"""parallel subpackage: the port's counterpart of meshclust2_tpu/parallel/."""
