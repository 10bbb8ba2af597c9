"""CUDA kernels and their PyTorch wrappers (the port of meshclust2_tpu/ops/)."""
