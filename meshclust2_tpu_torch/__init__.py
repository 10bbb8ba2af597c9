"""meshclust2_tpu_torch: the PyTorch and CUDA port of meshclust2_tpu
(meshclust2_tpu/__init__.py).

The JAX package `meshclust2_tpu` stays the reference; this package imports
its JAX-free modules (FASTA and k-mer code, the model, the clustering
engine, the native host library) and replaces its device work with torch
and hand-written CUDA kernels.  Nothing here imports jax or builds a kernel
at import time.
"""
