"""meshclust2_tpu_torch: the PyTorch and CUDA port of meshclust2_tpu
(meshclust2_tpu/__init__.py).

The JAX package `meshclust2_tpu` stays the reference.  This package keeps
its own copy of the JAX package's host layer (FASTA and k-mer code, the
feature formulas, the model and its training, the clustering engine, the
native host library, Red) and replaces its device work with torch and
hand-written CUDA kernels.  It imports nothing of the JAX package, and
nothing here imports jax or builds a kernel at import time.
"""
