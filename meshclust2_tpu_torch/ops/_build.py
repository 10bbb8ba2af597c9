"""Build and load the port's CUDA kernels.

Each kernel source under `meshclust2_tpu_torch/csrc/` is compiled at first
use by `nvcc` for `sm_90a` into a shared library with a plain C interface,
kept under `build/kernels/` at the repository root and keyed by a hash of
the sources and flags, then loaded with `ctypes`.  Nothing here runs at
import: the CPU tests import every module on a machine without `nvcc`.

The counterpart of the JAX package's lazy Pallas build
(meshclust2_tpu/ops/pallas_stats.py:_build, line 32), with `nvcc` in place
of Mosaic.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    seconds: float        # nvcc wall time; 0.0 when the library was cached
    log: str              # nvcc's output (ptxas registers / spills)


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


@functools.cache
def load(name: str) -> Built:
    """Compile `csrc/<name>.cu` (cached by content) and load it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
    return Built(ctypes.CDLL(str(so)), so, seconds, log)
