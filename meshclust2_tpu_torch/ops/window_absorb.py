"""The decision half of one accumulate step: positives, gates, best, absorb.

The port of the decision half of
meshclust2_tpu/cluster/device_loop.py:_build_program.scan_window._chunk_heavy
(lines 1112-1209), an XLA program on the TPU.  On a CUDA tensor
`window_absorb` launches the hand-written kernel in csrc/window_absorb.cu;
on a CPU tensor it runs `window_absorb_ref`, the plain PyTorch version,
which the CPU tests hold against a numpy reference.

For the W candidates of one window (rows[p], in flat order), with their
float64 GLM sums s, dists and pair statistics against the center:
    pos[p]  = s[p] >= pos_edge;
    bits    = 1 when some s[p] lies within margin * max(|s|, |pos_edge|, 1)
              of the edge, | 2 when some candidate lies within
              tie_margin * max(|dist[best]|, 1) of the best dist while its
              (stats, mags, selfdot, lens, stddev) differ from the best's;
    best    = the first position of the largest dist (W when W = 0);
    colsum  = the int64 [D] column sum of the positive rows.
Returns (pos bool [W], colsum int64 [D], info int64 [3] = (bits, npos,
best)), all on the store's device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# rows of the plain version's int64 temporaries per step
_REF_CHUNK = 16384

_ENTRY = {torch.uint8: "mc2_window_absorb_u8", torch.uint16: "mc2_window_absorb_u16"}


def _kernel(dtype: torch.dtype):
    from ._build import load

    fn = getattr(load("window_absorb").lib, _ENTRY[dtype])
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, ctypes.c_int64, p, p, p, p, p, p, p,
                       ctypes.c_double, ctypes.c_double, ctypes.c_double,
                       p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(counts, rows, s, dist, stats, moments):
    if counts.dtype not in _ENTRY:
        raise TypeError(f"counts must be uint8 or uint16, got {counts.dtype}")
    if counts.dim() != 2:
        raise ValueError(f"counts must be [N, D], got shape {tuple(counts.shape)}")
    n_cand = len(rows)
    want = (("rows", rows, torch.int64, (n_cand,)),
            ("s", s, torch.float64, (n_cand,)),
            ("dist", dist, torch.float64, (n_cand,)),
            ("stats", stats, torch.int64, (n_cand, 3)))
    want += tuple((name, t, torch.float64, counts.shape[:1])
                  for name, t in zip(("mags", "selfdot", "lens", "stddevs"), moments))
    for name, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on {counts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {counts.device}")


def window_absorb_ref(counts, rows, s, dist, stats, mags, selfdot, lens, stddevs,
                      *, pos_edge: float, margin: float, tie_margin: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same float64 operations as the kernel,
    the column sum in int64 by chunks."""
    n_cand, d = len(rows), counts.shape[1]
    dev = counts.device
    pos = s >= pos_edge
    scale = s.abs().clamp(min=max(abs(pos_edge), 1.0))
    unc = ((s - pos_edge).abs() <= margin * scale).any()
    tie = torch.zeros((), dtype=torch.bool, device=dev)
    best = torch.full((), n_cand, dtype=torch.int64, device=dev)
    if n_cand:
        # torch.argmax returns the first maximal position
        best = torch.argmax(dist)
        bv = dist[best]
        near = (dist - bv).abs() <= tie_margin * bv.abs().clamp(min=1.0)
        same = (dist == bv) & (stats == stats[best]).all(dim=1)
        for m in (mags, selfdot, lens, stddevs):
            same &= m[rows] == m[rows[best]]
        tie = (near & ~same).any()
    # CUDA has no uint16 gather: gather the same bits as int16 and mask
    src, mask = ((counts.view(torch.int16), 0xFFFF)
                 if counts.dtype == torch.uint16 else (counts, 0xFF))
    colsum = torch.zeros(d, dtype=torch.int64, device=dev)
    for c in range(0, n_cand, _REF_CHUNK):
        h = src[rows[c:c + _REF_CHUNK]].to(torch.int64) & mask
        colsum += (h * pos[c:c + _REF_CHUNK, None]).sum(dim=0)
    bits = unc.to(torch.int64) | 2 * tie.to(torch.int64)
    info = torch.stack([bits, pos.sum(dtype=torch.int64), best.to(torch.int64)])
    return pos, colsum, info


def window_absorb(counts: torch.Tensor, rows: torch.Tensor, s: torch.Tensor,
                  dist: torch.Tensor, stats: torch.Tensor, mags: torch.Tensor,
                  selfdot: torch.Tensor, lens: torch.Tensor,
                  stddevs: torch.Tensor, *, pos_edge: float, margin: float,
                  tie_margin: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, D] uint8/uint16 store, int64 [W] candidate rows, float64 [W] s
    and dist, int64 [W, 3] pair statistics, the store's float64 [N]
    moments -> (pos, colsum, info) as in the module docstring.

    On CUDA the rows must lie in [0, N).  Launches on the current stream
    without syncing."""
    moments = (mags, selfdot, lens, stddevs)
    _check(counts, rows, s, dist, stats, moments)
    kw = dict(pos_edge=float(pos_edge), margin=float(margin),
              tie_margin=float(tie_margin))
    if counts.device.type == "cpu":
        return window_absorb_ref(counts, rows, s, dist, stats, *moments, **kw)
    dev = counts.device
    n_cand = len(rows)
    pos = torch.empty(n_cand, dtype=torch.bool, device=dev)
    colsum = torch.zeros(counts.shape[1], dtype=torch.int64, device=dev)
    info = torch.empty(3, dtype=torch.int64, device=dev)
    fn = _kernel(counts.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(counts.data_ptr(), counts.shape[1], rows.data_ptr(), n_cand,
                s.data_ptr(), dist.data_ptr(), stats.data_ptr(),
                *(m.data_ptr() for m in moments), kw["pos_edge"], kw["margin"],
                kw["tie_margin"], pos.data_ptr(), colsum.data_ptr(),
                info.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"window_absorb kernel launch failed: cudaError {rc}")
    window_absorb.launches += 1
    return pos, colsum, info


window_absorb.launches = 0  # kernel launches since the last reset
