"""Pair statistics: sum-min, dot and EMD of two histogram rows.

The port of meshclust2_tpu/ops/pallas_stats.py (`center_block_stats`, line
114, over the Pallas kernel `_build.kernel`, line 39; `derive_singles`, line
148).  On a CUDA tensor `pair_stats` launches the hand-written kernel in
csrc/pair_stats.cu; on a CPU tensor it runs `pair_stats_ref`, the plain
PyTorch version, which the CPU tests hold against the JAX kernel.

Results are int64 [P, 3]: (sum_i min(h_i, c_i), sum_i h_i c_i,
sum_j |prefix_j(h - c)|), exact for uint8 and uint16 rows.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..features import flags as F

N_STATS = 3
# rows of the plain version's int64 temporaries per step (bounds its memory
# at 16384 x D x 8 bytes per temporary)
_REF_CHUNK = 16384

_ENTRY = {torch.uint8: "mc2_pair_stats_u8", torch.uint16: "mc2_pair_stats_u16"}


def _kernel(dtype: torch.dtype):
    from ._build import load

    fn = getattr(load("pair_stats").lib, _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(counts: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor):
    if counts.dtype not in _ENTRY:
        raise TypeError(f"counts must be uint8 or uint16, got {counts.dtype}")
    if counts.dim() != 2:
        raise ValueError(f"counts must be [N, D], got shape {tuple(counts.shape)}")
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be [P], got shape {tuple(t.shape)}")
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on {counts.device}")
    if a_idx.shape != b_idx.shape:
        raise ValueError(f"a_idx {tuple(a_idx.shape)} and b_idx "
                         f"{tuple(b_idx.shape)} differ in length")
    for name, t in (("counts", counts), ("a_idx", a_idx), ("b_idx", b_idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {counts.device}")


def pair_stats_ref(counts: torch.Tensor, a_idx: torch.Tensor,
                   b_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pair statistics: gather, minimum, product and cumsum,
    all in int64."""
    out = torch.empty((len(a_idx), N_STATS), dtype=torch.int64,
                      device=counts.device)
    # CUDA has no uint16 gather: gather the same bits as int16 and mask
    src, mask = ((counts.view(torch.int16), 0xFFFF)
                 if counts.dtype == torch.uint16 else (counts, 0xFF))
    for s in range(0, len(a_idx), _REF_CHUNK):
        h = src[a_idx[s:s + _REF_CHUNK]].to(torch.int64) & mask
        c = src[b_idx[s:s + _REF_CHUNK]].to(torch.int64) & mask
        out[s:s + len(h), 0] = torch.minimum(h, c).sum(dim=1)
        out[s:s + len(h), 1] = (h * c).sum(dim=1)
        out[s:s + len(h), 2] = torch.cumsum(h - c, dim=1).abs().sum(dim=1)
    return out


def pair_stats(counts: torch.Tensor, a_idx: torch.Tensor,
               b_idx: torch.Tensor) -> torch.Tensor:
    """[N, D] uint8/uint16 store, int64 [P] row indices -> int64 [P, 3]
    statistics of (counts[a_idx[p]], counts[b_idx[p]]).

    On CUDA the indices must lie in [0, N): the kernel writes -1 rows for
    any that do not.  Launches on the current stream without syncing."""
    _check(counts, a_idx, b_idx)
    if counts.device.type == "cpu":
        return pair_stats_ref(counts, a_idx, b_idx)
    n_pairs = len(a_idx)
    out = torch.empty((n_pairs, N_STATS), dtype=torch.int64,
                      device=counts.device)
    if n_pairs == 0:
        return out
    fn = _kernel(counts.dtype)
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    with torch.cuda.device(counts.device):
        rc = fn(counts.data_ptr(), counts.shape[0], counts.shape[1],
                a_idx.data_ptr(), b_idx.data_ptr(), n_pairs,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pair_stats kernel launch failed: cudaError {rc}")
    pair_stats.launches += 1
    return out


pair_stats.launches = 0  # kernel launches since the last reset


def center_block_stats(h_block: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """[B, D] candidate rows vs one [D] center row -> int64 [B, 3]; the
    meaning of meshclust2_tpu.ops.pallas_stats.center_block_stats."""
    b, d = h_block.shape
    if center.shape != (d,):
        raise ValueError(f"center must be [{d}], got {tuple(center.shape)}")
    store = torch.cat([h_block, center.reshape(1, d)]).contiguous()
    a_idx = torch.arange(b, dtype=torch.int64, device=h_block.device)
    b_idx = torch.full((b,), b, dtype=torch.int64, device=h_block.device)
    return pair_stats(store, a_idx, b_idx)


def derive_singles(stats: torch.Tensor, mags_a, mags_b, self_a, self_b,
                   std_a, std_b, len_a, len_b, d: int,
                   flags_list: Sequence[int]) -> torch.Tensor:
    """Raw singles [P, S] float64 from the statistics plus per-row float64
    moments: meshclust2_tpu/ops/pallas_stats.py:derive_singles formula for
    formula, in the same operation order."""
    summin = stats[:, 0].to(torch.float64)
    dot = stats[:, 1].to(torch.float64)
    emd = stats[:, 2].to(torch.float64)
    ap = mags_a / d
    aq = mags_b / d
    norm2 = self_a + self_b - 2 * dot
    out = []
    for flag in flags_list:
        if flag == F.FEAT_MANHATTAN:
            out.append(mags_a + mags_b - 2 * summin)
        elif flag == F.FEAT_EUCLIDEAN:
            out.append(torch.sqrt(norm2))
        elif flag == F.FEAT_INTERSECTION:
            out.append(2 * summin / (mags_a + mags_b))
        elif flag == F.FEAT_KULCZYNSKI2:
            out.append(d * (ap + aq) / (2 * ap * aq) * summin)
        elif flag == F.FEAT_SIMRATIO:
            out.append(dot / (dot + torch.sqrt(norm2)))
        elif flag == F.FEAT_NORMALIZED_VECTORS:
            out.append(dot / torch.sqrt(self_a * self_b))
        elif flag == F.FEAT_PEARSON_COEFF:
            cov = dot - d * ap * aq
            out.append(cov / torch.sqrt((self_a - d * ap**2) * (self_b - d * aq**2)))
        elif flag == F.FEAT_D2z:
            out.append((dot - d * ap * aq) / (std_a * std_b))
        elif flag == F.FEAT_EUCLIDEAN_Z:
            na = (self_a - d * ap**2) / std_a**2
            nb = (self_b - d * aq**2) / std_b**2
            dz = (dot - d * ap * aq) / (std_a * std_b)
            out.append(torch.sqrt(na + nb - 2 * dz))
        elif flag == F.FEAT_EMD:
            out.append(emd)
        elif flag == F.FEAT_LENGTHD:
            out.append(torch.abs(len_a - len_b))
        else:
            raise ValueError(f"flag {flag} not derivable from fused stats")
    return torch.stack(out, dim=1)
