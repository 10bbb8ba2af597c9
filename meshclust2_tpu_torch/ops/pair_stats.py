"""Pair statistics: sum-min, dot and EMD of two histogram rows, and the
classifier's float64 epilogue fused behind them.

The port of meshclust2_tpu/ops/pallas_stats.py (`center_block_stats`, line
114, over the Pallas kernel `_build.kernel`, line 39; `derive_singles`, line
148), with the epilogue that XLA fuses behind the Pallas kernel on the TPU
(meshclust2_tpu/cluster/device_loop.py:derive_singles_dd, epilogue_dd).
Two wrappers launch the hand-written kernel in csrc/pair_stats.cu on CUDA
tensors and run their plain PyTorch versions on CPU tensors, which the CPU
tests hold against the JAX package:

- `pair_stats`: int64 [P, 3] (sum_i min(h_i, c_i), sum_i h_i c_i,
  sum_j |prefix_j(h - c)|), exact for uint8 and uint16 rows; plain version
  `pair_stats_ref`.  Training's tables and the kernel checks use it.
- `pair_stats_decision`: the same statistics and, from them and the rows'
  float64 moments, the GLM sum, prob and dist of a model (`derive_singles`,
  then model/classifier.py:decision_from_raw), in one launch; plain version
  `pair_stats_decision_ref`.  The scorer, the accumulate step and the
  updater use it.  A model with full-vector singles (the log divergences
  and the blockwise singles, `vector_singles_ref`, the port of
  meshclust2_tpu/cluster/device_loop.py:log_div_stats and
  block_singles_stats) launches the FULL kernel (csrc/pair_stats.cu:
  full_kernel, a team of warps a pair), which sums their terms over the
  two rows from the counts its statistics pass loads and also returns
  absolute error bounds on s and dist (model/classifier.py:
  decision_errors); a model with plane singles (markov, sim_mm, rre_k_r,
  spearman, d2s, d2_star, afd, n2r/n2rc/n2rrc: ops/plane_singles.py) takes
  their values and bounds from `plane_singles` (`plane=`) and launches the
  PLANE instantiation, the fast kernel's rounds with each lane's epilogue
  reading them by code and propagating their bounds as FULL does (the
  FULL kernel reads them for a model with both); every other model's
  bounds are 0.

A `b_idx` of length 1 is the center form: every pair's second row is
b_idx[0].
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..features import flags as F
from ..model.classifier import (PLANE_SINGLES, SINGLE_CODES, VECTOR_SINGLES,
                                TorchModel, decision_errors, decision_from_raw)

N_STATS = 3
# rows of the plain version's int64 temporaries per step (bounds its memory
# at 16384 x D x 8 bytes per temporary)
_REF_CHUNK = 16384

_DTYPES = {torch.uint8: "u8", torch.uint16: "u16"}


def _kernel(name: str, dtype: torch.dtype):
    from ._build import load

    fn = getattr(load("pair_stats").lib, f"mc2_{name}_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        head = [p, i64, i32, p, p, i32, i64]
        if name == "pair_stats":
            fn.argtypes = head + [i32, p, p]
        else:
            fn.argtypes = head + [p, p, p, p, p, i32, ctypes.c_double, i32,
                                  i32, p, i32, i32, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def narrow_sums(d: int, maxc: Optional[int]) -> bool:
    """Whether 32-bit lane sums are exact for rows of d counts <= maxc:
    D maxc^2 < 2^31 bounds sum-min, dot and every EMD prefix, and
    ceil(D / 32) D maxc < 2^32 a lane's EMD part.  None: unknown, 64 bits."""
    if maxc is None:
        return False
    return d * maxc * maxc < 2**31 and -(-d // 32) * d * maxc < 2**32


def _check(counts: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor):
    if counts.dtype not in _DTYPES:
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
    if a_idx.shape != b_idx.shape and len(b_idx) != 1:
        raise ValueError(f"a_idx {tuple(a_idx.shape)} and b_idx "
                         f"{tuple(b_idx.shape)} differ in length")
    for name, t in (("counts", counts), ("a_idx", a_idx), ("b_idx", b_idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {counts.device}")


def _pairs(a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """b_idx as one index a pair (the center form expanded)."""
    return b_idx.expand(len(a_idx)) if len(b_idx) != len(a_idx) else b_idx


def pair_stats_ref(counts: torch.Tensor, a_idx: torch.Tensor,
                   b_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pair statistics: gather, minimum, product and cumsum,
    all in int64."""
    b_idx = _pairs(a_idx, b_idx)
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


def _launch(name: str, counts: torch.Tensor, a_idx: torch.Tensor,
            b_idx: torch.Tensor, maxc: Optional[int], extra, outs):
    fn = _kernel(name, counts.dtype)
    n, d = counts.shape
    center = int(len(b_idx) != len(a_idx))
    narrow = int(narrow_sums(d, maxc))
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    with torch.cuda.device(counts.device):
        rc = fn(counts.data_ptr(), n, d, a_idx.data_ptr(), b_idx.data_ptr(),
                center, len(a_idx), *extra, narrow,
                *(t.data_ptr() for t in outs), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def pair_stats(counts: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor,
               maxc: Optional[int] = None) -> torch.Tensor:
    """[N, D] uint8/uint16 store, int64 [P] row indices a_idx and b_idx (or
    [1], the center form) -> int64 [P, 3] statistics of (counts[a_idx[p]],
    counts[b_idx[p]]).  maxc, the store's largest count when known, lets
    the kernel sum in 32 bits (`narrow_sums`).

    On CUDA the indices must lie in [0, N): the kernel writes -1 rows for
    any that do not.  Launches on the current stream without syncing."""
    _check(counts, a_idx, b_idx)
    if counts.device.type == "cpu":
        return pair_stats_ref(counts, a_idx, b_idx)
    out = torch.empty((len(a_idx), N_STATS), dtype=torch.int64,
                      device=counts.device)
    if len(a_idx) == 0:
        return out
    _launch("pair_stats", counts, a_idx, b_idx, maxc, (), (out,))
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
    b_idx = torch.full((1,), b, dtype=torch.int64, device=h_block.device)
    return pair_stats(store, a_idx, b_idx)


_U = 2.0 ** -53   # unit roundoff of float64
# rows of the plain full-vector pass's float64 temporaries per step
_VEC_CHUNK = 4096


def _vector_terms(x: torch.Tensor, y: torch.Tensor, mA: torch.Tensor,
                  mB: torch.Tensor, d: int, need) -> Dict[int, tuple]:
    """{flag: (value, bound)} float64 [P] of the full-vector singles in
    `need` for count rows x, y [P, d] (float64) with count sums mA, mB [P];
    the per-term formulas of csrc/pair_stats.cu:full_group."""
    out = {}
    hs = (d + 64) * _U   # either side's sum of d terms, in any order
    e16 = 16 * _U        # both sides' roundings of one term
    ma, mb = mA[:, None], mB[:, None]
    if need & {F.FEAT_JEFFEREY_DIV, F.FEAT_JENSEN_SHANNON, F.FEAT_K_DIV}:
        # exact integer products (< 2^40): p_i / q_i = (x mB) / (y mA)
        ppn, pqn = x * mb, y * ma
        if F.FEAT_JEFFEREY_DIV in need:
            dnum = ppn - pqn
            lr = torch.log(ppn / pqn)
            t = dnum * lr
            mm = mA * mB
            comp = (dnum.abs() + (ppn + pqn) * lr.abs()).sum(1)
            out[F.FEAT_JEFFEREY_DIV] = (t.sum(1) / mm,
                                        (hs * t.abs().sum(1) + e16 * comp) / mm)
        if need & {F.FEAT_JENSEN_SHANNON, F.FEAT_K_DIV}:
            sn = ppn + pqn
            ta = x * torch.log((2 * ppn) / sn)
            sa, aa = ta.sum(1) / mA, ta.abs().sum(1) / mA
            # sum_i x_i / mA == 1: the roundings' constant part
            out[F.FEAT_K_DIV] = (sa, hs * aa + e16 * (aa + 1))
            if F.FEAT_JENSEN_SHANNON in need:
                tb = y * torch.log((2 * pqn) / sn)
                t_abs = 0.5 * (aa + tb.abs().sum(1) / mB)
                out[F.FEAT_JENSEN_SHANNON] = (0.5 * (sa + tb.sum(1) / mB),
                                              hs * t_abs + e16 * (t_abs + 1))
    if F.FEAT_KL_COND in need:
        gx, gy = x.view(len(x), d // 4, 4), y.view(len(y), d // 4, 4)
        sp, sq = gx.sum(2, keepdim=True), gy.sum(2, keepdim=True)
        lg = torch.log((gx * sq) / (gy * sp))
        tp, tq = gx * lg, gy * lg
        t_abs = 0.5 * (tp.abs().sum((1, 2)) / mA + tq.abs().sum((1, 2)) / mB)
        out[F.FEAT_KL_COND] = (0.5 * (tp.sum((1, 2)) / mA - tq.sum((1, 2)) / mB),
                               hs * t_abs + e16 * (t_abs + 1))
    if F.FEAT_HELLINGER in need:
        xa, xb = torch.sqrt((x * d) / ma), torch.sqrt((y * d) / mb)
        df = xa - xb
        ssq = (df * df).sum(1)
        e_s = hs * ssq + e16 * (df.abs() * (xa + xb)).sum(1)
        v = torch.sqrt(2 * ssq)
        # |sqrt(2 s1) - sqrt(2 s2)| <= 2 e / max(v, sqrt(2 e)), |s1 - s2| <= e
        err = torch.where(e_s > 0, 2 * e_s / torch.maximum(v, torch.sqrt(2 * e_s)),
                          torch.zeros_like(v))
        out[F.FEAT_HELLINGER] = (v, err + 4 * _U * v)
    if F.FEAT_SQCHORD in need:
        v = ((x + y) - 2 * torch.sqrt(x * y)).sum(1)
        out[F.FEAT_SQCHORD] = (v, hs * v + e16 * (mA + mB))
    plain = {F.FEAT_CHI_SQUARED: lambda: (x - y) * (x - y) / (x + y),
             F.FEAT_CANBERRA: lambda: (x - y).abs() / (x + y),
             F.FEAT_KULCZYNSKI1: lambda: (x - y).abs() / torch.minimum(x, y),
             F.FEAT_HARMONIC_MEAN: lambda: (x * y) / (x + y)}
    for flag, terms in plain.items():
        if flag in need:
            # terms >= 0, so their sum bounds their absolute values' sum
            v = terms().sum(1)
            if flag == F.FEAT_HARMONIC_MEAN:
                v = 2 * v
            out[flag] = (v, (hs + e16) * v)
    if F.FEAT_MISMATCH in need:
        out[F.FEAT_MISMATCH] = ((x != y).sum(1).to(torch.float64),
                                torch.zeros_like(mA))
    if F.FEAT_JACCARD in need:
        # 1 / d is a power of two: exact
        out[F.FEAT_JACCARD] = (((x == y) & (x > 1)).sum(1).to(torch.float64)
                               * (1.0 / d), torch.zeros_like(mA))
    return out


def vector_singles_ref(counts: torch.Tensor, a_idx: torch.Tensor,
                       b_idx: torch.Tensor, mags: torch.Tensor,
                       flags_list: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-vector singles of the pairs (counts[a_idx[p]],
    counts[b_idx[p]]) in plain float64 PyTorch: (values, bounds), each
    float64 [P, K] in `flags_list` order (VECTOR_SINGLES only).  `mags`,
    float64 [N], must be the rows' count sums (kmer/counting.py; a store's
    pseudo-magnitudes), and D a multiple of 4 (kl_cond's groups).

    The port of meshclust2_tpu/cluster/device_loop.py:log_div_stats and
    block_singles_stats with their exactness recipes in float64: a log's
    argument is a ratio of exact integer products, e.g. (h_i mB) /
    (c_i mA) for (h_i / mA) / (c_i / mB), so it rounds once.  Each bound
    is absolute, on |value - the host oracle's| (the native scorer,
    features/host.py): (D + 64) u times the sum of the terms' absolute
    values covers either side's sum over D terms in any order, and 16 u
    times a companion sum the roundings of each term on both sides
    (u = 2^-53, as train/device_tables.py:singles_error).  mismatch and
    jaccard are exact.  The kernel's FULL pass sums the same terms in
    another order, so it agrees with this within the same bounds."""
    b_idx = _pairs(a_idx, b_idx)
    d = counts.shape[1]
    if d % 4:
        raise ValueError(f"D = {d} is no multiple of 4 (kl_cond's groups)")
    bad = [f for f in flags_list if f not in VECTOR_SINGLES]
    if bad:
        raise ValueError(f"flags {bad} are not full-vector singles")
    vals = torch.empty((len(a_idx), len(flags_list)), dtype=torch.float64,
                       device=counts.device)
    errs = torch.empty_like(vals)
    # CUDA has no uint16 gather: gather the same bits as int16 and mask
    src, mask = ((counts.view(torch.int16), 0xFFFF)
                 if counts.dtype == torch.uint16 else (counts, 0xFF))
    for s in range(0, len(a_idx), _VEC_CHUNK):
        ai, bi = a_idx[s:s + _VEC_CHUNK], b_idx[s:s + _VEC_CHUNK]
        x = (src[ai].to(torch.int64) & mask).to(torch.float64)
        y = (src[bi].to(torch.int64) & mask).to(torch.float64)
        got = _vector_terms(x, y, mags[ai], mags[bi], d, set(flags_list))
        for j, flag in enumerate(flags_list):
            vals[s:s + len(ai), j], errs[s:s + len(ai), j] = got[flag]
    return vals, errs


def derive_singles(stats: torch.Tensor, mags_a, mags_b, self_a, self_b,
                   std_a, std_b, len_a, len_b, d: int,
                   flags_list: Sequence[int],
                   vector: Optional[Dict[int, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Raw singles [P, S] float64 from the statistics plus per-row float64
    moments: meshclust2_tpu/ops/pallas_stats.py:derive_singles formula for
    formula, in the same operation order.  A full-vector single takes its
    value from `vector` ({flag: float64 [P]}, `vector_singles_ref`)."""
    vector = vector or {}
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
        elif flag in vector:
            out.append(vector[flag])
        else:
            raise ValueError(f"flag {flag} not derivable from fused stats")
    return torch.stack(out, dim=1)


def _check_decision(store, params: TorchModel, a_idx, b_idx, plane):
    _check(store.counts, a_idx, b_idx)
    n = store.counts.shape[0]
    for name in ("mags", "selfdot", "stddevs", "lens"):
        t = getattr(store, name)
        if t.dtype != torch.float64 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float64 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != store.counts.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {store.counts.device}")
    pk = params.packed
    if (pk.dtype != torch.float64 or pk.dim() != 1 or not pk.is_contiguous()
            or pk.device != store.counts.device):
        raise ValueError(f"params.packed must be contiguous float64 [K] on "
                         f"{store.counts.device}")
    bad = [F.FEAT_NAMES.get(s, hex(s)) for s in params.singles
           if s not in SINGLE_CODES]
    if len(set(params.singles)) != len(params.singles):
        raise ValueError(f"singles {list(params.singles)} repeat")
    if bad:
        raise ValueError(f"singles {bad} have no device implementation")
    if has_vector(params) and store.counts.shape[1] % 4:
        raise ValueError(f"D = {store.counts.shape[1]} is no multiple of 4 "
                         f"(kl_cond's groups)")
    n_plane = sum(s in PLANE_SINGLES for s in params.singles)
    if n_plane and len(params.singles) > MAX_PLANE_MODEL_SINGLES:
        raise ValueError(f"{len(params.singles)} singles: the PLANE epilogue "
                         f"takes at most {MAX_PLANE_MODEL_SINGLES}")
    want = (2, n_plane, len(a_idx))
    if plane is None and n_plane:
        raise ValueError("a model with plane singles needs their values "
                         "(plane=, ops/plane_singles.py)")
    if plane is not None and (
            plane.dtype != torch.float64 or tuple(plane.shape) != want
            or plane.device != store.counts.device or not plane.is_contiguous()):
        raise ValueError(f"plane must be contiguous float64 {want} on "
                         f"{store.counts.device}, got {plane.dtype} "
                         f"{tuple(plane.shape)}")


def has_vector(params: TorchModel) -> bool:
    """Whether the model has a full-vector single (the FULL kernel)."""
    return any(s in VECTOR_SINGLES for s in params.singles)


# the PLANE epilogue gives each single of the model a lane of a warp
MAX_PLANE_MODEL_SINGLES = 32


def _decision_out(n_pairs: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One buffer: int64 stats [P, 3], then float64 (s, prob, dist, s_err,
    dist_err) [5, P]."""
    buf = torch.empty(8 * n_pairs, dtype=torch.int64, device=device)
    return (buf[:3 * n_pairs].view(n_pairs, N_STATS),
            buf[3 * n_pairs:].view(torch.float64).view(5, n_pairs))


def pair_stats_decision_ref(store, params: TorchModel, a_idx: torch.Tensor,
                            b_idx: torch.Tensor,
                            plane: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain sequence: `pair_stats_ref`, the moments gathered,
    `vector_singles_ref` for a model that has full-vector singles, the
    plane singles' values from `plane`, `derive_singles`,
    `decision_from_raw` and `decision_errors` (0 without full-vector or
    plane singles)."""
    stats, dec = _decision_out(len(a_idx), store.counts.device)
    if not len(a_idx):
        return stats, dec
    b_idx = _pairs(a_idx, b_idx)
    stats.copy_(pair_stats_ref(store.counts, a_idx, b_idx))
    vflags = [s for s in params.singles if s in VECTOR_SINGLES]
    pflags = [s for s in params.singles if s in PLANE_SINGLES]
    vector, bounds = {}, {}
    if vflags:
        vals, errs = vector_singles_ref(store.counts, a_idx, b_idx, store.mags,
                                        vflags)
        vector = dict(zip(vflags, vals.T))
        bounds = dict(zip(vflags, errs.T))
    if pflags:
        vector.update(zip(pflags, plane[0]))
        bounds.update(zip(pflags, plane[1]))
    raw = derive_singles(
        stats, store.mags[a_idx], store.mags[b_idx], store.selfdot[a_idx],
        store.selfdot[b_idx], store.stddevs[a_idx], store.stddevs[b_idx],
        store.lens[a_idx], store.lens[b_idx], store.counts.shape[1],
        params.singles, vector)
    for row, v in zip(dec, decision_from_raw(params, raw)):
        row.copy_(v)
    if bounds:
        err = torch.zeros_like(raw)
        for j, flag in enumerate(params.singles):
            if flag in bounds:
                err[:, j] = bounds[flag]
        for row, v in zip(dec[3:], decision_errors(params, raw, err)):
            row.copy_(v)
    else:
        dec[3:].zero_()
    return stats, dec


def pair_stats_decision(store, params: TorchModel, a_idx: torch.Tensor,
                        b_idx: torch.Tensor,
                        plane: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair statistics and the classifier's decision values of the pairs
    (store.counts[a_idx[p]], store.counts[b_idx[p]]) (b_idx [1]: the center
    form), over a DeviceStore-like `store` (counts, float64 mags, selfdot,
    stddevs, lens, maxc) and `params` from model_to_torch: (int64 stats
    [P, 3], float64 dec [5, P] = (GLM sum, prob, dist, s_err, dist_err)),
    views of one buffer.  s_err and dist_err bound |s - the host's| and
    |dist - the host's| for a model with full-vector or plane singles; 0
    for any other.  A model with plane singles needs `plane`, float64
    [2, S_p, P] from ops/plane_singles.py:plane_singles for its S_p plane
    singles in model order.

    On CUDA one launch on the current stream, without syncing; an index
    outside [0, N) gives -1 statistics and NaN decisions."""
    _check_decision(store, params, a_idx, b_idx, plane)
    counts = store.counts
    if counts.device.type == "cpu":
        return pair_stats_decision_ref(store, params, a_idx, b_idx, plane)
    stats, dec = _decision_out(len(a_idx), counts.device)
    if len(a_idx) == 0:
        return stats, dec
    pk = params.packed
    full, with_plane = int(has_vector(params)), int(plane is not None)
    extra = (store.mags.data_ptr(), store.selfdot.data_ptr(),
             store.stddevs.data_ptr(), store.lens.data_ptr(), pk.data_ptr(),
             pk.numel(), 1.0 / counts.shape[1], full, with_plane,
             plane.data_ptr() if with_plane else None,
             plane.shape[1] if with_plane else 0)
    _launch("pair_decision", counts, a_idx, b_idx, store.maxc, extra,
            (stats, dec))
    pair_stats_decision.launches += 1
    pair_stats_decision.full_launches += full
    pair_stats_decision.plane_launches += with_plane
    return stats, dec


pair_stats_decision.launches = 0  # kernel launches since the last reset
pair_stats_decision.full_launches = 0  # of them, of the FULL instantiation
pair_stats_decision.plane_launches = 0  # of them, of the PLANE instantiation
