"""The plane singles of pairs of rows, in float64 with absolute error bounds.

The port of the plane branches of
meshclust2_tpu/ops/device_features.py:DeviceFeatureEngine._build_pair_fn.
pair_singles (lines 278-303, 306-316, 332-338, 344-376, 395-399): markov,
sim_mm, rre_k_r, spearman, d2s, d2_star, afd, n2r, n2rc and n2rrc
(model/classifier.py:PLANE_SINGLES), the singles that neither the pair
statistics nor the fused kernel's full-vector pass give.  They read per-row
planes (`Planes`) that ops/device_features.py:TorchDeviceFeatureEngine
builds once a pool on the host in float64, each entry the intermediate the
host oracle (features/host.py) forms for that row.

`plane_singles` launches the hand-written kernel in csrc/plane_singles.cu on
CUDA tensors and runs its plain PyTorch version, `plane_singles_ref`, on CPU
tensors.  Both return float64 [2, S, P]: the values of the S selected
singles of each pair, in the reference's (a, b) argument order, then a bound
on |value - the host oracle's| for each; the fused kernel's PLANE epilogue
(ops/pair_stats.py:pair_stats_decision) reads them by code.  A `b_idx` of
length 1 is the center form.  Where a term is formed as the host forms it,
bit for bit (spearman's exact half-integer products, d2_star's, the n2
dots), only the sums' order differs; where the CUDA math library's log,
exp, pow or hypot stands in for numpy's, a companion sum covers it
(ops/pair_stats.py:vector_singles_ref's recipe).  The kernel sums in another
order than this plain version, so the two agree within the sum of their
bounds, not bit for bit.

The store keeps what a pair reads small: markov's logs of counts and of
group sums are two tables indexed by the integer (`log_count`,
`log_group`: numpy's own logs, which the build holds equal bit for bit to
the host's over every row), and spearman's rank deviations are integers
2 dev, int16 up to D = 16,384 (`rank2`), so its cov is an exact integer
sum.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ..features import flags as F
from ..features.host import digit_matrix
from ..model.classifier import PLANE_SINGLES, SINGLE_CODES

_U = 2.0 ** -53   # unit roundoff of float64
# pairs of the plain version's [chunk, D] float64 temporaries per step
_CHUNK = 2048
_DTYPES = {torch.uint8: "u8", torch.uint16: "u16"}
_N2 = (F.FEAT_N2R, F.FEAT_N2RC, F.FEAT_N2RRC)


@dataclass(frozen=True)
class Planes:
    """The per-row planes of one pool on one device (TorchDeviceFeatureEngine);
    a plane that no selected single reads is None."""

    counts: torch.Tensor        # [N, D] uint8/uint16, the DeviceStore's
    mags: torch.Tensor          # float64 [N] count sums (pseudo-magnitudes)
    real_mags: torch.Tensor     # float64 [N] mags - D
    one_mers: torch.Tensor      # float64 [N, 4] pseudocounted one-mer counts
    k: int
    log_count: Optional[torch.Tensor] = None     # float64 [L] log c (markov, sim_mm)
    log_group: Optional[torch.Tensor] = None     # float64 [4 (L - 1) + 1] log of a group sum
    markov_self: Optional[torch.Tensor] = None   # float64 [N] markov(x, x) (sim_mm)
    rank2: Optional[torch.Tensor] = None         # int16/int32 [N, D] 2 (tied rank - (D + 1) / 2)
    rank_ss: Optional[torch.Tensor] = None       # float64 [N] the deviations' sum of squares
    h: Optional[torch.Tensor] = None             # float64 [N, D] counts - expectation
    n2r: Optional[torch.Tensor] = None           # float64 [N, D] n2 z-planes
    n2rc: Optional[torch.Tensor] = None
    n2rrc: Optional[torch.Tensor] = None

    def n2(self, flag: int) -> Optional[torch.Tensor]:
        return {F.FEAT_N2R: self.n2r, F.FEAT_N2RC: self.n2rc,
                F.FEAT_N2RRC: self.n2rrc}[flag]

    def nbytes(self) -> int:
        """Device bytes of what the store adds to the DeviceStore's counts
        and mags: the tables, planes and per-row scalars."""
        return sum(t.numel() * t.element_size() for name, t in vars(self).items()
                   if isinstance(t, torch.Tensor) and name not in ("counts", "mags"))


def table_len(dtype: torch.dtype) -> int:
    """Entries of the log-count table of a store of `dtype` (every count
    the type holds); the group table has 4 (L - 1) + 1."""
    return 256 if dtype == torch.uint8 else 65536


def rank_dtype(d: int) -> torch.dtype:
    """2 dev of a tied rank fits int16 while |2 dev| <= D - 1 < 2^14."""
    return torch.int16 if d <= 16384 else torch.int32


# the planes each single reads
NEEDS = {
    F.FEAT_MARKOV: ("log_count", "log_group"),
    F.FEAT_SIM_MM: ("log_count", "log_group", "markov_self"),
    F.FEAT_RRE_K_R: (),
    F.FEAT_SPEARMAN: ("rank2", "rank_ss"),
    F.FEAT_D2s: ("h",),
    F.FEAT_D2_star: ("h",),
    F.FEAT_AFD: (),
    F.FEAT_N2R: ("n2r",),
    F.FEAT_N2RC: ("n2rc",),
    F.FEAT_N2RRC: ("n2rrc",),
}


def _rows(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """counts[idx] as int64 (CUDA has no uint16 gather: the same bits as
    int16, masked)."""
    if counts.dtype == torch.uint16:
        return counts.view(torch.int16)[idx].to(torch.int64) & 0xFFFF
    return counts[idx].to(torch.int64)


def _plane_terms(pl: Planes, a: torch.Tensor, b: torch.Tensor, need
                 ) -> Dict[int, tuple]:
    """{flag: (value, bound)} float64 [P] of the plane singles in `need`
    for the pairs (a[p], b[p]); csrc/plane_singles.cu's formulas, term for
    term, with its bounds: hs = (D + 64) u times the terms' absolute
    values, 16 u times a companion sum (u = 2^-53)."""
    out = {}
    d = pl.counts.shape[1]
    hs, e16 = (d + 64) * _U, 16 * _U
    xi, yi = _rows(pl.counts, a), _rows(pl.counts, b)
    x, y = xi.to(torch.float64), yi.to(torch.float64)
    if need & {F.FEAT_MARKOV, F.FEAT_SIM_MM}:
        la, lb = pl.log_count[xi], pl.log_count[yi]
        ga = pl.log_group[xi.view(len(a), d // 4, 4).sum(2)].repeat_interleave(4, dim=1)
        gb = pl.log_group[yi.view(len(b), d // 4, 4).sum(2)].repeat_interleave(4, dim=1)
        t1, t2 = (x - 1) * (lb - gb), (y - 1) * (la - ga)
        mk = 0.5 * (t1.sum(1) + t2.sum(1))
        comp = ((x - 1) * (lb.abs() + gb.abs())).sum(1) + \
            ((y - 1) * (la.abs() + ga.abs())).sum(1)
        mk_err = 0.5 * (hs * (t1.abs().sum(1) + t2.abs().sum(1)) + e16 * comp)
        out[F.FEAT_MARKOV] = (mk, mk_err)
        if F.FEAT_SIM_MM in need:
            rma, rmb = pl.real_mags[a], pl.real_mags[b]
            lga = torch.log(mk / pl.markov_self[a])
            lgb = torch.log(mk / pl.markov_self[b])
            d_ab, d_ba = lgb / rmb, lga / rma
            xx = 0.5 * (d_ab + d_ba)
            ex = torch.exp(xx)
            v = 1 - ex
            # first order: mk's relative error moves each log by as much
            em = mk_err / mk.abs()
            ea = (1.5 * em + 4 * _U + 16 * _U * lga.abs()) / rma + 4 * _U * d_ba.abs()
            eb = (1.5 * em + 4 * _U + 16 * _U * lgb.abs()) / rmb + 4 * _U * d_ab.abs()
            exx = 0.5 * (ea + eb) + 4 * _U * xx.abs()
            e = 2 * ex * exx + 16 * _U * (ex + v.abs())
            out[F.FEAT_SIM_MM] = (v, torch.where((em < 0.25) & torch.isfinite(e), e,
                                                 torch.full_like(e, float("inf"))))
    if F.FEAT_RRE_K_R in need:
        gx, gy = x.view(len(x), d // 4, 4), y.view(len(y), d // 4, 4)
        sp, sq = gx.sum(2, keepdim=True), gy.sum(2, keepdim=True)
        # cp / avg = 2 x sq / (x sq + y sp): exact integer products
        den = gx * sq + gy * sp
        lp, lq = torch.log((2 * gx * sq) / den), torch.log((2 * gy * sp) / den)
        tp, tq = (gx * lp) / sp, (gy * lq) / sq
        comp = ((gx / sp) * (lp.abs() + 1)).sum((1, 2)) + \
            ((gy / sq) * (lq.abs() + 1)).sum((1, 2))
        out[F.FEAT_RRE_K_R] = (
            0.5 * (tp.sum((1, 2)) + tq.sum((1, 2))),
            0.5 * (hs * (tp.abs().sum((1, 2)) + tq.abs().sum((1, 2))) + e16 * comp))
    if F.FEAT_SPEARMAN in need:
        # integer 2 dev: cov, an exact integer sum over 4, is the host's
        # exact half-integer sum; the bound covers square roots that a
        # library does not round correctly (PyTorch's on the CPU)
        cov = (pl.rank2[a].to(torch.int64) * pl.rank2[b].to(torch.int64)
               ).sum(1).to(torch.float64) * 0.25
        r = cov / (torch.sqrt(pl.rank_ss[a]) * torch.sqrt(pl.rank_ss[b]))
        out[F.FEAT_SPEARMAN] = (1 - r, 8 * _U * (r.abs() + 1))
    if need & {F.FEAT_D2s, F.FEAT_D2_star}:
        hp, hq = pl.h[a], pl.h[b]
        num = hp * hq
        if F.FEAT_D2s in need:
            den = torch.hypot(hp, hq)
            t = torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 0.0)
            out[F.FEAT_D2s] = (t.sum(1), (hs + e16) * t.abs().sum(1))
        if F.FEAT_D2_star in need:
            cm = (pl.one_mers[a] + pl.one_mers[b]) / (pl.mags[a] + pl.mags[b])[:, None]
            digs = torch.from_numpy(digit_matrix(pl.k)).to(a.device)
            pq1 = cm[:, digs[:, 0]]
            for j in range(1, pl.k):   # the host's order: digit 0 first
                pq1 = pq1 * cm[:, digs[:, j]]
            rma, rmb = pl.real_mags[a], pl.real_mags[b]
            den = ((rma + rmb)[:, None] * pq1 + 1) * torch.sqrt(rma * rmb)[:, None]
            t = torch.where(den > 0, num / torch.where(den <= 0, 1.0, den), 0.0)
            out[F.FEAT_D2_star] = (t.sum(1), (hs + e16) * t.abs().sum(1))
    if F.FEAT_AFD in need:
        first = torch.arange(d, device=a.device) // 4
        df = (x / pl.one_mers[a][:, first] - y / pl.one_mers[b][:, first]).abs()
        un = df * (1 + df) ** -14.0
        v = (un * un).sum(1)
        out[F.FEAT_AFD] = (v, (hs + 4 * e16) * v)
    for flag in _N2:
        if flag in need:
            t = pl.n2(flag)[a] * pl.n2(flag)[b]
            out[flag] = (t.sum(1), (hs + e16) * t.abs().sum(1))
    return out


def _check(pl: Planes, a_idx: torch.Tensor, b_idx: torch.Tensor,
           flags_list: Sequence[int]) -> None:
    counts = pl.counts
    if counts.dtype not in _DTYPES or counts.dim() != 2:
        raise TypeError(f"counts must be uint8/uint16 [N, D], got {counts.dtype} "
                        f"{tuple(counts.shape)}")
    n, d = counts.shape
    if d % 4:
        raise ValueError(f"D = {d} is no multiple of 4 (the groups of 4)")
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be int64 [P], got {t.dtype} {tuple(t.shape)}")
        if t.device != counts.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {counts.device}")
    if a_idx.shape != b_idx.shape and len(b_idx) != 1:
        raise ValueError(f"a_idx {tuple(a_idx.shape)} and b_idx "
                         f"{tuple(b_idx.shape)} differ in length")
    if not flags_list or len(set(flags_list)) != len(flags_list):
        raise ValueError(f"flags {list(flags_list)}: none, or repeated")
    bad = [f for f in flags_list if f not in PLANE_SINGLES]
    if bad:
        raise ValueError(f"flags {bad} are not plane singles")
    if F.FEAT_AFD in flags_list and pl.k != 2:
        raise ValueError("AFD requires k == 2")
    L = table_len(counts.dtype)
    shapes = {"mags": (n,), "real_mags": (n,), "one_mers": (n, 4),
              "log_count": (L,), "log_group": (4 * (L - 1) + 1,), "markov_self": (n,),
              "rank2": (n, d), "rank_ss": (n,), "h": (n, d), "n2r": (n, d),
              "n2rc": (n, d), "n2rrc": (n, d)}
    names = {"mags", "real_mags", "one_mers"}.union(
        *(NEEDS[f] for f in flags_list))
    for name in ["counts"] + sorted(names):
        t = getattr(pl, name)
        if t is None:
            raise ValueError(f"plane {name} was not built")
        dtype = (counts.dtype if name == "counts" else rank_dtype(d) if name == "rank2"
                 else torch.float64)
        shape = tuple(counts.shape) if name == "counts" else shapes[name]
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != counts.device or not t.is_contiguous()):
            raise ValueError(f"plane {name} must be contiguous {dtype} {shape} "
                             f"on {counts.device}")
        # the kernel reads rows in 16-byte vectors
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"plane {name} is not 16-byte aligned")


def plane_singles_ref(pl: Planes, a_idx: torch.Tensor, b_idx: torch.Tensor,
                      flags_list: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version: float64 [2, S, P], values then bounds of
    the plane singles `flags_list` for the pairs (a_idx[p], b_idx[p])."""
    out = torch.empty((2, len(flags_list), len(a_idx)), dtype=torch.float64,
                      device=pl.counts.device)
    b_idx = b_idx.expand(len(a_idx)) if len(b_idx) != len(a_idx) else b_idx
    need = set(flags_list)
    for s in range(0, len(a_idx), _CHUNK):
        got = _plane_terms(pl, a_idx[s:s + _CHUNK], b_idx[s:s + _CHUNK], need)
        for j, flag in enumerate(flags_list):
            out[0, j, s:s + _CHUNK], out[1, j, s:s + _CHUNK] = got[flag]
    return out


def _kernel(dtype: torch.dtype):
    from ._build import load

    fn = getattr(load("plane_singles").lib, f"mc2_plane_singles_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = ([p, i64, i32, i32, p, p, i32, i64] + [p] * 7 + [i32]
                       + [p] * 5 + [ctypes.POINTER(ctypes.c_int), i32, p, p])
        fn.restype = ctypes.c_int
    return fn


def plane_singles(pl: Planes, a_idx: torch.Tensor, b_idx: torch.Tensor,
                  flags_list: Sequence[int]) -> torch.Tensor:
    """float64 [2, S, P]: the values of the plane singles `flags_list` (S
    of model/classifier.py:PLANE_SINGLES, in the caller's order) of the
    pairs (pl.counts[a_idx[p]], pl.counts[b_idx[p]]) (b_idx [1]: the
    center form), then their absolute bounds on |value - the host
    oracle's|.  afd needs k = 2, as on the host.

    On CUDA one launch on the current stream, without syncing; an index
    outside [0, N) gives NaN values and bounds."""
    _check(pl, a_idx, b_idx, flags_list)
    counts = pl.counts
    if counts.device.type == "cpu":
        return plane_singles_ref(pl, a_idx, b_idx, flags_list)
    out = torch.empty((2, len(flags_list), len(a_idx)), dtype=torch.float64,
                      device=counts.device)
    if len(a_idx) == 0:
        return out
    n, d = counts.shape
    codes = (ctypes.c_int * len(flags_list))(*(SINGLE_CODES[f] for f in flags_list))
    ptr = lambda t: None if t is None else t.data_ptr()
    planes = [ptr(t) for t in (pl.mags, pl.real_mags, pl.one_mers, pl.log_count,
                               pl.log_group, pl.markov_self, pl.rank2, pl.rank_ss,
                               pl.h, pl.n2r, pl.n2rc, pl.n2rrc)]
    rank_wide = int(rank_dtype(d) == torch.int32)
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    with torch.cuda.device(counts.device):
        rc = _kernel(counts.dtype)(
            counts.data_ptr(), n, d, pl.k, a_idx.data_ptr(), b_idx.data_ptr(),
            int(len(b_idx) != len(a_idx)), len(a_idx), *planes[:7], rank_wide,
            *planes[7:], codes, len(flags_list), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"plane_singles kernel launch failed: cudaError {rc}")
    plane_singles.launches += 1
    return out


plane_singles.launches = 0  # kernel launches since the last reset
