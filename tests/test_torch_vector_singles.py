"""The full-vector singles (the log divergences and the blockwise singles)
and their error bounds, against the JAX package's host oracles and its
float32 device recipes.

`vector_singles_ref` (ops/pair_stats.py, the plain version of the fused
kernel's FULL pass) on random count rows 1..59 at D = 1,024, uint8 and
uint16, eight of them near-identical to their partner (the JAX tests'
`B[:8] = A[:8]; B[:8, :10] += 1`):
  - each value lies within its own bound of meshclust2_tpu/features/host.py
    (float64 numpy), and the bound stays below 1e-9 (|value| + 1);
    mismatch and jaccard are exact;
  - each value lies within the JAX bound plus the port's of the JAX
    package's log_div_stats / block_singles_stats (float32 with bounds).
The decision's error twin (model/classifier.py:decision_errors): with the
port's singles and bounds, |s - s_host| <= s_err and |dist - dist_host| <=
dist_err for the JAX package's CompiledModel on the host singles.  The
window step's gates take the bounds, and a full-vector model's exact tie
needs equal rows.  The CUDA FULL kernel is held against the plain version
and the host oracle only on a card, at every team mapping (one pair, a
window no multiple of the split, 20,000 pairs, D = 16 and 4,096, uint16)
and with bad indices (-1 and NaN).
"""
import functools
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu.features import host as jax_host
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.features import flags as F
from meshclust2_tpu_torch.model.classifier import (
    VECTOR_SINGLES, CompiledModel, decision_errors, model_to_torch)
from meshclust2_tpu_torch.model.weights import ModelBlock
from meshclust2_tpu_torch.ops.pair_stats import (
    pair_stats, pair_stats_decision, pair_stats_decision_ref, pair_stats_ref,
    vector_singles_ref)
from meshclust2_tpu_torch.ops.window_absorb import TIE_ALL, window_absorb_ref

torch.set_num_threads(2)

W, D = 64, 1024
NAMES = {f: F.FEAT_NAMES[f] for f in VECTOR_SINGLES}
DTYPES = {"uint8": np.uint8, "uint16": np.uint16}
LOG = (F.FEAT_JEFFEREY_DIV, F.FEAT_JENSEN_SHANNON)
# models over the full-vector singles, every combo kind among them
MODELS = {
    "slow": ([F.FEAT_MANHATTAN, F.FEAT_INTERSECTION, F.FEAT_JEFFEREY_DIV,
              F.FEAT_JENSEN_SHANNON],
             [(F.COMBO_XY, F.FEAT_INTERSECTION),
              (F.COMBO_XY, F.FEAT_JEFFEREY_DIV | F.FEAT_MANHATTAN),
              (F.COMBO_X2Y2, F.FEAT_JENSEN_SHANNON)]),
    "blockwise": ([F.FEAT_INTERSECTION, F.FEAT_HELLINGER, F.FEAT_CHI_SQUARED,
                   F.FEAT_KL_COND, F.FEAT_MISMATCH],
                  [(F.COMBO_XY, F.FEAT_INTERSECTION),
                   (F.COMBO_XY, F.FEAT_HELLINGER | F.FEAT_CHI_SQUARED),
                   (F.COMBO_XY, F.FEAT_KL_COND | F.FEAT_MISMATCH)]),
    "third": ([F.FEAT_CANBERRA, F.FEAT_KULCZYNSKI1, F.FEAT_SQCHORD,
               F.FEAT_HARMONIC_MEAN, F.FEAT_K_DIV, F.FEAT_JACCARD],
              [(F.COMBO_XY, F.FEAT_CANBERRA),
               (F.COMBO_XY2, F.FEAT_KULCZYNSKI1 | F.FEAT_SQCHORD),
               (F.COMBO_X2Y, F.FEAT_HARMONIC_MEAN | F.FEAT_K_DIV),
               (F.COMBO_X2Y2, F.FEAT_JACCARD | F.FEAT_CANBERRA)]),
}


@functools.lru_cache(maxsize=None)
def blocks(dtype_name: str):
    """Rows A, B [W, D] (eight near-identical pairs), as one store: counts,
    mags (count sums) and the pairs (A[i], B[i])."""
    rng = np.random.default_rng(3)
    A = rng.integers(1, 60, (W, D))
    B = rng.integers(1, 60, (W, D))
    B[:8] = A[:8]
    B[:8, :10] += 1
    counts = np.concatenate([A, B]).astype(DTYPES[dtype_name])
    mags = counts.astype(np.int64).sum(axis=1).astype(np.float64)
    return counts, mags, np.arange(W), np.arange(W, 2 * W)


class _Side:
    pass


def host_side(counts, mags):
    s = _Side()
    s.counts = counts.astype(np.float64)
    s.mags = mags
    s.dim = counts.shape[1]
    s.k = 5
    return s


@functools.lru_cache(maxsize=None)
def port_values(dtype_name: str):
    counts, mags, a, b = blocks(dtype_name)
    v, e = vector_singles_ref(torch.from_numpy(counts), torch.from_numpy(a),
                              torch.from_numpy(b), torch.from_numpy(mags),
                              list(VECTOR_SINGLES))
    return v.numpy(), e.numpy()


@functools.lru_cache(maxsize=None)
def jax_values(dtype_name: str):
    """{flag: (value, bound)} of the JAX package's float32 recipes."""
    import jax
    import jax.numpy as jnp

    from meshclust2_tpu.cluster.device_loop import (block_singles_stats,
                                                    log_div_stats)

    counts, mags, a, b = blocks(dtype_name)
    A, B = counts[a].astype(np.int32), counts[b].astype(np.int32)
    ma, mb = mags[a].astype(np.int32), mags[b].astype(np.int32)
    jd, js, jde, jse = jax.jit(lambda *x: log_div_stats(jnp, *x, True, True))(
        A, B, ma, mb)
    blk = tuple(f for f in VECTOR_SINGLES if f not in LOG)
    out = jax.jit(lambda *x: block_singles_stats(jnp, *x, D, blk))(A, B, ma, mb)
    got = {F.FEAT_JEFFEREY_DIV: (jd, jde), F.FEAT_JENSEN_SHANNON: (js, jse)}
    got.update(out)
    return {f: tuple(np.asarray(x, dtype=np.float64) for x in ve)
            for f, ve in got.items()}


@pytest.mark.parametrize("flag", VECTOR_SINGLES, ids=lambda f: NAMES[f])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_vector_single_within_its_bound_of_the_host_oracle(dtype_name, flag):
    counts, mags, a, b = blocks(dtype_name)
    want = jax_host._DISPATCH[flag](host_side(counts[a], mags[a]),
                                     host_side(counts[b], mags[b]))
    v, e = port_values(dtype_name)
    j = VECTOR_SINGLES.index(flag)
    diff = np.abs(v[:, j] - want)
    assert (diff <= e[:, j]).all(), (diff.max(), e[:, j].max())
    assert (e[:, j] < 1e-9 * (np.abs(want) + 1)).all(), e[:, j].max()
    if flag in (F.FEAT_MISMATCH, F.FEAT_JACCARD):
        assert (diff == 0).all() and (e[:, j] == 0).all()


@pytest.mark.parametrize("flag", VECTOR_SINGLES, ids=lambda f: NAMES[f])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_vector_single_within_the_jax_bounds_of_its_float32_recipe(dtype_name,
                                                                  flag):
    jv, je = jax_values(dtype_name)[flag]
    v, e = port_values(dtype_name)
    j = VECTOR_SINGLES.index(flag)
    assert (np.abs(v[:, j] - jv) <= je + e[:, j]).all()


def test_plain_version_refuses_what_it_cannot_compute():
    counts, mags, a, b = blocks("uint8")
    args = (torch.from_numpy(counts), torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(mags))
    with pytest.raises(ValueError, match="full-vector"):
        vector_singles_ref(*args, [F.FEAT_MANHATTAN])
    with pytest.raises(ValueError, match="multiple of 4"):
        vector_singles_ref(args[0][:, :1022].contiguous(), *args[1:],
                           [F.FEAT_KL_COND])


def store_of(counts, seed=5, device="cpu"):
    rng = np.random.default_rng(seed)
    c64 = counts.astype(np.int64)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return DeviceStore(counts=up(counts),
                       mags=up(c64.sum(axis=1).astype(np.float64)),
                       selfdot=up((c64 * c64).sum(axis=1).astype(np.float64)),
                       lens=up(rng.integers(700, 1500, len(counts)).astype(np.float64)),
                       stddevs=up(rng.random(len(counts)) * 3 + 0.5),
                       maxc=int(counts.max()))


def fitted_model(name, counts, mags, a, b):
    """A model over MODELS[name]: bounds from the host singles' range over
    the pairs, seeded weights."""
    singles, combos = MODELS[name]
    raw = jax_host.compute_singles(singles, host_side(counts[a], mags[a]),
                                   host_side(counts[b], mags[b]))
    lo, hi = raw.min(axis=0), raw.max(axis=0)
    rng = np.random.default_rng(len(singles))
    return CompiledModel(ModelBlock(
        combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
        singles=singles, mins=lo, maxs=np.where(hi > lo, hi, lo + 1.0)))


@pytest.mark.parametrize("form", ["center", "pair"])
@pytest.mark.parametrize("name", list(MODELS))
def test_decision_bounds_hold_against_the_host_decision(name, form):
    """The plain fused sequence: statistics = pair_stats_ref; s, prob and
    dist = derive_singles + decision_from_raw over the vector singles;
    |s - s_host| <= s_err and |dist - dist_host| <= dist_err for the JAX
    CompiledModel on the host singles; decision_errors is the bound."""
    from meshclust2_tpu.model.classifier import CompiledModel as JaxModel

    counts, mags, a, b = blocks("uint8")
    if form == "center":
        b = np.full_like(a, b[0])
    store = store_of(counts)
    model = fitted_model(name, counts, mags, a, b)
    params = model_to_torch(model, "cpu")
    bt = torch.from_numpy(b[:1] if form == "center" else b)
    stats, dec = pair_stats_decision(store, params, torch.from_numpy(a), bt)
    assert torch.equal(stats, pair_stats_ref(store.counts, torch.from_numpy(a),
                                             torch.from_numpy(b)))
    raw = jax_host.compute_singles(model.singles, host_side(counts[a], mags[a]),
                                   host_side(counts[b], mags[b]))
    s_h, prob_h, dist_h = JaxModel(model.block).decision_from_raw(raw)
    s, prob, dist, s_err, dist_err = dec.numpy()
    assert (s_err > 0).all() and (dist_err >= 0).all()
    assert (np.abs(s - s_h) <= s_err).all()
    assert (np.abs(dist - dist_h) <= dist_err).all()
    # the bounds: decision_errors over the singles' own bounds
    vf = [f for f in model.singles if f in VECTOR_SINGLES]
    _, errs = vector_singles_ref(store.counts, torch.from_numpy(a),
                                 torch.from_numpy(b), store.mags, vf)
    err = torch.zeros((len(a), len(model.singles)), dtype=torch.float64)
    for j, f in enumerate(model.singles):
        if f in vf:
            err[:, j] = errs[:, vf.index(f)]
    want = decision_errors(params, torch.from_numpy(raw), err)
    np.testing.assert_allclose(s_err, want[0].numpy(), rtol=1e-9)
    np.testing.assert_allclose(dist_err, want[1].numpy(), rtol=1e-9)


def test_window_gates_take_the_bounds_and_full_ties_need_equal_rows():
    """The step's decisions (window_absorb_ref, the plain version of the
    step kernel's): a sum within 8 s_err of the edge sets bit 1 where the
    relative margin alone does not; a dist within 8 (dist_err + the
    best's) sets bit 2; two candidates with the same statistics and
    moments but different rows tie exactly only without `full`."""
    counts = np.random.default_rng(9).integers(1, 30, (6, 64)).astype(np.uint8)
    counts[3] = counts[2][::-1]       # same sums, another row
    store = store_of(counts)
    rows = torch.tensor([0, 1, 2, 3])
    stats = torch.tensor([[5, 6, 7], [8, 9, 10], [11, 12, 13], [11, 12, 13]])
    # rows 2 and 3: equal moments, as the statistics
    for m in (store.mags, store.selfdot, store.lens, store.stddevs):
        m[3] = m[2]
    s = torch.tensor([3.0, -2.0, 0.25 + 1e-6, -4.0], dtype=torch.float64)
    dist = torch.tensor([0.1, 0.2, 0.5, 0.5], dtype=torch.float64)
    kw = dict(pos_edge=0.25, margin=1e-8, tie_margin=1e-12, tie=TIE_ALL)
    zero = torch.zeros(4, dtype=torch.float64)
    moments = (store.mags, store.selfdot, store.lens, store.stddevs)

    def bits(**extra):
        return int(window_absorb_ref(store.counts, rows, s, dist, stats,
                                     *moments, **kw, **extra)[2][0])

    assert bits(s_err=zero, dist_err=zero) == 0
    assert bits(s_err=zero, dist_err=zero, full=True) == 2
    s_err = zero.clone()
    s_err[2] = 2e-7                   # 8 s_err reaches the edge
    assert bits(s_err=s_err, dist_err=zero) == 1
    dist2 = dist.clone()
    dist2[1] = 0.5 - 1e-9
    for_tie = zero.clone()
    for_tie[1] = 2e-10                # 8 (2e-10 + 0) >= 1e-9
    assert int(window_absorb_ref(store.counts, rows, s, dist2, stats, *moments,
                                 **kw, s_err=zero, dist_err=zero)[2][0]) == 0
    assert int(window_absorb_ref(store.counts, rows, s, dist2, stats, *moments,
                                 **kw, s_err=zero, dist_err=for_tie)[2][0]) == 2
    store.counts[3] = store.counts[2]  # now the rows are equal too
    assert bits(s_err=zero, dist_err=zero, full=True) == 0


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["center", "pair"])
@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_cuda_full_kernel_within_bounds(dtype_name, name, form):
    """The FULL kernel: statistics bit for bit the plain version's; s and
    dist within the bounds of the plain version's and of the host
    decision; the kernel's bounds within 1e-9 relative of the plain
    version's."""
    from meshclust2_tpu.model.classifier import CompiledModel as JaxModel

    dev = _cuda_or_skip()
    counts, mags, a, b = blocks(dtype_name)
    if form == "center":
        b = np.full_like(a, b[0])
    store = store_of(counts, device=dev)
    model = fitted_model(name, counts, mags, a, b)
    params = model_to_torch(model, dev)
    a_d = torch.from_numpy(a).to(dev)
    b_d = torch.from_numpy(b[:1] if form == "center" else b).to(dev)
    before = pair_stats_decision.launches
    stats, dec = pair_stats_decision(store, params, a_d, b_d)
    torch.cuda.synchronize()
    assert pair_stats_decision.launches == before + 1
    p_stats, p_dec = pair_stats_decision_ref(store, params, a_d, b_d)
    assert torch.equal(stats, p_stats)
    assert torch.equal(stats, pair_stats(store.counts, a_d, b_d))
    got, want = dec.cpu().numpy(), p_dec.cpu().numpy()
    for r, e in ((0, 3), (2, 4)):   # s and s_err, dist and dist_err
        assert (np.abs(got[r] - want[r]) <= got[e] + want[e]).all()
    np.testing.assert_allclose(got[3:], want[3:], rtol=1e-9)
    raw = jax_host.compute_singles(model.singles, host_side(counts[a], mags[a]),
                                   host_side(counts[b], mags[b]))
    s_h, _, dist_h = JaxModel(model.block).decision_from_raw(raw)
    assert (np.abs(got[0] - s_h) <= got[3]).all()
    assert (np.abs(got[2] - dist_h) <= got[4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("kind", ["absorb", "on_edge", "tie", "near_tie", "stage2"])
def test_cuda_step_kernel_with_bounds_equals_plain(kind, full):
    """The step kernel with the fused kernel's bounds and, for a model with
    full-vector singles, row identity in exact ties: every state tensor
    and the trip equal the plain version's."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_window_absorb import clone_state, step_case

    from meshclust2_tpu_torch.ops.window_absorb import (StepState, window_step,
                                                        window_step_ref)

    dev = _cuda_or_skip()
    args, kw = step_case(11 + len(kind), np.uint8, 256, kind, n=3_000,
                         device="cuda")
    w = len(args[2])
    rng = np.random.default_rng(len(kind))
    kw.update(s_err=torch.from_numpy(rng.random(w) * 1e-3).to(dev),
              dist_err=torch.from_numpy(rng.random(w) * 1e-13).to(dev),
              full=full)
    got_args, got_state = clone_state(args)
    trip = window_step(*got_args, **kw).clone()
    torch.cuda.synchronize()
    want_args, want_state = clone_state(args)
    want = window_step_ref(*want_args, **kw)
    assert torch.equal(trip, want), (trip, want)
    for name, g, h in zip(StepState._fields, got_state, want_state):
        if name == "members":   # slot n is the plain version's scatter sink
            g, h = g[:-1], h[:-1]
        assert torch.equal(g, h), name


# the FULL kernel's mappings (a team of S warps a pair, chosen by the pair
# count and D): (count type, D, form, pairs)
FULL_CASES = {
    "center W=1": (np.uint8, 1024, "center", 1),
    "center W=37": (np.uint8, 1024, "center", 37),
    "pair P=20000": (np.uint8, 1024, "pair", 20_000),
    "uint8 D=16 pair": (np.uint8, 16, "pair", 300),
    "uint8 D=4096 center": (np.uint8, 4096, "center", 300),
    "uint16 D=1024 center": (np.uint16, 1024, "center", 77),
    "uint16 D=256 pair": (np.uint16, 256, "pair", 400),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("case", list(FULL_CASES))
def test_cuda_full_kernel_mappings_within_bounds(case, name):
    """Each mapping: statistics bit for bit the plain version's, s and dist
    within both bounds of it and within the kernel's bounds of the host
    decision."""
    from meshclust2_tpu.model.classifier import CompiledModel as JaxModel

    dev = _cuda_or_skip()
    dtype, d, form, size = FULL_CASES[case]
    rng = np.random.default_rng(len(case))
    counts = rng.integers(1, 60 if dtype == np.uint8 else 3000, (300, d))
    counts[8:16] = counts[:8]
    counts[8:16, :max(2, d // 100)] += 1
    counts = counts.astype(dtype)
    mags = counts.astype(np.int64).sum(axis=1).astype(np.float64)
    a = rng.integers(0, 300, size)
    a[:min(8, size)] = np.arange(min(8, size))
    b = np.full(size, 8) if form == "center" else rng.integers(0, 300, size)
    if form == "pair":
        b[:8] = np.arange(8, 16)
    store = store_of(counts, device=dev)
    model = fitted_model(name, counts, mags, a, b)
    params = model_to_torch(model, dev)
    a_d = torch.from_numpy(a).to(dev)
    b_d = torch.from_numpy(b[:1] if form == "center" else b).to(dev)
    stats, dec = pair_stats_decision(store, params, a_d, b_d)
    torch.cuda.synchronize()
    p_stats, p_dec = pair_stats_decision_ref(store, params, a_d, b_d)
    assert torch.equal(stats, p_stats)
    got, want = dec.cpu().numpy(), p_dec.cpu().numpy()
    for r, e in ((0, 3), (2, 4)):
        assert (np.abs(got[r] - want[r]) <= got[e] + want[e]).all()
    raw = jax_host.compute_singles(model.singles, host_side(counts[a], mags[a]),
                                   host_side(counts[b], mags[b]))
    s_h, _, dist_h = JaxModel(model.block).decision_from_raw(raw)
    assert (np.abs(got[0] - s_h) <= got[3]).all()
    assert (np.abs(got[2] - dist_h) <= got[4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["pair", "center"])
def test_cuda_full_kernel_bad_index_gives_nan(form):
    """An index outside the store: -1 statistics and NaN decisions for its
    pair (every pair for a bad center), the others as the plain version."""
    dev = _cuda_or_skip()
    counts, mags, a, b = blocks("uint8")
    store = store_of(counts, device=dev)
    params = model_to_torch(fitted_model("slow", counts, mags, a, b), dev)
    n = len(counts)
    a_d = torch.tensor([3, n, 4, -1], device=dev)
    b_d = (torch.tensor([70, 71, 72, 73], device=dev) if form == "pair"
           else torch.tensor([70], device=dev))
    stats, dec = pair_stats_decision(store, params, a_d, b_d)
    _, bad = pair_stats_decision(store, params, a_d[:1], torch.tensor([n], device=dev))
    torch.cuda.synchronize()
    assert (stats[[1, 3]] == -1).all() and torch.isnan(dec[:, [1, 3]]).all()
    assert (stats[[0, 2]] >= 0).all() and torch.isfinite(dec[:, [0, 2]]).all()
    assert torch.isnan(bad).all()
