"""The port's pair statistics against the JAX Pallas kernel and an int64
oracle, and the fused decision kernel's parameter buffer.

`pair_stats_ref` (what `pair_stats` runs on CPU tensors) must equal
`meshclust2_tpu.ops.pallas_stats.center_block_stats` in interpret mode, as
tests/test_pallas_stats.py runs it, and a numpy int64 oracle, exactly.
`pair_stats_decision`'s plain sequence is held against the JAX package in
tests/test_torch_scorer.py; here a numpy reading of the packed parameters in
the kernel's operation order must give the plain sequence's values.  The
CUDA kernels themselves are held against the plain versions only on a card,
bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu.io.fasta import read_fasta
from meshclust2_tpu.kmer.counting import build_point_set
from meshclust2_tpu.ops.pallas_stats import center_block_stats as jax_center_block_stats
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.features import flags as F
from meshclust2_tpu_torch.model.classifier import (
    PARAM_HEAD, PARAM_STRIDE, SINGLE_CODES, STATS_SINGLES, CompiledModel,
    model_to_torch)
from meshclust2_tpu_torch.model.weights import ModelBlock, load_weights
from meshclust2_tpu_torch.ops.pair_stats import (
    center_block_stats,
    narrow_sums,
    pair_stats,
    pair_stats_decision,
    pair_stats_decision_ref,
    pair_stats_ref,
)

torch.set_num_threads(2)

K_OF_D = {16: 2, 256: 4, 1024: 5}


def oracle(counts, a, b):
    h = counts[a].astype(np.int64)
    c = counts[b].astype(np.int64)
    return np.stack([
        np.minimum(h, c).sum(axis=1),
        (h * c).sum(axis=1),
        np.abs(np.cumsum(h - c, axis=1)).sum(axis=1),
    ], axis=1)


def pairs_counts(fixtures_dir, d, dtype):
    recs = read_fasta(os.path.join(fixtures_dir, "pairs.fasta"))
    ps = build_point_set(recs, K_OF_D[d], {np.uint8: "uint8_t",
                                           np.uint16: "uint16_t"}[dtype])
    return ps.counts


def random_counts(seed, n, d, dtype, high):
    return np.random.default_rng(seed).integers(0, high, (n, d)).astype(dtype)


@pytest.mark.parametrize("d", [16, 256, 1024])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("source", ["pairs", "random"])
def test_center_form_equals_jax_kernel(fixtures_dir, source, dtype, d):
    if source == "pairs":
        counts = pairs_counts(fixtures_dir, d, dtype)
    else:
        # inside the JAX kernel's int32 envelope (dot < 2^31)
        high = 256 if dtype == np.uint8 else 1000
        counts = random_counts(d, 21, d, dtype, high)
    block = np.arange(1, len(counts))          # ragged against tile_b=8
    center = 0
    want = jax_center_block_stats(counts[block], counts[center], tile_b=8,
                                  interpret=True).astype(np.int64)
    np.testing.assert_array_equal(want, oracle(counts, block, np.full(len(block), center)))
    got = center_block_stats(torch.from_numpy(counts[block]),
                             torch.from_numpy(counts[center]))
    assert got.dtype == torch.int64 and got.shape == (len(block), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [16, 256, 1024])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pair_form_equals_oracle(fixtures_dir, dtype, d):
    counts = np.concatenate([
        pairs_counts(fixtures_dir, d, dtype),
        # full-range rows: sums beyond 2^31 need the int64 accumulation
        random_counts(d + 1, 40, d, dtype, np.iinfo(dtype).max + 1),
    ])
    rng = np.random.default_rng(7 + d)
    p = 77                                      # ragged
    a = rng.integers(0, len(counts), p)
    b = rng.integers(0, len(counts), p)
    got = pair_stats(torch.from_numpy(counts), torch.from_numpy(a),
                     torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), oracle(counts, a, b))
    # on the fixture rows (inside the JAX kernel's int32 envelope) each
    # row-vs-row stat equals the JAX kernel's center form for that pair
    fixture = pairs_counts(fixtures_dir, d, dtype)
    n = len(fixture)
    for i in (0, 5):
        want = jax_center_block_stats(fixture, fixture[i], tile_b=8,
                                      interpret=True)
        got = pair_stats(torch.from_numpy(fixture), torch.arange(n),
                         torch.full((n,), i, dtype=torch.int64))
        np.testing.assert_array_equal(got.numpy(), want)


def test_empty_pairs():
    counts = torch.zeros((3, 16), dtype=torch.uint8)
    idx = torch.zeros(0, dtype=torch.int64)
    assert pair_stats(counts, idx, idx).shape == (0, 3)


@pytest.mark.parametrize("case", ["dtype", "idx_dtype", "shape", "idx_shape",
                                  "lengths", "contiguity"])
def test_wrapper_rejects(case):
    counts = torch.zeros((4, 16), dtype=torch.uint8)
    a = torch.zeros(3, dtype=torch.int64)
    b = torch.zeros(3, dtype=torch.int64)
    if case == "dtype":
        counts = counts.to(torch.int32)
    elif case == "idx_dtype":
        a = a.to(torch.int32)
    elif case == "shape":
        counts = counts.reshape(-1)
    elif case == "idx_shape":
        a = a.reshape(3, 1)
    elif case == "lengths":
        b = b[:2]
    elif case == "contiguity":
        counts = torch.zeros((4, 32), dtype=torch.uint8)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        pair_stats(counts, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("d", [16, 64, 256, 1024, 4096])
def test_cuda_kernel_equals_plain(d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    counts = random_counts(d, 300, d, dtype, np.iinfo(dtype).max + 1)
    rng = np.random.default_rng(d)
    a = rng.integers(0, 300, 1001)
    b = rng.integers(0, 300, 1001)
    dev = torch.device("cuda")
    c_d = torch.from_numpy(counts).to(dev)
    a_d = torch.from_numpy(a).to(dev)
    b_d = torch.from_numpy(b).to(dev)
    before = pair_stats.launches
    got = pair_stats(c_d, a_d, b_d)
    torch.cuda.synchronize()
    assert pair_stats.launches == before + 1
    assert torch.equal(got, pair_stats_ref(c_d, a_d, b_d))
    np.testing.assert_array_equal(got.cpu().numpy(), oracle(counts, a, b))


# -- the fused decision ------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ALL_SINGLES = list(STATS_SINGLES)
# every combo kind over every derivable single, one-single combos among them
SYNTH_COMBOS = [
    (F.COMBO_XY, F.FEAT_MANHATTAN | F.FEAT_EMD),
    (F.COMBO_XY2, F.FEAT_EUCLIDEAN | F.FEAT_INTERSECTION),
    (F.COMBO_X2Y, F.FEAT_KULCZYNSKI2 | F.FEAT_SIMRATIO),
    (F.COMBO_X2Y2, F.FEAT_NORMALIZED_VECTORS | F.FEAT_PEARSON_COEFF),
    (F.COMBO_XY, F.FEAT_D2z),
    (F.COMBO_X2Y2, F.FEAT_EUCLIDEAN_Z),
    (F.COMBO_X2Y, F.FEAT_LENGTHD | F.FEAT_EMD),
    (F.COMBO_XY2, F.FEAT_PEARSON_COEFF | F.FEAT_D2z),
]


def synthetic_block(block_cls, raw: np.ndarray, seed: int):
    """A model over all 11 derivable singles with SYNTH_COMBOS, its bounds
    the columns' range over `raw` [P, 11] (ALL_SINGLES order)."""
    rng = np.random.default_rng(seed)
    mins = np.nanmin(raw, axis=0)
    maxs = np.nanmax(raw, axis=0)
    maxs = np.where(maxs > mins, maxs, mins + 1.0)
    return block_cls(combos=list(SYNTH_COMBOS),
                     weights=rng.normal(0.0, 2.0, len(SYNTH_COMBOS) + 1),
                     singles=list(ALL_SINGLES), mins=mins, maxs=maxs)


def moment_store(counts: np.ndarray, seed: int, device="cpu", maxc=True):
    """A DeviceStore over counts with exact mags and self dots and seeded
    lengths and stddevs; maxc=False leaves the largest count unknown (the
    kernel's 64-bit sums)."""
    rng = np.random.default_rng(seed)
    c64 = counts.astype(np.int64)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DeviceStore(
        counts=up(counts), mags=up(c64.sum(axis=1).astype(np.float64)),
        selfdot=up((c64 * c64).sum(axis=1).astype(np.float64)),
        lens=up(rng.integers(700, 1500, len(counts)).astype(np.float64)),
        stddevs=up(rng.random(len(counts)) * 3 + 0.5),
        maxc=int(counts.max()) if maxc else None)


def _torch_fn(fn):
    return lambda x: fn(torch.from_numpy(np.asarray(x, np.float64))).numpy()


# torch's own sqrt and exp: on the CPU they may round an ulp away from
# numpy's (the card's are the CUDA math library's, as the kernel's)
_sqrt, _exp = _torch_fn(torch.sqrt), _torch_fn(torch.exp)


def packed_decision(packed: np.ndarray, stats: np.ndarray, store, a, b):
    """(s, prob, dist) from the packed parameters, in the kernel's order of
    operations (csrc/pair_stats.cu:epilogue), in numpy float64."""
    d = store.counts.shape[1]
    m = {k: getattr(store, k).numpy() for k in ("mags", "selfdot", "stddevs", "lens")}
    ma, mb, sa, sb = m["mags"][a], m["mags"][b], m["selfdot"][a], m["selfdot"][b]
    ta, tb, la, lb = m["stddevs"][a], m["stddevs"][b], m["lens"][a], m["lens"][b]
    summin, dot, emd = (stats[:, i].astype(np.float64) for i in range(3))
    ap, aq = ma * (1.0 / d), mb * (1.0 / d)
    norm2 = (sa + sb) - 2.0 * dot
    cov = dot - (d * ap) * aq
    va, vb = sa - d * (ap * ap), sb - d * (aq * aq)
    raw_of = [
        lambda: (ma + mb) - 2.0 * summin,
        lambda: _sqrt(norm2),
        lambda: (2.0 * summin) / (ma + mb),
        lambda: ((d * (ap + aq)) / ((2.0 * ap) * aq)) * summin,
        lambda: dot / (dot + _sqrt(norm2)),
        lambda: dot / _sqrt(sa * sb),
        lambda: cov / _sqrt(va * vb),
        lambda: cov / (ta * tb),
        lambda: _sqrt((va / (ta * ta) + vb / (tb * tb)) - 2.0 * (cov / (ta * tb))),
        lambda: emd,
        lambda: np.abs(la - lb),
    ]
    n_s, n_c, bias, w0 = packed[:PARAM_HEAD]
    nv = []
    for k in range(int(n_s)):
        code, lo, rng_, sim = packed[PARAM_HEAD + PARAM_STRIDE * k:][:PARAM_STRIDE]
        v = (raw_of[int(code)]() - lo) / rng_
        nv.append(v if sim else 1.0 - v)
    glm = dist = np.zeros(len(a))
    for j in range(int(n_c)):
        kind, i0, i1, w = packed[PARAM_HEAD + PARAM_STRIDE * (int(n_s) + j):][:PARAM_STRIDE]
        x = nv[int(i0)]
        y = nv[int(i1)] if i1 >= 0 else None
        v = {0: lambda: x * y if y is not None else x,
             1: lambda: (x * y) * y,
             2: lambda: (x * x) * y,
             3: lambda: (x * x) * (y * y) if y is not None else x * x}[int(kind)]()
        glm, dist = (v * w, v) if j == 0 else (glm + v * w, dist)
    s = w0 + glm if n_c else np.full(len(a), w0)
    prob = 1.0 / (1.0 + _exp(-np.clip(s, -709.0, 709.0))) + bias
    return s, prob, dist


def port_model(name: str, raw=None) -> CompiledModel:
    if name == "synthetic":
        return CompiledModel(synthetic_block(ModelBlock, raw, 11))
    return CompiledModel(load_weights(os.path.join(FIXTURES, name)).classifier)


def all_raw(store, a, b):
    """[P, 11] raw values of every derivable single (the synthetic model's
    bounds)."""
    from meshclust2_tpu_torch.ops.pair_stats import derive_singles

    t = lambda v: torch.from_numpy(np.array(v))
    st = pair_stats_ref(store.counts, t(a), t(b))
    g = lambda m, i: getattr(store, m)[t(i)]
    return derive_singles(st, g("mags", a), g("mags", b), g("selfdot", a),
                          g("selfdot", b), g("stddevs", a), g("stddevs", b),
                          g("lens", a), g("lens", b), store.counts.shape[1],
                          ALL_SINGLES).numpy()


@pytest.mark.parametrize("name", ["med2000_weights.txt", "bench10k_weights.txt",
                                  "synthetic"])
@pytest.mark.parametrize("form", ["center", "pair"])
def test_packed_params_in_kernel_order_equal_plain(name, form):
    """The kernel's reading of the packed buffer, mirrored in numpy, gives
    the plain sequence's s, prob and dist bit for bit."""
    counts = random_counts(5, 120, 1024, np.uint8, 40)
    store = moment_store(counts, 5)
    rng = np.random.default_rng(6)
    a = rng.integers(0, 120, 200)
    b = np.array([7]) if form == "center" else rng.integers(0, 120, 200)
    model = port_model(name, all_raw(store, a, np.broadcast_to(b, a.shape)))
    params = model_to_torch(model, "cpu")
    stats, dec = pair_stats_decision(store, params, torch.from_numpy(a),
                                     torch.from_numpy(b))
    assert stats.shape == (200, 3) and dec.shape == (5, 200)
    assert dec.dtype == torch.float64
    # no full-vector single: the bounds are 0
    assert not dec[3:].any()
    bb = np.broadcast_to(b, a.shape)
    np.testing.assert_array_equal(stats.numpy(), oracle(counts, a, bb))
    s, prob, dist = packed_decision(params.packed.numpy(), stats.numpy(), store,
                                    a, bb)
    np.testing.assert_array_equal(dec[0].numpy(), s)
    np.testing.assert_array_equal(dec[1].numpy(), prob)
    np.testing.assert_array_equal(dec[2].numpy(), dist)


def test_packed_params_layout():
    model = port_model("med2000_weights.txt")
    pk = model_to_torch(model, "cpu").packed.numpy()
    n_s, n_c = len(model.singles), len(model.combos)
    assert len(pk) == PARAM_HEAD + PARAM_STRIDE * (n_s + n_c)
    np.testing.assert_array_equal(pk[:PARAM_HEAD], [n_s, n_c, model.bias,
                                                    model.weights[0]])
    q = pk[PARAM_HEAD:PARAM_HEAD + PARAM_STRIDE * n_s].reshape(n_s, PARAM_STRIDE)
    assert [SINGLE_CODES[s] for s in model.singles] == q[:, 0].tolist()
    np.testing.assert_array_equal(q[:, 2], model.maxs - model.mins)
    c = pk[PARAM_HEAD + PARAM_STRIDE * n_s:].reshape(n_c, PARAM_STRIDE)
    assert [F.COMBO_TO_CODE[k] for k, _ in model.combos] == c[:, 0].tolist()
    np.testing.assert_array_equal(c[:, 3], model.weights[1:])


@pytest.mark.parametrize("d,maxc,narrow", [
    (1024, 255, True), (4096, 255, True), (1024, 1448, True),
    (1024, 1449, False), (4096, 65535, False), (4096, 724, True), (16, None, False)])
def test_narrow_sums_bound(d, maxc, narrow):
    assert narrow_sums(d, maxc) is narrow


def test_center_form_equals_pair_form():
    counts = random_counts(3, 50, 256, np.uint16, 5000)
    store = moment_store(counts, 3)
    model = port_model("med2000_weights.txt")
    params = model_to_torch(model, "cpu")
    a = torch.arange(50)
    center = pair_stats_decision(store, params, a, torch.tensor([9]))
    pair = pair_stats_decision(store, params, a, torch.full((50,), 9))
    assert all(torch.equal(c, p) for c, p in zip(center, pair))
    assert torch.equal(pair_stats(store.counts, a, torch.tensor([9])), pair[0])


@pytest.mark.parametrize("case", ["moment_dtype", "moment_shape", "packed",
                                  "single", "lengths"])
def test_decision_wrapper_rejects(case):
    counts = random_counts(4, 20, 16, np.uint8, 9)
    store = moment_store(counts, 4)
    params = model_to_torch(port_model("med2000_weights.txt"), "cpu")
    a = b = torch.arange(5)
    if case == "moment_dtype":
        store = DeviceStore(**{**store.__dict__, "mags": store.mags.float()})
    elif case == "moment_shape":
        store = DeviceStore(**{**store.__dict__, "lens": store.lens[:-1]})
    elif case == "packed":
        params = type(params)(**{**params.__dict__, "packed": params.packed.float()})
    elif case == "single":
        params = type(params)(**{**params.__dict__,
                                 "singles": params.singles + (F.FEAT_SPEARMAN,)})
    else:
        b = torch.arange(3)
    with pytest.raises((TypeError, ValueError)):
        pair_stats_decision(store, params, a, b)


def _same_f64(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int64), want[~nan].view(torch.int64)))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sums", ["narrow", "wide"])
@pytest.mark.parametrize("form", ["center", "pair"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("d", [16, 64, 256, 1024, 4096])
def test_cuda_decision_equals_plain(d, dtype, form, sums):
    """The fused kernel against its plain sequence on the card, bit for bit
    on stats, s, prob and dist, in both forms, on the 32-bit and the 64-bit
    sums (the wrapper picks them from the store's largest count)."""
    dev = _cuda_or_skip()
    high = 40 if sums == "narrow" else np.iinfo(dtype).max + 1
    counts = random_counts(d + 17, 300, d, dtype, high)
    store = moment_store(counts, d, dev, maxc=sums == "narrow")
    assert narrow_sums(d, store.maxc) is (sums == "narrow")
    rng = np.random.default_rng(d)
    a = rng.integers(0, 300, 1001)
    b = np.array([123]) if form == "center" else rng.integers(0, 300, 1001)
    host = moment_store(counts, d)
    bb = np.broadcast_to(b, a.shape)
    for name in ("med2000_weights.txt", "synthetic"):
        params = model_to_torch(port_model(name, all_raw(host, a, bb)), dev)
        a_d, b_d = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        before = pair_stats_decision.launches
        stats, dec = pair_stats_decision(store, params, a_d, b_d)
        torch.cuda.synchronize()
        assert pair_stats_decision.launches == before + 1
        p_stats, p_dec = pair_stats_decision_ref(store, params, a_d, b_d)
        assert torch.equal(stats, p_stats)
        np.testing.assert_array_equal(stats.cpu().numpy(), oracle(counts, a, bb))
        for row in range(3):
            assert _same_f64(dec[row], p_dec[row]), (name, row)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["center", "pair"])
@pytest.mark.parametrize("d", [64, 1024])
def test_cuda_decision_many_pairs_a_warp(d, form):
    """150,000 pairs: more than the card holds warps at once, so each warp
    takes several rounds of 32 pairs (and the statistics-only entry the
    same), equal to the plain sequence."""
    dev = _cuda_or_skip()
    counts = random_counts(d, 500, d, np.uint8, 40)
    store = moment_store(counts, d, dev)
    rng = np.random.default_rng(d + 1)
    a = torch.from_numpy(rng.integers(0, 500, 150_000)).to(dev)
    b = (torch.tensor([77], device=dev) if form == "center"
         else torch.from_numpy(rng.integers(0, 500, 150_000)).to(dev))
    params = model_to_torch(port_model("med2000_weights.txt"), dev)
    stats, dec = pair_stats_decision(store, params, a, b)
    only = pair_stats(store.counts, a, b, maxc=store.maxc)
    p_stats, p_dec = pair_stats_decision_ref(store, params, a, b)
    torch.cuda.synchronize()
    assert torch.equal(stats, p_stats) and torch.equal(only, p_stats)
    assert all(_same_f64(dec[r], p_dec[r]) for r in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_cuda_decision_unaligned_store_and_invalid_indices(dtype):
    """A store off a 16-byte boundary takes the element loop and still
    equals the plain sequence; indices outside [0, N) give -1 statistics
    and NaN decisions, in both forms."""
    dev = _cuda_or_skip()
    counts = random_counts(9, 200, 1024, dtype, 50)
    store = moment_store(counts, 9, dev)
    raw = torch.empty(counts.nbytes + 2, dtype=torch.uint8, device=dev)
    shifted = raw[2:].view(store.counts.dtype).view(counts.shape)
    shifted.copy_(store.counts)
    store = DeviceStore(**{**store.__dict__, "counts": shifted})
    params = model_to_torch(port_model("med2000_weights.txt"), dev)
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(0, 200, 500)).to(dev)
    b = torch.from_numpy(rng.integers(0, 200, 500)).to(dev)
    stats, dec = pair_stats_decision(store, params, a, b)
    p_stats, p_dec = pair_stats_decision_ref(store, params, a, b)
    torch.cuda.synchronize()
    assert torch.equal(stats, p_stats)
    assert all(_same_f64(dec[r], p_dec[r]) for r in range(3))
    bad = torch.tensor([-1, 200, 5], device=dev)
    for b_bad in (bad, torch.tensor([200], device=dev)):
        stats, dec = pair_stats_decision(store, params, torch.tensor([3, 4, 200], device=dev),
                                         b_bad)
        torch.cuda.synchronize()
        assert (stats.cpu() == -1).all() and torch.isnan(dec.cpu()).all()
