"""Long records at k = 7: the benchmark's long-record deployment
(benchmark/configs/mc2-fast-id90-k7.json, ~10 kbp records, 16,384-count
uint8 rows) on the port's normal path.

On the CPU: a seeded pool of the cell's traffic shape (benchmark/traffic/
pools-long-10k.json) at 240 records, clustered by the port's CLI on the
recover path with the committed weights (the kernels' plain versions), is
held against the benchmark's plain reference: the same histograms and
CLSTR, and the sampled GLM sums within the configuration's limit; upstream's
auto-k picks 7 on it; the run's clock has the set-up's row passes.  The
same pool, and one with a group of single-site mutants of one template
whose windows hold exact euclidean ties of candidates with other dot
products and self dots, give the JAX package's --device host run's CLSTR
byte for byte: the step's tie guard, which compares only the fields the
model's dist reads, takes those ties as the host does.

On a card (marked cuda, skipped without one): the kernels of the step and of
the phase at D = 16,384 uint8, each against its plain version bit for bit.
Only the comparison with the JAX package imports it, inside its test.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from meshclust2_tpu_torch import cli
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.io.fasta import read_fasta
from meshclust2_tpu_torch.kmer.counting import find_k
from meshclust2_tpu_torch.model.weights import load_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness.check import sum_gap  # noqa: E402
from harness.pools import pool_bytes  # noqa: E402
from harness.sample import DecisionSample  # noqa: E402
import reference as R  # noqa: E402
from reference import compare as C  # noqa: E402

D = 4 ** 7


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


CONFIG = _json("configs", "mc2-fast-id90-k7.json")
TRAFFIC = _json("traffic", "pools-long-10k.json")
WEIGHTS = os.path.join(BENCH, "configs", CONFIG["weights"])


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """The cell's traffic shape at 240 records (12 templates of 20)."""
    path = tmp_path_factory.mktemp("long") / "pool.fasta"
    path.write_bytes(pool_bytes(2**31 + 777, 0, 240, 12, TRAFFIC["len_lo"],
                                TRAFFIC["len_hi"], TRAFFIC["rate_lo"],
                                TRAFFIC["rate_hi"]))
    return str(path)


def _mutant_group(seed: int, n: int, length: int) -> bytes:
    """n records of one random template of `length` bp, each with 1-3
    substitutions: their squared euclidean distances to one another are
    small integers that often tie exactly, from other dot products and
    self dots."""
    rng = np.random.default_rng(seed)
    tmpl = rng.integers(0, 4, length)
    out = []
    for j in range(n):
        seq = tmpl.copy()
        pos = rng.choice(length, int(rng.integers(1, 4)), replace=False)
        seq[pos] = (seq[pos] + rng.integers(1, 4, len(pos))) % 4
        out.append(f">sub_{j}\n" + "".join("ACGT"[b] for b in seq) + "\n")
    return "".join(out).encode()


@pytest.fixture(scope="module")
def tie_pool(pool, tmp_path_factory):
    """The 240-record pool and 20 single-site mutants of a 9,000 bp
    template."""
    path = tmp_path_factory.mktemp("ties") / "pool.fasta"
    with open(pool, "rb") as f:
        path.write_bytes(f.read() + _mutant_group(2, 20, 9_000))
    return str(path)


@pytest.mark.parametrize("which", ["traffic", "ties"])
def test_cli_equals_the_jax_host_run_at_k7(which, pool, tie_pool, tmp_path):
    """The port's CLI on the CPU and the JAX package's --device host run
    give the same CLSTR, byte for byte.  On the pool with mutants the
    port's steps meet exact dist ties of candidates whose dot or self dot
    differ from the best's, which the model's keys (its dist is euclidean
    alone: selfdot - 2 dot) take as exact and every field would not."""
    from meshclust2_tpu.cli import main as jax_main
    from meshclust2_tpu_torch.ops import window_absorb as WA

    path = tie_pool if which == "ties" else pool
    real = WA.window_absorb_ref
    narrowed = []

    def absorb(counts, rows, s, dist, stats, mags, selfdot, *rest, **kw):
        out = real(counts, rows, s, dist, stats, mags, selfdot, *rest, **kw)
        every = real(counts, rows, s, dist, stats, mags, selfdot, *rest,
                     **dict(kw, tie=WA.TIE_ALL))
        if int(every[2][0]) & 2 and not int(out[2][0]) & 2:
            best = int(out[2][2])
            tied = dist == dist[best]
            tied[best] = False
            other = (stats[:, 1] != stats[best, 1]) | (selfdot[rows] != selfdot[rows[best]])
            narrowed.append(bool((tied & other).any()))
        return out

    argv = ["--recover", WEIGHTS, "--delta", str(CONFIG["options"]["delta"]),
            "--iterations", str(CONFIG["options"]["iterations"])]
    port, jax = tmp_path / "port.clstr", tmp_path / "jax.clstr"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(WA, "window_absorb_ref", absorb)
        res = cli.run(["--device", "cpu", *argv, "--output", str(port), path])
    assert res.rc == 0 and res.accumulator.error is None
    assert jax_main(["--device", "host", *argv, "--output", str(jax), path]) == 0
    assert port.read_bytes() == jax.read_bytes()
    if which == "ties":
        assert any(narrowed)


def test_auto_k_picks_7_and_the_configuration_states_its_weights(pool):
    assert find_k([read_fasta(pool)], 1) == 7
    w = load_weights(WEIGHTS)
    assert (w.k, w.id_cutoff, w.datatype) == (CONFIG["k"], CONFIG["id"],
                                              CONFIG["datatype"]) == (7, 0.9, "uint8_t")


def test_cli_equals_the_reference_at_k7(pool, tmp_path):
    out = tmp_path / "out.clstr"
    opts = CONFIG["options"]
    sample = DecisionSample(2**31 + 99, every=1, pairs=64)
    with sample.patched():
        sample.job = 0
        res = cli.run(["--device", "cpu", "--recover", WEIGHTS,
                       "--delta", str(opts["delta"]),
                       "--iterations", str(opts["iterations"]),
                       "--output", str(out), pool])
    assert res.rc == 0
    # the normal path: the session's accumulate loop and update phase
    assert res.accumulator is not None and res.accumulator.error is None
    assert res.accumulator.total_steps > 0 and res.phase is not None
    ps = res.engine.ps
    assert ps.counts.shape == (240, D) and ps.counts.dtype == np.uint8
    ref = R.cluster(pool, WEIGHTS, torch.device("cpu"), **opts)
    limits = CONFIG["limits"]
    assert C.hist_off(ref.headers, ref.counts, list(ps.headers), ps.counts) \
        == limits["hist_off"] == 0
    assert C.clstr_off(ref.keys, str(out)) == limits["clstr_off"] == 0
    a, b, s = sample.by_job()[0]
    assert len(a) > 100
    assert sum_gap(ref, list(ps.headers), a, b, s) <= limits["glm_sum_gap"]

    # the set-up's passes over the matrix: the moments once (one file), the
    # envelope twice on the recover path (the store's refusal, its upload)
    spans = res.clock.spans()
    assert spans["setup.moments"][1] == 1
    assert spans["setup.moments"][3] == "setup.count"
    assert spans["session.envelope"][1] == 2
    assert spans["session.envelope"][3] == "session.upload"


# -- the kernels at D = 16,384 on a card --------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _store(n, seed, dev, high=12):
    """A DeviceStore of n seeded uint8 rows of D counts (up to `high` - 1,
    about what ~10 kbp records give at k = 7) with exact moments, seeded
    lengths and stddevs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    counts = torch.randint(0, high, (n, D), generator=g, device=dev,
                           dtype=torch.uint8)
    c64 = counts.to(torch.int64)
    rng = np.random.default_rng(seed)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return DeviceStore(
        counts=counts, mags=c64.sum(1).to(torch.float64),
        selfdot=(c64 * c64).sum(1).to(torch.float64),
        lens=up(rng.integers(8000, 12000, n).astype(np.float64)),
        stddevs=up(rng.random(n) + 0.5), maxc=int(counts.max()))


def _same_f64(got, want):
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int64), want[~nan].view(torch.int64)))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["center", "pair"])
def test_cuda_decision_at_16384(form):
    """pair_stats_decision at D = 16,384: a center form over a window of
    ~1,500 rows (~25 MB of rows) and a pair form, against the plain
    sequence on stats, s, prob and dist."""
    from meshclust2_tpu_torch.model.classifier import CompiledModel, model_to_torch
    from meshclust2_tpu_torch.ops.pair_stats import (pair_stats_decision,
                                                     pair_stats_decision_ref)

    dev = _cuda()
    n = 2_000
    store = _store(n, 71, dev)
    rng = np.random.default_rng(72)
    a = torch.from_numpy(rng.integers(0, n, 1_500)).to(dev)
    b = (torch.tensor([123], device=dev) if form == "center"
         else torch.from_numpy(rng.integers(0, n, 1_500)).to(dev))
    params = model_to_torch(CompiledModel(load_weights(WEIGHTS).classifier), dev)
    before = pair_stats_decision.launches
    stats, dec = pair_stats_decision(store, params, a, b)
    torch.cuda.synchronize()
    assert pair_stats_decision.launches == before + 1
    p_stats, p_dec = pair_stats_decision_ref(store, params, a, b)
    assert torch.equal(stats, p_stats)
    for row in range(3):
        assert _same_f64(dec[row], p_dec[row]), row


def _step_case(dev, n, w, mcnt, seed, kind):
    """window_step's arguments over an n-row store at D = 16,384: an open
    cluster of mcnt members with its column sums, a window of w alive
    candidates, all positive ("absorb", "tie") or none ("min"); with "tie",
    candidates 3 and 7 share the largest dist, and 7 the squared distance
    to the center of 3 (selfdot - 2 dot) with another dot and selfdot."""
    from meshclust2_tpu_torch.ops.pair_stats import pair_stats_ref
    from meshclust2_tpu_torch.ops.window_absorb import StepState

    rng = np.random.default_rng(seed)
    store = _store(n, seed, dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    order = rng.permutation(n).astype(np.int64)
    flat = rng.permutation(n)
    mem, free = flat[:mcnt], flat[mcnt:]
    alive = np.zeros(n, bool)
    alive[free] = True
    assign = np.full(n, -1, np.int64)
    astep = np.zeros(n, np.int64)
    assign[mem] = 3
    astep[mem] = np.arange(mcnt)
    members = rng.integers(0, n, n + 1).astype(np.int64)
    members[:mcnt] = mem
    cand = np.sort(rng.choice(free, w, replace=False)).astype(np.int64)
    order_t = t(order)
    msum = store.counts[order_t[t(mem)]].to(torch.int64).sum(0)
    s = -(0.75 + rng.random(w)) if kind == "min" else 0.75 + rng.random(w)
    dist = rng.random(w)
    cur_d = t(np.array([mem[0]], np.int64))
    center = order_t[cur_d].expand(w).contiguous()
    stats = pair_stats_ref(store.counts, order_t[t(cand)], center)
    if kind == "tie":
        dist[3] = dist[7] = 2.0
        stats[7] = stats[3] + torch.tensor([3, 7, 11], device=dev)
        store.selfdot[order_t[t(cand[7:8])]] = store.selfdot[order_t[t(cand[3:4])]] + 14
    state = StepState(t(alive), t(assign), t(astep), t(members), msum)
    zero = torch.zeros(w, dtype=torch.float64, device=dev)
    args = (store, order_t, t(cand), t(s), t(dist), stats, state, cur_d)
    kw = dict(cid=3, stepc=n + 7, mcnt=mcnt, pos_edge=0.25, margin=1e-9,
              tie_margin=1e-12, s_err=zero, dist_err=zero.clone())
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("shape,keys", [
    ("window", "model"), ("past_capacity", "model"), ("min", "model"),
    ("tie", "model"), ("tie", "all")])
def test_cuda_window_step_at_16384(shape, keys):
    """window_step at D = 16,384 (16 KB of shared memory a block) against
    its plain version on the trip and every state tensor, with the tie
    guard's keys of the k = 7 model (its dist is euclidean alone) or every
    field: a window of the cell's size; one whose grid (a block per 64
    members and candidates, 66,000 of them) asks for more blocks than can be
    co-resident, the cooperative limit of 1,024 blocks and below, so the
    launch is capped and each block takes several members; a window without
    positives; and an exact tie on the dist whose other fields differ, which
    the model's keys take as exact and every field does not."""
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.ops.window_absorb import (TIE_ALL, TIE_NORM2, StepState,
                                                        tie_keys, window_step,
                                                        window_step_ref)

    dev = _cuda()
    model = CompiledModel(load_weights(WEIGHTS).classifier)
    tie = tie_keys(model.singles, model.combos) if keys == "model" else TIE_ALL
    assert keys == "all" or tie == TIE_NORM2
    n, w, mcnt = {"window": (3_000, 1_500, 40), "past_capacity": (70_000, 16_000, 50_000),
                  "min": (3_000, 1_500, 40), "tie": (3_000, 1_500, 40)}[shape]
    args, kw = _step_case(dev, n, w, mcnt, 81 + len(shape),
                          shape if shape in ("min", "tie") else "absorb")
    kw["tie"] = tie
    if shape == "past_capacity":
        assert (mcnt + w) // 64 > 1024
    clone = lambda: (*args[:6], StepState(*(x.clone() for x in args[6])), args[7])  # noqa: E731
    got = clone()
    before = window_step.launches
    trip = window_step(*got, **kw).clone()
    torch.cuda.synchronize()
    assert window_step.launches == before + 1
    want = clone()
    ref = window_step_ref(*want, **kw)
    assert torch.equal(trip, ref), (trip, ref)
    assert int(trip[0]) == (2 if keys == "all" and shape == "tie" else 0)
    assert int(trip[1]) == (0 if shape == "min" else w)
    for name, g, r in zip(StepState._fields, got[6], want[6]):
        if name == "members":   # slot n is the plain version's scatter sink
            g, r = g[:-1], r[:-1]
        assert torch.equal(g, r), name


@pytest.mark.cuda
def test_cuda_closest_candidates_at_16384():
    """The phase's closest_candidates at D = 16,384 on a seeded state of
    10,000 rows in 1,147 clusters (the 10k default path's shape after
    accumulate), against its plain version on first, unc, the new centers
    and the candidates."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from kernel_ab import phase_state
    from meshclust2_tpu_torch.ops import phase as P

    dev = _cuda()
    arr = phase_state(10_000, 1_147, 288, seed=91)
    t = {k: torch.from_numpy(v).to(dev) for k, v in arr.items()}
    st = P.PhaseState(t["assign"], t["seq"], t["cen"], t["alive"], t["clen"])
    rows = P.PhaseRows(t["lens"], t["blen"], t["elen"])
    n, S, delta = len(st.assign), len(st.cen), 5
    lay = P.new_layout(n, S, delta, dev)
    P.phase_layout_ref(st, rows, delta, lay)
    n_alive, n_pairs = lay.hdr.tolist()
    store = _store(n, 92, dev)
    keep = torch.from_numpy(np.random.default_rng(93).random(n_pairs) < 0.3).to(dev)
    kw = dict(maxc=store.maxc, tie_margin=1e-12)
    want = P.new_candidates(S, delta, dev)
    w_first, w_unc = P.closest_candidates_ref(store.counts, store.mags, keep, st, rows,
                                              delta, lay, n_alive, n_pairs, want, **kw)
    got = P.new_candidates(S, delta, dev)
    before = P.closest_candidates.launches
    first, unc = P.closest_candidates(store.counts, store.mags, keep, st, rows, delta,
                                      lay, n_alive, n_pairs, got, **kw)
    torch.cuda.synchronize()
    assert P.closest_candidates.launches == before + 1
    assert torch.equal(first, w_first) and torch.equal(unc, w_unc)
    assert torch.equal(got.cen, want.cen)
    m = delta * n_alive
    for f in ("a", "b", "seg", "ok"):
        assert torch.equal(getattr(got, f)[:m], getattr(want, f)[:m]), f
