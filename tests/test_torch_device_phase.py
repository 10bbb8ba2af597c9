"""TorchDevicePhaseUpdater, the port's update phase on the card, and the
plain versions of its kernels (ops/phase.py), against the JAX package and
the host engine (--device cpu: the plain versions).

- phase_layout_ref: the alive ranks equal the JAX program's `ranks`
  (meshclust2_tpu/cluster/device_phase.py l. 218-226, taken from the built
  program), the pairs equal the host engine's neighbourhood arrays (b_arr,
  seg; cluster/engine.py:_batched_mean_shift_update) and the JAX program's
  per-offset targets in its tie order (2 delta - o, seq); on the
  post-accumulate state of small and med2000, and on a med2000 state with
  dead slots.
- closest_candidates on CPU tensors (closest_mean_ref, then
  phase_candidates_ref): the new centers equal the engine's (delta = 5 and
  the final delta = 0 pass), the candidates with `ok` equal the engine's
  merge pairs (jj, seg; _merge_pass); the phase's own pass equals the two
  steps apart, and launches no separate candidates kernel.
- merge_replay_ref: a pure-Python replay of the engine's
  `clusters[ret].members.extend(clusters[i].members)` on seeded random
  chains of merges (i -> j -> k included).
- csrc/phase.cu's decompositions, as numpy models (`replay_model`,
  `layout_model`) against the plain versions: the replay's size rounds,
  the warp's sibling offsets and the pointer-jumping path sums on seeded
  random forests, a chain of depth S - 1, a star, no events and every
  alive slot but one merging; the layout's packed rank scan, the flat
  positions' prefix ipre, the tiles' staged windows and center search on
  seeded synthetic states (kernel_ab.py:phase_state) at delta 5 and 0,
  C = 1, singletons, one cluster of 90 % of the rows and dead slots.
- TorchDevicePhaseUpdater.run: clusters, hist, it and pairs equal the JAX
  engine's per-iteration device path (its DeviceUpdater) on small and
  med2000, and the JAX DevicePhaseUpdater.run wherever that one does not
  abort (its double-float32 bounds abort med2000 at iteration 0; the
  port's float64 margins need not trip at the same place, so abort codes
  are compared only where neither aborts).
- The port CLI's default path equals the JAX forced session's CLSTR
  (MC2_FORCE_DEVICE_SESSION=1 MC2_DEVICE_LOOP=1 --device host) byte for
  byte; under a forced MC2_DD_MARGIN the phase aborts, the engine resumes
  on the per-iteration path, and the CLSTR equals the host engine's.
- On a card (marked cuda): each kernel against its plain version, and the
  whole phase against the CPU run; the redesigned layout and replay on the
  cases of their models, a 100k-shaped state and a state above each one's
  shared-memory limit (the wide instantiations, counted apart).
Tolerance: exact throughout (the state is integers, the outputs rows).
"""
import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meshclust2_tpu_torch import cli as torch_cli
from meshclust2_tpu_torch.cluster.device_phase import TorchDevicePhaseUpdater
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.cluster.device_update import TorchDeviceUpdater
from meshclust2_tpu_torch.ops import phase as P
from meshclust2_tpu_torch.ops.closest_mean import closest_mean
from kernel_ab import PHASE_SHAPES, phase_state

torch.set_num_threads(2)

DELTA = 5
SETS = {"small": ("small.fasta", "small_ref_weights.txt"),
        "med2000": ("med2000.fasta", "med2000_weights.txt")}
PHASE_ENV = ("MC2_NO_DEVICE_LOOP", "MC2_NO_DEVICE_UPDATE_BATCH",
             "MC2_NO_DEVICE_SESSION", "MC2_FORCE_DEVICE_SESSION",
             "MC2_DEVICE_LOOP", "MC2_DEVICE_STRICT", "MC2_DD_MARGIN",
             "MC2_DD_TIE_MARGIN", "MC2_NO_NATIVE_UPDATE", "MC2_DEV_MAX_RESUMES")


@pytest.fixture
def clean_env(monkeypatch):
    for k in PHASE_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def accumulated(pkg, fixtures_dir, name):
    """(ps, model, sim, clusters after the host accumulate phase) of a set,
    through package `pkg` (the JAX package or the port)."""
    import importlib

    cli = importlib.import_module(f"{pkg}.cli")
    eng = importlib.import_module(f"{pkg}.cluster.engine")
    bvec = importlib.import_module(f"{pkg}.cluster.bvec")
    clf = importlib.import_module(f"{pkg}.model.classifier")
    wts = importlib.import_module(f"{pkg}.model.weights")
    native = importlib.import_module(f"{pkg}.native")
    fasta, weights = SETS[name]
    w = wts.load_weights(os.path.join(fixtures_dir, weights))
    _, ps = cli.load_sorted_points([os.path.join(fixtures_dir, fasta)], [], w.k,
                                   w.datatype, False)
    ps.seqs = None
    model = clf.CompiledModel(w.classifier)
    engine = eng.MeanShiftEngine(ps, model, w.id_cutoff,
                                 scorer=native.NativeScorer.create(ps, model))
    bv = bvec.BVec(ps.lengths, engine.bin_size)
    bv.insert_all(ps.lengths)
    bv.insert_finalize(ps.lengths)
    return ps, model, w.id_cutoff, engine.accumulate_all(bv)


@pytest.fixture(scope="module")
def pools(fixtures_dir):
    """The JAX package's post-accumulate state of small and med2000."""
    return {name: SimpleNamespace(**dict(zip(
        ("ps", "model", "sim", "clusters"),
        accumulated("meshclust2_tpu", fixtures_dir, name)))) for name in SETS}


def port_phase(pool, device="cpu", **kw):
    return TorchDevicePhaseUpdater(pool.ps, pool.model, pool.sim,
                                   DeviceStore.from_pointset(pool.ps, device),
                                   delta=DELTA, **kw)


class Recorder:
    """An updater that records the engine's batches and answers with the
    port's updater."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []
        self.rechecked_pairs = 0

    def filter_closest(self, *args):
        self.calls.append(("filter", args))
        return self.inner.filter_closest(*args)

    def merge_segmented(self, *args):
        self.calls.append(("merge", args))
        return self.inner.merge_segmented(*args)


def jax_engine(pool, updater):
    """The JAX package's engine over the pool with `updater` as its device
    updater (its per-iteration device path) and no phase."""
    from meshclust2_tpu.cluster.engine import MeanShiftEngine
    from meshclust2_tpu.native import NativeScorer

    engine = MeanShiftEngine(pool.ps, pool.model, pool.sim,
                             scorer=NativeScorer.create(pool.ps, pool.model),
                             delta=DELTA)
    engine.device_session = SimpleNamespace(updater=updater, phase=None)
    return engine


def python_replay(clusters, t_dst):
    """The host engine's merge bookkeeping: in ascending i, the members of
    i join t_dst[i]'s, i is deleted (cluster/engine.py:_merge_pass)."""
    out = [list(m) for m in clusters]
    dead = [False] * len(out)
    for i, d in enumerate(t_dst):
        if d >= 0 and not dead[i]:
            out[d].extend(out[i])
            dead[i] = True
    return out, dead


def dead_slot_state(pool, rng):
    """A med2000 state with dead slots: about a sixth of the clusters merged
    into one of the next three (chains included), and the host's cluster
    list of the same state."""
    from meshclust2_tpu.cluster.engine import Cluster

    S = len(pool.clusters)
    t_dst = np.full(S, -1, np.int64)
    for s in range(S - 3):
        if rng.random() < 0.17:
            t_dst[s] = s + rng.integers(1, 4)
    members, dead = python_replay([c.members for c in pool.clusters], t_dst)
    phase = port_phase(pool)
    st = phase.init_arrays(pool.clusters)
    out = P.new_state(pool.ps.n, S, "cpu")
    P.merge_replay(st, torch.from_numpy(t_dst), out)
    st = out._replace(cen=st.cen)
    host = [Cluster(center_row=c.center_row, members=m)
            for c, m, d in zip(pool.clusters, members, dead) if not d]
    return st, host


def state_for(pool, kind, rng):
    if kind == "dead":
        return dead_slot_state(pool, rng)
    return port_phase(pool).init_arrays(pool.clusters), pool.clusters


def jax_targets(st, rows, delta):
    """The JAX program's filter targets (device_phase.py l. 261-282): for
    each offset o, row r targets the center of rank rank[assign[r]] + o -
    delta; kept when that rank exists and r's length lies in the center's
    window.  Returns (center rank, row) in the order of (rank, 2 delta - o,
    seq), the key of its closest-to-mean ties (l. 374-375)."""
    alive = st.alive.numpy()
    rank = np.cumsum(alive) - alive
    C = int(alive.sum())
    inv = np.nonzero(alive)[0]
    assign, seq = st.assign.numpy(), st.seq.numpy()
    cen, lens = st.cen.numpy(), rows.lens.numpy()
    blen, elen = rows.blen.numpy(), rows.elen.numpy()
    rrank = rank[assign]
    keys = []
    for o in range(2 * delta + 1):
        t = rrank + o - delta
        ok = (t >= 0) & (t < C)
        cr = cen[inv[np.clip(t, 0, C - 1)]]
        ok &= (lens >= blen[cr]) & (lens <= elen[cr])
        r = np.nonzero(ok)[0]
        keys.append(np.stack([t[r], np.full(len(r), 2 * delta - o), seq[r], r]))
    k = np.concatenate(keys, axis=1)
    order = np.lexsort((k[2], k[1], k[0]))
    return k[0][order], k[3][order]


def jax_ranks(pool, alive):
    """(rank, inv, C) of the JAX program's own `ranks` closure."""
    import jax
    import jax.numpy as jnp
    from meshclust2_tpu.cluster.device_phase import DevicePhaseUpdater
    from meshclust2_tpu.cluster.device_session import DeviceStore as JaxStore

    jax.config.update("jax_enable_x64", True)
    jp = DevicePhaseUpdater(pool.ps, pool.model, pool.sim,
                            JaxStore(pool.ps, pool.sim), delta=DELTA)
    cb = jp.pick_cb(len(alive))
    prog = jp._build(cb)
    free = dict(zip(prog.__code__.co_freevars,
                    (c.cell_contents for c in prog.__closure__)))
    pad = np.zeros(cb, bool)
    pad[:len(alive)] = alive
    rank, inv, C = free["ranks"](jnp.asarray(pad))
    return np.asarray(rank)[:len(alive)], np.asarray(inv), int(C)


@pytest.mark.parametrize("name,kind", [("small", "live"), ("med2000", "live"),
                                       ("med2000", "dead")])
def test_phase_layout_ref_equals_the_engine_and_the_jax_targets(pools, name, kind):
    pool = pools[name]
    rng = np.random.default_rng(7)
    st, host = state_for(pool, kind, rng)
    phase = port_phase(pool)
    rows = phase._phase_rows()
    lay = P.new_layout(pool.ps.n, len(st.cen), DELTA, "cpu")
    P.phase_layout(st, rows, DELTA, lay)
    C, n_pairs = lay.hdr.tolist()
    alive = st.alive.numpy()
    assert C == alive.sum() == len(host) and (kind == "live") == alive.all()
    # the JAX program's ranks
    rank, inv, jC = jax_ranks(pool, alive)
    assert jC == C
    np.testing.assert_array_equal(lay.rank.numpy()[alive], rank[alive])
    np.testing.assert_array_equal(lay.inv.numpy()[:C], inv[:C])
    # the member table: each cluster's members in order
    moff = lay.moff.numpy()[:C + 1]
    flat = lay.flat.numpy()
    for k, cl in enumerate(host):
        assert flat[moff[k]:moff[k + 1]].tolist() == list(cl.members)
    # the host engine's neighbourhood arrays
    rec = Recorder(TorchDeviceUpdater(pool.model, DeviceStore.from_pointset(
        pool.ps, "cpu")))
    jax_engine(pool, rec)._batched_mean_shift_update(copy.deepcopy(host), DELTA)
    (what, (cen_rows, b_arr, seg, hC)), = rec.calls
    assert what == "filter" and hC == C and n_pairs == len(b_arr) > 0
    np.testing.assert_array_equal(lay.b_rows[:n_pairs].numpy(), b_arr)
    np.testing.assert_array_equal(lay.seg[:n_pairs].numpy(), seg)
    np.testing.assert_array_equal(lay.a_rows[:n_pairs].numpy(), cen_rows[seg])
    # the JAX program's targets in its tie order
    t_rank, t_row = jax_targets(st, rows, DELTA)
    np.testing.assert_array_equal(lay.seg[:n_pairs].numpy(), t_rank)
    np.testing.assert_array_equal(lay.b_rows[:n_pairs].numpy(), t_row)


@pytest.mark.parametrize("name,kind", [("small", "live"), ("med2000", "live"),
                                       ("med2000", "dead")])
def test_phase_candidates_ref_equals_the_engine(pools, name, kind):
    pool = pools[name]
    st, host = state_for(pool, kind, np.random.default_rng(7))
    phase = port_phase(pool)
    rows = phase._phase_rows()
    S = len(st.cen)
    for delta, final in ((DELTA, False), (0, True)):
        lay = P.new_layout(pool.ps.n, S, delta, "cpu")
        P.phase_layout(st, rows, delta, lay)
        C, n_pairs = lay.hdr.tolist()
        keep, _ = phase.updater.filter_keep(lay.a_rows[:n_pairs], lay.b_rows[:n_pairs])
        cand = P.new_candidates(S, DELTA, "cpu")
        store = phase.store
        first, cunc = P.closest_candidates(
            store.counts, store.mags, keep, st, rows, delta, lay, C, n_pairs, cand,
            maxc=store.maxc, tie_margin=phase.tie_margin, final=final)
        assert not cunc.any()
        # the same as the two plain steps apart, and as the phase's own pass
        want_first, _ = P.closest_mean_ref(store.counts, store.mags,
                                           lay.b_rows[:n_pairs], lay.seg[:n_pairs],
                                           keep, C, maxc=store.maxc,
                                           tie_margin=phase.tie_margin)
        assert torch.equal(first, want_first)
        apart = P.new_candidates(S, DELTA, "cpu")
        P.phase_candidates_ref(st, rows, delta, lay, first, C, n_pairs, apart, final)
        own = P.new_candidates(S, DELTA, "cpu")
        phase._filter(st, rows, delta, lay, C, n_pairs, own, final)
        m = delta * C
        for got in (apart, own):
            assert torch.equal(got.cen, cand.cen)
            for f in ("a", "b", "seg", "ok"):
                assert torch.equal(getattr(got, f)[:m], getattr(cand, f)[:m]), f
        # the engine's new centers over the same clusters
        rec = Recorder(phase.updater)
        engine = jax_engine(pool, rec)
        clusters = copy.deepcopy(host)
        want = engine._batched_mean_shift_update(clusters, delta)
        got = cand.cen.numpy()
        inv = lay.inv.numpy()[:C]
        assert got[inv].tolist() == want
        dead = ~st.alive.numpy()
        np.testing.assert_array_equal(got[dead], st.cen.numpy()[dead])
        if final:
            continue
        # the engine's merge pairs over the new centers
        for c, nc in zip(clusters, want):
            c.center_row = nc
        rec.calls.clear()
        engine._merge_pass(clusters, delta)
        (what, (cen_rows, jj, seg, mC)), = rec.calls
        assert what == "merge" and mC == C
        m = delta * C
        ok = cand.ok[:m].numpy()
        assert ok.sum() == len(jj) > 0
        np.testing.assert_array_equal(cand.a[:m].numpy()[ok], cen_rows[jj])
        np.testing.assert_array_equal(cand.b[:m].numpy()[ok], cen_rows[seg])
        np.testing.assert_array_equal(cand.seg[:m].numpy()[ok], seg)
        pos = np.nonzero(ok)[0]
        np.testing.assert_array_equal(pos // delta + pos % delta + 1, jj)


def random_replay_case(seed: int):
    """A state of 500 rows in 60 slots (some dead after a first round of
    merges) and events t_dst of chains i -> j -> k, from `seed`."""
    rng = np.random.default_rng(seed)
    n, S = 500, 60
    slot = rng.integers(0, S, n)
    slot[:S] = np.arange(S)        # every slot starts non-empty
    clusters = [rng.permutation(np.nonzero(slot == s)[0]).tolist() for s in range(S)]
    first = np.full(S, -1, np.int64)
    for s in range(S - 1):
        if rng.random() < 0.15:
            first[s] = rng.integers(s + 1, min(S, s + 4))
    members, dead = python_replay(clusters, first)
    t_dst = np.full(S, -1, np.int64)
    alive = np.nonzero(~np.asarray(dead))[0]
    for a, s in enumerate(alive[:-1]):
        if rng.random() < 0.4:   # to one of the next alive slots: chains
            t_dst[s] = alive[min(len(alive) - 1, a + rng.integers(1, 3))]
    assign = np.empty(n, np.int64)
    seq = np.empty(n, np.int64)
    for s, m in enumerate(members):
        if not dead[s]:
            assign[m] = s
            seq[m] = np.arange(len(m))
    clen = np.array([0 if d else len(m) for m, d in zip(members, dead)], np.int64)
    st = P.PhaseState(torch.from_numpy(assign), torch.from_numpy(seq),
                      torch.from_numpy(rng.integers(0, n, S)),
                      torch.from_numpy(~np.asarray(dead)), torch.from_numpy(clen))
    return st, t_dst, members, dead


@pytest.mark.parametrize("seed", range(6))
def test_merge_replay_ref_equals_the_engine_replay(seed):
    st, t_dst, members, dead = random_replay_case(seed)
    events = (t_dst >= 0).sum()
    chained = sum(1 for s, d in enumerate(t_dst) if d >= 0 and t_dst[d] >= 0)
    assert events > 5 and chained > 0
    want, gone = python_replay([m if not d else [] for m, d in zip(members, dead)],
                               t_dst)
    out = P.new_state(len(st.assign), len(st.cen), "cpu")
    P.merge_replay(st, torch.from_numpy(t_dst), out)
    alive = out.alive.numpy()
    np.testing.assert_array_equal(alive, ~np.asarray(dead) & ~np.asarray(gone))
    assign, seq, clen = out.assign.numpy(), out.seq.numpy(), out.clen.numpy()
    for s in range(len(alive)):
        rows = np.nonzero(assign == s)[0]
        got = rows[np.argsort(seq[rows])].tolist()
        assert got == (want[s] if alive[s] else [])
        assert clen[s] == len(got)
        if alive[s]:
            assert sorted(seq[rows].tolist()) == list(range(len(rows)))


# -- csrc/phase.cu's decompositions, as numpy models ---------------------------

WARP = 32   # the replay's offsets walk: events a step
STAGE_ROWS, STAGE_CENTERS = 2048, 1024   # what a layout tile stages at most


def replay_model(alive, clen, t_dst):
    """merge_replay as the kernel decomposes it: each event's size in
    rounds of the events whose sources are all applied, the offsets by a
    warp's walk (32 events a step, siblings summed in lane order), the
    final slots and offsets by pointer jumping.  Returns (fin, tot,
    clen_out, alive_out, size rounds, walk steps, jump rounds)."""
    S = len(alive)
    ids = np.arange(S)
    event = alive & (t_dst > ids) & (t_dst < S)
    size = clen.astype(np.int64).copy()
    fin = np.where(event, t_dst, ids)
    ev = np.nonzero(event)[0]
    pend = np.bincount(fin[ev], minlength=S)
    done = np.zeros(S, bool)
    rounds = 0
    while True:
        ready = ev[(pend[ev] == 0) & ~done[ev]]
        np.add.at(size, fin[ready], size[ready])
        np.subtract.at(pend, fin[ready], 1)
        done[ready] = True
        rounds += 1
        if done[ev].all():
            break
    acc = clen.astype(np.int64).copy()
    off = np.zeros(S, np.int64)
    steps = 0
    for e0 in range(0, len(ev), WARP):
        lanes = ev[e0:e0 + WARP]
        d, f = fin[lanes], size[lanes]
        base = acc[d]
        for k in range(len(lanes)):
            off[lanes[k]] = base[k] + f[:k][d[:k] == d[k]].sum()
        for g in np.unique(d):
            acc[g] = base[d == g][0] + f[d == g].sum()
        steps += 1
    moved = fin != ids
    clen_out, alive_out = np.where(moved, 0, size), alive & ~moved
    f0, t0, jumps = fin, off, 0
    while True:
        f1, t1 = f0[f0], t0 + t0[f0]
        jumps += 1
        still = not np.array_equal(f1, f0)
        f0, t0 = f1, t1
        if not still:
            break
    return f0, t0, clen_out, alive_out, rounds, steps, jumps


def layout_model(st, rows, delta, tile):
    """phase_layout as the kernel decomposes it: the scan of (alive, clen)
    packed as alive << 32 | clen, the positions' prefix ipre by center
    rank, the scatter, then tile by tile (`tile` positions) the window of
    member positions (staged when it holds at most STAGE_ROWS rows), each
    position's center by binary search, the kept pairs at the tiles'
    running count.  Returns (rank, inv, moff, flat, a_rows, b_rows, seg, C,
    P, tiles, tiles staged)."""
    assign, seq, cen, alive, clen = (t.numpy() for t in st)
    lens, blen, elen = (t.numpy() for t in rows)
    n = len(assign)
    packed = np.where(alive, (1 << 32) | clen, 0)
    ex = np.cumsum(packed) - packed
    rank, soff = ex >> 32, ex & 0xffffffff
    tot = int(packed.sum())
    C = tot >> 32
    inv = np.nonzero(alive)[0]
    moff = np.append(soff[inv], tot & 0xffffffff)
    js = np.arange(C)
    start = moff[np.maximum(0, js - delta)]
    end = moff[np.minimum(C - 1, js + delta) + 1]
    ipre = np.append(0, np.cumsum(end - start))
    W = int(ipre[-1])
    flat = np.full(n, -1, np.int64)
    flat[soff[assign] + seq] = np.arange(n)
    out, count, staged = [], 0, 0
    tiles = -(-W // tile)
    for t in range(tiles):
        i0, i1 = t * tile, min(W, t * tile + tile)
        jlo = int(np.searchsorted(ipre[:C], i0, side="right")) - 1
        jhi = int(np.searchsorted(ipre[jlo:C], i1 - 1, side="right")) - 1 + jlo
        wlo = start[jlo] + i0 - ipre[jlo]
        whi = start[jhi] + i1 - ipre[jhi]
        if jhi > jlo:
            wlo, whi = min(wlo, start[jlo + 1]), max(whi, end[jhi - 1])
        staged += whi - wlo <= STAGE_ROWS
        assert jhi - jlo < STAGE_CENTERS or delta == 0
        i = np.arange(i0, i1)
        j = np.searchsorted(ipre[jlo:jhi + 1], i, side="right") - 1 + jlo
        x = start[j] + i - ipre[j]
        assert (x >= wlo).all() and (x < whi).all()
        r, c = flat[x], cen[inv[j]]
        keep = (lens[r] >= blen[c]) & (lens[r] <= elen[c])
        out.append(np.stack([c[keep], r[keep], j[keep]]))
        count += int(keep.sum())
    pairs = np.concatenate(out, axis=1) if out else np.zeros((3, 0), np.int64)
    return rank, inv, moff, flat, *pairs, C, count, tiles, staged


def torch_state(arr, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in arr.items()}
    return (P.PhaseState(t["assign"], t["seq"], t["cen"], t["alive"], t["clen"]),
            P.PhaseRows(t["lens"], t["blen"], t["elen"]), t["t_dst"])


def replay_forest(kind: str, seed: int = 0):
    """A state of 600 slots over 2,000 rows and its events t_dst: "chain"
    (s -> s + 1 for every slot, depth S - 1), "star" (every slot into the
    top one), "none", "all_but_one" (every alive slot but the top into a
    random slot above), or "random" (about a quarter into one of the 5
    above, as the merge pass makes them)."""
    S = 600
    arr = phase_state(2_000, S, 150 if kind == "random" else 0, seed=seed)
    rng = np.random.default_rng(seed)
    ids = np.arange(S)
    t = {"chain": ids + 1, "star": np.full(S, S - 1), "none": np.full(S, -1),
         "all_but_one": ids + 1 + (rng.random(S) * (S - 1 - ids)).astype(np.int64),
         "random": arr["t_dst"]}[kind].astype(np.int64)
    t[-1] = -1
    arr["t_dst"] = t
    return arr


@pytest.mark.parametrize("kind", ["chain", "star", "none", "all_but_one", "random"])
def test_replay_decomposition_equals_merge_replay_ref(kind):
    arr = replay_forest(kind, seed=11)
    st, _, t_dst = torch_state(arr)
    out = P.new_state(len(st.assign), len(st.cen), "cpu")
    P.merge_replay_ref(st, t_dst, out)
    fin, tot, clen_out, alive_out, rounds, steps, jumps = replay_model(
        arr["alive"], arr["clen"], arr["t_dst"])
    np.testing.assert_array_equal(fin[arr["assign"]], out.assign.numpy())
    np.testing.assert_array_equal(arr["seq"] + tot[arr["assign"]], out.seq.numpy())
    np.testing.assert_array_equal(clen_out, out.clen.numpy())
    np.testing.assert_array_equal(alive_out, out.alive.numpy())
    E = int((arr["t_dst"] >= 0).sum())
    S = len(arr["alive"])
    # the rounds the kernel takes: the longest chain's, E / 32 walk steps,
    # ceil(log2 depth) + 1 jumps
    want = {"chain": (S - 1, 11), "star": (1, 1), "none": (1, 1)}
    if kind in want:
        assert (rounds, jumps) == want[kind]
    assert steps == -(-E // WARP)


@pytest.mark.parametrize("seed", range(6))
def test_replay_decomposition_on_dead_slots(seed):
    """The replay model on the seeded chains of dead and alive slots of
    test_merge_replay_ref_equals_the_engine_replay."""
    st, t_dst, _, _ = random_replay_case(seed)
    out = P.new_state(len(st.assign), len(st.cen), "cpu")
    P.merge_replay_ref(st, torch.from_numpy(t_dst), out)
    fin, tot, clen_out, alive_out, *_ = replay_model(st.alive.numpy(), st.clen.numpy(),
                                                     t_dst)
    assign = st.assign.numpy()
    np.testing.assert_array_equal(fin[assign], out.assign.numpy())
    np.testing.assert_array_equal(st.seq.numpy() + tot[assign], out.seq.numpy())
    np.testing.assert_array_equal(clen_out, out.clen.numpy())
    np.testing.assert_array_equal(alive_out, out.alive.numpy())


LAYOUT_CASES = {   # (n, S, merges, big, delta)
    "delta5": (3_000, 350, 80, 0.0, 5),
    "delta0": (3_000, 350, 80, 0.0, 0),
    "one_cluster": (800, 1, 0, 0.0, 5),
    "singletons": (1_200, 1_200, 0, 0.0, 5),
    "big90": (6_000, 120, 0, 0.9, 5),
}


def layout_case(name: str, seed: int = 5):
    n, S, merges, big, delta = LAYOUT_CASES[name]
    return phase_state(n, S, merges, seed=seed, big=big), delta


def check_layout(lay, model, n, S):
    rank, inv, moff, flat, a_rows, b_rows, seg, C, n_pairs = model[:9]
    assert lay.hdr.tolist() == [C, n_pairs]
    alive_rank = lay.rank.cpu().numpy()
    np.testing.assert_array_equal(alive_rank[:S], rank)
    for got, want in ((lay.inv[:C], inv), (lay.moff[:C + 1], moff), (lay.flat[:n], flat),
                      (lay.a_rows[:n_pairs], a_rows), (lay.b_rows[:n_pairs], b_rows),
                      (lay.seg[:n_pairs], seg)):
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("per", [1, 4])
@pytest.mark.parametrize("name", list(LAYOUT_CASES) + ["dead"])
def test_layout_decomposition_equals_phase_layout_ref(name, per):
    """At `per` positions a thread: tiles of per TILE positions."""
    if name == "dead":   # the replayed state: dead slots among the alive
        arr, delta = layout_case("delta5")
        st, rows, t_dst = torch_state(arr)
        out = P.new_state(len(st.assign), len(st.cen), "cpu")
        P.merge_replay_ref(st, t_dst, out)
        st = out._replace(cen=st.cen)
        assert not st.alive.all()
    else:
        arr, delta = layout_case(name)
        st, rows, _ = torch_state(arr)
    n, S = len(st.assign), len(st.cen)
    lay = P.new_layout(n, S, delta, "cpu")
    assert lay.scratch.numel() == S + 1 + P.layout_tiles(n, delta)
    P.phase_layout_ref(st, rows, delta, lay)
    model = layout_model(st, rows, delta, per * P.TILE)
    check_layout(lay, model, n, S)
    tiles, staged = model[9:]
    assert tiles <= P.layout_tiles(n, delta)
    # tiles next to one cluster of 90 % of the rows, and the 4,096-position
    # tiles at delta = 0 (a row a position), read their rows from global
    # memory
    assert (staged < tiles) == (name == "big90" or (name, per) == ("delta0", 4))


def jax_per_iteration(pool):
    """The JAX engine's per-iteration device path (its DeviceUpdater) from
    the pool's clusters: (clusters, hist, iterations, pairs)."""
    from meshclust2_tpu.cluster.device_update import DeviceUpdater

    engine = jax_engine(pool, DeviceUpdater(pool.ps, pool.model, pool.sim))
    hist = []
    real = engine._merge_pass

    def merge_pass(clusters, delta):
        out = real(clusters, delta)
        hist.append(len(clusters))
        return out

    engine._merge_pass = merge_pass
    clusters = copy.deepcopy(pool.clusters)
    engine.update_phase(clusters)
    return ([(c.center_row, list(c.members)) for c in clusters], hist,
            engine.stats.update_iterations, engine.stats.pairs_scored)


@pytest.mark.parametrize("name", list(SETS))
def test_phase_run_equals_the_jax_phase(pools, clean_env, name):
    from meshclust2_tpu.cluster.device_phase import DevicePhaseUpdater
    from meshclust2_tpu.cluster.device_session import DeviceStore as JaxStore

    pool = pools[name]
    phase = port_phase(pool)
    res = phase.run(copy.deepcopy(pool.clusters))
    assert res.abort == 0 and res.it == phase.last_iterations == len(res.hist)
    assert phase.scored_pairs == res.pairs
    clean_env.setenv("MC2_NO_NATIVE_UPDATE", "1")
    clusters, hist, its, pairs = jax_per_iteration(pool)
    assert (res.clusters, res.hist, res.it, res.pairs) == (clusters, hist, its, pairs)
    jr = DevicePhaseUpdater(pool.ps, pool.model, pool.sim, JaxStore(pool.ps, pool.sim),
                            delta=DELTA).run(copy.deepcopy(pool.clusters))
    if jr.abort == 0:
        assert ([(c, list(m)) for c, m in jr.clusters], jr.hist, jr.it, jr.pairs) \
            == (res.clusters, res.hist, res.it, res.pairs)
    else:
        # its double-float32 bounds trip first (med2000: at iteration 0)
        assert name == "med2000" and res.hist[:jr.it] == jr.hist
    assert (name, res.it, res.hist[-1]) in (("small", 3, 20), ("med2000", 6, 113))


def test_phase_abort_keeps_the_iteration_start(pools):
    """A forced margin aborts an iteration after the first (med2000 at
    1e-3: the second); the state returned is its start: the memberships
    and counts of a run stopped before it (whose final pass moves centers
    only)."""
    pool = pools["med2000"]
    res = port_phase(pool, margin=1e-3).run(copy.deepcopy(pool.clusters))
    assert res.abort == 1 and res.it >= 1 and res.pairs < 116_481
    ref = port_phase(pool, iterations=res.it).run(copy.deepcopy(pool.clusters))
    assert ref.abort == 0 and ref.hist == res.hist
    assert [m for _, m in ref.clusters] == [m for _, m in res.clusters]


def jax_cli(fixtures_dir, tmp_path, monkeypatch, name, env):
    from meshclust2_tpu.cli import main as jax_main

    fasta, weights = SETS[name]
    out = tmp_path / f"jax_{name}.clstr"
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        assert jax_main(["--device", "host", "--recover",
                         os.path.join(fixtures_dir, weights), "--output",
                         str(out), os.path.join(fixtures_dir, fasta)]) == 0
    return out.read_bytes()


def port_cli(fixtures_dir, tmp_path, name):
    fasta, weights = SETS[name]
    out = tmp_path / f"port_{name}.clstr"
    res = torch_cli.run(["--device", "cpu", "--recover",
                         os.path.join(fixtures_dir, weights), "--output",
                         str(out), os.path.join(fixtures_dir, fasta)])
    assert res.rc == 0
    return out.read_bytes(), res


@pytest.mark.parametrize("name", list(SETS))
def test_default_path_equals_the_jax_forced_session(fixtures_dir, tmp_path,
                                                    clean_env, capsys, name):
    got, res = port_cli(fixtures_dir, tmp_path, name)
    assert "guarded abort" not in capsys.readouterr().out
    assert res.phase is not None and res.updater.scored_pairs == 0
    # one decision object serves the phase and the resume after an abort
    assert res.phase.updater is res.updater
    assert res.phase.last_iterations == res.engine.stats.update_iterations > 0
    want = jax_cli(fixtures_dir, tmp_path, clean_env, name,
                   {"MC2_FORCE_DEVICE_SESSION": "1", "MC2_DEVICE_LOOP": "1"})
    assert got == want


@pytest.mark.parametrize("name,env", [
    ("small", {"MC2_DD_MARGIN": "1e9", "MC2_DEV_MAX_RESUMES": "2"}),
    ("med2000", {"MC2_DD_MARGIN": "3e-3"})])
def test_phase_abort_resumes_to_the_host_output(fixtures_dir, tmp_path,
                                                clean_env, capsys, name, env):
    """small's sums lie far from the edges (no abort up to a margin of
    0.1): every decision uncertain aborts its phase at iteration 0."""
    with clean_env.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        got, res = port_cli(fixtures_dir, tmp_path, name)
    printed = capsys.readouterr().out
    assert "device update phase: guarded abort (stage 1) at iteration " in printed
    assert res.phase.margin == float(env["MC2_DD_MARGIN"])
    want = jax_cli(fixtures_dir, tmp_path, clean_env, name,
                   {"MC2_NO_DEVICE_LOOP": "1", "MC2_NO_DEVICE_SESSION": "1"})
    assert got == want


def test_no_phase_without_the_device_loop_or_the_update_batch(fixtures_dir,
                                                              tmp_path, clean_env):
    for env in ({"MC2_NO_DEVICE_LOOP": "1"}, {"MC2_NO_DEVICE_UPDATE_BATCH": "1"}):
        with clean_env.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            _, res = port_cli(fixtures_dir, tmp_path, "small")
        assert res.phase is None and res.engine.device_session.phase is None


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    """phase_layout, closest_candidates and merge_replay on the card against
    their plain versions on the post-accumulate med2000 state and random
    chains, each wrapper counting its own launches, and the whole phase on
    the card against the CPU run, with one closest_candidates launch a pass
    and no closest_mean launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    ps, model, sim, clusters = accumulated("meshclust2_tpu_torch", fixtures, "med2000")
    pool = SimpleNamespace(ps=ps, model=model, sim=sim, clusters=clusters)
    dev = torch.device("cuda")
    cpu, gpu = port_phase(pool), port_phase(pool, device=dev)
    st_c, st_g = cpu.init_arrays(clusters), gpu.init_arrays(clusters)
    rows_c, rows_g = cpu._phase_rows(), gpu._phase_rows()
    S, n = len(clusters), ps.n
    rng = np.random.default_rng(3)
    wrappers = (P.phase_layout, P.closest_candidates, P.merge_replay)
    for fn in wrappers:
        fn.launches = 0
    for delta in (DELTA, 0):
        lay_c = P.new_layout(n, S, delta, "cpu")
        lay_g = P.new_layout(n, S, delta, dev)
        P.phase_layout(st_c, rows_c, delta, lay_c)
        P.phase_layout(st_g, rows_g, delta, lay_g)
        C, n_pairs = lay_c.hdr.tolist()
        assert lay_g.hdr.tolist() == [C, n_pairs]
        for f in ("a_rows", "b_rows", "seg"):
            assert torch.equal(getattr(lay_g, f)[:n_pairs].cpu(),
                               getattr(lay_c, f)[:n_pairs]), f
        for f, k in (("rank", S), ("inv", C), ("moff", C + 1), ("flat", n)):
            assert torch.equal(getattr(lay_g, f)[:k].cpu(), getattr(lay_c, f)[:k]), f
        keep = torch.from_numpy(rng.random(n_pairs) < 0.3)
        for final in (False, True):
            got = []
            for ph, st, rows, lay, k in ((cpu, st_c, rows_c, lay_c, keep),
                                         (gpu, st_g, rows_g, lay_g, keep.to(dev))):
                cand = P.new_candidates(S, DELTA, ph.device)
                first, unc = P.closest_candidates(
                    ph.store.counts, ph.store.mags, k, st, rows, delta, lay, C,
                    n_pairs, cand, maxc=ph.store.maxc, tie_margin=ph.tie_margin,
                    final=final)
                got.append((first.cpu(), unc.cpu(), cand))
            (first_c, unc_c, cand_c), (first_g, unc_g, cand_g) = got
            assert torch.equal(first_g, first_c) and torch.equal(unc_g, unc_c)
            m = delta * C
            assert torch.equal(cand_g.cen.cpu(), cand_c.cen)
            for f in ("a", "b", "seg", "ok"):
                assert torch.equal(getattr(cand_g, f)[:m].cpu(), getattr(cand_c, f)[:m])
            assert not cand_g.arrive.any()
    for seed in range(4):
        st, t_dst, _, _ = random_replay_case(seed)
        out_c = P.new_state(len(st.assign), len(st.cen), "cpu")
        out_g = P.new_state(len(st.assign), len(st.cen), dev)
        P.merge_replay(st, torch.from_numpy(t_dst), out_c)
        P.merge_replay(P.PhaseState(*(t.to(dev) for t in st)),
                       torch.from_numpy(t_dst).to(dev), out_g)
        for f in ("assign", "seq", "alive", "clen"):
            assert torch.equal(getattr(out_g, f).cpu(), getattr(out_c, f)), f
    assert [fn.launches for fn in wrappers] == [2, 4, 4]
    for fn in wrappers + (closest_mean,):
        fn.launches = 0
    res_g = gpu.run(copy.deepcopy(clusters))
    torch.cuda.synchronize()
    assert res_g == cpu.run(copy.deepcopy(clusters))
    assert res_g.abort == 0 and res_g.pairs == 116_481
    # the phase's closest-to-mean and candidates: one launch a pass
    assert P.closest_candidates.launches == res_g.it + 1 and closest_mean.launches == 0


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["chain", "star", "none", "all_but_one", "random", "wide"])
def test_cuda_merge_replay_cases_equal_plain(kind):
    """The redesigned replay against its plain version, bit for bit, on the
    model's forests and on a state above its shared-memory limit (the wide
    instantiation)."""
    dev = cuda_device()
    if kind == "wide":
        S = P.smem_slots("merge_replay", dev) + 1_000
        arr = phase_state(2 * S, S, S // 4, seed=13)
    else:
        arr = replay_forest(kind, seed=11)
    st, _, t_dst = torch_state(arr, dev)
    n, S = len(st.assign), len(st.cen)
    out, out_p = P.new_state(n, S, dev), P.new_state(n, S, dev)
    P.merge_replay.launches = P.merge_replay.wide_launches = 0
    P.merge_replay(st, t_dst, out)
    P.merge_replay_ref(st, t_dst, out_p)
    torch.cuda.synchronize()
    for f in ("assign", "seq", "alive", "clen"):
        assert torch.equal(getattr(out, f), getattr(out_p, f)), f
    assert (P.merge_replay.launches, P.merge_replay.wide_launches) == (1, int(kind == "wide"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LAYOUT_CASES) + ["dead", "100k", "wide"])
def test_cuda_phase_layout_cases_equal_plain(name):
    """The redesigned layout against its plain version, bit for bit, at
    delta 5 and 0, C = 1, singletons, one cluster of 90 % of the rows, dead
    slots, the 100k shape of kernel_ab.py and a state above its
    shared-memory limit (the wide instantiation)."""
    dev = cuda_device()
    delta = 5
    if name == "100k":
        arr = phase_state(*PHASE_SHAPES["100k"], seed=17)
    elif name == "wide":
        S = P.smem_slots("phase_layout", dev) + 1_000
        arr = phase_state(4 * S, S, 0, seed=19)
    elif name == "dead":
        arr, delta = layout_case("delta5")
    else:
        arr, delta = layout_case(name)
    st, rows, t_dst = torch_state(arr, dev)
    n, S = len(st.assign), len(st.cen)
    if name == "dead":
        out = P.new_state(n, S, dev)
        P.merge_replay_ref(st, t_dst, out)
        st = out._replace(cen=st.cen)
    lay, lay_p = P.new_layout(n, S, delta, dev), P.new_layout(n, S, delta, dev)
    P.phase_layout.launches = P.phase_layout.wide_launches = 0
    P.phase_layout(st, rows, delta, lay)
    P.phase_layout_ref(st, rows, delta, lay_p)
    torch.cuda.synchronize()
    C, n_pairs = lay_p.hdr.tolist()
    assert lay.hdr.tolist() == [C, n_pairs] and n_pairs > 0
    for f, k in (("rank", S), ("inv", C), ("moff", C + 1), ("flat", n),
                 ("a_rows", n_pairs), ("b_rows", n_pairs), ("seg", n_pairs)):
        assert torch.equal(getattr(lay, f)[:k], getattr(lay_p, f)[:k]), f
    assert (P.phase_layout.launches, P.phase_layout.wide_launches) == (1, int(name == "wide"))


def test_phase_launches_no_candidates_kernel_of_its_own(pools, monkeypatch):
    """The phase's candidates run inside closest_candidates (csrc/
    closest_mean.cu's phase instantiation): one call a pass, delta for the
    iterations and 0 for the final pass; csrc/phase.cu has no candidates
    kernel left and ops/phase.py no wrapper for one."""
    from meshclust2_tpu_torch.cluster import device_phase

    calls = []
    real = device_phase.closest_candidates

    def counted(*args, **kwargs):
        calls.append((args[5], kwargs["final"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(device_phase, "closest_candidates", counted)
    res = port_phase(pools["small"]).run(copy.deepcopy(pools["small"].clusters))
    assert res.abort == 0
    assert calls == [(DELTA, False)] * res.it + [(0, True)]
    assert not hasattr(P, "phase_candidates")
    src = os.path.join(os.path.dirname(P.__file__), "..", "csrc", "phase.cu")
    with open(src) as f:
        assert "mc2_phase_candidates" not in f.read()


FOLD_CASES = ["chain", "star", "one_cluster", "few", "final", "no_pairs", "big90",
              "100k", "wide"]


def fold_case(name: str, dev):
    """(state, rows, delta, final) of a closest_candidates case: "chain" and
    "star" the states left by those replays (dead slots), "one_cluster" C
    = 1, "few" C = 3 <= delta, "final" the delta = 0 pass, "no_pairs" P =
    0, "big90" one cluster of 90 % of the rows, "100k" the 100k shape of
    kernel_ab.py, "wide" 12,000 slots (past the phase kernels' shared
    memory)."""
    delta, final = 5, False
    if name in ("chain", "star"):
        st, rows, t_dst = torch_state(replay_forest(name, seed=23), dev)
        out = P.new_state(len(st.assign), len(st.cen), dev)
        P.merge_replay_ref(st, t_dst, out)
        return out._replace(cen=st.cen), rows, delta, final
    if name == "few":
        arr = phase_state(60, 3, 0, seed=29)
    elif name == "100k":
        arr = phase_state(*PHASE_SHAPES["100k"], seed=31)
    elif name == "wide":
        arr = phase_state(36_000, 12_000, 3_000, seed=37)
    else:
        arr, delta = layout_case({"final": "delta0", "no_pairs": "delta5"}.get(name, name))
        final = name == "final"
    st, rows, _ = torch_state(arr, dev)
    return st, rows, delta, final


@pytest.mark.cuda
@pytest.mark.parametrize("name", FOLD_CASES)
def test_cuda_closest_candidates_cases_equal_plain(name):
    """The folded launch (closest-to-mean and the candidates step) against
    its plain version, bit for bit on first, unc, the new centers of all S
    slots and the delta C candidates, twice (the arrival counters come back
    to 0), one launch a call."""
    dev = cuda_device()
    st, rows, delta, final = fold_case(name, dev)
    n, S = len(st.assign), len(st.cen)
    lay = P.new_layout(n, S, delta, dev)
    P.phase_layout_ref(st, rows, delta, lay)
    C, n_pairs = lay.hdr.tolist()
    if name == "no_pairs":
        n_pairs = 0
    rng = np.random.default_rng(41)
    counts = torch.from_numpy(rng.integers(0, 40, (n, 64)).astype(np.uint8)).to(dev)
    mags = counts.sum(dim=1, dtype=torch.int64).to(torch.float64)
    keep = torch.from_numpy(rng.random(n_pairs) < 0.3).to(dev)
    kw = dict(maxc=int(counts.max()), tie_margin=1e-12, final=final)
    want = P.new_candidates(S, delta, dev)
    w_first, w_unc = P.closest_candidates_ref(counts, mags, keep, st, rows, delta, lay,
                                              C, n_pairs, want, **kw)
    P.closest_candidates.launches = 0
    m = delta * C
    got = P.new_candidates(S, delta, dev)
    for _ in range(2):
        got.cen.fill_(-7)
        for f in ("a", "b", "seg"):
            getattr(got, f).fill_(-7)
        first, unc = P.closest_candidates(counts, mags, keep, st, rows, delta, lay, C,
                                          n_pairs, got, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, w_first) and torch.equal(unc, w_unc)
        assert torch.equal(got.cen, want.cen)
        for f in ("a", "b", "seg", "ok"):
            assert torch.equal(getattr(got, f)[:m], getattr(want, f)[:m]), f
        assert not got.arrive.any()
    assert P.closest_candidates.launches == 2


def test_default_path_with_delta_0_equals_the_host_engine(fixtures_dir, tmp_path,
                                                          clean_env):
    """-d 0: each cluster is its own neighbourhood and the merge pass has no
    candidates (empty candidate buffers); the phase runs and the CLSTR
    equals the JAX host engine's."""
    fasta, weights = SETS["small"]
    args = ["-d", "0", "--recover", os.path.join(fixtures_dir, weights)]
    out = tmp_path / "port.clstr"
    res = torch_cli.run(["--device", "cpu", *args, "--output", str(out),
                         os.path.join(fixtures_dir, fasta)])
    assert res.rc == 0 and res.phase is not None and res.phase.delta == 0
    assert res.phase.last_iterations > 0 and res.updater.scored_pairs == 0
    from meshclust2_tpu.cli import main as jax_main

    want = tmp_path / "jax.clstr"
    with clean_env.context() as m:
        m.setenv("MC2_NO_DEVICE_LOOP", "1")
        m.setenv("MC2_NO_DEVICE_SESSION", "1")
        assert jax_main(["--device", "host", *args, "--output", str(want),
                         os.path.join(fixtures_dir, fasta)]) == 0
    assert out.read_bytes() == want.read_bytes()
