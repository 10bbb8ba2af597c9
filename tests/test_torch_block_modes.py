"""The block modes of the step kernel and of closest_candidates (a rank of a
row-sharded store, parallel/multihost_session.py) against their one-block
versions, the store's rows split over G blocks in one process, the
exchange summed and the partials stacked as the collectives do it
(window_step_blocks, closest_candidates_blocks).

- The step: every kind of step of tests/test_torch_window_absorb.py
  (absorb, min, on and one ulp below the edge, exact and near window ties,
  a full pool, an uncertain mean), G = 1-4: each block's trip and state bit
  for bit window_step_ref's, and the summed exchange the window's
  statistics and decisions, its positives' column sums and the first
  maximum's row in its owner's seed slot.  A min case whose seed row lies
  on a block other than the first.  Then a closest-to-mean near tie whose
  rows lie on two blocks: a tie margin just above the gap between the
  first minimum and a member with other integers on the other block sets
  the uncertainty, one just below it does not, as the one-block step
  decides.
- closest_candidates: the small and med2000 states after the port's host
  accumulate, G = 1-4, tie margins from the default to one where many
  segments are uncertain: first, unc and the candidates bit for bit
  closest_candidates', the exchange's keep bits the filter's.  A segment
  whose first row and every near row with other integers lie on two
  different blocks.  A uint16 pool at the edge of the int32 exchange (P
  maxc just below 2^31, a segment's column sum past 2^30): the int32 and
  the int64 exchange hold the same sums and give the same result, and the
  int32 one is refused one count past the edge.
Exact throughout.  On a card the kernels against the plain versions.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu_torch.ops import phase as P
from meshclust2_tpu_torch.ops.closest_mean import RowBlock
from meshclust2_tpu_torch.ops.window_absorb import (StepState, seed_slot, step_xbuf_len,
                                                    window_step_blocks, window_step_ref)
from meshclust2_tpu_torch.parallel.mesh import block_bounds
from test_torch_window_absorb import STEP_KINDS, clone_state, step_case

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SETS = {"small": ("small.fasta", "small_ref_weights.txt"),
        "med2000": ("med2000.fasta", "med2000_weights.txt")}
DELTA = 5


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def row_blocks(store, splits):
    """RowBlocks of the store's rows cut at `splits` (ascending)."""
    bounds = [0] + list(splits) + [store.counts.shape[0]]
    return [RowBlock(store.counts[lo:hi].contiguous(), store.mags, store.selfdot,
                     store.lens, store.stddevs, store.maxc, lo, hi)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def even_splits(n: int, G: int):
    return [block_bounds(n, G, g)[0] for g in range(1, G)]


def step_blocks(args, kw, splits):
    """window_step_blocks over the blocks cut at `splits`, each block with
    its own state copy and exchange (a few words longer than the step's):
    (trips, states, exchanges)."""
    store, order, cand, s, dist, stats, _, cur_d = args
    blocks = row_blocks(store, splits)
    dev = store.counts.device
    L = step_xbuf_len(len(cand), store.counts.shape[1], store.counts.element_size(),
                      len(blocks))
    states, scratches, xbufs, curs = [], [], [], []
    for _ in blocks:
        states.append(clone_state(args)[1])
        scratches.append(torch.zeros(4 if dev.type == "cpu" else 1 << 20,
                                     dtype=torch.int64, device=dev))
        xbufs.append(torch.full((L + 3,), -7, dtype=torch.int64, device=dev))
        curs.append(cur_d.clone())
    trips = window_step_blocks(blocks, states, scratches, xbufs, order, cand, s, dist,
                               stats, curs, **kw)
    return trips, states, xbufs


def assert_exchange(args, kw, xbuf, splits):
    """The summed exchange: the window's statistics and (s, dist, s_err,
    dist_err) bits, the column sums of all its positives, and in each
    block's seed slot its own candidates' first maximum's position + 1 and
    row (zeros for a block without one), the window's first maximum in its
    owner's slot; the words past it untouched."""
    store, order, cand, s, dist, stats, _, _ = args
    counts = store.counts.cpu()
    W, d = len(cand), counts.shape[1]
    G = len(splits) + 1
    sw = seed_slot(d, counts.element_size())
    x = xbuf.cpu()
    assert torch.equal(x[:3 * W].view(W, 3), stats.cpu())
    dec = torch.stack([s, dist, kw["s_err"], kw["dist_err"]]).cpu()
    assert torch.equal(x[3 * W:7 * W], dec.view(torch.int64).view(-1))
    rows = order[cand].cpu()
    pos = rows[s.cpu() >= kw["pos_edge"]]
    want = counts[pos].to(torch.int64).sum(dim=0) if counts.dtype == torch.uint8 else \
        (counts.view(torch.int16)[pos].to(torch.int64) & 0xFFFF).sum(dim=0)
    assert torch.equal(x[7 * W:7 * W + d], want)
    seeds = x[7 * W + d:7 * W + d + G * sw].view(G, sw)
    owner = np.searchsorted(np.asarray(splits), rows.numpy(), side="right")
    dist = dist.cpu()
    for g in range(G):
        own = np.nonzero(owner == g)[0]
        if not len(own):
            assert not seeds[g].any()
            continue
        best = int(own[int(torch.argmax(dist[own]))])   # the block's first maximum
        assert int(seeds[g, 0]) == best + 1
        raw = seeds[g, 1:].contiguous().view(torch.uint8)
        row = counts[rows[best]].contiguous().view(torch.uint8)
        assert torch.equal(raw[:len(row)], row) and not raw[len(row):].any()
    # the window's first maximum is its owner's own
    best = int(torch.argmax(dist))
    assert int(seeds[owner[best], 0]) == best + 1
    assert (x[7 * W + d + G * sw:] == -7).all()


def assert_step_equal(args, kw, splits):
    want_args, want_state = clone_state(args)
    want = window_step_ref(*want_args, **kw)
    trips, states, xbufs = step_blocks(args, kw, splits)
    for g, (trip, state, xbuf) in enumerate(zip(trips, states, xbufs)):
        assert torch.equal(trip.cpu(), want.cpu()), (g, trip, want)
        for name, a, b in zip(StepState._fields, state, want_state):
            if name == "members":   # slot n is the plain version's scatter sink
                a, b = a[:-1], b[:-1]
            assert torch.equal(a.cpu(), b.cpu()), (g, name)
        assert_exchange(args, kw, xbuf, splits)
    return want


@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", STEP_KINDS)
def test_step_blocks_equal_one_block(kind, G):
    for dtype, d in ((np.uint8, 16), (np.uint16, 256)):
        args, kw = step_case(d + STEP_KINDS.index(kind), dtype, d, kind)
        assert_step_equal(args, kw, even_splits(args[0].counts.shape[0], G))


@pytest.mark.parametrize("G", [2, 3, 4])
def test_step_min_seed_on_another_block(G):
    """The min case whose seed row lies on block G - 1 (the blocks cut
    below it), so msum comes from a seed slot other than the first's."""
    for dtype, d in ((np.uint8, 16), (np.uint16, 256)):
        for seed in range(77, 177):
            args, kw = step_case(seed + d, dtype, d, "min")
            store, order, cand, _, dist = args[:5]
            seed_row = int(order[cand[int(torch.argmax(dist))]])
            if seed_row >= 16:
                break
        splits = [seed_row * (g + 1) // (G - 1) for g in range(G - 2)] + [seed_row]
        assert sorted(set(splits)) == splits and splits[0] > 0
        want = assert_step_equal(args, kw, splits)
        assert want[0] == 0 and want[1] == 0   # the min case


def member_values(store, order, members, msum, count):
    """Per member of the open cluster after the step: (store row, v, dist2,
    mag), the host's distance to the round-half-up mean."""
    rows = order[members[:count]].numpy()
    h = store.counts.numpy()[rows].astype(np.int64)
    num = msum.numpy()
    q, rem = num // count, num % count
    r = q + (2 * rem >= count)
    dist2 = 2 * np.minimum(h, r[None]).sum(axis=1)
    mag = store.mags.numpy()[rows].astype(np.int64) + q.sum()
    v = 10000.0 * (1.0 - (dist2 / mag) ** 2)
    return rows, v, dist2, mag


def near_tie_step():
    """An absorbing step whose first minimum and the nearest member with
    other integers sit on different store rows: (args, kw, the split
    between their rows, the relative gap)."""
    for seed in range(200):
        args, kw = step_case(1000 + seed, np.uint8, 64, "absorb", n=160)
        got_args, state = clone_state(args)
        trip = window_step_ref(*got_args, **kw)
        if trip[0] != 0 or trip[1] == 0:
            continue
        count = kw["mcnt"] + int(trip[1])
        rows, v, d2, mag = member_values(args[0], args[1], state.members, state.msum, count)
        f = int(np.argmin(v))
        other = (d2 != d2[f]) | (mag != mag[f])
        if not other.any():
            continue
        g = int(np.argmin(np.where(other, v, np.inf)))
        gap = (v[g] - v[f]) / max(abs(v[f]), 1.0)
        if rows[g] == rows[f] or not 1e-6 < gap < 1e-3:
            continue
        return args, kw, sorted([max(rows[f], rows[g])]), gap
    raise AssertionError("no step with a near tie across rows")


@pytest.mark.parametrize("side", ["above", "below"])
def test_step_near_tie_on_another_block(side):
    args, kw, splits, gap = near_tie_step()
    kw["tie_margin"] = gap * (1 + 1e-6 if side == "above" else 1 - 1e-6)
    want = assert_step_equal(args, kw, splits)
    assert want[0] == 0 and int(want[2]) == (side == "above")


def pool_state(name):
    """(store, phase updater, state, rows) after the port's host accumulate
    of a fixture set."""
    from meshclust2_tpu_torch.cli import load_sorted_points
    from meshclust2_tpu_torch.cluster.bvec import BVec
    from meshclust2_tpu_torch.cluster.device_phase import TorchDevicePhaseUpdater
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.cluster.engine import MeanShiftEngine
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import load_weights
    from meshclust2_tpu_torch.native import NativeScorer

    fasta, weights = SETS[name]
    w = load_weights(os.path.join(FIX, weights))
    _, ps = load_sorted_points([os.path.join(FIX, fasta)], [], w.k, w.datatype, False)
    ps.seqs = None
    model = CompiledModel(w.classifier)
    eng = MeanShiftEngine(ps, model, w.id_cutoff, scorer=NativeScorer.create(ps, model))
    bv = BVec(ps.lengths, eng.bin_size)
    bv.insert_all(ps.lengths)
    bv.insert_finalize(ps.lengths)
    clusters = eng.accumulate_all(bv)
    store = DeviceStore.from_pointset(ps, "cpu")
    phase = TorchDevicePhaseUpdater(ps, model, w.id_cutoff, store, delta=DELTA)
    return store, phase, phase.init_arrays(clusters), phase._phase_rows()


@pytest.fixture(scope="module")
def pools():
    return {name: pool_state(name) for name in SETS}


def layout_and_keep(phase, st, rows, delta):
    lay = P.new_layout(len(st.assign), len(st.cen), DELTA, st.cen.device)
    P.phase_layout(st, rows, delta, lay)
    C, n_pairs = lay.hdr.tolist()
    keep, _ = phase.updater.filter_keep(lay.a_rows[:n_pairs], lay.b_rows[:n_pairs])
    return lay, C, n_pairs, keep


def assert_candidates_equal(store, st, rows, delta, lay, C, n_pairs, keep, tie_margin,
                            final, splits):
    S = len(st.cen)
    dev = st.cen.device
    want = P.new_candidates(S, DELTA, dev)
    f0, u0 = P.closest_candidates(store.counts, store.mags, keep, st, rows, delta, lay, C,
                                  n_pairs, want, maxc=store.maxc, tie_margin=tie_margin,
                                  final=final)
    blocks = row_blocks(store, splits)
    outs = [P.new_candidates(S, DELTA, dev) for _ in blocks]
    # the filter's uncertainty bits: every seventh pair's
    func = torch.arange(n_pairs, device=dev) % 7 == 3
    xs = []
    got = P.closest_candidates_blocks(blocks, keep, st, rows, delta, lay, C, n_pairs, outs,
                                      tie_margin=tie_margin, final=final, unc=func,
                                      exchanges=xs)
    m = delta * C
    for g, ((f, u), out) in enumerate(zip(got, outs)):
        assert torch.equal(f, f0) and torch.equal(u, u0), g
        assert torch.equal(out.cen, want.cen), g
        for name in ("a", "b", "seg", "ok"):
            assert torch.equal(getattr(out, name)[:m], getattr(want, name)[:m]), (g, name)
        assert not out.arrive.any(), g
    assert_candidates_exchange(store, lay, n_pairs, C, keep, func, xs[0])
    return f0, u0


def assert_candidates_exchange(store, lay, n_pairs, C, keep, func, x):
    """The summed exchange: the whole filter's keep and uncertainty bits, 32
    positions a word, and every segment's column sums of its kept rows."""
    d = store.counts.shape[1]
    nw = -(-n_pairs // 32)
    assert x.dtype == P.exchange_dtype(n_pairs, store.maxc)
    assert len(x) == P.exchange_words(n_pairs, C, d)
    w = x.cpu().to(torch.int64) & 0xFFFFFFFF
    bits = ((w[:, None] >> torch.arange(32)) & 1).view(-1)
    for i, want in enumerate((keep, func)):
        got = bits[i * 32 * nw:(i + 1) * 32 * nw]
        assert torch.equal(got[:n_pairs].bool(), want.cpu()) and not got[n_pairs:].any()
    whole = RowBlock(store.counts, store.mags, store.selfdot, store.lens, store.stddevs,
                     store.maxc, 0, store.counts.shape[0])
    from meshclust2_tpu_torch.ops.closest_mean import block_sums_ref
    sums = block_sums_ref(whole, lay.b_rows[:n_pairs], lay.seg[:n_pairs], keep, C)
    assert torch.equal(x[2 * nw:].cpu().to(torch.int64).view(C, d), sums.cpu())


@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(SETS))
def test_candidates_blocks_equal_one_block(pools, name, G):
    store, phase, st, rows = pools[name]
    splits = even_splits(store.counts.shape[0], G)
    n_unc = 0
    for delta, final in ((DELTA, False), (0, True)):
        lay, C, n_pairs, keep = layout_and_keep(phase, st, rows, delta)
        for tie_margin in (phase.tie_margin, 1e-3, 3e-2):
            _, unc = assert_candidates_equal(store, st, rows, delta, lay, C, n_pairs, keep,
                                             tie_margin, final, splits)
            n_unc += int(unc.sum())
    assert n_unc > 0   # the wide margins make some segments uncertain


def segment_values(store, lay, n_pairs, keep, C):
    """Per kept position: (segment, store row, v, dist2, mag), the host's
    distance to its segment's round-half-up mean."""
    seg = lay.seg[:n_pairs].numpy()
    rows = lay.b_rows[:n_pairs].numpy()
    k = keep.numpy()
    h = store.counts.numpy()[rows].astype(np.int64)
    num = np.zeros((C, h.shape[1]), np.int64)
    np.add.at(num, seg[k], h[k])
    cnt = np.maximum(np.bincount(seg[k], minlength=C), 1)[:, None]
    q, rem = num // cnt, num % cnt
    r = q + (2 * rem >= cnt)
    dist2 = 2 * np.minimum(h, r[seg]).sum(axis=1)
    mag = store.mags.numpy()[rows].astype(np.int64) + q.sum(axis=1)[seg]
    v = 10000.0 * (1.0 - (dist2 / mag) ** 2)
    return seg, rows, k, v, dist2, mag


def test_candidates_near_tie_on_another_block(pools):
    """A segment whose first row and every kept row within the margin with
    other integers lie on two blocks: the block mode finds its tie, as the
    one-block kernel does."""
    store, phase, st, rows = pools["med2000"]
    lay, C, n_pairs, keep = layout_and_keep(phase, st, rows, DELTA)
    tie_margin = 1e-3
    seg, prow, k, v, d2, mag = segment_values(store, lay, n_pairs, keep, C)
    found = 0
    for c in range(C):
        idx = np.nonzero((seg == c) & k)[0]
        if len(idx) < 2:
            continue
        f = idx[np.argmin(v[idx])]
        thr = tie_margin * max(abs(v[f]), 1.0)
        near = idx[(np.abs(v[idx] - v[f]) <= thr)
                   & ((d2[idx] != d2[f]) | (mag[idx] != mag[f]))]
        if not len(near):
            continue
        if (prow[near] > prow[f]).all():
            split = prow[f] + 1
        elif (prow[near] < prow[f]).all():
            split = prow[f]
        else:
            continue
        _, unc = assert_candidates_equal(store, st, rows, DELTA, lay, C, n_pairs, keep,
                                         tie_margin, False, [int(split)])
        assert bool(unc[c])
        found += 1
        if found == 3:
            break
    assert found


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", STEP_KINDS)
def test_cuda_step_blocks_equal_plain(kind, G):
    """The step kernel's block mode on the card: each block's trip and state
    bit for bit the plain one-block step's, the summed exchange the window's
    (assert_exchange)."""
    dev = cuda_or_skip()
    from meshclust2_tpu_torch.ops.window_absorb import window_step_block

    for dtype, d in ((np.uint8, 1024), (np.uint16, 256)):
        seed = d + STEP_KINDS.index(kind)
        args, kw = step_case(seed, dtype, d, kind, n=3_000)
        want_args, want_state = clone_state(args)
        want = window_step_ref(*want_args, **kw)
        dargs, dkw = step_case(seed, dtype, d, kind, n=3_000, device=dev)
        before = window_step_block.launches
        splits = even_splits(len(args[1]), G)
        trips, states, xbufs = step_blocks(dargs, dkw, splits)
        torch.cuda.synchronize()
        assert window_step_block.launches == before + 3 * G
        for trip, state, xbuf in zip(trips, states, xbufs):
            assert torch.equal(trip.cpu(), want), (trip, want)
            for name, a, b in zip(StepState._fields, state, want_state):
                if name == "members":
                    a, b = a[:-1], b[:-1]
                assert torch.equal(a.cpu(), b), name
            assert_exchange(args, kw, xbuf, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [2, 3, 4])
def test_cuda_step_min_seed_on_another_block(G):
    """The kernel's min case with its seed row on block G - 1: msum from
    that block's seed slot, as the plain one-block step."""
    dev = cuda_or_skip()
    for dtype, d in ((np.uint8, 1024), (np.uint16, 256)):
        for seed in range(77, 177):
            args, kw = step_case(seed + d, dtype, d, "min", n=3_000)
            order, cand, _, dist = args[1:5]
            seed_row = int(order[cand[int(torch.argmax(dist))]])
            if seed_row >= 16:
                break
        splits = [seed_row * (g + 1) // (G - 1) for g in range(G - 2)] + [seed_row]
        want_args, want_state = clone_state(args)
        want = window_step_ref(*want_args, **kw)
        dargs, dkw = step_case(seed + d, dtype, d, "min", n=3_000, device=dev)
        trips, states, xbufs = step_blocks(dargs, dkw, splits)
        torch.cuda.synchronize()
        assert want[0] == 0 and want[1] == 0
        for trip, state in zip(trips, states):
            assert torch.equal(trip.cpu(), want)
            assert torch.equal(state.msum.cpu(), want_state.msum)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(SETS))
def test_cuda_candidates_blocks_equal_plain(name, G):
    """closest_candidates' block mode on the card: first, unc and the
    candidates bit for bit the plain one-block version's."""
    dev = cuda_or_skip()
    store, phase, st, rows = pool_state(name)
    to = lambda t: t.to(dev)
    dstore = type(store)(*(to(x) if torch.is_tensor(x) else x
                           for x in store.__dict__.values()))
    dst = P.PhaseState(*(to(t) for t in st))
    drows = P.PhaseRows(*(to(t) for t in rows))
    splits = even_splits(store.counts.shape[0], G)
    for delta, final in ((DELTA, False), (0, True)):
        lay, C, n_pairs, keep = layout_and_keep(phase, st, rows, delta)
        dlay = P.Layout(*(to(t) for t in lay))
        for tie_margin in (phase.tie_margin, 3e-2):
            want = P.new_candidates(len(st.cen), DELTA, "cpu")
            f0, u0 = P.closest_candidates(store.counts, store.mags, keep, st, rows, delta,
                                          lay, C, n_pairs, want, maxc=store.maxc,
                                          tie_margin=tie_margin, final=final)
            blocks = row_blocks(dstore, splits)
            outs = [P.new_candidates(len(st.cen), DELTA, dev) for _ in blocks]
            before = P.closest_candidates_block.launches
            xs = []
            got = P.closest_candidates_blocks(blocks, to(keep), dst, drows, delta, dlay, C,
                                              n_pairs, outs, tie_margin=tie_margin,
                                              final=final, exchanges=xs)
            want_x = []
            P.closest_candidates_blocks(row_blocks(store, splits), keep, st, rows, delta,
                                        lay, C, n_pairs,
                                        [P.new_candidates(len(st.cen), DELTA, "cpu")
                                         for _ in blocks], tie_margin=tie_margin,
                                        final=final, exchanges=want_x)
            torch.cuda.synchronize()
            assert P.closest_candidates_block.launches == before + 3 * G
            m = delta * C
            for (f, u), out in zip(got, outs):
                assert torch.equal(f.cpu(), f0) and torch.equal(u.cpu(), u0)
                assert torch.equal(out.cen.cpu(), want.cen)
                for fld in ("a", "b", "seg", "ok"):
                    assert torch.equal(getattr(out, fld)[:m].cpu(), getattr(want, fld)[:m])
                assert not out.arrive.any()
            assert torch.equal(xs[0].cpu(), want_x[0])   # the exchange, as the plain one


def edge_pool(n: int = 33_000, d: int = 8):
    """A uint16 store of n rows in one cluster (every pair kept, one
    segment), its counts at most maxc = (2^31 - 1) // P for the P = n pairs
    of the delta = 0 pass, column 0 at maxc in every row: P maxc just below
    2^31 and that segment's column sum near it."""
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore

    n_pairs = n
    maxc = (2 ** 31 - 1) // n_pairs
    rng = np.random.default_rng(5)
    counts = rng.integers(0, maxc + 1, (n, d)).astype(np.uint16)
    counts[:, 0] = maxc
    c64 = counts.astype(np.int64)
    t = torch.from_numpy
    store = DeviceStore(counts=t(counts), mags=t(c64.sum(axis=1).astype(np.float64)),
                        selfdot=t((c64 * c64).sum(axis=1).astype(np.float64)),
                        lens=t(np.full(n, 1000.0)), stddevs=t(rng.random(n)),
                        maxc=int(counts.max()))
    i64 = dict(dtype=torch.int64)
    st = P.PhaseState(torch.zeros(n, **i64), torch.arange(n, **i64), torch.tensor([n // 3]),
                      torch.ones(1, dtype=torch.bool), torch.tensor([n]))
    lens = torch.full((n,), 1000, **i64)
    rows = P.PhaseRows(lens, torch.full((n,), 900, **i64), torch.full((n,), 1100, **i64))
    return store, st, rows


def test_candidates_int32_edge_equals_int64():
    """At the int32 exchange's edge both widths hold the same sums and give
    closest_candidates' result; one count past the edge int32 is refused."""
    store, st, rows = edge_pool()
    n = store.counts.shape[0]
    lay = P.new_layout(n, 1, DELTA, "cpu")
    P.phase_layout(st, rows, 0, lay)
    C, n_pairs = lay.hdr.tolist()
    assert (C, n_pairs) == (1, n)
    assert n_pairs * store.maxc < 2 ** 31 <= n_pairs * (store.maxc + 1)
    assert P.exchange_dtype(n_pairs, store.maxc) == torch.int32
    keep = torch.ones(n_pairs, dtype=torch.bool)
    keep[::9] = False
    want = P.new_candidates(1, DELTA, "cpu")
    f0, u0 = P.closest_candidates(store.counts, store.mags, keep, st, rows, 0, lay, C,
                                  n_pairs, want, maxc=store.maxc, tie_margin=1e-12,
                                  final=True)
    splits = even_splits(n, 3)
    blocks = row_blocks(store, splits)
    exchanges = {}
    for dtype in (torch.int32, torch.int64):
        xs = []
        outs = [P.new_candidates(1, DELTA, "cpu") for _ in blocks]
        got = P.closest_candidates_blocks(blocks, keep, st, rows, 0, lay, C, n_pairs, outs,
                                          tie_margin=1e-12, final=True, dtype=dtype,
                                          exchanges=xs)
        for (f, u), out in zip(got, outs):
            assert torch.equal(f, f0) and torch.equal(u, u0)
            assert torch.equal(out.cen, want.cen)
        assert xs[0].dtype == dtype
        exchanges[dtype] = xs[0]
    nw = -(-n_pairs // 32)
    sums = exchanges[torch.int64][2 * nw:]
    assert int(sums.max()) > 2 ** 30     # the sums near the edge
    assert torch.equal(exchanges[torch.int32].to(torch.int64)[2 * nw:], sums)
    assert torch.equal(exchanges[torch.int32].to(torch.int64)[:2 * nw] & 0xFFFFFFFF,
                       exchanges[torch.int64][:2 * nw])
    # past the edge: the int32 exchange is refused
    past = blocks[0]._replace(maxc=store.maxc + 1)
    own_cs, k, u = P.own_pairs(past, lay.b_rows[:n_pairs], keep)
    with pytest.raises(ValueError, match="int32"):
        P.closest_candidates_block(
            1, past, st, rows, 0, lay, C, n_pairs, P.new_candidates(1, DELTA, "cpu"),
            tie_margin=1e-12, xbuf=torch.zeros(P.exchange_words(n_pairs, C, 8),
                                               dtype=torch.int32),
            own_cs=own_cs, own_keep=k, own_unc=u)
    assert P.exchange_dtype(n_pairs, store.maxc + 1) == torch.int64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_cuda_candidates_int32_edge(dtype):
    """The kernel's exchange at the int32 edge, in either width: the plain
    exchange's words and closest_candidates' result."""
    dev = cuda_or_skip()
    store, st, rows = edge_pool()
    n = store.counts.shape[0]
    lay = P.new_layout(n, 1, DELTA, "cpu")
    P.phase_layout(st, rows, 0, lay)
    C, n_pairs = lay.hdr.tolist()
    keep = torch.ones(n_pairs, dtype=torch.bool)
    keep[::9] = False
    want = P.new_candidates(1, DELTA, "cpu")
    f0, u0 = P.closest_candidates(store.counts, store.mags, keep, st, rows, 0, lay, C,
                                  n_pairs, want, maxc=store.maxc, tie_margin=1e-12,
                                  final=True)
    width = getattr(torch, dtype)
    splits = even_splits(n, 3)
    want_x = []
    P.closest_candidates_blocks(row_blocks(store, splits), keep, st, rows, 0, lay, C,
                                n_pairs, [P.new_candidates(1, DELTA, "cpu")
                                          for _ in range(len(splits) + 1)], tie_margin=1e-12,
                                final=True, dtype=width, exchanges=want_x)
    to = lambda t: t.to(dev)
    dstore = type(store)(*(to(x) if torch.is_tensor(x) else x
                           for x in store.__dict__.values()))
    blocks = row_blocks(dstore, splits)
    outs = [P.new_candidates(1, DELTA, dev) for _ in blocks]
    xs = []
    got = P.closest_candidates_blocks(blocks, to(keep), P.PhaseState(*(to(t) for t in st)),
                                      P.PhaseRows(*(to(t) for t in rows)), 0,
                                      P.Layout(*(to(t) for t in lay)), C, n_pairs, outs,
                                      tie_margin=1e-12, final=True, dtype=width,
                                      exchanges=xs)
    torch.cuda.synchronize()
    assert torch.equal(xs[0].cpu(), want_x[0])
    for (f, u), out in zip(got, outs):
        assert torch.equal(f.cpu(), f0) and torch.equal(u.cpu(), u0)
        assert torch.equal(out.cen.cpu(), want.cen)
