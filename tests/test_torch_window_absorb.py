"""The accumulate step's tail against a numpy reference, the host scorer
and the accumulator's earlier torch sequence.

`window_absorb_ref` (the decisions of the plain step) must equal a numpy
transcription exactly (positives, column sums, bits, count, best); on
constructed windows its gate and tie bits must fire where a decision sits
on its edge or two candidates with different inputs tie, and not where
exact copies tie; on med2000 windows scored by the port's epilogue,
wherever it sets no bit, the positives and the best must be the host
scorer's (round(prob) > 0, first maximum of dist).  `window_step_ref`
(what `window_step` runs on CPU tensors) must leave every state tensor and
the trip exactly as the accumulator's earlier sequence (window_absorb_ref,
the gated torch updates, closest_mean_ref's one-segment mode) does, in
the absorb and min cases, on and one ulp off the edge, at exact and near
ties, when the mean is uncertain (stage 2) and when the member list
reaches n.  Tolerance: exact throughout.  The CUDA step kernel is held
against the plain version only on a card.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu.cli import load_sorted_points
from meshclust2_tpu.cluster.device_loop import _pack_model, resolve_margins
from meshclust2_tpu.cluster.engine import HostScorer, c_round
from meshclust2_tpu.model.classifier import CompiledModel
from meshclust2_tpu.model.weights import load_weights
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.model.classifier import model_to_torch
from meshclust2_tpu_torch.ops.closest_mean import closest_mean_ref
from meshclust2_tpu_torch.ops.pair_stats import pair_stats_decision, pair_stats_ref
from meshclust2_tpu_torch.ops.window_absorb import (
    TIE_ALL, TIE_DOT, TIE_EMD, TIE_MANH, TIE_NORM2, TIE_SELFDOT, StepState, tie_keys,
    window_absorb_ref, window_step, window_step_ref)

torch.set_num_threads(2)

MARGIN, TIE_MARGIN = 1e-8, 1e-12


def numpy_absorb(counts, rows, s, dist, stats, moments, edge, margin, tie_margin):
    pos = s >= edge
    scale = np.maximum(np.maximum(np.abs(s), abs(edge)), 1.0)
    bits = int((np.abs(s - edge) <= margin * scale).any())
    best = len(rows)
    if len(rows):
        best = int(np.argmax(dist))
        bv = dist[best]
        near = np.abs(dist - bv) <= tie_margin * max(abs(bv), 1.0)
        same = (dist == bv) & (stats == stats[best]).all(axis=1)
        for m in moments:
            same &= m[rows] == m[rows[best]]
        bits |= 2 * int((near & ~same).any())
    colsum = counts[rows[pos]].astype(np.int64).sum(axis=0)
    return pos, colsum, np.array([bits, pos.sum(), best])


def window_case(seed, n_rows, d, dtype, n_cand):
    """A store, candidate rows (repeats among them) and their statistics
    against one center, with random s and dist."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, np.iinfo(dtype).max + 1, (n_rows, d)).astype(dtype)
    rows = rng.integers(0, n_rows, n_cand).astype(np.int64)
    center = np.full(n_cand, rng.integers(0, n_rows), np.int64)
    stats = pair_stats_ref(torch.from_numpy(counts), torch.from_numpy(rows),
                           torch.from_numpy(center)).numpy()
    moments = [rng.integers(1, 50, n_rows).astype(np.float64) for _ in range(4)]
    s = rng.normal(0.0, 2.0, n_cand)
    dist = rng.random(n_cand)
    return counts, rows, s, dist, stats, moments


def port_absorb(counts, rows, s, dist, stats, moments, edge, margin=MARGIN,
                tie_margin=TIE_MARGIN):
    t = torch.from_numpy
    zero = torch.zeros(len(rows), dtype=torch.float64)
    pos, colsum, info = window_absorb_ref(
        t(counts), t(rows), t(s), t(dist), t(stats), *(t(m) for m in moments),
        pos_edge=edge, margin=margin, tie_margin=tie_margin, s_err=zero,
        dist_err=zero, tie=TIE_ALL)
    assert pos.dtype == torch.bool and colsum.dtype == info.dtype == torch.int64
    return pos.numpy(), colsum.numpy(), info.numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("d,n_cand", [(16, 0), (16, 1), (256, 97), (1024, 2048)])
def test_plain_equals_numpy(dtype, d, n_cand):
    case = window_case(d + n_cand, 300, d, dtype, n_cand)
    got = port_absorb(*case, edge=0.25)
    want = numpy_absorb(*case, 0.25, MARGIN, TIE_MARGIN)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_edge_straddling_sums_set_the_gate_bit():
    counts, rows, s, dist, stats, moments = window_case(1, 50, 16, np.uint8, 6)
    edge = 0.75
    s[:] = [-3.0, 4.0, 2.0, -1.0, 9.0, -5.0]
    pos, _, info = port_absorb(counts, rows, s, dist, stats, moments, edge)
    assert info[0] == 0 and info[1] == 3
    np.testing.assert_array_equal(pos, s >= edge)
    # on the edge: positive, and uncertain; one ulp below: not positive
    s[2] = edge
    s[3] = np.nextafter(edge, -np.inf)
    pos, _, info = port_absorb(counts, rows, s, dist, stats, moments, edge)
    assert info[0] & 1 and pos[2] and not pos[3] and info[1] == 3
    # just outside the margin: certain again
    s[2] = edge + 2 * MARGIN * edge
    s[3] = edge - 2 * MARGIN * edge
    pos, _, info = port_absorb(counts, rows, s, dist, stats, moments, edge)
    assert info[0] == 0 and pos[2] and not pos[3]


def test_ties():
    counts, rows, s, dist, stats, moments = window_case(2, 50, 64, np.uint8, 8)
    stats = stats.copy()
    # an exact copy of the best (same row, so the same statistics and
    # moments) ties it without doubt: the first position wins
    rows[5] = rows[2]
    stats[5] = stats[2]
    dist[:] = 0.5
    dist[2] = dist[5] = 0.9
    _, _, info = port_absorb(counts, rows, s, dist, stats, moments, -1e9)
    assert info[0] == 0 and info[2] == 2
    # an equal dist from other inputs: the host's float64 could rank it
    # either way
    dist[6] = 0.9
    _, _, info = port_absorb(counts, rows, s, dist, stats, moments, -1e9)
    assert info[0] == 2 and info[2] == 2
    # within the tie margin, and just outside it
    dist[6] = 0.9 * (1 - 0.5 * TIE_MARGIN)
    assert port_absorb(counts, rows, s, dist, stats, moments, -1e9)[2][0] == 2
    dist[6] = 0.9 * (1 - 4 * TIE_MARGIN)
    assert port_absorb(counts, rows, s, dist, stats, moments, -1e9)[2][0] == 0


def test_ties_compare_the_keys_the_dist_reads():
    """With a model's keys (tie_keys: its dist is its first combo's value),
    a near candidate whose dist and keys equal the best's ties it exactly
    though other fields differ; one whose keys differ still sets bit 2."""
    counts, rows, s, dist, stats, moments = window_case(4, 50, 64, np.uint8, 8)
    stats, moments = stats.copy(), [m.copy() for m in moments]
    mags, selfdot = moments[0], moments[1]
    dist[:] = 0.5
    dist[2] = dist[5] = 0.9
    rows[5] = 49 if rows[2] != 49 else 48
    # candidate 5: another row, the best's selfdot - 2 dot and mags - 2 summin
    stats[5] = stats[2] + [3, 7, 11]
    selfdot[rows[5]] = selfdot[rows[2]] + 14
    mags[rows[5]] = mags[rows[2]] + 6

    def bits(keys):
        t = torch.from_numpy
        zero = torch.zeros(len(rows), dtype=torch.float64)
        return int(window_absorb_ref(
            t(counts), t(rows), t(s), t(dist), t(stats), *(t(m) for m in moments),
            pos_edge=-1e9, margin=MARGIN, tie_margin=TIE_MARGIN, s_err=zero,
            dist_err=zero, tie=keys)[2][0])

    assert bits(TIE_ALL) == 2
    assert bits(TIE_NORM2) == bits(TIE_MANH) == bits(TIE_NORM2 | TIE_MANH) == 0
    assert bits(TIE_NORM2 | TIE_EMD) == bits(TIE_DOT) == bits(TIE_SELFDOT) == 2
    assert bits(0) == 0
    stats[5, 1] += 1      # another squared distance
    assert bits(TIE_NORM2) == 2 and bits(TIE_MANH) == 0


@pytest.mark.parametrize("name,want", [
    ("bench10k_weights.txt", None), ("med2000_weights.txt", None),
    ("../../benchmark/configs/mc2-fast-id90-k7.weights.txt", TIE_NORM2)])
def test_tie_keys_are_the_first_combos_singles(fixtures_dir, name, want):
    """The keys of a model are those of its first combo's singles: the k = 7
    benchmark model's first combo is euclidean alone."""
    import os

    from meshclust2_tpu_torch.model.weights import load_weights as torch_weights
    from meshclust2_tpu_torch.model.classifier import CompiledModel as TorchModel

    model = TorchModel(torch_weights(os.path.join(fixtures_dir, name)).classifier)
    keys = tie_keys(model.singles, model.combos)
    assert keys and not keys & ~(TIE_ALL | TIE_NORM2 | TIE_MANH)
    if want is not None:
        assert keys == want
    assert tie_keys(model.singles, ()) == 0


def test_column_sum_of_positives():
    counts, rows, s, dist, stats, moments = window_case(3, 40, 32, np.uint16, 30)
    pos, colsum, info = port_absorb(counts, rows, s, dist, stats, moments, 0.0)
    assert 0 < info[1] < 30
    want = np.zeros(32, np.int64)
    for r in rows[s >= 0.0]:
        want += counts[r]
    np.testing.assert_array_equal(colsum, want)


def test_med2000_windows_agree_with_host_scorer(fixtures_dir):
    """Real windows (rows by length around a center, the accumulate scan's
    shape) scored by the port's epilogue: where no bit is set, the
    positives are the host's round(prob) > 0 and the best its first
    maximum of dist."""
    w = load_weights(os.path.join(fixtures_dir, "med2000_weights.txt"))
    _, ps = load_sorted_points([os.path.join(fixtures_dir, "med2000.fasta")],
                               [], w.k, w.datatype, False)
    model = CompiledModel(w.classifier)
    store = DeviceStore.from_pointset(ps, "cpu")
    params = model_to_torch(model, "cpu")
    edge = _pack_model(model).pos_edge
    margin, tie_margin = resolve_margins(None, None)
    host = HostScorer(ps, model)
    checked = 0
    for center in range(0, ps.n, 97):
        rows = np.arange(max(0, center - 300), min(ps.n, center + 300))
        a = torch.from_numpy(rows)
        b = torch.full_like(a, center)
        _, dec = pair_stats_decision(store, params, a, b)
        s, dist = dec[0], dec[2]
        stats = pair_stats_ref(store.counts, a, b)
        pos, colsum, info = window_absorb_ref(
            store.counts, a, s, dist, stats, store.mags, store.selfdot,
            store.lens, store.stddevs, pos_edge=edge, margin=margin,
            tie_margin=tie_margin, s_err=dec[3], dist_err=dec[4],
            tie=tie_keys(model.singles, model.combos))
        prob, hdist = host.score(rows, np.array([center]))
        if info[0] & 1 == 0:
            np.testing.assert_array_equal(pos.numpy(), c_round(prob) > 0)
            np.testing.assert_array_equal(
                colsum.numpy(), ps.counts[rows[pos.numpy()]].astype(np.int64).sum(0))
        if info[0] & 2 == 0:
            assert int(info[2]) == int(np.argmax(hdist))
        checked += info[0] == 0
    assert checked >= 15


@pytest.mark.parametrize("case", ["dtype", "rows_dtype", "s_dtype", "stats_shape",
                                  "moments_shape", "lengths", "contiguity",
                                  "err_shape", "err_dtype"])
def test_wrapper_rejects(case):
    counts = torch.zeros((4, 16), dtype=torch.uint8)
    rows = torch.zeros(3, dtype=torch.int64)
    s = torch.zeros(3, dtype=torch.float64)
    dist = torch.zeros(3, dtype=torch.float64)
    stats = torch.zeros((3, 3), dtype=torch.int64)
    moments = [torch.zeros(4, dtype=torch.float64) for _ in range(4)]
    s_err = torch.zeros(3, dtype=torch.float64)
    dist_err = torch.zeros(3, dtype=torch.float64)
    if case == "dtype":
        counts = counts.to(torch.int32)
    elif case == "rows_dtype":
        rows = rows.to(torch.int32)
    elif case == "s_dtype":
        s = s.to(torch.float32)
    elif case == "stats_shape":
        stats = stats[:, :2]
    elif case == "moments_shape":
        moments[2] = moments[2][:3]
    elif case == "lengths":
        dist = dist[:2]
    elif case == "contiguity":
        rows = torch.zeros(6, dtype=torch.int64)[::2]
    elif case == "err_shape":
        dist_err = dist_err[:2]
    elif case == "err_dtype":
        s_err = s_err.to(torch.float32)
    with pytest.raises((TypeError, ValueError)):
        window_absorb_ref(counts, rows, s, dist, stats, *moments, pos_edge=0.0,
                          margin=MARGIN, tie_margin=TIE_MARGIN, s_err=s_err,
                          dist_err=dist_err, tie=TIE_ALL)


# -- the whole step ------------------------------------------------------------

STEP_KINDS = ["absorb", "min", "on_edge", "ulp_below", "tie", "near_tie",
              "stage2", "full"]
EDGE = 0.25


def step_case(seed, dtype, d, kind, n=120, device="cpu"):
    """A store of n rows, a pool of n flat positions (order a permutation,
    or with repeats for stage2), earlier clusters, an open cluster of mcnt
    members with its column sums, and a window of alive candidates with
    their statistics against the center, s and dist shaped by `kind`."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, np.iinfo(dtype).max + 1, (n, d)).astype(dtype)
    c64 = counts.astype(np.int64)
    order = rng.permutation(n).astype(np.int64)
    cid, stepc = 3, n + 7
    flat = rng.permutation(n)
    mcnt = int(rng.integers(1, 12))
    done = 0 if kind == "full" else int(rng.integers(5, 30))
    mem, old, free = flat[:mcnt], flat[mcnt:mcnt + done], flat[mcnt + done:]
    alive = np.zeros(n, bool)
    alive[free] = True
    assign = np.full(n, -1, np.int64)
    astep = np.zeros(n, np.int64)
    assign[old] = rng.integers(0, cid, len(old))
    astep[old] = rng.integers(0, 50, len(old))
    assign[mem] = cid
    astep[mem] = np.arange(mcnt)
    members = rng.integers(0, n, n + 1).astype(np.int64)   # stale beyond mcnt
    members[:mcnt] = mem
    w = len(free) if kind == "full" else int(rng.integers(1, len(free) + 1))
    cand = np.sort(rng.choice(free, w, replace=False)).astype(np.int64)
    cur_d = np.array([mem[0]], np.int64)
    tie_margin = TIE_MARGIN
    s = rng.normal(EDGE, 2.0, w)
    s[np.abs(s - EDGE) < 1e-6] += 1e-3
    dist = rng.random(w)
    if kind == "min":
        s = -np.abs(s) - 1.0
    elif kind in ("absorb", "full", "stage2"):
        s = EDGE + 0.5 + np.abs(s)
        if kind == "absorb" and w > 2:
            s[::2] = EDGE - 0.5 - np.abs(s[::2])
    elif kind == "on_edge":
        s[w // 2] = EDGE
    elif kind == "ulp_below":
        s[w // 2] = np.nextafter(EDGE, -np.inf)
    if kind == "stage2":
        # every candidate a copy of one row at one dist: no window tie; a
        # tie margin that takes in every member makes the mean uncertain
        order[cand] = order[cand[0]]
        dist[:] = 0.5
        tie_margin = 1e9
    if kind in ("tie", "near_tie") and w > 1:
        top = int(np.argmax(dist))
        other = (top + 1) % w
        dist[other] = dist[top] if kind == "tie" else \
            dist[top] * (1 - 0.5 * TIE_MARGIN)
    msum = c64[order[mem]].sum(axis=0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    store = DeviceStore(
        counts=t(counts), mags=t(c64.sum(axis=1).astype(np.float64)),
        selfdot=t((c64 * c64).sum(axis=1).astype(np.float64)),
        lens=t(rng.integers(800, 1500, n).astype(np.float64)),
        stddevs=t(rng.random(n)), maxc=int(counts.max()))
    order_t, cand_t = t(order), t(cand)
    center = order_t[t(cur_d)].expand(w).contiguous()
    stats = pair_stats_ref(store.counts, order_t[cand_t], center)
    state = StepState(t(alive), t(assign), t(astep), t(members), t(msum))
    args = (store, order_t, cand_t, t(s), t(dist), stats, state, t(cur_d))
    # the fused kernel's bounds of a model without full-vector singles
    zero = torch.zeros(w, dtype=torch.float64, device=device)
    kw = dict(cid=cid, stepc=stepc, mcnt=mcnt, pos_edge=EDGE, margin=MARGIN,
              tie_margin=tie_margin, s_err=zero, dist_err=zero.clone(), tie=TIE_ALL)
    return args, kw


def clone_state(args):
    state = StepState(*(x.clone() for x in args[6]))
    return args[:6] + (state,) + args[7:], state


def earlier_step(store, order, cand, s, dist, stats, state, cur_d, *, cid, stepc,
                 mcnt, pos_edge, margin, tie_margin, s_err, dist_err, tie):
    """The accumulator's scan tail before the step kernel, transcribed: the
    decisions, the gated torch updates, the one-segment closest-to-mean,
    and the min case's gated seed.  Returns ((bits, npos, unc), next
    center)."""
    counts = store.counts
    n, n_cand = len(order), len(cand)
    alive, assign, astep, members, msum = state
    pos, colsum, info = window_absorb_ref(
        counts, order[cand], s, dist, stats, store.mags, store.selfdot,
        store.lens, store.stddevs, pos_edge=pos_edge, margin=margin,
        tie_margin=tie_margin, s_err=s_err, dist_err=dist_err, tie=tie)
    bits, npos, best = info[0:1], info[1:2], info[2:3]
    ok = bits == 0
    absorb = ok & (npos > 0)
    is_min = ok & (npos == 0)
    pa = pos & absorb
    alive[cand] = ~pa
    assign[cand] = torch.where(pa, cid, -1)
    astep[cand] = torch.where(pa, stepc, 0)
    slot = torch.cumsum(pa, 0, dtype=torch.int64) + (mcnt - 1)
    members.scatter_(0, torch.where(pa, slot, n), cand)
    new_sum = msum + colsum
    size = mcnt + n_cand
    count = npos + mcnt
    first, unc = closest_mean_ref(
        counts, store.mags, order[members[:size]], None,
        torch.arange(size) < count, 1, maxc=store.maxc,
        tie_margin=tie_margin, col_sum=new_sum, count=count)
    seed = cand[best.clamp(max=n_cand - 1)]
    cur_next = torch.where(absorb & ~unc, members[first.clamp(max=n)],
                           torch.where(is_min, seed, cur_d))
    msum.copy_(torch.where(absorb, new_sum, msum))
    row = counts[order[seed]].to(torch.int64)[0]
    alive[seed] = alive[seed] & ~is_min
    assign[seed] = torch.where(is_min, cid + 1, assign[seed])
    astep[seed] = torch.where(is_min, stepc, astep[seed])
    members[:1] = torch.where(is_min, seed, members[:1])
    msum.copy_(torch.where(is_min, row, msum))
    return torch.cat([bits, npos, unc.to(torch.int64)]), cur_next


def check_kind(kind, trip, args, kw, state):
    bits, npos, unc, nxt = (int(x) for x in trip)
    cand, cur_d = args[2], int(args[7][0])
    n = len(args[1])
    if kind in ("absorb", "full"):
        assert bits == 0 and npos > 0
    elif kind == "min":
        assert bits == 0 and npos == 0 and nxt in cand.tolist()
        assert not state.alive[nxt] and state.members[0] == nxt
    elif kind in ("on_edge", "ulp_below"):
        assert bits & 1
    elif kind in ("tie", "near_tie"):
        assert bits & 2 or len(cand) == 1
    elif kind == "stage2":
        assert bits == 0 and npos == len(cand) and unc == 1 and nxt == cur_d
    if kind == "full":
        assert kw["mcnt"] + npos == n and not state.alive.any()
    if bits:
        assert nxt == cur_d and unc == 0


@pytest.mark.parametrize("kind", STEP_KINDS)
@pytest.mark.parametrize("d", [16, 256, 1024])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_plain_step_equals_earlier_sequence(dtype, d, kind):
    args, kw = step_case(d + STEP_KINDS.index(kind), dtype, d, kind)
    got_args, got_state = clone_state(args)
    trip = window_step(*got_args, **kw)
    assert trip.dtype == torch.int64 and trip.shape == (4,)
    want_args, want_state = clone_state(args)
    want_trip, cur_next = earlier_step(*want_args, **kw)
    absorb = want_trip[0] == 0 and want_trip[1] > 0
    # the loop reads the mean's uncertainty only after an absorb
    want = torch.cat([want_trip[:2], want_trip[2:] * absorb, cur_next])
    assert torch.equal(trip, want), (trip, want)
    for name, g, w in zip(StepState._fields, got_state, want_state):
        assert torch.equal(g, w), name
    check_kind(kind, trip, args, kw, got_state)


@pytest.mark.parametrize("case", ["alive_dtype", "assign_shape", "members_shape",
                                  "msum_shape", "cur_d_shape", "no_candidate",
                                  "too_many", "cand_dtype", "device"])
def test_step_wrapper_rejects(case):
    args, kw = step_case(5, np.uint8, 16, "absorb", n=20)
    store, order, cand, s, dist, stats, state, cur_d = args
    if case == "alive_dtype":
        state = state._replace(alive=state.alive.to(torch.uint8))
    elif case == "assign_shape":
        state = state._replace(assign=state.assign[:-1])
    elif case == "members_shape":
        state = state._replace(members=state.members[:-1])
    elif case == "msum_shape":
        state = state._replace(msum=state.msum[:8])
    elif case == "cur_d_shape":
        cur_d = torch.cat([cur_d, cur_d])
    elif case == "no_candidate":
        cand, s, dist, stats = cand[:0], s[:0], dist[:0], stats[:0]
    elif case == "too_many":
        kw["mcnt"] = len(order)
    elif case == "cand_dtype":
        cand = cand.to(torch.int32)
    elif case == "device":
        cur_d = cur_d.to("meta")
    with pytest.raises((TypeError, ValueError)):
        window_step(store, order, cand, s, dist, stats, state, cur_d, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STEP_KINDS)
@pytest.mark.parametrize("d", [16, 256, 1024, 4096])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_cuda_step_kernel_equals_plain(dtype, d, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    n = 3_000 if d <= 1024 else 600
    args, kw = step_case(d + STEP_KINDS.index(kind), dtype, d, kind, n=n,
                         device="cuda")
    got_args, got_state = clone_state(args)
    before = window_step.launches
    trip = window_step(*got_args, **kw).clone()
    torch.cuda.synchronize()
    assert window_step.launches == before + 1
    want_args, want_state = clone_state(args)
    want = window_step_ref(*want_args, **kw)
    assert torch.equal(trip, want), (trip, want)
    for name, g, w in zip(StepState._fields, got_state, want_state):
        if name == "members":   # slot n is the plain version's scatter sink
            g, w = g[:-1], w[:-1]
        assert torch.equal(g, w), name
    check_kind(kind, trip.cpu(), [a.cpu() if torch.is_tensor(a) else a
                                  for a in args], kw, got_state)
