"""The window-absorb step against a numpy reference and the host scorer.

`window_absorb_ref` (what `window_absorb` runs on CPU tensors) must equal a
numpy transcription of the step exactly (positives, column sums, bits,
count, best); on constructed windows its gate and tie bits must fire where
a decision sits on its edge or two candidates with different inputs tie,
and not where exact copies tie; on med2000 windows scored by the port's
epilogue, wherever it sets no bit, the positives and the best must be the
host scorer's (round(prob) > 0, first maximum of dist).  Tolerance: exact
throughout.  The CUDA kernel is held against the plain version only on a
card.
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
from meshclust2_tpu_torch.ops.device_features import pair_decision
from meshclust2_tpu_torch.ops.pair_stats import pair_stats_ref
from meshclust2_tpu_torch.ops.window_absorb import window_absorb, window_absorb_ref

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
    pos, colsum, info = window_absorb(
        t(counts), t(rows), t(s), t(dist), t(stats), *(t(m) for m in moments),
        pos_edge=edge, margin=margin, tie_margin=tie_margin)
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
        s, _, dist = pair_decision(store, params, model.singles, a, b)
        stats = pair_stats_ref(store.counts, a, b)
        pos, colsum, info = window_absorb_ref(
            store.counts, a, s, dist, stats, store.mags, store.selfdot,
            store.lens, store.stddevs, pos_edge=edge, margin=margin,
            tie_margin=tie_margin)
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
                                  "moments_shape", "lengths", "contiguity"])
def test_wrapper_rejects(case):
    counts = torch.zeros((4, 16), dtype=torch.uint8)
    rows = torch.zeros(3, dtype=torch.int64)
    s = torch.zeros(3, dtype=torch.float64)
    dist = torch.zeros(3, dtype=torch.float64)
    stats = torch.zeros((3, 3), dtype=torch.int64)
    moments = [torch.zeros(4, dtype=torch.float64) for _ in range(4)]
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
    with pytest.raises((TypeError, ValueError)):
        window_absorb(counts, rows, s, dist, stats, *moments, pos_edge=0.0,
                      margin=MARGIN, tie_margin=TIE_MARGIN)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("d,n_cand", [(16, 1), (256, 97), (1024, 2048), (4096, 300)])
def test_cuda_kernel_equals_plain(dtype, d, n_cand):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    counts, rows, s, dist, stats, moments = window_case(d, 300, d, dtype, n_cand)
    dist[n_cand // 2:] = dist[0]   # ties
    s[::7] = 0.25                  # on the edge
    args = [torch.from_numpy(a).cuda()
            for a in (counts, rows, s, dist, stats, *moments)]
    kw = dict(pos_edge=0.25, margin=MARGIN, tie_margin=TIE_MARGIN)
    before = window_absorb.launches
    got = window_absorb(*args, **kw)
    torch.cuda.synchronize()
    assert window_absorb.launches == before + 1
    want = window_absorb_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
