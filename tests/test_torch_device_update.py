"""TorchDeviceUpdater against the JAX DeviceUpdater on med2000 update inputs.

The inputs are the engine's own: MeanShiftEngine builds the first update
iteration's (cen_rows, b_rows, seg) and the merge pass's (cen_rows, jj, seg)
from the accumulate phase's clusters (cluster/engine.py:706-733, 849-866)
and hands them to a recording updater.  On them:
- `keep` is equal wherever neither side is uncertain, and the port's
  uncertain pairs lie within the margin of the host's float64 GLM sum;
- `first` is equal wherever neither side marks the center uncertain;
- `any_m` and `best` are equal wherever neither side marks the center
  ambiguous or holds an uncertain pair of it, among centers with a
  candidate.
A constructed merge segment with two candidates of different inputs and
equal dists is flagged ambiguous and resolves as HostScorer does.
"""
import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meshclust2_tpu.cli import load_sorted_points
from meshclust2_tpu.cluster.bvec import BVec
from meshclust2_tpu.cluster.device_update import DeviceUpdater
from meshclust2_tpu.cluster.engine import Cluster, HostScorer, MeanShiftEngine
from meshclust2_tpu.features import host as H
from meshclust2_tpu.model.classifier import CompiledModel
from meshclust2_tpu.model.weights import load_weights
from meshclust2_tpu.native import NativeScorer
from meshclust2_tpu_torch.cluster import device_update as port_update
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.cluster.device_update import TorchDeviceUpdater

torch.set_num_threads(2)

DELTA = 5


class Recorder:
    """An updater that records the engine's arguments and answers with the
    wrapped updater's results."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = {}
        self.rechecked_pairs = 0

    def filter_closest(self, *args):
        self.calls["filter"] = args
        return self.inner.filter_closest(*args)

    def merge_segmented(self, *args):
        self.calls["merge"] = args
        return self.inner.merge_segmented(*args)


@pytest.fixture(scope="module")
def med(fixtures_dir):
    w = load_weights(os.path.join(fixtures_dir, "med2000_weights.txt"))
    _, ps = load_sorted_points([os.path.join(fixtures_dir, "med2000.fasta")],
                               [], w.k, w.datatype, False)
    ps.seqs = None
    model = CompiledModel(w.classifier)
    engine = MeanShiftEngine(ps, model, w.id_cutoff,
                             scorer=NativeScorer.create(ps, model))
    bv = BVec(ps.lengths, engine.bin_size)
    bv.insert_all(ps.lengths)
    bv.insert_finalize(ps.lengths)
    clusters = engine.accumulate_all(bv)
    port = TorchDeviceUpdater(model, DeviceStore.from_pointset(ps, "cpu"))
    rec = Recorder(port)
    engine.device_session = SimpleNamespace(updater=rec, phase=None)
    engine._batched_mean_shift_update(copy.deepcopy(clusters), DELTA)
    engine._merge_pass(copy.deepcopy(clusters), DELTA)
    return SimpleNamespace(ps=ps, model=model, sim=w.id_cutoff, port=port,
                           jax=DeviceUpdater(ps, model, w.id_cutoff),
                           calls=rec.calls, clusters=clusters)


def host_sum(ps, model, a, b):
    raw = model.raw_singles(H.side_from_pointset(ps, a), H.side_from_pointset(ps, b))
    return model.decision_from_raw(raw)[0]


def test_filter_closest_equals_jax(med):
    cen_rows, b_rows, seg, C = med.calls["filter"]
    assert C == 305 and len(b_rows) > 10_000
    keep, kunc, first, cunc = med.port.filter_closest(cen_rows, b_rows, seg, C)
    jkeep, jkunc, jfirst, jcunc = med.jax.filter_closest(cen_rows, b_rows, seg, C)
    for got, want in ((keep, jkeep), (kunc, jkunc), (first, jfirst), (cunc, jcunc)):
        assert got.dtype == want.dtype and got.shape == want.shape
    sure = ~kunc & ~jkunc
    np.testing.assert_array_equal(keep[sure], jkeep[sure])
    assert 0 < keep.sum() < len(keep)
    ok = ~cunc & ~jcunc
    np.testing.assert_array_equal(first[ok], jfirst[ok])
    assert ok.sum() > C // 2
    # uncertain pairs lie within the margin of the host's float64 sum
    idx = np.nonzero(kunc)[0]
    if len(idx):
        s = host_sum(med.ps, med.model, cen_rows[seg[idx]], b_rows[idx])
        lo, hi = med.port.band0
        dist = np.minimum(np.abs(s - lo), np.abs(s - hi))
        thr = med.port.margin * max(abs(lo), abs(hi), 1.0)
        assert (dist <= thr * (1 + 1e-6)).all()


def test_filter_closest_records_the_largest_segment(med, monkeypatch):
    """The profile line's segment shape under MC2_DEVICE_PROF: the most
    positions and the most kept rows of one segment over the calls since
    the last reset."""
    cen_rows, b_rows, seg, C = med.calls["filter"]
    monkeypatch.setenv("MC2_DEVICE_PROF", "1")
    med.port._reset_counters()
    keep = med.port.filter_closest(cen_rows, b_rows, seg, C)[0]
    sizes = np.bincount(seg, minlength=C)
    kept = np.bincount(seg, weights=keep, minlength=C)
    assert med.port.max_segment == sizes.max() > 1
    assert med.port.max_kept == kept.max() >= 1
    assert (f"largest segment {sizes.max()} positions, {int(kept.max())} kept"
            in med.port.prof_line())


def test_merge_segmented_equals_jax(med):
    cen_rows, jj, seg, C = med.calls["merge"]
    assert C == 305 and len(jj) > 0
    unc, any_m, best, amb = med.port.merge_segmented(cen_rows, jj, seg, C)
    junc, jany, jbest, jamb = med.jax.merge_segmented(cen_rows, jj, seg, C)
    for got, want in ((unc, junc), (any_m, jany), (best, jbest), (amb, jamb)):
        assert got.dtype == want.dtype and got.shape == want.shape
    touched = np.zeros(C, bool)
    touched[seg[unc | junc]] = True
    # the engine skips centers without candidates, where the JAX program's
    # best is the int32 identity of an empty segment_max
    has = np.bincount(seg, minlength=C) > 0
    ok = has & ~amb & ~jamb & ~touched
    np.testing.assert_array_equal(any_m[ok], jany[ok])
    np.testing.assert_array_equal(best[ok], jbest[ok])
    assert ok.sum() > C // 2


def test_score_sum_dist_is_float64_with_zero_error(med):
    """score_sums, which took score_sum_dist's place: float64 GLM sums equal
    to the host's within float64 rounding, the same in any slicing."""
    cen_rows, b_rows, seg, _ = med.calls["filter"]
    a, b = cen_rows[seg[:500]], b_rows[:500]
    s = med.port.score_sums(a, b)
    assert s.dtype == np.float64 and s.shape == (500,)
    np.testing.assert_allclose(s, host_sum(med.ps, med.model, a, b),
                               rtol=1e-9, atol=1e-9)
    assert np.array_equal(med.port.score_sums(a, b, slice_pairs=77), s)
    assert len(med.port.score_sums(a[:0], b[:0])) == 0


def test_merge_tie_with_different_inputs_is_ambiguous(med, monkeypatch):
    """Center i0 with two merge-positive candidates whose host dists differ:
    a device error that made the later one equal to the earlier one would
    pick the later (ties go to the later candidate).  Their inputs differ,
    so the segment is ambiguous and the engine re-scores it on the host."""
    ps, model = med.ps, med.model
    host = HostScorer(ps, model)
    members = max(med.clusters, key=lambda c: len(c.members)).members
    found = None
    for i0 in members:
        for j1 in members:
            for j2 in members:
                if len({i0, j1, j2}) < 3 or ps.lengths[j1] == ps.lengths[j2]:
                    continue
                prob, dist = host.score(np.array([j1, j2]), np.array([i0]))
                if (np.floor(prob + 0.5) == 1).all() and dist[0] > dist[1]:
                    found = i0, j1, j2
                    break
            if found:
                break
        if found:
            break
    assert found, "no merge-positive candidate pair in the largest cluster"
    i0, j1, j2 = found
    clusters = [Cluster(center_row=r, members=[r]) for r in (i0, j1, j2)]
    real = port_update.pair_stats_decision
    applied = []

    def tied(store, params, a_idx, b_idx):
        # give (j2, i0) the device dist of (j1, i0)
        stats, dec = real(store, params, a_idx, b_idx)
        p1 = torch.nonzero((a_idx == j1) & (b_idx == i0)).flatten()
        p2 = torch.nonzero((a_idx == j2) & (b_idx == i0)).flatten()
        if len(p1) and len(p2):
            dec = dec.clone()
            dec[2, p2] = dec[2, p1]
            applied.append(True)
        return stats, dec

    monkeypatch.setattr(port_update, "pair_stats_decision", tied)
    cen_rows = np.array([i0, j1, j2], np.int64)
    jj, seg = np.array([1, 2, 2], np.int64), np.array([0, 0, 1], np.int64)
    unc, any_m, best, amb = med.port.merge_segmented(cen_rows, jj, seg, 3)
    assert not unc[:2].any() and any_m[0] and best[0] == 1 and amb[0]

    engine = MeanShiftEngine(ps, model, med.sim)
    engine.device_session = SimpleNamespace(updater=med.port, phase=None)
    on_device = copy.deepcopy(clusters)
    engine._merge_pass(on_device, DELTA)
    assert len(applied) == 2
    on_host = copy.deepcopy(clusters)
    MeanShiftEngine(ps, model, med.sim)._merge_pass(on_host, DELTA)
    assert [(c.center_row, c.members) for c in on_device] == \
        [(c.center_row, c.members) for c in on_host]
    assert any(c.center_row == j1 and i0 in c.members for c in on_host)
