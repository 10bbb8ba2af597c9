"""The port's float64 epilogue and TorchDeviceScorer against the JAX package.

- `derive_singles` + `decision_from_raw` in torch equal the JAX package's
  numpy versions to 1e-12: the formulas and their order are the same.
- `pair_stats_decision` (the fused kernel's plain sequence, what it runs on
  CPU tensors) equals the JAX Pallas kernel in interpret mode, the JAX
  `derive_singles` and the JAX CompiledModel's epilogue: the statistics
  exactly, s, prob and dist to 1e-12, for two fixture models and a
  synthetic one with every combo kind and every derivable single.
- TorchDeviceScorer rounds every decision as the JAX DeviceScorer and the
  float64 HostScorer do, and picks the same dist argmax, for the three
  fixture models.
- A near-tie inside one merge segment is re-checked (rule iii) and then
  resolves as HostScorer does.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu.cli import load_sorted_points
from meshclust2_tpu.cluster.engine import HostScorer
from meshclust2_tpu.model.classifier import CompiledModel
from meshclust2_tpu.model.weights import load_weights
from meshclust2_tpu.ops.device_features import DeviceScorer
from meshclust2_tpu.model.weights import ModelBlock as JaxModelBlock
from meshclust2_tpu.ops.pallas_stats import center_block_stats as jax_center_block_stats
from meshclust2_tpu.ops.pallas_stats import derive_singles as jax_derive_singles
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.model.classifier import CompiledModel as PortCompiledModel
from meshclust2_tpu_torch.model.weights import ModelBlock as PortModelBlock
from meshclust2_tpu_torch.model.weights import load_weights as port_load_weights
from meshclust2_tpu_torch.model.classifier import decision_from_raw, model_to_torch
from meshclust2_tpu_torch.ops.device_features import TorchDeviceScorer, recheck_mask
from meshclust2_tpu_torch.ops.pair_stats import (derive_singles, pair_stats,
                                                  pair_stats_decision)

torch.set_num_threads(2)

MODELS = ["small_ref_weights.txt", "med2000_weights.txt", "bench10k_weights.txt"]


@pytest.fixture(scope="module")
def med_ps(fixtures_dir):
    # all three fixture models are k = 5, uint8
    _, ps = load_sorted_points([os.path.join(fixtures_dir, "med2000.fasta")],
                               [], 5, "uint8_t", False)
    ps.seqs = None
    return ps


def compiled(fixtures_dir, name):
    w = load_weights(os.path.join(fixtures_dir, name))
    assert (w.k, w.datatype) == (5, "uint8_t")
    return CompiledModel(w.classifier)


def pair_sample(n, seed):
    rng = np.random.default_rng(seed)
    center_a = np.arange(300, 600)
    center_b = np.full(300, 450)
    return (np.concatenate([center_a, rng.integers(0, n, 300)]),
            np.concatenate([center_b, rng.integers(0, n, 300)]))


@pytest.mark.parametrize("name", MODELS)
def test_epilogue_matches_jax_numpy(fixtures_dir, med_ps, name):
    ps = med_ps
    model = compiled(fixtures_dir, name)
    a, b = pair_sample(ps.n, 1)
    stats = pair_stats(torch.from_numpy(ps.counts), torch.from_numpy(a),
                       torch.from_numpy(b))
    mags = ps.mags.astype(np.float64)
    selfd = np.einsum("ij,ij->i", ps.counts.astype(np.float64),
                      ps.counts.astype(np.float64))
    lens = ps.lengths.astype(np.float64)
    std = ps.stddevs
    want_raw = jax_derive_singles(
        stats.numpy(), mags[a], mags[b], selfd[a], selfd[b], std[a], std[b],
        lens[a], lens[b], ps.dim, list(model.singles))
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    got_raw = derive_singles(
        stats, t(mags[a]), t(mags[b]), t(selfd[a]), t(selfd[b]), t(std[a]),
        t(std[b]), t(lens[a]), t(lens[b]), ps.dim, model.singles)
    np.testing.assert_allclose(got_raw.numpy(), want_raw, rtol=1e-12, atol=1e-12)
    want = model.decision_from_raw(want_raw)
    got = decision_from_raw(model_to_torch(model, "cpu"), t(want_raw))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("form", ["center", "pair"])
@pytest.mark.parametrize("name", ["med2000_weights.txt", "bench10k_weights.txt",
                                  "synthetic"])
def test_fused_decision_matches_jax(fixtures_dir, med_ps, name, form):
    """The fused decision's plain sequence against the JAX chain: the
    Pallas kernel (interpret mode; its center form, per center in the pair
    form), the JAX derive_singles, the JAX CompiledModel epilogue."""
    # imported here, not at the top: the card's machine may hold another
    # top-level `tests` package, and its cuda-marked run collects this file
    from tests.test_torch_pair_stats import ALL_SINGLES, synthetic_block

    ps = med_ps
    a, b = pair_sample(ps.n, 3)
    a, b = (a[:300], b[:1]) if form == "center" else (a[300:], b[300:])
    bb = np.broadcast_to(b, a.shape)
    stats = np.zeros((len(a), 3), np.int64)
    for c in np.unique(bb):
        sel = np.nonzero(bb == c)[0]
        stats[sel] = jax_center_block_stats(ps.counts[a[sel]], ps.counts[c],
                                            tile_b=8, interpret=True)
    mags = ps.mags.astype(np.float64)
    selfd = np.einsum("ij,ij->i", ps.counts.astype(np.float64),
                      ps.counts.astype(np.float64))
    lens = ps.lengths.astype(np.float64)
    std = ps.stddevs

    def jax_raw(singles):
        return jax_derive_singles(stats, mags[a], mags[bb], selfd[a], selfd[bb],
                                  std[a], std[bb], lens[a], lens[bb], ps.dim,
                                  list(singles))

    if name == "synthetic":
        raw_all = jax_raw(ALL_SINGLES)
        jax_model = CompiledModel(synthetic_block(JaxModelBlock, raw_all, 11))
        port_model = PortCompiledModel(synthetic_block(PortModelBlock, raw_all, 11))
    else:
        jax_model = compiled(fixtures_dir, name)
        port_model = PortCompiledModel(port_load_weights(
            os.path.join(fixtures_dir, name)).classifier)
    want = jax_model.decision_from_raw(jax_raw(jax_model.singles))
    store = DeviceStore.from_pointset(ps, "cpu")
    got_stats, dec = pair_stats_decision(store, model_to_torch(port_model, "cpu"),
                                         torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got_stats.numpy(), stats)
    for g, w in zip(dec, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_scorer_decisions_match_jax_and_host(fixtures_dir, med_ps, name):
    ps = med_ps
    model = compiled(fixtures_dir, name)
    port = TorchDeviceScorer(ps, model, "cpu")
    # the port's engine keys its device loop on the session, not the scorer
    assert not hasattr(port, "prefers_device_loop")
    assert type(port).__name__ != "DeviceScorer"
    jax_scorer = DeviceScorer(ps, model)
    host = HostScorer(ps, model)
    a, b = pair_sample(ps.n, 2)
    # the center form (one window against one center) and the pair form
    for sl in (slice(0, 300), slice(300, 600)):
        got_p, got_d = port.score(a[sl], b[sl])
        for p, d in (jax_scorer.score(a[sl], b[sl]), host.score(a[sl], b[sl])):
            np.testing.assert_array_equal(np.floor(got_p + 0.5), np.floor(p + 0.5))
            assert int(np.argmax(got_d)) == int(np.argmax(d))
    # a length-1 side broadcasts
    p1, d1 = port.score(a[:300], np.array([450]))
    np.testing.assert_array_equal(p1, port.score(a[:300], b[:300])[0])
    assert port.scored_pairs == 1200 and port.rechecked_pairs > 0


def test_recheck_rules():
    prob = np.array([0.1, 0.49995, 0.9, 0.2, 0.3, 1.2])
    dist = np.array([0.5, 0.1, 0.9, 0.3, 0.3 + 1e-12, 0.6])
    #             none  (i)  (ii)  (iii) (iii)  none
    zero = np.zeros(len(prob))
    np.testing.assert_array_equal(
        recheck_mask(prob, dist, zero, zero), [False, True, True, True, True, False])


def test_merge_segment_near_tie_resolves_as_host(fixtures_dir, med_ps):
    """Rows 10 and 60 are the same sequence, so against any center their
    host dists tie exactly and the merge pass's later-candidate-wins rule
    (cluster/engine.py:888-890) picks row 60.  A device rounding error that
    lifts row 10 by 1e-12 would pick row 10; rule (iii) re-checks both."""
    ps = med_ps.subset(np.r_[np.arange(60), 10])
    model = compiled(fixtures_dir, "med2000_weights.txt")
    host = HostScorer(ps, model)
    for center in range(60):
        cand = np.array([i for i in range(60) if i not in (10, center)])
        p, d = host.score(cand, np.array([center]))
        p_tie, d_tie = host.score(np.array([10, 60]), np.array([center]))
        top = int(np.argmax(d))
        scale = max(abs(d[top]), 1.0)
        if (d_tie[0] == d_tie[1]
                and d[top] - d_tie[0] > 1e-3 * scale
                and (np.abs(p_tie - np.floor(p_tie) - 0.5) > 1e-2).all()):
            break
    else:
        pytest.fail("no center separates the tied pair from the call's max")
    rows = np.array([cand[top], 10, 60])

    class Perturbed(TorchDeviceScorer):
        def _device_decision(self, a, b):
            prob, dist, s_err, dist_err = super()._device_decision(a, b)
            dist[1] += 1e-12 * max(abs(dist[1]), 1.0)
            return prob, dist, s_err, dist_err

    scorer = Perturbed(ps, model, "cpu")
    prob, dist = scorer.score(rows, np.array([center]))
    assert scorer.rechecked_pairs == 3          # the max (ii), the tie (iii)
    hp, hd = host.score(rows, np.array([center]))
    np.testing.assert_array_equal(dist, hd)
    np.testing.assert_array_equal(prob, hp)
    seg = dist[1:]                               # one center's merge segment
    assert len(seg) - 1 - int(np.argmax(seg[::-1])) == 1    # row 60 wins
