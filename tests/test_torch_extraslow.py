"""--feat extraslow on the port: models over the blockwise singles cluster
through the port's three device paths, with --device cpu (the kernels'
plain versions), against the JAX package; a model with a single that has no
device implementation is clustered on the host scorer with one stderr line;
--feat extraslow training gives the JAX host training's weights.

- The JAX tests' blockwise model (tests/test_device_extraslow.py:
  _extraslow_model: intersection, hellinger, chi^2, kl_cond, mismatch) and
  a third one over canberra, kulczynski1, squared chord, harmonic mean,
  k_div and jaccard (every combo kind), fitted the same way over each
  fixture's pool, on small.fasta and med2000: the CLSTR byte for byte the
  JAX CLI's --device host run on the three paths, and under
  MC2_DD_MARGIN=3e-3; the default path's counters equal the JAX forced
  device session's on small.fasta.
- The blockwise model with spearman in place of mismatch (the JAX test's
  host-bound case; full-vector and plane singles together): rc 0, a
  session with the device scorer alone, stderr names spearman and the
  device scorer, the CLSTR the JAX host run's.
- --feat extraslow training at k = 2 (AFD, in the set, needs k = 2 in the
  JAX package too): weights byte for byte the JAX --device host training's.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu_torch import cli as torch_cli

from test_torch_slow_feats import (DEVICE_ENV, FIXTURES, FORCED_SESSION, PATHS,
                                   check_paths, counters, jax_run,
                                   jax_tests_module, model_weights, port_run)

torch.set_num_threads(2)


def third_model(ps, sim=0.9):
    """A classifier over the remaining blockwise singles, fitted as the JAX
    tests fit theirs (seed 0, 600 random pairs, template labels, least
    squares)."""
    from meshclust2_tpu.features import flags as F
    from meshclust2_tpu.features import host as H
    from meshclust2_tpu.model.weights import ModelBlock, PredictorModel

    singles = [F.FEAT_CANBERRA, F.FEAT_KULCZYNSKI1, F.FEAT_SQCHORD,
               F.FEAT_HARMONIC_MEAN, F.FEAT_K_DIV, F.FEAT_JACCARD]
    rng = np.random.default_rng(0)
    a_rows = rng.integers(0, ps.n, 600)
    b_rows = rng.integers(0, ps.n, 600)
    keep = a_rows != b_rows
    a_rows, b_rows = a_rows[keep], b_rows[keep]
    raw = H.compute_singles(singles, H.side_from_pointset(ps, a_rows),
                            H.side_from_pointset(ps, b_rows))
    mins, maxs = raw.min(axis=0), raw.max(axis=0)
    z = (raw - mins) / np.where(maxs > mins, maxs - mins, 1.0)
    is_sim = np.array([bool(F.FEAT_IS_SIM[s]) for s in singles])
    z = np.where(is_sim[None, :], z, 1.0 - z)
    lab_a = np.array([ps.headers[r].split("_")[0] for r in a_rows])
    lab_b = np.array([ps.headers[r].split("_")[0] for r in b_rows])
    y = np.where(lab_a == lab_b, 1.0, -1.0)
    # singles in flag order: canberra, kulczynski1 < squared chord, harmonic
    # mean < k_div, jaccard
    combos = [("xy", F.FEAT_CANBERRA),
              ("xy2", F.FEAT_KULCZYNSKI1 | F.FEAT_SQCHORD),
              ("x2y", F.FEAT_HARMONIC_MEAN | F.FEAT_K_DIV),
              ("x2y2", F.FEAT_JACCARD | F.FEAT_CANBERRA)]
    cols = [z[:, 0], z[:, 2] * z[:, 1] ** 2, z[:, 3] ** 2 * z[:, 4],
            (z[:, 0] * z[:, 5]) ** 2]
    X = np.column_stack([np.ones(len(y))] + cols)
    w, *_ = np.linalg.lstsq(X, y * 4.0, rcond=None)
    return PredictorModel(k=ps.k, mode=1, max_features=4, id_cutoff=sim,
                          datatype="uint8_t",
                          feature_set=int(np.bitwise_or.reduce(singles)),
                          classifier=ModelBlock(combos=combos, weights=w,
                                                singles=singles, mins=mins,
                                                maxs=maxs))


def spearman_model(ps):
    """The JAX test's host-bound case: the blockwise model with spearman
    in place of mismatch (the fused kernel's FULL and PLANE epilogue)."""
    from meshclust2_tpu.features import flags as F

    model = jax_tests_module("test_device_extraslow")._extraslow_model(ps)
    model.classifier.singles[-1] = F.FEAT_SPEARMAN
    model.classifier.combos[-1] = ("xy", F.FEAT_KL_COND | F.FEAT_SPEARMAN)
    return model


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    builders = {
        "blockwise": jax_tests_module("test_device_extraslow")._extraslow_model,
        "third": third_model,
    }
    return {(name, f): model_weights(tmp_path_factory, f, build)
            for name, build in builders.items()
            for f in ("small.fasta", "med2000.fasta")}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("fasta", ["small.fasta", "med2000.fasta"])
@pytest.mark.parametrize("model", ["blockwise", "third"])
def test_model_equals_jax_host(weights, tmp_path, monkeypatch, model, fasta,
                               path):
    res = check_paths(tmp_path, monkeypatch, fasta, weights[model, fasta], path)
    if res.accumulator is not None:
        assert res.accumulator.full and res.accumulator.total_steps > 0


@pytest.mark.parametrize("fasta", ["small.fasta", "med2000.fasta"])
@pytest.mark.parametrize("model", ["blockwise", "third"])
def test_model_forced_margin_equals_jax_host(weights, tmp_path, monkeypatch,
                                             model, fasta):
    check_paths(tmp_path, monkeypatch, fasta, weights[model, fasta], "default",
                margin="3e-3")


@pytest.mark.parametrize("model", ["blockwise", "third"])
def test_counters_equal_jax_forced_session(weights, tmp_path, monkeypatch,
                                           model):
    w = weights[model, "small.fasta"]
    want, forced_c = jax_run(tmp_path, monkeypatch, "small.fasta", w,
                             FORCED_SESSION)
    res, got = port_run(tmp_path, monkeypatch, "small.fasta", w)
    assert got == want
    assert counters(res.engine) == forced_c


def test_spearman_model_clusters_on_the_host_scorer(tmp_path, monkeypatch,
                                                    capsys):
    from meshclust2_tpu.cli import load_sorted_points
    from meshclust2_tpu.model.weights import save_weights

    _, ps = load_sorted_points([os.path.join(FIXTURES, "small.fasta")], [], 5,
                               "uint8_t", False, keep_seqs_train=False)
    w = str(tmp_path / "spear_weights.txt")
    save_weights(w, spearman_model(ps))
    want, _ = jax_run(tmp_path, monkeypatch, "small.fasta", w)
    capsys.readouterr()
    res, got = port_run(tmp_path, monkeypatch, "small.fasta", w)
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "no device implementation" in ln]
    assert len(lines) == 1 and "spearman" in lines[0], err
    assert "device scorer" in lines[0] and "host scorer" not in err
    assert res.accumulator is None and res.updater is None
    # the device scorer, its plane store holding spearman's planes
    assert type(res.scorer).__name__ == "TorchDeviceScorer"
    assert res.scorer.engine.planes.rank2 is not None
    assert res.scorer.scored_pairs > 0
    assert got == want


def test_feat_extraslow_training_equals_jax_host(tmp_path, monkeypatch, capsys):
    from meshclust2_tpu.cli import main as jax_main

    flags = ["--id", "0.9", "--kmer", "2", "--mut-type", "single", "--feat",
             "extraslow", "--sample", "200", "--num-templates", "50",
             os.path.join(FIXTURES, "small.fasta")]
    for k in DEVICE_ENV:
        monkeypatch.delenv(k, raising=False)
    port_w, jax_w = tmp_path / "port_w.txt", tmp_path / "jax_w.txt"
    res = torch_cli.run(["--device", "cpu", "--dump", str(port_w), *flags])
    assert res.rc == 0 and res.tables.tables == 0
    assert "training tables on the host" in capsys.readouterr().err
    assert jax_main(["--device", "host", "--dump", str(jax_w), *flags]) == 0
    assert port_w.read_bytes() == jax_w.read_bytes()
