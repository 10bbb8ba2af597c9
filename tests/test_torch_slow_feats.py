"""--feat slow on the port: a model over the log divergences (jefferey,
jensen-shannon) clusters through the port's three device paths, trains and
searches, with --device cpu (the kernels' plain versions), against the JAX
package.

- The JAX tests' slow model (tests/test_device_slow_feats.py:_slow_model,
  fitted over each fixture's pool) on small.fasta and med2000: the CLSTR
  byte for byte the JAX CLI's --device host run of the same weights on the
  default path, MC2_NO_DEVICE_LOOP=1 and MC2_NO_DEVICE_LOOP=1
  MC2_NO_DEVICE_UPDATE_BATCH=1, and again under MC2_DD_MARGIN=3e-3, which
  sends pairs and windows to the host re-checks;
- the default path's engine counters (windows, pairs, clusters before
  update, update iterations) equal the JAX package's forced device session
  (MC2_FORCE_DEVICE_SESSION=1 MC2_DEVICE_LOOP=1) on small.fasta;
- `--feat slow` training: its tables from the host oracle, the weights
  byte for byte the JAX --device host training's;
- fastcar `--feat slow` on the small split (tests/test_torch_fastcar.py):
  weights and output byte for byte the JAX fastcar's host route.

The helpers serve tests/test_torch_extraslow.py too.
"""
import os
import sys

import pytest
import torch

from meshclust2_tpu_torch import cli as torch_cli

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PATHS = {
    "default": {},
    "no_device_loop": {"MC2_NO_DEVICE_LOOP": "1"},
    "no_device_loop_no_update_batch": {"MC2_NO_DEVICE_LOOP": "1",
                                       "MC2_NO_DEVICE_UPDATE_BATCH": "1"},
}
# the environment the JAX package reads for its device configurations,
# cleared for its --device host runs
DEVICE_ENV = ("MC2_NO_DEVICE_SESSION", "MC2_NO_DEVICE_LOOP",
              "MC2_NO_DEVICE_UPDATE_BATCH", "MC2_DEVICE_THRESHOLD",
              "MC2_DEVICE_PROBE_TIMEOUT", "MC2_DEVICE_TRAIN", "MC2_DD_MARGIN",
              "MC2_FORCE_DEVICE_SESSION", "MC2_DEVICE_LOOP")


def jax_tests_module(name: str):
    """A JAX test module of this directory (its model builders)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    return __import__(name)


def model_weights(tmp_path_factory, fasta: str, build) -> str:
    """weights.txt of build(ps) over the fixture's pool (k = 5, uint8), as
    the JAX tests fit theirs."""
    from meshclust2_tpu.cli import load_sorted_points
    from meshclust2_tpu.model.weights import save_weights

    _, ps = load_sorted_points([os.path.join(FIXTURES, fasta)], [], 5,
                               "uint8_t", False, keep_seqs_train=False)
    path = str(tmp_path_factory.mktemp("w") / f"{fasta}_weights.txt")
    save_weights(path, build(ps))
    return path


def counters(engine):
    """(windows scored, pairs scored, clusters before update, update
    iterations) of an engine."""
    s = engine.stats
    return (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations)


def port_run(tmp_path, monkeypatch, fasta, weights, path="default", env=None):
    """The port's CLI, --device cpu, on one of PATHS: (ClusterRun, CLSTR
    bytes)."""
    for k in DEVICE_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in {**PATHS[path], **(env or {})}.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / f"port_{path}.clstr"
    res = torch_cli.run(["--device", "cpu", "--recover", weights, "--output",
                         str(out), os.path.join(FIXTURES, fasta)])
    assert res.rc == 0
    return res, out.read_bytes()


def jax_run(tmp_path, monkeypatch, fasta, weights, env=None):
    """The JAX CLI on the same weights: --device host, or with env (its
    forced device session).  Returns (CLSTR bytes, its engine counters)."""
    from meshclust2_tpu.cli import main as jax_main
    from meshclust2_tpu.cluster import engine as jax_engine

    got = {}
    real = jax_engine.MeanShiftEngine.run

    def run(self, *args, **kw):
        out = real(self, *args, **kw)
        got["res"] = self
        return out

    with monkeypatch.context() as m:
        for k in DEVICE_ENV:
            m.delenv(k, raising=False)
        for k, v in (env or {}).items():
            m.setenv(k, v)
        m.setattr(jax_engine.MeanShiftEngine, "run", run)
        out = tmp_path / "jax.clstr"
        assert jax_main(["--device", "host", "--recover", weights, "--output",
                         str(out), os.path.join(FIXTURES, fasta)]) == 0
    return out.read_bytes(), counters(got["res"])


# the JAX package's forced device session: its session and whole-phase
# program on its CPU backend
FORCED_SESSION = {"MC2_FORCE_DEVICE_SESSION": "1", "MC2_DEVICE_LOOP": "1"}


def check_paths(tmp_path, monkeypatch, fasta, weights, path, margin=None):
    """The port's run on `path` == the JAX --device host run, byte for
    byte; the host scorer's counters on the scorer-only path; with a
    forced margin, the re-checks it causes on med2000."""
    want, host_c = jax_run(tmp_path, monkeypatch, fasta, weights)
    env = {} if margin is None else {"MC2_DD_MARGIN": margin}
    res, got = port_run(tmp_path, monkeypatch, fasta, weights, path, env)
    assert got == want
    c = counters(res.engine)
    assert (c[2], c[3]) == (host_c[2], host_c[3])
    if margin is None:
        # an aborted window is counted again when the host redoes it
        assert c[0] == host_c[0]
    if path == "no_device_loop_no_update_batch":
        assert c == host_c
    if margin is not None:
        acc, upd = res.accumulator, res.updater
        assert acc.margin == upd.margin == float(margin)
        if fasta == "med2000.fasta":   # small.fasta's sums lie far from the edges
            assert acc.aborts + upd.rechecked_pairs > 0
    return res


@pytest.fixture(scope="module")
def slow_weights(tmp_path_factory):
    build = jax_tests_module("test_device_slow_feats")._slow_model
    return {f: model_weights(tmp_path_factory, f, build)
            for f in ("small.fasta", "med2000.fasta")}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("fasta", ["small.fasta", "med2000.fasta"])
def test_slow_model_equals_jax_host(slow_weights, tmp_path, monkeypatch, fasta,
                                    path):
    res = check_paths(tmp_path, monkeypatch, fasta, slow_weights[fasta], path)
    assert (res.accumulator is not None) == (path == "default")
    if res.accumulator is not None:
        assert res.accumulator.full and res.accumulator.total_steps > 0


@pytest.mark.parametrize("fasta", ["small.fasta", "med2000.fasta"])
def test_slow_model_forced_margin_equals_jax_host(slow_weights, tmp_path,
                                                  monkeypatch, fasta):
    check_paths(tmp_path, monkeypatch, fasta, slow_weights[fasta], "default",
                margin="3e-3")


def test_slow_model_counters_equal_jax_forced_session(slow_weights, tmp_path,
                                                      monkeypatch):
    w = slow_weights["small.fasta"]
    want, forced_c = jax_run(tmp_path, monkeypatch, "small.fasta", w,
                             FORCED_SESSION)
    res, got = port_run(tmp_path, monkeypatch, "small.fasta", w)
    assert got == want
    assert counters(res.engine) == forced_c


def test_feat_slow_training_equals_jax_host(tmp_path, monkeypatch, capsys):
    """--feat slow: the tables of the log divergences come from the host
    oracle, with one stderr line, and the weights equal the JAX CLI's
    --device host training byte for byte."""
    from meshclust2_tpu.cli import main as jax_main

    flags = ["--id", "0.9", "--kmer", "5", "--mut-type", "single", "--feat",
             "slow", "--sample", "200", "--num-templates", "50",
             os.path.join(FIXTURES, "small.fasta")]
    for k in DEVICE_ENV:
        monkeypatch.delenv(k, raising=False)
    port_w, jax_w = tmp_path / "port_w.txt", tmp_path / "jax_w.txt"
    res = torch_cli.run(["--device", "cpu", "--dump", str(port_w), *flags])
    assert res.rc == 0 and res.tables.tables == 0
    err = capsys.readouterr().err
    assert "not derivable from the pair statistics" in err
    assert "training tables on the host" in err
    assert jax_main(["--device", "host", "--dump", str(jax_w), *flags]) == 0
    assert port_w.read_bytes() == jax_w.read_bytes()


def test_fastcar_feat_slow_equals_jax_host_route(tmp_path, monkeypatch,
                                                 capsys):
    """fastcar --feat slow on the small split: training with host tables,
    then the search with that model through the device route: weights and
    output equal the JAX fastcar's host route."""
    helpers = jax_tests_module("test_torch_fastcar")
    db, q = helpers.split(tmp_path, "small.fasta", 150, 10)
    res, port_dir, jax_dir = helpers.both(
        tmp_path, monkeypatch, capsys,
        [db, "-q", q, "--id", "0.9", "-m", "rc", "--mut-type", "single",
         "--feat", "slow"])
    helpers.assert_same_output(port_dir, jax_dir)
    assert (port_dir / "weights.txt").read_bytes() == \
        (jax_dir / "weights.txt").read_bytes()
    assert res.stats.device_blocks == 1
    assert "training tables on the host" in (port_dir / "stderr.txt").read_text()
