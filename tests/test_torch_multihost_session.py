"""`--multihost` on its default route, the device session over the
row-sharded store (parallel/multihost_session.py), as real gloo process
groups (one OS process a rank, spawned once for this file, every join
bounded), and the port's `graft_entry` (Part D):

- 1, 2 and 4 ranks on small.fasta and 2 ranks on med2000: the CLSTR byte
  for byte the JAX `--device host` run's; every rank's engine counters,
  accumulator counters (steps, windows, pairs, guarded aborts) and phase
  counters (iterations, pairs, abort) equal to the port's single-device
  default path on the same file, and every rank's clustering digest equal;
- the block modes' collectives (the counters on `Collectives`): at 2 and 4
  ranks every scan step through the block mode makes 2 (the exchange's
  all-reduce, the partials' all-gather) and every pass of the phase 3 (the
  exchange, the partials, the new centers' rows); one rank runs no
  block-mode phase and no collective;
- 2 ranks on small.fasta with every decision uncertain (MC2_DD_MARGIN=1e9):
  the accumulate loop and the phase abort, the host resolves them through
  MultihostScorer and fetched rows, and the CLSTR is still the JAX host
  run's; the session's counters equal the single-device run's under the
  same margin;
- a rank killed once its session is built: its peer exits non-zero in
  bounded time and no CLSTR is written;
- dryrun_multichip(2) on the CPU (its seven sections), and entry()'s
  forward on the CPU against the plain fused decisions.
"""
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_multihost import FIX, ROOT, SETS, jax_host, launch_with, prof

# the line every rank prints on stderr once its session is built
SESSION = "--multihost runs the device session over the row-sharded store"
JOIN_S = 240
DEAD_PEER_S = 90
# (set, ranks, extra environment)
JOBS = {"small1": ("small", 1, {}), "small2": ("small", 2, {}),
        "small4": ("small", 4, {}), "med2": ("med2000", 2, {}),
        "abort2": ("small", 2, {"MC2_DD_MARGIN": "1e9"}), "dead": ("med2000", 2, {})}


def kill_when_built(proc, deadline: float):
    """Read proc's stderr until its SESSION line, then SIGKILL it."""
    def watch():
        for line in proc.stderr:
            if SESSION in line:
                break
        proc.send_signal(signal.SIGKILL)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    t.join(max(0.0, deadline - time.monotonic()))
    proc.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("session")
    jobs = {}
    for key, (name, nprocs, env) in JOBS.items():
        d = tmp / key
        d.mkdir()
        weights, fasta = SETS[name]
        out = str(d / "out.clstr")
        jobs[key] = (out, launch_with(os.path.join(FIX, weights), fasta, nprocs, out, env))
    dry = subprocess.Popen([sys.executable, "-m", "meshclust2_tpu_torch.graft_entry", "2",
                            "--cpu"], cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True,
                           env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT))
    t0 = time.monotonic()
    kill_when_built(jobs["dead"][1][1], t0 + JOIN_S)
    res = {}
    try:
        for key, (out, procs) in jobs.items():
            got = []
            for p in procs:
                so, se = p.communicate(timeout=max(1.0, t0 + JOIN_S - time.monotonic()))
                got.append((p.returncode, so, se, time.monotonic() - t0))
            res[key] = (out, got)
        so, _ = dry.communicate(timeout=max(1.0, t0 + JOIN_S - time.monotonic()))
        res["dryrun"] = (dry.returncode, so)
    finally:
        for _, procs in jobs.values():
            for p in procs:
                p.kill()
        dry.kill()
    return res


def session_counters(stdout: str) -> dict:
    m = re.search(r"accumulator steps (\d+), windows (\d+), pairs (\d+), aborts (\d+); "
                  r"phase iterations (\d+), pairs (\d+), abort (\d+)", stdout)
    assert m, stdout[-2000:]
    return dict(zip(("steps", "windows", "pairs", "aborts", "it", "phase_pairs", "abort"),
                    map(int, m.groups())))


def block_counters(stdout: str) -> dict:
    """The block modes' steps and passes, and {collectives: how many} of
    each, from the session's line."""
    m = re.search(r"block mode: steps (\d+), collectives a step \{([^}]*)\}, passes (\d+), "
                  r"collectives a pass \{([^}]*)\}", stdout)
    assert m, stdout[-2000:]
    per = lambda t: {int(k): int(v) for k, v in
                     (kv.split(": ") for kv in t.split(", ") if kv)}
    return dict(steps=int(m.group(1)), per_step=per(m.group(2)), passes=int(m.group(3)),
                per_pass=per(m.group(4)))


def single_device(name: str, tmp, monkeypatch, env=None) -> dict:
    """The port's single-device default path on the same file (the CPU):
    its engine, accumulator and phase counters."""
    from meshclust2_tpu_torch import cli

    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    weights, fasta = SETS[name]
    res = cli.run(["--device", "cpu", "--recover", os.path.join(FIX, weights), "--output",
                   str(tmp / f"{name}_single.clstr"), os.path.join(FIX, fasta)])
    assert res.rc == 0
    s, acc, ph = res.engine.stats, res.accumulator, res.phase
    return dict(engine=(s.windows_scored, s.pairs_scored, s.clusters_before_update,
                        s.update_iterations),
                session=dict(steps=acc.total_steps, windows=acc.last_windows,
                             pairs=acc.last_pairs, aborts=acc.aborts,
                             it=ph.last_iterations, phase_pairs=ph.scored_pairs,
                             abort=ph.last_abort))


def ok_ranks(runs, key):
    out, got = runs[key]
    ranks = []
    for rc, so, se, _ in got:
        assert rc == 0, se[-3000:]
        assert SESSION in se and "per-window" not in se
        ranks.append((prof(so), session_counters(so)))
    with open(out, "rb") as f:
        return f.read(), ranks


@pytest.mark.parametrize("key", ["small1", "small2", "small4", "med2"])
def test_session_equals_jax_host_and_the_single_device_path(runs, key, tmp_path,
                                                            monkeypatch):
    name, nprocs, _ = JOBS[key]
    clstr, ranks = ok_ranks(runs, key)
    assert clstr == jax_host(name, tmp_path)
    if name == "small":
        with open(os.path.join(FIX, "small_ref.clstr"), "rb") as f:
            assert clstr == f.read()
    want = single_device(name, tmp_path, monkeypatch)
    assert [p["rank"] for p, _ in ranks] == list(range(nprocs))
    for p, sess in ranks:
        assert p["world"] == nprocs
        assert (p["windows"], p["pairs"], p["before"], p["iterations"]) == want["engine"]
        assert sess == want["session"]
        assert p["digest"] == ranks[0][0]["digest"]
    if name == "med2000":
        assert want["engine"] == (146, 165_218, 305, 6)
        assert want["session"]["steps"] == 393 and want["session"]["phase_pairs"] == 116_481


@pytest.mark.parametrize("key", ["small1", "small2", "small4", "med2"])
def test_block_mode_collectives(runs, key):
    """A scan step through the block mode makes 2 collectives and a pass 3
    at 2 and 4 ranks; one rank takes the one-launch kernels: no block-mode
    phase, no collective."""
    _, nprocs, _ = JOBS[key]
    for _, so, _, _ in runs[key][1]:
        got = block_counters(so)
        if nprocs == 1:
            assert got == dict(steps=0, per_step={}, passes=0, per_pass={})
            continue
        assert got["steps"] > 0 and got["per_step"] == {2: got["steps"]}
        assert got["passes"] > 0 and got["per_pass"] == {3: got["passes"]}
        # every window of the run went through a block-mode step
        assert got["steps"] == session_counters(so)["windows"]


def test_guarded_aborts_resume_on_the_host(runs, tmp_path, monkeypatch):
    """Every decision uncertain: the accumulate loop aborts at its first
    step and the phase at its first iteration on every rank alike; the
    host resolves both through MultihostScorer (every pair re-checked on
    fetched rows) and the CLSTR is the JAX host run's."""
    clstr, ranks = ok_ranks(runs, "abort2")
    assert clstr == jax_host("small", tmp_path)
    want = single_device("small", tmp_path, monkeypatch, JOBS["abort2"][2])
    for p, sess in ranks:
        assert sess == want["session"]
        assert sess["aborts"] >= 1 and sess["abort"] == 1
        assert p["rechecked"] == p["scored"] > 0 and 0 < p["remote"] < p["rows"]
        assert {k: v for k, v in p.items() if k not in ("rank", "remote")} == \
            {k: v for k, v in ranks[0][0].items() if k not in ("rank", "remote")}


def test_dead_rank_fails_its_peer(runs):
    out, got = runs["dead"]
    rc0, _, se0, t0 = got[0]
    assert got[1][0] == -signal.SIGKILL
    assert rc0 not in (0, None), se0[-2000:]
    assert SESSION in se0
    assert t0 < DEAD_PEER_S
    assert not os.path.exists(out)


def test_dryrun_multichip_on_two_cpu_ranks(runs):
    rc, so = runs["dryrun"]
    assert rc == 0, so[-3000:]
    assert "dryrun_multichip(2): ok" in so


def test_entry_forward_on_the_cpu():
    """entry()'s forward on the CPU: the fused decisions equal the plain
    sequence's; the float32 epilogue beside them agrees within float32."""
    import torch

    from meshclust2_tpu_torch.graft_entry import entry

    forward, (a_idx, b_idx) = entry("cpu")
    prob, dist, prob32, dist32 = forward(a_idx, b_idx)
    assert prob.shape == dist.shape == prob32.shape == dist32.shape == (64,)
    assert torch.isfinite(dist).all() and torch.isfinite(dist32).all()
    assert prob.dtype == torch.float64 and prob32.dtype == torch.float32
    np.testing.assert_allclose(dist32.double().numpy(), dist.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.floor(prob32.double().numpy() + 0.5),
                                  np.floor(prob.numpy() + 0.5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            entry()     # the card by default
