"""`python -m meshclust2_tpu_torch.cli --multihost --device cpu` as real gloo
process groups (parallel/multihost.py; one OS process a rank, MC2_NPROCS /
MC2_PROC_ID / MC2_COORD with a port from a free-port probe), all spawned
once for this file, every join bounded.  These runs take the per-window
route (MC2_NO_DEVICE_SESSION=1: MultihostScorer scores every window; the
device session's runs are tests/test_torch_multihost_session.py's), or
the host route of a pool the kernels do not take:

- 1 and 2 processes on small.fasta: the CLSTR byte for byte the JAX
  package's `--device host` run's and small_ref.clstr;
- 2 processes on med2000, whose host re-checks fire (rule (i) included:
  pairs at the rounding threshold): every rank re-checks pairs, fetches rows
  the other holds, takes the same branches (the same counters and the same
  clustering digest) and the CLSTR is the JAX `--device host` run's;
- 2 processes on small.fasta with uint16 histograms: the CLSTR the JAX
  `--device host` run's with the same weights;
- a dead peer: rank 1 is killed once its run is under way; rank 0 exits
  non-zero in bounded time and writes no CLSTR;
- a pool with uint32 histograms, which the kernels do not take, on 1 and 2
  processes: clustered on the host over fetched rows (FetchOracle), rc 0
  with its stderr line, the CLSTR the JAX `--device host` run's.
"""
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
SETS = {"small": ("small_ref_weights.txt", "small.fasta"),
        "med2000": ("med2000_weights.txt", "med2000.fasta")}
# the line every rank prints on stderr once its set-up is done
STARTED = "--multihost runs MultihostScorer per-window scoring"
# the host route's line (a pool the kernels do not take)
HOST_ROUTE = "clustering on the host scorer over the row-sharded store"
# the per-window route (the device session is the default)
PER_WINDOW = {"MC2_NO_DEVICE_SESSION": "1"}
JOIN_S = 240
DEAD_PEER_S = 90


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(name: str, nprocs: int, out: str, extra=PER_WINDOW):
    weights, fasta = SETS[name]
    weights = os.path.join(FIX, weights)
    return launch_with(weights, fasta, nprocs, out, extra)


def launch_with(weights: str, fasta: str, nprocs: int, out: str, extra=PER_WINDOW):
    port = free_port()
    procs = []
    for pid in range(nprocs):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(MC2_NPROCS=str(nprocs), MC2_PROC_ID=str(pid),
                   MC2_COORD=f"localhost:{port}", MC2_DEVICE_PROF="1",
                   OMP_NUM_THREADS="1", PYTHONPATH=ROOT, **extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "meshclust2_tpu_torch.cli", "--multihost",
             "--device", "cpu", "--recover", weights,
             "--output", out, os.path.join(FIX, fasta)],
            env=env, cwd=os.path.dirname(out), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def kill_when_started(proc, deadline: float):
    """Read proc's stderr until its STARTED line, then SIGKILL it."""
    def watch():
        for line in proc.stderr:
            if STARTED in line:
                break
        proc.send_signal(signal.SIGKILL)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    t.join(max(0.0, deadline - time.monotonic()))
    proc.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    jobs = {}
    for key, (name, nprocs) in {"small1": ("small", 1), "small2": ("small", 2),
                                "med2": ("med2000", 2), "dead": ("small", 2)}.items():
        d = tmp / key
        d.mkdir()
        jobs[key] = (str(d / "out.clstr"), launch(name, nprocs, str(d / "out.clstr")))
    # small.fasta with uint16 histograms: the all-to-all and the fetches at
    # the other width the kernels take
    d = tmp / "small16"
    d.mkdir()
    jobs["small16"] = (str(d / "out.clstr"),
                       launch_with(uint16_weights(d), "small.fasta", 2, str(d / "out.clstr")))
    # uint32 histograms: the host route, on the session's default
    d = tmp / "small32"
    d.mkdir()
    jobs["small32"] = (str(d / "out.clstr"),
                       launch_with(wide_weights(d), "small.fasta", 2, str(d / "out.clstr"),
                                   {}))
    t0 = time.monotonic()
    kill_when_started(jobs["dead"][1][1], t0 + JOIN_S)
    res = {}
    try:
        for key, (out, procs) in jobs.items():
            got = []
            for p in procs:
                so, se = p.communicate(timeout=max(1.0, t0 + JOIN_S - time.monotonic()))
                got.append((p.returncode, so, se, time.monotonic() - t0))
            res[key] = (out, got)
    finally:
        for _, procs in jobs.values():
            for p in procs:
                p.kill()
    return res


def uint16_weights(tmp) -> str:
    """small_ref_weights.txt with uint16 histograms, written into tmp."""
    with open(os.path.join(FIX, "small_ref_weights.txt")) as f:
        text = f.read()
    assert "Datatype: uint8_t" in text
    path = tmp / "w16.txt"
    path.write_text(text.replace("Datatype: uint8_t", "Datatype: uint16_t"))
    return str(path)


def wide_weights(tmp) -> str:
    """small_ref_weights.txt with uint32 histograms, written into tmp."""
    with open(os.path.join(FIX, "small_ref_weights.txt")) as f:
        text = f.read()
    assert "Datatype: uint8_t" in text
    path = tmp / "w32.txt"
    path.write_text(text.replace("Datatype: uint8_t", "Datatype: uint32_t"))
    return str(path)


def jax_host(name: str, tmp, weights=None) -> bytes:
    from meshclust2_tpu.cli import main

    w, fasta = SETS[name]
    out = str(tmp / f"{name}_host.clstr")
    assert main(["--recover", weights or os.path.join(FIX, w), "--output", out,
                 "--device", "host", os.path.join(FIX, fasta)]) == 0
    with open(out, "rb") as f:
        return f.read()


def prof(stdout: str) -> dict:
    m = re.search(r"multihost rank (\d+) of (\d+): windows (\d+), pairs (\d+), clusters "
                  r"(\d+) -> (\d+), iterations (\d+), scored (\d+), re-checked (\d+) "
                  r"\[(\d+), (\d+), (\d+)\], fetches (\d+) \((\d+) rows, (\d+) remote\), "
                  r"output (\w+)", stdout)
    assert m, stdout[-2000:]
    keys = ("rank", "world", "windows", "pairs", "before", "after", "iterations", "scored",
            "rechecked", "rule_i", "rule_ii", "rule_iii", "fetches", "rows", "remote")
    out = dict(zip(keys, map(int, m.groups()[:-1])))
    out["digest"] = m.group(16)
    return out


def ok_runs(runs, key, started=STARTED):
    out, got = runs[key]
    for rc, so, se, _ in got:
        assert rc == 0, se[-3000:]
        assert started in se
    with open(out, "rb") as f:
        return f.read(), [prof(so) for _, so, _, _ in got]


@pytest.mark.parametrize("key", ["small1", "small2"])
def test_small_equals_jax_host_and_reference(runs, key, tmp_path):
    clstr, ranks = ok_runs(runs, key)
    assert clstr == jax_host("small", tmp_path)
    with open(os.path.join(FIX, "small_ref.clstr"), "rb") as f:
        assert clstr == f.read()
    assert [r["rank"] for r in ranks] == list(range(len(ranks)))


def test_rechecks_fetch_across_ranks_and_agree(runs, tmp_path):
    """med2000 on 2 ranks: host re-checks fire on every rank (rule (i)
    among them), each fetches rows the other holds, both take the same
    branches, and the CLSTR is the JAX --device host run's."""
    clstr, ranks = ok_runs(runs, "med2")
    assert clstr == jax_host("med2000", tmp_path)
    same = ("windows", "pairs", "before", "after", "iterations", "scored", "rechecked",
            "rule_i", "rule_ii", "rule_iii", "fetches", "rows", "digest")
    assert {k: ranks[0][k] for k in same} == {k: ranks[1][k] for k in same}
    for r in ranks:
        assert r["world"] == 2 and r["rechecked"] > 0 and r["rule_i"] > 0
        assert 0 < r["remote"] < r["rows"]
    # the scorer-alone counters of the single-process engine
    assert (ranks[0]["windows"], ranks[0]["pairs"], ranks[0]["before"],
            ranks[0]["iterations"]) == (146, 62_376, 305, 6)


def test_uint16_pool_equals_jax_host(runs, tmp_path):
    """small.fasta with uint16 histograms on 2 ranks: the rows travel at
    two bytes a count through the all-to-all and the re-checks' fetches,
    and the CLSTR is the JAX --device host run's with the same weights."""
    clstr, ranks = ok_runs(runs, "small16")
    assert clstr == jax_host("small", tmp_path, uint16_weights(tmp_path))
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for r in ranks:
        assert r["world"] == 2 and r["rechecked"] > 0 and 0 < r["remote"] < r["rows"]


def test_uint32_pool_takes_the_host_route(runs, tmp_path):
    """uint32 histograms on 2 ranks: every window through FetchOracle over
    rows fetched from both ranks, rc 0, the CLSTR the JAX --device host
    run's with the same weights."""
    clstr, ranks = ok_runs(runs, "small32", HOST_ROUTE)
    _, got = runs["small32"]
    for _, _, se, _ in got:
        assert "uint32 histograms" in se and STARTED not in se
    assert clstr == jax_host("small", tmp_path, wide_weights(tmp_path))
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for r in ranks:
        assert r["world"] == 2 and r["scored"] == 0 and 0 < r["remote"] < r["rows"]


def test_dead_peer_fails_the_run(runs):
    out, got = runs["dead"]
    rc0, _, se0, t0 = got[0]
    assert got[1][0] == -signal.SIGKILL
    assert rc0 not in (0, None), se0[-2000:]
    assert t0 < DEAD_PEER_S
    assert not os.path.exists(out)


def test_multihost_needs_recover(capsys):
    from meshclust2_tpu_torch import cli

    res = cli.run(["--multihost", "--device", "cpu", os.path.join(FIX, "small.fasta")])
    assert res.rc == 2
    assert "--multihost requires --recover" in capsys.readouterr().err


def test_multihost_cuda_without_a_card_raises(monkeypatch):
    import torch

    from meshclust2_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.run(["--multihost", "--recover", os.path.join(FIX, "small_ref_weights.txt"),
                 os.path.join(FIX, "small.fasta")])


@pytest.mark.parametrize("pid", [0, 1, 2])
def test_load_points_multihost_equals_jax(pid):
    """The block-parallel load of one of 3 processes: the same headers,
    block bounds and block counts as the JAX package's."""
    import numpy as np

    from meshclust2_tpu.parallel.multihost import load_points_multihost as jax_load

    from meshclust2_tpu_torch.parallel.multihost import load_points_multihost

    files = [os.path.join(FIX, "small.fasta")]
    headers, local, bounds = load_points_multihost(files, 5, "uint8_t", pid, 3)
    j_headers, j_local, j_bounds = jax_load(files, 5, "uint8_t", pid, 3)
    assert headers == j_headers and bounds == j_bounds
    for f in ("counts", "one_mers", "mags", "lengths"):
        np.testing.assert_array_equal(getattr(local, f), getattr(j_local, f), err_msg=f)


def test_multihost_refuses_a_pool_the_kernels_do_not_take(tmp_path, capsys):
    """uint32 histograms, which the kernels do not take, in one process: no
    session and no kernel; the host route with its stderr line naming the
    reason, rc 0, the JAX --device host run's CLSTR, and the one-rank
    group it formed released."""
    import torch.distributed as dist

    from meshclust2_tpu_torch import cli

    weights = wide_weights(tmp_path)
    out = tmp_path / "out.clstr"
    initialized = dist.is_initialized()
    res = cli.run(["--multihost", "--device", "cpu", "--recover", weights,
                   "--output", str(out), os.path.join(FIX, "small.fasta")])
    assert res.rc == 0
    err = capsys.readouterr().err
    assert "uint32 histograms" in err and HOST_ROUTE in err
    assert res.accumulator is None and res.scorer.__class__.__name__ == "FetchOracle"
    assert out.read_bytes() == jax_host("small", tmp_path, weights)
    assert dist.is_initialized() == initialized


def test_refusal_names_the_envelope():
    """A pool outside the kernels' exact-integer envelope takes the same
    host route as a uint32 pool: `refusal` names it from the metadata."""
    import numpy as np

    from meshclust2_tpu_torch.parallel.multihost import _MetaPS, refusal

    meta = _MetaPS(5, ["a", "b"], np.array([900, 1000]), np.array([800, 900]),
                   np.ones(2), np.zeros((2, 4), np.uint64), 1024)
    meta.dtype, meta.maxc = np.uint16, 200
    meta.self_dots = np.array([5_000, 3_000_000_000])
    assert "self dot >= 2^31" in refusal(meta)
    assert "exact-integer envelope" in refusal(meta)
    meta.self_dots = np.array([5_000, 6_000])
    assert refusal(meta) is None
    meta.dtype = np.uint64
    assert "uint64 histograms" in refusal(meta)
