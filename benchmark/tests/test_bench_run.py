"""Whole runs of the harness on the CPU at a tiny size (the kernels' plain
versions), past its look for a card: the reference agrees with the port;
with the timed path broken underneath, `correct` comes out false; the
float32 control fails the search's check; without a card, no result."""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from harness import main as H
from harness import plan as P
from conftest import ROOT


def run_cell(bench_copy, workload, capsys, seconds=1.0, trace=0):
    plan = P.load(workload, str(bench_copy))
    args = argparse.Namespace(workload=workload, seed=2**31 + 12345,
                              seconds=seconds, trace=trace)
    assert H.run_cell(plan, args, time.monotonic(), "cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["cluster-tiny", "search-tiny"])
def test_port_agrees_with_the_reference(bench_copy, capsys, workload):
    res = run_cell(bench_copy, workload, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2 and res["attempted"] % 2 == 0   # whole cycles
    assert all(v["value"] <= v["limit"] for v in res["checked"].values())
    assert {k for k, v in res["checked"].items() if v["value"] != 0} <= {"glm_sum_gap"}
    assert list(res)[-1] == "checked"


def test_traced_run_reads_its_metrics(bench_copy, capsys):
    res = run_cell(bench_copy, "cluster-tiny", capsys, seconds=0.01, trace=1)
    assert res["correct"] is True
    assert {"job_setup_s", "accumulate_ms_per_step", "update_s"} <= set(res["metrics"])
    assert res["device"]["busy_s"] > 0 and len(res["breakdown"]["device_ops"]) <= 10


def _move_a_member(orig):
    def write(path, clusters):
        clusters = list(clusters)
        clusters[0] = {"members": clusters[0]["members"] + clusters[1]["members"][:1]}
        clusters[1] = {"members": clusters[1]["members"][1:]}
        return orig(path, clusters)
    return write


def _half(orig):
    def read(path, *a):
        records = orig(path, *a)
        return records[: len(records) // 2]
    return read


def _flip_first(orig):
    def search(self, a, b, oracle):
        keep, sim = orig(self, a, b, oracle)
        keep = keep.copy()
        keep[0] = not keep[0]
        if sim is not None and keep[0]:
            sim = sim.copy()
            sim[0] = 0.5
        return keep, sim
    return search


def _half_chunks(orig):
    def load(files, *a, **kw):
        for ps in orig(files, *a, **kw):
            yield ps.subset(np.arange(ps.n // 2))
    return load


def _float32_sums(orig):
    def ref(*a, **kw):
        stats, dec = orig(*a, **kw)
        dec[0] = dec[0].float().double()
        return stats, dec
    return ref


FAULTS = {
    # the classifier's sums in float32 where the configuration states float64
    "cluster-float32": ("cluster-tiny", "meshclust2_tpu_torch.ops.pair_stats",
                        "pair_stats_decision_ref", _float32_sums),
    # an answer altered where it is produced: a member moved to another cluster
    "cluster-answer": ("cluster-tiny", "meshclust2_tpu_torch.cli", "write_clstr",
                       _move_a_member),
    # half of the batch left out: half of the pool read
    "cluster-half": ("cluster-tiny", "meshclust2_tpu_torch.cli", "read_fasta", _half),
    # a step that returns its state unchanged: the update phase does nothing
    "cluster-unchanged": ("cluster-tiny", "meshclust2_tpu_torch.cluster.engine",
                          "MeanShiftEngine.update_phase",
                          lambda orig: (lambda self, clusters, **kw: None)),
    # an answer altered where it is produced: one pair's decision flipped
    "search-answer": ("search-tiny", "meshclust2_tpu_torch.cluster.device_search",
                      "TorchDeviceSearch.search", _flip_first),
    # half of the batch left out: half of each chunk searched
    "search-half": ("search-tiny", "meshclust2_tpu_torch.fastcar", "load_chunks",
                    _half_chunks),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(bench_copy, capsys, monkeypatch, fault):
    import importlib

    workload, mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    owner, name = mod, attr
    if "." in attr:
        cls, name = attr.split(".")
        owner = getattr(mod, cls)
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    res = run_cell(bench_copy, workload, capsys)
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_the_float32_control_fails_the_search(bench_copy):
    import torch

    import reference as R
    from readings import control_lines
    from reference import compare as C
    from harness.pools import write_pool

    plan = P.load("search-tiny", str(bench_copy))
    pool = str(bench_copy / "pool.fasta")
    write_pool(pool, 2**31 + 99, 0, plan.traffic)
    w = plan.path(plan.config["weights"])
    ref = R.search_all(pool, pool, w, torch.device("cpu"))
    ctl = R.search_all(pool, pool, w, torch.device("cpu"), dtype=np.float32)
    control_lines(ctl, pool + ".control")
    control_lines(ref, pool + ".same")
    assert C.lines_off(ref, pool + ".same") == 0
    assert C.lines_off(ref, pool + ".control") > 0


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is here: the look for one succeeds")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "cluster-fast-10k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 2
    assert not res.stdout.strip()


def test_no_program_no_result(tmp_path):
    # a checkout that holds only BENCHMARK.json and benchmark/: the port is
    # not there, the warm job fails, and no result is printed
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import argparse, sys, time; sys.path[:0] = ['benchmark', '.']\n"
            "from harness import main, plan\n"
            "a = argparse.Namespace(workload='cluster-fast-10k', seed=1, seconds=1, trace=0)\n"
            "sys.exit(main.run_cell(plan.load('cluster-fast-10k', '.'), a, time.monotonic(), 'cpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode != 0
    assert "meshclust2_tpu_torch" in res.stderr
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
