"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q`."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import json  # noqa: E402
import shutil  # noqa: E402

import pytest  # noqa: E402

TINY = {"why": "test", "n_seqs": 400, "n_templates": 20, "len_lo": 800,
        "len_hi": 1500, "rate_lo": 0.01, "rate_hi": 0.12, "pools": 2,
        "trace_jobs": 1}


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark that a later change would make: one traffic
    file more (tiny), one configuration more (mc2-tiny, which samples more
    launches) and two cell entries (cluster-tiny, search-tiny), each listed
    by the metrics of its program; no file of the copy edited but
    BENCHMARK.json."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(tmp_path / "benchmark" / "traffic" / "tiny.json", "w") as f:
        json.dump(TINY, f)
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    # a tiny pool's job makes a few hundred launches: sample more of them
    conf_dir = tmp_path / "benchmark" / "configs"
    with open(conf_dir / "mc2-fast-id90.json") as f:
        conf = json.load(f)
    conf.update(name="mc2-tiny", sample={"every": 2, "pairs": 16})
    with open(conf_dir / "mc2-tiny.json", "w") as f:
        json.dump(conf, f)
    bench["configs"].append(dict(bench["configs"][0], name="mc2-tiny",
                                 file="benchmark/configs/mc2-tiny.json"))
    bench["workloads"] += [
        {"name": "cluster-tiny", "config": "mc2-tiny", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "search-tiny", "config": "fastcar-fast-id90", "traffic": "tiny",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("search-tiny" if "search-fast-10k" in m["workloads"]
                                  else "cluster-tiny")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return tmp_path
