"""The long-record cell (cluster-long-k7: ~10 kbp records at k = 7) as
committed: it plans with its configuration's weights at k = 7 and reports
the host's row passes; the reader of those passes on synthetic records of
the program's clock."""
import pytest

from harness import plan as P
from harness.jobs import Job
from harness.main import Run
from test_bench_metrics import reader
from test_bench_spans import finished, record  # noqa: F401 - a fixture


def test_the_long_cell_plans():
    plan = P.load("cluster-long-k7")
    assert plan.cell["chips"] == 1 and plan.config["program"] == "cluster"
    assert P.weights_header(plan.path(plan.config["weights"]))["k"] == "7"
    assert plan.traffic["len_lo"] >= 8000 and plan.traffic["n_seqs"] == 10000
    assert [m.name for m in plan.end_to_end] == ["cluster_seqs_per_s", "setup_s"]
    names = [m.name for m in plan.per_layer]
    assert {"host_row_passes_s", "job_setup_s", "update_s",
            "pair_stats_roofline.cluster", "window_step_roofline",
            "device_idle.cluster"} <= set(names)
    for cell in ("cluster-fast-10k", "cluster-fast-100k"):
        assert "host_row_passes_s" in [m.name for m in P.load(cell).per_layer]
    assert "host_row_passes_s" not in [m.name for m in P.load("search-fast-10k").per_layer]


def test_host_row_passes_over_the_jobs(finished):  # noqa: F811
    jobs = [Job("cluster", 0, 1000, 10.0, 12.0), Job("cluster", 1, 1000, 12.0, 15.0)]
    run = Run(setup_s=1.0, t_open=10.0, jobs=jobs)
    # a program without the spans (the parent of them) gives no reading
    finished.extend([record(10.1, {"setup.count": (0.5, 1)}),
                     record(12.1, {"setup.count": (0.5, 1)})])
    assert reader("host_row_passes_s")(run) is None
    finished.clear()
    finished.extend([
        record(9.0, {"setup.moments": (9.0, 1)}),          # before the window
        record(10.1, {"setup.moments": (0.25, 1), "session.envelope": (0.5, 2),
                      "setup.count": (1.0, 1)}),
        record(12.1, {"setup.moments": (0.125, 1), "session.envelope": (0.375, 2)})])
    assert reader("host_row_passes_s")(run) == pytest.approx((0.75 + 0.5) / 2)
    search = Run(setup_s=1.0, t_open=10.0, jobs=[Job("search", 0, 10, 10.0, 12.0)])
    assert reader("host_row_passes_s")(search) is None
