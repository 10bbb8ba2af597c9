"""The span metrics: their arithmetic on synthetic records of the program's
clock, no reading from a program that keeps none, and each of them read in
a CPU rehearsal of a traced run of its cell."""
from collections import deque
from types import SimpleNamespace

import pytest

from harness.jobs import Job
from harness.main import Run
from test_bench_metrics import reader
from test_bench_run import run_cell

SPAN_METRICS = {
    "cluster-tiny": ["step_window_us", "step_scan_us", "step_read_us",
                     "step_seed_us", "accumulate_host_s", "setup_count_s",
                     "session_build_s", "idle_in_step_issue.cluster"],
    "search-tiny": ["search_load_s", "search_write_s", "search_recheck_s",
                    "idle_in_host_stages.search"],
}


def record(start, spans, intervals=()):
    """A clock record starting at monotonic second `start`: spans name ->
    (seconds, count)."""
    from meshclust2_tpu_torch.utils.clock import Record

    ns = lambda s: int(round(s * 1e9))   # noqa: E731
    return Record(1, ns(start), ns(start + 1), {},
                  {k: (ns(s), n, ns(s), None) for k, (s, n) in spans.items()},
                  [(k, None, ns(a), ns(b)) for k, a, b in intervals])


@pytest.fixture
def finished(monkeypatch):
    from meshclust2_tpu_torch.utils import clock

    recs = deque(maxlen=256)
    monkeypatch.setattr(clock, "FINISHED", recs)
    return recs


def test_span_metrics_over_the_jobs(finished):
    jobs = [Job("cluster", 0, 1000, 10.0, 12.0, counters={"steps": 100}),
            Job("cluster", 1, 1000, 12.0, 15.0, counters={"steps": 300})]
    finished.extend([
        record(9.0, {"accumulate.window": (9.0, 9)}),      # before the window
        record(10.1, {"accumulate.window": (0.02, 100), "accumulate.scan": (0.04, 90),
                      "accumulate.read": (0.01, 101), "accumulate.upload": (0.5, 1),
                      "accumulate.seed": (0.02, 10),
                      "setup.read": (0.25, 1), "setup.count": (0.5, 1),
                      "setup.session": (1.0, 1)}),
        record(12.1, {"accumulate.window": (0.06, 300), "accumulate.scan": (0.08, 250),
                      "accumulate.read": (0.03, 301), "accumulate.consume": (0.25, 1),
                      "accumulate.resolve": (0.25, 2), "setup.count": (0.25, 1),
                      "setup.session": (2.0, 1)})])
    run = Run(setup_s=1.0, t_open=10.0, jobs=jobs)
    assert reader("step_window_us")(run) == pytest.approx(1e6 * 0.08 / 400)
    assert reader("step_scan_us")(run) == pytest.approx(1e6 * 0.12 / 400)
    assert reader("step_read_us")(run) == pytest.approx(1e6 * 0.04 / 400)
    assert reader("step_seed_us")(run) == pytest.approx(1e6 * 0.02 / 400)
    assert reader("accumulate_host_s")(run) == pytest.approx(0.5)
    assert reader("setup_count_s")(run) == pytest.approx(0.5)
    assert reader("session_build_s")(run) == pytest.approx(1.5)
    assert reader("search_load_s")(run) is None
    search = [Job("search", 0, 10, 1.0, 3.0), Job("search", 1, 10, 3.0, 5.0)]
    finished.extend([record(1.5, {"search.load": (0.5, 2), "search.write": (0.25, 1),
                                  "search.recheck": (0.125, 1)}),
                     record(3.5, {"search.load": (0.25, 2), "search.write": (0.75, 1)})])
    run = Run(setup_s=1.0, t_open=1.0, jobs=search)
    assert reader("search_load_s")(run) == pytest.approx(0.375)
    assert reader("search_write_s")(run) == pytest.approx(0.5)
    assert reader("search_recheck_s")(run) == pytest.approx(0.0625)
    assert reader("step_window_us")(run) is None


def test_no_records_no_reading(monkeypatch):
    # a program whose clock keeps no records (the parent of the spans)
    from meshclust2_tpu_torch.utils import clock

    monkeypatch.delattr(clock, "FINISHED", raising=False)
    jobs = [Job("cluster", 0, 1000, 10.0, 12.0, counters={"steps": 100}),
            Job("search", 0, 10, 12.0, 13.0)]
    run = Run(setup_s=1.0, t_open=10.0, jobs=jobs, traced=jobs[:1],
              trace=SimpleNamespace(gaps=[(1.0, 2.0, "k")], window_s=2.0))
    for names in SPAN_METRICS.values():
        for name in names:
            assert reader(name)(run) is None


def test_idle_in_the_spans(finished):
    # the trace's gaps in epoch seconds, the spans' intervals in monotonic
    # time: an epoch of 1000 s apart
    job = Job("cluster", 0, 1000, 10.0, 20.0, counters={"steps": 3})
    finished.append(record(10.0, {}, [
        ("accumulate.window", 11.0, 12.0), ("accumulate.read", 12.0, 13.0),
        ("accumulate.scan", 13.0, 14.0), ("accumulate.seed", 15.0, 16.0),
        ("search.load", 16.0, 17.0)]))
    gaps = [(1011.5, 1012.5, "k"), (1013.5, 1015.5, "k"), (1016.5, 1019.0, "k")]
    run = Run(setup_s=0.0, t_open=0.0, jobs=[], traced=[job], epoch=1000.0,
              trace=SimpleNamespace(gaps=gaps, window_s=10.0))
    # window 11.5-12, scan 13.5-14, seed 15-15.5: 1.5 s of 10
    assert reader("idle_in_step_issue.cluster")(run) == pytest.approx(15.0)
    assert reader("idle_in_host_stages.search")(run) is None   # not a search
    job.program = "search"
    assert reader("idle_in_host_stages.search")(run) == pytest.approx(5.0)


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_run_reads_the_span_metrics(bench_copy, capsys, workload):
    res = run_cell(bench_copy, workload, capsys, seconds=0.01, trace=1)
    assert res["correct"] is True
    for name in SPAN_METRICS[workload]:
        value = res["metrics"][name]["value"]
        assert value >= 0, name
        if name.startswith("idle_in"):
            # idle inside the spans is a part of the card's idle time
            idle = res["metrics"]["device_idle." + name.split(".")[1]]["value"]
            assert value <= idle + 1e-9
