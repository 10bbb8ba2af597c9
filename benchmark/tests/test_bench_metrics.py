"""The metric arithmetic on synthetic stamps, launches and profiler events:
the rate over all the window's work, the idle union, the rooflines from
the frozen bounds."""
import importlib.util
import os
from types import SimpleNamespace

import pytest

from harness.jobs import Job
from harness.main import Run
from harness.trace import Launches, reduce_events, short_name
from metrics import _bounds as B

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cluster_job(start, end, setup, acc, upd, steps, n=1000):
    return Job("cluster", 0, n, start, end, stamps={
        "read_in_points": start + setup, "accumulate": start + setup + acc,
        "update": start + setup + acc + upd}, counters={"steps": steps})


def test_rate_is_all_work_over_all_time():
    # a job that starts inside the window runs to its end, and counts
    jobs = [cluster_job(10.0, 12.0, 0.5, 1.0, 0.2, 100),
            cluster_job(12.0, 14.5, 0.5, 1.5, 0.2, 200),
            cluster_job(14.5, 17.0, 0.5, 1.5, 0.2, 300)]
    run = Run(setup_s=9.0, t_open=10.0, jobs=jobs)
    assert reader("cluster_seqs_per_s")(run) == pytest.approx(3000 / 7.0)
    assert reader("search_queries_per_s")(run) is None
    assert reader("setup_s")(run) == 9.0
    assert reader("job_setup_s")(run) == pytest.approx(0.5)
    assert reader("accumulate_ms_per_step")(run) == pytest.approx(1e3 * 4.0 / 600)
    assert reader("update_s")(run) == pytest.approx(0.2)


def test_search_parts():
    jobs = [Job("search", 0, 10000, 1.0, 7.0, counters={"search_s": 5.0, "score_s": 2.0,
                                                         "positives": 5}),
            Job("search", 1, 10000, 7.0, 12.0, counters={"search_s": 4.0, "score_s": 1.0,
                                                          "positives": 5})]
    run = Run(setup_s=1.0, t_open=1.0, jobs=jobs)
    assert reader("search_queries_per_s")(run) == pytest.approx(20000 / 11.0)
    assert reader("search_host_s")(run) == pytest.approx(3.0)
    assert reader("search_score_s")(run) == pytest.approx(1.5)
    assert reader("cluster_seqs_per_s")(run) is None


class Ev:
    def __init__(self, name, start, dur, kind="CUDA"):
        self._n, self._s, self._d = name, start, dur
        self._k = SimpleNamespace(name=kind)

    def name(self):
        return self._n

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_idle_union_and_gaps():
    ev = [Ev("void pair_stats_kernel<unsigned char>(Args)", 0, 100),
          Ev("window_step_kernel(StepArgs)", 50, 100),      # overlaps: union 150
          Ev("Memcpy DtoH (Device -> Pinned)", 400, 100),
          Ev("aten::add", 0, 10_000, kind="CPU")]           # not the card's
    tr = reduce_events(ev, window_s=1e-6)
    assert tr.busy_s == pytest.approx(250e-9)
    assert tr.by_kernel == pytest.approx({"pair_stats_kernel": 100e-9,
                                          "window_step_kernel": 100e-9,
                                          "Memcpy DtoH": 100e-9})
    assert tr.gaps == [pytest.approx((150e-9, 400e-9, "Memcpy DtoH"))]
    job = Job("cluster", 0, 1, 0.0, 1.0)
    run = Run(setup_s=0, t_open=0, jobs=[job], traced=[job], trace=tr,
              launches=Launches())
    assert reader("device_idle.cluster")(run) == pytest.approx(75.0)
    assert reader("device_idle.search")(run) is None


def test_short_names():
    assert short_name("void (anonymous namespace)::pair_stats_kernel<unsigned char, 1>"
                      "(Args)") == "pair_stats_kernel"
    assert short_name("void at::native::elementwise_kernel<128, 4, at::native::"
                      "gpu_kernel_impl<F>(at::TensorIteratorBase&, F const&)::"
                      "{lambda(int)#1}>(int, F)") == "elementwise_kernel"
    assert short_name("Memset (Device)") == "Memset (Device)"


def test_rooflines_from_the_frozen_bounds():
    d, p = 1024, 1 << 24
    # the search's slice: operations bound it
    want = (8 * p * d + p * (12 + 11 * 5 + 5 * 4)) / B.OPS_PER_S
    assert B.decision_bound(10000, d, 1, p, p, 5, 4) == pytest.approx(want)
    # a center-form launch over 2,000 rows: bytes bound it
    nbytes = 2001 * (d + 32) + 8 * 2001 + 48 * 2000 + 8 * (4 + 4 * 10)
    assert B.decision_bound(2001, d, 1, 2000, 1, 6, 4) == pytest.approx(nbytes / 3.35e12)
    launches = Launches()
    launches.calls["pair_stats_decision"] = [
        dict(rows=2001, d=d, elem=1, p=2000, nb=1, singles=(8192, 32), combos=4,
             plane=False)] * 3
    launches.calls["window_step"] = [dict(w=2000, npos=10, mcnt=5, d=d, elem=1)] * 2
    tr = SimpleNamespace(by_kernel={"pair_stats_kernel": 3e-5, "window_step_kernel": 4e-5})
    job = Job("cluster", 0, 1, 0.0, 1.0)
    run = Run(setup_s=0, t_open=0, jobs=[job], traced=[job], trace=tr, launches=launches)
    least = 3 * B.decision_bound(2001, d, 1, 2000, 1, 2, 4)
    assert reader("pair_stats_roofline.cluster")(run) == pytest.approx(100 * least / 3e-5)
    assert reader("pair_stats_roofline.search")(run) is None
    step = 2 * B.step_bound(2000, 10, 15, d, 1)
    assert reader("window_step_roofline")(run) == pytest.approx(100 * step / 4e-5)
    # a model with a full-vector single is not bounded here: no reading
    launches.calls["pair_stats_decision"][0] = dict(
        launches.calls["pair_stats_decision"][0], singles=(1 << 7,))
    assert reader("pair_stats_roofline.cluster")(run) is None
