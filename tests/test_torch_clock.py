"""The port's clock (meshclust2_tpu_torch/utils/clock.py): spans, their
parents and self times, the no-op without a current clock, the
bounded list of finished runs, intervals only under a profiler, profiler
ranges only under the program's own --profile on the same clock as the
spans; and the spans of a CLI and a fastcar run on the CPU, an aborting
one included."""
import glob
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.profiler as tp

from meshclust2_tpu_torch import cli, fastcar
from meshclust2_tpu_torch.cluster.device_loop import TorchDeviceAccumulator
from meshclust2_tpu_torch.utils import clock as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FASTCAR_WEIGHTS = os.path.join(ROOT, "benchmark", "configs",
                               "fastcar-fast-id90.weights.txt")
STEP_SPANS = ("accumulate.window", "accumulate.read", "accumulate.scan",
              "accumulate.seed", "accumulate.upload", "accumulate.consume",
              "accumulate.resolve")


def busy(seconds):
    t = time.monotonic() + seconds
    while time.monotonic() < t:
        pass


def test_spans_nest_with_parents_and_self_time():
    with C.Clock() as clock:
        assert C.current() is clock
        with C.span("outer"):
            busy(0.002)
            for _ in range(3):
                with C.span("inner"):
                    busy(0.001)
        with C.span("outer"):
            pass
    assert C.current() is None
    rec = C.FINISHED[-1]
    assert rec.run == clock.run and rec.start_ns == clock.start_ns
    assert rec.end_ns >= rec.start_ns
    outer, inner = rec.spans["outer"], rec.spans["inner"]
    assert (outer[1], outer[3]) == (2, None)
    assert (inner[1], inner[3]) == (3, "outer")
    assert inner[0] >= 3_000_000 and inner[2] == inner[0]     # no children
    assert outer[0] >= inner[0] + 2_000_000
    assert outer[2] == outer[0] - inner[0]                    # self time
    assert rec.intervals == []                                # no profiler
    assert clock.seconds("inner") == pytest.approx(inner[0] * 1e-9)
    assert clock.calls("outer") == 2 and clock.calls("none") == 0


def test_no_current_clock_is_a_shared_noop():
    assert C.current() is None
    n = len(C.FINISHED)
    a, b = C.span("x"), C.span("y")
    assert a is b
    with a as s:
        busy(0.001)
    assert s.ns == 0 and s.seconds == 0.0
    # a timed span measures on a clock of its own, kept nowhere
    with C.timed("x") as t:
        busy(0.001)
    assert t.ns >= 1_000_000
    assert len(C.FINISHED) == n


def test_the_enclosing_clock_is_current_again():
    with C.Clock() as outer:
        with C.Clock() as inner:
            with C.span("a"):
                pass
            assert C.current() is inner
        assert C.current() is outer
        with C.span("b"):
            pass
    assert "a" not in C.FINISHED[-1].spans and "b" in C.FINISHED[-1].spans
    assert "a" in C.FINISHED[-2].spans
    assert outer.run != inner.run


def test_finished_is_bounded():
    for _ in range(300):
        with C.Clock():
            pass
    assert len(C.FINISHED) == C.FINISHED.maxlen == 256
    runs = [r.run for r in C.FINISHED]
    assert runs == sorted(runs)


def test_intervals_only_under_a_profiler():
    with C.Clock() as clock:
        with C.span("before"):
            pass
        with tp.profile(activities=[tp.ProfilerActivity.CPU]):
            with C.span("during"):
                with C.span("child"):
                    torch.ones(3).sum()
        with C.span("after"):
            pass
    rec = C.FINISHED[-1]
    assert [(n, p) for n, p, _, _ in rec.intervals] == [("child", "during"),
                                                        ("during", None)]
    (_, _, c0, c1), (_, _, d0, d1) = rec.intervals
    assert d0 <= c0 <= c1 <= d1
    assert clock.calls("before") == clock.calls("after") == 1


def names_in(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_ranges_only_under_the_programs_own_profile():
    spans = {"s.one", "s.two"}

    def work():
        for name in sorted(spans):
            with C.span(name):
                torch.ones(8).cumsum(0)

    # a profiler the program did not start: no range of a span
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        with C.Clock():
            work()
    assert not spans & names_in(prof)
    assert len(C.FINISHED[-1].intervals) == 2
    # the program's own --profile: one range a span
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        with C.Clock(annotate=True):
            work()
    assert spans <= names_in(prof)
    # and no profiler at all: nothing to annotate
    with C.Clock(annotate=True):
        work()
    assert C.FINISHED[-1].intervals == []


def test_span_lines_under_device_prof(monkeypatch, capsys):
    monkeypatch.setenv("MC2_DEVICE_PROF", "1")
    with C.Clock():
        with C.span("p"):
            with C.span("q"):
                busy(0.001)
    out = capsys.readouterr().out.splitlines()
    lines = {ln.split()[1]: ln.split() for ln in out if ln.startswith("span ")}
    assert set(lines) == {"p", "q"}
    _, _, total, n, own = lines["p"]
    assert int(n) == 1 and float(own) < float(total)
    assert float(lines["q"][2]) >= 0.001


def run_cli(fixtures_dir, tmp_path, name, *extra, pool="small"):
    out = str(tmp_path / name)
    weights = "small_ref_weights.txt" if pool == "small" else f"{pool}_weights.txt"
    res = cli.run(["--device", "cpu", "--recover",
                   os.path.join(fixtures_dir, weights),
                   "--output", out, *extra,
                   os.path.join(fixtures_dir, f"{pool}.fasta")])
    assert res.rc == 0
    with open(out, "rb") as f:
        return res, f.read(), C.FINISHED[-1]


def test_cli_spans_cover_the_accumulate_and_set_up_parts(fixtures_dir, tmp_path,
                                                         monkeypatch):
    reads = []
    window = TorchDeviceAccumulator._window

    def counted(self, *a):
        reads.append(1)
        return window(self, *a)

    monkeypatch.setattr(TorchDeviceAccumulator, "_window", counted)
    res, _, rec = run_cli(fixtures_dir, tmp_path, "out.clstr")
    assert rec.run == res.clock.run and rec.stamps == res.clock.stamps
    spans = rec.spans
    # one read a call of the step's window, each after its issue
    assert spans["accumulate.read"][1] == spans["accumulate.window"][1] == len(reads)
    assert len(reads) >= res.accumulator.total_steps > 0
    # a step scans its window, or seeds the next cluster, or ends the pool
    steps = spans["accumulate.scan"][1] + spans.get("accumulate.seed", (0, 0))[1]
    assert steps <= res.accumulator.total_steps <= steps + 1
    assert res.accumulator.aborts == 0 and "accumulate.relaunch" not in spans
    st = rec.stamps
    covered = sum(spans[n][0] for n in STEP_SPANS if n in spans) * 1e-9
    assert covered >= 0.9 * (st["accumulate"] - st["read_in_points"])
    setup = sum(spans[n][0] for n in ("setup.read", "setup.count",
                                      "setup.session")) * 1e-9
    assert setup >= 0.9 * st["read_in_points"]
    assert spans["session.upload"][3] == spans["session.warm"][3] == "setup.session"
    assert spans["update.phase"][1] == 1 and spans["update.write"][1] == 1
    assert res.phase.last_seconds == pytest.approx(spans["update.phase"][0] * 1e-9)


def test_an_aborting_run_times_each_resolve_and_relaunch(fixtures_dir, tmp_path,
                                                         monkeypatch):
    # the abort backoff budgets its host steps by the time of a resolve and
    # of the relaunch after it: one span each, the relaunch holding the
    # relaunched launch's step spans
    monkeypatch.setenv("MC2_DD_MARGIN", "3e-3")
    res, _, rec = run_cli(fixtures_dir, tmp_path, "out.clstr", pool="med2000")
    spans = rec.spans
    assert res.accumulator.aborts > 0
    resolves, relaunches = spans["accumulate.resolve"][1], spans["accumulate.relaunch"][1]
    assert relaunches >= 1 and resolves - 1 <= relaunches <= resolves
    assert spans["accumulate.upload"][3] == "accumulate.relaunch"
    assert spans["accumulate.upload"][1] == relaunches + 1
    # self time: the relaunch's own host work around its launch
    assert 0 <= spans["accumulate.relaunch"][2] < spans["accumulate.relaunch"][0]


def test_clstr_is_the_same_under_a_profiler(fixtures_dir, tmp_path):
    _, plain, rec = run_cli(fixtures_dir, tmp_path, "plain.clstr")
    assert rec.intervals == []
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        _, traced, rec = run_cli(fixtures_dir, tmp_path, "traced.clstr")
    assert len(rec.intervals) == sum(n for _, n, _, _ in rec.spans.values())
    _, profiled, _ = run_cli(fixtures_dir, tmp_path, "profiled.clstr",
                             "--profile", str(tmp_path / "prof"))
    assert plain == traced == profiled


def test_profile_ranges_share_the_spans_clock(fixtures_dir, tmp_path):
    epoch = time.time_ns() - time.monotonic_ns()
    prof = tmp_path / "prof"
    _, _, rec = run_cli(fixtures_dir, tmp_path, "out.clstr", "--profile", str(prof))
    (path,) = glob.glob(str(prof / "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    names = {n for n, _, _, _ in rec.intervals}
    starts = {}
    for ev in trace["traceEvents"]:
        if ev.get("name") in names and ev.get("cat") == "user_annotation":
            starts.setdefault(ev["name"], []).append(base + ev["ts"] * 1e3)
    assert names == set(starts)
    for name in names:
        mine = sorted(t0 for n, _, t0, _ in rec.intervals if n == name)
        theirs = sorted(starts[name])
        assert len(mine) == len(theirs)
        off = np.abs(np.array(theirs) - (np.array(mine) + epoch))
        assert off.max() < 1e6, (name, off.max())


def test_a_harness_profile_sees_the_same_events(fixtures_dir, tmp_path,
                                                monkeypatch):
    # the benchmark's traced jobs: the spans add no event to the profiler's
    # trace, so its busy union reads the same operations
    monkeypatch.syspath_prepend(os.path.join(ROOT, "benchmark"))
    from harness.trace import Profiled

    def traced(tag):
        with Profiled("cpu") as prof:
            run_cli(fixtures_dir, tmp_path, f"{tag}.clstr")
        return prof.trace

    traced("warm")
    with_spans = traced("spans")
    assert C.FINISHED[-1].intervals
    monkeypatch.setattr(C, "_Span", lambda clock, name: C._NO_SPAN)
    without = traced("none")
    assert not C.FINISHED[-1].intervals
    assert set(with_spans.by_kernel) == set(without.by_kernel)
    assert not {n.split(".")[0] for n in with_spans.by_kernel} & {
        "setup", "session", "accumulate", "update"}


def test_update_prof_line_reads_the_spans(fixtures_dir, tmp_path, monkeypatch,
                                          capsys):
    # without the device loop the engine's update loop calls the updater
    # and prints its line: calls since its warm-up, from the spans
    monkeypatch.setenv("MC2_NO_DEVICE_LOOP", "1")
    monkeypatch.setenv("MC2_DEVICE_PROF", "1")
    _, _, rec = run_cli(fixtures_dir, tmp_path, "out.clstr")
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("device update: "))
    score, closest = (int(line.split(f"{k} ")[1].split("/")[1].split()[0])
                      for k in ("score", "closest"))
    assert closest == rec.spans["update.closest"][1] - 1 > 0
    assert score == rec.spans["update.score"][1] - 1
    assert "span update.pass " in out


def test_fastcar_seconds_are_span_totals(fixtures_dir, tmp_path):
    small = os.path.join(fixtures_dir, "small.fasta")
    res = fastcar.run(["--device", "cpu", "--recover", FASTCAR_WEIGHTS, "-q", small,
                       "-o", str(tmp_path / "fc"), small])
    assert res.rc == 0
    spans = C.FINISHED[-1].spans
    st = res.stats
    s = lambda n: spans[n][0] * 1e-9   # noqa: E731
    assert res.search_seconds == s("search")
    assert (st.pairs_seconds, st.score_seconds, st.write_seconds) == (
        s("search.pairs"), s("search.score"), s("search.write"))
    parts = ("search.load", "search.pairs", "search.score", "search.write")
    assert all(spans[n][3] == "search" for n in parts)
    assert sum(s(n) for n in parts) <= res.search_seconds
    assert {"search.upload", "search.sums"} <= set(spans)
    assert spans["search.sums"][3] == "search.score"
    # one chunk of queries and one of the database, each draw and each end
    assert spans["search.load"][1] == 4
