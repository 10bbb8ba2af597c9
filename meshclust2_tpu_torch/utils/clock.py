"""A run's clock: phase stamps and spans.

Stamps match the reference's observability surface (Clock.cpp:14-19):
`stamp` prints `timestamp <phase> <seconds-since-start>`.  Phase names are
kept identical for benchmark comparability.

Spans time the host's work at the program's layer boundaries:

    with clock.span("accumulate.read"):
        got = t.tolist()

Each span records its name, its start and end on `time.monotonic_ns()`
(the clock of `Clock.start` and of the stamps), the span open when it
began (its parent) and, through the `Clock` it belongs to, the run.  A
span times the host only: it never synchronizes the card, so the host's
wait on the card is a span of its own, around the read that waits.

What a span keeps:
  - always, per span name: total ns, count, and the ns its child spans
    covered (self time = total - children), with its parent's name (the
    latest, for a name opened under several).  One to a few microseconds
    a span;
  - while a torch profiler records (`torch.autograd._profiler_enabled()`):
    each span's interval (name, parent, t0_ns, t1_ns) as well;
  - under the program's own `--profile` (`Clock(annotate=True)`): each
    span also opens `torch.profiler.record_function(name)`, so the trace
    shows the host spans above the operations they issued.  A profiler that
    the program did not start sees no such range: its trace of the card is
    the same with the spans as without them.

An entry point makes its clock the current one for the run (`with
Clock() as clock:`); deeper code reaches it through `span` and `current` and threads no argument.  With no current clock `span` is a
shared no-op.  When the run ends its `Record` goes to `FINISHED`, a deque
of the last 256 runs in this process, which is what readers outside the
program (the benchmark's metrics) read; nothing is written to disk.
Under MC2_DEVICE_PROF the run ends with one line a span name:
`span <name> <total s> <count> <self s>`.

Spans are opened on the thread that runs the entry point.
"""
from __future__ import annotations

import itertools
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from torch.autograd import _profiler_enabled

_now = time.monotonic_ns
_RUN_IDS = itertools.count(1)
_CURRENT: Optional["Clock"] = None


@dataclass
class Record:
    """What a finished run's clock kept."""
    run: int                     # the clock's run id, one a Clock in the process
    start_ns: int                # time.monotonic_ns() at the clock's start
    end_ns: int                  # and when the run ended
    stamps: Dict[str, float]     # phase -> seconds since the start
    spans: Dict[str, Tuple[int, int, int, Optional[str]]]  # name -> (total ns,
    #                              count, self ns, parent name)
    intervals: List[Tuple[str, Optional[str], int, int]]   # (name, parent,
    #                              t0 ns, t1 ns), only while a profiler recorded


# the records of the last runs, oldest first
FINISHED: Deque[Record] = deque(maxlen=256)


class _Span:
    """One span of `clock`: a context manager; `ns` holds its length after
    it closes."""
    __slots__ = ("clock", "name", "agg", "up", "t0", "ns", "kept", "rf")

    def __init__(self, clock: "Clock", name: str):
        self.clock = clock
        self.name = name
        self.ns = 0

    def __enter__(self):
        c = self.clock
        up = self.up = c._open
        agg = self.agg = c._spans.get(self.name)
        if agg is None:
            # total ns, count, children's ns, parent
            agg = self.agg = c._spans[self.name] = [0, 0, 0, None]
        agg[3] = up and up.name
        c._open = self
        self.rf = None
        self.kept = _profiler_enabled()
        if self.kept and c.annotate:
            from torch.profiler import record_function

            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        ns = self.ns = t1 - self.t0
        agg = self.agg
        agg[0] += ns
        agg[1] += 1
        up = self.up
        c = self.clock
        c._open = up
        if up is not None:
            up.agg[2] += ns
        if self.kept:
            c.intervals.append((self.name, up and up.name, self.t0, t1))
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
        return False

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9


class _NoSpan:
    """The span where no clock is current: it keeps nothing."""
    __slots__ = ()
    ns = 0
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Clock:
    """One run's stamps and spans; the current clock inside
    `with`, whose end closes the run (`done`)."""

    def __init__(self, annotate: bool = False):
        self.start_ns = _now()
        self.start = self.start_ns * 1e-9     # time.monotonic()'s seconds
        self.stamps: Dict[str, float] = {}
        self.run = next(_RUN_IDS)
        self.annotate = annotate
        self.intervals: List[Tuple[str, Optional[str], int, int]] = []
        self._spans: Dict[str, list] = {}
        self._open: Optional[_Span] = None
        self._prev: Optional[Clock] = None

    def stamp(self, desc: str) -> float:
        t = time.monotonic() - self.start
        self.stamps[desc] = t
        print(f"timestamp {desc} {t:g}")
        return t

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def seconds(self, name: str) -> float:
        """The total of span `name` so far (0 where it never closed)."""
        agg = self._spans.get(name)
        return agg[0] * 1e-9 if agg else 0.0

    def calls(self, name: str) -> int:
        """How often span `name` closed so far."""
        agg = self._spans.get(name)
        return agg[1] if agg else 0

    def spans(self) -> Dict[str, Tuple[int, int, int, Optional[str]]]:
        """name -> (total ns, count, self ns, parent name)."""
        return {k: (a[0], a[1], a[0] - a[2], a[3]) for k, a in self._spans.items()}

    def __enter__(self) -> "Clock":
        global _CURRENT
        self._prev, _CURRENT = _CURRENT, self
        return self

    def __exit__(self, *exc):
        global _CURRENT
        _CURRENT = self._prev
        self.done()
        return False

    def done(self) -> Record:
        """The run's record, appended to FINISHED (and, under
        MC2_DEVICE_PROF, printed a line a span)."""
        rec = Record(self.run, self.start_ns, _now(), dict(self.stamps),
                     self.spans(), self.intervals)
        FINISHED.append(rec)
        if os.environ.get("MC2_DEVICE_PROF"):
            for name, (total, n, own, _) in rec.spans.items():
                print(f"span {name} {total * 1e-9:.6f} {n} {own * 1e-9:.6f}")
        return rec


def prepare_ranges() -> None:
    """Set up torch's profiler ranges before a profiler starts (the range
    opened here is recorded by none): a process's first range costs ~1 ms,
    which would otherwise lie between a span's first range and its start."""
    from torch.profiler import record_function

    with record_function("clock"):
        pass


def current() -> Optional[Clock]:
    """The clock of the run in progress, or None."""
    return _CURRENT


def span(name: str):
    """A span of the current clock; a no-op without one."""
    c = _CURRENT
    return _NO_SPAN if c is None else _Span(c, name)


def timed(name: str) -> _Span:
    """A span whose `ns` is read afterwards: of the current clock, or of a
    clock of its own (kept nowhere) without one."""
    return _Span(_CURRENT or Clock(), name)
