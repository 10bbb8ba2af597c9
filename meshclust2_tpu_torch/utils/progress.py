"""Carriage-return progress bar matching the reference's rendering
(Progress.cpp:23-44, Progress.h:15-32): ``prefix [===>   ] NN %\\r`` with
bar width ``70 - (len(prefix) + 1)``, redrawn only when the integer percent
changes; ``end()`` completes the bar and prints the newline.

The reference compiles bars out with ``-DNOPROG``; here they are disabled at
runtime when stdout is not a TTY (so piped/captured output — tests, benches,
the driver — stays clean, mirroring what NOPROG builds see) or when
``MESHCLUST2_NOPROG`` is set.
"""
from __future__ import annotations

import os
import sys


def _enabled() -> bool:
    if os.environ.get("MESHCLUST2_NOPROG"):
        return False
    try:
        return sys.stdout.isatty()
    except Exception:
        return False


class Progress:
    def __init__(self, num: int, prefix: str):
        self.pmax = max(int(num), 1)
        self.pcur = 0
        self.old_prog = -1
        self.ended = False
        self.prefix = prefix
        self.bar_width = 70 - (len(prefix) + 1)
        self.on = _enabled()
        self._print()

    def _print(self) -> None:
        if not self.on:
            return
        prog = self.pcur / self.pmax
        pct = int(prog * 100)
        if self.old_prog != pct:
            pos = int(self.bar_width * prog)
            bar = "".join(
                "=" if i < pos else (">" if i == pos else " ")
                for i in range(self.bar_width)
            )
            sys.stdout.write(f"{self.prefix} [{bar}] {pct} %\r")
            sys.stdout.flush()
        self.old_prog = pct

    def set(self, num: int) -> None:
        self.pcur = num
        self._print()

    def step(self, n: int = 1) -> None:
        self.pcur += n
        self._print()

    def end(self) -> None:
        if not self.ended:
            self.pcur = self.pmax
            self._print()
            if self.on:
                sys.stdout.write("\n")
                sys.stdout.flush()
        self.ended = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
