"""Phase wall-clock stamps, matching the reference's observability surface
(Clock.cpp:14-19): prints `timestamp <phase> <seconds-since-start>`.
Phase names are kept identical for benchmark comparability."""
from __future__ import annotations

import time


class Clock:
    def __init__(self):
        self.start = time.monotonic()
        self.stamps = {}

    def stamp(self, desc: str) -> float:
        t = time.monotonic() - self.start
        self.stamps[desc] = t
        print(f"timestamp {desc} {t:g}")
        return t
