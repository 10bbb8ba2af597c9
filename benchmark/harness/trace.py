"""The traced run's instruments: torch.profiler over a fixed number of whole
jobs, and the arguments of the kernel launches the rooflines read.

The launches are recorded by wrapping the port's wrappers
(`ops.pair_stats.pair_stats_decision`, `ops.window_absorb.window_step`) in
every module of the port that holds them, for the traced jobs only.  A
wrapper call keeps its sizes and a device copy of what the bound needs
later (the pair indices, for the rows they touch once; the step's trip,
for its positives): one small copy on the card a launch, the cost of the
instrument.  The profiler keeps the card's activity alone (kernels, copies,
fills); the trace is reduced to the busy union, the time by kernel and the
idle gaps, and dropped.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_WRAPPED = {
    "meshclust2_tpu_torch.ops.pair_stats": "pair_stats_decision",
    "meshclust2_tpu_torch.ops.window_absorb": "window_step",
}


@dataclass
class Launches:
    """Per wrapped function, one dict of sizes a launch."""
    calls: Dict[str, List[dict]] = field(default_factory=lambda: defaultdict(list))

    def finish(self) -> None:
        """Turn the device copies into numbers (after the traced jobs)."""
        import torch

        for rec in self.calls["pair_stats_decision"]:
            a, b = rec.pop("a"), rec.pop("b")
            rec["rows"] = int(torch.unique(torch.cat([a, b])).numel())
        for rec in self.calls["window_step"]:
            rec["npos"] = int(rec.pop("trip")[1])


def _record_decision(log: Launches, fn):
    def wrapper(store, params, a_idx, b_idx, plane=None):
        out = fn(store, params, a_idx, b_idx, plane)
        c = store.counts
        log.calls["pair_stats_decision"].append(dict(
            d=c.shape[1], elem=c.element_size(), p=len(a_idx), nb=len(b_idx),
            singles=tuple(params.singles), combos=len(params.combos),
            plane=plane is not None, a=a_idx.clone(), b=b_idx.clone()))
        return out
    return wrapper


def _record_step(log: Launches, fn):
    def wrapper(store, order, cand, *args, **kw):
        trip = fn(store, order, cand, *args, **kw)
        c = store.counts
        log.calls["window_step"].append(dict(
            w=len(cand), mcnt=int(kw["mcnt"]), d=c.shape[1],
            elem=c.element_size(), trip=trip.clone()))
        return trip
    return wrapper


class Patched:
    """Inside the context, every module of the port that holds one of the
    named functions holds `makers[name](original)` instead; a module that
    imports it inside the context gets the wrapper, and loses it on exit."""

    def __init__(self, makers: Dict[str, object]):
        self.makers = makers
        self.swaps: List[Tuple[str, object, object]] = []

    @staticmethod
    def _swap(fn_name: str, old, new) -> None:
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] == "meshclust2_tpu_torch" and \
                    getattr(mod, fn_name, None) is old:
                setattr(mod, fn_name, new)

    def __enter__(self):
        import importlib

        # the entry points import every module that calls the wrappers
        for entry in ("meshclust2_tpu_torch.cli", "meshclust2_tpu_torch.fastcar"):
            importlib.import_module(entry)
        for mod_name, fn_name in _WRAPPED.items():
            if fn_name not in self.makers:
                continue
            orig = getattr(importlib.import_module(mod_name), fn_name)
            wrapper = self.makers[fn_name](orig)
            wrapper.__dict__.update(orig.__dict__)   # the launch counters
            self._swap(fn_name, orig, wrapper)
            self.swaps.append((fn_name, orig, wrapper))
        return self

    def __exit__(self, *exc):
        for fn_name, orig, wrapper in reversed(self.swaps):
            self._swap(fn_name, wrapper, orig)
        return False


def recorded(log: Launches) -> Patched:
    """The launch recorder of the traced jobs."""
    return Patched({"pair_stats_decision": lambda fn: _record_decision(log, fn),
                    "window_step": lambda fn: _record_step(log, fn)})


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters; a copy's or a fill's first two words."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    base = "".join(out)
    if base.endswith(")"):      # the parameter list: its balanced group
        depth = 0
        for i in range(len(base) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(base[i], 0)
            if depth == 0:
                base = base[:i]
                break
    return base.removeprefix("void ").split("::")[-1].strip()


@dataclass
class DeviceTrace:
    window_s: float                       # host wall time of the traced jobs
    busy_s: float                         # union of the card's activity
    by_kernel: Dict[str, float]           # device seconds by short name
    gaps: List[Tuple[float, float, str]]  # (start, end, next op) in epoch s


def reduce_events(events, window_s: float, kind: str = "CUDA") -> DeviceTrace:
    """The device's intervals from the profiler's events (those of device
    type `kind`): their union, the time by name, the gaps between the
    union's pieces."""
    spans = []
    by_kernel: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.device_type().name != kind or e.duration_ns() <= 0:
            continue
        name = short_name(e.name())
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        by_kernel[name] += e.duration_ns() * 1e-9
    spans.sort()
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for s, e, name in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e * 1e-9, s * 1e-9, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return DeviceTrace(window_s, busy * 1e-9, dict(by_kernel), gaps)


class Profiled:
    """torch.profiler over the card's activity (on the CPU, where the tests
    rehearse it, over the host's operations); `trace` after the context."""

    def __init__(self, device: str):
        self.kind = "CUDA" if device == "cuda" else "CPU"
        self.trace = None

    def __enter__(self):
        import torch.profiler as tp

        self.prof = tp.profile(activities=[getattr(tp.ProfilerActivity, self.kind)])
        self.prof.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        import torch

        if self.kind == "CUDA":
            torch.cuda.synchronize()
        window = time.monotonic() - self.t0
        self.prof.__exit__(*exc)
        self.trace = reduce_events(self.prof.profiler.kineto_results.events(),
                                   window, self.kind)
        del self.prof
        return False
