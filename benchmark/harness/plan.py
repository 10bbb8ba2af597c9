"""What one run of a cell does, read from BENCHMARK.json and the files it
names: the cell's configuration (`configs/<name>.json`), its traffic mix
(`traffic/<name>.json`) and the reader of each metric it reports
(`metrics/<name>.py`).  A cell, a mix or a metric is added by adding its
file and its entry; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable      # read(run) -> float or None


@dataclass
class Plan:
    root: str
    cell: dict
    config: dict        # the configuration's file, with "file" its path
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def path(self, rel: str) -> str:
        """A path of the configuration's own files, relative to its file."""
        return os.path.join(os.path.dirname(self.config["file"]), rel)


def _reader(root: str, name: str) -> Callable:
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str, e2e: Dict[str, dict]) -> bool:
    """A metric with `workloads` reports in those cells; one without, in
    every cell that reports the end-to-end metric it moves (or every cell,
    for an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = e2e.get(metric.get("moves", ""))
    return moved is None or "workloads" not in moved or cell in moved["workloads"]


# a configuration's keys that its weights file's header states
_HEADER = {"k": ("k", int), "id": ("ID", float), "datatype": ("Datatype", str)}


def weights_header(path: str) -> Dict[str, str]:
    """The `key: value` lines at the head of a weights file."""
    head = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                break
            key, value = line.split(":", 1)
            head[key.strip()] = value.strip()
    return head


def _agrees(config: dict, weights: str) -> None:
    """Each of k, id and datatype that the configuration states is what
    its weights file states: the program takes them from the file."""
    head = weights_header(weights)
    for key, (field, kind) in _HEADER.items():
        if key in config and kind(head.get(field, "nan")) != config[key]:
            raise SystemExit(f"{config['file']}: {key} {config[key]!r}, but "
                             f"{weights} states {field}: {head.get(field)}")


def load(workload: str, root: str = ROOT) -> Plan:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf_file = os.path.join(root, conf_entry["file"])
    with open(conf_file) as f:
        config = json.load(f)
    config["file"] = conf_file
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    pick = lambda ms: [Metric(m["name"], m["unit"], _reader(root, m["name"]))  # noqa: E731
                       for m in ms if _reports(m, workload, e2e)]
    plan = Plan(root, cell, config, traffic, pick(bench["end_to_end"]),
                pick(bench["per_layer"]))
    _agrees(config, plan.path(config["weights"]))
    return plan
