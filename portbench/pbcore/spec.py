"""The benchmark's files, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
each metric.  A configuration is ``portbench/configs/<config>.json`` (its
``file`` entry), a traffic mix ``portbench/traffic/<traffic>.json``, a
cell's limits of the correctness check ``portbench/limits/<cell>.json``,
and a metric ``portbench/metrics/<metric>.py``, a module whose
``read(run)`` returns the metric's value, or None where the run holds
nothing for it to read.  Adding a cell, a mix or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent          # portbench/
ROOT = HERE.parent                                      # the checkout


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable
    end_to_end: bool
    workloads: Optional[List[str]] = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: List[Metric] = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def metric_reader(name: str, base: Path = HERE) -> Callable:
    path = base / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def cell(name: str, bench: Optional[dict] = None, base: Path = HERE,
         root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")["limits"]
    metrics = []
    for kind, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in bench[kind]:
            cells = m.get("workloads")
            if cells is not None and name not in cells:
                continue
            metrics.append(Metric(m["name"], m["unit"],
                                  metric_reader(m["name"], base), e2e, cells))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, metrics=metrics)


def with_traffic(c: Cell, **override) -> Cell:
    """The cell with some of its mix's parameters changed (the control)."""
    return Cell(name=c.name, chips=c.chips, config=c.config,
                traffic={**c.traffic, **override}, limits=c.limits,
                metrics=c.metrics)


def values(c: Cell, run: dict, end_to_end: bool) -> Dict[str, dict]:
    """The cell's metrics of one kind that the run holds, by name."""
    out = {}
    for m in c.metrics:
        if m.end_to_end != end_to_end:
            continue
        v = m.read(run)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out
