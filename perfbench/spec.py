"""``BENCHMARK.json`` and the files each of its names leads to.

A cell (an entry of ``workloads``) names a configuration, whose file is
the one ``configs`` gives it, and a traffic mix, ``traffic/<mix>.json``.
Its comparison limits are ``limits/<cell>.json``.  Each per-layer metric
is read by ``metrics/<metric>.py``, a module with ``read(run)`` (the
value, or None where the run holds nothing to read it from) and,
optionally, ``explain(run)`` (the counts behind it, printed beside it).
A later cell, mix or metric is a new file and a new entry: nothing here
names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    power_limit: str = "unknown"

    def reader(self, metric: str):
        return load_reader(metric)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "read"):
        raise ValueError(f"{path} has no read(run)")
    return mod


def cell(name: str, bench: Dict = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench or benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, config_name=w["config"],
        config=load_json(root / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
