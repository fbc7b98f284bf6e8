"""A cell of `BENCHMARK.json`, and the files its names lead to.

Everything that belongs to one configuration, one traffic mix, one
cell's limits or one per-layer metric is a file of its own, found by its
name: `configs/<config>.json` (which names its driver,
`drivers/<driver>.py`), `traffic/<traffic>.json`,
`limits/<workload>.json` and `metrics/<metric>.py` (or, where that file
is absent, the reader named by the metric's part before its first dot:
`mfu.short` reads with `metrics/mfu.py`). A cell or a metric is added
with new files and entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    limits: dict
    driver: object
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str) -> Cell:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(by_name)}")
    w = by_name[workload]
    config = _json("configs", f"{w['config']}.json")
    return Cell(
        workload=w, config=config, mix=_json("traffic", f"{w['traffic']}.json"),
        limits=_json("limits", f"{workload}.json"),
        driver=importlib.import_module(f"benchmark.drivers.{config['driver']}"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def metric_reader(name: str):
    """`read(ctx)` of `metrics/<name>.py`, or else of the file named by
    `name`'s part before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(f"no reader for metric {name!r} under benchmark/metrics/")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
