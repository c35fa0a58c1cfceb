"""BENCHMARK.json and the files it names, found by name: a cell's file
workloads/<cell>.json, its configuration's configs/<config>.json, each
per-layer metric's reader metrics/<metric>.py."""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(name: str, bench: dict) -> dict:
    """The cell `name`: its BENCHMARK.json entry and its own file, merged,
    with the configuration's file under "config"."""
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as fh:
        spec = json.load(fh)
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(os.path.join(ROOT, conf["file"])) as fh:
        config = json.load(fh)
    return {**entry, **spec, "config": config}


def metrics_for(name: str, bench: dict, trace: bool) -> list:
    """The metric entries a run of cell `name` reports."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    return importlib.import_module(f"ldbench.metrics.{metric}").read
