"""Finding a cell's files by name: BENCHMARK.json at the checkout's root,
the configuration and traffic files, the traffic kind's generator and
each metric's reader under benchmark/."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def data(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json (kind: configs, traffic)."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def module(path: str, name: str):
    """A module loaded from its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    return module(os.path.join(HERE, "benchlib", "kinds", name + ".py"),
                  "bench_kind_" + name)


def metric(name: str):
    """metrics/<name>.py, or where there is none, the reader of the name's
    first part: metrics/device_idle.py reads device_idle.msm too."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    return module(path, "bench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that this
    cell reports: those with no "workloads" key and those that list it."""
    return [m for m in bench[section]
            if cell in m.get("workloads", (cell,))]
