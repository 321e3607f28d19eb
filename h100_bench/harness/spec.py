"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, ``workloads/<cell>.json``, ``configs/<config>.json`` beside its
module ``configs/<config>.py``, ``layer_metrics/<metric>.py`` and
``counts/<kernel>.py``."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def workload(name):
    return _json("workloads", name)


def config(name):
    return _json("configs", name)


def module(kind, name):
    """The module ``<kind>/<name>.py`` under the harness (names may hold
    dots, so it is loaded from its file)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def metrics_of(bench, cell, kind):
    """The ``end_to_end`` or ``per_layer`` entries that a cell reports:
    those that list it under ``workloads``, and those without such a list
    (a per-layer metric without one: where its end-to-end metric is
    reported)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]
