"""The benchmark's files find each other by name, and BENCHMARK.json keeps
to the shapes its readers expect."""

import json
import os
import re

import pytest

from bench_helpers import HERE, ROOT, small_path, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_workload_names_an_existing_configuration(cell):
    entry = spec.cell_entry(BENCH, cell)
    wl = spec.workload(cell)
    assert wl["config"] == entry["config"]
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    cfg = spec.config(wl["config"])
    assert cfg["name"] == wl["config"]
    assert entry["chips"] == 1
    assert entry["traffic"] == cell[len(entry["config"]) + 1:]
    assert wl["path"] in ("row", "cell", "generic")
    assert wl["periods_per_s"] > 0
    if wl["path"] == "row":
        assert os.path.exists(os.path.join(HERE, "counts",
                                           wl["kernel"] + ".py"))
    else:
        assert wl["kernel"] is None


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    path = os.path.join(ROOT, cfg["file"])
    with open(path) as f:
        data = json.load(f)
    assert data["reduced"] == cfg["reduced"]
    assert data["source"].split()[0] in cfg["source"]
    for suffix in (".py", "_reference.py"):
        assert os.path.exists(os.path.join(HERE, "configs",
                                           cfg["name"] + suffix))
    assert "move" in data and "precision" in data


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric["workloads"]) <= set(CELLS)
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    mod = spec.module("layer_metrics", metric["name"])
    assert callable(mod.read)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, "per_layer")
    assert os.path.exists(small_path(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_every_number_has_a_limit(cell):
    limits = spec.workload(cell)["limits"]
    result = __import__("bench_helpers").run_small(cell)
    assert set(result["checks"]) == set(limits)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_module_defines_its_sampler(cfg):
    # what one move is, the sampler's algorithm entries and the path check
    # belong to the configuration, so the harness needs no edit for a new
    # sampler
    mod = spec.module("configs", cfg["name"])
    for name in ("make", "kernel", "algorithms", "counters", "moves", "path",
                 "replay", "outputs", "control_outputs", "compare"):
        assert callable(getattr(mod, name)), name
    assert mod.STATE_LEAVES
