"""What a cell or a configuration brings to the CPU tests is a file of its
own, found by name: ``small/<cell>.json`` (its small sizes and the path
the CPU drives it on) and ``faults/<config>.py`` (its timed path broken
three ways), so that a new cell needs no edit of a shared test file."""

import types

import pytest

import bench_helpers
from bench_helpers import SMALL, faults, run, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


@pytest.mark.parametrize("cell", CELLS)
def test_small_file_of_each_cell(cell):
    s = SMALL[cell]
    assert set(s) == {"overrides", "periods", "fused"}
    assert set(s["overrides"]) <= set(spec.workload(cell))
    assert s["periods"] >= 1
    # the plain versions of the row kernels, or the cell path: the CPU has
    # no kernel to launch
    assert s["fused"] in ("interpret", "cell")


@pytest.mark.parametrize("cfg", CONFIGS)
def test_faults_file_of_each_configuration(cfg):
    f = faults(cfg)
    assert set(f) == {"unchanged", "half_batch", "altered"}
    for mod, attr, make in f.values():
        assert isinstance(mod, types.ModuleType)
        assert callable(getattr(mod, attr))
        assert callable(make)
        assert callable(make(getattr(mod, attr)))


@pytest.mark.parametrize("cell", CELLS)
def test_run_small_drives_the_file_path(cell, monkeypatch):
    seen = {}
    monkeypatch.setattr(run, "run_cell", lambda *a, **kw: seen.update(kw))
    bench_helpers.run_small(cell, chains=3)
    s = SMALL[cell]
    assert seen["device"] == "cpu"
    assert seen["fused"] == s["fused"]
    assert seen["periods"] == s["periods"]
    assert seen["overrides"] == dict(s["overrides"], chains=3)

