"""The cell path's operation and byte counts (``counts/cell_substep.py``)
by hand at small shapes, and the readers of its layer
(``harness/cell_spans.py``) on a synthetic trace: each reading by hand,
nothing where the program has no such span or counter."""

import numpy as np
import pytest

from bench_helpers import spec
from harness import peaks

C = spec.module("counts", "cell_substep")
CELL = "ka2d_large.n32768.cell"


def test_stream_terms():
    # parity word 2, key adds 2, 20 rounds of 3, 5 injections of 3
    assert C.BLOCK == 79
    # xor, shift/or/subtract, the fused scale (2) and max
    assert C.UNIFORM == 79 + 1 + 3 + 3
    # x * -x, log1p, negation, compare, two of the branch, 8 FMAs, p * x,
    # sqrt(2) *
    assert C.NORMAL == 86 + 1 + 1 + 1 + 1 + 2 + 16 + 1 + 1


def test_pair_terms():
    assert C.GEOMETRY == 10 and C.ENERGY == 12 and C.PAIR == 22


def test_grid():
    assert C.grid(512, 1.2, 2.5) == 6
    assert C.grid(32768, 1.2, 2.5) == 48


def test_substeps_by_hand():
    # N 64 in a 4 x 4 grid: 36 expected occupants of a 3 x 3 neighbourhood,
    # 4 of one cell
    occ = 36
    assert C.disp_ops(occ) == 4 * 88 + 327 + 2 * 36 * 22
    assert C.DISP_SCALAR == 2 * 110 + 86 + 1 + 4 + 8 + 1 + 1 + 1 + 2 + 1 + 2
    assert C.swap_ops(occ) == 2 * 4 * 88 + 97 + 36 * (2 * 10 + 4 * 12)
    ops, nbytes = C.count(chains=2, n=64, nc=4, disp=10, swap=3, substeps=5)
    assert ops == 10 * 2263 + 3 * 3249 + 5 * (2 * 316 + 399) == 37532
    # every particle's x, y and label read, the 4 active cells' written
    assert nbytes == 5 * 2 * 12 * (64 + 4)


def _span(calls, host_s, device_s):
    return dict(calls=calls, host_s=host_s, self_s=host_s,
                device_s=device_s)


def _ctx():
    wl, cfg = spec.workload(CELL), spec.config("ka2d_large")
    counters = np.zeros((wl["chains"], 2, 2), np.int64)
    counters[:, 0, 1] = 4000
    counters[:, 1, 1] = 1000
    return dict(
        spans=dict(spans={
            "mc.cell.substep": _span(100, 0.5, 0.1),
            "mc.cell.bind": _span(4, 0.01, 0.002),
            "mc.cell.unbind": _span(4, 0.004, 0.0008)},
            top_s=0.9, top_sum_s=0.9, idle_gaps=[]),
        program_counters=dict(cell_substeps=100, cell_binds=4, periods=4),
        trace=dict(launches=19000, window_s=1.0), wl=wl, cfg=cfg,
        counters=counters, periods=4,
        count=lambda k: spec.module("counts", k))


def _read(name, ctx):
    return spec.module("layer_metrics", name).read(ctx)


def test_readers_by_hand():
    ctx = _ctx()
    assert _read("substep_us.cell", ctx) == pytest.approx(5000.0)
    assert _read("substep_device_us.cell", ctx) == pytest.approx(1000.0)
    assert _read("launches_per_substep.cell", ctx) == pytest.approx(190.0)
    assert _read("bind_device_ms.cell", ctx) == pytest.approx(0.7)
    ops, nbytes = C.count(32, 32768, 48, 32 * 4000, 32 * 1000, 100)
    assert _read("roofline_pct.cell_substep", ctx) == pytest.approx(
        100.0 * peaks.least_seconds(ops, nbytes) / 0.1)


#: each reader and what it reads: the program's spans, its counters
NEEDS = {"substep_us.cell": {"spans"},
         "substep_device_us.cell": {"spans"},
         "launches_per_substep.cell": {"counters"},
         "bind_device_ms.cell": {"spans", "counters"},
         "roofline_pct.cell_substep": {"spans", "counters"}}
NAMES = list(NEEDS)


@pytest.mark.parametrize("name", NAMES)
def test_readers_return_nothing_without_what_they_read(name):
    without = {"spans": [dict(_ctx(), spans={}),
                         dict(_ctx(), spans=dict(_ctx()["spans"],
                                                 spans={}))],
               "counters": [dict(_ctx(), program_counters=None),
                            dict(_ctx(), program_counters={})]}
    for need in ("spans", "counters"):
        for ctx in without[need]:
            got = _read(name, ctx)
            assert (got is None) == (need in NEEDS[name]), (need, got)


def test_bind_reading_needs_the_bind_spans_and_counter():
    """A program from before the bind spans (it has the substep span and
    its counter): the bind reading is nothing, the substep's are there."""
    ctx = _ctx()
    for k in ("mc.cell.bind", "mc.cell.unbind"):
        del ctx["spans"]["spans"][k]
    del ctx["program_counters"]["cell_binds"]
    assert _read("bind_device_ms.cell", ctx) is None
    assert _read("substep_device_us.cell", ctx) == pytest.approx(1000.0)


def test_cpu_trace_has_no_device_readings():
    ctx = _ctx()
    for s in ctx["spans"]["spans"].values():
        s["device_s"] = 0.0
    ctx["trace"]["launches"] = 0
    for name in NAMES[1:]:
        assert _read(name, ctx) is None
