"""The per-layer metrics that read the program's spans and counters
(``harness/spans.py: reading``): each returns its key of
``spans.readings``, nothing where the traced run holds no span of the
program or no counters (a program from before them), and a traced run of
each cell on the CPU hands them both."""

from types import SimpleNamespace

import pytest

from bench_helpers import SMALL, run_small, spec
from harness import spans

#: the readers of ``spans.readings``: each metric's key is its name up to
#: the first dot
METRICS = ["advance_us.short_stride", "observe_us.short_stride",
           "flush_ms.short_stride", "unspanned_us.short_stride",
           "refresh_device_ms.lj", "host_syncs_per_period"]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _span(calls, host_s, device_s=0.0):
    return dict(calls=calls, host_s=host_s, self_s=host_s,
                device_s=device_s)


def _ctx():
    """Four periods in a window of 2 ms: 1.6 ms of it in top-level spans."""
    summary = dict(spans={
        "mc.advance": _span(4, 400e-6, 40e-6),
        "mc.observe": _span(4, 800e-6),
        "mc.flush": _span(1, 300e-6),
        "mc.flush.write": _span(1, 250e-6),
        "mc.refresh": _span(4, 100e-6, 360e-6)},
        top_s=1.6e-3, top_sum_s=1.6e-3, idle_gaps=[])
    return dict(spans=summary, periods=4, trace=dict(window_s=2e-3),
                program_counters=dict(periods=4, host_syncs=6))


#: the readings of :func:`_ctx`, by hand
HAND = dict(advance_us=100.0, observe_us=200.0, flush_ms=0.3,
            unspanned_us=100.0, refresh_device_ms=0.09,
            host_syncs_per_period=1.5)


def _read(name, ctx):
    return spec.module("layer_metrics", name).read(ctx)


@pytest.mark.parametrize("name", METRICS)
def test_reader_returns_its_reading(name):
    key = name.split(".")[0]
    ctx = _ctx()
    want = spans.readings(ctx["spans"], ctx["program_counters"], 4, 2e-3)
    assert _read(name, ctx) == want[key]
    assert _read(name, ctx) == pytest.approx(HAND[key])


@pytest.mark.parametrize("name", METRICS)
def test_reader_returns_nothing_without_spans_or_counters(name):
    for ctx in (dict(_ctx(), spans=dict(_ctx()["spans"], spans={})),
                dict(_ctx(), spans={}),
                dict(_ctx(), program_counters=None)):
        assert _read(name, ctx) is None


def test_reader_returns_nothing_for_a_missing_span():
    ctx = _ctx()
    del ctx["spans"]["spans"]["mc.refresh"]
    assert _read("refresh_device_ms.lj", ctx) is None
    assert _read("advance_us.short_stride", ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_hands_the_readers_spans_and_counters(cell,
                                                             monkeypatch):
    real, seen = spec.module, []

    def module(kind, name):
        mod = real(kind, name)
        if kind != "layer_metrics":
            return mod

        def read(ctx):
            seen.append(ctx)
            return mod.read(ctx)
        return SimpleNamespace(read=read)

    monkeypatch.setattr(spec, "module", module)
    r = run_small(cell, trace=1)
    periods = SMALL[cell]["periods"]
    assert seen
    ctx = seen[0]
    assert ctx["spans"]["spans"]["mc.advance"]["calls"] == periods
    assert ctx["program_counters"]["periods"] == periods
    got = spans.readings(ctx["spans"], ctx["program_counters"], periods,
                         ctx["trace"]["window_s"])
    # the host's readings come back; the device's are the card's alone
    for key in ("advance_us", "observe_us", "flush_ms", "unspanned_us",
                "host_syncs_per_period"):
        assert got[key] is not None and got[key] >= 0, key
    assert got["refresh_device_ms"] is None
    names = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell,
                                                "per_layer")}
    for name in names & set(METRICS):
        key = name.split(".")[0]
        if key == "refresh_device_ms":
            assert name not in r["metrics"]
        else:
            assert r["metrics"][name]["value"] == got[key]
    assert r["program"]["counters"] == ctx["program_counters"]
