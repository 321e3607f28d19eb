"""``harness/spans.py`` on synthetic profiler events: each span's self
time, the partition of the window into top-level spans and the Python
outside them, kernels' device time put down to the span their launch was
made in by the profiler's correlation id, and the device's idle stretches
named by the top-level span the host was in; then on a real CPU trace of
the program's spans, and ``trace_spans.py`` on a small cell on the CPU
and in a process that holds JAX."""

import json
import sys
import time
import types
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from bench_helpers import SMALL  # puts the harness on the path

import run  # noqa: E402
import trace_spans  # noqa: E402
from harness import spans  # noqa: E402

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(name, start, end, device=CPU, id=0, thread=1, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end), device_type=device, id=id, thread=thread,
        is_user_annotation=annotation)


def _window():
    """A wall of 300 us: an advance, a flush with its three parts, and an
    observe; 90 us outside every span."""
    return [
        _ev("mc.advance", 0, 40, annotation=True),
        _ev("cudaLaunchKernel", 5, 8, id=7),
        _ev("aten::copy_", 50, 60, id=9),          # an op's id, not a launch
        _ev("mc.flush", 40, 140, annotation=True),
        _ev("mc.flush.check", 50, 60, annotation=True),
        _ev("mc.flush.to_host", 60, 110, annotation=True),
        _ev("cudaMemcpyAsync", 62, 64, id=11),
        _ev("mc.flush.write", 110, 135, annotation=True),
        _ev("mc.observe", 200, 260, annotation=True),
        _ev("cudaLaunchKernel", 290, 292, id=13),   # outside every span
        # the device rows: a kernel, a copy, a kernel launched outside any
        # span, a span's shadow and a kernel whose id matches only an op
        _ev("sweep_kernel", 1000, 1004, CUDA, id=7),
        _ev("Memcpy DtoH", 1100, 1130, CUDA, id=11),
        _ev("reduce_kernel", 1200, 1210, CUDA, id=13),
        _ev("mc.flush", 1100, 1130, CUDA, id=4, annotation=True),
        _ev("copy_kernel", 1300, 1302, CUDA, id=9),
    ]


def test_self_time_is_the_span_less_its_children():
    s = spans.summarize(_window())["spans"]
    assert s["mc.flush"]["calls"] == 1
    assert s["mc.flush"]["host_s"] == pytest.approx(100e-6)
    assert s["mc.flush"]["self_s"] == pytest.approx(
        (100 - 10 - 50 - 25) * 1e-6)
    for name in ("mc.flush.check", "mc.flush.to_host", "mc.advance"):
        assert s[name]["self_s"] == pytest.approx(s[name]["host_s"])


def test_top_level_spans_and_unspanned_partition_the_wall():
    out = spans.summarize(_window())
    wall = 300e-6
    assert out["top_s"] == pytest.approx((40 + 100 + 60) * 1e-6)
    assert out["top_sum_s"] == pytest.approx(out["top_s"])
    assert out["top_s"] + (wall - out["top_s"]) == pytest.approx(wall)
    # overlapping top-level spans (not nested on one thread) count once
    # in the union and twice in the sum
    two = spans.summarize([_ev("mc.a", 0, 10), _ev("mc.b", 5, 20, thread=2)])
    assert two["top_s"] == pytest.approx(20e-6)
    assert two["top_sum_s"] == pytest.approx(25e-6)


def test_device_time_follows_the_launch_by_correlation():
    s = spans.summarize(_window())["spans"]
    assert s["mc.advance"]["device_s"] == pytest.approx(4e-6)
    # the copy counts for the part it was made in and for the flush
    assert s["mc.flush.to_host"]["device_s"] == pytest.approx(30e-6)
    assert s["mc.flush"]["device_s"] == pytest.approx(30e-6)
    for name in ("mc.flush.check", "mc.flush.write", "mc.observe"):
        assert s[name]["device_s"] == 0.0


def test_idle_gaps_are_named_by_the_top_level_span():
    events = [
        _ev("k", 0, 10, CUDA, id=1), _ev("k", 50, 60, CUDA, id=2),
        _ev("k", 95, 105, CUDA, id=3), _ev("k", 107, 109, CUDA, id=4),
        _ev("mc.advance", 5, 45),            # 35 of the 40 us gap
        _ev("mc.advance.inner", 10, 40),     # a child: never the name
        _ev("mc.observe", 55, 70),           # 10 of the next 35: unspanned
    ]
    gaps = spans.summarize(events, n_gaps=2)["idle_gaps"]
    assert [g[0] for g in gaps] == ["mc.advance", "unspanned"]
    assert [g[1] for g in gaps] == pytest.approx([40e-6, 35e-6])


def test_a_cpu_trace_of_the_program_spans():
    from montecarlo_tpu_torch.utils.observability import span
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("mc.advance"):
                torch.ones(4).sum()
            with span("mc.flush"):
                with span("mc.flush.to_host"):
                    torch.zeros(4).numpy()
    out = spans.summarize(prof.events())
    s = out["spans"]
    assert {k: v["calls"] for k, v in s.items()} == {
        "mc.advance": 3, "mc.flush": 3, "mc.flush.to_host": 3}
    assert out["top_sum_s"] == pytest.approx(
        s["mc.advance"]["host_s"] + s["mc.flush"]["host_s"])
    assert out["top_s"] == pytest.approx(out["top_sum_s"])
    assert 0 <= s["mc.flush"]["self_s"] < s["mc.flush"]["host_s"]


def test_trace_spans_reports_a_small_cell(monkeypatch, capsys):
    """The tool's line for a few periods of ``harmonic1d.fine`` on the CPU
    (the row kernel's plain version): the spans, the counters and the
    readings that the CPU can give (no device rows: no idle gaps)."""
    s = SMALL["harmonic1d.fine"]
    periods = s["periods"]
    real = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda name, seed, seconds, trace:
                        real(name, seed, seconds, trace, device="cpu",
                             fused=s["fused"], overrides=s["overrides"],
                             periods=periods, t_start=time.perf_counter()))
    assert trace_spans.main(["--workload", "harmonic1d.fine", "--seed",
                             str(2 ** 40 + 3), "--seconds", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and line["periods"] == periods
    assert line["spans"]["mc.advance"]["calls"] == periods
    assert line["counters"]["periods"] == periods
    assert line["counters"]["host_syncs"] == 3     # first record, flush, sync
    r = line["readings"]
    assert r["host_syncs_per_period"] == pytest.approx(3 / periods)
    assert r["advance_us"] > 0 and r["flush_ms"] > 0
    assert r["refresh_device_ms"] is None          # no refresh, no card
    assert 0 <= r["unspanned_us"] * periods * 1e-6 < line["wall"]
    assert line["idle_gaps"] == []


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "montecarlo_tpu.core"])
def test_trace_spans_gives_no_line_where_jax_is_loaded(name, monkeypatch,
                                                        capsys):
    """As ``run.py``: a process that holds JAX or the JAX package once the
    window has closed prints no line, exits non-zero and names it."""
    monkeypatch.setattr(run, "run_cell", lambda *a, **kw: {})
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert trace_spans.main(["--workload", "harmonic1d.fine", "--seed",
                             "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and name in out.err
