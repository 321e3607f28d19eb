"""What a traced run says of the cell path's layer: the program's spans
``mc.cell.bind``, ``mc.cell.substep`` and ``mc.cell.unbind`` and its
counters ``cell_binds`` and ``cell_substeps`` (``ops/cell_mc.py``).  Each
reading is None where the trace or the program has none of them."""

from __future__ import annotations


def _span(ctx, name):
    summary = ctx.get("spans") or {}
    return (summary.get("spans") or {}).get(name)


def _counter(ctx, name):
    return (ctx.get("program_counters") or {}).get(name) or None


def substep_us(ctx):
    """Mean host microseconds of one ``mc.cell.substep`` span."""
    s = _span(ctx, "mc.cell.substep")
    return s["host_s"] / s["calls"] * 1e6 if s and s["calls"] else None


def substep_device_us(ctx):
    """Mean device microseconds of the kernels launched inside one
    ``mc.cell.substep``."""
    s = _span(ctx, "mc.cell.substep")
    if not s or not s["calls"] or s["device_s"] <= 0:
        return None
    return s["device_s"] / s["calls"] * 1e6


def launches_per_substep(ctx):
    """The window's kernel launch calls over its ``cell_substeps``."""
    n, sub = ctx["trace"]["launches"], _counter(ctx, "cell_substeps")
    return n / sub if n and sub else None


def bind_device_ms(ctx):
    """Device milliseconds a segment of the kernels launched inside
    ``mc.cell.bind`` and ``mc.cell.unbind``, over the ``cell_binds``
    counter's segments."""
    b, u = _span(ctx, "mc.cell.bind"), _span(ctx, "mc.cell.unbind")
    segments = _counter(ctx, "cell_binds")
    if not b or not u or not segments:
        return None
    device = b["device_s"] + u["device_s"]
    return device / segments * 1e3 if device > 0 else None


def substep_device_s(ctx):
    """Device seconds of the kernels launched inside every
    ``mc.cell.substep`` of the window, and the ``cell_substeps``
    counter."""
    s = _span(ctx, "mc.cell.substep")
    sub = _counter(ctx, "cell_substeps")
    if not s or s["device_s"] <= 0 or not sub:
        return None, None
    return s["device_s"], sub
