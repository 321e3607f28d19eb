"""What the program's own spans say in a ``torch.profiler`` trace: for each
span name (``mc.<layer>``, ``utils/observability.py: span``) its calls,
host seconds, self host seconds (less its child spans) and the device
seconds of the kernels launched inside it; and the host seconds the
top-level spans cover, so that the window's wall less them is the time
loop's Python outside every layer."""

from __future__ import annotations

import bisect

from .trace import _merge

#: the prefix of the program's spans
PREFIX = "mc."
#: host runtime calls that put work on the card, matched to it by the
#: profiler's correlation id (the device row's ``id`` is the call's)
RUNTIME = ("cuda", "cu")


def _nest(items):
    """Sweep ``items`` (dicts with ``start``, ``end``, ``thread``; spans
    with ``span`` true) in time order on each thread; sets each item's
    ``parent``: the index of the innermost span enclosing it, or None."""
    order = sorted(range(len(items)),
                   key=lambda i: (items[i]["thread"], items[i]["start"],
                                  not items[i]["span"], -items[i]["end"]))
    stack, thread = [], None
    for i in order:
        it = items[i]
        if it["thread"] != thread:
            stack, thread = [], it["thread"]
        while stack and items[stack[-1]]["end"] <= it["start"]:
            stack.pop()
        it["parent"] = stack[-1] if stack else None
        if it["span"]:
            stack.append(i)


def summarize(events, prefix=PREFIX, n_gaps=10):
    """``events``: the profiler's ``events()`` (or objects with ``name``,
    ``time_range.start``/``.end`` in microseconds, ``device_type``,
    ``thread``, ``id`` and ``is_user_annotation``).  Returns ``spans``
    ({name: {calls, host_s, self_s, device_s}}), ``top_s`` (the host
    seconds the top-level spans cover, their union) and ``top_sum_s``
    (their durations' sum: equal to ``top_s`` when none overlaps) and
    ``idle_gaps``: the ``n_gaps`` longest idle stretches of the device,
    each named by the top-level span the host was in (:func:`_name_gaps`),
    where ``trace.summarize`` names them by the host operation that
    covers most of them among the last few hundred."""
    from torch.autograd import DeviceType
    items, runtime, device, device_rows = [], {}, [], []
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.id, (end - start) * 1e-6))
                device_rows.append((start, end))
        elif ev.name.startswith(prefix):
            items.append(dict(name=ev.name, start=start, end=end,
                              thread=ev.thread, span=True))
        elif ev.name.startswith(RUNTIME):
            runtime[ev.id] = len(items)
            items.append(dict(name=ev.name, start=start, end=start,
                              thread=ev.thread, span=False))
    _nest(items)
    spans = {it["name"]: dict(calls=0, host_s=0.0, self_s=0.0, device_s=0.0)
             for it in items if it["span"]}
    for it in items:
        if it["span"]:
            d = (it["end"] - it["start"]) * 1e-6
            s = spans[it["name"]]
            s["calls"] += 1
            s["host_s"] += d
            s["self_s"] += d
            if it["parent"] is not None:
                spans[items[it["parent"]]["name"]]["self_s"] -= d
    for corr, seconds in device:
        i = runtime.get(corr)
        p = None if i is None else items[i]["parent"]
        seen = set()
        while p is not None:
            name = items[p]["name"]
            if name not in seen:        # a name's kernel counted once
                spans[name]["device_s"] += seconds
                seen.add(name)
            p = items[p]["parent"]
    top = sorted((it["start"], it["end"], it["name"]) for it in items
                 if it["span"] and it["parent"] is None)
    union, last = 0.0, float("-inf")
    for s, e, _ in top:
        if e > last:
            union += e - max(s, last)
            last = e
    return dict(spans=spans, top_s=union * 1e-6,
                top_sum_s=sum(e - s for s, e, _ in top) * 1e-6,
                idle_gaps=_name_gaps(device_rows, top, n_gaps))


def _name_gaps(device_rows, top, n):
    """The ``n`` longest stretches between the device's operations, each
    named by the top-level span that covers most of it (``unspanned``
    where none covers half of it): [name, seconds]."""
    merged = _merge(device_rows)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:n]
    starts = [t[0] for t in top]
    out = []
    for length, g0, g1 in gaps:
        best, name = 0.0, "unspanned"
        # top-level spans do not nest: those that overlap the gap are the
        # one that starts before it and those that start inside it
        for s, e, span in top[max(0, bisect.bisect_right(starts, g0) - 1):
                              bisect.bisect_left(starts, g1)]:
            ov = min(e, g1) - max(s, g0)
            if ov > best:
                best, name = ov, span
        out.append([name if best >= 0.5 * length else "unspanned",
                    length * 1e-6])
    return out


def readings(summary, counters, periods, window_s):
    """The per-period readings of one traced window: ``advance_us``,
    ``observe_us`` and ``flush_ms`` (a span's mean host time, children
    included), ``refresh_device_ms`` (the mean device time of the kernels
    launched inside an ``mc.refresh``), ``unspanned_us`` (the window's wall
    less the top-level spans, a period) and ``host_syncs_per_period`` (the
    program's counter).  None where the trace or the program has nothing
    to read."""
    s = summary["spans"]

    def mean(name, key, scale):
        v = s.get(name)
        return v[key] / v["calls"] * scale if v and v[key] > 0 else None

    syncs = (counters or {}).get("host_syncs")
    return dict(
        advance_us=mean("mc.advance", "host_s", 1e6),
        observe_us=mean("mc.observe", "host_s", 1e6),
        flush_ms=mean("mc.flush", "host_s", 1e3),
        refresh_device_ms=mean("mc.refresh", "device_s", 1e3),
        unspanned_us=((window_s - summary["top_s"]) / periods * 1e6
                      if s else None),
        host_syncs_per_period=None if syncs is None else syncs / periods)


def reading(ctx, key):
    """One key of :func:`readings` for a per-layer metric's reader, from
    the traced run's ``ctx`` (``spans``: :func:`summarize` of its events,
    ``program_counters``: the program's ``Simulation.counters`` as a
    dict): None where the trace holds no span of the program or the
    program keeps no counters, as a program from before them."""
    summary, counters = ctx.get("spans"), ctx.get("program_counters")
    if not summary or not summary["spans"] or counters is None:
        return None
    return readings(summary, counters, ctx["periods"],
                    ctx["trace"]["window_s"])[key]
