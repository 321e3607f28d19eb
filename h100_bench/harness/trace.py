"""What a ``torch.profiler`` trace of the window says: the device's busy
time (the union of its operations' intervals), kernel time by name, the
runtime's kernel launches counted on the host rows, and the longest idle
gaps named by the host operation they overlap most."""

from __future__ import annotations

import bisect

#: the prefix of the harness's own spans
SPAN = "bench."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, window_s, top=10):
    """``events``: the profiler's ``events()``.  Returns a dict with
    ``busy_s``, ``window_s``, ``launches``, ``kernels`` ({name: [count,
    seconds]}) and ``breakdown`` (``device_ops``, ``idle_gaps``: at most
    ``top`` [name, seconds] each)."""
    from torch.autograd import DeviceType
    dev, host, kernels, launches = [], [], {}, 0
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) \
                    or ev.name.startswith(SPAN):
                continue          # a span's shadow on the device's rows
            dev.append((start, end))
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += (end - start) * 1e-6
        else:
            if ev.name in LAUNCHES:
                launches += 1
            host.append((start, end, ev.name))
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for length, g0, g1 in gaps:
        # the host op that covers most of the gap; where none covers half
        # of it, the host ran Python after the last op that began before
        best, name, last = 0.0, None, "the window's start"
        hi = bisect.bisect_left(starts, g1)
        for s, e, n in host[max(0, hi - 400):hi]:
            ov = min(e, g1) - max(s, g0)
            if ov > best:
                best, name = ov, n
            last = n
        if best < 0.5 * length:
            name = f"host Python after {last}"
        idle.append([name, length * 1e-6])
    ops = sorted(([n, v[1]] for n, v in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy, window_s=window_s, launches=launches,
                kernels=kernels,
                breakdown={"device_ops": ops, "idle_gaps": idle})


def kernel_time(summary, match):
    """(launches, seconds) of the kernels whose name ``match`` accepts."""
    n = t = 0
    for name, (count, sec) in summary["kernels"].items():
        if match(name):
            n += count
            t += sec
    return n, t
