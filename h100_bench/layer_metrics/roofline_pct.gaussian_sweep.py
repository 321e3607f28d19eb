"""Kernel #1's share of its roofline in the traced window: the least time
the card could take for the operations and bytes its calls need
(``counts/gaussian_sweep.py``) over the kernel's device time by name in
the profiler's trace.  Nothing when the trace shows no such kernel."""

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import peaks  # noqa: E402
from harness.trace import kernel_time  # noqa: E402

_NAME = re.compile(r"(^|[^A-Za-z_])sweep_kernel<")


def read(ctx):
    calls, seconds = kernel_time(ctx["trace"], lambda n: bool(_NAME.search(n)))
    if not calls or seconds <= 0:
        return None
    wl = ctx["wl"]
    ops, nbytes = ctx["count"]("gaussian_sweep").count(
        wl["chains"], wl["stride"] * wl["sweepstep"])
    return 100.0 * peaks.least_seconds(ops * calls, nbytes * calls) / seconds
