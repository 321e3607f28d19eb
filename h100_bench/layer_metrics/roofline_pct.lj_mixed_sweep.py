"""Kernel #3's (``mc_lj_mixed_sweep``) share of its roofline in the
traced window: the least time the card could take for the operations and
bytes its calls need (``counts/lj_mixed_sweep.py``, with the window's
displacement and swap attempts from the program's counters) over the
kernel's device time by name in the profiler's trace.  Nothing when the
trace shows no such kernel."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import peaks  # noqa: E402
from harness.trace import kernel_time  # noqa: E402


def read(ctx):
    calls, seconds = kernel_time(ctx["trace"],
                                 lambda n: "lj_sweep_kernel<true" in n)
    if not calls or seconds <= 0:
        return None
    wl = ctx["wl"]
    kinds = [p["move"] for p in wl["pool"]]
    att = np.asarray(ctx["counters"])[..., 1].sum(axis=0, dtype=np.int64)
    m = wl["chains"]
    ops, nbytes = ctx["count"]("lj_mixed_sweep").count(
        m, wl["n_particles"], int(att[kinds.index("displacement")]),
        int(att[kinds.index("swap")]), calls,
        wl["stride"] * wl["sweepstep"], -(-m // min(256, max(8, m))))
    return 100.0 * peaks.least_seconds(ops, nbytes) / seconds
