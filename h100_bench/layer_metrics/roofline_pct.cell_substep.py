"""The cell path's substeps' share of their roofline in the traced
window: the least time the card could take for the operations and bytes
of the window's displacement and swap attempts (``counts/cell_substep.py``,
counted from the algorithm, the attempts from the program's counters)
over the device time of the kernels launched inside the
``mc.cell.substep`` spans.  Nothing when the trace holds no such span."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import cell_spans, peaks  # noqa: E402


def read(ctx):
    seconds, substeps = cell_spans.substep_device_s(ctx)
    if seconds is None:
        return None
    wl, cfg = ctx["wl"], ctx["cfg"]
    counts = ctx["count"]("cell_substep")
    kinds = [p["move"] for p in wl["pool"]]
    att = np.asarray(ctx["counters"])[..., 1].sum(axis=0, dtype=np.int64)
    n = wl["n_particles"]
    nc = counts.grid(n, cfg["rho"], cfg["rcut"] * max(map(max, cfg["sig"])),
                     dim=cfg["dimensions"])
    ops, nbytes = counts.count(
        wl["chains"], n, nc, int(att[kinds.index("displacement")]),
        int(att[kinds.index("swap")]), substeps, cfg["dimensions"])
    return 100.0 * peaks.least_seconds(ops, nbytes) / seconds
