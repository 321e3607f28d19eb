"""Device milliseconds a segment of the kernels launched inside the cell
path's ``mc.cell.bind`` and ``mc.cell.unbind`` spans (the grid shift,
binning and packing; the particles back in their order), over the
program's ``cell_binds`` counter."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import cell_spans  # noqa: E402


def read(ctx):
    return cell_spans.bind_device_ms(ctx)
