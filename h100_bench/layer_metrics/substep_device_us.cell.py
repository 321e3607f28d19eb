"""Mean device microseconds of the kernels launched inside one
``mc.cell.substep`` span (matched to their launches by the profiler's
correlation id): the card's work a substep of the cell path."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import cell_spans  # noqa: E402


def read(ctx):
    return cell_spans.substep_device_us(ctx)
