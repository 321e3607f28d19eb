"""Kernel launches per cell-path substep in the traced window: the
runtime's launch calls on the profiler's host rows over the program's
``cell_substeps`` counter."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import cell_spans  # noqa: E402


def read(ctx):
    return cell_spans.launches_per_substep(ctx)
