"""Mean host microseconds of one ``mc.cell.substep`` span in the traced
window: the host's work to put one substep of the cell path on the card.

A host time of the program's span on the profiler's clock (``source``
``program_span``), with the profiler's own cost for every host operation
recorded inside it: compare two readings only from runs on one machine."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import cell_spans  # noqa: E402


def read(ctx):
    return cell_spans.substep_us(ctx)
