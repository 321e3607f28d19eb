"""The points a period at which the host waits for the device (the
program's ``host_syncs`` counter: pulls to the host, reads of a latched
flag, device syncs) over the traced window's periods.

A program counter (``source`` ``program_counter``), read from
``Simulation.counters`` after the traced window, not from the trace;
nothing where that run's trace holds no span of the program."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import spans  # noqa: E402


def read(ctx):
    return spans.reading(ctx, "host_syncs_per_period")
