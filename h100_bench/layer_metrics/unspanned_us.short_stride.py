"""Host microseconds a period of the traced window outside every
top-level span of the program: the window's wall less the union of the
top-level ``mc.`` spans, over its periods (the time loop's own Python).

A host time on the profiler's clock, read from the program's spans
(``source`` ``program_span``), not a device time.  It holds the
profiler's own cost for every host operation recorded there (some 6 to
7 us each on an H100 host, half of a traced ``harmonic1d.fine``
period), and that cost differs from machine to machine: compare two
readings only from runs on one machine."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import spans  # noqa: E402


def read(ctx):
    return spans.reading(ctx, "unspanned_us")
