"""Mean host microseconds of one ``mc.observe`` span (its children
included) in the traced window: the time loop's work at a record point
(the callbacks and the copies into the chunk buffer).

A host time of the program's span on the profiler's clock (``source``
``program_span``), not a device time.  It holds the profiler's own cost
for every host operation recorded inside the span (some 6 to 7 us each
on an H100 host, half of a traced ``harmonic1d.fine`` period), and that
cost differs from machine to machine: compare two readings only from
runs on one machine."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import spans  # noqa: E402


def read(ctx):
    return spans.reading(ctx, "observe_us")
