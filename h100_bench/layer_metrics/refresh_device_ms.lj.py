"""Mean device milliseconds of the kernels launched inside one
``mc.refresh`` span (the LJ cache refresh at a record point), matched to
their launches by the profiler's correlation id; nothing on the CPU."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import spans  # noqa: E402


def read(ctx):
    return spans.reading(ctx, "refresh_device_ms")
