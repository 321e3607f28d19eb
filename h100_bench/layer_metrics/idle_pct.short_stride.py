"""``idle_pct`` in the cells whose rate is ``moves_per_s.short_stride``:
the same reading, split so that each end-to-end metric has its own."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from harness import spec  # noqa: E402

read = spec.module("layer_metrics", "idle_pct").read
