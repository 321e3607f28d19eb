"""Schedule construction and compression.

A copy of ``montecarlo_tpu/core/schedule.py`` (numpy only; importing the
reference would pull in ``jax``).  ``build_schedule`` reproduces the three
overloads of the reference (``src/simulation.jl:95,104,113``): linear,
log-spaced, and block-pattern schedules.  :func:`compress_runs` factors a
sorted event-time list into maximal arithmetic progressions so the
orchestrator can run each as one buffered chunk.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

__all__ = ["build_schedule", "compress_runs"]


def build_schedule(steps: int, burn: int, spec):
    """Build a sorted array of event timesteps.

    - ``spec: int`` — linear ``burn:spec:steps`` plus the endpoint
      (ref ``src/simulation.jl:95``).
    - ``spec: float`` — log-spaced with base ``spec``
      (ref ``src/simulation.jl:104``).
    - ``spec: list[int]`` — repeated block pattern
      (ref ``src/simulation.jl:113``).
    """
    if isinstance(spec, bool):
        raise TypeError("spec must be int, float, or list of ints")
    if isinstance(spec, (int, np.integer)):
        sched = np.union1d(np.arange(burn, steps + 1, spec), [steps])
    elif isinstance(spec, float):
        base = spec
        if base <= 1.0:
            raise ValueError("log-spaced schedule requires base > 1")
        nmax = math.floor(math.log(steps - burn, base)) if steps > burn else -1
        pts = [burn] + [burn + int(base ** n) for n in range(nmax + 1)] + [steps]
        sched = np.unique(pts)
    elif isinstance(spec, (list, tuple, np.ndarray)):
        block = np.asarray(spec, dtype=np.int64)
        nblock = (steps - burn) // int(block[-1])
        blocks = [block + burn + m * int(block[-1]) for m in range(nblock)]
        pts = np.concatenate(blocks + [np.asarray([steps])]) if blocks else \
            np.asarray([steps])
        sched = np.unique(pts[pts <= steps])
    else:
        raise TypeError(f"unsupported schedule spec: {type(spec)}")
    return sched.astype(np.int64)


def compress_runs(times: np.ndarray) -> List[Tuple[int, int, int]]:
    """Factor sorted event times into maximal arithmetic runs.

    Returns a list of ``(start, stride, count)`` with
    ``times == concat(start + stride*arange(count) for each run)``.
    Singleton runs use ``stride=0``.
    """
    times = np.asarray(times, dtype=np.int64)
    runs: List[Tuple[int, int, int]] = []
    i, n = 0, len(times)
    while i < n:
        if i + 1 == n:
            runs.append((int(times[i]), 0, 1))
            break
        stride = int(times[i + 1] - times[i])
        j = i + 1
        while j + 1 < n and int(times[j + 1] - times[j]) == stride:
            j += 1
        count = j - i + 1
        if count == 2 and j + 1 < n:
            # Lone pair before a stride change: emit a singleton so the next
            # run can extend maximally.
            runs.append((int(times[i]), 0, 1))
            i += 1
        else:
            runs.append((int(times[i]), stride, count))
            i = j + 1
    return runs
