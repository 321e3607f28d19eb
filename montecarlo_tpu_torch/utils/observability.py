"""Observability: device sync and the throughput meter.

Port of ``montecarlo_tpu/utils/observability.py``.  ``ProfilerTrace`` is
not yet ported.
"""

from __future__ import annotations

import os
import time

import torch

from ..core.algorithms import HostAlgorithm
from .tree import tree_leaves

__all__ = ["device_sync", "Throughput"]


def device_sync(tree):
    """Block until the work producing ``tree``'s tensors has executed: a
    ``torch.cuda.synchronize`` of each CUDA device holding one of them."""
    for dev in {leaf.device for leaf in tree_leaves(tree)
                if torch.is_tensor(leaf) and leaf.is_cuda}:
        torch.cuda.synchronize(dev)


class Throughput(HostAlgorithm):
    """Writes ``throughput.dat`` lines ``t steps_per_sec`` measured between
    its scheduled firings (chain-aggregate Metropolis steps/s)."""

    def __init__(self, sim, dependencies=(), **_):
        self.path = os.path.join(sim.path, "throughput.dat")
        self.n_chains = sim.n_chains
        self._last_t = 0
        self._last_wall = None
        self.file = None

    def initialise(self, sim):
        self.file = open(self.path, "w")
        self._last_t = sim.t
        self._last_wall = time.perf_counter()

    def make_step(self, sim, t):
        # sync so the interval measures execution, not enqueueing
        device_sync(sim.device_state)
        now = time.perf_counter()
        dt_steps = (t - self._last_t) * self.n_chains
        wall = now - self._last_wall
        if self.file is not None and wall > 0 and dt_steps > 0:
            self.file.write(f"{t} {dt_steps / wall!r}\n")
            self.file.flush()
        self._last_t, self._last_wall = t, now

    def finalise(self, sim):
        if self.file:
            self.file.close()
            self.file = None
