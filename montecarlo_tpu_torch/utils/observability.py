"""Observability: device sync, the throughput meter and profiler traces.

Port of ``montecarlo_tpu/utils/observability.py``.  Both algorithms are
plain host algorithms, schedulable like any recorder; on a chain mesh only
rank 0 writes (every rank still syncs with its device, so the intervals
measure the same steps).
"""

from __future__ import annotations

import os
import time

import torch

from ..core.algorithms import HostAlgorithm, _io_host
from .tree import tree_leaves

__all__ = ["device_sync", "Throughput", "ProfilerTrace"]


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
        if _io_host(sim):
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


class ProfilerTrace(HostAlgorithm):
    """Captures a ``torch.profiler`` trace between its first and second
    scheduled firings (and between its third and fourth, ...), written at
    the closing firing t as ``<trace_dir>/trace_t<t>.json``, a Chrome trace
    (``chrome://tracing``, Perfetto).  CPU activity always, the card's too
    when the chains are on one.  On a mesh only rank 0 profiles."""

    def __init__(self, sim, dependencies=(), trace_dir=None, **_):
        self.trace_dir = trace_dir or os.path.join(sim.path, "trace")
        self._prof = None

    def make_step(self, sim, t):
        if not _io_host(sim):
            return      # one trace per run: only rank 0 profiles
        if self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if sim.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            return
        device_sync(sim.device_state)
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.trace_dir, f"trace_t{int(t)}.json"))

    def finalise(self, sim):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
