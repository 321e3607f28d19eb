"""Observability: spans and counters of a run, device sync, the throughput
meter and profiler traces.

Port of ``montecarlo_tpu/utils/observability.py``, with what the port adds:

- :func:`span`: a ``torch.profiler.record_function`` range named
  ``mc.<layer>`` while a profiler records, else nothing but one read of
  torch's profiler flag.  The ranges sit on the profiler's host rows, on
  the clock of its device rows, so every idle stretch of the card falls in
  the span the host was in.  The time loop's top-level spans do not nest
  and cover the whole of ``Simulation.run``: ``mc.initialise``,
  ``mc.schedule``, ``mc.advance``, ``mc.refresh``, ``mc.observe``,
  ``mc.flush`` (children ``mc.flush.check``, ``mc.flush.to_host``,
  ``mc.flush.write``), ``mc.record``, ``mc.host_algorithm`` and
  ``mc.finalise``.  Under ``mc.advance``: ``mc.step`` (a device
  algorithm's step on the generic and hybrid paths), ``mc.cell.bind``,
  ``mc.cell.substep``, ``mc.cell.unbind`` (a cell-path segment's binding,
  substeps and unbinding), ``mc.prng`` (a public draw of
  :mod:`~montecarlo_tpu_torch.utils.prng`) and ``mc.ecmc.iteration``.
- :class:`Counters`: the plain integer counts of a run
  (``Simulation.counters``), always kept, listed in ``summary.log``.

``Throughput`` and ``ProfilerTrace`` are plain host algorithms,
schedulable like any recorder; the recorder times they share take the
per-event path, without the chunk buffer.  On a chain mesh only rank 0
writes (every rank still syncs with its device, so the intervals measure
the same steps).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from ..core.algorithms import HostAlgorithm, _io_host
from ..ops._cuda import KERNELS
from ..ops.threefry import LAUNCHES_BY_MODE, THREEFRY_KERNEL
from .tree import tree_leaves

__all__ = ["span", "Counters", "count", "counting", "device_sync",
           "Throughput", "ProfilerTrace"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` on the profiler's host rows.

    While a ``torch.profiler`` records (an operator's own
    ``torch.profiler.profile``, :class:`ProfilerTrace`), a
    ``record_function`` range, whose parent is the range enclosing it;
    otherwise one shared no-op: a read of torch's profiler flag, no object
    made, no ``record_function`` call."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@dataclasses.dataclass
class Counters:
    """Plain integer counts of one run's work (``Simulation.counters``).

    - ``periods``: the time loop's observe points (one emit each);
    - ``chunks``: flushes of the chunk buffer;
    - ``records``: rows handed to recorders (one recorder at one time);
    - ``host_syncs``: the points where the host waits for the device: a
      pull to the host, a read of a latched device flag
      (``validate_state``, ECMC's loop condition), a :func:`device_sync`;
      on the CPU the same points, waiting for nothing;
    - ``bytes_to_host``: the bytes of those pulls;
    - ``cell_binds``: segments of the cell path (one bind each);
    - ``cell_substeps``: substeps of the cell path;
    - ``prng_draws``: public draws of
      :mod:`~montecarlo_tpu_torch.utils.prng`;
    - ``launches``: each hand-written kernel's launches over the run, by
      entry point (threefry's by mode), read from the process-wide counts
      (:func:`_kernel_launches`): a run in another thread of the process
      at the same time adds its own.
    """

    periods: int = 0
    chunks: int = 0
    records: int = 0
    host_syncs: int = 0
    bytes_to_host: int = 0
    cell_binds: int = 0
    cell_substeps: int = 0
    prng_draws: int = 0
    launches: dict = dataclasses.field(default_factory=dict)


#: the counts of the run going on in this thread (:func:`counting`)
_RUN_COUNTERS = contextvars.ContextVar("montecarlo_tpu_torch_counters",
                                       default=None)


def count(field: str, n: int = 1):
    """Add ``n`` to ``field`` of the counts of the run going on in this
    thread; outside a run, nothing."""
    c = _RUN_COUNTERS.get()
    if c is not None:
        setattr(c, field, getattr(c, field) + n)


def _kernel_launches() -> dict:
    """The process's launches of each hand-written kernel so far, by entry
    point; threefry's by mode (``mc_threefry.<mode>``)."""
    out = {k.symbol: k.launches for k in KERNELS
           if k is not THREEFRY_KERNEL}
    out.update((f"{THREEFRY_KERNEL.symbol}.{m}", n)
               for m, n in LAUNCHES_BY_MODE.items())
    return out


@contextlib.contextmanager
def counting(counters: Counters):
    """Count into ``counters`` in this thread for the ``with`` block, and
    set its ``launches`` to the kernel launches made meanwhile."""
    token = _RUN_COUNTERS.set(counters)
    before = _kernel_launches()
    try:
        yield counters
    finally:
        _RUN_COUNTERS.reset(token)
        counters.launches = {k: n - before.get(k, 0)
                             for k, n in _kernel_launches().items()
                             if n != before.get(k, 0)}


def device_sync(tree):
    """Block until the work producing ``tree``'s tensors has executed: a
    ``torch.cuda.synchronize`` of each CUDA device holding one of them.
    A host sync of the run's counts, on the CPU too."""
    count("host_syncs")
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
