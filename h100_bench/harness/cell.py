"""One run of a cell: the Simulation the window drives, its warm-up at the
cell's shapes and its size, the tap that keeps the program's state at
the last period's edges for the comparison, and what the run wrote."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import warnings

import numpy as np

#: wall seconds of the second warm-up run, at the cell's stated rate
_WARM_S = 0.5
#: fewest record periods in a window: the time loop buffers its records
#: from four periods up
MIN_PERIODS = 4


def _clone(state, leaves):
    return {k: getattr(state, k).detach().clone() for k in leaves}


class Tap:
    """Wraps the system's ``refresh`` and the cell's first callback (both
    calls the program makes at every record point):

    - the callback at step ``t_snap`` keeps the state the last period
      starts from (after that point's refresh) and the move counters;
    - the ``last``-th refresh keeps its input, the row kernel's output of
      the last period with its own incremental energy;
    - with ``timing``, each refresh is timed by CUDA events and marked as a
      profiler span.
    """

    def __init__(self, leaves, counters, t_snap, last, timing=False):
        self.leaves, self.counters = leaves, counters
        self.t_snap, self.last = t_snap, last
        self.timing = timing
        self.calls = 0
        self.events = []
        self.snap = None
        self.pre_refresh = None

    def refresh(self, inner):
        import torch

        def refresh(state):
            self.calls += 1
            if self.calls == self.last:
                self.pre_refresh = _clone(state, self.leaves)
            if not self.timing:
                return inner(state)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function("bench.refresh"):
                a.record()
                out = inner(state)
                b.record()
            self.events.append((a, b))
            return out
        return refresh

    def callback(self, inner):
        def wrapped(view):
            if view.t == self.t_snap:
                self.snap = _clone(view.sys, self.leaves)
                self.snap["counters"] = \
                    self.counters(view.state).detach().clone()
            return inner(view)
        wrapped.__name__ = inner.__name__
        return wrapped

    def refresh_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def build(mc, cfgmod, made, wl, mc_seed, steps, path, fused, tap=None):
    """The cell's Simulation over ``steps`` steps: the configuration's
    sampler (``cfgmod.algorithms``), ``StoreCallbacks`` and, where the cell
    has it, ``StoreTrajectories(fmt=BIN())``, every ``stride`` steps; no
    host algorithm."""
    stride = wl["stride"]
    sched = np.arange(stride, steps + 1, stride)
    system = made["system"]
    cbs = [made["callbacks"][n] for n in wl["callbacks"]]
    if tap is not None:
        cbs[0] = tap.callback(cbs[0])
        if system.refresh is not None:
            system = dataclasses.replace(system,
                                         refresh=tap.refresh(system.refresh))
    algos = cfgmod.algorithms(mc, made, wl, mc_seed, fused)
    algos.append(dict(algorithm=mc.StoreCallbacks, callbacks=tuple(cbs),
                      scheduler=sched))
    if wl["trajectories"] == "bin":
        algos.append(dict(algorithm=mc.StoreTrajectories, fmt=mc.BIN(),
                          scheduler=sched))
    elif wl["trajectories"] is not None:
        raise ValueError(f"no trajectory format {wl['trajectories']!r}")
    sim = mc.Simulation(system, made["chains"], algos, steps, path=path)
    if any(isinstance(a, mc.HostAlgorithm) for a in sim.algorithms):
        raise RuntimeError("the timed Simulation holds a host algorithm")
    return sim


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def size_periods(mc, cfgmod, made, wl, mc_seed, seconds, root, fused,
                 device):
    """Warm the cell's shapes up and return the record periods of the
    window: ``seconds`` at the cell's stated rate ``periods_per_s``, so
    that every run of a cell does the same work.  The first warm-up run, of
    one period, builds and loads every kernel; the second runs ``_WARM_S``
    of periods at that rate, the buffered record path with them."""
    rate = wl["periods_per_s"]
    for k, w in enumerate((1, max(MIN_PERIODS, int(round(_WARM_S * rate))))):
        path = os.path.join(root, f"warmup{k}")
        sim = build(mc, cfgmod, made, wl, mc_seed, w * wl["stride"], path,
                    fused)
        sim.run()
        sync(device)
        del sim
        shutil.rmtree(path, ignore_errors=True)
    return max(MIN_PERIODS, int(round(seconds * rate)))


def read_files(path, wl, periods):
    """The callbacks' ``.dat`` columns and, for a BIN store, its last two
    frames; and ``rows_off``: records missing, extra or at the wrong step
    (every file must hold steps 0, stride, ..., periods * stride)."""
    want = np.arange(periods + 1, dtype=np.int64) * wl["stride"]
    files, off = {}, 0
    for name in wl["callbacks"]:
        a = np.loadtxt(os.path.join(path, name + ".dat"), ndmin=2)
        t = a[:, 0].astype(np.int64)
        n = min(len(t), len(want))
        off += abs(len(t) - len(want)) + int(np.sum(t[:n] != want[:n]))
        files[name] = a[:, 1]
    if wl["trajectories"] == "bin":
        d = os.path.join(path, "trajectories")
        with open(os.path.join(d, "index.json")) as f:
            idx = json.load(f)
        t = np.asarray(idx["times"], np.int64)
        n = min(len(t), len(want))
        off += abs(len(t) - len(want)) + int(np.sum(t[:n] != want[:n]))
        spec = idx["fields"]["frame"]
        m = int(np.prod(spec["shape"]))
        frames = np.memmap(os.path.join(d, "frame.bin"),
                           dtype=np.dtype(spec["dtype"]), mode="r",
                           shape=(len(t), m))
        files["frames"] = np.array(frames[-2:])
        del frames
    return files, off


def window(sim, device, trace):
    """Run the timed Simulation once, from its start to a final device
    synchronisation; returns the wall seconds, the profiler's events
    (``trace``) and the warnings the run raised."""
    import contextlib
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with prof as p:
            t0 = time.perf_counter()
            sim.run()
            sync(device)
            wall = time.perf_counter() - t0
    events = p.events() if trace else None
    return wall, events, list(caught)
