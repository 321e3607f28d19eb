"""Simulation orchestrator.

Port of ``montecarlo_tpu/core/simulation.py`` (ref ``src/simulation.jl``).
PyTorch runs eagerly, so the time loop is a host loop that enqueues device
work and syncs only where the host needs values:

- The stepper (:func:`_select_advance`) is one fused sweep call per
  segment between sync points (a single always-on Metropolis with a
  fusable pool); the hybrid stepper, which runs such a Metropolis in fused
  segments between the events of sparse further device algorithms (the
  PGMC estimator and update) and those algorithms at their events; or the
  generic loop that applies each device algorithm at the steps its
  schedule names.
- Recorder events are sync points.  Sorted sync times are factored into
  arithmetic runs, and each run advances ``stride`` steps at a time and
  writes observables into a device buffer that is copied to the host once
  per chunk of :data:`_CHUNK` periods, with the chunk after it already
  enqueued (a one-deep pipeline).
- Host algorithms and short runs use the per-event path: advance, pull,
  write.
- Every sync point checks the device state (``validate_state``) before its
  records are written; an auto-selected cell-MC path whose bind overflowed
  falls back and resumes from the last committed state (:func:`_execute`).
- Each layer of the loop is a span (``mc.initialise``, ``mc.schedule``,
  ``mc.advance``, ``mc.refresh``, ``mc.observe``, ``mc.flush``,
  ``mc.record``, ``mc.host_algorithm``, ``mc.finalise``:
  :func:`~montecarlo_tpu_torch.utils.observability.span`), and the run's
  work is counted in ``Simulation.counters``.

On a chain mesh (``mesh=``, :mod:`~montecarlo_tpu_torch.parallel`) every
rank runs this loop on its slice of the chains.  Each observe point first
gathers the sliced leaves (the chains and the per-chain counters) from
every rank, so observables see the whole ensemble on every rank, as the
reference's replicated observables do; rank 0 writes the files.  Every
host decision that could differ between ranks (an overflow flag) is
reduced over the ranks first, so all ranks issue the same collectives.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

from ..parallel.mesh import fetch, shard_device_state
from ..utils.observability import Counters, count, counting, device_sync, span
from ..utils.tree import tree_leaves, tree_leaves_with_path, tree_map
from .algorithms import (Algorithm, DeviceAlgorithm, HostAlgorithm,
                         ObservableRecorder, SimView, _io_host, is_resuming,
                         to_numpy)
from .schedule import build_schedule, compress_runs
from .system import SystemDef, stack_chains

__all__ = ["Simulation", "run", "build_schedule"]

_CHUNK = 512          # periods buffered on device per flush
_MIN_BUFFERED = 4     # below this run length, per-event path is cheaper


class Simulation:
    """Holds chains + algorithms + schedules; see module docstring.

    ``algorithm_list`` entries are dicts with an ``algorithm`` class,
    optional ``scheduler`` (default: every step), optional ``dependencies``
    (tuple of previously-listed algorithm classes, indices or instances),
    plus algorithm kwargs.  ``device`` is where the chains and all device
    state live; it defaults to the mesh's device, else the chains' device.

    ``mesh`` (a :class:`~montecarlo_tpu_torch.parallel.Mesh`) splits the
    chains over its ranks: every rank passes the same whole ensemble and
    keeps its slice (:func:`~montecarlo_tpu_torch.parallel.
    shard_device_state`).  ``device`` and ``mesh`` are taken together only
    when they agree.
    """

    def __init__(self, system: SystemDef, chains, algorithm_list,
                 steps: int, path: str = "data", verbose: bool = False,
                 device=None, mesh=None):
        self.system = system
        self.mesh = mesh
        if isinstance(chains, list) and chains:
            # reference-style "vector of systems" input: stack to chain-major
            chains = stack_chains(chains)
        leaves = tree_leaves(chains)
        if not leaves:
            raise ValueError("chains tree has no leaves")
        if mesh is not None:
            if device is not None and not _same_device(device, mesh.device):
                raise ValueError(
                    f"device={device!r} disagrees with the mesh's device "
                    f"{mesh.device}")
            device = mesh.device
        self.device = torch.device(device) if device is not None \
            else leaves[0].device
        self.chains0 = tree_map(lambda x: x.to(self.device), chains)
        self.n_chains = int(leaves[0].shape[0])
        if mesh is not None and self.n_chains % mesh.size:
            raise ValueError(
                f"n_chains={self.n_chains} not divisible by mesh size "
                f"{mesh.size}; pad the chain count (extra independent chains "
                f"are free)")
        self.steps = int(steps)
        self.path = path
        self.verbose = verbose
        self.t = 0
        self.device_state: Dict[str, Any] = {}
        self.counters = Counters()     # the last run's (observability)

        self.algorithms: List[Algorithm] = []
        self.schedulers: List[np.ndarray] = []
        for spec in algorithm_list:
            spec = dict(spec)
            cls = spec.pop("algorithm")
            sched = spec.pop("scheduler", None)
            if sched is None:
                sched = np.arange(1, self.steps + 1, dtype=np.int64)
            sched = np.asarray(sched, dtype=np.int64)
            if sched.size and (not np.all(np.diff(sched) >= 0)):
                raise ValueError(f"scheduler for {cls.__name__} must be sorted")
            if sched.size and (sched[0] < 0 or sched[-1] > self.steps):
                raise ValueError(
                    f"scheduler for {cls.__name__} out of range [0, steps]")
            deps = self._resolve_deps(spec.pop("dependencies", ()), cls)
            inst = cls(self, dependencies=deps, **spec)
            self.algorithms.append(inst)
            self.schedulers.append(sched)

        # unique state keys for device algorithms (list order preserved)
        seen = set()
        self.device_algos: List[DeviceAlgorithm] = []
        for a in self.algorithms:
            if isinstance(a, DeviceAlgorithm):
                base = a.state_key or type(a).__name__.lower()
                key, i = base, 1
                while key in seen:
                    key = f"{base}_{i}"
                    i += 1
                a.state_key = key
                seen.add(key)
                self.device_algos.append(a)

        # per-algorithm parameter namespaces: the first params-owning
        # algorithm keeps the canonical "params" slot (SimView.params);
        # every further owner gets its own slot
        owners = [a for a in self.device_algos if hasattr(a, "init_params")]
        for i, a in enumerate(owners):
            a.params_key = "params" if i == 0 else f"params_{a.state_key}"

        if _io_host(self):
            os.makedirs(self.path, exist_ok=True)

    def _resolve_deps(self, dep_spec, cls):
        """Resolve a ``dependencies`` entry to algorithm instances: a type
        (matches every previously-listed instance), an index into the
        algorithm list so far, or an instance."""
        deps = []
        for d in dep_spec:
            if isinstance(d, bool):
                raise TypeError(f"invalid dependency spec for "
                                f"{cls.__name__}: {d!r}")
            if isinstance(d, int):
                if not 0 <= d < len(self.algorithms):
                    raise ValueError(
                        f"dependency index {d} for {cls.__name__} is out of "
                        f"range: integer dependencies must point at one of "
                        f"the {len(self.algorithms)} previously listed "
                        f"algorithm(s)")
                deps.append(self.algorithms[d])
            elif isinstance(d, type):
                deps.extend(a for a in self.algorithms if isinstance(a, d))
            elif isinstance(d, Algorithm):
                deps.append(d)
            else:
                raise TypeError(f"invalid dependency spec for "
                                f"{cls.__name__}: {d!r}")
        return tuple(dict.fromkeys(deps))

    # ------------------------------------------------------------------
    def init_device_state(self):
        dstate: Dict[str, Any] = {
            "sys": self.chains0,
            "t": 0,
            "params": (),
        }
        for a in self.device_algos:
            if hasattr(a, "init_params"):
                dstate[a.params_key] = a.init_params()
        for a in self.device_algos:
            dstate[a.state_key] = a.init_state(self)
        if self.mesh is not None:
            dstate = shard_device_state(dstate, self.mesh, self.n_chains)
        return dstate

    def view(self, dstate) -> SimView:
        return SimView(sys=dstate["sys"], params=dstate["params"],
                       t=dstate["t"], state=dstate)

    def gathered_view(self, dstate) -> SimView:
        """The view of the whole ensemble: on a mesh, the sliced leaves
        gathered from every rank (a collective), else :meth:`view`."""
        return self.view(fetch(dstate, self.mesh))

    def run(self):
        run(self)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def run(simulation: Simulation):
    """Run the simulation (ref ``run!``, ``src/simulation.jl:175-204``)."""
    sim = simulation
    sim.counters = Counters()
    try:
        with counting(sim.counters):
            _run(sim)
    finally:
        _write_counters(sim)


def _run(sim: Simulation):
    try:
        with span("mc.initialise"):
            if sim.verbose:
                print("\n" + "-" * 50)
                print("\033[1;32mINITIALISATION\033[0m")
            # decided before initialise, which may not touch the device
            # state: a store kept across a resume (the BIN trajectories)
            # asks the same
            resuming = is_resuming(sim)
            for alg in sim.algorithms:
                alg.initialise(sim)
            if not resuming:
                sim.device_state = sim.init_device_state()
            _write_summary(sim)
            if not resuming:
                _store_first(sim)
            if sim.verbose:
                print("\033[1;32m\nRUNNING SIMULATION...\033[0m")
        t_start = time.perf_counter()
        _execute(sim)
        with span("mc.finalise"):
            device_sync(sim.device_state)
            sim_time = time.perf_counter() - t_start
            if sim.verbose:
                print(f"\nSimulation completed in {sim_time} s")
            _update_summary(sim, sim_time)
    finally:
        with span("mc.finalise"):
            if sim.verbose:
                print("\033[1;32m\nFINALISATION\033[0m")
            _store_last(sim)
            for alg in sim.algorithms:
                alg.finalise(sim)
            _finalise_summary(sim)
            if sim.verbose:
                print("\033[1;32m\nDONE\033[0m")
                print("-" * 50 + "\n")


def _store_first(sim: Simulation):
    """store_first semantics: observe at t=0 before any step."""
    recs = [a for a in sim.algorithms
            if isinstance(a, ObservableRecorder) and a.store_first]
    _pull_and_write(sim, recs, 0)


def _store_last(sim: Simulation):
    recs = [a for a in sim.algorithms
            if isinstance(a, ObservableRecorder) and a.store_last]
    if sim.device_state:
        _pull_and_write(sim, recs, sim.t)


def _same_device(a, b) -> bool:
    """``a`` names device ``b`` (``'cuda'`` names any CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and a.index in (None, b.index)


def _pull_and_write(sim, recorders, t):
    if not recorders:
        return
    view = sim.gathered_view(sim.device_state)
    values = _to_host(tuple(r.observable(view) for r in recorders))
    for r, v in zip(recorders, values):
        r.write(sim, t, v)
    count("records", len(recorders))


def _to_host(tree):
    """:func:`to_numpy`, counted as a host sync of its bytes."""
    out = to_numpy(tree)
    count("host_syncs")
    count("bytes_to_host", sum(x.nbytes for x in tree_leaves(out)))
    return out


# -- advance ------------------------------------------------------------------

def build_chunk_runner(advance, refresh, observe):
    """Buffered runner: ``n_periods`` advances, each followed by an
    observable emit into a device buffer of ``n_periods <= _CHUNK`` rows;
    the caller copies the buffer to the host once per chunk."""

    def run_chunk(ds, masks, first_dt, stride, n_periods):
        bufs = None
        for i in range(n_periods):
            with span("mc.advance"):
                ds = advance(ds, masks, first_dt if i == 0 else stride)
            ds = refresh(ds)
            with span("mc.observe"):
                obs = observe(ds)
                if bufs is None:
                    bufs = tree_map(
                        lambda o: torch.empty(
                            (n_periods,) + tuple(o.shape), dtype=o.dtype,
                            device=o.device),
                        obs)
                tree_map(lambda b, o: b[i].copy_(o), bufs, obs)
        count("periods", n_periods)
        return ds, bufs

    return run_chunk


def _make_advance(device_algos, always_on=None):
    """Build the generic time-stepper: for each of ``n_steps`` steps, apply
    every device algorithm whose schedule mask (a host bool array of length
    steps+1, indexed by timestep) is set at that step, in list order.
    ``always_on[k]`` marks algorithms whose schedule covers every step."""
    if always_on is None:
        always_on = (False,) * len(device_algos)

    def advance(ds, masks, n_steps):
        for _ in range(int(n_steps)):
            t = ds["t"] + 1
            ds = {**ds, "t": t}
            for alg, mask, always in zip(device_algos, masks, always_on):
                if always or mask[t]:
                    with span("mc.step"):
                        ds = alg.step(ds, t)
        return ds

    return advance


def _make_hybrid_advance(met, sparse_algos, event_times):
    """The fused path composed with sparse device algorithms (PGMC).

    Between two consecutive events of the sparse algorithms (estimator /
    update steps, the sorted ``event_times``) the always-on Metropolis
    advances in one fused sweep call; at each event step the sparse
    algorithms whose schedule names it run in list order.  Metropolis must
    be the first device algorithm: the fused sweep through t comes before
    the sparse algorithms at t, the reference's in-order semantics
    (``src/simulation.jl:185-191``).  A host loop that never syncs with the
    device.
    """

    def advance(ds, masks, n_steps):
        t_end = ds["t"] + int(n_steps)
        while ds["t"] < t_end:
            k = int(np.searchsorted(event_times, ds["t"], side="right"))
            t_next = (min(int(event_times[k]), t_end)
                      if k < len(event_times) else t_end)
            ds = met.fused_advance(ds, t_next - ds["t"])
            for alg, m in zip(sparse_algos, masks[1:]):
                if m[ds["t"]]:
                    with span("mc.step"):
                        ds = alg.step(ds, ds["t"])
        return ds

    return advance


def _select_advance(sim: Simulation):
    """Pick the device time-stepper.

    1. Single always-on Metropolis with a fusable pool -> one fused sweep
       call per segment.
    2. Always-on fusable Metropolis listed first + sparse further device
       algorithms (the PGMC estimator/update pattern) -> the hybrid stepper:
       fused segments between events, the sparse algorithms at events.
    3. Otherwise -> the generic mask-scheduled loop.
    """
    def covers_all(sched):
        return (len(sched) == sim.steps and sched[0] == 1
                and sched[-1] == sim.steps)

    algos = sim.device_algos
    if algos and getattr(algos[0], "supports_fused", False):
        alg = algos[0]
        sched = sim.schedulers[sim.algorithms.index(alg)]
        if covers_all(sched):
            if len(algos) == 1:
                def advance(ds, masks, n_steps):
                    return alg.fused_advance(ds, n_steps)
                return advance
            # hybrid: worthwhile when the other device algorithms fire on a
            # minority of steps (each event costs a kernel relaunch)
            others = [sim.schedulers[sim.algorithms.index(a)]
                      for a in algos[1:]]
            events = sorted({int(t) for s in others for t in s})
            if len(events) * 2 <= sim.steps:
                return _make_hybrid_advance(alg, algos[1:],
                                            np.asarray(events, np.int64))
    always_on = tuple(
        covers_all(sim.schedulers[sim.algorithms.index(a)]) for a in algos)
    return _make_advance(algos, always_on)


def _execute(sim: Simulation):
    """Run the time loop, falling back (and resuming from the last committed
    sync point, whose records are all that was written) when an
    auto-selected cell-MC bind overflows.  Nothing is rewound: the generic
    path draws each step's numbers from the chains' keys and t, and the
    row kernels from the seed and the micro-step, so the steps after the
    fallback draw what they would have drawn without the dropped
    segments."""
    from .metropolis import Metropolis
    while True:
        try:
            return _execute_inner(sim)
        except Metropolis.CellBindInvalid as e:
            e.alg.disable_cell_path()
            slc = sim.device_state.get(e.alg.state_key)
            if isinstance(slc, dict) and "cell_overflow" in slc:
                sim.device_state = {
                    **sim.device_state,
                    e.alg.state_key: {**slc, "cell_overflow": torch.zeros_like(
                        slc["cell_overflow"])}}
            warnings.warn(
                "cell-MC bind exceeded the planned cell capacity at "
                f"t={sim.t}; falling back to the row or generic path for the "
                "rest of the run (raise cell_opts={'cap_slack': ...} to keep "
                "the fast path)", RuntimeWarning, stacklevel=2)


def _execute_inner(sim: Simulation):
    with span("mc.schedule"):
        advance = _select_advance(sim)
        masks = []
        for a in sim.device_algos:
            i = sim.algorithms.index(a)
            m = np.zeros(sim.steps + 1, dtype=bool)
            sched = sim.schedulers[i]
            m[sched[(sched > 0) & (sched <= sim.steps)]] = True
            masks.append(m)
        masks = tuple(masks)

        # sync events: (obs recorder indices, host algorithm indices) per
        # time
        events: Dict[int, tuple] = {}
        for i, (alg, sched) in enumerate(zip(sim.algorithms,
                                             sim.schedulers)):
            if isinstance(alg, (ObservableRecorder, HostAlgorithm)):
                for t in sched[(sched > 0) & (sched <= sim.steps)]:
                    events.setdefault(int(t), ([], []))
                    if isinstance(alg, ObservableRecorder):
                        events[int(t)][0].append(i)
                    else:
                        events[int(t)][1].append(i)

        # on resume (sim.t > 0) skip past events
        sync_ts = sorted(t for t in events if t > sim.t)
        # group sync times into uniform runs (same signature, constant
        # stride)
        groups = _group_events(sync_ts, events)

    def check_state(ds):
        # surface latched device-side flags (an invalid cell bind) at every
        # host sync point, before that point's records are written
        for a in sim.device_algos:
            validate = getattr(a, "validate_state", None)
            if validate is not None:
                validate(ds)

    # cache revalidation at observation points (SystemDef.refresh)
    if sim.system.refresh is not None:
        def refresh(ds):
            with span("mc.refresh"):
                return {**ds, "sys": sim.system.refresh(ds["sys"])}
    else:
        refresh = lambda ds: ds

    def advance_r(ds, masks, n_steps):
        with span("mc.advance"):
            ds = advance(ds, masks, n_steps)
        return refresh(ds)

    def make_observe(obs_ids):
        recs = [sim.algorithms[i] for i in obs_ids]

        def observe(ds):
            v = sim.gathered_view(ds)
            return tuple(r.observable(v) for r in recs)

        return observe

    ds = sim.device_state

    for times, obs_ids, host_ids in groups:
        bufferable = (not host_ids
                      and len(times) >= _MIN_BUFFERED
                      and all(getattr(sim.algorithms[i], "buffered_ok", True)
                              for i in obs_ids))
        if bufferable:
            _, stride, _ = compress_runs(np.asarray(times))[0]
            run_chunk = build_chunk_runner(advance, refresh,
                                           make_observe(obs_ids))
            recs = [sim.algorithms[i] for i in obs_ids]

            def flush(bufs, ds_after, ts):
                # commit a chunk: check its state, copy its buffer to the
                # host (by now the next chunk is already enqueued) and write
                # it out; a chunk whose state fails the check is dropped
                with span("mc.flush"):
                    with span("mc.flush.check"):
                        check_state(ds_after)
                    with span("mc.flush.to_host"):
                        vals = _to_host(bufs)
                    with span("mc.flush.write"):
                        for r, v in zip(recs, vals):
                            r.write_batch(sim, ts, v)
                    sim.t = int(ts[-1])
                    sim.device_state = ds_after
                    count("chunks")
                    count("records", len(ts) * len(recs))

            pos = 0
            t_disp = sim.t          # end time of the last enqueued chunk
            pending = None
            while pos < len(times):
                n = min(_CHUNK, len(times) - pos)
                first_dt = times[pos] - t_disp
                ds, bufs = run_chunk(ds, masks, first_dt,
                                     stride if stride else 1, n)
                t_disp = times[pos + n - 1]
                if pending is not None:
                    flush(*pending)
                pending = (bufs, ds, times[pos:pos + n])
                pos += n
            if pending is not None:
                flush(*pending)
        else:
            observe = make_observe(obs_ids) if obs_ids else None
            for t in times:
                if t > sim.t:
                    ds = advance_r(ds, masks, t - sim.t)
                with span("mc.record"):
                    if t > sim.t:
                        check_state(ds)
                        sim.t = t
                        sim.device_state = ds
                    if obs_ids:
                        vals = _to_host(observe(ds))
                        # unbuffered recorders (the backups) write last, so
                        # a checkpoint at t finds the other records at t on
                        # disk
                        for i, v in sorted(
                                zip(obs_ids, vals),
                                key=lambda iv: not getattr(
                                    sim.algorithms[iv[0]], "buffered_ok",
                                    True)):
                            sim.algorithms[i].write(sim, t, v)
                        count("periods")
                        count("records", len(obs_ids))
                for i in host_ids:
                    with span("mc.host_algorithm"):
                        sim.algorithms[i].make_step(sim, t)
                if host_ids:
                    # host algorithms may replace sim.device_state
                    ds = sim.device_state

    if sim.t < sim.steps:
        ds = advance_r(ds, masks, sim.steps - sim.t)
        with span("mc.record"):
            check_state(ds)
        sim.t = sim.steps
    sim.device_state = ds


def _group_events(sync_ts, events):
    """Split sorted sync times into maximal runs with identical firing
    signature and constant stride."""
    groups = []
    i, n = 0, len(sync_ts)
    while i < n:
        t0 = sync_ts[i]
        sig = (tuple(events[t0][0]), tuple(events[t0][1]))
        j = i + 1
        stride = None
        while j < n:
            tj = sync_ts[j]
            if (tuple(events[tj][0]), tuple(events[tj][1])) != sig:
                break
            s = tj - sync_ts[j - 1]
            if stride is None:
                stride = s
            elif s != stride:
                break
            j += 1
        groups.append((sync_ts[i:j], sig[0], list(sig[1])))
        i = j
    return groups


# -- summary.log (ref ``src/simulation.jl:124-172``) ------------------------

def _dtype_name(dtype) -> str:
    """numpy-style dtype name (``float32``, not ``torch.float32``)."""
    return str(dtype).replace("torch.", "")


def _write_summary(sim: Simulation):
    if not _io_host(sim):
        return
    with open(os.path.join(sim.path, "summary.log"), "w") as f:
        f.write("SIMULATION SUMMARY\n\n")
        f.write("Simulation:\n")
        f.write(f"\tSteps: {sim.steps}\n")
        f.write(f"\tNumber of chains: {sim.n_chains}\n")
        f.write(f"\tNumber of algorithms: {len(sim.algorithms)}\n")
        f.write(f"\tVerbose: {sim.verbose}\n")
        f.write(f"\tStarted on {datetime.datetime.now()}\n\n")
        f.write("System:\n")
        f.write(f"\t{sim.system.name}\n")
        # one line per state field with the per-chain shape and dtype
        for path, leaf in tree_leaves_with_path(sim.chains0):
            label = ".".join(str(k) for k in path)
            shape = tuple(leaf.shape)[1:]  # drop the chain axis
            f.write(f"\t\t{label}: shape {shape or '()'} "
                    f"dtype {_dtype_name(leaf.dtype)}\n")
        f.write("\n")
        f.write("Algorithms:\n")
        for alg, sched in zip(sim.algorithms, sim.schedulers):
            alg.write_summary(f, sched)
        f.write("\n")


def _update_summary(sim: Simulation, sim_time: float):
    if not _io_host(sim):
        return
    with open(os.path.join(sim.path, "summary.log"), "a") as f:
        f.write("Report:\n")
        f.write(f"\tSimulation time: {sim_time} s\n")


def _finalise_summary(sim: Simulation):
    if not _io_host(sim):
        return
    total = 0
    for root, _, files in os.walk(sim.path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(root, fn))
            except OSError:
                pass
    with open(os.path.join(sim.path, "summary.log"), "a") as f:
        f.write(f"\tSimulation size: {total / 1024 ** 2} MB\n")
        f.write(f"\tStatus: Completed on {datetime.datetime.now()}\n")


def _write_counters(sim: Simulation):
    """The run's counts, closing the report (the port's own lines)."""
    if not _io_host(sim):
        return
    c = dataclasses.asdict(sim.counters)
    launches = c.pop("launches")
    with open(os.path.join(sim.path, "summary.log"), "a") as f:
        f.write("\tCounters: " + ", ".join(
            f"{k} {v}" for k, v in c.items()) + "\n")
        f.write("\tKernel launches: " + (", ".join(
            f"{k} {v}" for k, v in launches.items()) or "none") + "\n")
