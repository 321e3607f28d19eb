"""Algorithm lifecycle protocol + recorder algorithms.

Port of ``montecarlo_tpu/core/algorithms.py``.  Algorithms are split by
where they run, so the orchestrator can batch device work between host
sync points:

- :class:`DeviceAlgorithm` — a state transform on device tensors
  (Metropolis sweeps).
- :class:`ObservableRecorder` — declares an observable of the device state;
  the orchestrator evaluates it on device (batched into device buffers
  between flushes) and hands numpy values to ``write``.
- :class:`HostAlgorithm` — arbitrary host code at scheduled steps.

All keep the reference's 3-hook lifecycle ``initialise`` / step /
``finalise`` and its on-disk layout; the files written are byte-identical
to the JAX package's for the same values.  On a chain mesh every rank
computes the observables of the whole ensemble and only rank 0 touches the
filesystem (:func:`_io_host`), so each file is written once.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..parallel.distributed import is_io_host
from ..parallel.mesh import fetch
from ..utils.tree import tree_leaves_with_path, tree_map

__all__ = [
    "Algorithm",
    "DeviceAlgorithm",
    "ObservableRecorder",
    "HostAlgorithm",
    "SimView",
    "Format",
    "TXT",
    "DAT",
    "BIN",
    "StoreCallbacks",
    "StoreTrajectories",
    "load_chain_major_trajectories",
    "StoreLastFrames",
    "StoreBackups",
    "PrintTimeSteps",
]


@dataclasses.dataclass(frozen=True)
class SimView:
    """View of the device state handed to callbacks and observables."""

    sys: Any          # chain-batched system state (leading chain axis)
    params: Any       # tuple of move-parameter trees (shared by all chains)
    t: Any            # current step (int)
    state: Any        # full device-state dict (algorithm slices by state_key)


class Algorithm:
    """Base lifecycle (ref ``AriannaAlgorithm``, ``src/algorithms.jl:6-37``)."""

    def initialise(self, sim) -> None:
        return None

    def finalise(self, sim) -> None:
        return None

    def write_summary(self, io, scheduler) -> None:
        io.write(f"\t{type(self).__name__}\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")


def is_resuming(sim) -> bool:
    """True when ``sim`` carries a device state past step 0 (set by
    :func:`~montecarlo_tpu_torch.checkpoint.resume_state`), which its next
    run continues.  A recorder's ``initialise`` asks it of whatever
    simulation it is given, which need not have a device state."""
    return bool(getattr(sim, "device_state", None)) and sim.t > 0


def _io_host(sim) -> bool:
    """True where ``sim``'s files are written: rank 0 of its mesh, or, with
    no mesh, rank 0 of the process group if there is one (the reference's
    ``jax.process_index() == 0``)."""
    mesh = getattr(sim, "mesh", None)
    return mesh.rank == 0 if mesh is not None else is_io_host()


def _n_calls(scheduler) -> int:
    s = np.asarray(scheduler)
    if s.size == 0:
        return 0
    return int(np.count_nonzero((s > 0) & (s <= s[-1])))


class DeviceAlgorithm(Algorithm):
    """A state transform on the device-state dict, scheduled by the time
    loop."""

    #: unique key for this algorithm's slice of the device-state dict
    state_key: str = ""

    def init_state(self, sim) -> Any:
        """Return this algorithm's initial device-state slice."""
        return ()

    def step(self, dstate: dict, t: int) -> dict:
        """Update of the device-state dict at step ``t``."""
        raise NotImplementedError


class ObservableRecorder(Algorithm):
    """Records an observable of the device state at scheduled steps."""

    store_first: bool = True
    store_last: bool = False

    def observable(self, view: SimView):
        """Tree of device tensors computed from the view."""
        raise NotImplementedError

    def write(self, sim, t: int, value) -> None:
        """Host-side write of one observation (``value`` is numpy)."""
        raise NotImplementedError

    def write_batch(self, sim, ts, value) -> None:
        """Write a whole buffered chunk (leaves of ``value`` have a leading
        time axis aligned with ``ts``).  Default: per-event loop."""
        for j, t in enumerate(ts):
            self.write(sim, t, tree_map(lambda x: x[j], value))


class HostAlgorithm(Algorithm):
    """Arbitrary host-side work at scheduled steps."""

    def make_step(self, sim, t: int) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Output formats (ref ``Format``/``TXT``/``DAT``, ``src/algorithms.jl:116-140``)
# ---------------------------------------------------------------------------

class Format:
    extension = ""


class TXT(Format):
    extension = ".txt"


class DAT(Format):
    extension = ".dat"


class BIN(Format):
    """Chain-major consolidated binary trajectory layout: one
    ``trajectories/<field>.bin`` per frame field with a leading (time, chain)
    axis pair, plus ``trajectories/index.json`` (dtype/shape/times
    manifest).  The same layout as the JAX package's; read back with
    :func:`load_chain_major_trajectories`.  A run resumed in the directory
    of the run it continues appends to that run's store (records up to the
    resumed step are kept, later ones dropped), where the JAX package's
    truncates it.

    The manifest never trails the last checkpoint: it is rewritten (to a
    temporary file, then ``os.replace``) when the run starts, after each
    flushed chunk, before a ``StoreBackups`` event saves its checkpoint and
    at finalise, each time after the ``.bin`` files were flushed, so a
    process killed at any point leaves a manifest that the files cover.
    The flush hands the bytes to the operating system; it is no ``fsync``
    against a power cut."""

    extension = ".bin"


def _fmt_scalar(v) -> str:
    """Format a scalar the way Julia prints floats (shortest round-trip)."""
    v = np.asarray(v)
    if v.dtype.kind in "iub":
        return str(int(v))
    return repr(float(v))


def to_numpy(tree):
    """Copy a tree of tensors to host numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if torch.is_tensor(x) else np.asarray(x), tree)


# ---------------------------------------------------------------------------
# StoreCallbacks (ref ``src/algorithms.jl:62-109``)
# ---------------------------------------------------------------------------

class StoreCallbacks(ObservableRecorder):
    """Append ``"t value"`` lines, one ``.dat`` file per callback; the
    ``callback_`` prefix of the function name is stripped, so
    ``callback_energy`` writes ``energy.dat``."""

    def __init__(self, sim, callbacks: Sequence[Callable] = (),
                 store_first: bool = True, store_last: bool = False,
                 dependencies=(), **_):
        self.callbacks = tuple(callbacks)
        self.store_first = store_first
        self.store_last = store_last
        names = [getattr(cb, "__name__", f"callback{i}").replace("callback_", "")
                 for i, cb in enumerate(self.callbacks)]
        self.paths = [os.path.join(sim.path, f"{n}.dat") for n in names]
        self.files = []

    def initialise(self, sim):
        if not _io_host(sim):
            return
        if sim.verbose:
            print("Opening callback files...")
        os.makedirs(sim.path, exist_ok=True)
        self.files = [open(p, "w") for p in self.paths]

    def observable(self, view: SimView):
        return tuple(cb(view) for cb in self.callbacks)

    def write(self, sim, t, value):
        if not _io_host(sim):
            return
        for f, v in zip(self.files, value):
            f.write(f"{t} {_fmt_scalar(v)}\n")
            f.flush()

    def write_batch(self, sim, ts, value):
        if not _io_host(sim):
            return
        for f, col in zip(self.files, value):
            col = np.asarray(col)
            f.write("".join(f"{t} {v!r}\n"
                            for t, v in zip(ts, col.tolist())))
            f.flush()

    def finalise(self, sim):
        if sim.verbose:
            print("Closing callback files...")
        for f in self.files:
            f.close()
        self.files = []


# ---------------------------------------------------------------------------
# StoreTrajectories (ref ``src/algorithms.jl:154-210``)
# ---------------------------------------------------------------------------

class StoreTrajectories(ObservableRecorder):
    """One ``trajectories/<c>/trajectory.dat`` per chain (1-based dirs),
    with the line format of the system's ``format_frame``; ``fmt=BIN()``
    switches to the chain-major consolidated layout (see :class:`BIN`)."""

    def __init__(self, sim, fmt: Format = DAT(), store_first: bool = True,
                 store_last: bool = False, dependencies=(), **_):
        self.fmt = fmt
        self.store_first = store_first
        self.store_last = store_last
        self.system = sim.system
        self.chain_major = isinstance(fmt, BIN)
        self.n_chains = sim.n_chains
        self.io_host = _io_host(sim)
        if self.chain_major:
            self.dir = os.path.join(sim.path, "trajectories")
            self._times = []
            self._field_files = {}
            self._field_spec = {}
            return
        self.dirs = [os.path.join(sim.path, "trajectories", str(c + 1))
                     for c in range(sim.n_chains)]
        self.paths = [os.path.join(d, "trajectory" + fmt.extension)
                      for d in self.dirs]
        self.files = []

    def initialise(self, sim):
        if not self.io_host:
            return
        if sim.verbose:
            print("Opening trajectory files...")
        if self.chain_major:
            os.makedirs(self.dir, exist_ok=True)
            self._times = []
            self._field_files = {}
            self._field_spec = {}
            if is_resuming(sim):
                self._reopen(sim.t)
            else:
                self.commit()
            return
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)
        self.files = [open(p, "w") for p in self.paths]

    def _reopen(self, t):
        """Continue the store a resumed run finds in its directory: keep its
        records up to step ``t``, drop later ones, append from there."""
        index = os.path.join(self.dir, "index.json")
        if not os.path.exists(index):
            stale = sorted(glob.glob(os.path.join(self.dir, "*.bin")))
            if stale:
                raise RuntimeError(
                    f"cannot resume the trajectory store in {self.dir}: it "
                    f"holds {[os.path.basename(p) for p in stale]} but no "
                    f"index.json, so its records cannot be told from "
                    f"leftovers; move the files away or resume in another "
                    f"directory")
            self.commit()
            return
        with open(index) as f:
            idx = json.load(f)
        keep = int(np.searchsorted(np.asarray(idx["times"], np.int64), t,
                                   side="right"))
        self._times = [int(s) for s in idx["times"][:keep]]
        for name, spec in idx["fields"].items():
            path = os.path.join(self.dir, name + ".bin")
            size = np.dtype(spec["dtype"]).itemsize * int(
                np.prod(spec["shape"], dtype=np.int64))
            if os.path.getsize(path) < keep * size:
                raise RuntimeError(
                    f"{path} holds fewer than the {keep} records that "
                    f"index.json lists up to step {t}")
            os.truncate(path, keep * size)
            self._field_files[name] = open(path, "ab")
            self._field_spec[name] = spec
        self.commit()

    def commit(self):
        """Make the chain-major store on disk whole: flush the ``.bin``
        files, then replace the manifest with one that lists every record
        written so far.  A no-op for the per-chain text layout and off
        rank 0."""
        if not (self.chain_major and self.io_host):
            return
        for f in self._field_files.values():
            f.flush()
        index = os.path.join(self.dir, "index.json")
        with open(index + ".tmp", "w") as f:
            json.dump({"n_chains": self.n_chains, "times": self._times,
                       "fields": self._field_spec}, f)
        os.replace(index + ".tmp", index)

    def observable(self, view: SimView):
        return self.system.frame(view.sys)

    # -- chain-major binary layout ------------------------------------------
    def _append_records(self, ts, value):
        """Append a (T, M, ...) tree chunk to the per-field bin files."""
        for path, leaf in tree_leaves_with_path(value):
            name = _field_name(path)
            leaf = np.ascontiguousarray(leaf)
            if name not in self._field_files:
                self._field_files[name] = open(
                    os.path.join(self.dir, name + ".bin"), "wb")
                self._field_spec[name] = {
                    "dtype": leaf.dtype.str,
                    "shape": list(leaf.shape[1:]),   # (M, ...) per record
                }
            leaf.tofile(self._field_files[name])
        self._times.extend(int(t) for t in ts)

    def write(self, sim, t, value):
        # buffered IO + flush at finalise keeps the same file contents
        # without a syscall per line on dense schedules
        if not self.io_host:
            return
        if self.chain_major:
            self._append_records(
                [t], tree_map(lambda x: np.asarray(x)[None], value))
            return
        fmt = self.system.format_frame
        rows = _unstack(value)
        t = int(t)
        for f, row in zip(self.files, rows):
            f.write(fmt(t, row) + "\n")

    def write_batch(self, sim, ts, value):
        if not self.io_host:
            return
        if self.chain_major:
            self._append_records(ts, value)
            self.commit()
            return
        fmt = self.system.format_frame
        if isinstance(value, np.ndarray) and value.ndim == 2:
            # scalar frames: one string join per chain
            for c, f in enumerate(self.files):
                col = value[:, c].tolist()
                f.write("".join(
                    fmt(t, v) + "\n" for t, v in zip(ts, col)))
        else:
            super().write_batch(sim, ts, value)

    def finalise(self, sim):
        if not self.io_host:
            return
        if sim.verbose:
            print("Closing trajectory files...")
        if self.chain_major:
            # the manifest is written even for an empty run so the loader
            # never hits a missing index.json
            os.makedirs(self.dir, exist_ok=True)
            self.commit()
            for f in self._field_files.values():
                f.close()
            self._field_files = {}
            return
        for f in self.files:
            f.close()
        self.files = []


def _field_name(path) -> str:
    """Stable field name from a tree path (``()`` -> ``'frame'``), equal to
    the JAX package's name for the same structure."""
    return "_".join(str(k) for k in path) or "frame"


def load_chain_major_trajectories(path):
    """Load a chain-major trajectory store written by
    ``StoreTrajectories(fmt=BIN())`` (either package's).

    ``path`` is the run directory (or its ``trajectories/`` subdir).
    Returns ``(times, fields)`` — times an int64 array (T,), fields a dict
    of zero-copy ``np.memmap`` arrays shaped (T, M, ...)."""
    d = path if os.path.basename(os.path.normpath(path)) == "trajectories" \
        else os.path.join(path, "trajectories")
    with open(os.path.join(d, "index.json")) as f:
        idx = json.load(f)
    times = np.asarray(idx["times"], np.int64)
    fields = {}
    for name, spec in idx["fields"].items():
        shape = (len(times),) + tuple(spec["shape"])
        if len(times) == 0:
            fields[name] = np.empty(shape, np.dtype(spec["dtype"]))
            continue
        fields[name] = np.memmap(os.path.join(d, name + ".bin"),
                                 dtype=np.dtype(spec["dtype"]), mode="r",
                                 shape=shape)
    return times, fields


def _unstack(value):
    """Split a chain-stacked numpy tree into per-chain rows."""
    n = len(tree_leaves_with_path(value)[0][1])
    return [tree_map(lambda lf: lf[c], value) for c in range(n)]


# ---------------------------------------------------------------------------
# StoreLastFrames (ref ``src/algorithms.jl:221-251``)
# ---------------------------------------------------------------------------

class StoreLastFrames(Algorithm):
    """At finalise only, write ``trajectories/<c>/lastframe.dat`` per chain,
    with the line format of the system's ``format_frame``."""

    def __init__(self, sim, fmt: Format = DAT(), dependencies=(), **_):
        self.fmt = fmt
        self.system = sim.system
        self.dirs = [os.path.join(sim.path, "trajectories", str(c + 1))
                     for c in range(sim.n_chains)]

    def finalise(self, sim):
        if not sim.device_state:       # the run failed before it started
            return
        # a collective on a mesh: every rank gathers, rank 0 writes
        sys = fetch({"sys": sim.device_state["sys"]},
                    getattr(sim, "mesh", None))["sys"]
        if not _io_host(sim):
            return
        frames = to_numpy(self.system.frame(sys))
        t = int(sim.t)
        for d, row in zip(self.dirs, _unstack(frames)):
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "lastframe" + self.fmt.extension),
                      "w") as f:
                f.write(self.system.format_frame(t, row) + "\n")


# ---------------------------------------------------------------------------
# StoreBackups (ref ``src/algorithms.jl:264-303``), with a loader
# ---------------------------------------------------------------------------

class StoreBackups(ObservableRecorder):
    """Scheduled restart snapshots plus a restorable checkpoint.

    Per chain, ``trajectories/<c>/restart_t<t>.dat`` holds the frame in the
    system's ``format_frame`` line format, as the reference's; besides,
    ``checkpoints/ckpt_t<t>.npz`` holds the whole device state (chains,
    the chains' keys, counters, move parameters, PGMC
    accumulators, step), which
    :func:`montecarlo_tpu_torch.checkpoint.resume_state` loads to resume.
    Before the checkpoint is saved, every chain-major trajectory store of
    the run is committed (``StoreTrajectories.commit``), and at a step that
    both record the backup is written last, so a checkpoint at step t
    finds the records up to t on disk and listed in the manifest.
    """

    #: never folded into buffered chunks: ``write`` saves sim.device_state,
    #: which must be the state at the event, not at the end of a chunk
    buffered_ok = False

    def __init__(self, sim, fmt: Format = DAT(), store_first: bool = False,
                 store_last: bool = False, checkpoint: bool = True,
                 dependencies=(), **_):
        self.fmt = fmt
        self.store_first = store_first
        self.store_last = store_last
        self.checkpoint = checkpoint
        self.system = sim.system
        self.dirs = [os.path.join(sim.path, "trajectories", str(c + 1))
                     for c in range(sim.n_chains)]
        self.ckpt_dir = os.path.join(sim.path, "checkpoints")

    def initialise(self, sim):
        if not _io_host(sim):
            return
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)
        if self.checkpoint:
            os.makedirs(self.ckpt_dir, exist_ok=True)

    def observable(self, view: SimView):
        return self.system.frame(view.sys)

    def write(self, sim, t, value):
        t = int(t)
        if self.checkpoint:
            from .. import checkpoint as ckpt
            for alg in sim.algorithms:
                if isinstance(alg, StoreTrajectories):
                    alg.commit()
            # on a mesh a collective: every rank takes part, rank 0 writes
            ckpt.save(os.path.join(self.ckpt_dir, f"ckpt_t{t}.npz"),
                      sim.device_state, mesh=getattr(sim, "mesh", None))
        if not _io_host(sim):
            return
        for d, row in zip(self.dirs, _unstack(value)):
            path = os.path.join(d, f"restart_t{t}{self.fmt.extension}")
            with open(path, "w") as f:
                f.write(self.system.format_frame(t, row) + "\n")


# ---------------------------------------------------------------------------
# PrintTimeSteps (ref ``src/algorithms.jl:310-323``)
# ---------------------------------------------------------------------------

class PrintTimeSteps(HostAlgorithm):
    """ANSI progress bar."""

    def __init__(self, sim, dependencies=(), **_):
        pass

    def make_step(self, sim, t):
        if not _io_host(sim):
            return
        percent = t / sim.steps
        bar_length = 50
        filled = int(round(percent * bar_length))
        bar = ("\033[1;34m" + "■" * filled + "\033[0m"
               + "□" * (bar_length - filled))
        sys.stdout.write(f"\rProgress: [{bar}] {percent * 100:.0f}% t = {t}")
        sys.stdout.flush()
