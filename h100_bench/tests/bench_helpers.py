"""Small sizes at which the CPU tests drive a cell, and the faults that
break a configuration's timed path, each in a file of its own so that a
new cell or configuration needs no edit here:

- ``small/<cell>.json``: the workload's ``overrides``, the window's
  ``periods`` and ``fused``, the path the CPU drives the cell on
  (``'interpret'``: the row kernels' plain versions; ``'cell'``: the cell
  path); every chain sampled;
- ``faults/<config>.py``: ``FAULTS``, each fault's ``(module, attribute,
  wrapper)`` (:func:`faults`)."""

import dataclasses
import importlib.util
import json
import os
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
HERE = os.path.dirname(TESTS)
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

import run  # noqa: E402
from harness import spec  # noqa: E402

# the test workers share the cores: one thread each, or torch's pools
# oversubscribe them many times over
torch.set_num_threads(1)


def small_path(cell):
    return os.path.join(TESTS, "small", cell + ".json")


def _small(cell):
    with open(small_path(cell)) as f:
        return json.load(f)


#: every ``small/<cell>.json``, by cell
SMALL = {f[:-len(".json")]: _small(f[:-len(".json")])
         for f in sorted(os.listdir(os.path.join(TESTS, "small")))
         if f.endswith(".json")}


def run_small(name, seed=2 ** 33 + 5, control=False, trace=0, **more):
    s = SMALL[name]
    return run.run_cell(name, seed, 1, trace, device="cpu",
                        fused=s["fused"],
                        overrides=dict(s["overrides"], **more),
                        periods=s["periods"], t_start=time.perf_counter(),
                        control=control)


def judged(name, result, checks="checks"):
    limits = spec.workload(name)["limits"]
    return run.judge(dict(result, checks=result[checks]), limits)


def faults(config):
    """``FAULTS`` of ``faults/<config>.py``: ``unchanged`` (a step that
    returns its state unchanged), ``half_batch`` (half of the batch left
    out, the mean taken over the rest) and ``altered`` (an answer altered
    where it is produced), each ``(module, attribute, wrapper)``: the
    test sets ``module.attribute`` to ``wrapper(module.attribute)``."""
    s = importlib.util.spec_from_file_location(
        f"h100_bench_faults_{config.replace('.', '_')}",
        os.path.join(TESTS, "faults", config + ".py"))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.FAULTS


def half_mean(real):
    """A callback that sees the first half of the chains only, so its mean
    is taken over the rest."""
    def callback(view):
        half = dataclasses.replace(view.sys, **{
            f.name: getattr(view.sys, f.name)[: view.sys.beta.shape[0] // 2]
            for f in dataclasses.fields(view.sys)})
        return real(dataclasses.replace(view, sys=half))
    callback.__name__ = real.__name__
    return callback
