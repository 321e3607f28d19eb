"""Small sizes at which the CPU tests drive a cell: the row kernels'
plain versions (``fused='interpret'``) on the CPU, every chain sampled."""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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

SMALL = {
    "harmonic1d.fine": (dict(chains=64, stride=4, check_chains=64), 6),
    "ka2d.n1024.swap": (dict(chains=8, n_particles=64, stride=2,
                             sweepstep=64, check_chains=8), 4),
}


def run_small(name, seed=2 ** 33 + 5, control=False, **more):
    overrides, periods = SMALL[name]
    # the row kernels' plain versions
    return run.run_cell(name, seed, 1, 0, device="cpu", fused="interpret",
                        overrides=dict(overrides, **more), periods=periods,
                        t_start=time.perf_counter(), control=control)


def judged(name, result, checks="checks"):
    limits = spec.workload(name)["limits"]
    return run.judge(dict(result, checks=result[checks]), limits)
