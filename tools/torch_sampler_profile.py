"""Where a keyed sampler's host time goes, on one GPU.

Runs in a fresh process on the package of a tree (this checkout by
default; ``--tree DIR`` names another, e.g. an earlier commit unpacked with
``git archive``) one of ``chip_smoke.py`` phase 14c's paths at its width:

- ``cell``: the cell path at 32 x N 32768 (LJ, one displacement move,
  ``fused='cell'``), segments of 2 steps (~28 substeps) through the
  algorithm's own advance;
- ``checkerboard``: the 2-D Ising checkerboard at 1024 x 64^2, 4 sweeps a
  step.

After a warm-up it times ``--reps`` calls from an idle card to an idle
card, then runs them again under ``cProfile`` and prints the functions
that took the most host time (``tottime``), and under ``torch.profiler``
the ops that took the most host time (``self_cpu_time_total``).

Prints the card's name and power limit, then one JSON line with the
wall a call and a substep (or a sweep).  Build the tree's kernels first
(any run of ``chip_smoke.py`` does).

Usage: python tools/torch_sampler_profile.py [--tree DIR] [--path cell]
       [--reps 5] [--top 25]
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--tree", default=root)
    parser.add_argument("--path", default="cell",
                        choices=("cell", "checkerboard"))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--top", type=int, default=25)
    opts = parser.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("torch_sampler_profile: no CUDA device", file=sys.stderr)
        return 1
    import montecarlo_tpu_torch as tmc
    from montecarlo_tpu_torch.models import ising2d
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from torch.profiler import ProfilerActivity, profile
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}; package {tmc.__file__}; path {opts.path}")

    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=root) as tmp:
        if opts.path == "cell":
            n = 32768
            chains = lj.init_chains(32, n, rho=1.2, beta=1.0 / 0.45,
                                    frac_b=0.2, seed=42, device=device)
            sim = tmc.Simulation(lj.make_system(), chains, [
                dict(algorithm=tmc.Metropolis,
                     pool=(lj.lj_displacement_move(0.08),), seed=42,
                     sweepstep=n // 4, fused="cell")], 2, path=tmp)
            met = sim.device_algos[0]
            per = met._cell_plan.nc ** 2 // 4
            box = {"ds": met.fused_advance(sim.init_device_state(), 1)}

            def call():
                box["ds"] = met.fused_advance(box["ds"], 2)

            def units():
                c = box["ds"]["metropolis"]["counters"][:, 0, 1]
                return float(c.double().mean()) / per
        else:
            chains = ising2d.init_chains(1024, 64, beta=0.44, seed=42,
                                         device=device)
            sim = tmc.Simulation(ising2d.make_system(), chains, [
                dict(algorithm=ising2d.CheckerboardMetropolis, sweeps=4,
                     seed=42)], 1, path=tmp)
            alg = sim.device_algos[0]
            box = {"ds": sim.init_device_state(), "t": 0}

            def call():
                box["t"] += 1
                box["ds"] = alg.step(box["ds"], box["t"])

            def units():
                return 4.0 * box["t"]

        call()
        torch.cuda.synchronize()
        u0 = units()
        t0 = time.perf_counter()
        for _ in range(opts.reps):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_units = units() - u0

        prof = cProfile.Profile()
        prof.enable()
        for _ in range(opts.reps):
            call()
        torch.cuda.synchronize()
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(
            opts.top)
        print(buf.getvalue())

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            call()
            torch.cuda.synchronize()
        print(tp.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=opts.top))
    unit = "substep" if opts.path == "cell" else "sweep"
    print(json.dumps({"path": opts.path, "wall_call_ms": wall / opts.reps
                      * 1e3, f"ms_a_{unit}": wall / n_units * 1e3,
                      "units": n_units}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
