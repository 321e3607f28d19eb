"""Host time of the PyTorch port's generic Metropolis path on one GPU.

Runs in a fresh process, on the package of a tree (this checkout by
default; ``--tree DIR`` names another, e.g. an earlier commit unpacked with
``git archive``), at config 2's width (10^4 harmonic chains, one Gaussian
displacement move, ``fused='off'``):

- the process's first ``Simulation.run`` of 20 steps, and a second one;
- ``Metropolis.step`` alone, ms a step over 200 steps;
- the host time of one call of each random draw a step makes (``prng``'s
  ``fold_in``, ``split``, ``normal`` and ``uniform`` where the tree has
  ``utils/prng.py``, and ``split_uniform`` at the LJ event loop's 64 x
  64 where it has that; else ``torch.randn`` and ``torch.rand`` from a
  generator), over 500 calls with no sync inside.

Prints the card's name and power limit, then one JSON line.  Build the
tree's kernels first (any run of ``chip_smoke.py`` does), or the first run
holds the nvcc build.

Usage: python tools/torch_generic_step.py [--tree DIR]
"""

import argparse
import json
import os
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
    tree = os.path.abspath(parser.parse_args().tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("torch_generic_step: no CUDA device", file=sys.stderr)
        return 1
    import montecarlo_tpu_torch as tmc
    from montecarlo_tpu_torch.models import particle1d as p1d
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}; package {tmc.__file__}")
    torch.zeros(1, device=device)
    torch.cuda.synchronize()

    def simulation(path, steps):
        return tmc.Simulation(
            p1d.make_system(p1d.harmonic),
            p1d.init_chains(10 ** 4, beta=2.0, seed=42, device=device),
            [dict(algorithm=tmc.Metropolis,
                  pool=(p1d.displacement_move(sigma=0.5),), seed=42,
                  fused="off")], steps, path=path)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {}
    # the runs' files go inside the checkout (.gitignore lists the prefix)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=root) as tmp:
        for label in ("first_run_s", "second_run_s"):
            out[label] = timed(simulation(os.path.join(tmp, label), 20).run)
        sim = simulation(os.path.join(tmp, "c"), 10)
        met = sim.device_algos[0]
        ds = sim.init_device_state()
        for t in range(1, 21):
            ds = met.step(ds, t)

        def steps():
            d = ds
            for t in range(21, 221):
                d = met.step(d, t)

        out["step_ms"] = timed(steps) / 200 * 1e3

    try:
        from montecarlo_tpu_torch.utils import prng
    except ImportError:
        prng = None
    if prng is not None:
        keys = prng.split(prng.key(1, device), 10 ** 4)
        draws = {"fold_in": lambda: prng.fold_in(keys, 5),
                 "split3": lambda: prng.split(keys, 3),
                 "normal": lambda: prng.normal(keys),
                 "uniform": lambda: prng.uniform(keys)}
        if hasattr(prng, "split_uniform"):
            # the soft-potential event loop's draw: 64 chains x N 64
            loop = keys[:64]
            draws["split_uniform_64x64"] = lambda: prng.split_uniform(
                loop, (64,))
    else:
        gen = torch.Generator(device=device).manual_seed(1)
        draws = {"randn": lambda: torch.randn(10 ** 4, generator=gen,
                                              device=device),
                 "rand": lambda: torch.rand(10 ** 4, generator=gen,
                                            device=device)}
    for name, fn in draws.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        out[f"{name}_host_us"] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
