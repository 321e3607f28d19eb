"""The proposal widths of the NPT glass protocol record, from its own
acceptances.

``benchmarks/glass_protocol_r05.json`` records the protocol's
configuration (N 2048, T 0.4, P 4.0, move weights 0.798 / 0.2 / 0.002, the
cell path, ~100 sweeps) and its physics (density 1.0 -> 0.9004, acceptance
per move 0.487 / 0.277 / 0.374) but not the displacement width sigma nor
the ln-V half-width dlnv.  This script runs the JAX package itself (the
reference, on the CPU, with fewer chains) over a grid of widths and prints
one JSON line per pair: acceptance per move and the final density, to read
off the widths the record was taken with.

Usage: JAX_PLATFORMS=cpu python tools/glass_protocol_widths.py
       [--chains 8] [--sigma 0.08 ...] [--dlnv 0.002 ...]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def run(sigma, dlnv, chains, root):
    import montecarlo_tpu as mc
    from montecarlo_tpu.models import polydisperse as poly
    n = 2048
    state = poly.init_chains(chains, n, rho=1.0, beta=1.0 / 0.4, seed=42)
    pool = (poly.displacement_move(sigma, weight=0.798),
            poly.swap_move(weight=0.2),
            poly.volume_move(dlnv=dlnv, pressure=4.0, weight=0.002))
    sim = mc.Simulation(poly.make_system(), state, [
        dict(algorithm=mc.Metropolis, pool=pool, seed=11, sweepstep=n // 4)],
        400, path=os.path.join(root, f"s{sigma}_v{dlnv}"))
    t0 = time.perf_counter()
    sim.run()
    cnt = np.asarray(sim.device_state["metropolis"]["counters"]).sum(0)
    box = np.asarray(sim.device_state["sys"].box, np.float64)
    return {"sigma": sigma, "dlnv": dlnv, "chains": chains,
            "acceptance": (cnt[:, 0] / cnt[:, 1]).tolist(),
            "attempts": cnt[:, 1].tolist(),
            "density": float(np.mean(n / box ** 2)),
            "wall_s": time.perf_counter() - t0}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chains", type=int, default=8)
    parser.add_argument("--sigma", type=float, nargs="+", default=[0.08])
    parser.add_argument("--dlnv", type=float, nargs="+",
                        default=[0.002, 0.01, 0.02, 0.03])
    opts = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as root:
        for sigma in opts.sigma:
            for dlnv in opts.dlnv:
                print(json.dumps(run(sigma, dlnv, opts.chains, root)),
                      flush=True)


if __name__ == "__main__":
    main()
