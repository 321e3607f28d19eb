"""Swap Monte Carlo for a polydisperse glass-former, on the PyTorch port.

Port of ``examples/swap_mc_glass.py``.  Continuously polydisperse soft
spheres at low temperature: diameter-swap moves reach lower-energy
equilibrated states far faster than displacement-only dynamics.  Prints
the energy relaxation of both protocols from the same initial
configuration.

Run:  python examples/torch/swap_mc_glass.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import polydisperse as poly  # noqa: E402


def main(n=64, n_chains=32, rho=1.0, beta=5.0, steps=400, device=None,
         root="data/swap_glass"):
    p = poly.PolyParams()
    times = mc.build_schedule(steps, 0, 20)
    results = {}
    for label, swap in (("displacement only", False), ("with swap", True)):
        chains = poly.init_chains(n_chains, n, rho=rho, beta=beta, seed=5,
                                  params=p, device=device)
        if swap:
            pool = (poly.displacement_move(0.08, weight=0.8, params=p),
                    poly.swap_move(weight=0.2, params=p))
        else:
            pool = (poly.displacement_move(0.08, weight=1.0, params=p),)
        sim = mc.Simulation(
            poly.make_system(p), chains,
            [dict(algorithm=mc.Metropolis, pool=pool, sweepstep=n, seed=11),
             dict(algorithm=mc.StoreCallbacks,
                  callbacks=(poly.callback_energy_per_particle,),
                  scheduler=times)],
            steps, path=f"{root}/{swap}")
        sim.run()
        results[label] = np.loadtxt(
            f"{root}/{swap}/energy_per_particle.dat")

    print(f"polydisperse soft spheres: N={n}, rho={rho}, beta={beta}")
    print(f"{'t (sweeps)':>11} {'e/N (disp only)':>16} {'e/N (swap)':>11}")
    a, b = results["displacement only"], results["with swap"]
    for k in range(0, len(a), max(1, len(a) // 10)):
        print(f"{int(a[k, 0]):>11} {a[k, 1]:>16.4f} {b[k, 1]:>11.4f}")
    print(f"\nfinal: disp-only {a[-1, 1]:.4f}  vs  swap {b[-1, 1]:.4f} "
          "(swap equilibrates to the lower plateau first)")
    return results


if __name__ == "__main__":
    main()
