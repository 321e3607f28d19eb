"""Parallel tempering on the double well, on the PyTorch port.

Port of ``examples/parallel_tempering.py``.  At beta = 6 a walker with
local displacement moves stays in one well of U(x) = (x^2 - 1)^2 for a
long time; replica exchange against hotter replicas restores mixing.  The
script runs the same cold ensemble with and without exchange and prints
the well hops per chain and the well occupancies: with exchange the cold
replicas split ~50/50 between the wells, without it they stay where they
started.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import particle1d as p1d  # noqa: E402

BETAS = [0.5, 1.0, 2.0, 6.0]   # replica 3 (coldest) is the one we care about


def run(with_exchange, path, n_ladders, steps, device):
    t = len(BETAS)
    betas = mc.tile_ladder(BETAS, n_ladders, device=device)
    chains = p1d.init_chains(t * n_ladders, beta=betas, seed=42,
                             potential=p1d.double_well, device=device)
    algos = [dict(algorithm=mc.Metropolis,
                  pool=(p1d.displacement_move(sigma=0.3,
                                              potential=p1d.double_well),),
                  seed=42)]
    if with_exchange:
        algos.append(dict(algorithm=mc.ReplicaExchange, n_temps=t, seed=7,
                          scheduler=mc.build_schedule(steps, 0, 10)))
    algos.append(dict(algorithm=mc.StoreTrajectories,
                      scheduler=mc.build_schedule(steps, 0, 100)))
    sim = mc.Simulation(p1d.make_system(p1d.double_well), chains, algos,
                        steps, path=path)
    sim.run()

    # the coldest replicas are chains t-1, 2t-1, ...
    hops, frac_right = [], []
    for c in range(t - 1, t * n_ladders, t):
        xs = np.loadtxt(os.path.join(path, "trajectories", str(c + 1),
                                     "trajectory.dat"))[:, 1]
        side = np.sign(xs[np.abs(xs) > 0.3])
        hops.append(int(np.sum(side[1:] != side[:-1])))
        frac_right.append(float(np.mean(xs > 0)))
    return np.mean(hops), np.mean(frac_right), np.std(frac_right)


def main(n_ladders=128, steps=20_000, device=None, root="data"):
    out = {}
    for label, flag, path in (("without exchange", False, f"{root}/pt_off"),
                              ("with exchange", True, f"{root}/pt_on")):
        hops, frac, spread = run(flag, path, n_ladders, steps, device)
        out[flag] = (hops, frac, spread)
        print(f"{label:>18}: well hops/chain = {hops:6.1f}, "
              f"P(x>0) = {frac:.3f} +- {spread:.3f}")
    return out


if __name__ == "__main__":
    main()
