"""2-D Ising sweep across the phase transition with checkerboard
Metropolis, on the PyTorch port.

Port of ``examples/ising2d_checkerboard.py``: a temperature scan around
beta_c = ln(1 + sqrt(2)) / 2 ~ 0.4407 on a 64x64 periodic lattice,
printing the energy per spin and |m|.  Each simulation step is a
whole-lattice bipartite sweep: 4096 Metropolis attempts a chain in a few
(chains, 64, 64) tensor operations.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import ising2d  # noqa: E402


def main(size=64, n_chains=64, steps=3000, burn=1000,
         betas=(0.30, 0.38, 0.42, 0.4407, 0.46, 0.55), device=None,
         root="data"):
    print(f"{'beta':>6} {'e/spin':>8} {'|m|':>6}   (L={size}, {n_chains} "
          f"chains)")
    out = {}
    for beta in betas:
        chains = ising2d.init_chains(n_chains, size, beta=beta, seed=42,
                                     device=device)
        path = f"{root}/ising2d_b{beta}"
        sim = mc.Simulation(
            ising2d.make_system(), chains,
            [dict(algorithm=ising2d.CheckerboardMetropolis, seed=42),
             dict(algorithm=mc.StoreCallbacks,
                  callbacks=[ising2d.callback_energy_per_spin,
                             ising2d.callback_magnetisation],
                  scheduler=mc.build_schedule(steps, burn, 10))],
            steps, path=path)
        sim.run()
        e = np.loadtxt(f"{path}/energy_per_spin.dat")[:, 1]
        m = np.loadtxt(f"{path}/magnetisation.dat")[:, 1]
        out[beta] = (e.mean(), m.mean())
        print(f"{beta:6.4f} {e.mean():8.4f} {m.mean():6.3f}")
    return out


if __name__ == "__main__":
    main()
