"""Large-N Lennard-Jones via checkerboard cell-list MC, on the PyTorch port.

Port of ``examples/cell_mc_large_n.py``.  Beyond N ~ 2000 particles the
engine can switch to checkerboard cell-list MC (``ops/cell_mc.py``):
4-colored cells, one uniformly-picked occupant of every same-color cell
moves at once, each move touching only its 3x3 cell neighbourhood.  On the
CPU ``Metropolis(fused='auto')`` takes it for a single-displacement pool
from N = 2048; on the card the LJ row kernel keeps the pools it holds (up
to 19,114 particles) and the cell path takes the larger ones.  The script
runs N = 4096 and checks the energy cache against a full recompute.

Run:  python examples/torch/cell_mc_large_n.py [n_particles] [n_chains]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import lennard_jones as lj  # noqa: E402
from montecarlo_tpu_torch.utils.tree import tree_map  # noqa: E402


def main(n_particles=4096, n_chains=32, steps=40, device=None,
         path="data/cell_mc_large_n"):
    params = lj.LJParams()
    chains = lj.init_chains(n_chains, n_particles, rho=1.2, beta=1.0 / 0.45,
                            frac_b=0.2, seed=42, params=params, device=device)
    pool = (lj.lj_displacement_move(0.08, params=params),)
    sim = mc.Simulation(
        lj.make_system(params), chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=7,
              sweepstep=n_particles // 4),
         dict(algorithm=mc.StoreCallbacks,
              callbacks=(lj.callback_energy_per_particle,),
              scheduler=np.arange(5, steps + 1, 5))],
        steps, path=path, verbose=True)
    met = sim.device_algos[0]
    print(f"N={n_particles}, chains={n_chains}: cell path selected = "
          f"{met._use_cell} (plan: {met._cell_plan!r})")
    sim.run()

    slc = sim.device_state["metropolis"]
    cnt = slc["counters"].cpu().numpy()
    acc = cnt[:, 0, 0].sum() / cnt[:, 0, 1].sum()
    print(f"attempts/chain: {cnt[0, 0, 1]}, acceptance: {acc:.3f}, "
          f"capacity overflow: {bool(slc.get('cell_overflow', False))}")

    st4 = tree_map(lambda a: a[:4], sim.device_state["sys"])
    e_true = lj.total_energy(st4, params, row_batch=256).cpu().numpy()
    err = np.abs((st4.energy.cpu().numpy() - e_true) / e_true).max()
    print(f"energy cache vs full recompute (4 chains): rel err {err:.2e}")
    return {"use_cell": met._use_cell, "acceptance": acc, "rel_err": err}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096,
         int(sys.argv[2]) if len(sys.argv) > 2 else 32)
