"""2-D Lennard-Jones mixture on the PyTorch port: displacement + swap pool,
optional PGMC adaptation, optional chain mesh.

Port of ``examples/lj_2d.py`` (BASELINE configs 4-5): local displacement
moves with O(N) incremental delta-energies and a species-swap move for the
binary mixture, both on the hand-written CUDA kernel on the card, PGMC
adaptation of the displacement width, and with ``use_mesh`` the chains
split over the ``torch.distributed`` ranks of an initialised process group
(``montecarlo_tpu_torch.parallel``).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch import policy_guided as pg  # noqa: E402
from montecarlo_tpu_torch.models import lennard_jones as lj  # noqa: E402
from montecarlo_tpu_torch.parallel import make_mesh  # noqa: E402


def main(n_chains=64, n_particles=256, rho=0.7, beta=1.0, steps=2000,
         use_mesh=False, pgmc=True, device=None, root="data/LJ2D"):
    seed = 42
    params = lj.LJParams()
    system = lj.make_system(params)
    chains = lj.init_chains(n_chains, n_particles, rho, beta, frac_b=0.2,
                            seed=seed, params=params, device=device)
    pool = (
        lj.lj_displacement_move(sigma=0.1, weight=0.8, params=params),
        lj.lj_swap_move(weight=0.2, params=params),
    )
    burn = steps // 10
    sampletimes = mc.build_schedule(steps, burn, [0, 10])
    path = f"{root}/N{n_particles}/rho{rho}/beta{beta}/M{n_chains}"

    algorithm_list = [
        # sweepstep=N: one "sweep" attempts N moves, like particle MC usage
        dict(algorithm=mc.Metropolis, pool=pool, seed=seed,
             sweepstep=n_particles),
    ]
    if pgmc:
        algorithm_list += [
            dict(algorithm=pg.PolicyGradientEstimator,
                 dependencies=(mc.Metropolis,),
                 optimisers=(pg.VPG(1e-4), pg.Static()), q_batch_size=4),
            dict(algorithm=pg.PolicyGradientUpdate,
                 dependencies=(pg.PolicyGradientEstimator,),
                 scheduler=mc.build_schedule(steps, burn, 2)),
            dict(algorithm=mc.StoreParameters,
                 dependencies=(mc.Metropolis,), scheduler=sampletimes),
        ]
    algorithm_list += [
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,
                        mc.callback_acceptance),
             scheduler=sampletimes),
        dict(algorithm=mc.StoreLastFrames, scheduler=np.asarray([steps])),
    ]
    mesh = make_mesh(device) if use_mesh else None
    sim = mc.Simulation(system, chains, algorithm_list, steps, path=path,
                        verbose=True, mesh=mesh)
    sim.run()

    e = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    print(f"\nenergy/particle: start {e[0, 1]:.4f} -> end {e[-1, 1]:.4f}")
    a = np.loadtxt(os.path.join(path, "acceptance.dat"))
    print(f"acceptance: {a[-1, 1]:.3f}")
    return {"path": path, "energy": e, "acceptance": a[-1, 1]}


if __name__ == "__main__":
    main()
