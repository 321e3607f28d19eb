"""Configurations shared by the port's multi-process tests and their
one-process emulations (``tests/test_torch_mesh.py``,
``tests/_torch_mesh_worker.py``).  Imports nothing of JAX: the worker
processes run without it."""

import numpy as np
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import policy_guided as pg
from montecarlo_tpu_torch.models import particle1d as p1d
from montecarlo_tpu_torch.utils.tree import tree_leaves_with_path

REF_STEPS = 60


def reference_algorithms(pkg, mod, fused):
    """``tests/_multihost_worker.py``'s algorithm list in package ``pkg``
    (either package) with particle-1d module ``mod``."""
    times = pkg.build_schedule(REF_STEPS, 10, 10)
    return [
        dict(algorithm=pkg.Metropolis, pool=(mod.displacement_move(0.5),),
             seed=42, fused=fused),
        dict(algorithm=pkg.StoreCallbacks,
             callbacks=(mod.callback_energy, pkg.callback_acceptance),
             scheduler=times),
        dict(algorithm=pkg.StoreTrajectories, scheduler=times),
        dict(algorithm=pkg.StoreBackups, scheduler=np.asarray([30])),
        dict(algorithm=pkg.StoreParameters, dependencies=(pkg.Metropolis,),
             scheduler=times),
        dict(algorithm=pkg.Throughput, scheduler=times),
    ]


PGMC_STEPS = 40


def pgmc_sim(path, mesh, backups=()):
    """16 harmonic chains on the generic path with PGMC: VPG on the second
    of two displacement moves, the estimator every 2 steps (q 2), the
    update every 10, parameters recorded at each update."""
    chains = p1d.init_chains(16, beta=2.0, seed=42, device="cpu")
    pool = (p1d.displacement_move(sigma=0.2, weight=0.5),
            p1d.displacement_move(sigma=0.2, weight=0.5))
    steps = PGMC_STEPS
    algos = [
        dict(algorithm=tmc.Metropolis, pool=pool, seed=42, fused="off"),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(tmc.Metropolis,),
             optimisers=(pg.Static(), pg.VPG(0.05)), q_batch_size=2,
             scheduler=np.arange(2, steps + 1, 2)),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(10, steps + 1, 10)),
        dict(algorithm=tmc.StoreParameters, dependencies=(tmc.Metropolis,),
             scheduler=np.arange(10, steps + 1, 10)),
    ]
    if len(backups):
        algos.append(dict(algorithm=tmc.StoreBackups,
                          scheduler=np.asarray(backups)))
    return tmc.Simulation(p1d.make_system(p1d.harmonic), chains, algos,
                          steps, path=path, mesh=mesh)


def state_arrays(ds):
    """The tensors of a device-state tree as numpy arrays, by path."""
    return {"/".join(str(k) for k in path): leaf.detach().cpu().numpy()
            for path, leaf in tree_leaves_with_path(ds)
            if torch.is_tensor(leaf)}


TEMPERING_STEPS = 30


def tempering_sim(path, mesh, metropolis=True):
    """Replica exchange on 12 chains in ladders of 4 (the middle ladder
    straddles the boundary of two ranks), a swap every 3 steps, after the
    generic path's harmonic moves (or alone: then every rank count gives
    the same chains)."""
    chains = p1d.init_chains(12, beta=tmc.tile_ladder([0.5, 1.0, 2.0, 4.0],
                                                      3, device="cpu"),
                             seed=5, device="cpu")
    algos = [dict(algorithm=tmc.ReplicaExchange, n_temps=4, seed=9,
                  scheduler=np.arange(3, TEMPERING_STEPS + 1, 3)),
             dict(algorithm=tmc.StoreCallbacks,
                  callbacks=(tmc.callback_swap_rate,),
                  scheduler=np.arange(3, TEMPERING_STEPS + 1, 3))]
    if metropolis:
        algos.insert(0, dict(algorithm=tmc.Metropolis,
                             pool=(p1d.displacement_move(sigma=1.0),),
                             seed=8, fused="off"))
    return tmc.Simulation(p1d.make_system(p1d.harmonic), chains, algos,
                          TEMPERING_STEPS, path=path, mesh=mesh)


SAMPLER_STEPS, SAMPLER_BACKUP = 8, 4


def sampler_sim(name, path, mesh, backups=()):
    """One of the samplers whose streams are per-chain keys, on 4 chains:
    ``"lattice"`` the 2-D Ising Wolff sampler (two flips a step),
    ``"ecmc"`` event-chain MC on LJ (the soft hook: its loop splits a key
    each iteration), ``"cell"`` the 2-D LJ cell path (``fused='cell'``);
    a backup at each step of ``backups``."""
    from montecarlo_tpu_torch.models import ising2d
    from montecarlo_tpu_torch.models import lennard_jones as lj

    if name == "lattice":
        system = ising2d.make_system()
        chains = ising2d.init_chains(4, 6, 0.44, seed=3, device="cpu")
        algos = [dict(algorithm=ising2d.WolffCluster, clusters=2, seed=5)]
    elif name == "ecmc":
        system = lj.make_system()
        chains = lj.init_chains(4, 20, 0.7, 1.0, frac_b=0.2, seed=5,
                                device="cpu")
        algos = [dict(algorithm=tmc.EventChain, model=lj.ecmc_model(1.5),
                      events_per_step=2, seed=11)]
    else:
        system = lj.make_system()
        chains = lj.init_chains(4, 512, rho=1.0, beta=1.0, frac_b=0.2,
                                seed=6, device="cpu")
        algos = [dict(algorithm=tmc.Metropolis,
                      pool=(lj.lj_displacement_move(0.1, weight=0.8),
                            lj.lj_swap_move(weight=0.2)),
                      seed=3, sweepstep=64, fused="cell")]
    if len(backups):
        algos.append(dict(algorithm=tmc.StoreBackups,
                          scheduler=np.asarray(backups)))
    return tmc.Simulation(system, chains, algos, SAMPLER_STEPS, path=path,
                          mesh=mesh)
