"""One rank of the port's two-process tests (``tests/test_torch_mesh.py``).

Usage: python _torch_mesh_worker.py <rank> <world> <port> <outdir>

Joins a ``gloo`` group of ``world`` ranks on ``localhost:<port>``, builds a
mesh with its chains on the CPU, and runs each scenario of the tests in
turn: the reference's multihost configuration (harmonic chains on the
fused path's plain version), the generic path with PGMC, an LJ and a poly
pool on the fused path, a cell-path pool with and without a forced
overflow on rank 1, a run resumed from its checkpoint, replica
exchange across the ranks' boundary, and a lattice driver, event-chain MC
and the cell path, each cut by a backup.  Simulations
write under ``<outdir>/runs``; each rank leaves what the tests compare
under ``<outdir>/results/rank<r>``.  Off rank 0, every attempt to create or
write a file under ``<outdir>/runs`` is recorded, and the list saved.
"""

import builtins
import json
import os
import sys
import warnings

import numpy as np

rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4])
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import montecarlo_tpu_torch as tmc  # noqa: E402
from montecarlo_tpu_torch import checkpoint, interop  # noqa: E402
from montecarlo_tpu_torch.models import lennard_jones as lj  # noqa: E402
from montecarlo_tpu_torch.models import particle1d as p1d  # noqa: E402
from montecarlo_tpu_torch.models import polydisperse as poly  # noqa: E402
from montecarlo_tpu_torch.ops import cell_mc  # noqa: E402
from montecarlo_tpu_torch.parallel import fetch, initialize, make_mesh  # noqa: E402
from torch_mesh_helpers import (REF_STEPS, SAMPLER_BACKUP,  # noqa: E402
                                 pgmc_sim, reference_algorithms,
                                 sampler_sim, state_arrays, tempering_sim)

RUNS = os.path.join(outdir, "runs")
RESULTS = os.path.join(outdir, "results", f"rank{rank}")
torch.set_num_threads(1)

# -- every file a rank other than 0 opens for writing under RUNS -----------------
violations = []


def _guard(fn, kind):
    def wrapped(path, *args, **kw):
        p = os.path.abspath(os.fspath(path)) if isinstance(
            path, (str, os.PathLike)) else ""
        mode = args[0] if args else kw.get("mode", "r")
        writes = kind != "open" or any(c in str(mode) for c in "wax+")
        if p.startswith(os.path.abspath(RUNS)) and writes:
            violations.append(f"{kind} {p}")
        return fn(path, *args, **kw)
    return wrapped


if rank != 0:
    builtins.open = _guard(builtins.open, "open")
    os.makedirs = _guard(os.makedirs, "makedirs")
    os.replace = _guard(os.replace, "replace")
    np.savez = _guard(np.savez, "savez")


def save(name, **arrays):
    os.makedirs(RESULTS, exist_ok=True)
    np.savez(os.path.join(RESULTS, name + ".npz"), **arrays)


# -- the scenarios ---------------------------------------------------------------

def reference_config(mesh):
    """tests/_multihost_worker.py's configuration, from the reference's
    chains, on the fused path's plain version, plus a profiler trace."""
    with np.load(os.path.join(outdir, "ref_chains.npz")) as f:
        chains = interop.chains_from_reference(dict(f), device="cpu")
    algos = reference_algorithms(tmc, p1d, fused="interpret") + [
        dict(algorithm=tmc.ProfilerTrace, scheduler=np.asarray([20, 40]))]
    tmc.Simulation(p1d.make_system(p1d.harmonic), chains, algos, REF_STEPS,
                   path=os.path.join(RUNS, "reference"), mesh=mesh).run()


def pgmc(mesh):
    sim = pgmc_sim(os.path.join(RUNS, "pgmc"), mesh)
    sim.run()
    save("pgmc", **state_arrays(sim.device_state))


def particles(mesh):
    """An LJ mixed pool and a poly pool on the fused path's plain version;
    rank 0 keeps the gathered final chains."""
    for name, mod, chains, pool in (
            ("lj", lj,
             lj.init_chains(4, 32, rho=1.0, beta=1.0, frac_b=0.2, seed=3,
                            device="cpu"),
             (lj.lj_displacement_move(0.1, weight=0.8),
              lj.lj_swap_move(weight=0.2))),
            ("poly", poly,
             poly.init_chains(4, 32, rho=0.9, beta=2.0, seed=4,
                              device="cpu"),
             (poly.displacement_move(0.1, weight=0.8),
              poly.swap_move(weight=0.2)))):
        sim = tmc.Simulation(mod.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, pool=pool, seed=7, sweepstep=32,
                 fused="interpret"),
            dict(algorithm=tmc.StoreCallbacks,
                 callbacks=(mod.callback_energy_per_particle,
                            tmc.callback_acceptance),
                 scheduler=np.arange(2, 9, 2)),
            dict(algorithm=tmc.StoreLastFrames),
        ], 8, path=os.path.join(RUNS, name), mesh=mesh)
        sim.run()
        whole = fetch(sim.device_state, mesh)
        if rank == 0:
            save(name, **state_arrays(whole))


def cell(mesh):
    """A cell-path pool under 'auto' (N 2048, one chain a rank): the plan
    each rank made; then the same run with rank 1's segments flagging an
    overflow: every rank must fall back."""
    chains = lj.init_chains(2, 2048, rho=1.0, beta=1.0, seed=33,
                            device="cpu")

    def build(path):
        return tmc.Simulation(lj.make_system(), chains, [
            dict(algorithm=tmc.Metropolis,
                 pool=(lj.lj_displacement_move(0.08),), seed=1, sweepstep=4),
            dict(algorithm=tmc.StoreCallbacks,
                 callbacks=(lj.callback_energy_per_particle,),
                 scheduler=np.arange(1, 5)),
        ], 4, path=path, mesh=mesh)

    sim = build(os.path.join(RUNS, "cell"))
    met = sim.device_algos[0]
    use_cell = met._use_cell
    sim.run()
    out = {"plan": repr(met._cell_plan), "use_cell": bool(use_cell),
           "overflow": bool(sim.device_state["metropolis"]["cell_overflow"])}

    segment = cell_mc.cell_mc_segment
    if rank == 1:
        def overflowing(*args, **kw):
            res = segment(*args, **kw)
            return res[:-1] + (torch.ones_like(res[-1]),)
        cell_mc.cell_mc_segment = overflowing
    sim = build(os.path.join(RUNS, "cell_overflow"))
    met = sim.device_algos[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim.run()
    cell_mc.cell_mc_segment = segment
    out.update(fell_back=bool(met._cell_disabled), t=int(sim.t),
               warned=any("falling back" in str(w.message) for w in caught),
               attempts=sim.device_state["metropolis"]["counters"][
                   :, 0, 1].tolist())
    with open(os.path.join(RESULTS, "cell.json"), "w") as f:
        json.dump(out, f)


def resume(mesh):
    """A PGMC run with a backup at step 20, and a fresh run resumed from
    that backup; rank 0 keeps both gathered final states, each rank whether
    its own slice of the chains' keys came back."""
    whole = pgmc_sim(os.path.join(RUNS, "uncut"), mesh, backups=[20])
    whole.run()
    resumed = pgmc_sim(os.path.join(RUNS, "resumed"), mesh)
    checkpoint.resume_state(
        resumed, os.path.join(RUNS, "uncut", "checkpoints", "ckpt_t20.npz"))
    resumed.run()
    a = fetch(whole.device_state, mesh)
    b = fetch(resumed.device_state, mesh)
    keys = [torch.equal(whole.device_state[k]["keys"],
                        resumed.device_state[k]["keys"])
            for k in ("metropolis", "pge")]
    if rank == 0:
        save("resume_uncut", **state_arrays(a))
        save("resume_resumed", **state_arrays(b))
    save("resume_keys", equal=np.asarray(keys),
         rows=np.asarray(whole.device_state["metropolis"]["keys"].shape[0]))


def tempering(mesh):
    """Replica exchange with and without the generic path's moves; each
    rank keeps its own final slice, rank 0 the gathered swap-only run."""
    for name, metropolis in (("tempering", True), ("swaps", False)):
        sim = tempering_sim(os.path.join(RUNS, name), mesh, metropolis)
        sim.run()
        save(name, **state_arrays(sim.device_state))
        whole = fetch(sim.device_state, mesh)
        if rank == 0:
            save(name + "_whole", **state_arrays(whole))


def samplers(mesh):
    """The lattice driver, event-chain MC and the cell path on two ranks,
    each with a backup: rank 0 keeps each gathered final state; the
    checkpoints stay under ``runs/sampler_<name>``."""
    for name in ("lattice", "ecmc", "cell"):
        sim = sampler_sim(name, os.path.join(RUNS, f"sampler_{name}"), mesh,
                          backups=[SAMPLER_BACKUP])
        sim.run()
        whole = fetch(sim.device_state, mesh)
        if rank == 0:
            save(f"sampler_{name}", **state_arrays(whole))


def main():
    initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, "gloo")
        os.makedirs(RESULTS, exist_ok=True)
        for scenario in (reference_config, pgmc, particles, cell, resume,
                         tempering, samplers):
            scenario(mesh)
            print(f"rank {rank}: {scenario.__name__} done", flush=True)
        save("violations", paths=np.asarray(violations, dtype=str))
        with open(os.path.join(RESULTS, "counts.json"), "w") as f:
            json.dump(mesh.counts, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
