"""Soft-potential event-chain MC on the 2-D Lennard-Jones fluid, on the
PyTorch port.

Port of ``examples/ecmc_lj.py``: the factorized-Metropolis event chain
(``models/lennard_jones.ecmc_model``) beside local Metropolis on the same
system, with three routes to the pressure: the MKK lifting-event
estimator of the event chain, and the virial average of each trajectory.

Run:  python examples/torch/ecmc_lj.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import lennard_jones as lj  # noqa: E402

RHO, BETA, ELL = 0.6, 1.0, 1.5


def run(kind, path, n, n_chains, steps, params, device):
    chains = lj.init_chains(n_chains, n, rho=RHO, beta=BETA, frac_b=0.0,
                            seed=1, params=params, device=device)
    if kind == "ecmc":
        algo = dict(algorithm=mc.EventChain,
                    model=lj.ecmc_model(ELL, params=params),
                    events_per_step=8, seed=2)
    else:
        algo = dict(algorithm=mc.Metropolis,
                    pool=(lj.lj_displacement_move(0.25, params=params),),
                    seed=3, sweepstep=n)

    def callback_pressure(view):
        return lj.callback_pressure(view, params)

    sim = mc.Simulation(lj.make_system(params), chains, [
        algo,
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle, callback_pressure),
             scheduler=np.arange(5, steps + 1, 5)),
    ], steps, path=path)
    sim.run()
    return sim, np.loadtxt(os.path.join(path, "energy_per_particle.dat"))


def main(n=64, n_chains=64, steps=200, device=None, root="data/ecmc_lj"):
    params = lj.LJParams()
    sim_e, e_ecmc = run("ecmc", f"{root}/ecmc", n, n_chains, steps, params,
                        device)
    sim_m, e_met = run("met", f"{root}/met", n, n_chains, steps, params,
                       device)
    tail = lambda d: d[d[:, 0] > steps // 2, 1]
    print(f"e/N   ECMC {tail(e_ecmc).mean():+.4f}  "
          f"Metropolis {tail(e_met).mean():+.4f}")

    stats = sim_e.device_state["ecmc"]["stats"]
    excess = float(stats["excess"].double().sum())
    nch = float(stats["chains"].double().sum())
    p_mkk = 1.0 + excess / (nch * ELL)
    out = {"mkk": p_mkk}
    for name, sim in (("ECMC", sim_e), ("Metropolis", sim_m)):
        pv = float(lj.virial_pressure(sim.device_state["sys"], params).mean())
        out[name] = pv * BETA / RHO
        print(f"beta P / rho ({name} virial): {pv * BETA / RHO:.3f}")
    print(f"beta P / rho (MKK lifting events): {p_mkk:.3f}")
    print(f"lifting events: {int(stats['collisions'].sum())} (cap_hits "
          f"{int(stats['cap_hits'].sum())})")
    return out


if __name__ == "__main__":
    main()
