"""Event-chain Monte Carlo for 2-D hard disks, on the PyTorch port: the
equation of state.

Port of ``examples/ecmc_hard_disks.py``.  Straight event chains are
rejection-free and non-reversible; the pressure comes from the chain-span
estimator beta P / rho = 1 + <excess> / chain_length, with excess the
projected contact separations summed over collisions.  Prints the equation
of state across packing fractions against the low-density virial
expansion (B2..B5).

Run:  python examples/torch/ecmc_hard_disks.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import hard_disks as hd  # noqa: E402

B2 = np.pi / 2


def virial(rho):
    return (1.0 + B2 * rho + 0.78202 * B2 ** 2 * rho ** 2
            + 0.53223 * B2 ** 3 * rho ** 3 + 0.33356 * B2 ** 4 * rho ** 4)


def main(n_disks=32, n_chains=64, steps=150, etas=(0.05, 0.15, 0.25),
         chain_length=3.0, device=None, root="data/hd_ecmc"):
    print(f"hard disks: N={n_disks}, {n_chains} chains, straight event "
          f"chains")
    print(f"{'eta':>6} {'rho':>7} {'bP/rho ECMC':>12} {'virial(B2..B5)':>15} "
          f"{'collisions/chain':>17}")
    out = {}
    for eta in etas:
        rho = 4.0 * eta / np.pi
        chains = hd.init_chains(n_chains, n_disks, eta, seed=3, device=device)
        sim = mc.Simulation(
            hd.make_system(), chains,
            [dict(algorithm=mc.EventChain, model=hd.ecmc_model(chain_length),
                  events_per_step=8, seed=11)],
            steps, path=f"{root}/eta{eta}")
        sim.run()
        st = sim.device_state["ecmc"]["stats"]
        if int(st["cap_hits"].sum()) != 0:
            raise RuntimeError("an event chain hit its event cap")
        p = hd.ecmc_pressure(st, chain_length)
        cpc = float(st["collisions"].sum()) / float(st["chains"].sum())
        out[eta] = (p, virial(rho))
        print(f"{eta:6.2f} {rho:7.4f} {p:12.4f} {virial(rho):15.4f} "
              f"{cpc:17.2f}")
    print("\n(virial truncated at B5: expect growing deviation beyond "
          "eta~0.25)")
    return out


if __name__ == "__main__":
    main()
