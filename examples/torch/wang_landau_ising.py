"""Wang-Landau density of states of the 2-D Ising model on the PyTorch
port, and the temperature dependence of energy and specific heat from one
simulation.

Port of ``examples/wang_landau_ising.py``.  Flat-histogram sampling
estimates log g(E) directly; canonical expectations at any temperature
follow by reweighting.  For L = 4 the result is checked against the
exactly enumerated density of states (2^16 states).

Run:  python examples/torch/wang_landau_ising.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.core.wanglandau import (mean_log_g,  # noqa: E402
                                                  reweight)
from montecarlo_tpu_torch.models import ising2d  # noqa: E402


def main(size=4, steps=60_000, n_chains=8, refine_every=250, device=None,
         path="data/wang_landau_ising"):
    """``steps`` x L^2 proposals a walker (the default ~1M), ``n_chains``
    independent walkers averaged at the end."""
    chains = ising2d.init_chains(n_chains, size=size, beta=1.0, seed=1,
                                 device=device)
    sim = mc.Simulation(
        ising2d.make_system(), chains,
        [dict(algorithm=mc.WangLandau, model=ising2d.wl_model(size),
              moves_per_step=size * size, seed=1),
         dict(algorithm=mc.WangLandauRefine, flatness=0.8, log_f_min=1e-4,
              dependencies=(mc.WangLandau,),
              scheduler=np.arange(refine_every, steps + 1, refine_every)),
         dict(algorithm=mc.StoreCallbacks,
              callbacks=[mc.callback_wl_log_f, mc.callback_wl_flatness],
              scheduler=mc.build_schedule(steps, 0, 1000))],
        steps, path=path)
    sim.run()

    slc = sim.device_state["wang_landau"]
    log_g, support = mean_log_g(slc, anchor_bin=0, anchor_log_g=np.log(2.0))
    energies = ising2d.wl_bin_energies(size)
    exact = ising2d.exact_log_g(size)

    print(f"final log f per walker: {slc['log_f'].cpu().numpy()}")
    # compare over the bins both the walkers and the enumeration support; a
    # reachable but unvisited bin is a discrepancy to report, not a crash
    exact_support = np.isfinite(exact)
    common = support & exact_support
    err = np.abs(log_g[common] - exact[common])
    print(f"max |log g - exact| over {common.sum()} common bins: "
          f"{err.max():.3f}")
    if (missed := exact_support & ~support).any():
        print(f"WARNING: {missed.sum()} reachable bins never visited: "
              f"E = {energies[missed]}")
    if (spurious := support & ~exact_support).any():
        print(f"WARNING: {spurious.sum()} visited bins outside exact "
              f"support: E = {energies[spurious]}")

    print(f"\n{'beta':>8} {'<E>/N (WL)':>12} {'<E>/N exact':>12} "
          f"{'C/N (WL)':>10} {'C/N exact':>10}")
    n = size * size
    for beta in np.linspace(0.1, 1.0, 10):
        _, e_wl, v_wl = reweight(log_g, energies, beta)
        _, e_ex, v_ex = reweight(exact, energies, beta)
        print(f"{beta:8.2f} {e_wl / n:12.4f} {e_ex / n:12.4f} "
              f"{beta**2 * v_wl / n:10.4f} {beta**2 * v_ex / n:10.4f}")
    return {"log_f": slc["log_f"].cpu().numpy(), "max_err": err.max(),
            "log_g": log_g, "support": support}


if __name__ == "__main__":
    main()
