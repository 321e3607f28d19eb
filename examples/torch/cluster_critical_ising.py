"""Cluster algorithms at the Ising critical point and a reweighted Binder
scan, on the PyTorch port.

Port of ``examples/cluster_critical_ising.py``:

1. Swendsen-Wang at beta_c on a 32x32 lattice decorrelates in a handful of
   sweeps where local dynamics suffer critical slowing down; the script
   prints tau_int of |m| for checkerboard Metropolis and Swendsen-Wang at
   equal sweep counts.
2. Multi-histogram (WHAM) reweighting: two runs bracketing beta_c trace the
   Binder cumulant through the transition without re-simulating.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import ising2d  # noqa: E402
from montecarlo_tpu_torch.utils import analysis  # noqa: E402

BETA_C = 0.44068679


def run(algo_spec, beta, path, size, n_chains, steps, burn, device,
        trajectories=False):
    chains = ising2d.init_chains(n_chains, size, beta=beta, seed=42,
                                 device=device)
    sched = mc.build_schedule(steps, burn, 1)
    algos = [algo_spec,
             dict(algorithm=mc.StoreCallbacks,
                  callbacks=[ising2d.callback_energy_per_spin,
                             ising2d.callback_magnetisation],
                  scheduler=sched)]
    if trajectories:
        algos.append(dict(algorithm=mc.StoreTrajectories, scheduler=sched))
    sim = mc.Simulation(ising2d.make_system(), chains, algos, steps,
                        path=path)
    sim.run()
    e = np.loadtxt(f"{path}/energy_per_spin.dat")[:, 1]
    m = np.loadtxt(f"{path}/magnetisation.dat")[:, 1]
    if not trajectories:
        return e, m
    # per-configuration samples (frames are "t m e" per chain): reweighting
    # weights apply to configurations, never to chain-averaged series
    frames = np.concatenate([
        np.loadtxt(f"{path}/trajectories/{c + 1}/trajectory.dat")
        for c in range(n_chains)])
    return frames[:, 2], np.abs(frames[:, 1])


def main(size=32, n_chains=32, steps=2000, burn=500, device=None,
         root="data/cluster_demo"):
    args = (size, n_chains, steps, burn, device)
    print(f"tau_int of |m| at beta_c on {size}x{size} (per lattice sweep):")
    _, m_cb = run(dict(algorithm=ising2d.CheckerboardMetropolis, seed=1),
                  BETA_C, f"{root}/checkerboard_b{BETA_C:.4f}", *args)
    _, m_sw = run(dict(algorithm=ising2d.SwendsenWang, seed=1),
                  BETA_C, f"{root}/swendsen_wang_b{BETA_C:.4f}", *args)
    tau_cb = analysis.integrated_autocorr_time(m_cb)
    tau_sw = analysis.integrated_autocorr_time(m_sw)
    print(f"  checkerboard Metropolis: tau_int = {tau_cb:6.1f}")
    print(f"  Swendsen-Wang:           tau_int = {tau_sw:6.1f}"
          f"   ({tau_cb / tau_sw:.0f}x faster mixing)")

    b_lo, b_hi = 0.41, 0.47
    e1, m1 = run(dict(algorithm=ising2d.SwendsenWang, seed=2), b_lo,
                 f"{root}/wham_b{b_lo:.4f}", *args, trajectories=True)
    e2, m2 = run(dict(algorithm=ising2d.SwendsenWang, seed=3), b_hi,
                 f"{root}/wham_b{b_hi:.4f}", *args, trajectories=True)
    print(f"\nWHAM Binder scan from runs at beta={b_lo} and {b_hi} "
          f"({e1.size + e2.size} pooled configurations):")
    print(f"{'beta':>8} {'U4':>8}")
    u4s = []
    for beta in np.linspace(b_lo, b_hi, 7):
        m2_rw = analysis.multi_reweight(
            [b_lo, b_hi], [e1, e2], beta, obs=[m1 ** 2, m2 ** 2])
        m4_rw = analysis.multi_reweight(
            [b_lo, b_hi], [e1, e2], beta, obs=[m1 ** 4, m2 ** 4])
        u4 = 1.0 - m4_rw / (3.0 * m2_rw ** 2)
        u4s.append(u4)
        print(f"{beta:8.4f} {u4:8.4f}")
    return {"tau_cb": tau_cb, "tau_sw": tau_sw, "u4": np.asarray(u4s)}


if __name__ == "__main__":
    main()
