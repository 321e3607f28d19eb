"""Quantum Monte Carlo on the PyTorch port: the transverse-field Ising
chain across its quantum critical region, against exact diagonalization.

Port of ``examples/tfim_quantum.py``.  The Suzuki-Trotter mapping turns the
N-spin quantum chain at inverse temperature beta into an (N, M) classical
space-time lattice; checkerboard sweeps sample it, and quantum observables
come from equal-time correlations (sigma^z) and temporal-bond statistics
(sigma^x).  For N = 8 the dense ED ground truth (2^8 states) is computed
alongside.

Run:  python examples/torch/tfim_quantum.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import tfim  # noqa: E402


def main(n_sites=8, m_slices=64, beta=2.0, j=1.0, n_chains=256, steps=200,
         sweeps=15, fields=(0.4, 1.0, 1.6), device=None, root="data/tfim"):
    print(f"TFIM chain: N={n_sites}, M={m_slices} slices, beta={beta}, "
          f"J={j}")
    print(f"{'h':>5} {'<sx> QMC':>9} {'<sx> ED':>8} {'<szsz> QMC':>11} "
          f"{'<szsz> ED':>10} {'<mz2> QMC':>10} {'<mz2> ED':>9}")
    out = {}
    for h in fields:
        chains = tfim.init_chains(n_chains, n_sites, m_slices, beta, j=j,
                                  h=h, seed=7, device=device)
        path = f"{root}/h{h}"
        sim = mc.Simulation(
            tfim.make_system(), chains,
            [dict(algorithm=tfim.TFIMCheckerboard, sweeps=sweeps, seed=7),
             dict(algorithm=mc.StoreCallbacks,
                  callbacks=(tfim.make_sx_callback(beta, h, m_slices),
                             tfim.callback_szsz, tfim.callback_sz2),
                  scheduler=mc.build_schedule(steps, 0, 2))],
            steps, path=path)
        sim.run()

        def tail(name):
            d = np.loadtxt(f"{path}/{name}.dat")
            return d[d[:, 0] >= steps // 2, 1].mean()

        ex = tfim.ed_observables(n_sites, beta, j, h)
        qmc = {"sx": tail("sx"), "szsz": tail("szsz"), "mz2": tail("sz2")}
        out[h] = (qmc, ex)
        print(f"{h:5.1f} {qmc['sx']:9.4f} {ex['sx']:8.4f} "
              f"{qmc['szsz']:11.4f} {ex['szsz']:10.4f} "
              f"{qmc['mz2']:10.4f} {ex['mz2']:9.4f}")
    return out


if __name__ == "__main__":
    main()
