"""Metropolis sampling of a 1-D harmonic oscillator, on the PyTorch port.

Port of ``examples/mc_harmonic_oscillator.py`` (the reference example
``MC_harmonic_oscillator.jl``): M chains, a Gaussian displacement move
(the hand-written CUDA sweep on the card), energy and acceptance
callbacks, trajectories, backups, last frames and a progress bar, then
the sampled moments against the target (mean 0, std 1/sqrt(2 beta)).
"""

import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch.models import particle1d as p1d  # noqa: E402


def main(n_chains=10, steps=10 ** 5, burn=1000, beta=2.0, device=None,
         root="data/MC"):
    seed = 42
    sampletimes = mc.build_schedule(steps, burn, [0, 10])
    path = (f"{root}/particle_1d/Harmonic/beta{beta}/M{n_chains}/"
            f"seed{seed}")

    system = p1d.make_system(p1d.harmonic)
    chains = p1d.init_chains(n_chains, beta=beta, seed=seed, device=device)
    pool = (p1d.displacement_move(sigma=0.1, weight=1.0),)

    algorithm_list = [
        dict(algorithm=mc.Metropolis, pool=pool, seed=seed),
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(p1d.callback_energy, mc.callback_acceptance),
             scheduler=sampletimes),
        dict(algorithm=mc.StoreTrajectories, scheduler=sampletimes),
        dict(algorithm=mc.StoreBackups,
             scheduler=mc.build_schedule(steps, burn, steps // 10),
             store_first=True, store_last=True),
        dict(algorithm=mc.StoreLastFrames, scheduler=np.asarray([steps])),
        dict(algorithm=mc.PrintTimeSteps,
             scheduler=mc.build_schedule(steps, burn, steps // 10)),
    ]
    sim = mc.Simulation(system, chains, algorithm_list, steps, path=path,
                        verbose=True)
    sim.run()

    energies = np.loadtxt(os.path.join(path, "energy.dat"))[:, 1]
    print(f"\nenergy mean={energies.mean():.4f} std={energies.std():.4f} "
          f"(expect ~{1 / (2 * beta):.4f})")
    trj = [np.loadtxt(f)[:, 1] for f in glob.glob(
        os.path.join(path, "trajectories", "*", "trajectory.dat"))]
    pos = np.concatenate(trj)
    print(f"position mean={pos.mean():.4f} std={pos.std():.4f} "
          f"(expect 0, {1 / np.sqrt(2 * beta):.4f})")
    plot_density(path, pos, beta)
    return {"path": path, "energy": energies.mean(), "pos_std": pos.std()}


def plot_density(path, pos, beta):
    """Sampled density against the Boltzmann curve -> density.png."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping density.png")
        return
    fig, ax = plt.subplots(figsize=(5.4, 3.6), dpi=150)
    ax.hist(pos, bins=60, density=True, color="#6b9bd1", alpha=0.85,
            edgecolor="white", linewidth=0.3, label="sampled")
    xs = np.linspace(pos.min(), pos.max(), 400)
    target = np.exp(-beta * xs ** 2)
    target /= np.trapezoid(target, xs)
    ax.plot(xs, target, color="#1a1a2e", linewidth=2.0,
            label=r"$\propto e^{-\beta x^2}$")
    ax.set_xlabel("x")
    ax.set_ylabel("density")
    ax.set_title(f"Harmonic oscillator, $\\beta$ = {beta}")
    ax.legend(frameon=False)
    ax.spines[["top", "right"]].set_visible(False)
    ax.grid(axis="y", color="#e6e6e6", linewidth=0.6)
    ax.set_axisbelow(True)
    fig.tight_layout()
    out = os.path.join(path, "density.png")
    fig.savefig(out)
    plt.close(fig)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
