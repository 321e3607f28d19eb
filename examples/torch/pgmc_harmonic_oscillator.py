"""Policy-guided MC on the PyTorch port: adapt the proposal width online.

Port of ``examples/pgmc_harmonic_oscillator.py`` (the reference example
``PGMC_harmonic_oscillator.jl``): two displacement moves, one Static and
one VPG-adapted; the estimator samples policy gradients every step and the
update is applied to the shared parameters, so sigma(t) climbs from 0.1
toward the optimal ~1.2 at beta 2.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import montecarlo_tpu_torch as mc  # noqa: E402
from montecarlo_tpu_torch import policy_guided as pg  # noqa: E402
from montecarlo_tpu_torch.models import particle1d as p1d  # noqa: E402


def main(n_chains=10, steps=10 ** 5, burn=1000, beta=2.0, device=None,
         root="data/PGMC"):
    seed = 42
    sampletimes = mc.build_schedule(steps, burn, [0, 10])
    path = (f"{root}/particle_1d/Harmonic/beta{beta}/M{n_chains}/"
            f"seed{seed}")

    system = p1d.make_system(p1d.harmonic)
    chains = p1d.init_chains(n_chains, beta=beta, seed=seed, device=device)
    pool = (
        p1d.displacement_move(sigma=0.2, weight=0.6),
        p1d.displacement_move(sigma=0.1, weight=0.4),
    )
    optimisers = (pg.Static(), pg.VPG(0.001))

    algorithm_list = [
        dict(algorithm=mc.Metropolis, pool=pool, seed=seed),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(mc.Metropolis,), optimisers=optimisers),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,)),
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(p1d.callback_energy, mc.callback_acceptance),
             scheduler=sampletimes),
        dict(algorithm=mc.StoreTrajectories, scheduler=sampletimes),
        dict(algorithm=mc.StoreParameters, dependencies=(mc.Metropolis,),
             scheduler=sampletimes),
        dict(algorithm=mc.StoreLastFrames, scheduler=np.asarray([steps])),
        dict(algorithm=mc.PrintTimeSteps,
             scheduler=mc.build_schedule(steps, burn, steps // 10)),
    ]
    sim = mc.Simulation(system, chains, algorithm_list, steps, path=path,
                        verbose=True)
    sim.run()

    energies = np.loadtxt(os.path.join(path, "energy.dat"))[:, 1]
    print(f"\nenergy mean={energies.mean():.4f} (expect ~0.25)")
    with open(os.path.join(path, "parameters", "2", "parameters.dat")) as f:
        lines = f.read().strip().split("\n")
    sig0 = float(lines[0].split(" ", 1)[1].strip("[]"))
    sig1 = float(lines[-1].split(" ", 1)[1].strip("[]"))
    print(f"adapted sigma: {sig0:.3f} -> {sig1:.3f} (optimal ~1.2)")
    plot_learning(path)
    return {"path": path, "energy": energies.mean(), "sigma": (sig0, sig1)}


def plot_learning(path):
    """sigma(t) per move -> learning.png."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping learning.png")
        return

    def series(k):
        ts, sig = [], []
        with open(os.path.join(path, "parameters", str(k),
                               "parameters.dat")) as f:
            for line in f:
                t, rest = line.split(" ", 1)
                ts.append(int(t))
                sig.append(float(rest.strip().strip("[]")))
        return np.asarray(ts), np.asarray(sig)

    fig, ax = plt.subplots(figsize=(5.4, 3.6), dpi=150)
    for k, (name, color) in enumerate(
            [("Static", "#6b9bd1"), ("VPG", "#c2503c")], start=1):
        ts, sig = series(k)
        ax.plot(ts, sig, color=color, linewidth=2.0, label=name)
    ax.axhline(1.2, color="#9a9a9a", linewidth=1.2, linestyle="--",
               label=r"optimal $\sigma \approx 1.2$")
    ax.set_xlabel("t")
    ax.set_ylabel(r"$\sigma$")
    ax.set_title("PGMC proposal-width adaptation")
    ax.legend(frameon=False)
    ax.spines[["top", "right"]].set_visible(False)
    ax.grid(axis="y", color="#e6e6e6", linewidth=0.6)
    ax.set_axisbelow(True)
    fig.tight_layout()
    out = os.path.join(path, "learning.png")
    fig.savefig(out)
    plt.close(fig)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
