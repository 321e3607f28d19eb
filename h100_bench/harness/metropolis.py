"""What a configuration driven by one ``Metropolis`` over a move pool
tells the harness: the sampler's algorithm entries, its move counters,
the moves a run attempted and the path it took.  A configuration module
re-exports these four; one driven by another sampler (an event chain, a
lattice sweep) defines its own under the same names."""

from __future__ import annotations


def algorithms(mc, made, wl, mc_seed, fused):
    """The sampler's entries of the Simulation's algorithm list."""
    return [dict(algorithm=mc.Metropolis, pool=made["pool"], seed=mc_seed,
                 sweepstep=wl["sweepstep"], fused=fused)]


def counters(state):
    """The per-chain, per-move ``(accepted, attempted)`` counters of a
    Simulation's ``device_state``."""
    return state["metropolis"]["counters"]


def moves(counts) -> float:
    """Attempted moves over all chains, from :func:`counters` as numpy: an
    attempted displacement or swap of one particle, or one chain-step."""
    import numpy as np
    return float(counts[..., 1].sum(dtype=np.float64))


def path(sim) -> str:
    """Which path the Metropolis took: ``cell``, ``row`` (a row kernel, or
    its plain version under ``fused='interpret'``) or ``generic``."""
    met = sim.device_algos[0]
    if met._use_cell:
        return "cell"
    return "row" if met.supports_fused else "generic"
