"""Wang-Landau flat-histogram sampling: density-of-states estimation.

Port of ``montecarlo_tpu/core/wanglandau.py``.  Each chain is an
independent Wang-Landau walker: a random walk in energy space with the
acceptance ``min(1, g(E_old) / g(E_new))`` that converges its own estimate
``log g(E)`` of the density of states, with its own histogram and
modification factor.  Averaging the walkers' converged estimates
(:func:`mean_log_g`) reduces the error; every canonical expectation at
every temperature then follows by one reweighting sum (:func:`reweight`).

- :class:`WangLandau` runs ``moves_per_step`` proposals a step on all
  walkers at once (:func:`wl_step`).  A model names the draws its proposal
  consumes (:attr:`WangLandauModel.draw`, from each proposal's key); a
  step derives the keys of all its proposals from the walkers' threefry
  keys as the reference does (``split(fold_in(key, t), K)``, each split
  into ``k_prop, k_acc``), in a few batched calls, and draws the model's
  draws and the acceptance uniforms from them in one call each, so the
  step function takes them as tensors and one seed gives the JAX
  package's walkers.
- :class:`WangLandauRefine` is the host-side refinement between steps:
  walkers whose histogram is flat (over the bins they have visited, and
  covering every bin they ever visited) halve ``log f`` (floored at
  ``log_f_min``) and reset their histogram.

The proposal must be symmetric (uniform single-site flips and the like).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..utils import prng
from ..utils.tree import tree_map
from .algorithms import DeviceAlgorithm, HostAlgorithm, SimView, _n_calls

__all__ = [
    "WangLandauModel",
    "WangLandau",
    "WangLandauRefine",
    "wl_callbacks",
    "callback_wl_log_f",
    "callback_wl_flatness",
    "mean_log_g",
    "reweight",
]

TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class WangLandauModel:
    """What a system must supply to run under Wang-Landau.

    Fields
    ------
    n_bins:
        Number of energy bins.  Unreachable bins are fine: flatness is
        measured over visited bins only.
    bin_index:
        ``state -> (M,) int64``, each chain's energy bin (typically read
        from the cached energy in the state).
    propose:
        ``(state, draw) -> candidate_state``, a symmetric proposal on every
        chain from one proposal's draws ``draw`` (leading axis the chains);
        the candidate carries its own cached energy.
    draw:
        ``keys -> draws``, the draws of K proposals of every chain from
        their (M, K, 2) threefry keys ``k_prop`` (the reference's
        ``propose(state, k_prop)``), a tensor whose first two axes are
        (M, K): proposal ``k`` reads ``draws[:, k]``.
    """

    n_bins: int
    bin_index: Callable[[Any], Any]
    propose: Callable[[Any, Any], Any]
    draw: Callable[[Any], Any]


def _select(accept, cand, state):
    """``cand`` where ``accept`` (M,), else ``state``; a leaf the proposal
    kept (the same tensor in both) is passed through."""
    def pick(a, b):
        if a is b:
            return a
        return torch.where(accept.reshape(accept.shape + (1,) * (a.dim() - 1)),
                           a, b)

    return tree_map(pick, cand, state)


def wl_step(model: WangLandauModel, state, log_g, hist, visited, log_f,
            draws, u):
    """K sequential Wang-Landau proposals on every walker.

    ``draws`` holds the proposals' draws (``model.draw``'s layout) and ``u``
    the (M, K) acceptance uniforms in [TINY, 1).  Proposal ``k`` moves to the
    candidate where ``log u[:, k] < log_g[b0] - log_g[b1]`` (b0 the
    current bin, b1 the candidate's), then adds ``log_f`` to ``log_g`` and
    one visit to ``hist`` and ``visited`` at the bin it ends in.  Returns
    ``(state, log_g, hist, visited)``.

    The walkers' ``log_g`` and this step's visits sit side by side in one
    (M, 2 n_bins) float32 buffer, so a proposal's bookkeeping is one
    gather and one scatter-add; the visits (at most K a step) are exact in
    float32 and are added to the int32 histograms once a step.
    """
    m, nb = log_g.shape
    log_u = torch.log(u)
    work = torch.cat([log_g, torch.zeros_like(log_g)], dim=1)
    bump = torch.stack([log_f, torch.ones_like(log_f)], dim=1)
    offs = torch.tensor([0, nb], device=log_g.device)
    b0 = model.bin_index(state)
    for k in range(u.shape[1]):
        cand = model.propose(state, draws[:, k])
        b1 = model.bin_index(cand)
        g = work.gather(1, torch.stack([b0, b1], dim=1))
        # acceptance min(1, g(E0)/g(E1)); the proposal is symmetric
        accept = log_u[:, k] < g[:, 0] - g[:, 1]
        state = _select(accept, cand, state)
        b0 = torch.where(accept, b1, b0)
        work.scatter_add_(1, b0[:, None] + offs, bump)
    visits = work[:, nb:].to(torch.int32)
    return state, work[:, :nb].contiguous(), hist + visits, visited + visits


class WangLandau(DeviceAlgorithm):
    """Parallel Wang-Landau walkers, one a chain.

    Device-state slice (chain-major):

    - ``keys``: per-chain threefry keys ``fold_in(key(seed), chain)`` over
      the global chain ids (a mesh slices them with the chains);
    - ``log_g (chains, n_bins) float32``: the running log density of
      states;
    - ``hist (chains, n_bins) int32``: visits since the last refinement;
    - ``visited (chains, n_bins) int32``: all visits, never reset (the
      reachable support, for normalising and reweighting);
    - ``log_f (chains,) float32``: the modification factor, halved by
      :class:`WangLandauRefine` when the histogram is flat.
    """

    state_key = "wang_landau"

    def __init__(self, sim, model: WangLandauModel, moves_per_step: int = 1,
                 log_f0: float = 1.0, seed: int = 7, dependencies=(), **_):
        self.model = model
        self.moves_per_step = int(moves_per_step)
        self.log_f0 = float(log_f0)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        self.device = sim.device

    def init_state(self, sim):
        nb = self.model.n_bins
        zeros = lambda dtype: torch.zeros((self.n_chains, nb), dtype=dtype,
                                          device=self.device)
        chain_ids = torch.arange(self.n_chains, device=self.device)
        return {
            "keys": prng.fold_in(prng.key(self.seed, self.device)[None],
                                 chain_ids),
            "log_g": zeros(torch.float32),
            "hist": zeros(torch.int32),
            "visited": zeros(torch.int32),
            "log_f": torch.full((self.n_chains,), self.log_f0,
                                dtype=torch.float32, device=self.device),
        }

    def draws(self, slc, t):
        """Step ``t``'s (draws, u): the model's draws of every proposal,
        then the (M, K) acceptance uniforms in [TINY, 1), from the keys
        ``k_prop, k_acc = split(split(fold_in(key, t), K)[k])``."""
        k = prng.split(prng.split(prng.fold_in(slc["keys"], int(t)),
                                  self.moves_per_step), 2)   # (M, K, 2, 2)
        return (self.model.draw(k[:, :, 0]),
                prng.uniform(k[:, :, 1], (), minval=TINY))

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        sys, log_g, hist, visited = wl_step(
            self.model, dstate["sys"], slc["log_g"], slc["hist"],
            slc["visited"], slc["log_f"], *self.draws(slc, t))
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "log_g": log_g, "hist": hist,
                                 "visited": visited}}

    def write_summary(self, io, scheduler):
        io.write("\tWangLandau\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tEnergy bins: {self.model.n_bins}\n")
        io.write(f"\t\tMoves per simulation step: {self.moves_per_step}\n")
        io.write(f"\t\tInitial log f: {self.log_f0}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def _flatness(hist):
    """min/mean visit ratio over the visited bins, (chains, n_bins) ->
    (chains,); 0 where nothing was visited.  Bins never visited since the
    reset (an unreachable energy) do not block refinement."""
    h = hist.to(torch.float32)
    mask = h > 0
    n_seen = torch.sum(mask, dim=-1)
    mean = torch.sum(h, dim=-1) / torch.clamp(n_seen, min=1)
    h_min = torch.amin(torch.where(mask, h, torch.inf), dim=-1)
    return torch.where(n_seen > 0, h_min / torch.clamp(mean, min=1.0), 0.0)


def refine(slc, flatness: float, log_f_min: float):
    """The slice after one refinement: flat walkers halve ``log_f`` (floored
    at ``log_f_min``) and reset their histogram.

    A walker is flat when its since-reset histogram covers every bin it has
    ever visited and ``min >= flatness * mean`` over those bins; right after
    a reset a walker confined to a few bins would otherwise look flat, and
    ``log_f`` could crash before it re-traverses its energy range."""
    covers = torch.all((slc["visited"] == 0) | (slc["hist"] > 0), dim=-1)
    flat = covers & (_flatness(slc["hist"]) >= flatness)
    log_f = torch.where(flat, torch.clamp(slc["log_f"] * 0.5, min=log_f_min),
                        slc["log_f"])
    hist = torch.where(flat[:, None], 0, slc["hist"])
    return {**slc, "log_f": log_f, "hist": hist}


class WangLandauRefine(HostAlgorithm):
    """Scheduled flatness check and modification-factor halving
    (:func:`refine`) between steps of the walker named in
    ``dependencies=(WangLandau,)``."""

    def __init__(self, sim, flatness: float = 0.8, log_f_min: float = 1e-6,
                 dependencies=(), **_):
        if not dependencies:
            raise ValueError(
                "WangLandauRefine needs dependencies=(WangLandau,) in the "
                "algorithm list")
        self.walker = dependencies[0]
        self.flatness = float(flatness)
        self.log_f_min = float(log_f_min)

    def make_step(self, sim, t):
        key = self.walker.state_key
        slc = sim.device_state[key]
        sim.device_state = {**sim.device_state,
                            key: refine(slc, self.flatness, self.log_f_min)}

    def write_summary(self, io, scheduler):
        io.write("\tWangLandauRefine\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tFlatness criterion: {self.flatness}\n")
        io.write(f"\t\tFinal log f floor: {self.log_f_min}\n")


# -- observables ------------------------------------------------------------

def wl_callbacks(state_key: str = "wang_landau"):
    """``(callback_log_f, callback_flatness)`` bound to a walker's
    device-state key (a second ``WangLandau`` in one simulation is
    ``wang_landau_1``); the files are named after the key."""
    suffix = "wl" if state_key == "wang_landau" else state_key

    def log_f(view: SimView):
        return torch.mean(view.state[state_key]["log_f"])

    def flatness(view: SimView):
        return torch.mean(_flatness(view.state[state_key]["hist"]))

    log_f.__name__ = f"callback_{suffix}_log_f"
    log_f.__doc__ = "Mean modification factor over walkers."
    flatness.__name__ = f"callback_{suffix}_flatness"
    flatness.__doc__ = "Mean histogram flatness over walkers."
    return log_f, flatness


#: single-instance conveniences (state key ``wang_landau``)
callback_wl_log_f, callback_wl_flatness = wl_callbacks()


# -- estimators -------------------------------------------------------------

def _np(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def mean_log_g(slc, anchor_bin: int, anchor_log_g: float = 0.0):
    """The walkers' ``log_g`` estimates averaged into one, anchored.

    Each walker is shifted so ``log_g[anchor_bin] == anchor_log_g`` (the
    Ising ground level has 2 states: ``log 2``) and the shifted estimates
    are averaged.  A walker that never visited the anchor bin is left out;
    if none did, ``ValueError``.  Bins no anchored walker visited are
    ``-inf``.  Returns ``(log_g (n_bins,), support (n_bins,) bool)`` as
    numpy arrays."""
    log_g = _np(slc["log_g"], np.float64)
    visited = _np(slc["visited"]) > 0
    anchored = visited[:, anchor_bin]
    if not anchored.any():
        raise ValueError(
            f"no walker visited anchor bin {anchor_bin}; run longer or pick "
            "an anchor inside the sampled energy range")
    shifted = log_g - log_g[:, anchor_bin:anchor_bin + 1] + anchor_log_g
    w = (visited & anchored[:, None]).astype(np.float64)
    support = w.any(axis=0)
    avg = (shifted * w).sum(axis=0) / np.maximum(w.sum(axis=0), 1.0)
    return np.where(support, avg, -np.inf), support


def reweight(log_g, energies, beta):
    """Canonical ``(log_Z, mean_E, var_E)`` at inverse temperature ``beta``
    from ``log g(E)`` (``-inf`` for unsupported bins); the specific heat is
    ``beta**2 * var_E``."""
    log_g = np.asarray(log_g, np.float64)
    energies = np.asarray(energies, np.float64)
    logw = log_g - beta * energies
    m = logw.max()
    w = np.exp(logw - m)
    z = w.sum()
    mean_e = float((w * energies).sum() / z)
    var_e = float((w * (energies - mean_e) ** 2).sum() / z)
    return float(m + np.log(z)), mean_e, var_e
