"""2-D Ising model on a periodic square lattice.

Port of ``montecarlo_tpu/models/ising2d.py``.  Four sampling paths, each
over all chains at once (the spins are one (M, L1, L2) int8 tensor), and
the Wang-Landau binding :func:`wl_model`:

- :func:`spin_flip_move` — a single-site Metropolis move through the generic
  move protocol (O(1) delta-energy from the four-neighbour local field);
- :class:`CheckerboardMetropolis` — whole-lattice sweeps: the square lattice
  is bipartite, so every site of one parity is updated at once, L²
  attempts a chain a sweep;
- :class:`WolffCluster` — one Wolff cluster flip: every aligned bond
  activated with ``p = 1 - exp(-2 beta J)``, the seed's component found by
  dilation (:func:`~montecarlo_tpu_torch.ops.cluster.seed_component_mask`);
- :class:`SwendsenWang` — every activated-bond component labelled
  (:func:`~montecarlo_tpu_torch.ops.cluster.component_labels`) and given a
  fresh spin;
- :func:`wl_model` — a uniform single-site flip for
  :class:`~montecarlo_tpu_torch.core.wanglandau.WangLandau`, binned by
  energy level.

The step functions (:func:`checkerboard_half_sweep`,
:func:`checkerboard_sweep`, :func:`wolff_step`,
:func:`swendsen_wang_step`) take their random numbers as tensors, so the
tests can feed them any draws; each sampler derives them from per-chain
threefry keys ``fold_in(key(seed), chain)`` as the reference's does
(:class:`LatticeSampler`), so one seed gives the JAX package's chains on
any device and rank count.

Exact check: small lattices are enumerable (:func:`exact_moments`,
:func:`exact_log_g`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.algorithms import DeviceAlgorithm, SimView, _n_calls
from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef
from ..utils import prng
from ..utils.device import resolve_device
from .ising import random_spins

__all__ = ["Ising2DState", "make_system", "init_chains", "spin_flip_move",
           "CheckerboardMetropolis", "WolffCluster", "wolff_step",
           "SwendsenWang", "swendsen_wang_step",
           "wl_model", "wl_bin_energies", "exact_log_g",
           "exact_moments",
           "callback_energy_per_spin", "callback_magnetisation",
           "callback_checkerboard_acceptance", "callback_mean_cluster_size"]


@dataclasses.dataclass(frozen=True)
class Ising2DState:
    """Chain-batched state."""
    spins: torch.Tensor   # (M, L1, L2) int8 in {-1, +1}
    beta: torch.Tensor    # (M,)
    j: torch.Tensor       # (M,) coupling
    energy: torch.Tensor  # (M,) cached total energy


def _total_energy(spins, j):
    s = spins.to(torch.float32)
    return -j * torch.sum(s * (torch.roll(s, 1, 1) + torch.roll(s, 1, 2)),
                          dim=(1, 2))


def _neighbour_sum(s):
    """Sum of the four nearest neighbours, periodic boundaries; float32."""
    s = s.to(torch.float32)
    return (torch.roll(s, 1, 1) + torch.roll(s, -1, 1)
            + torch.roll(s, 1, 2) + torch.roll(s, -1, 2))


def make_system() -> SystemDef:
    def log_target(state: Ising2DState):
        return -state.beta * state.energy

    def frame(state: Ising2DState):
        return {"e": state.energy,
                "m": torch.mean(state.spins.to(torch.float32), dim=(1, 2))}

    def format_frame(t, fr):
        return f"{t} {float(fr['m'])!r} {float(fr['e'])!r}"

    return SystemDef(name="Ising2D", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def init_chains(n_chains: int, size: int, beta: float, j: float = 1.0,
                seed: int = 42, device=None) -> Ising2DState:
    """Random L x L spins from ``key(seed)`` as the reference draws them
    (the same seed gives its chains), made on ``device``, the card
    (``cuda``) when it is None."""
    device = resolve_device(device)
    spins = random_spins((n_chains, size, size), seed, device)
    full = lambda v: torch.full((n_chains,), v, dtype=torch.float32,
                                device=device)
    jj = full(j)
    return Ising2DState(spins=spins, beta=full(beta), j=jj,
                        energy=_total_energy(spins, jj))


def _pick(spins, i, k):
    """Each chain's spin at (i, k) (two (M,) index tensors), as float32."""
    m = spins.shape[0]
    return spins[torch.arange(m, device=spins.device), i, k].to(
        torch.float32)


# ---------------------------------------------------------------------------
# Path 1: single-site flip through the generic move protocol
# ---------------------------------------------------------------------------

class UniformSiteFlip2D(Policy):
    """Pick a lattice site uniformly; symmetric, self-inverse proposal."""

    def sample(self, params, key, state):
        _, lx, ly = state.spins.shape
        return prng.randint(key, (), 0, lx * ly, dtype=torch.int64)

    def log_density(self, params, action, state):
        m, lx, ly = state.spins.shape
        return torch.full((m,), -float(np.log(np.float32(lx * ly))),
                          dtype=torch.float32, device=state.spins.device)


def spin_flip_move(weight: float = 1.0) -> Move:
    def apply(state: Ising2DState, site):
        s = state.spins
        m, lx, ly = s.shape
        i, k = site // ly, site % ly
        nsum = (_pick(s, (i - 1) % lx, k) + _pick(s, (i + 1) % lx, k)
                + _pick(s, i, (k - 1) % ly) + _pick(s, i, (k + 1) % ly))
        d_e = 2.0 * state.j * _pick(s, i, k) * nsum
        rows = torch.arange(m, device=s.device)
        spins = s.clone()
        spins[rows, i, k] = -s[rows, i, k]
        new_state = dataclasses.replace(
            state, spins=spins, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(site, new_state):
        return site  # self-inverse

    def reward(site, new_state):
        return torch.ones(site.shape, dtype=torch.float32,
                          device=site.device)

    md = MoveDef(name="SpinFlip2D", policy=UniformSiteFlip2D(), apply=apply,
                 invert=invert, reward=reward, kind="ising2d_spin_flip")
    return Move(move=md, params={"dummy": torch.zeros(())}, weight=weight)


# ---------------------------------------------------------------------------
# Path 2: checkerboard half-sweeps (whole-lattice updates)
# ---------------------------------------------------------------------------

def _require_even(shape, who):
    if any(d % 2 for d in shape):
        raise ValueError(
            f"{who} need even lattice dimensions, got {tuple(shape)}: the "
            f"parity mask is not a proper 2-colouring of a periodic odd "
            f"lattice (wrap-around neighbours share a parity), which would "
            f"bias the sampled distribution")


def parity_mask(lx: int, ly: int, parity: int, device):
    """(L1, L2) True on the sites with (i + j) % 2 == parity."""
    ii = torch.arange(lx, device=device)[:, None]
    kk = torch.arange(ly, device=device)[None, :]
    return ((ii + kk) % 2) == parity


def checkerboard_half_sweep(state: Ising2DState, parity: int, u):
    """Metropolis-update every site of one sublattice at once, with the
    (M, L1, L2) uniforms ``u`` in [0, 1).

    Valid because the square lattice is bipartite: given the other
    sublattice, same-parity sites do not interact.  Needs even lattice
    dimensions.  Returns ``(new_state, n_accepted)`` with ``n_accepted`` the
    (M,) int32 flips (attempts = L²/2)."""
    s = state.spins
    _require_even(s.shape[1:], "checkerboard sweeps")
    mask = parity_mask(s.shape[1], s.shape[2], parity, s.device)
    d_e = 2.0 * state.j[:, None, None] * s.to(torch.float32) \
        * _neighbour_sum(s)
    accept = mask & (torch.log(u) < -state.beta[:, None, None] * d_e)
    spins = torch.where(accept, -s, s)
    energy = state.energy + torch.sum(torch.where(accept, d_e, 0.0),
                                      dim=(1, 2))
    new_state = dataclasses.replace(state, spins=spins, energy=energy)
    return new_state, torch.sum(accept, dim=(1, 2), dtype=torch.int32)


def checkerboard_sweep(state: Ising2DState, u0, u1):
    """One full lattice sweep, the even then the odd half-sweep (L²
    attempts), with their uniforms ``u0`` and ``u1``."""
    state, a0 = checkerboard_half_sweep(state, 0, u0)
    state, a1 = checkerboard_half_sweep(state, 1, u1)
    return state, a0 + a1


class LatticeSampler(DeviceAlgorithm):
    """What the lattice samplers share: the lattice shape (the two axes
    after the chains' of the state's ``lattice_field``), the per-chain
    threefry keys and a ``counters`` slice of shape (M, 1, 2).

    Chain c's key is ``fold_in(base, c)`` over the global chain ids (a
    mesh slices them with the chains), ``base`` being ``key(seed)`` with
    :attr:`stream_tag` folded in where a sampler has one, and step t's
    units (sweeps or cluster flips) take the keys ``split(fold_in(key,
    t), n)`` (:meth:`unit_keys`), the reference's tree."""

    lattice_field = "spins"
    #: folded into ``key(seed)`` before the chain ids, or None
    stream_tag = None
    #: whether a step of one unit splits its key (else the unit takes the
    #: step's key itself, as the reference's 2-D Ising checkerboard does)
    split_single = True

    def __init__(self, sim, seed: int = 1):
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        self.device = sim.device
        lattice = getattr(sim.chains0, self.lattice_field)
        self.lattice_shape = tuple(int(d) for d in lattice.shape[1:3])

    def init_state(self, sim):
        base = prng.key(self.seed, self.device)
        if self.stream_tag is not None:
            base = prng.fold_in(base, self.stream_tag)
        chain_ids = torch.arange(self.n_chains, device=self.device)
        return {"keys": prng.fold_in(base[None], chain_ids),
                "counters": torch.zeros((self.n_chains, 1, 2),
                                        dtype=torch.int32,
                                        device=self.device)}

    def unit_keys(self, slc, t, n: int):
        """(M, n, 2): the keys of step ``t``'s ``n`` units."""
        step = prng.fold_in(slc["keys"], int(t))
        if n == 1 and not self.split_single:
            return step[:, None]
        return prng.split(step, n)

    def count(self, dstate, sys, total, per_step):
        """The device state with ``sys`` and (total, per_step) added to each
        chain's counters."""
        slc = dstate[self.state_key]
        inc = torch.stack([total, torch.full_like(total, per_step)],
                          dim=-1)[:, None, :]
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "counters": slc["counters"] + inc}}

    def _check_ferromagnetic(self, sim, rule):
        j = sim.chains0.j
        if not bool(torch.all(j > 0)):
            raise ValueError(
                f"{type(self).__name__} requires a ferromagnetic coupling "
                f"J > 0 on every chain (got min J = {float(j.min())}); "
                f"{rule} is only valid for J > 0")


class CheckerboardMetropolis(LatticeSampler):
    """Whole-lattice checkerboard Metropolis sampler for 2-D lattices.

    Each sublattice is one (chains, L, L) tensor update; ``sweeps`` full
    sweeps a step, a sweep's key split into the two half-sweeps' (one
    sweep a step takes the step's key).  Device state: ``keys`` and
    ``counters[chain, 0] = (accepted, attempted)``."""

    state_key = "checkerboard"
    split_single = False

    def __init__(self, sim, sweeps: int = 1, seed: int = 1, dependencies=(),
                 **_):
        super().__init__(sim, seed)
        self.sweeps = int(sweeps)
        _require_even(self.lattice_shape, type(self).__name__)

    def sweep(self, sys, key):
        # k0, k1 = split(key): both half-sweeps' uniforms in one draw
        u = prng.uniform(prng.split(key), tuple(sys.spins.shape[1:]))
        return checkerboard_sweep(sys, u[:, 0], u[:, 1])

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        sys, acc = dstate["sys"], None
        keys = self.unit_keys(slc, t, self.sweeps)
        for s in range(self.sweeps):
            sys, a = self.sweep(sys, keys[:, s])
            acc = a if acc is None else acc + a
        attempts = self.sweeps * int(np.prod(self.lattice_shape))
        return self.count(dstate, sys, acc, attempts)

    def write_summary(self, io, scheduler):
        io.write("\tCheckerboardMetropolis\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLattice sweeps per simulation step: {self.sweeps}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def callback_checkerboard_acceptance(view: SimView):
    counters = view.state["checkerboard"]["counters"]
    acc = counters[..., 0].to(torch.float32)
    tot = counters[..., 1].to(torch.float32)
    return torch.mean(acc / torch.clamp(tot, min=1.0))


# ---------------------------------------------------------------------------
# Path 3: Wolff cluster updates
# ---------------------------------------------------------------------------

def bond_activation(s, p_bond, u_right, u_down):
    """Fortuin-Kasteleyn bonds: the aligned right and down bonds of each
    chain, active where their uniform is below the chain's ``p_bond``."""
    p = p_bond[:, None, None]
    act_right = (s == torch.roll(s, -1, 2)) & (u_right < p)
    act_down = (s == torch.roll(s, -1, 1)) & (u_down < p)
    return act_right, act_down


def wolff_step(state: Ising2DState, u_right, u_down, site):
    """One Wolff cluster flip on every chain.

    Every aligned bond is activated independently with
    ``p = 1 - exp(-2 beta J)`` (its (M, L1, L2) uniforms ``u_right``,
    ``u_down``); pre-sampling all bonds is distributionally the textbook
    grow-from-seed recursion.  The cluster is the component of the seed
    ``site`` (M,), found by dilation; it flips with probability 1 and the
    cached energy is recomputed.  Returns ``(new_state, cluster_size)``."""
    from ..ops.cluster import seed_component_mask

    s = state.spins
    p_bond = 1.0 - torch.exp(-2.0 * state.beta * state.j)
    act_right, act_down = bond_activation(s, p_bond, u_right, u_down)
    mask = seed_component_mask(act_right, act_down, site)
    spins = torch.where(mask, -s, s)
    new_state = dataclasses.replace(state, spins=spins,
                                    energy=_total_energy(spins, state.j))
    return new_state, torch.sum(mask, dim=(1, 2), dtype=torch.int32)


class WolffCluster(LatticeSampler):
    """Wolff cluster sampler for the 2-D Ising family: ``clusters`` flips a
    step, a flip's key split into ``k_seed, k_right, k_down`` (Potts adds
    ``k_col``).  Device state: ``keys`` and ``counters[chain, 0] = (total
    cluster size, clusters flipped)``.  Needs J > 0."""

    state_key = "wolff"
    #: the keys a flip splits its key into
    flip_keys = 3

    def __init__(self, sim, clusters: int = 1, seed: int = 1,
                 dependencies=(), **_):
        super().__init__(sim, seed)
        self.clusters = int(clusters)
        # the bond probability 1 - exp(-2 beta J) is derived for J > 0; with
        # J <= 0 no bond activates and the seed spin alone would flip with
        # probability 1, breaking detailed balance
        self._check_ferromagnetic(sim, "the bond probability "
                                       "1 - exp(-2 beta J) as a cluster rule")

    def draws(self, key, shape):
        """(the flip's split keys, u_right, u_down, site) of one cluster
        flip."""
        k = prng.split(key, self.flip_keys)
        u = prng.uniform(k[:, 1:3], tuple(shape[1:]))
        site = prng.randint(k[:, 0], (), 0, shape[1] * shape[2],
                            dtype=torch.int64)
        return k, u[:, 0], u[:, 1], site

    def flip(self, sys, key):
        return wolff_step(sys, *self.draws(key, sys.spins.shape)[1:])

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        sys, size = dstate["sys"], None
        keys = self.unit_keys(slc, t, self.clusters)
        for c in range(self.clusters):
            sys, n = self.flip(sys, keys[:, c])
            size = n if size is None else size + n
        return self.count(dstate, sys, size, self.clusters)

    def write_summary(self, io, scheduler):
        io.write("\tWolffCluster\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tCluster flips per simulation step: {self.clusters}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def callback_mean_cluster_size(view: SimView):
    counters = view.state["wolff"]["counters"]
    tot = counters[..., 0].to(torch.float32)
    n = counters[..., 1].to(torch.float32)
    return torch.mean(tot / torch.clamp(n, min=1.0))


# ---------------------------------------------------------------------------
# Path 4: Swendsen-Wang (whole-lattice Fortuin-Kasteleyn cluster updates)
# ---------------------------------------------------------------------------

def own_labels(labels):
    """(M,) int32: the components of each chain (the sites that are their
    own canonical label)."""
    m, lx, ly = labels.shape
    own = torch.arange(lx * ly, dtype=labels.dtype,
                       device=labels.device).reshape(1, lx, ly)
    return torch.sum(labels == own, dim=(1, 2), dtype=torch.int32)


def fresh_by_label(fresh, labels):
    """Each site's value ``fresh[c, labels[c, i, j]]``: a component reads the
    draw at its canonical (minimum-index) site."""
    m = labels.shape[0]
    return torch.gather(fresh, 1, labels.reshape(m, -1).to(
        torch.int64)).reshape(labels.shape)


def swendsen_wang_step(state: Ising2DState, u_right, u_down, fresh):
    """One Swendsen-Wang sweep on every chain: every aligned bond activated
    with ``p = 1 - exp(-2 beta J)`` (uniforms ``u_right``, ``u_down``), every
    component labelled, and each component given the spin ``fresh`` (an
    (M, L1 L2) int8 tensor of ±1) holds at its canonical site.  Valid on odd
    lattices.  Returns ``(new_state, n_clusters)``."""
    from ..ops.cluster import component_labels

    s = state.spins
    p_bond = 1.0 - torch.exp(-2.0 * state.beta * state.j)
    act_right, act_down = bond_activation(s, p_bond, u_right, u_down)
    labels = component_labels(act_right, act_down)
    spins = fresh_by_label(fresh.to(s.dtype), labels)
    new_state = dataclasses.replace(state, spins=spins,
                                    energy=_total_energy(spins, state.j))
    return new_state, own_labels(labels)


class SwendsenWang(LatticeSampler):
    """Swendsen-Wang sampler for the 2-D Ising family: ``sweeps`` a step, a
    sweep's key split into ``k_right, k_down, k_spin``.  Device state:
    ``keys`` and ``counters[chain, 0] = (total clusters resampled,
    sweeps)``.  Needs J > 0."""

    state_key = "swendsen_wang"

    def __init__(self, sim, sweeps: int = 1, seed: int = 1,
                 dependencies=(), **_):
        super().__init__(sim, seed)
        self.sweeps = int(sweeps)
        self._check_ferromagnetic(sim, "the FK bond probability "
                                       "1 - exp(-2 beta J)")

    def draws(self, key, shape):
        """(the sweep's split keys, u_right, u_down) of one sweep."""
        k = prng.split(key, 3)
        u = prng.uniform(k[:, :2], tuple(shape[1:]))
        return k, u[:, 0], u[:, 1]

    def sweep(self, sys, key):
        k, u_right, u_down = self.draws(key, sys.spins.shape)
        up = prng.bernoulli(k[:, 2], 0.5, (self.lattice_shape[0]
                                           * self.lattice_shape[1],))
        return swendsen_wang_step(sys, u_right, u_down,
                                  2 * up.to(torch.int8) - 1)

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        sys, nc = dstate["sys"], None
        keys = self.unit_keys(slc, t, self.sweeps)
        for s in range(self.sweeps):
            sys, n = self.sweep(sys, keys[:, s])
            nc = n if nc is None else nc + n
        return self.count(dstate, sys, nc, self.sweeps)

    def write_summary(self, io, scheduler):
        io.write("\tSwendsenWang\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLattice sweeps per simulation step: {self.sweeps}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


# ---------------------------------------------------------------------------
# Path 5: Wang-Landau binding (density-of-states random walk)
# ---------------------------------------------------------------------------

def wl_model(size: int, j: float = 1.0):
    """Wang-Landau model of the L x L periodic Ising lattice.

    Energy levels are ``E = -2 N j + 4 j k`` for bin ``k in [0, N]`` (N =
    L²; k = 1 and k = N-1 are unreachable on the periodic lattice, and
    flatness is measured over visited bins only).  The proposal is a
    uniform single-site flip (symmetric, as Wang-Landau needs); its draw is
    the site, an int64 index in [0, N) per chain and proposal,
    ``randint(k_prop, (), 0, N)`` as the reference's proposal draws it.  A
    proposal gathers the site and its four neighbours through a neighbour
    table made once, and updates the cached energy from their local field
    as :func:`spin_flip_move` does.  ``j`` is the coupling the bins are laid
    out for; the chains' own ``j`` enters the energies and the bins.
    """
    from ..core.wanglandau import WangLandauModel

    n = size * size
    ii, kk = np.divmod(np.arange(n), size)
    # each site and its four neighbours (the reference's order of the sum)
    table = np.stack([ii * size + kk,
                      (ii - 1) % size * size + kk,
                      (ii + 1) % size * size + kk,
                      ii * size + (kk - 1) % size,
                      ii * size + (kk + 1) % size], axis=1)
    tables = {}

    def bin_index(state: Ising2DState):
        return torch.round((state.energy + 2.0 * n * state.j)
                           / (4.0 * state.j)).to(torch.int64)

    def propose(state: Ising2DState, site):
        s = state.spins
        m = s.shape[0]
        dev = s.device
        if dev not in tables:
            tables[dev] = torch.as_tensor(table, device=dev)
        flat = s.reshape(m, n)
        near = flat.gather(1, tables[dev][site]).to(torch.float32)
        nsum = near[:, 1:].sum(1)              # small integers: exact
        d_e = 2.0 * state.j * near[:, 0] * nsum
        spins = flat.scatter(1, site[:, None],
                             (-near[:, :1]).to(s.dtype)).reshape(s.shape)
        return dataclasses.replace(state, spins=spins,
                                   energy=state.energy + d_e)

    def draw(keys):
        # the reference's propose: randint(k_prop, (), 0, N) a proposal
        return prng.randint(keys, (), 0, n, dtype=torch.int64)

    return WangLandauModel(n_bins=n + 1, bin_index=bin_index,
                           propose=propose, draw=draw)


# ---------------------------------------------------------------------------
# Wang-Landau bins, exact enumeration and observables
# ---------------------------------------------------------------------------

def wl_bin_energies(size: int, j: float = 1.0) -> np.ndarray:
    """Energy of each Wang-Landau bin: ``-2 N j + 4 j k``, k = 0..N."""
    n = size * size
    return -2.0 * n * j + 4.0 * j * np.arange(n + 1, dtype=np.float64)


def _enumerate(size: int, j: float):
    """Every configuration of an L x L lattice (L*L <= 20) and its energy."""
    n = size * size
    if n > 20:
        raise ValueError("exact enumeration is only feasible for L*L <= 20")
    bits = (np.arange(1 << n, dtype=np.int64)[:, None]
            >> np.arange(n)) & 1                        # (2^n, n)
    s = (2 * bits - 1).astype(np.float32).reshape(-1, size, size)
    e = -j * np.sum(
        s * (np.roll(s, 1, axis=1) + np.roll(s, 1, axis=2)), axis=(1, 2))
    return s, e


def exact_log_g(size: int, j: float = 1.0) -> np.ndarray:
    """Exact ``log g(E)`` per Wang-Landau bin by enumeration (L*L <= 20);
    unreachable bins are ``-inf``, on the grid of :func:`wl_bin_energies`."""
    n = size * size
    _, e = _enumerate(size, j)
    bins = np.round((e + 2.0 * n * j) / (4.0 * j)).astype(np.int64)
    counts = np.bincount(bins, minlength=n + 1).astype(np.float64)
    with np.errstate(divide="ignore"):
        return np.log(counts)


def exact_moments(size: int, beta: float, j: float = 1.0):
    """Brute-force Boltzmann expectations on an L x L periodic lattice
    (all 2^(L²) configurations, L ≤ 4): ``(energy per spin, mean
    |magnetisation|)``."""
    n = size * size
    s, e = _enumerate(size, j)
    w = np.exp(-beta * (e - e.min()))
    z = w.sum()
    e_spin = float((w * e).sum() / z / n)
    m_abs = float((w * np.abs(s.mean(axis=(1, 2)))).sum() / z)
    return e_spin, m_abs


def callback_energy_per_spin(view):
    n = view.sys.spins.shape[-1] * view.sys.spins.shape[-2]
    return torch.mean(view.sys.energy) / n


def callback_magnetisation(view):
    return torch.mean(torch.abs(torch.mean(
        view.sys.spins.to(torch.float32), dim=(-2, -1))))
