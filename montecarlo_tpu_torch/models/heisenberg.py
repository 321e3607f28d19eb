"""Classical Heisenberg (O(3)) model on a periodic 2-D square lattice.

Port of ``montecarlo_tpu/models/heisenberg.py``.  Hamiltonian
``E = -J * sum_<ij> s_i . s_j`` over nearest-neighbour bonds, ``s`` unit
3-vectors; the spins of all chains are one (M, L1, L2, 3) float32 tensor.

Sampling paths:

- :func:`rotation_move` — a single-site rotation through the generic move
  protocol: site uniform, a rotation about a uniformly random axis by
  ``alpha ~ U[-delta, delta]`` (Rodrigues formula, renormalised), O(1)
  delta-energy from the four-neighbour local field;
- :class:`CheckerboardHeisenberg` — whole-lattice bipartite Metropolis
  sweeps (even lattices only), each followed by ``overrelax``
  over-relaxation sweeps: every active-parity spin reflected about its
  local field, ``s -> 2 (s.h) h / |h|^2 - s``, skipped where
  ``|h|^2 <= 1e-12``.

The step functions take their random numbers as tensors (the Gaussian
normals of the random axes and the uniforms), which the sampler derives
from per-chain threefry keys as the reference's does (``ising2d``'s
:class:`~montecarlo_tpu_torch.models.ising2d.LatticeSampler`).

Ground truth: the 2x2 periodic lattice is a 4-ring with coupling 2J, solved
by the transfer-operator expansion in Legendre polynomials
(:func:`exact_energy_2x2`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.algorithms import _n_calls
from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef
from ..utils import prng
from ..utils.device import resolve_device
from .ising2d import LatticeSampler, _require_even, parity_mask

__all__ = ["HeisenbergState", "make_system", "init_chains", "rotation_move",
           "AxisAngleRotation",
           "checkerboard_sweep", "overrelax_sweep", "CheckerboardHeisenberg",
           "exact_energy_2x2",
           "callback_energy_per_spin", "callback_magnetisation"]


@dataclasses.dataclass(frozen=True)
class HeisenbergState:
    """Chain-batched state."""
    spins: torch.Tensor   # (M, L1, L2, 3) float32 unit vectors
    beta: torch.Tensor    # (M,)
    j: torch.Tensor       # (M,) coupling
    energy: torch.Tensor  # (M,) cached total energy


def _bond_energy(spins, j):
    """-J * the sum of nearest-neighbour dots, each bond counted once by the
    two roll(+1)s."""
    return -j * torch.sum(spins * (torch.roll(spins, 1, 1)
                                   + torch.roll(spins, 1, 2)), dim=(1, 2, 3))


def _neighbour_field(spins):
    """Local field h = the sum of the four neighbour spins, (M, L1, L2, 3)."""
    return (torch.roll(spins, 1, 1) + torch.roll(spins, -1, 1)
            + torch.roll(spins, 1, 2) + torch.roll(spins, -1, 2))


def _unit(v):
    """``v`` over its norm along the last axis, the norm clipped at 1e-12;
    of (..., 3) standard normals, uniform points on S^2."""
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _rotate(s, axis, alpha):
    """Rodrigues rotation of ``s`` about the unit ``axis`` by ``alpha``;
    3-vectors on the last axis, broadcast over the leading ones.  The result
    is renormalised, so float32 round-off cannot drift spins off the
    sphere."""
    c = torch.cos(alpha)[..., None]
    si = torch.sin(alpha)[..., None]
    dot = torch.sum(axis * s, dim=-1, keepdim=True)
    r = s * c + torch.cross(axis, s, dim=-1) * si + axis * dot * (1.0 - c)
    return _unit(r)


def make_system() -> SystemDef:
    def log_target(state: HeisenbergState):
        return -state.beta * state.energy

    def frame(state: HeisenbergState):
        return {"m": _magnetisation(state.spins), "e": state.energy}

    def format_frame(t, fr):
        return f"{t} {float(fr['m'])!r} {float(fr['e'])!r}"

    return SystemDef(name="Heisenberg2D", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def init_chains(n_chains: int, size: int, beta: float, j: float = 1.0,
                seed: int = 42, device=None) -> HeisenbergState:
    """Uniform random unit spins from ``key(seed)`` as the reference draws
    them (normalised standard normals; its chains within a few float32
    ulps, as ``utils/prng.py``'s normals are), made on ``device``, the
    card (``cuda``) when it is None."""
    device = resolve_device(device)
    spins = _unit(prng.normal(prng.key(seed, device),
                              (n_chains, size, size, 3)))
    full = lambda v: torch.full((n_chains,), v, dtype=torch.float32,
                                device=device)
    jj = full(j)
    return HeisenbergState(spins=spins, beta=full(beta), j=jj,
                           energy=_bond_energy(spins, jj))


# ---------------------------------------------------------------------------
# Path 1: single-site axis-angle rotation through the generic move protocol
# ---------------------------------------------------------------------------

class AxisAngleRotation(Policy):
    """(site, axis, alpha): site uniform over L², axis uniform on S²,
    ``alpha ~ U[-delta, delta]``.  Symmetric: the inverse action (same axis,
    ``-alpha``) has the same density."""

    def sample(self, params, key, state):
        k_site, k_axis, k_ang = prng.split(key, 3).unbind(-2)
        _, lx, ly, _ = state.spins.shape
        site = prng.randint(k_site, (), 0, lx * ly, dtype=torch.int64)
        axis = _unit(prng.normal(k_axis, (3,)))
        u = prng.uniform(k_ang)
        return {"site": site, "axis": axis,
                "alpha": params["delta"] * (2.0 * u - 1.0)}

    def log_density(self, params, action, state):
        n = state.spins.shape[1] * state.spins.shape[2]
        # uniform site x uniform axis (constant) x uniform box of width 2 delta
        logq = (-float(np.log(np.float32(n)))
                - torch.log(2.0 * params["delta"]))
        return logq.expand(action["alpha"].shape)


def rotation_move(delta: float, weight: float = 1.0) -> Move:
    def apply(state: HeisenbergState, action):
        sp = state.spins
        m, lx, ly, _ = sp.shape
        site = action["site"]
        i, k = site // ly, site % ly
        rows = torch.arange(m, device=sp.device)
        old = sp[rows, i, k]
        new = _rotate(old, action["axis"], action["alpha"])
        h = (sp[rows, (i - 1) % lx, k] + sp[rows, (i + 1) % lx, k]
             + sp[rows, i, (k - 1) % ly] + sp[rows, i, (k + 1) % ly])
        d_e = -state.j * torch.sum((new - old) * h, dim=-1)
        spins = sp.clone()
        spins[rows, i, k] = new
        new_state = dataclasses.replace(state, spins=spins,
                                        energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return {"site": action["site"], "axis": action["axis"],
                "alpha": -action["alpha"]}

    def reward(action, new_state):
        return action["alpha"] * action["alpha"]

    md = MoveDef(name="SpinRotation", policy=AxisAngleRotation(), apply=apply,
                 invert=invert, reward=reward, kind="heisenberg_rotation")
    return Move(move=md,
                params={"delta": torch.tensor(delta, dtype=torch.float32)},
                weight=weight)


# ---------------------------------------------------------------------------
# Path 2: checkerboard Metropolis + over-relaxation sweeps
# ---------------------------------------------------------------------------

def checkerboard_half_sweep(state: HeisenbergState, parity: int, delta,
                            normals, u_angle, u_accept):
    """Metropolis-rotate every site of one sublattice at once: about the
    axis of the (M, L1, L2, 3) standard ``normals`` by ``delta (2 u_angle -
    1)``, accepted where ``log(u_accept) < -beta dE`` (both (M, L1, L2)
    uniforms in [0, 1)).  Needs even lattice dimensions.  Returns
    ``(new_state, n_accepted)``, the (M,) int32 accepted rotations."""
    sp = state.spins
    _require_even(sp.shape[1:3], "checkerboard sweeps")
    mask = parity_mask(sp.shape[1], sp.shape[2], parity, sp.device)

    axis = _unit(normals)
    alpha = delta * (2.0 * u_angle - 1.0)
    prop = _rotate(sp, axis, alpha)

    h = _neighbour_field(sp)
    d_e = -state.j[:, None, None] * torch.sum((prop - sp) * h, dim=-1)

    accept = mask & (torch.log(u_accept) < -state.beta[:, None, None] * d_e)
    spins = torch.where(accept[..., None], prop, sp)
    energy = state.energy + torch.sum(torch.where(accept, d_e, 0.0),
                                      dim=(1, 2))
    new_state = dataclasses.replace(state, spins=spins, energy=energy)
    return new_state, torch.sum(accept, dim=(1, 2), dtype=torch.int32)


def checkerboard_sweep(state: HeisenbergState, delta, normals0, u_angle0,
                       u_accept0, normals1, u_angle1, u_accept1):
    """One full lattice sweep, the even then the odd half-sweep (L²
    attempts), each with its normals and two uniforms."""
    state, a0 = checkerboard_half_sweep(state, 0, delta, normals0, u_angle0,
                                        u_accept0)
    state, a1 = checkerboard_half_sweep(state, 1, delta, normals1, u_angle1,
                                        u_accept1)
    return state, a0 + a1


def overrelax_half_sweep(state: HeisenbergState, parity: int):
    """Reflect every active-parity spin about its local field,
    ``s -> 2 (s.h) h / |h|^2 - s``, which keeps ``s.h`` (so the site's
    neighbour energy) and the unit norm; sites with ``|h|^2 <= 1e-12`` keep
    their spin (their local energy is constant)."""
    sp = state.spins
    mask = parity_mask(sp.shape[1], sp.shape[2], parity, sp.device)
    h = _neighbour_field(sp)
    h2 = torch.sum(h * h, dim=-1, keepdim=True)
    safe = h2 > 1e-12
    dot = torch.sum(sp * h, dim=-1, keepdim=True)
    reflected = torch.where(
        safe, 2.0 * dot * h / torch.where(safe, h2, 1.0) - sp, sp)
    spins = torch.where(mask[..., None], reflected, sp)
    return dataclasses.replace(state, spins=spins)


def overrelax_sweep(state: HeisenbergState):
    state = overrelax_half_sweep(state, 0)
    return overrelax_half_sweep(state, 1)


class CheckerboardHeisenberg(LatticeSampler):
    """Checkerboard Metropolis + over-relaxation sampler.

    Per simulation step: ``sweeps`` x (one Metropolis checkerboard sweep +
    ``overrelax`` over-relaxation sweeps).  Device state: ``keys`` and
    ``counters[chain, 0] = (accepted, attempted)`` over the Metropolis
    attempts only."""

    state_key = "checkerboard_heisenberg"

    def __init__(self, sim, sweeps: int = 1, overrelax: int = 0,
                 delta: float = 1.0, seed: int = 1, dependencies=(), **_):
        super().__init__(sim, seed)
        self.sweeps = int(sweeps)
        self.overrelax = int(overrelax)
        self.delta = float(delta)
        _require_even(self.lattice_shape, type(self).__name__)

    def sweep(self, sys, key):
        # the half-sweeps' keys k0, k1, each split into (k_axis, k_ang,
        # k_acc): the axes' normals in one draw, the uniforms in another
        k = prng.split(prng.split(key), 3)               # (M, 2, 3, 2)
        shape = tuple(sys.spins.shape[1:3])
        normals = prng.normal(k[:, :, 0], shape + (3,))
        u = prng.uniform(k[:, :, 1:], shape)
        sys, acc = checkerboard_sweep(
            sys, self.delta, normals[:, 0], u[:, 0, 0], u[:, 0, 1],
            normals[:, 1], u[:, 1, 0], u[:, 1, 1])
        for _ in range(self.overrelax):
            sys = overrelax_sweep(sys)
        return sys, acc

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
        io.write("\tCheckerboardHeisenberg\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tSweeps per step: {self.sweeps}\n")
        io.write(f"\t\tOver-relaxation sweeps per Metropolis sweep: "
                 f"{self.overrelax}\n")
        io.write(f"\t\tRotation half-width delta: {self.delta}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


# ---------------------------------------------------------------------------
# Observables + exact ground truth
# ---------------------------------------------------------------------------

def _magnetisation(spins):
    n = spins.shape[-2] * spins.shape[-3]
    m = torch.sum(spins, dim=(-3, -2)) / n
    return torch.linalg.norm(m, dim=-1)


def callback_energy_per_spin(view):
    n = view.sys.spins.shape[-2] * view.sys.spins.shape[-3]
    return torch.mean(view.sys.energy) / n


def callback_magnetisation(view):
    return torch.mean(_magnetisation(view.sys.spins))


def exact_energy_2x2(beta: float, j: float = 1.0, l_max: int = 60) -> float:
    """Exact mean energy per spin of the 2x2 periodic Heisenberg lattice.

    With the roll(+1) bond convention the 2x2 torus counts every edge
    twice: a 4-ring with coupling ``2 J``, whose transfer-operator solution
    is ``Z propto sum_l (2l+1) i_l(K)^4`` with ``K = 2 beta J`` and ``i_l``
    the modified spherical Bessel functions; ``<E> = -(2 J) d log Z / dK``,
    the sum cut at ``l_max``.
    """
    from scipy.special import spherical_in

    n_ring = 4
    k = 2.0 * beta * j
    ls = np.arange(l_max + 1)
    il = spherical_in(ls, k)
    dil = spherical_in(ls, k, derivative=True)
    w = (2 * ls + 1) * il ** n_ring
    z = w.sum()
    dz = ((2 * ls + 1) * n_ring * il ** (n_ring - 1) * dil).sum()
    mean_e_total = -(2.0 * j) * dz / z
    return float(mean_e_total / 4.0)
