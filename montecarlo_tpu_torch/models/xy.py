"""Classical XY (planar rotor) model on a periodic 2-D square lattice.

Port of ``montecarlo_tpu/models/xy.py``.  Hamiltonian
``E = -J * sum_<ij> cos(theta_i - theta_j)`` over nearest-neighbour bonds,
angles in ``[0, 2 pi)``; the angles of all chains are one (M, L1, L2)
float32 tensor.

Sampling paths:

- :func:`rotation_move` — a single-site angle perturbation through the
  generic move protocol: site uniform, ``dtheta ~ U[-delta, delta]``
  (``policy="uniform"``) or ``N(0, delta^2)`` (``policy="gaussian"``, whose
  width PGMC can learn), O(1) delta-energy from the four neighbours;
- :class:`CheckerboardXY` — whole-lattice bipartite Metropolis sweeps (even
  lattices only), each followed by ``overrelax`` microcanonical
  over-relaxation sweeps: every active-parity spin reflected about its
  local field, ``theta -> 2 phi - theta`` with ``phi = atan2(hy, hx)``,
  which keeps each site's neighbour energy exactly.

The step functions (:func:`checkerboard_half_sweep`,
:func:`checkerboard_sweep`) take their uniforms as tensors; the sampler
derives them from per-chain threefry keys as the reference's does
(:class:`~montecarlo_tpu_torch.models.ising2d.LatticeSampler`).

Ground truth: :func:`exact_moments` integrates the 2x2 periodic lattice by
the tensor-product periodic rectangle rule.
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

__all__ = ["XYState", "make_system", "init_chains", "rotation_move",
           "UniformRotation", "GaussianRotation",
           "checkerboard_sweep", "overrelax_sweep", "CheckerboardXY",
           "exact_moments",
           "callback_energy_per_spin", "callback_magnetisation"]

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class XYState:
    """Chain-batched state."""
    theta: torch.Tensor   # (M, L1, L2) float32 angles in [0, 2 pi)
    beta: torch.Tensor    # (M,)
    j: torch.Tensor       # (M,) coupling
    energy: torch.Tensor  # (M,) cached total energy


def _bond_energy(theta, j):
    """-J * the sum over bonds, each bond counted once by the two
    roll(+1)s."""
    return -j * torch.sum(torch.cos(theta - torch.roll(theta, 1, 1))
                          + torch.cos(theta - torch.roll(theta, 1, 2)),
                          dim=(1, 2))


def _neighbour_field(theta):
    """Local field h = sum_nb e^{i theta_nb} as (hx, hy)."""
    c, s = torch.cos(theta), torch.sin(theta)

    def nsum(a):
        return (torch.roll(a, 1, 1) + torch.roll(a, -1, 1)
                + torch.roll(a, 1, 2) + torch.roll(a, -1, 2))

    return nsum(c), nsum(s)


def make_system() -> SystemDef:
    def log_target(state: XYState):
        return -state.beta * state.energy

    def frame(state: XYState):
        return {"m": _magnetisation(state.theta), "e": state.energy}

    def format_frame(t, fr):
        return f"{t} {float(fr['m'])!r} {float(fr['e'])!r}"

    return SystemDef(name="XY2D", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def init_chains(n_chains: int, size: int, beta: float, j: float = 1.0,
                seed: int = 42, device=None) -> XYState:
    """Uniform angles from ``key(seed)`` as the reference draws them (the
    same seed gives its chains), made on ``device``, the card (``cuda``)
    when it is None."""
    device = resolve_device(device)
    theta = TWO_PI * prng.uniform(prng.key(seed, device),
                                  (n_chains, size, size))
    full = lambda v: torch.full((n_chains,), v, dtype=torch.float32,
                                device=device)
    jj = full(j)
    return XYState(theta=theta, beta=full(beta), j=jj,
                   energy=_bond_energy(theta, jj))


# ---------------------------------------------------------------------------
# Path 1: single-site rotation through the generic move protocol
# ---------------------------------------------------------------------------

def _log_sites(state):
    """-log(L1 L2) in float32, the log density of a uniform site."""
    return -float(np.log(np.float32(state.theta.shape[1]
                                    * state.theta.shape[2])))


def _site_and_angle_keys(key, state):
    """A uniform site per chain and the key of its angle draw, split from
    each chain's key as the reference splits it."""
    k_site, k_ang = prng.split(key).unbind(-2)
    _, lx, ly = state.theta.shape
    return prng.randint(k_site, (), 0, lx * ly, dtype=torch.int64), k_ang


class UniformRotation(Policy):
    """(site, dtheta) with site uniform over L² and ``dtheta ~ U[-delta,
    delta]``: symmetric, ``delta`` a learnable parameter."""

    def sample(self, params, key, state):
        site, k_ang = _site_and_angle_keys(key, state)
        u = prng.uniform(k_ang)
        return {"site": site, "dtheta": params["delta"] * (2.0 * u - 1.0)}

    def log_density(self, params, action, state):
        logq = _log_sites(state) - torch.log(2.0 * params["delta"])
        return logq.expand(action["dtheta"].shape)


class GaussianRotation(Policy):
    """(site, dtheta) with site uniform and ``dtheta ~ N(0, sigma^2)``.

    The PGMC-learnable variant: the uniform box's score ``-1/delta`` does
    not depend on the action, while the Gaussian's ``dtheta^2/sigma^3 -
    1/sigma`` does, and reaches the estimator through ``torch.autograd``.
    """

    def sample(self, params, key, state):
        site, k_ang = _site_and_angle_keys(key, state)
        return {"site": site, "dtheta": params["sigma"] * prng.normal(k_ang)}

    def log_density(self, params, action, state):
        sigma = params["sigma"]
        d = action["dtheta"]
        return (_log_sites(state) - (d * d) / (2.0 * sigma * sigma)
                - 0.5 * torch.log(2.0 * torch.pi * sigma * sigma))


def rotation_move(delta: float, weight: float = 1.0,
                  policy: str = "uniform") -> Move:
    """Single-site rotation move: ``policy="uniform"`` draws ``dtheta ~
    U[-delta, delta]``, ``policy="gaussian"`` ``dtheta ~ N(0, delta^2)``
    (learnable by PGMC, see :class:`GaussianRotation`)."""
    def apply(state: XYState, action):
        th = state.theta
        m, lx, ly = th.shape
        site = action["site"]
        i, k = site // ly, site % ly
        rows = torch.arange(m, device=th.device)
        old = th[rows, i, k]
        new = torch.remainder(old + action["dtheta"], TWO_PI)
        nbs = torch.stack([th[rows, (i - 1) % lx, k],
                           th[rows, (i + 1) % lx, k],
                           th[rows, i, (k - 1) % ly],
                           th[rows, i, (k + 1) % ly]], dim=1)
        d_e = -state.j * torch.sum(torch.cos(new[:, None] - nbs)
                                   - torch.cos(old[:, None] - nbs), dim=1)
        theta = th.clone()
        theta[rows, i, k] = new
        new_state = dataclasses.replace(state, theta=theta,
                                        energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return {"site": action["site"], "dtheta": -action["dtheta"]}

    def reward(action, new_state):
        return action["dtheta"] * action["dtheta"]

    if policy == "uniform":
        pol, name, kind = UniformRotation(), "delta", "xy_rotation"
    elif policy == "gaussian":
        pol, name, kind = (GaussianRotation(), "sigma",
                           "xy_rotation_gaussian")
    else:
        raise ValueError(f"unknown rotation policy {policy!r}; "
                         f"expected 'uniform' or 'gaussian'")
    md = MoveDef(name="Rotation", policy=pol, apply=apply, invert=invert,
                 reward=reward, kind=kind)
    return Move(move=md,
                params={name: torch.tensor(delta, dtype=torch.float32)},
                weight=weight)


# ---------------------------------------------------------------------------
# Path 2: checkerboard Metropolis + over-relaxation sweeps
# ---------------------------------------------------------------------------

def checkerboard_half_sweep(state: XYState, parity: int, delta, u_angle,
                            u_accept):
    """Metropolis-perturb every site of one sublattice at once: the
    proposal ``theta + delta (2 u_angle - 1)`` (mod 2 pi), accepted where
    ``log(u_accept) < -beta dE``; ``u_angle`` and ``u_accept`` are (M, L1,
    L2) uniforms in [0, 1).  Needs even lattice dimensions.  Returns
    ``(new_state, n_accepted)``, the (M,) int32 accepted rotations."""
    th = state.theta
    _require_even(th.shape[1:], "checkerboard sweeps")
    mask = parity_mask(th.shape[1], th.shape[2], parity, th.device)
    prop = torch.remainder(th + delta * (2.0 * u_angle - 1.0), TWO_PI)

    hx, hy = _neighbour_field(th)
    # sum_nb cos(x - theta_nb) = cos(x) hx + sin(x) hy
    e_old = -(torch.cos(th) * hx + torch.sin(th) * hy)
    e_new = -(torch.cos(prop) * hx + torch.sin(prop) * hy)
    d_e = state.j[:, None, None] * (e_new - e_old)

    accept = mask & (torch.log(u_accept) < -state.beta[:, None, None] * d_e)
    theta = torch.where(accept, prop, th)
    energy = state.energy + torch.sum(torch.where(accept, d_e, 0.0),
                                      dim=(1, 2))
    new_state = dataclasses.replace(state, theta=theta, energy=energy)
    return new_state, torch.sum(accept, dim=(1, 2), dtype=torch.int32)


def checkerboard_sweep(state: XYState, delta, u_angle0, u_accept0,
                       u_angle1, u_accept1):
    """One full lattice sweep, the even then the odd half-sweep (L²
    attempts), each with its two uniforms."""
    state, a0 = checkerboard_half_sweep(state, 0, delta, u_angle0, u_accept0)
    state, a1 = checkerboard_half_sweep(state, 1, delta, u_angle1, u_accept1)
    return state, a0 + a1


def overrelax_half_sweep(state: XYState, parity: int):
    """Reflect every active-parity spin about its local field direction,
    ``theta -> 2 phi - theta`` with ``phi = atan2(hy, hx)``: exactly
    energy-preserving and deterministic.  A site with ``|h| = 0`` has a
    constant local energy, so reflecting it about ``atan2(0, 0) = 0`` keeps
    the energy too."""
    th = state.theta
    mask = parity_mask(th.shape[1], th.shape[2], parity, th.device)
    hx, hy = _neighbour_field(th)
    phi = torch.atan2(hy, hx)
    reflected = torch.remainder(2.0 * phi - th, TWO_PI)
    return dataclasses.replace(state, theta=torch.where(mask, reflected, th))


def overrelax_sweep(state: XYState):
    state = overrelax_half_sweep(state, 0)
    return overrelax_half_sweep(state, 1)


class CheckerboardXY(LatticeSampler):
    """Checkerboard Metropolis + over-relaxation sampler.

    Per simulation step: ``sweeps`` x (one Metropolis checkerboard sweep +
    ``overrelax`` over-relaxation sweeps).  Device state: ``keys`` and
    ``counters[chain, 0] = (accepted, attempted)`` over the Metropolis
    attempts only (over-relaxation is rejection-free)."""

    state_key = "checkerboard_xy"
    lattice_field = "theta"

    def __init__(self, sim, sweeps: int = 1, overrelax: int = 0,
                 delta: float = 1.0, seed: int = 1, dependencies=(), **_):
        super().__init__(sim, seed)
        self.sweeps = int(sweeps)
        self.overrelax = int(overrelax)
        self.delta = float(delta)
        _require_even(self.lattice_shape, type(self).__name__)

    def sweep(self, sys, key):
        # the half-sweeps' keys k0, k1, each split into (k_ang, k_acc): all
        # four uniforms in one draw, (M, half, [angle, accept], L1, L2)
        u = prng.uniform(prng.split(prng.split(key), 2),
                         tuple(sys.theta.shape[1:]))
        sys, acc = checkerboard_sweep(sys, self.delta, u[:, 0, 0],
                                      u[:, 0, 1], u[:, 1, 0], u[:, 1, 1])
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
        io.write("\tCheckerboardXY\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tSweeps per step: {self.sweeps}\n")
        io.write(f"\t\tOver-relaxation sweeps per Metropolis sweep: "
                 f"{self.overrelax}\n")
        io.write(f"\t\tProposal half-width delta: {self.delta}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


# ---------------------------------------------------------------------------
# Observables + exact ground truth
# ---------------------------------------------------------------------------

def _magnetisation(theta):
    n = theta.shape[-1] * theta.shape[-2]
    mx = torch.sum(torch.cos(theta), dim=(-2, -1)) / n
    my = torch.sum(torch.sin(theta), dim=(-2, -1)) / n
    return torch.sqrt(mx * mx + my * my)


def callback_energy_per_spin(view):
    n = view.sys.theta.shape[-1] * view.sys.theta.shape[-2]
    return torch.mean(view.sys.energy) / n


def callback_magnetisation(view):
    return torch.mean(_magnetisation(view.sys.theta))


def exact_moments(beta: float, j: float = 1.0, n_quad: int = 48):
    """Quadrature Boltzmann expectations on the 2x2 periodic lattice:
    ``(energy per spin, mean magnetisation)`` by the tensor-product
    periodic rectangle rule over [0, 2 pi)^4, with the bond convention of
    :func:`_bond_energy` (on L = 2 each pair is a double bond)."""
    th = (np.arange(n_quad) + 0.5) * TWO_PI / n_quad
    a, b, c, d = np.meshgrid(th, th, th, th, indexing="ij")
    theta = np.stack([np.stack([a, b], -1), np.stack([c, d], -1)], -2)
    e = -j * (np.cos(theta - np.roll(theta, 1, -2))
              + np.cos(theta - np.roll(theta, 1, -1))).sum((-2, -1))
    w = np.exp(-beta * (e - e.min()))
    z = w.sum()
    mx = np.cos(theta).mean((-2, -1))
    my = np.sin(theta).mean((-2, -1))
    m = np.sqrt(mx * mx + my * my)
    return float((w * e).sum() / z / 4.0), float((w * m).sum() / z)
