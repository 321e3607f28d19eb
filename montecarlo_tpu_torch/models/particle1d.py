"""1-D particle in an external potential.

Port of ``montecarlo_tpu/models/particle1d.py`` (the reference example
system ``example/particle_1d/particle_1d.jl``): the state carries position
``x``, inverse temperature ``beta`` and the cached potential energy ``e``
per chain, so the Displacement move's delta-log-target comes from cached
energies.

Provides the harmonic and double-well potentials, the Gaussian displacement
move with its analytic log density, the MALA move (gradient-informed
proposal) and the energy callback.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef

__all__ = [
    "Particle1DState",
    "harmonic",
    "double_well",
    "make_system",
    "init_chains",
    "StandardGaussian",
    "displacement_move",
    "LangevinGaussian",
    "mala_move",
    "callback_energy",
]


@dataclasses.dataclass(frozen=True)
class Particle1DState:
    """Chain-batched state: each field is an (M,) tensor."""
    x: torch.Tensor      # position
    beta: torch.Tensor   # inverse temperature
    e: torch.Tensor      # cached potential energy  (ref Particle.e)


def harmonic(x):
    """U(x) = x^2."""
    return x * x


def double_well(x, a=1.0, h=1.0):
    """U(x) = h * (x^2 - a^2)^2 / a^4 — double well with minima at ±a."""
    d = x * x - a * a
    return h * d * d / (a ** 4)


def make_system(potential=harmonic) -> SystemDef:
    """System descriptor.  Log target = -beta * e from the cached energy."""

    def log_target(state: Particle1DState):
        return -state.e * state.beta

    def frame(state: Particle1DState):
        return state.x

    def format_frame(t, x):
        # ref custom store_trajectory: "t x" (particle_1d.jl:63-66)
        return f"{t} {float(x)!r}"

    def parse_frame(line: str):
        t_str, x_str = line.split()
        return int(t_str), float(x_str)

    return SystemDef(name="Particle1D", log_target=log_target, frame=frame,
                     format_frame=format_frame, parse_frame=parse_frame)


def init_chains(n_chains: int, beta: float, seed: int = 42,
                potential=harmonic, dtype=torch.float32,
                device=None) -> Particle1DState:
    """Chain-batched initial state with x0 ~ U[-2, 2) (the reference
    scripts' ``4rand(rng) - 2`` init), drawn from a ``torch.Generator``
    seeded with ``seed`` — a different stream than the JAX package's, so
    ``interop.chains_from_reference`` carries its chains over instead."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    x = 4.0 * torch.rand((n_chains,), generator=gen, dtype=dtype,
                         device=device) - 2.0
    return Particle1DState(
        x=x,
        beta=torch.full((n_chains,), beta, dtype=dtype, device=device),
        e=potential(x),
    )


class StandardGaussian(Policy):
    """Zero-mean Gaussian over displacements, parameter ``sigma``."""

    def sample(self, params, generator, state):
        sigma = params["sigma"]
        return sigma * torch.randn(state.x.shape, generator=generator,
                                   dtype=sigma.dtype, device=state.x.device)

    def log_density(self, params, action, state):
        sigma = params["sigma"]
        return (-(action * action) / (2.0 * sigma * sigma)
                - 0.5 * torch.log(2.0 * torch.pi * sigma * sigma))


def displacement_move(sigma: float, weight: float = 1.0,
                      potential=harmonic) -> Move:
    """Gaussian displacement move (ref ``Displacement`` action)."""

    def apply(state: Particle1DState, delta):
        xn = state.x + delta
        en = potential(xn)
        dlogp = -(en - state.e) * state.beta
        return dataclasses.replace(state, x=xn, e=en), dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    md = MoveDef(name="Displacement", policy=StandardGaussian(),
                 apply=apply, invert=invert, reward=reward,
                 kind="gaussian_displacement_1d", aux=potential)
    return Move(move=md,
                params={"sigma": torch.tensor(sigma, dtype=torch.float32)},
                weight=weight)


class LangevinGaussian(Policy):
    """Gradient-informed (MALA) displacement proposal.

    The drift is one Euler–Maruyama step of the overdamped Langevin
    dynamics,

        delta ~ N( -eps * beta * U'(x),  2 eps ),

    with ``U'`` from ``torch.autograd`` on a detached copy of ``x`` (it does
    not depend on the parameters, so a parameter gradient flows through the
    drift's ``-eps * beta`` factor alone).  The proposal is asymmetric: the
    generic MH step evaluates the backward density at the proposed state
    with the inverted action.  Parameter ``step`` (= eps) is learnable by
    PGMC like any other policy parameter.
    """

    def __init__(self, potential=harmonic):
        self.potential = potential

    def grad_u(self, x):
        """U'(x), elementwise, as a constant of the parameters."""
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.potential(xd).sum(), xd)
        return g

    def _drift(self, params, state):
        return -params["step"] * state.beta * self.grad_u(state.x)

    def sample(self, params, generator, state):
        eps = params["step"]
        noise = torch.sqrt(2.0 * eps) * torch.randn(
            state.x.shape, generator=generator, dtype=eps.dtype,
            device=state.x.device)
        return self._drift(params, state) + noise

    def log_density(self, params, action, state):
        eps = params["step"]
        d = action - self._drift(params, state)
        return (-(d * d) / (4.0 * eps)
                - 0.5 * torch.log(4.0 * torch.pi * eps))


def mala_move(step: float, weight: float = 1.0, potential=harmonic) -> Move:
    """Metropolis-adjusted Langevin move: the apply/invert/reward of
    :func:`displacement_move` with the :class:`LangevinGaussian` proposal.
    Not fusable: it takes the generic path."""
    if step <= 0:
        raise ValueError(f"MALA step size must be positive, got {step}")

    def apply(state: Particle1DState, delta):
        xn = state.x + delta
        en = potential(xn)
        dlogp = -(en - state.e) * state.beta
        return dataclasses.replace(state, x=xn, e=en), dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    md = MoveDef(name="LangevinDisplacement",
                 policy=LangevinGaussian(potential),
                 apply=apply, invert=invert, reward=reward,
                 kind="mala_displacement_1d", aux=potential)
    return Move(move=md,
                params={"step": torch.tensor(step, dtype=torch.float32)},
                weight=weight)


def callback_energy(view):
    """Mean cached energy over chains."""
    return torch.mean(view.sys.e)
