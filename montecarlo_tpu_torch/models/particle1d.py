"""1-D particle in an external potential.

Port of ``montecarlo_tpu/models/particle1d.py`` (the reference example
system ``example/particle_1d/particle_1d.jl``): the state carries position
``x``, inverse temperature ``beta`` and the cached potential energy ``e``
per chain, so the Displacement move's delta-log-target comes from cached
energies.

Provides the harmonic and double-well potentials, the Gaussian displacement
move with its analytic log density, the MALA move (gradient-informed
proposal), the energy callback and the zig-zag event-chain model
(:func:`zigzag_model`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.ecmc import EventChainModel
from ..core.moves import Move, MoveDef, MoveFamily, Policy
from ..core.system import SystemDef
from ..ops import fused_sweep
from ..utils import prng
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves

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
    "zigzag_model",
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
    scripts' ``4rand(rng) - 2`` init) drawn from ``jax.random.key(seed)``'s
    stream, so the JAX package's ``init_chains`` gives the same x0, and
    ``beta`` a number or one value a chain
    (:func:`~montecarlo_tpu_torch.core.tempering.tile_ladder`).  The chains
    are made on ``device``, the card (``cuda``) when it is None."""
    device = resolve_device(device)
    x = 4.0 * prng.uniform(prng.key(seed, device), (n_chains,), dtype) - 2.0
    beta = torch.broadcast_to(torch.as_tensor(beta, dtype=dtype,
                                              device=device), (n_chains,))
    return Particle1DState(x=x, beta=beta.clone(), e=potential(x))


class StandardGaussian(Policy):
    """Zero-mean Gaussian over displacements, parameter ``sigma``."""

    def sample(self, params, key, state):
        sigma = params["sigma"]
        return sigma * prng.normal(key, (), sigma.dtype)

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
                 kind="gaussian_displacement_1d", aux=potential,
                 family=FAMILY)
    return Move(move=md,
                params={"sigma": torch.tensor(sigma, dtype=torch.float32)},
                weight=weight)


def _row_sweep(pool, state0, mesh, interpret):
    """``MoveFamily.row``: ``ops/fused_sweep.py``'s Gaussian sweep of one
    displacement move in a potential ``kernel_potential`` knows."""
    potential = pool[0].move.aux
    if (tuple(m.move.kind for m in pool) != ("gaussian_displacement_1d",)
            or not interpret
            and fused_sweep.kernel_potential(potential) is None):
        return None
    name = "sharded_gaussian_sweep" if mesh else "fused_gaussian_sweep"

    def run(sys, params, seed, micro_t0, n_steps):
        x, e, acc = getattr(fused_sweep, name)(
            *mesh, sys.x, sys.beta, tree_leaves(params[0])[0], seed,
            micro_t0, n_steps, potential=potential, interpret=interpret)
        inc = torch.stack([acc, torch.full_like(acc, n_steps)], dim=-1)
        return dataclasses.replace(sys, x=x, e=e), inc[:, None, :]

    return run


FAMILY = MoveFamily(roles={}, row=_row_sweep)


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

    def sample(self, params, key, state):
        eps = params["step"]
        noise = torch.sqrt(2.0 * eps) * prng.normal(key, (), eps.dtype)
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


# ---------------------------------------------------------------------------
# Event-chain (zig-zag) sampler for the harmonic target
# ---------------------------------------------------------------------------

def _ipow(x, k: int):
    """``x ** k`` for an integer ``k >= 1`` by square-and-multiply, the
    products in the order of ``jax.lax.integer_pow``."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def zigzag_model():
    """1-D event-chain model for the harmonic target exp(-beta x^2) — the
    zig-zag process, with closed-form event times.

    The lifted state is a velocity v in {-1, +1}; x moves ballistically and
    v flips at events of hazard rate ``beta * max(0, d/dt U(x + v t))``
    (U = x^2).  Downhill motion (x v < 0) is event-free until x crosses 0;
    uphill from w = max(x v, 0) the cumulative hazard is
    ``beta ((w + s)^2 - w^2)``, so with E ~ Exp(1) the event time is

        t* = -min(x v, 0) + sqrt(w^2 + E / beta) - w.

    The statistics are the exact trajectory integrals ``t``,
    ``sx = int x dt``, ``sx2 = int x^2 dt`` and ``sx4 = int x^4 dt``, so
    the moments are time averages with no discretisation."""

    def init_lift(state, draws):
        one = torch.ones_like(state.x)
        return {"v": torch.where(draws.bernoulli(), one, -one)}

    def event_step(state, lift, draws):
        x, beta, v = state.x, state.beta, lift["v"]
        exp_draw = -torch.log(draws.uniform(x.dtype))  # E ~ Exp(1)
        xv = x * v
        w = torch.clamp(xv, min=0.0)
        t = (-torch.clamp(xv, max=0.0) + torch.sqrt(w * w + exp_draw / beta)
             - w)
        xn = x + v * t

        def poly_int(k):                              # int_0^t (x + v s)^k ds
            return (_ipow(xn, k + 1) - _ipow(x, k + 1)) / ((k + 1) * v)

        stats = {"t": t, "sx": poly_int(1), "sx2": poly_int(2),
                 "sx4": poly_int(4)}
        new_state = dataclasses.replace(state, x=xn, e=xn * xn)
        return new_state, {"v": -v}, stats

    return EventChainModel(init_lift=init_lift, event_step=event_step,
                           name="ZigZagHarmonic1D")
