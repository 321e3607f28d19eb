"""Policy-gradient optimisers.

Port of ``montecarlo_tpu/policy_guided/learning.py``: one pure update rule
per optimiser, on flat parameter vectors, with the reference's formulas in
the same operation order (ref ``src/PolicyGuided/learning.jl``):

- ``Static``  — no-op
- ``VPG``     — θ += η ∇j
- ``BLPG``    — θ += η (∇j − j ∇logq_f)
- ``BLAPG``   — adaptive step η=√(2δ/(‖∇j‖²+ε))
- ``NPG``     — θ += η (g+εI)⁻¹ ∇j
- ``ANPG``    — adaptive natural
- ``BLANPG``  — baseline + adaptive + natural

A scalar over a tensor is written as a division of two tensors: torch's
``scalar / tensor`` multiplies by a reciprocal, which rounds differently
from JAX's division.
"""

from __future__ import annotations

import dataclasses

import torch

from .gradients import GradientData

__all__ = ["PolicyGradient", "Static", "VPG", "BLPG", "BLAPG", "NPG", "ANPG",
           "BLANPG", "learning_step"]


class PolicyGradient:
    """Abstract optimiser (ref ``PolicyGradient``, ``learning.jl:9``)."""

    def update(self, flat_params, gd: GradientData):
        raise NotImplementedError


def _adaptive_eta(delta, quad):
    """√(2δ / quad): 2δ is taken in Python floats, then in ``quad``'s
    dtype, as the reference's weakly typed arithmetic takes it."""
    return torch.sqrt(torch.div(torch.full_like(quad, 2.0 * delta), quad))


@dataclasses.dataclass(frozen=True)
class Static(PolicyGradient):
    def update(self, flat_params, gd):
        return flat_params


@dataclasses.dataclass(frozen=True)
class VPG(PolicyGradient):
    eta: float

    def update(self, p, gd):
        return p + self.eta * gd.grad_j


@dataclasses.dataclass(frozen=True)
class BLPG(PolicyGradient):
    eta: float

    def update(self, p, gd):
        return p + self.eta * (gd.grad_j - gd.j * gd.grad_logq_forward)


@dataclasses.dataclass(frozen=True)
class BLAPG(PolicyGradient):
    delta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        eta = _adaptive_eta(self.delta,
                            torch.dot(gd.grad_j, gd.grad_j) + self.eps_id)
        return p + eta * (gd.grad_j - gd.j * gd.grad_logq_forward)


def _inv_reg(g, eps_id):
    """(g + εI)⁻¹; at P = 1 the scalar reciprocal, as the reference."""
    if g.shape[0] == 1:
        return torch.reciprocal(g + eps_id)
    return torch.linalg.inv(
        g + eps_id * torch.eye(g.shape[0], dtype=g.dtype, device=g.device))


@dataclasses.dataclass(frozen=True)
class NPG(PolicyGradient):
    eta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        return p + self.eta * (_inv_reg(gd.g, self.eps_id) @ gd.grad_j)


@dataclasses.dataclass(frozen=True)
class ANPG(PolicyGradient):
    delta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        f_inv = _inv_reg(gd.g, self.eps_id)
        eta = _adaptive_eta(self.delta, gd.grad_j @ (f_inv @ gd.grad_j))
        return p + eta * (f_inv @ gd.grad_j)


@dataclasses.dataclass(frozen=True)
class BLANPG(PolicyGradient):
    delta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        f_inv = _inv_reg(gd.g, self.eps_id)
        d = gd.grad_j - gd.j * gd.grad_logq_forward
        eta = _adaptive_eta(self.delta, d @ (f_inv @ d))
        return p + eta * (f_inv @ d)


def learning_step(optimiser: PolicyGradient, flat_params, gd: GradientData):
    """Apply one optimiser update (ref ``learning_step!`` methods)."""
    return optimiser.update(flat_params, gd)
