"""PGMC gradient estimation.

Port of ``montecarlo_tpu/policy_guided/gradients.py`` (ref
``src/PolicyGuided/gradients.jl``).  Parameters are handled as flat vectors
(:func:`~montecarlo_tpu_torch.utils.tree.ravel`), so the Fisher-metric outer
product ``g`` is a plain ``(P, P)`` matrix.

The JAX package differentiates one chain at a time under ``jax.vmap``.
Here policies work on all chains at once, so each chain gets its own copy
of the flat parameters: a ``(B, P)`` leaf that is unravelled into a
parameter tree with a leading chain axis (which every policy accepts, as a
grouped pool's gathered parameters).  One ``torch.autograd.grad`` of the
summed log densities then gives every chain's own gradient, row by row.
Only the log-density evaluations build a graph; the state, ``apply``,
``reward`` and ``invert`` run detached.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.moves import MoveDef
from ..utils.device import resolve_device
from ..utils.tree import ravel, tree_leaves, tree_map

__all__ = [
    "GradientData",
    "init_gradient_data",
    "add",
    "average",
    "pgmc_estimate",
    "sample_gradient_data",
]


@dataclasses.dataclass(frozen=True)
class GradientData:
    """Monoid carried by the estimator (ref ``GradientData``,
    ``src/PolicyGuided/gradients.jl:41-85``).  :func:`pgmc_estimate` returns
    one per sample, every field with a leading sample axis."""
    j: torch.Tensor                  # objective estimate (scalar)
    grad_j: torch.Tensor             # ∇θ j, shape (P,)
    grad_logq_forward: torch.Tensor  # ∇θ log q(forward), shape (P,)
    g: torch.Tensor                  # Fisher-metric outer product, (P, P)
    n: torch.Tensor                  # sample count (int32 scalar)


def init_gradient_data(n_params: int, dtype=torch.float32,
                       device=None) -> GradientData:
    """Zero accumulator (ref ``initialise_gradient_data``) on ``device``,
    the card (``cuda``) when it is None."""
    device = resolve_device(device)
    return GradientData(
        j=torch.zeros((), dtype=dtype, device=device),
        grad_j=torch.zeros((n_params,), dtype=dtype, device=device),
        grad_logq_forward=torch.zeros((n_params,), dtype=dtype,
                                      device=device),
        g=torch.zeros((n_params, n_params), dtype=dtype, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
    )


def add(a: GradientData, b: GradientData) -> GradientData:
    """Monoid sum (ref ``Base.:+``)."""
    return tree_map(lambda x, y: x + y, a, b)


def average(gd: GradientData) -> GradientData:
    """Divide the accumulated sums by the sample count (ref ``average``)."""
    n = gd.n.to(gd.j.dtype)
    return GradientData(j=gd.j / n, grad_j=gd.grad_j / n,
                        grad_logq_forward=gd.grad_logq_forward / n,
                        g=gd.g / n, n=gd.n)


def _per_sample(flat_params, batch: int):
    """A ``(batch, P)`` leaf holding one detached copy of the flat
    parameters per sample, for per-sample gradients."""
    return flat_params.detach().expand(batch, -1).clone().requires_grad_(True)


def _withgrad_log_density(policy, p_rep, unravel, action, state):
    """Per-sample ``(logq, ∇θ logq)``, shapes ``(B,)`` and ``(B, P)``: the
    single dispatch point of the reference's AD layer.  A policy may supply
    the analytic escape hatch ``grad_log_density(params, action, state)``
    returning a params-shaped tree (leaves with the leading sample axis)."""
    grad_fn = getattr(policy, "grad_log_density", None)
    if grad_fn is not None:
        with torch.no_grad():
            params = unravel(p_rep)
            logq = policy.log_density(params, action, state)
            leaves = tree_leaves(grad_fn(params, action, state))
            grad = torch.cat([x.reshape(p_rep.shape[0], -1) for x in leaves],
                             dim=-1).to(p_rep.dtype)
        return logq, grad
    with torch.enable_grad():
        logq = policy.log_density(unravel(p_rep), action, state)
        if logq.requires_grad:
            (grad,) = torch.autograd.grad(logq.sum(), p_rep,
                                          allow_unused=True)
        else:
            grad = None
    if grad is None:      # the density does not depend on the parameters
        grad = torch.zeros_like(p_rep)
    return logq.detach(), grad


def pgmc_estimate(movedef: MoveDef, flat_params, unravel, state,
                  action) -> GradientData:
    """Off-policy PGMC probe of one sampled action per chain (ref
    ``pgmc_estimate``, ``gradients.jl:93-109``).

    ``flat_params`` is the ``(P,)`` flat parameter vector shared by every
    chain (or a ``(B, P)`` tensor of per-chain vectors) and ``unravel`` its
    inverse from :func:`~montecarlo_tpu_torch.utils.tree.ravel`.  The
    reference performs the action, measures, then always reverts: the new
    state is never returned.  Returns one :class:`GradientData` per chain
    (leading chain axis on every field).
    """
    if movedef.reward is None:
        raise ValueError(f"move {movedef.name} defines no reward; "
                         "required for policy-guided adaptation")
    policy = movedef.policy
    batch = int(tree_leaves(state)[0].shape[0])
    p_rep = _per_sample(flat_params, batch)
    logq_f, glogq_f = _withgrad_log_density(policy, p_rep, unravel, action,
                                            state)
    with torch.no_grad():
        new_state, dlogp = movedef.apply(state, action)
        r = movedef.reward(action, new_state)
        inv = movedef.invert(action, new_state)
    logq_b, glogq_b = _withgrad_log_density(policy, p_rep, unravel, inv,
                                            new_state)
    log_ratio = dlogp + logq_b - logq_f
    alpha = torch.exp(torch.clamp(log_ratio, max=0.0))
    j = r * alpha
    # ref gradients.jl:106 — use the forward gradient iff α == 1
    grad_j = j[:, None] * torch.where((log_ratio >= 0.0)[:, None], glogq_f,
                                      glogq_b)
    g = glogq_f[:, :, None] * glogq_f[:, None, :]
    return GradientData(j=j, grad_j=grad_j, grad_logq_forward=glogq_f, g=g,
                        n=torch.ones(j.shape, dtype=torch.int32,
                                     device=j.device))


def sample_gradient_data(movedef: MoveDef, params, state,
                         key) -> GradientData:
    """Sample one action per chain from the policy, chain c's from its key
    ``key[c]`` (an ``(M, 2)`` uint32 tensor), then estimate (ref
    ``sample_gradient_data``, ``gradients.jl:117-121``)."""
    flat_params, unravel = ravel(params)
    with torch.no_grad():
        action = movedef.policy.sample(params, key, state)
    return pgmc_estimate(movedef, flat_params, unravel, state, action)
