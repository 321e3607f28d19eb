"""PolicyGradientEstimator — accumulate PGMC gradient estimates.

Port of ``montecarlo_tpu/policy_guided/estimator.py`` (ref
``src/PolicyGuided/estimator.jl``).  At each of its steps, for every
learnable move, the state is repeated ``q_batch_size`` times along the chain
axis, one action per (chain, q-sample) is drawn and probed
(:func:`~.gradients.sample_gradient_data`), and the per-sample
:class:`~.gradients.GradientData` are summed into the move's accumulator.

The estimator is off-policy: it samples proposals at the current state but
never advances the chains, so it composes with Metropolis at the same step
as the reference's in-order algorithm list does.

Randomness: one ``torch.Generator`` on the state's device, seeded from the
Metropolis seed (its ``stream_seed``: on a mesh, the rank folded in) and
:data:`_PGE_TAG`, where the reference folds per-chain threefry keys; the
estimator is held to the reference by statistics.

On a chain mesh each rank samples its own chains, and each step's sums are
all-reduced over the ranks before they are added (the reference's
``psum``), so the accumulators, and the parameters the update computes
from them, stay the same on every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.algorithms import DeviceAlgorithm, _n_calls
from ..core.metropolis import Metropolis, _n_devices
from ..utils.tree import ravel, tree_map
from .gradients import add, init_gradient_data, sample_gradient_data
from .learning import PolicyGradient, Static

__all__ = ["PolicyGradientEstimator"]

_PGE_TAG = 0x50474D43  # "PGMC": decorrelates the estimator from Metropolis


class PolicyGradientEstimator(DeviceAlgorithm):
    state_key = "pge"

    def __init__(self, sim, dependencies=(),
                 optimisers: Sequence[PolicyGradient] = (),
                 q_batch_size: int = 1, **_):
        deps = [d for d in dependencies if isinstance(d, Metropolis)]
        if len(deps) != 1:
            raise ValueError("PolicyGradientEstimator requires a single "
                             "Metropolis dependency")
        self.metropolis = deps[0]
        self.optimisers = tuple(optimisers)
        if len(self.optimisers) != self.metropolis.n_moves:
            raise ValueError("need one optimiser per move in the pool")
        # ref estimator.jl:72 — learnable moves are the non-Static ones
        self.learn_ids = [k for k, o in enumerate(self.optimisers)
                          if not isinstance(o, Static)]
        self.q_batch_size = int(q_batch_size)
        self.seed = self.metropolis.seed
        self.mesh = self.metropolis.mesh
        self.device = sim.device
        self.movedefs = self.metropolis.movedefs
        self.param_dims = [
            int(ravel(self.metropolis.pool[lid].params)[0].shape[0])
            for lid in self.learn_ids]

    def init_state(self, sim):
        gen = torch.Generator(device=self.device).manual_seed(
            (_PGE_TAG << 32) | (self.metropolis.stream_seed & 0xFFFFFFFF))
        gd = tuple(init_gradient_data(p, device=self.device)
                   for p in self.param_dims)
        obj = torch.zeros((len(self.learn_ids),), dtype=torch.float32,
                          device=self.device)
        return {"generator": gen, "gd": gd, "obj": obj}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        gds = list(slc["gd"])
        obj = slc["obj"].clone()
        params = dstate[self.metropolis.params_key]
        q = self.q_batch_size
        # the q-batch as q copies of the chains along the chain axis
        state = dstate["sys"] if q == 1 else tree_map(
            lambda x: x.repeat((q,) + (1,) * (x.dim() - 1)), dstate["sys"])
        for acc_idx, lid in enumerate(self.learn_ids):
            per = sample_gradient_data(self.movedefs[lid], params[lid], state,
                                       slc["generator"])
            total = tree_map(lambda x: x.sum(0).to(x.dtype), per)
            if self.mesh is not None:
                # the chain reduction over the ranks, one all_reduce a field
                total = tree_map(self.mesh.all_reduce, total)
            gd = add(gds[acc_idx], total)
            gds[acc_idx] = gd
            obj[acc_idx] = gd.j / gd.n.to(gd.j.dtype)
        return {**dstate, self.state_key: {**slc, "gd": tuple(gds),
                                           "obj": obj}}

    def write_summary(self, io, scheduler):
        n_dev = _n_devices(self.mesh, self.device)
        io.write("\tPolicyGradientEstimator\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLearnable moves: {[k + 1 for k in self.learn_ids]}\n")
        io.write(f"\t\tQ batch size: {self.q_batch_size}\n")
        io.write("\t\tAD backend: torch.autograd\n")
        io.write(f"\t\tSeed: {self.seed}\n")
        io.write(f"\t\tDevices: {n_dev}\n")
