"""PolicyGradientEstimator — accumulate PGMC gradient estimates.

Port of ``montecarlo_tpu/policy_guided/estimator.py`` (ref
``src/PolicyGuided/estimator.jl``).  At each of its steps, for every
learnable move, each chain is repeated ``q_batch_size`` times along the
chain axis (chain c's copies side by side, the reference's order), one
action per (chain, q-sample) is drawn and probed
(:func:`~.gradients.sample_gradient_data`), and the per-sample
:class:`~.gradients.GradientData` are summed, over each chain's q-batch
first and then over the chains, into the move's accumulator.

The estimator is off-policy: it samples proposals at the current state but
never advances the chains, so it composes with Metropolis at the same step
as the reference's in-order algorithm list does.

Randomness, the reference's: chain c's key is
``fold_in(fold_in(key(seed), _PGE_TAG), c)`` with the Metropolis seed, and
at step t the q-batch of move ``lid`` takes
``split(fold_in(fold_in(key_c, t), lid), q_batch_size)``
(``montecarlo_tpu/policy_guided/estimator.py:83-107``), so the estimator
gives the reference's sums from the same seed, on any device and any rank
count.

On a chain mesh each rank samples its own chains, and each chain's sums
are gathered from every rank before they are added over the chains (where
the reference adds partial sums by ``psum``): every rank then adds the same
values in the same order as one process does, so the accumulators, and
the parameters the update computes from them, are the same on every rank
and on every rank count.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.algorithms import DeviceAlgorithm, _n_calls
from ..core.metropolis import Metropolis, _n_devices
from ..utils import prng
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
        base = prng.fold_in(prng.key(self.seed, self.device), _PGE_TAG)
        keys = prng.fold_in(base[None], torch.arange(sim.n_chains,
                                                     device=self.device))
        gd = tuple(init_gradient_data(p, device=self.device)
                   for p in self.param_dims)
        obj = torch.zeros((len(self.learn_ids),), dtype=torch.float32,
                          device=self.device)
        return {"keys": keys, "gd": gd, "obj": obj}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        gds = list(slc["gd"])
        obj = slc["obj"].clone()
        params = dstate[self.metropolis.params_key]
        q = self.q_batch_size
        # the q-batch: each chain's q copies side by side on the chain axis
        state = dstate["sys"] if q == 1 else tree_map(
            lambda x: x.repeat_interleave(q, dim=0), dstate["sys"])
        step_keys = prng.fold_in(slc["keys"], t)
        for acc_idx, lid in enumerate(self.learn_ids):
            ks = prng.split(prng.fold_in(step_keys, lid), q)
            per = sample_gradient_data(self.movedefs[lid], params[lid], state,
                                       ks.reshape(-1, 2))
            # over each chain's q-batch, then over the chains
            per_chain = tree_map(
                lambda x: x.reshape((-1, q) + x.shape[1:]).sum(1), per)
            if self.mesh is not None:
                # every chain's sums on every rank, one all_gather a field,
                # so the sum over the chains is the one-process sum
                per_chain = tree_map(self.mesh.all_gather, per_chain)
            total = tree_map(lambda x: x.sum(0).to(x.dtype), per_chain)
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
