"""PolicyGradientUpdate — consume accumulated gradients, update parameters.

Port of ``montecarlo_tpu/policy_guided/update.py`` (ref
``src/PolicyGuided/update.jl``).  The update writes a new ``params`` tuple
into the owning Metropolis' parameter slot of the device state, so every
chain sees the new proposal distribution at the next step, and a second
sampler's PGMC touches only its own slot.  Schedule the estimator E times
per update and the accumulated ``GradientData`` (a monoid) is averaged
here, then reset (``update.jl:52-54``).
"""

from __future__ import annotations

from ..core.algorithms import DeviceAlgorithm, _n_calls
from ..utils.tree import ravel
from .estimator import PolicyGradientEstimator
from .gradients import average, init_gradient_data
from .learning import learning_step

__all__ = ["PolicyGradientUpdate"]


class PolicyGradientUpdate(DeviceAlgorithm):
    state_key = "pgu"

    def __init__(self, sim, dependencies=(), **_):
        deps = [d for d in dependencies
                if isinstance(d, PolicyGradientEstimator)]
        if len(deps) != 1:
            raise ValueError("PolicyGradientUpdate requires a single "
                             "PolicyGradientEstimator dependency")
        self.estimator = deps[0]
        self.optimisers = self.estimator.optimisers
        self.learn_ids = self.estimator.learn_ids

    def init_state(self, sim):
        return ()

    def step(self, dstate, t):
        est = self.estimator
        slc = dstate[est.state_key]
        pkey = est.metropolis.params_key
        params = list(dstate[pkey])
        gds = list(slc["gd"])
        for idx, lid in enumerate(self.learn_ids):
            gd_avg = average(gds[idx])
            flat, unravel = ravel(params[lid])
            new_flat = learning_step(self.optimisers[lid], flat, gd_avg)
            params[lid] = unravel(new_flat)
            gds[idx] = init_gradient_data(est.param_dims[idx],
                                          dtype=gds[idx].j.dtype,
                                          device=gds[idx].j.device)
        return {**dstate, pkey: tuple(params),
                est.state_key: {**slc, "gd": tuple(gds)}}

    def write_summary(self, io, scheduler):
        io.write("\tPolicyGradientUpdate\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLearnable moves: {[k + 1 for k in self.learn_ids]}\n")
        io.write("\t\tOptimisers:\n")
        for k, opt in enumerate(self.optimisers):
            io.write(f"\t\t\tMove {k + 1}: {opt!r}\n")
