"""Policy-guided Monte Carlo (PGMC): adaptive proposal parameters.

Port of ``montecarlo_tpu/policy_guided`` (ref ``src/PolicyGuided/``), with
``torch.autograd`` as its one AD backend.  The export surface is the JAX
package's.
"""

from .gradients import (GradientData, add, average, init_gradient_data,
                        pgmc_estimate, sample_gradient_data)
from .learning import (ANPG, BLANPG, BLAPG, BLPG, NPG, VPG, PolicyGradient,
                       Static, learning_step)
from .estimator import PolicyGradientEstimator
from .update import PolicyGradientUpdate

__all__ = [
    "GradientData", "add", "average", "init_gradient_data",
    "pgmc_estimate", "sample_gradient_data",
    "PolicyGradient", "Static", "VPG", "BLPG", "BLAPG", "NPG", "ANPG",
    "BLANPG", "learning_step",
    "PolicyGradientEstimator", "PolicyGradientUpdate",
]
