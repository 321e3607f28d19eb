"""Helpers of the event-chain tests: the JAX package's draws of one event,
fed to the port's hooks.

:class:`ReferenceEventDraws` follows the draws protocol of
``montecarlo_tpu_torch.core.ecmc.KeyEventDraws`` with the numbers the
reference's hooks derive from each chain's event key: ``split(key, 2)``
(hard disks) or ``split(key, 3)`` (LJ, polydisperse) for the active
particle, the direction and the loop's key, one ``split`` of that key per
loop iteration for the thresholds (``montecarlo_tpu/models/
hard_disks.py:368-373``, ``lennard_jones.py:588-610``,
``polydisperse.py:420-445``), and the key itself for the zig-zag's uniform
and initial direction (``particle1d.py:242-255``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY = float(np.finfo(np.float32).tiny)


def T(x):
    """A CPU tensor of a JAX or numpy array's values."""
    return torch.as_tensor(np.array(x))


class ReferenceEventDraws:
    """The reference's draws of one event for the chains whose event keys
    are ``keys`` (a (M,) array of JAX keys); ``n_split`` is the arity of the
    hook's first ``split``."""

    def __init__(self, keys, n_split=2):
        self.keys = keys
        self.n_split = n_split
        self._loop = None
        self._next = 0

    def start(self, n, dim):
        ks = jax.vmap(lambda k: jax.random.split(k, self.n_split))(self.keys)
        a0 = jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(ks[:, 0])
        d = jax.vmap(lambda k: jax.random.randint(k, (), 0, dim))(ks[:, 1])
        if self.n_split > 2:
            self._loop = ks[:, 2]
        return T(a0).long(), T(d).long()

    def thresholds(self, i, n):
        assert i == self._next, (i, self._next)
        self._next += 1
        ks = jax.vmap(jax.random.split)(self._loop)
        self._loop = ks[:, 0]
        return T(jax.vmap(lambda k: jax.random.uniform(
            k, (n,), minval=TINY, maxval=1.0))(ks[:, 1]))

    def uniform(self, dtype=torch.float32):
        jdtype = {torch.float32: jnp.float32, torch.float64: jnp.float64}
        return T(jax.vmap(lambda k: jax.random.uniform(
            k, (), jdtype[dtype], minval=TINY))(self.keys))

    def bernoulli(self):
        return T(jax.vmap(jax.random.bernoulli)(self.keys))


def chain_keys(seed, m):
    """(M,) event keys, one a chain."""
    return jax.random.split(jax.random.key(seed), m)
