"""Helpers of the lattice tests: one torch thread a test module, and the
JAX package's draws of a batch of chains, derived from their keys as the
reference's steps derive them, as CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu_torch import interop
from torch_ecmc_helpers import T

TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def warm_up_transcendentals():
    """Call each transcendental the comparisons use once before any of them.

    On the MKL build of torch the first call of a vector math function in a
    process can come back at reduced accuracy (relative error ~1e-4 on a
    few percent of the elements; later calls are accurate:
    ``tests/torch_first_call_probe.py``).  A test module calls this at
    import, which pytest does in every worker before any test runs; on one
    thread and on many (a tensor above the intra-op grain size)."""
    for n in (64, 1 << 17):
        u = torch.linspace(0.01, 0.99, n)
        for fn in (torch.log, torch.log1p, torch.cos, torch.sin, torch.exp,
                   torch.sqrt, torch.tanh):
            fn(u)
        torch.atan2(u, u.flip(0))
        torch.linalg.norm(u.reshape(-1, 2), dim=-1)


def carry(ref_state, cls, fields=("spins", "beta", "j", "energy")):
    """The reference's chains as the port's ``cls`` on the CPU."""
    return interop.chains_from_reference(
        {k: np.asarray(getattr(ref_state, k)) for k in fields},
        device="cpu", cls=cls)


def ref_keys(seed, m):
    """``m`` chain keys of the reference, split from ``key(seed)``."""
    return jax.random.split(jax.random.key(seed), m)


def vsplit(keys, n):
    ks = jax.vmap(lambda k: jax.random.split(k, n))(keys)
    return [ks[:, i] for i in range(n)]


def vuniform(keys, shape, minval=0.0):
    return T(jax.vmap(lambda k: jax.random.uniform(
        k, shape, jnp.float32, minval=minval))(keys))


def vnormal(keys, shape):
    return T(jax.vmap(lambda k: jax.random.normal(k, shape,
                                                  jnp.float32))(keys))


def vrandint(keys, shape, lo, hi, dtype=jnp.int32):
    return T(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi,
                                                   dtype=dtype))(keys))
