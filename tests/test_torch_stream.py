"""The PyTorch port's counter-hash stream against the JAX package's.

``montecarlo_tpu_torch.ops.fused_sweep`` reproduces the reference's
interpret-mode random stream (``software_bits``, ``_hash32``,
``_uniform_from_bits``, ``_shard_seed``) in int64 tensors masked to 32 bits.
The bits must be equal exactly, for every seed including negative ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops import fused_sweep as ref
from montecarlo_tpu_torch.ops import fused_sweep as port

SEEDS = [0, 1, 1234, -5, -2 ** 31, 2 ** 31 - 1]
SHAPES = [(8, 128), (3, 5), (16,)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("draw", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_software_bits_equal_reference(seed, draw, shape):
    want = np.asarray(ref.software_bits(jnp.int32(seed), draw, shape))
    got = port.software_bits(seed, draw, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_hash_and_uniform_equal_reference():
    rng = np.random.default_rng(0)
    s = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(np.int32)
    want = np.asarray(ref._hash32(jnp.asarray(s))).view(np.uint32)
    got = port._hash32(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the scalar form used for per-pair seeds
    assert [port._hash32(int(v)) for v in s[:16]] == \
        [int(v) for v in want[:16]]

    u_want = np.asarray(ref._uniform_from_bits(jnp.asarray(want)))
    u_got = port._uniform_from_bits(got)
    assert u_got.dtype == torch.float32
    np.testing.assert_array_equal(u_got.numpy(), u_want)
    assert u_got.min() > 0.0 and u_got.max() <= 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_shard_seed_equals_reference(seed):
    shards = 4
    want = jax.vmap(lambda s: ref._shard_seed("i", s), axis_name="i")(
        jnp.full((shards,), seed, jnp.int32))
    want = np.asarray(want).view(np.uint32).astype(np.int64)
    got = [port._shard_seed(i, seed) for i in range(shards)]
    assert got == want.tolist()
