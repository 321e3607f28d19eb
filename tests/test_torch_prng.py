"""The port's ``jax.random`` stream (``utils/prng.py``) against JAX's own.

Every function takes a batch of keys and must equal ``jax.vmap`` of the
per-key ``jax.random`` call on the same key words: bit for bit for
``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform``, ``randint``
(int8 and int16 too), ``bernoulli`` and ``split_uniform`` (the event
loops' ``k, kthr = split(k)`` and uniforms); ``normal`` within 4 float32
ulps (its ``log1p`` is
torch's, not XLA's, which differ at the last bit); ``gumbel`` within 2e-6
absolute (two logs); ``categorical`` the same picks on the tested keys.
The keys are made from the seeds 0, 42 and 2**31 - 1.  On the CPU the
functions take the threefry block function's plain version, whose numpy
uint32 rounds are held against Python integers at words that wrap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.ops.threefry import threefry
from montecarlo_tpu_torch.utils import prng
from torch_lattice_helpers import warm_up_transcendentals

warm_up_transcendentals()

SEEDS = (0, 42, 2 ** 31 - 1)
SHAPES = [(), (5,), (3, 4), (2, 3, 5)]
SPANS = (1, 3, 255, 256, 1023, 1024)
NORMAL_ULPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once, and
    the many small ops of the plain threefry version slow down sharply when
    threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n=6):
    """(n * len(SEEDS), 2) key words from the seeds, each folded with a
    few chain ids as the engine makes them, in both packages."""
    ids = jnp.arange(n, dtype=jnp.uint32)
    ref = jnp.concatenate([
        jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(s), ids)
        for s in SEEDS])
    return ref, interop.keys_from_reference(jax.random.key_data(ref),
                                            device="cpu")


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS + (2 ** 32 - 1, 2 ** 32 + 5, -1,
                                          2 ** 63 - 1, -2 ** 63))
def test_key_equals_reference(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    got = prng.key(seed, device="cpu")
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


def test_key_refuses_seeds_beyond_int64():
    for seed in (2 ** 63, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            jax.random.key(seed)
        with pytest.raises(OverflowError):
            prng.key(seed, device="cpu")


@pytest.mark.parametrize("data", [0, 7, 2 ** 32 - 1])
def test_fold_in_equals_reference(data):
    ref, keys = _keys()
    want = jax.random.key_data(jax.vmap(
        lambda k: jax.random.fold_in(k, np.uint32(data)))(ref))
    np.testing.assert_array_equal(prng.fold_in(keys, data).numpy(), want)
    # per-key data and one key broadcast over a batch of data
    ids = jnp.arange(keys.shape[0], dtype=jnp.uint32) * 977
    want = jax.random.key_data(jax.vmap(jax.random.fold_in)(ref, ids))
    got = prng.fold_in(keys, torch.as_tensor(np.asarray(ids, np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    want = jax.random.key_data(jax.vmap(jax.random.fold_in, (None, 0))(
        ref[1], ids))
    np.testing.assert_array_equal(
        prng.fold_in(keys[1], torch.as_tensor(np.asarray(ids, np.int64)))
        .numpy(), want)


@pytest.mark.parametrize("num", [2, 3, 7, (2, 3)])
def test_split_equals_reference(num):
    ref, keys = _keys()
    want = jax.random.key_data(jax.vmap(
        lambda k: jax.random.split(k, num))(ref))
    got = prng.split(keys, num)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli_equal_reference(shape):
    ref, keys = _keys()
    want = jax.vmap(lambda k: jax.random.bits(k, shape))(ref)
    np.testing.assert_array_equal(prng.random_bits(keys, shape).numpy(), want)
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-2.0, 3.0), (1e-3, 7.7)):
        want = jax.vmap(lambda k: jax.random.uniform(
            k, shape, minval=lo, maxval=hi))(ref)
        got = prng.uniform(keys, shape, minval=lo, maxval=hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    want = jax.vmap(lambda k: jax.random.bernoulli(k, 0.3, shape))(ref)
    np.testing.assert_array_equal(prng.bernoulli(keys, 0.3, shape).numpy(),
                                  want)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("shape", [(), (4,), (3, 4)])
def test_randint_equals_reference(shape, span):
    ref, keys = _keys()
    for lo in (0, -7):
        want = jax.vmap(lambda k: jax.random.randint(
            k, shape, lo, lo + span))(ref)
        got = prng.randint(keys, shape, lo, lo + span)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_per_key_bounds_and_wide_spans():
    """The LJ swap's per-chain bound ``max(n_a, 1)``, an empty range and
    spans above 2**16, where JAX's uint32 multiplier wraps to 0."""
    ref, keys = _keys()
    hi = jnp.asarray(np.arange(keys.shape[0]) * 37 % 50, jnp.int32)
    want = jax.vmap(lambda k, h: jax.random.randint(k, (), 0, h))(ref, hi)
    got = prng.randint(keys, (), 0, torch.as_tensor(np.array(hi)))
    np.testing.assert_array_equal(got.numpy(), want)
    for lo, span in ((5, 999995), (0, 2 ** 20 + 3), (-2 ** 30, 2 ** 31 - 1)):
        want = jax.vmap(lambda k: jax.random.randint(
            k, (7,), lo, lo + span))(ref)
        np.testing.assert_array_equal(
            prng.randint(keys, (7,), lo, lo + span).numpy(), want)


@pytest.mark.parametrize("shape", [(), (3,), (64, 40)])
def test_normal_within_ulps_of_reference(shape):
    ref, keys = _keys()
    want = jax.vmap(lambda k: jax.random.normal(k, shape))(ref)
    got = prng.normal(keys, shape)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= NORMAL_ULPS


def test_normal_many_values_within_ulps():
    """2 x 10^5 draws: almost all bit for bit, none beyond the bound."""
    ref = jax.random.split(jax.random.key(42), 200)
    keys = interop.keys_from_reference(jax.random.key_data(ref), "cpu")
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (1000,)))(ref))
    ulps = _ulps(prng.normal(keys, (1000,)).numpy(), want)
    assert ulps.max() <= NORMAL_ULPS
    assert (ulps == 0).mean() > 0.98


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_gumbel_and_categorical_follow_reference(shape):
    ref, keys = _keys(40)
    want = jax.vmap(lambda k: jax.random.gumbel(k, shape))(ref)
    np.testing.assert_allclose(prng.gumbel(keys, shape).numpy(), want,
                               rtol=0, atol=2e-6)
    for logits in ([0.0], np.log([0.2, 0.5, 0.3]), np.log([0.9, 0.05] * 3)):
        logits = np.asarray(logits, np.float32)
        want = jax.vmap(lambda k: jax.random.categorical(
            k, jnp.asarray(logits)))(ref)
        got = prng.categorical(keys, torch.as_tensor(logits))
        np.testing.assert_array_equal(got.numpy(), want)


def test_float64_uniform_equals_reference_under_x64():
    """float64 draws take the block's two words, as JAX's 64-bit bits."""
    with jax.enable_x64(True):
        ref = jax.random.split(jax.random.key(3), 20)
        keys = interop.keys_from_reference(jax.random.key_data(ref), "cpu")
        want = jax.vmap(lambda k: jax.random.uniform(
            k, (50,), jnp.float64))(ref)
        got = prng.uniform(keys, (50,), torch.float64)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threefry_modes_agree_with_each_other():
    """The block function's finishes from one evaluation: bits are the
    words' xor, a uniform is the bits' mantissa, a split equals the words
    at iota counts, and fold_in the words at (0, data)."""
    _, keys = _keys()
    words = threefry(keys, 6, "words").to(torch.int64)
    bits = threefry(keys, 6, "bits").to(torch.int64)
    assert torch.equal(words[..., 0] ^ words[..., 1], bits)
    u = threefry(keys, 6, "uniform")
    want = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1
    assert torch.equal(u, want)
    data = torch.arange(keys.shape[0], dtype=torch.int64).to(torch.uint32)
    assert torch.equal(prng.fold_in(keys, data),
                       threefry(keys, 1, "words", data=data)[:, 0])


def test_misuse_raises():
    _, keys = _keys()
    with pytest.raises(TypeError):
        prng.uniform(keys.to(torch.int64))
    with pytest.raises(TypeError):
        prng.fold_in(keys, 1.5)
    with pytest.raises(ValueError):
        threefry(keys, 2, "nonsense")
    with pytest.raises(TypeError):
        prng.normal(keys, (), torch.float64)


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (64,)])
@pytest.mark.parametrize("minval", [0.0, 1.1754943508222875e-38])
def test_split_uniform_equals_reference(shape, minval):
    """``split_uniform``, one step of the soft-potential event loops: the
    successor ``k`` and the values ``uniform(kthr, shape, minval=minval)``
    of ``k, kthr = split(key)`` bit for bit, and the same as the separate
    ``split`` and ``uniform``."""
    ref, keys = _keys()

    def one(k):
        k, kthr = jax.random.split(k)
        return (jax.random.key_data(k),
                jax.random.uniform(kthr, shape, minval=minval))

    want_k, want_u = jax.vmap(one)(ref)
    got_k, got_u = prng.split_uniform(keys, shape, minval=minval)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    k = prng.split(keys)
    assert torch.equal(got_k, k[:, 0])
    assert torch.equal(got_u, prng.uniform(k[:, 1], shape, minval=minval))


@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("span", [2, 3, 4, 7, 100])
def test_randint_narrow_dtypes_equal_reference(dtype, span):
    """An int8 or int16 ``randint`` (the Potts colours) is drawn at 32
    bits and converted, as JAX draws it."""
    ref, keys = _keys()
    want = jax.vmap(lambda k: jax.random.randint(
        k, (3, 4), 0, span, dtype=getattr(jnp, dtype)))(ref)
    got = prng.randint(keys, (3, 4), 0, span, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_block_wraps_as_uint32():
    """The plain twin's rounds in numpy uint32 against the block computed
    with Python integers masked to 32 bits, at keys and counts near 2**32
    (every addition wraps)."""
    from montecarlo_tpu_torch.ops.threefry import block

    def slow(k0, k1, x0, x1):
        m = 0xFFFFFFFF
        rot = ((13, 15, 26, 6), (17, 29, 16, 24))
        ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
        x0, x1 = (x0 + k0) & m, (x1 + k1) & m
        for i in range(5):
            for r in rot[i % 2]:
                x0 = (x0 + x1) & m
                x1 = ((x1 << r) | (x1 >> (32 - r))) & m
                x1 ^= x0
            x0 = (x0 + ks[(i + 1) % 3]) & m
            x1 = (x1 + ks[(i + 2) % 3] + i + 1) & m
        return x0, x1

    vals = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
            0x1BD11BDA, 12345]
    for k0 in vals:
        for k1 in vals[::-1]:
            got = block(*(np.array([v], np.uint32)
                          for v in (k0, k1, 0xFFFFFFFF, k0 ^ 5)))
            want = slow(k0, k1, 0xFFFFFFFF, k0 ^ 5)
            assert (int(got[0][0]), int(got[1][0])) == want
