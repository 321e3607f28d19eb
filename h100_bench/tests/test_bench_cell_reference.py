"""The ``ka2d_large`` reference's own pieces: its threefry2x32 against the
Random123 known-answer vectors and its draws against ``jax.random`` on the
CPU (computed in a process of their own, so that no test process of the
benchmark holds JAX), its segment draws and plan against the program's,
and a process that loads the reference alone loading neither the program
nor JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_helpers import HERE, ROOT  # puts the harness on the path
from harness import guard

sys.path.insert(0, os.path.join(HERE, "configs"))
import ka2d_large_reference as ref  # noqa: E402


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, count, want):
    assert tuple(int(w) for w in ref.threefry2x32(*key, *count)) == want


SEEDS = [0, 42, 2 ** 31 - 1, 2 ** 32 - 5]

#: ``jax.random``'s draws of each seed, computed by JAX on the CPU
_JAX = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
out = {}
for seed in json.loads(sys.argv[1]):
    k = jax.random.key(np.uint32(seed))
    ks = jax.vmap(jax.random.fold_in, (None, 0))(k, jnp.arange(64))
    out[str(seed)] = {
        "key": jax.random.key_data(k),
        "fold_in": jax.random.key_data(jax.random.fold_in(k, 0x5A1F7)),
        "split": jax.random.key_data(jax.random.split(k, 3)),
        "bits": jax.random.bits(k, (1000,), jnp.uint32),
        "uniform": jax.random.uniform(k, (4096,)),
        "uniform_pm": jax.random.uniform(k, (512,), minval=-1.0,
                                         maxval=1.0),
        "randint": jax.vmap(lambda q: jax.random.randint(q, (), 0, 4))(ks),
        "normal": jax.random.normal(k, (4096,))}
    out[str(seed)] = {n: np.asarray(v).tolist()
                      for n, v in out[str(seed)].items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_draws():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX, json.dumps(SEEDS)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax(seed, jax_draws):
    want = {n: np.asarray(v) for n, v in jax_draws[str(seed)].items()}
    k = ref.key(seed)
    np.testing.assert_array_equal(k, want["key"])
    np.testing.assert_array_equal(ref.fold_in(k, 0x5A1F7), want["fold_in"])
    np.testing.assert_array_equal(ref.split(k, 3), want["split"])
    np.testing.assert_array_equal(ref.bits(k, 1000), want["bits"])


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_equal_jax(seed, jax_draws):
    want = {n: np.asarray(v) for n, v in jax_draws[str(seed)].items()}
    k = ref.key(seed)
    np.testing.assert_array_equal(ref.uniform(k, 4096),
                                  want["uniform"].astype(np.float32))
    np.testing.assert_array_equal(ref.uniform(k, 512, -1.0, 1.0),
                                  want["uniform_pm"].astype(np.float32))
    np.testing.assert_array_equal(ref.randint(ref.fold_in(
        k[None], np.arange(64)), 4), want["randint"])
    # XLA's log1p and the CPU's differ at the last bit on a few values
    np.testing.assert_array_max_ulp(ref.normal(k, 4096, "cpu"),
                                    want["normal"].astype(np.float32),
                                    maxulp=4)


def test_fma_rounds_once():
    """Where the float64 sum lands on a float32 midpoint that the exact sum
    is not on, float64 then float32 rounds twice; the fused result goes to
    the side of the exact sum."""
    one = np.float32(1.0)
    a = np.float32(1.0 + 2.0 ** -12)          # a * a: 1 + 2^-11 + 2^-24,
    c = np.float32([2.0 ** -60, -2.0 ** -60, 0.0])   # a float32 midpoint
    got = ref.fma32(np.full(3, a), np.full(3, a), c)
    lo = np.float32(1.0 + 2.0 ** -11)
    hi = np.nextafter(lo, np.float32(2.0))
    np.testing.assert_array_equal(got, [hi, lo, lo])
    twice = (np.float64(a) * np.float64(a) + c.astype(np.float64)).astype(
        np.float32)
    assert twice[0] == lo                     # the trap itself
    rng = np.random.default_rng(5)
    x, y, z = (rng.standard_normal(64).astype(np.float32) for _ in range(3))
    from fractions import Fraction
    for xi, yi, zi, g in zip(x, y, z, ref.fma32(x, y, z)):
        exact = Fraction(float(xi)) * Fraction(float(yi)) + Fraction(
            float(zi))
        near = [np.nextafter(g, -one * np.inf), g, np.nextafter(g, one * np.inf)]
        assert min(near, key=lambda v: abs(Fraction(float(v)) - exact)) == g


def test_segment_draws_equal_the_programs():
    """The reference's variants, origins and substep draws equal the
    program's ``KeyDraws`` on the CPU, bit for bit."""
    from montecarlo_tpu_torch.ops.cell_mc import KeyDraws
    seed, t0, m, h, cap, n = 1234567891, 327680 * 37, 3, 6, 16, 24
    kd = KeyDraws(seed, t0, torch.arange(m))
    base = ref.segment_keys(seed, t0)
    seq = kd.variants(n, 4, 0.8, 0.2, True, False)
    np.testing.assert_array_equal(seq, ref.variants(base, n, 0.8))
    np.testing.assert_array_equal(kd.shift(m, 2, "cpu").numpy(),
                                  ref.origins(base, np.arange(m)))
    keys = ref.split(ref.fold_in(ref.fold_in(base[None], np.arange(m))[
        :, None], np.arange(n)), 3)
    for i, (kind, _) in enumerate(seq):
        a, b, c = kd.substep(i, kind, m, h, cap, 2, "gaussian", "cpu")
        second = (ref.uniform(keys[:, i, 1], h * h * cap) if kind
                  else ref.normal(keys[:, i, 1], h * h * 2, "cpu"))
        for got, want in ((a, ref.uniform(keys[:, i, 0], h * h * cap)),
                          (b, second), (c, ref.uniform(keys[:, i, 2],
                                                       h * h))):
            np.testing.assert_array_equal(got.numpy().reshape(m, -1), want)


@pytest.mark.parametrize("n,seed", [(512, 3), (2048, 8)])
def test_plan_equals_the_programs(n, seed):
    from montecarlo_tpu_torch.core.metropolis import _max_cell_occupancy
    from montecarlo_tpu_torch.models import lennard_jones as lj
    from montecarlo_tpu_torch.ops.cell_mc import plan_grid
    chains = lj.init_chains(4, n, rho=1.2, beta=2.0, frac_b=0.35,
                            seed=seed, device="cpu")
    box = float(chains.box[0])
    nc, cap = ref.plan(n, box, 2.5, chains.pos.numpy())
    grid = plan_grid(n, box, 2.5, max_occupancy=_max_cell_occupancy(
        chains, plan_grid(n, box, 2.5).nc, 2))
    assert (nc, cap) == (grid.nc, grid.cap)


def test_reference_loads_neither_the_program_nor_jax():
    code = f"""
import json, sys
sys.path[:0] = [{os.path.join(HERE, 'configs')!r}, {HERE!r}]
import ka2d_large_reference
print(json.dumps(sorted(sys.modules)))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert guard.forbidden_loaded(modules) == []
    assert not [m for m in modules if m.startswith("montecarlo_tpu_torch")]
