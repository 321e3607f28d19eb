"""Helpers of the cell-MC tests: the JAX package's cell-MC draws, fed to
the port's ``ops/cell_mc.py``, a fine-stride schedule, and a bit-for-bit
comparison of device states.

:class:`ReferenceDraws` follows the draws protocol of
``montecarlo_tpu_torch.ops.cell_mc.KeyDraws`` with the numbers the
reference's ``cell_mc_segment`` derives from its base key, so the port's
substeps and segments can be held to the reference's value for value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from montecarlo_tpu_torch.utils.tree import tree_leaves_with_path


def T(x):
    """A CPU tensor of a JAX or numpy array's values."""
    return torch.as_tensor(np.array(x))


class ReferenceDraws:
    """The reference's draws for one segment of base key ``key``: the
    variant stream ``fold_in(fold_in(fold_in(key, 0x7C01), 0xC0110), i)``,
    the shift stream ``fold_in(fold_in(key, 0x5A1F7), 0x0F5E7)`` per chain,
    and per substep ``split(fold_in(fold_in(key, c), i), 3)`` (2 for a
    volume substep) (``montecarlo_tpu/ops/cell_mc.py:605-659``, ``:363``,
    ``:424``, ``:501``)."""

    def __init__(self, key):
        self.key = key

    def variants(self, n, n_colors, w_disp, w_swap, swap, vol):
        base = jax.random.fold_in(jax.random.fold_in(self.key, 0x7C01),
                                  0xC0110)
        w_disp = jnp.asarray(w_disp, jnp.float32)
        w_swap = jnp.asarray(w_swap, jnp.float32)
        out = np.zeros((n, 2), np.int64)
        for i in range(n):
            kv = jax.random.fold_in(base, i)
            out[i, 1] = int(jax.random.randint(kv, (), 0, n_colors))
            if not (swap or vol):
                continue
            u = jax.random.uniform(jax.random.fold_in(kv, 1))
            if not vol:
                kind = jnp.where(u < w_disp, 0, 1)
            elif not swap:
                kind = jnp.where(u < w_disp, 0, 2)
            else:
                kind = jnp.where(u < w_disp, 0,
                                 jnp.where(u < w_disp + w_swap, 1, 2))
            out[i, 0] = int(kind)
        return out

    def shift(self, m, dim, device):
        ks = jax.random.fold_in(jax.random.fold_in(self.key, 0x5A1F7),
                                0x0F5E7)
        sh = jax.vmap(lambda c: jax.random.uniform(
            jax.random.fold_in(ks, c), (dim,)))(jnp.arange(m, dtype=jnp.uint32))
        return T(sh).to(device)

    def _keys(self, i, m):
        chain = jax.vmap(jax.random.fold_in, (None, 0))(
            self.key, jnp.arange(m, dtype=jnp.uint32))
        return jax.vmap(jax.random.fold_in, (0, None))(chain, i)

    def substep(self, i, kind, m, h, cap, dim, proposal, device):
        cells = (h,) * dim

        def one(k):
            k1, k2, k3 = jax.random.split(k, 3)
            first = jax.random.uniform(k1, cells + (cap,))
            if kind == 1:
                second = jax.random.uniform(k2, cells + (cap,))
            elif proposal == "square":
                second = jax.random.uniform(k2, cells + (dim,), minval=-1.0,
                                            maxval=1.0)
            else:
                second = jax.random.normal(k2, cells + (dim,))
            return first, second, jax.random.uniform(k3, cells)

        return tuple(T(x).to(device) for x in jax.vmap(one)(self._keys(i, m)))

    def volume(self, i, m, device):
        def one(k):
            kd, kacc = jax.random.split(k)
            return (jax.random.uniform(kd, (), minval=-1.0, maxval=1.0),
                    jax.random.uniform(kacc, ()))

        return tuple(T(x).to(device) for x in jax.vmap(one)(self._keys(i, m)))


def segment_lengths(steps):
    """A fine-stride schedule: segments of 1, 2 and 3 steps in turn."""
    out, t = [], 0
    while t < steps:
        n = min(1 + len(out) % 3, steps - t)
        out.append(n)
        t += n
    return out


def assert_same_state(a, b):
    """Two device states equal bit for bit: tensors (and their dtypes),
    generators by their state, everything else by ``==``."""
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), path
        elif torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path
