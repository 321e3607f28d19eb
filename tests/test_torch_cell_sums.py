"""The cell path's stated sum order (``ops/cell_mc.py``, "Sum order"): each
sum of float32 terms that decides a move or a chain's energy accumulates
in float64 and is rounded to float32 once, so its bits do not depend on
the order the terms are added in.

A substep of every variant runs on LJ chains with the port's own draws;
every sum it makes is recorded with its terms and held, bit for bit, to
numpy's float64 sum of the same terms in a shuffled order, rounded once;
the substep's energy changes are then the recorded neighbourhood sums'
differences, and its chain sums those of the accepted changes.
"""

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.ops import cell_mc

LJP = lj.LJParams()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rounded_once(terms, dims, rng):
    """float32 of numpy's float64 sum of ``terms`` over ``dims``, the
    summed entries shuffled first."""
    x = np.moveaxis(terms.numpy().astype(np.float64), dims,
                    tuple(range(-len(dims), 0)))
    x = x.reshape(x.shape[:x.ndim - len(dims)] + (-1,))
    x = x[..., rng.permutation(x.shape[-1])]
    return np.sum(x, axis=-1).astype(np.float32)


@pytest.mark.parametrize("kind,color", [(k, c) for k in (0, 1)
                                        for c in range(4)])
def test_substep_sums_are_float64_rounded_once(kind, color, monkeypatch):
    chains = lj.init_chains(2, 512, rho=1.2, beta=1.0 / 0.45, frac_b=0.35,
                            seed=9, device="cpu")
    pe, rc2, rcut = lj.cell_closures(LJP)
    grid = cell_mc.plan_grid(512, float(chains.box[0]), rcut)
    draws = cell_mc.KeyDraws(21, 4096, torch.arange(2))
    s = torch.remainder(chains.pos / chains.box[:, None, None]
                        + draws.shift(2, 2, "cpu")[:, None, :], 1.0)
    P = cell_mc._pack(cell_mc.bind_cells(grid, s, chains.species.float()))
    seen = []
    real = cell_mc._sum32

    def recording(x, dim):
        out = real(x, dim)
        seen.append((x.clone(), dim, out.clone()))
        return out

    monkeypatch.setattr(cell_mc, "_sum32", recording)
    variants, _ = cell_mc._make_substep(
        grid, pe, rc2, "species" if kind == 1 else None)
    d = draws.substep(0, kind, 2, grid.nc // 2, grid.cap, 2, "gaussian",
                      "cpu")
    d_e, n_att, n_acc = variants[kind][color](
        P, chains.box, torch.tensor(0.08), chains.beta, *d)
    assert int(n_att.sum()) > 0 and int(n_acc.sum()) > 0

    rng = np.random.default_rng(kind * 4 + color)
    for x, dim, out in seen:
        dims = (dim,) if isinstance(dim, int) else tuple(dim)
        assert x.dtype == torch.float32 and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(),
                                      _rounded_once(x, dims, rng))
    # the neighbourhood energies in one sum, then the chain sums of the
    # accepted dE: a displacement's rows at the new and the old position, a
    # swap's four rows (i and j as they are, then exchanged)
    assert len(seen) == 2
    (_, _, e), (gained, _, chain_sum) = seen
    assert e.shape[0] == (2 if kind == 0 else 4)
    per_cell = (e[0] - e[1] if kind == 0
                else (e[2] + e[3]) - (e[0] + e[1]))
    accepted = gained != 0
    np.testing.assert_array_equal(
        gained[accepted].numpy(),
        per_cell.reshape(gained.shape)[accepted].numpy())
    np.testing.assert_array_equal(d_e.numpy(), chain_sum.numpy())


def test_float32_order_would_show():
    """Terms whose float32 sum depends on the order, as a neighbourhood's
    can: the stated sum gives one answer for every order."""
    rng = np.random.default_rng(3)
    terms = torch.tensor(np.concatenate([
        rng.uniform(-2.0, 2.0, 280), rng.uniform(-1e-6, 1e-6, 8),
        [40.0, -39.5]]).astype(np.float32))
    orders = [torch.as_tensor(rng.permutation(terms.numel()))
              for _ in range(32)]
    # float32 added in turn, each partial sum rounded
    plain = {float(np.cumsum(terms[o].numpy(), dtype=np.float32)[-1])
             for o in orders}
    stated = {float(cell_mc._sum32(terms[o], 0)) for o in orders}
    assert len(plain) > 1
    assert len(stated) == 1
