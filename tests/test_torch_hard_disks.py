"""2-D hard disks in the port (``models/hard_disks.py``) against the JAX
package's: the state carried both ways by ``interop``, the observables
(``min_pair_distance``, ``psi6``, dense and row-batched) within rtol 1e-5
on the same chains, the generic displacement move by statistics (its
acceptance against the reference's, the hard core kept), and the cell-MC
path through ``Simulation.run`` (the reference's ``test_hard_disk_cell_path``
gate: overlap-free, acceptance in (0.1, 0.99), psi6 in [0, 1]).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import montecarlo_tpu as mc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu.models import hard_disks as ref_hd
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.core.moves import MoveFamily
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.ops.cell_mc import CellModel
from torch_cell_helpers import assert_same_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_state_roundtrips_through_interop():
    ref = ref_hd.init_chains(3, 64, eta=0.5, seed=1)
    st = interop.chains_from_reference(ref, device="cpu")
    assert type(st) is hd.HardDiskState
    assert st.pos.dtype == torch.float32 and st.pos.shape == (3, 64, 2)
    back = interop.chains_to_reference(st)
    assert set(back) == {"pos", "box"}
    ref2 = ref_hd.HardDiskState(**back)
    np.testing.assert_array_equal(np.asarray(ref2.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(np.asarray(ref2.box), np.asarray(ref.box))
    # a mapping with pos and box only is a hard-disk state; x stays
    # particle-1d
    assert type(interop.chains_from_reference(
        {"pos": np.zeros((1, 2, 2)), "box": np.ones(1)},
        device="cpu")) is hd.HardDiskState
    assert type(interop.chains_from_reference(
        {"x": np.zeros(2), "beta": np.ones(2), "e": np.zeros(2)},
        device="cpu")).__name__ == "Particle1DState"


def test_init_chains():
    st = hd.init_chains(2, 100, eta=0.6, seed=3, device="cpu")
    ref = ref_hd.init_chains(2, 100, eta=0.6, seed=3)
    assert st.pos.device.type == "cpu" and st.pos.shape == (2, 100, 2)
    np.testing.assert_allclose(st.box.numpy(), np.asarray(ref.box))
    assert bool(hd.overlap_free(st).all())
    assert bool((st.pos >= 0).all()) and bool((st.pos < st.box[0]).all())
    with pytest.raises(ValueError, match="too dense"):
        hd.init_chains(1, 100, eta=0.8, device="cpu")


@pytest.mark.parametrize("n,eta", [(64, 0.5), (1100, 0.7)])
def test_observables_match_reference(n, eta):
    """``min_pair_distance`` and ``psi6`` on carried states (row-batched
    beyond N 1024 on both sides); an overlap is seen as one."""
    ref = ref_hd.init_chains(2, n, eta=eta, seed=5)
    pos = np.array(ref.pos)
    pos[1, 1] = pos[1, 0] + np.float32(0.3)      # chain 1 overlaps
    ref = ref_hd.HardDiskState(pos=jax.numpy.asarray(pos), box=ref.box)
    st = interop.chains_from_reference(ref, device="cpu")
    want_d = np.asarray(jax.jit(jax.vmap(ref_hd.min_pair_distance))(ref))
    want_p = np.asarray(jax.jit(jax.vmap(ref_hd.psi6))(ref))
    np.testing.assert_allclose(hd.min_pair_distance(st).numpy(), want_d,
                               rtol=1e-5)
    np.testing.assert_allclose(hd.psi6(st).numpy(), want_p, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(hd.overlap_free(st).numpy(),
                                  [True, False])
    view = tmc.SimView(sys=st, params=(), t=0, state={})
    assert float(hd.callback_min_distance(view)) == pytest.approx(
        float(want_d.mean()), rel=1e-5)
    assert float(hd.callback_psi6(view)) == pytest.approx(
        float(want_p.mean()), rel=1e-5, abs=1e-6)


def test_cell_closures_are_an_infinite_wall():
    pe, rc2, rcut = hd.cell_closures()
    r2 = torch.tensor([0.25, 0.81, 1.5])
    assert rcut == 1.0 and rc2(None, None) == 1.0
    assert bool(torch.isinf(pe(r2, None, None)).all())
    # an overlap is rejected even for an exact-0.0 uniform
    assert not bool(torch.log(torch.tensor(0.0)) < -1.0 * torch.inf)


def _generic_run(pkg, mod, chains, path, steps=400):
    sim = pkg.Simulation(mod.make_system(), chains, [
        dict(algorithm=pkg.Metropolis, pool=(mod.displacement_move(0.15),),
             seed=7, sweepstep=16, fused="off")], steps, path=str(path))
    sim.run()
    cnt = np.asarray(sim.device_state["metropolis"]["counters"])
    return sim, cnt[:, 0, 0].sum() / cnt[:, 0, 1].sum()


def test_generic_displacement_matches_reference_by_statistics(tmp_path):
    """The generic path from the same chains: the hard core holds, and the
    acceptance agrees with the reference's within its binomial error."""
    ref_chains = ref_hd.init_chains(16, 64, eta=0.6, seed=8)
    ref_sim, ref_rate = _generic_run(mc, ref_hd, ref_chains,
                                     tmp_path / "ref")
    sim, rate = _generic_run(
        tmc, hd, interop.chains_from_reference(ref_chains, device="cpu"),
        tmp_path / "port")
    assert bool(hd.overlap_free(sim.device_state["sys"]).all())
    n = 16 * 400 * 16
    se = np.sqrt(2 * rate * (1 - rate) / n)
    assert 0.1 < rate < 0.99
    # both chains start from the same lattice and relax alike; the spread
    # between runs exceeds the binomial error, so allow 6 of it plus 1 %
    assert abs(rate - ref_rate) < 6 * se + 0.01, (rate, ref_rate, se)


def test_hard_disk_cell_path(tmp_path):
    """Hard disks through the cell path: accept iff overlap-free (the
    infinite wall), the hard core kept, the square proposal."""
    n, m, steps = 1024, 4, 30
    chains = hd.init_chains(m, n, eta=0.70, seed=40, device="cpu")
    sim = tmc.Simulation(hd.make_system(), chains, [
        dict(algorithm=tmc.Metropolis, pool=(hd.displacement_move(0.12),),
             seed=5, sweepstep=128, fused="cell"),
        dict(algorithm=tmc.StoreCallbacks, callbacks=(hd.callback_psi6,),
             scheduler=np.arange(10, steps + 1, 10))],
        steps, path=str(tmp_path))
    met = sim.device_algos[0]
    assert met._use_cell and met._cell_model.model == hd.FAMILY.cell(None)
    assert met._cell_model.model.proposal == "square"
    sim.run()
    slc = sim.device_state["metropolis"]
    assert not bool(slc["cell_overflow"])
    cnt = slc["counters"].numpy()
    rate = cnt[:, 0, 0].sum() / cnt[:, 0, 1].sum()
    assert 0.1 < rate < 0.99, rate
    assert bool(hd.overlap_free(sim.device_state["sys"]).all())
    p6 = np.loadtxt(os.path.join(sim.path, "psi6.dat"))
    assert p6.shape == (4, 2)
    assert np.all((p6[:, 1] >= 0) & (p6[:, 1] <= 1))


def test_a_family_declared_outside_the_package_takes_the_cell_path(tmp_path):
    """The seam: a move family declared here, hard disks' closures under a
    kind tag the package does not know, plans and runs the cell path,
    displacement and volume substeps, equal to ``hard_disks``' own run bit
    for bit."""
    family = MoveFamily(
        roles={"my_disk_move": "disp", "my_disk_volume": "vol"},
        cell=lambda aux: CellModel(*hd.cell_closures(), proposal="square"))

    def mine(move, kind):
        return dataclasses.replace(move, move=dataclasses.replace(
            move.move, kind=kind, family=family))

    pool = (hd.displacement_move(0.12, weight=0.9),
            hd.volume_move(dlnv=0.002, beta_pressure=3.0, weight=0.1))
    runs = []
    for name, p in (("hd", pool), ("mine", (
            mine(pool[0], "my_disk_move"), mine(pool[1], "my_disk_volume")))):
        chains = hd.init_chains(2, 1024, eta=0.5, seed=7, device="cpu")
        sim = tmc.Simulation(hd.make_system(), chains, [
            dict(algorithm=tmc.Metropolis, pool=p, seed=3, sweepstep=64,
                 fused="cell")], 6, path=str(tmp_path / name))
        assert sim.device_algos[0]._use_cell
        sim.run()
        runs.append(sim)
    assert runs[0].device_algos[0]._cell_plan == \
        runs[1].device_algos[0]._cell_plan
    assert_same_state(runs[0].device_state, runs[1].device_state)
    cnt = runs[1].device_state["metropolis"]["counters"].numpy()
    assert cnt[:, 0, 0].sum() > 0 and cnt[:, 1, 1].min() > 0
