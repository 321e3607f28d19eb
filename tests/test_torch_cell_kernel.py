"""The cell path's substep kernel (``csrc/cell_substep.cu``) on the CPU:
where ``cell_mc_segment`` takes it, what it is handed, and how the segment
keeps its books around it.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it to
its twin there, bit for bit).  Here:

- the dispatch: 2-D LJ float32 state on a CUDA device takes the kernel;
  poly, hard disks, 3-D, float64 and the CPU take the twin, and a run on
  the CPU launches nothing;
- the arguments: the per-chain ``sigma / box``, halo fraction, ``-beta``
  and ``box^2`` and the pair table are the numbers the twin computes;
- the segment: with a stand-in in the kernel's place that runs the twin
  from the kernel's arguments and accumulates in place as the kernel does,
  ``cell_mc_segment``'s kernel path gives the twin's segments, NVT and NPT
  (the energies carried in place, the arguments rebuilt after a volume
  substep).
"""

import contextlib

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.models import hard_disks as hd
from montecarlo_tpu_torch.models import lennard_jones as lj
from montecarlo_tpu_torch.models import polydisperse as poly
from montecarlo_tpu_torch.ops import cell_mc
from montecarlo_tpu_torch.ops._cuda import KERNELS
from montecarlo_tpu_torch.ops.lj_energy import _pair_table

LJP = lj.LJParams()
CPU = torch.device("cpu")
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the pair table -----------------------------------------------------------

def _pair(table, r2, a, b):
    """The table's pair term of probes of label ``a`` against occupants of
    label ``b`` at ``r2``, and whether it lies inside the cutoff."""
    same, is_a = b == a, a == 0.0

    def pick(row):
        return torch.where(same, torch.where(is_a, row[0], row[2]), row[1])

    e4, s2, rc2, sh = (pick(row) for row in
                       (table.e4, table.s2, table.rc2, table.sh))
    inv = s2 / torch.clamp(r2, min=1e-12)
    i6 = inv * inv * inv
    return e4 * (i6 * i6 - i6) - sh, r2 < rc2


# -- the arguments ------------------------------------------------------------

@pytest.mark.parametrize("vol", [None, (512, 1.0)])
@pytest.mark.parametrize("sigma", [0.08, "per_chain"])
def test_kernel_args_are_the_twins_numbers(vol, sigma):
    """(4, M) float32, contiguous: ``sigma / box``, the halo fraction
    (``d_cap / box``, or ``d_cap / box_min`` with volume substeps),
    ``-beta`` and ``box * box``, each as the twin computes it."""
    grid = cell_mc.CellGrid(6, 32, 20.6, 0.45, 2.5)
    box = torch.tensor([20.6, 21.37, 23.0031], dtype=torch.float32)
    beta = torch.tensor([2.2222, 1.0, 0.3], dtype=torch.float32)
    sig = (torch.tensor([0.08, 0.11, 0.013]) if sigma == "per_chain"
           else torch.tensor(sigma))
    args = cell_mc._kernel_args(grid, sig, box, beta, vol)
    assert args.dtype == torch.float32 and args.shape == (4, 3)
    assert args.is_contiguous()
    halo = torch.full_like(box, grid.d_cap) / (
        box if vol is None else torch.full_like(box, grid.box_min))
    assert torch.equal(args[0], (sig / box).expand(3))
    assert torch.equal(args[1], halo)
    assert torch.equal(args[2], -beta)
    assert torch.equal(args[3], box * box)


def test_pair_table_gives_the_closures_pair_terms():
    """The table's pair terms and cutoffs, as the kernel computes them, are
    ``lennard_jones.cell_closures``' bit for bit, for every label pair."""
    pe, rc2_of, _ = lj.cell_closures(LJP)
    rng = np.random.default_rng(0)
    r2 = torch.as_tensor(np.concatenate([
        rng.uniform(0.0, 7.0, 4000), [0.0, 1e-13, 1.0, 6.25, 4.0, 4.84]])
        .astype(np.float32))
    table = _pair_table(LJP)
    for a in (0.0, 1.0):
        for b in (0.0, 1.0):
            ta, tb = torch.full_like(r2, a), torch.full_like(r2, b)
            u, inside = _pair(table, r2, ta, tb)
            assert torch.equal(inside, r2 < rc2_of(ta, tb))
            assert torch.equal(u[inside], pe(r2, ta, tb)[inside])
            assert bool(inside.any()) and not bool(inside.all())


# -- the dispatch -------------------------------------------------------------

@pytest.mark.parametrize("family,dim,device,dtype,takes", [
    ("lj", 2, CUDA, torch.float32, True),
    ("poly", 2, CUDA, torch.float32, False),
    ("hd", 2, CUDA, torch.float32, False),
    ("lj", 3, CUDA, torch.float32, False),
    ("lj", 2, CPU, torch.float32, False),
    ("lj", 2, CUDA, torch.float64, False),
])
def test_kernel_takes_only_2d_lj_float32_on_cuda(family, dim, device, dtype,
                                                 takes):
    model = {"lj": lj.FAMILY.cell(LJP), "poly": poly.FAMILY.cell(
        poly.PolyParams()), "hd": hd.FAMILY.cell(None)}[family]
    assert (model.kernel_params is LJP) == (family == "lj")
    t = torch.zeros(2, dtype=dtype)
    assert cell_mc._kernel_takes(model, dim, device, t, t, t) is takes
    mixed = torch.zeros(2, dtype=torch.float64)
    assert not cell_mc._kernel_takes(model, dim, device, t, mixed, t)


def _pool(family):
    if family == "lj":
        return (lj.lj_displacement_move(0.08, weight=0.8),
                lj.lj_swap_move(weight=0.2))
    if family == "lj_npt":
        return (lj.lj_displacement_move(0.08, weight=0.75),
                lj.lj_swap_move(weight=0.2),
                lj.lj_volume_move(0.002, 2.0, weight=0.05))
    if family == "poly":
        return (poly.displacement_move(0.08, weight=0.8),
                poly.swap_move(weight=0.2))
    return (hd.displacement_move(0.12),)


def _chains(family, dim=2):
    if family in ("lj", "lj_npt"):
        n, rho = (512, 1.0) if dim == 2 else (1372, 0.5)
        return lj.init_chains(2, n, rho=rho, beta=1.0 / 0.45, frac_b=0.35,
                              seed=4, device="cpu", dim=dim)
    if family == "poly":
        return poly.init_chains(2, 512, rho=1.0, beta=1.0, seed=4,
                                device="cpu")
    return hd.init_chains(2, 512, eta=0.70, seed=4, device="cpu")


@pytest.mark.parametrize("family,dim", [("lj", 2), ("lj_npt", 2), ("lj", 3),
                                        ("poly", 2), ("hd", 2)])
def test_metropolis_hands_the_lj_table_and_the_cpu_launches_nothing(
        family, dim, tmp_path, monkeypatch):
    """``_cell_segment`` hands the segment the LJ pool's parameters and
    nothing for poly and hard disks; on the CPU every substep takes the
    twin: the kernel's launches stay 0 and ``sim.counters`` lists none."""
    seen = []
    real = cell_mc.cell_mc_segment
    taken = []
    real_takes = cell_mc._kernel_takes

    def spy(grid, model, *args, **kw):
        seen.append(model.kernel_params)
        return real(grid, model, *args, **kw)

    def takes(*args):
        taken.append(real_takes(*args))
        return taken[-1]

    monkeypatch.setattr(cell_mc, "cell_mc_segment", spy)
    monkeypatch.setattr(cell_mc, "_kernel_takes", takes)
    before = cell_mc.CELL_SUBSTEP_KERNEL.launches
    system = {"poly": poly, "hd": hd}.get(family, lj).make_system()
    sim = tmc.Simulation(system, _chains(family, dim), [
        dict(algorithm=tmc.Metropolis, pool=_pool(family), seed=3,
             sweepstep=64, fused="cell")], 3, path=str(tmp_path))
    sim.run()
    assert seen and taken and not any(taken)
    want = LJP if family.startswith("lj") else None
    assert all(p == want for p in seen)
    assert cell_mc.CELL_SUBSTEP_KERNEL.launches == before
    assert "mc_cell_substep" not in sim.counters.launches
    assert sim.counters.cell_substeps > 0


def test_kernel_is_counted_by_its_entry_point():
    assert cell_mc.CELL_SUBSTEP_KERNEL in KERNELS
    assert cell_mc.CELL_SUBSTEP_KERNEL.symbol == "mc_cell_substep"
    assert cell_mc.CELL_SUBSTEP_KERNEL.source.endswith("cell_substep.cu")


# -- the segment through the kernel's path ------------------------------------

def twin_in_kernel_place(grid, P, params, e, att, acc):
    """A stand-in for ``cell_mc._kernel_substeps`` on any device: each
    launch runs the twin's substep with the box and ``beta`` read back from
    the kernel's arguments (``sqrt`` of a float32 square gives its root
    exactly) and adds the chain sums into ``e``, ``att`` and ``acc`` in
    place, as the kernel does.  Stale arguments give another box."""
    model = lj.FAMILY.cell(params)
    variants, _ = cell_mc._make_substep(grid, model.pair_energy,
                                        model.rcut2_of, "species")
    sigma = torch.tensor(SEGMENT_SIGMA)

    def launch(kind, color, args, *draws):
        box = args[3].sqrt()
        assert torch.equal(args[0], sigma / box)
        d_e, n_att, n_acc = variants[kind][color](P, box, sigma, -args[2],
                                                  *draws)
        e.copy_(e + d_e)
        att[:, kind] += n_att.to(torch.int32)
        acc[:, kind] += n_acc.to(torch.int32)

    return launch


SEGMENT_SIGMA = 0.08


@pytest.mark.parametrize("pool", ["species", "one_move", "npt"])
def test_segment_through_the_kernel_path_equals_the_twin(pool, monkeypatch):
    """``cell_mc_segment`` with :func:`twin_in_kernel_place` in the
    kernel's place (the CPU made to take the kernel's path) against the
    twin's segment from the same draws: positions, labels, energies, box,
    counts and flags bit for bit; with volume substeps the arguments follow
    the box and the energies carried in place take the volume's."""
    st = _chains("lj")
    m, n = st.pos.shape[:2]
    pe, rc2, rcut = lj.cell_closures(LJP)
    vol = (n, 2.0) if pool == "npt" else None
    grid = cell_mc.plan_grid(n, float(st.box[0]), rcut,
                             box_margin=0.15 if vol else 0.0)
    swap_mode = None if pool == "one_move" else "species"
    model = cell_mc.CellModel(pe, rc2, rcut, swap_mode=swap_mode,
                              kernel_params=LJP)
    kw = dict(w_disp={"species": 0.7, "one_move": 1.0, "npt": 0.6}[pool],
              w_swap=0.3 if pool != "one_move" else 0.0,
              box=st.box, vol=vol, dlnv=0.01)
    if pool == "npt":
        kw["w_swap"] = 0.25
    launched = []

    def stand_in(*a):
        launch = twin_in_kernel_place(*a)
        return lambda *b: (launched.append(b[0]), launch(*b))

    def run(kernel_path):
        with monkeypatch.context() as mp:
            if kernel_path:
                mp.setattr(cell_mc, "_kernel_takes", lambda *a: True)
                mp.setattr(cell_mc, "_kernel_substeps", stand_in)
                mp.setattr(cell_mc.torch.cuda, "device",
                           lambda d: contextlib.nullcontext())
            return cell_mc.cell_mc_segment(
                grid, model, cell_mc.KeyDraws(9, 2048, torch.arange(m)),
                st.pos, st.species.float(), st.beta, st.energy,
                SEGMENT_SIGMA, 60, **kw)

    want, got = run(False), run(True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    att = want[4]
    seq = cell_mc.KeyDraws(9, 2048, torch.arange(m)).variants(
        60, 4, kw["w_disp"], kw["w_swap"], swap_mode is not None,
        vol is not None)
    assert launched == [k for k, _ in seq.tolist() if k != 2]
    assert int(att[:, 0].min()) > 0
    if pool != "one_move":
        assert int(att[:, 1].min()) > 0
    if pool == "npt":
        assert int(att[:, 2].min()) > 0 and int(want[5][:, 2].sum()) > 0
        assert not torch.equal(want[3], st.box)
