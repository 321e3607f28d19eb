"""How the CUDA kernels are laid out over the card, as far as Python decides
it: the lanes T of a warp that serve one Gaussian chain
(``ops.fused_sweep.group_lanes``) and the warps W of the block that serves
one Lennard-Jones chain (``ops.lj_sweep.block_warps``).  Neither is an
argument of an entry point: T follows the number of chains and the card's
size and changes no bit of the result; W follows N alone, because the row
sums' order follows W.
"""

import inspect

import pytest

from montecarlo_tpu_torch.ops import fused_sweep, lj_sweep
from montecarlo_tpu_torch.ops.fused_sweep import group_lanes
from montecarlo_tpu_torch.ops.lj_sweep import MAX_PARTICLES, block_warps

H100_SMS = 132


@pytest.mark.parametrize("m", [1, 10, 100, 1000, 4096, 10 ** 4, 33000,
                               10 ** 5, 10 ** 6, 10 ** 7])
@pytest.mark.parametrize("sms", [1, 16, H100_SMS, 264])
def test_group_lanes_is_a_power_of_two_in_range(m, sms):
    t = group_lanes(m, sms)
    assert 1 <= t <= 32 and t & (t - 1) == 0
    fill = sms * fused_sweep._FILL_THREADS_PER_SM
    # the smallest such T that fills the card, or 32 when none does
    assert m * t >= fill or t == 32
    assert t == 1 or m * (t // 2) < fill


def test_group_lanes_on_the_h100():
    """One M for each regime: the README's 10 chains get a whole warp each,
    10^4 chains a group of 8, 10^6 chains one thread each."""
    assert group_lanes(10, H100_SMS) == 32
    assert group_lanes(10 ** 4, H100_SMS) == 8
    assert group_lanes(10 ** 6, H100_SMS) == 1
    lanes = [group_lanes(m, H100_SMS) for m in (10 ** k for k in range(8))]
    assert lanes == sorted(lanes, reverse=True)


@pytest.mark.parametrize("n", [1, 2, 20, 31, 32, 33, 100, 128, 129, 256,
                               257, 300, 1024, 1025, 2048, 4096, 5000,
                               MAX_PARTICLES])
def test_block_warps_is_a_power_of_two_in_range(n):
    w = block_warps(n)
    assert 1 <= w <= 16 and w & (w - 1) == 0
    slots = -(-n // (32 * w))          # slots a thread
    if n <= 256:
        assert slots == 1 and (w == 1 or 32 * (w // 2) < n)
    elif n <= 2048:
        assert slots <= 4 and w >= 8 and (w == 8 or 128 * (w // 2) < n)
    else:
        assert w == 16


def test_block_warps_grows_with_the_particle_count():
    warps = [block_warps(n) for n in range(1, 6000)]
    assert warps == sorted(warps) and set(warps) == {1, 2, 4, 8, 16}


def test_block_warps_at_the_main_shapes():
    assert [block_warps(n) for n in (20, 100, 256, 1024, 4648)] == [
        1, 4, 8, 8, 16]


def test_block_warps_reads_the_particle_count_alone():
    """W must not follow the number of chains or the card: the plain
    version could not follow the sum order."""
    assert list(inspect.signature(block_warps).parameters) == ["n"]
    src = inspect.getsource(block_warps)
    assert "cuda" not in src and "get_device_properties" not in src
    # no user-facing override of either choice
    for fn in (lj_sweep.fused_lj_sweep, lj_sweep.fused_lj_mixed_sweep,
               fused_sweep.fused_gaussian_sweep):
        names = set(inspect.signature(fn).parameters)
        assert not names & {"warps", "lanes", "threads"}
