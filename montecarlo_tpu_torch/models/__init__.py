"""The ported model families (the reference's ``montecarlo_tpu.models``
subset)."""

from . import hard_disks, lennard_jones, particle1d, polydisperse

__all__ = ["hard_disks", "lennard_jones", "particle1d", "polydisperse"]
