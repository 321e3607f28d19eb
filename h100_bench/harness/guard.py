"""Which modules a benchmark process may not hold.

The port's package name begins with the JAX package's, so names are
compared whole, by their top-level part (before the first dot).
"""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlo_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(module_names) -> list:
    """The names among ``module_names`` whose top-level part is one of
    :data:`FORBIDDEN`, sorted."""
    return sorted(n for n in module_names if top_level(n) in FORBIDDEN)
