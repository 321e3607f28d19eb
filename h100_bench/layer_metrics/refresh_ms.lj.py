"""Mean milliseconds of the LJ cache refresh (``SystemDef.refresh``, the
O(N^2) energies at every record point) over the traced window's calls,
by CUDA events the harness records around the refresh it passes in."""


def read(ctx):
    ms = ctx["refresh_ms"]
    return sum(ms) / len(ms) if ms else None
