"""Kernel launches per record period in the traced window: the runtime's
launch calls on the profiler's host rows over the window's periods."""


def read(ctx):
    n = ctx["trace"]["launches"]
    return n / ctx["periods"] if n else None
