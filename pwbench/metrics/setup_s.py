"""Seconds from the start of ``run.py`` to the start of the window: imports,
the kernels' build or load, the pool, the warm-up (host clock)."""


def read(run):
    return run.setup_s
