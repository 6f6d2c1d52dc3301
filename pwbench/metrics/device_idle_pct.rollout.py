"""The card's idle share in the traced slice: 100 x (1 - the union of the
device intervals / the slice's length)."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
