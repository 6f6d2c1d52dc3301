"""Device microseconds per lockstep step in the traced slice: every device
interval's length, summed, over the slice's replays x horizon."""


def read(run):
    t, steps = run.trace, run.traced.get("lockstep_steps")
    if t is None or not steps:
        return None
    return sum(e - s for _, s, e in t.device) / steps
