"""The observation bytes the trajectory rollout writes in the traced slice,
over the slice's busy time (the union of its device intervals) and the
card's published memory bandwidth, in %: the program's
``COUNTERS["obs_bytes"]`` over its ``COUNTERS["replays"]`` (the rollout
graph counts both under torch.profiler), times the slice's replays.
Nothing where the program has no such counters."""


def read(run):
    t, bw, replays = run.trace, run.peaks.get("hbm_bytes_per_s"), run.traced.get("replays")
    if t is None or not bw or not replays or not t.busy_s:
        return None
    try:
        from pushworld_tpu_torch.utils.tracing import COUNTERS
    except ImportError:
        return None
    if not COUNTERS["replays"]:
        return None
    return 100.0 * COUNTERS["obs_bytes"] / COUNTERS["replays"] * replays / t.busy_s / bw
