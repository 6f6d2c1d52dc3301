"""Where one puzzle's batched search spends its time on the card.

``python -m pushworld_tpu_torch.scripts.profile_search PUZZLE.pwp [--iters N]``

Builds the kernels, then the planner and its RGD tables (timed, with the
host movement-graph fixpoint timed on its own) at the puzzle's RGD depth or
``--depth``, then runs ``--iters`` search
iterations at the production capacities under ``torch.profiler`` eagerly
(``_iterate`` in a Python loop), and one chunk of ``--chunk`` iterations as
the card's ``run_chunk`` runs it (the device-side loop of
``search/chunk_graph.py``, on a second state from the same start), timed by
CUDA events: torch.profiler traces only the first body of a loop, so the
device time of the chunk's iterations comes from the same iterations run
eagerly on a third state under the profiler.  Prints one JSON line: the
table-build time; for the eager loop the host-clock time per iteration
(under the profiler), the device-busy share (the union of the trace's
device intervals over the wall time: an iteration's branches run side by
side on the card; the summed kernel time beside it), kernels per iteration
and how many of the iterations were active (their gate open); for the
chunk, the bodies it ran, ms per iteration (events), the device time of the
iteration's kernels per iteration (the union), the busy share (that over
the events' time) and the loop's own cost per iteration (the rest), the
host's time for the call, the body's nodes, node types and longest
dependent chain, and capture and build seconds; the kernels with the most device time
in the eager loop; a chunk of the default length
(``batched.chunk_length``) on a search that has ended: its bodies, ms
(events) and device time; the same eager loop with the gate closed (the
search marked solved: every kernel a no-op), its device ms per iteration
in all and by kernel and its hand-kernel launches per iteration (the eight
of ``ITERATION_KERNELS``, and any other); and a compaction that evicts: the puzzle's search with a
frontier of 8 x expand slots (``--evict-frontier``), caught before the
iteration whose compaction drops live entries, ``compact_frontier`` on that
iteration's state timed by kernel (every kernel it launches, the visited
set's deletes included), each call on the state as it was.
Needs a CUDA device.  The script uses only the package's public calls, so
it also times another tree's package: run it with that tree's root on
``PYTHONPATH`` (a tree whose chunks replay graphs of G iterations counts
G iterations a replay as its bodies).
"""

import argparse
import dataclasses
import json
import time

# A search iteration's hand-kernel launches on the card, one each.
ITERATION_KERNELS = ("frontier.select", "step.expand", "visited_set.fingerprint_dedup_insert", "novelty.score",
                     "novelty.absorb", "rgd.heuristic", "frontier.compact", "frontier.append")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("puzzle", help="path of a .pwp puzzle file")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--depth", type=int, default=None,
                    help="RGD pushing depth (default: the puzzle's required_depth)")
    ap.add_argument("--chunk", type=int, default=64,
                    help="iterations of the timed chunk (the 47x54 puzzle of chip_smoke.py solves in ~70)")
    ap.add_argument("--evict-frontier", type=int, default=None,
                    help="frontier slots of the evicting compaction's search (default: 8 x expand)")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pushworld_tpu_torch import kernels
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES, _build
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.ops.rgd import _movement_graphs_host
    from pushworld_tpu_torch.search import chunk_graph
    from pushworld_tpu_torch.search.batched import BatchedPlanner, _iterate, chunk_length, required_depth, run_chunk
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    settle_launches = getattr(kernels, "settle_launches", lambda: None)  # a tree whose chunks count as replayed

    dev = torch.device("cuda", 0)
    _build.build()
    bridge.is_available()  # builds the native planner before the fixpoint is timed
    puzzle = Puzzle.from_file(args.puzzle)
    depth = required_depth(puzzle) if args.depth is None else args.depth
    t0 = time.monotonic()
    _movement_graphs_host(puzzle, compile_puzzle(puzzle))
    graphs_s = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    planner = BatchedPlanner(puzzle, max_depth=depth, device=dev, **PRODUCTION_CAPACITIES)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    cfg = planner.config
    eager_s, graphed_s, twin_s = (planner.init_state() for _ in range(3))
    for s in (eager_s, twin_s):  # warm-up
        for _ in range(2):
            _iterate(planner.cp_dev, planner.tables, cfg, s)
    g = chunk_graph.attach(planner.cp_dev, planner.tables, cfg, graphed_s)
    run_chunk(planner.cp_dev, planner.tables, cfg, graphed_s, 2)  # warm-up
    torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def profiled(run, iters):
        settle_launches()
        LAUNCHES.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t0
        settle_launches()
        # Kernel rows carry the device time once; operator rows repeat it.
        avgs = prof.key_averages()
        kernels = [e for e in avgs if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        busy_us = union_us((e.time_range.start, e.time_range.end) for e in prof.events()
                            if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
        row = {"iters": iters, "ms_per_iter": wall_s / iters * 1e3,
               "device_busy_share": busy_us / (wall_s * 1e6),
               "device_ms_per_iter": busy_us / 1e3 / iters,
               "summed_device_ms_per_iter": sum(dev_us(e) for e in kernels) / 1e3 / iters,
               "kernels_per_iter": sum(e.count for e in kernels) / iters,
               "hand_kernel_launches": dict(LAUNCHES)}
        return row, avgs

    def eager_with(state, iters=args.iters):
        def run():
            for _ in range(iters):
                _iterate(planner.cp_dev, planner.tables, cfg, state)
        return run

    def timed_chunk(s, g, chunk):
        """One ``run_chunk`` of ``chunk`` iterations: device ms between CUDA
        events around it (torch.profiler traces only a loop's first body),
        host ms of the call, and the bodies it ran (on a tree whose chunks
        replay graphs of G iterations, G a replay)."""
        b0 = int(g.bodies) if hasattr(g, "bodies") else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        start.record()
        run_chunk(planner.cp_dev, planner.tables, cfg, s, chunk)
        host_ms = (time.monotonic() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        bodies = int(g.bodies) - b0 if b0 is not None else -(-chunk // g.iters) * g.iters
        return {"ms": start.elapsed_time(end), "host_ms": host_ms, "bodies": bodies}

    eager = eager_with(eager_s)

    counted = int(eager_s.iterations)
    eager_row, avgs = profiled(eager, args.iters)
    eager_row["active_iters"] = int(eager_s.iterations) - counted  # the others had their gate closed
    # The chunk, and the same iterations run eagerly on a twin state under
    # the profiler: the device time of the iteration's kernels.  What the
    # chunk takes beyond it is the loop's own cost (the body's relaunch, the
    # gaps between dependent kernels) or, on a tree
    # that replays graphs, the host's replays.
    counted = int(graphed_s.iterations)
    chunk = timed_chunk(graphed_s, g, args.chunk)
    n = chunk["bodies"]
    twin_row, _ = profiled(eager_with(twin_s, n), n)
    graphed_row = {
        "chunk": args.chunk, "bodies": n, "active_iters": int(graphed_s.iterations) - counted,
        "ms_per_iter": chunk["ms"] / n, "host_ms": chunk["host_ms"],
        "iteration_kernels_device_ms_per_iter": twin_row["device_ms_per_iter"],
        "device_busy_share": twin_row["device_ms_per_iter"] * n / chunk["ms"],
        "loop_cost_ms_per_iter": chunk["ms"] / n - twin_row["device_ms_per_iter"],
        "same_search_as_eager": (int(twin_s.iterations), int(twin_s.expansions))
        == (int(graphed_s.iterations), int(graphed_s.expansions)),
        "nodes": g.nodes, "node_types": getattr(g, "node_types", None),
        "longest_chain": getattr(g, "longest_chain", None), "capture_s": g.capture_s,
        "instantiate_s": g.instantiate_s}
    # A chunk of the default length on a search that has ended.
    ended_s = planner.init_state()
    ended_s.solved.fill_(True)
    default = chunk_length(None, cfg, dev)
    ended_g = chunk_graph.attach(planner.cp_dev, planner.tables, cfg, ended_s)
    timed_chunk(ended_s, ended_g, default)  # warm-up
    ended = dict(timed_chunk(ended_s, ended_g, default), chunk=default)
    ended_prof, _ = profiled(lambda: run_chunk(planner.cp_dev, planner.tables, cfg, ended_s, default), 1)
    ended.update(device_ms=ended_prof["device_ms_per_iter"], device_rows=ended_prof["kernels_per_iter"])
    rows = [e for e in avgs if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    top = sorted(rows, key=dev_us, reverse=True)[: args.top]
    # A closed gate: iterations of a solved search (every kernel a no-op).
    closed_s = dataclasses.replace(eager_s, solved=torch.ones((), dtype=torch.bool, device=dev))
    closed_row, closed_avgs = profiled(eager_with(closed_s), args.iters)
    closed_row["device_ms_by_kernel"] = {e.key[:120]: dev_us(e) / 1e3 / args.iters for e in closed_avgs
                                         if e.device_type == DeviceType.CUDA and dev_us(e) > 0}
    per_iter = {k: n / args.iters for k, n in closed_row["hand_kernel_launches"].items()}
    closed_row["hand_kernel_launches_per_iter"] = {
        "iteration_kernels": {k: per_iter.get(k, 0) for k in ITERATION_KERNELS},
        "others": {k: n for k, n in per_iter.items() if k not in ITERATION_KERNELS},
        "total": sum(per_iter.values())}
    evicting = _evicting_compaction(puzzle, depth, dev, args.evict_frontier, dev_us)
    print(json.dumps({
        "puzzle": args.puzzle, "depth": depth, "device": torch.cuda.get_device_name(0),
        "table_build_s": build_s, "of_which_host_movement_graphs_s": graphs_s,
        "eager": eager_row,
        "graphed": graphed_row,
        "ended_search_chunk": ended,
        "top_kernels_device_ms_per_iter": {e.key[:120]: dev_us(e) / 1e3 / args.iters for e in top},
        "closed_gate": closed_row,
        "evicting_compaction": evicting,
        "expansions": {"eager": int(eager_s.expansions), "graphed": int(graphed_s.expansions)},
    }))
    return 0


def union_us(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _evicting_compaction(puzzle, depth, dev, frontier, dev_us, reps=20) -> dict:
    """The search with ``frontier`` slots (default 8 x expand) run until the
    next compaction drops live entries; that iteration's compaction timed
    (device ms by kernel, over ``reps`` calls, each on the state before it:
    the frontier, the counters and the visited set restored)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pushworld_tpu_torch.ops.hashset import fingerprint_dedup_insert
    from pushworld_tpu_torch.ops.step import expand_and_test
    from pushworld_tpu_torch.search import batched
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    caps = dict(PRODUCTION_CAPACITIES)
    caps["frontier_capacity"] = frontier or 8 * caps["expand"]
    pl = batched.BatchedPlanner(puzzle, max_depth=depth, device=dev, **caps)
    cfg, t, cp = pl.config, pl.tables, pl.cp_dev
    s = pl.init_state()
    F, nb = pl.frontier_capacity, 4 * cfg.expand
    for it in range(4096):
        live = int((s.frontier_h < batched.EMPTY).sum())
        if int(s.ring_cursor) + nb > F and live - cfg.expand > F - max(nb, F // 4):
            break
        batched._iterate(cp, t, cfg, s)
    else:
        return {"frontier": F, "found": False}
    # The iteration's steps up to its compaction (select, expand, insert).
    parents, _, sel_valid, gate = batched.select_and_gate(cfg, s)
    children, _, effective, _ = expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)
    fingerprint_dedup_insert(s.visited, children, cp.width, effective, gate)
    saved = {f: getattr(s, f).clone() for f in ("frontier_h", "frontier_states", "frontier_hist", "frontier_key",
                                                "ring_cursor", "evictions")}
    table = s.visited.keys.clone()

    def reset():
        for f, v in saved.items():
            getattr(s, f).copy_(v)
        s.visited.keys.copy_(table)

    def compact():
        reset()
        batched.compact_frontier(s, nb, gate)

    compact()
    torch.cuda.synchronize()
    row = {"frontier": F, "found": True, "iteration": it, "live": live, "evicted": int(s.evictions - saved["evictions"]),
           "keys_deleted": int(((table != -1) & (s.visited.keys == -1)).sum())}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            compact()
        torch.cuda.synchronize()
    hand = {e.key[:120]: dev_us(e) / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0 and ("compact" in e.key or "probe" in e.key)}
    row.update(device_ms_by_kernel=hand, device_ms=sum(hand.values()))
    return row


if __name__ == "__main__":
    raise SystemExit(main())
