"""Where one puzzle's batched search spends its time on the card.

``python -m pushworld_tpu_torch.scripts.profile_search PUZZLE.pwp [--iters N]``

Builds the kernels, then the planner and its RGD tables (timed, with the
host movement-graph fixpoint timed on its own), then runs ``--iters`` search iterations at the
production capacities under ``torch.profiler`` and prints one JSON line: the
table-build time, the host-clock time per iteration (under the profiler),
the device-busy share (summed kernel time over the wall time), kernels per
iteration, and the operators with the most device time.  Needs a CUDA device.
"""

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("puzzle", help="path of a .pwp puzzle file")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES, _build
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.ops.rgd import _movement_graphs_host
    from pushworld_tpu_torch.search.batched import BatchedPlanner, _iterate, required_depth
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    dev = torch.device("cuda", 0)
    _build.build()
    bridge.is_available()  # builds the native planner before the fixpoint is timed
    puzzle = Puzzle.from_file(args.puzzle)
    depth = required_depth(puzzle)
    t0 = time.monotonic()
    _movement_graphs_host(puzzle, compile_puzzle(puzzle))
    graphs_s = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    planner = BatchedPlanner(puzzle, max_depth=depth, device=dev, **PRODUCTION_CAPACITIES)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    s = planner.init_state()
    cfg = planner.config
    for _ in range(2):  # warm-up
        _iterate(planner.cp_dev, planner.tables, cfg, s)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(args.iters):
            _iterate(planner.cp_dev, planner.tables, cfg, s)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Kernel rows carry the device time once; operator rows repeat it.
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    ops = [e for e in avgs if e.device_type == DeviceType.CPU and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    top = sorted(ops, key=dev_us, reverse=True)[: args.top]
    print(json.dumps({
        "puzzle": args.puzzle, "depth": depth, "device": torch.cuda.get_device_name(0),
        "table_build_s": build_s, "of_which_host_movement_graphs_s": graphs_s,
        "iters": args.iters,
        "ms_per_iter": wall_s / args.iters * 1e3,
        "device_busy_share": busy_us / (wall_s * 1e6),
        "kernels_per_iter": n_kernels / args.iters,
        "hand_kernel_launches": dict(LAUNCHES),
        "top_ops_device_ms_per_iter": {e.key: dev_us(e) / 1e3 / args.iters for e in top},
        "expansions": int(s.expansions),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
