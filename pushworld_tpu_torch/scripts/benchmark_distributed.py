"""Multi-process benchmark CLI: every process runs the same command; the
puzzle set is sharded round-robin across processes and each process prints
(and optionally writes) the COMPLETE merged results.

    PW_COORDINATOR=host0:12345 PW_NUM_PROCESSES=4 PW_PROCESS_ID=<i> \\
        python -m pushworld_tpu_torch.scripts.benchmark_distributed <puzzles_dir>

Each process plans on ``cuda:{process_id % device_count}`` (``--device
cpu``: on the CPU); several processes may share one card.  The reference has
no distributed runtime (its harness is a sequential single-process loop,
reference: python3/src/pushworld/benchmark_rgd.py:70-84).
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("puzzles_dir", help="directory of .pwp puzzles")
    ap.add_argument("--mode", default="N+RGD", choices=["RGD", "N+RGD"])
    ap.add_argument("--time-limit", type=float, default=60.0)
    ap.add_argument("--no-fleet", action="store_true",
                    help="per-puzzle planner instead of the fleet executor")
    ap.add_argument("--native-workers", type=int, default=None,
                    help="host planner threads per process (default: CPU "
                         "count; pin to 1 for scaling-efficiency runs)")
    ap.add_argument("--out", default=None,
                    help="write merged results (and this process's shard) as JSON to this path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where each process plans (default: its card)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.parallel.distributed import (
        initialize_from_env,
        plan_puzzles_distributed,
        shard_puzzles,
    )
    from pushworld_tpu_torch.utils.filesystem import get_puzzle_file_paths

    pid, nproc = initialize_from_env()
    paths = get_puzzle_file_paths(args.puzzles_dir)
    named = [(n, Puzzle.from_file(paths[n])) for n in sorted(paths)]

    kwargs = {}
    if args.native_workers is not None:
        kwargs["native_workers"] = args.native_workers

    t0 = time.monotonic()
    try:
        results = plan_puzzles_distributed(
            named, mode=args.mode, time_limit=args.time_limit,
            use_fleet=not args.no_fleet, device=args.device, **kwargs,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()  # its threads must not outlive the interpreter
    wall = time.monotonic() - t0
    doc = {
        "process_id": pid,
        "n_processes": nproc,
        "solved": sum(1 for r in results.values() if r.failure_reason is None),
        "count": len(results),
        "wall_s": round(wall, 3),
        "local": [n for n, _ in shard_puzzles(named, pid, nproc)],
        "results": {
            n: {
                "plan": r.plan,
                "planning_time": r.planning_time,
                "failure_reason": r.failure_reason,
                "solver": r.solver,
            }
            for n, r in sorted(results.items())
        },
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f)
    print(
        json.dumps(
            {
                k: doc[k]
                for k in (
                    "process_id", "n_processes", "solved", "count", "wall_s"
                )
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
