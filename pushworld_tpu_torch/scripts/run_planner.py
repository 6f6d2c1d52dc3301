"""CLI planner: ``python -m pushworld_tpu_torch.scripts.run_planner <mode> <puzzle.pwp>``.

Mirrors the reference C++ CLI (reference: cpp/src/run_planner.cc:69-104):
prints a plan of L/R/U/D characters solving the puzzle, or "NO SOLUTION".
Modes: "RGD" and "N+RGD" (lexicographic novelty + RGD).  The search runs on
the GPU unless ``--device cpu`` is given.
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Solve a PushWorld puzzle and print the plan."
    )
    parser.add_argument("mode", choices=["RGD", "N+RGD"])
    parser.add_argument("puzzle", help="path of a .pwp puzzle file")
    parser.add_argument(
        "--planner",
        choices=["auto", "batched"],
        default="auto",
        help="batched (= auto): the batched search on --device",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--time-limit", type=float, default=None)
    args = parser.parse_args(argv)

    from pushworld_tpu_torch.core.puzzle import Puzzle, plan_to_string
    from pushworld_tpu_torch.search.planner import solve_puzzle

    try:
        puzzle = Puzzle.from_file(args.puzzle)
        result = solve_puzzle(
            puzzle,
            mode=args.mode,
            time_limit=args.time_limit,
            planner=args.planner,
            device=args.device,
        )
    except Exception as e:  # noqa: BLE001 — CLI surface, match reference behavior
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    if result.failure_reason is None and result.plan is not None:
        print(plan_to_string(result.plan))
        return 0
    if result.failure_reason == "no solution":
        print("NO SOLUTION")
        return 0
    print(f"ERROR: {result.failure_reason}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
