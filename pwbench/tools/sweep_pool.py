"""Solves every puzzle of a configuration's pool once on the card, as the
``plan`` traffic sends it, and prints one JSON line a puzzle: seconds,
iterations, expansions, the failure if any, and whether the plan reaches
the goal under the reference.  A tool for sizing and for the record of
which pooled puzzles the card fails; the benchmark never runs it.

    python pwbench/tools/sweep_pool.py level0 [--repeat 2]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from pwbench.harness.cell import BENCH  # noqa: E402
from pwbench.reference import dynamics, puzzle as ref_puzzle  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--time-limit", type=float, default=60.0)
    args = ap.parse_args()
    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES, solve_puzzle

    paths = sorted((BENCH / "configs" / args.config).glob("*.pwp"))
    for rep in range(args.repeat):
        for path in paths:
            text = path.read_text()
            p = Puzzle.from_text(text)
            t0 = time.perf_counter()
            r = solve_puzzle(p, mode="N+RGD", time_limit=args.time_limit, device="cuda", **PRODUCTION_CAPACITIES)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ok = r.plan is not None and dynamics.plan_reaches_goal(ref_puzzle.parse(text), r.plan)
            print(json.dumps({"rep": rep, "puzzle": path.stem, "movables": p.num_movables, "seconds": dt,
                              "iterations": int(r.iterations), "expansions": int(r.expansions),
                              "failure": r.failure_reason, "plan_len": None if r.plan is None else len(r.plan),
                              "reaches_goal": ok}), flush=True)


if __name__ == "__main__":
    main()
