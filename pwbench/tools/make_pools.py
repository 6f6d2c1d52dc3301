"""Makes a configuration's frozen puzzle pool, once, on the CPU.

    python pwbench/tools/make_pools.py level0 [--workers 4]

Draws candidates from ``configs/<config>.json``'s generator parameters with
``random.Random(pool.seed)`` (the frozen generator in ``tools/generate.py``),
and keeps each that the filter keeps, in the order drawn, until the pool is
full.  The filter solves a candidate with the port's native serial planner
(``pushworld_tpu_torch.native.bridge.solve_native``) and replays the plan
with the benchmark's reference; a candidate is kept when the planner solves
it within the filter's ``time_limit`` seconds (PushWorld's own filter) and
the reference replays the plan to the goal.

Writes ``configs/<config>/puzzle_NNN.pwp`` and ``configs/<config>/pool.json``
(candidates drawn and kept, each kept puzzle's plan).  The benchmark never
runs this script: the pools are committed.
"""

import argparse
import json
import multiprocessing
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH))

from pwbench.reference import dynamics, puzzle as ref_puzzle  # noqa: E402
from pwbench.tools.generate import candidates  # noqa: E402

ACTIONS = "LRUD"


def judge(args):
    """(kept, plan string or None, seconds) for one candidate."""
    text, filt = args
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.native.bridge import solve_native

    t0 = time.monotonic()
    p = Puzzle.from_text(text)
    plan = None
    try:
        plan = solve_native(p, mode=filt["mode"], time_limit=filt["time_limit"])
    except (TimeoutError, MemoryError):
        plan = None
    if not plan or not dynamics.plan_reaches_goal(ref_puzzle.parse(text), plan):
        return False, None, time.monotonic() - t0
    return True, "".join(ACTIONS[a] for a in plan), time.monotonic() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=32)
    args = ap.parse_args()
    with open(os.path.join(BENCH, "configs", f"{args.config}.json")) as f:
        cfg = json.load(f)
    out_dir = os.path.join(BENCH, "configs", args.config)
    os.makedirs(out_dir, exist_ok=True)
    if any(n.endswith(".pwp") for n in os.listdir(out_dir)):
        raise SystemExit(f"{out_dir} already holds a pool")
    stream = candidates(cfg["generator"], random.Random(cfg["pool"]["seed"]))
    size = cfg["pool"]["size"]
    kept, drawn, seconds = [], 0, 0.0
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers) as pool:
        while len(kept) < size:
            batch = [next(stream) for _ in range(args.chunk)]
            for text, (ok, plan, dt) in zip(batch, pool.map(judge, [(t, cfg["filter"]) for t in batch])):
                if len(kept) == size:
                    break
                drawn += 1
                seconds += dt
                if ok:
                    kept.append((text, plan))
            print(f"{args.config}: {len(kept)} kept of {drawn} drawn, {seconds:.0f} s of filter", flush=True)
    plans = {}
    for i, (text, plan) in enumerate(kept):
        name = f"puzzle_{i:03d}"
        with open(os.path.join(out_dir, name + ".pwp"), "w") as f:
            f.write(text + "\n")
        plans[name] = plan
    with open(os.path.join(out_dir, "pool.json"), "w") as f:
        json.dump({"candidates_drawn": drawn, "kept": len(kept), "filter_cpu_seconds": round(seconds, 1),
                   "plans": plans}, f, indent=1)


if __name__ == "__main__":
    main()
