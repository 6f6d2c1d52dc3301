"""Readings for the limits that decide ``correct``: the program's, and the
control's and the planted faults' in its place, at a cell's own size.

    python pwbench/controls.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one window of the cell's traffic runs as in a benchmark run
(set-up, window, the program's state freed); then each number the check
compares is read for the program (the lower reading of its limit) and for
each stand-in put in the program's place:

- rollouts: ``control_bfloat16``, the reference computed in bfloat16 (the
  configuration's rewards are float32); the faults ``state_unchanged`` (a
  step that leaves the state as it was), ``half_batch`` (half the rollouts
  left where they are and paid nothing, the other half paid double),
  ``answer_altered`` (one step of one rollout paid for a goal more, and
  one coordinate of one rollout moved);
- plans: ``control_truncated`` (every plan less its last move: the
  guarantee that a returned plan reaches the goal, broken),
  ``answer_altered`` (one move of the first plan changed).

Prints one JSON line a seed.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pwbench.harness import cell as cells  # noqa: E402
from pwbench.harness.main import Run  # noqa: E402
from pwbench.reference import dynamics, env as ref_env, puzzle as ref_puzzle  # noqa: E402


def bfloat16(x):
    """``x`` (float32) rounded to the nearest bfloat16, ties to even, kept
    in float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def rollout_readings(driver) -> dict:
    """Each compared number's reading, the worst over the kept replays, for
    the program and for each stand-in in its place."""
    t = dynamics.Tables(driver.ref)
    ms = driver.p["max_steps"]
    movable = t.cmask[driver.pidx].any(-1)
    half = len(driver.pidx) // 2

    def frozen_half(pos, a, step=dynamics.Batch(t, driver.pidx).step):
        nxt = step(pos, a)
        nxt[half:] = pos[half:]
        return nxt

    def output(totals, last):
        totals = np.asarray(totals, np.float32)
        return {"total": float(totals.astype(np.float64).sum()), "totals": totals, "positions": last}

    res = {}
    for k in driver.kept:
        a = k["actions"]
        totals, last = ref_env.rollout(t, driver.pidx, a, ms)
        half_totals, half_last = ref_env.rollout(t, driver.pidx, a, ms, step=frozen_half)
        half_totals = np.concatenate([2 * half_totals[:half], np.zeros_like(half_totals[half:])])
        altered_totals, altered_last = totals.copy(), last.copy()
        altered_totals[0] += np.float32(1.0)  # one step of one rollout paid for a goal more
        altered_last[0, 0, 0] += 1  # one coordinate of one rollout moved
        outs = {"program": k,
                "control_bfloat16": output(*ref_env.rollout(t, driver.pidx, a, ms, rounding=bfloat16)),
                "state_unchanged": output(*ref_env.rollout(t, driver.pidx, a, ms, step=lambda p, _: p)),
                "half_batch": output(half_totals, half_last),
                "answer_altered": output(altered_totals, altered_last)}
        for name, out in outs.items():
            for number, v in driver.readings(out, totals, last, movable).items():
                res.setdefault(number, {})[name] = max(res.get(number, {}).get(name, 0), v)
    return res


def plan_readings(driver) -> dict:
    refs = {}
    program = truncated = altered = 0
    first = True
    for r in driver.results:
        if r["plan"] is None:
            continue
        rp = refs.setdefault(r["puzzle"], ref_puzzle.parse(driver.texts[r["puzzle"]]))
        program += not dynamics.plan_reaches_goal(rp, r["plan"])
        truncated += not dynamics.plan_reaches_goal(rp, r["plan"][:-1])
        if first:
            bad = list(r["plan"])
            bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % 4
            altered += not dynamics.plan_reaches_goal(rp, bad)
            first = False
    return {"plans_not_reaching_goal": {"program": program, "control_truncated": truncated,
                                        "answer_altered": altered}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    cell = cells.resolve(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        run = Run(cell, seed, args.seconds, False, dev)
        driver = cell.driver().Driver(run)
        t0 = time.perf_counter()
        driver.setup()
        run.window = driver.window(args.seconds)
        driver.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        readings = (plan_readings if cell.traffic["driver"] == "plan" else rollout_readings)(driver)
        print(json.dumps({"workload": cell.name, "seed": seed, "attempted": run.window["attempted"],
                          "seconds": time.perf_counter() - t0, "readings": readings}), flush=True)


if __name__ == "__main__":
    main()
