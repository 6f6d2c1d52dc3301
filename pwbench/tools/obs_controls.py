"""Readings for the limits of the Gym cell (``rollout-obs.*``): the
program's, and the control's and the stand-ins' in its place, at the cell's
own size.

    python pwbench/tools/obs_controls.py --workload rollout-obs.level0-gym --seconds <s> --seeds <n> [<n> ...]

For each seed, one window of the cell's traffic runs as in a benchmark run
(set-up, window, the program's state freed); then each number the check
compares is read, the worst over the kept replays, for the program (the
lower reading of its limit) and for each stand-in put in its place:
``control_bfloat16``, the reference computed in bfloat16 (the
configuration's rewards are float32); ``state_unchanged`` (a step that
leaves the state as it was); ``answer_altered`` (one step of one rollout
paid a goal more, one coordinate of one rollout moved, one observation
cell's channel flipped).  Prints one JSON line a seed.  The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from pwbench.controls import bfloat16  # noqa: E402
from pwbench.harness import cell as cells  # noqa: E402
from pwbench.harness.main import Run  # noqa: E402


def _as_output(r) -> dict:
    """A reference's outputs in the form of a kept replay."""
    return dict(r, total=float(np.asarray(r["totals"], np.float64).sum()), positions=r["last"],
                obs=np.stack(r["obs"]))


def readings(driver) -> dict:
    movable = driver.tables().cmask[driver.pidx].any(-1)
    res = {}
    for k in driver.kept:
        want = driver.reference(k)
        altered = _as_output(want)
        altered["reward"] = altered["reward"].copy()
        altered["reward"][0, 0] += np.float32(1.0)
        altered["totals"] = altered["totals"].copy()
        altered["totals"][0] += np.float32(1.0)
        altered["total"] += 1.0
        altered["positions"] = altered["positions"].copy()
        altered["positions"][0, 0, 0] += 1
        altered["obs"] = altered["obs"].copy()
        altered["obs"][0, 0, 0, 0, 0] = 1.0 - altered["obs"][0, 0, 0, 0, 0]
        outs = {"program": k,
                "control_bfloat16": _as_output(driver.reference(k, rounding=bfloat16)),
                "state_unchanged": _as_output(driver.reference(k, step=lambda p, _: p)),
                "answer_altered": altered}
        for name, out in outs.items():
            for number, v in driver.readings(out, want, movable).items():
                res.setdefault(number, {})[name] = max(res.get(number, {}).get(name, 0), v)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="rollout-obs.level0-gym")
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
        print(json.dumps({"workload": cell.name, "seed": seed, "attempted": run.window["attempted"],
                          "seconds": time.perf_counter() - t0, "readings": readings(driver)}), flush=True)


if __name__ == "__main__":
    main()
