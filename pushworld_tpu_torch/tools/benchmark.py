"""Benchmark harness: runs the planner over a puzzle tree, one result YAML
per puzzle.

Output schema matches the reference harness exactly (reference:
python3/src/pushworld/benchmark_rgd.py:37-46,88-120):

    planner: <name>
    puzzle: <puzzle name>
    plan: <LRUD string or null>
    planning_time: <seconds; == time_limit on timeout>
    failure_reason: <absent | "time limit" | "no solution" | "memory error"
                     | "invalid plan">

Differences by design: the planner runs in-process on the accelerator (the
reference fork/execs a C++ binary per puzzle under rlimits,
utils/process.py:61-84); the time budget is enforced between search chunks
rather than by the OS.

The port's copy of the JAX package's ``tools/benchmark.py``: the same schema
and planner names; the batched branch plans on ``device`` (see
:func:`pushworld_tpu_torch.tools.resolve_planner`).
"""

import os
import time
from typing import Optional

import yaml

from pushworld_tpu_torch import config
from pushworld_tpu_torch.core.puzzle import Puzzle, plan_to_string
from pushworld_tpu_torch.device import DeviceLike
from pushworld_tpu_torch.search.planner import PlanResult, plan_puzzles, solve_puzzle
from pushworld_tpu_torch.tools import resolve_planner
from pushworld_tpu_torch.utils.filesystem import map_files_with_extension


def benchmark_planner(
    puzzles_path: str = config.BENCHMARK_PUZZLES_PATH,
    results_path: str = "results",
    heuristic: str = "N+RGD",
    time_limit: float = 1800.0,
    planner: str = "auto",
    skip_existing: bool = True,
    progress: bool = True,
    device: DeviceLike = "cuda",
) -> dict:
    """Runs the planner on every ``.pwp`` under ``puzzles_path``; writes one
    YAML per puzzle under ``results_path`` mirroring the directory tree.

    Returns {puzzle_name: PlanResult}.
    """
    planner, device = resolve_planner(planner, device)
    pairs = map_files_with_extension(
        puzzles_path, config.PUZZLE_EXTENSION, results_path, config.RESULT_EXTENSION
    )
    todo = []
    for in_path, out_path in pairs:
        if skip_existing and os.path.exists(out_path):
            continue
        todo.append((in_path, out_path))

    results = {}
    if planner == "batched":
        named = [
            (os.path.basename(p)[: -len(config.PUZZLE_EXTENSION)], Puzzle.from_file(p))
            for p, _ in todo
        ]
        out_paths = {
            os.path.basename(p)[: -len(config.PUZZLE_EXTENSION)]: o for p, o in todo
        }
        planner_name = f"pushworld-tpu batched {heuristic}"
        res = plan_puzzles(
            named, mode=heuristic, time_limit=time_limit, progress=progress, device=device
        )
        for name, r in res.items():
            _write_result(out_paths[name], planner_name, name, r, time_limit)
            results[name] = r
    else:
        planner_name = f"pushworld-tpu host {heuristic}"
        for in_path, out_path in todo:
            name = os.path.basename(in_path)[: -len(config.PUZZLE_EXTENSION)]
            puzzle = Puzzle.from_file(in_path)
            r = solve_puzzle(
                puzzle, mode=heuristic, time_limit=time_limit, planner="host"
            )
            _write_result(out_path, planner_name, name, r, time_limit)
            results[name] = r
            if progress:
                status = "ok" if r.failure_reason is None else r.failure_reason
                print(f"  {name}: {status} ({r.planning_time:.2f}s)", flush=True)
    return results


def _write_result(
    out_path: str, planner_name: str, name: str, r: PlanResult, time_limit: float
) -> None:
    # Internal diagnostic reasons (e.g. "frontier exhausted after
    # evictions": the device search pruned states it cannot re-generate, so
    # the outcome is inconclusive) map onto the reference harness's
    # taxonomy {time limit, no solution, memory error, invalid plan}
    # (reference: benchmark_rgd.py:94-117) at this reporting layer.
    reason = r.failure_reason
    if reason == "frontier exhausted after evictions":
        reason = "time limit"
    doc = {
        "planner": planner_name,
        "puzzle": name,
        "plan": plan_to_string(r.plan) if r.plan is not None and not reason else None,
        "planning_time": float(
            time_limit if reason == "time limit" else r.planning_time
        ),
    }
    if reason is not None:
        doc["failure_reason"] = reason
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
