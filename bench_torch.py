#!/usr/bin/env python
"""Headline benchmark of the PyTorch port (``pushworld_tpu_torch``) on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"detail"}.  All progress/diagnostics go to stderr.  It imports only the port
and fails without a CUDA device.

Headline: puzzles solved per second by the heterogeneous fleet executor
(host native workers + the batched search on the GPU,
pushworld_tpu_torch.search.fleet) under the reference benchmark protocol's
per-puzzle budget.

``vs_baseline`` races a serial planner sequentially on the same puzzles with
the same per-puzzle budget: the reference C++ planner where the binary
``scripts_dev/ref_planner`` exists (this script does not build it), else the
port's own serial native planner.

A set specification names sub-folders of ``<root>/puzzles``; the root is
``PUSHWORLD_BENCHMARK_PATH`` (any folder holding ``puzzles/<level>/*.pwp``),
else ``benchmark/`` beside this script.  The published 223-puzzle dataset is
not part of the repository; to run on the repository's fixtures:

    PUSHWORLD_BENCHMARK_PATH=tests PUSHWORLD_BENCH_SET=heur python3 bench_torch.py

A run whose device worker failed prints no result line and exits 1.

Reliability: a watchdog thread force-prints the best partial result and
exits 0 if the run exceeds PW_BENCH_WATCHDOG_S (default 780); faulthandler
dumps all stacks to stderr at the same deadline for diagnosis.

Environment overrides:
  PUSHWORLD_BENCH_SET     comma-separated level:count specs
                          (default "level1:12,level2:18,level3:18,level4:6")
  PUSHWORLD_BENCH_BUDGET  per-puzzle seconds (default 20)
  PUSHWORLD_BENCH_BASELINE  "ref" | "native" | "skip" (default ref)
  PUSHWORLD_BENCH_PROTOCOL  "full60" = all four levels, 60 s per puzzle
  PW_BENCH_WATCHDOG_S     watchdog deadline seconds (default 780; <= 0
                          disables)
  PW_PROFILE_DIR          when set, capture a torch.profiler trace of the
                          fleet run into this directory (chrome trace)
"""

import contextlib
import faulthandler
import json
import os
import resource
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_BIN = os.path.join(HERE, "scripts_dev", "ref_planner")
ACTION = {"L": 0, "R": 1, "U": 2, "D": 3}

_T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[bench +{time.monotonic() - _T0:.0f}s] {msg}", file=sys.stderr, flush=True)


def load_set(spec: str):
    from pushworld_tpu_torch import config
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.utils.filesystem import get_puzzle_file_paths

    named = []
    paths_by_name = {}
    for part in spec.split(","):
        level, _, count = part.partition(":")
        level = level.strip()
        paths = get_puzzle_file_paths(os.path.join(config.BENCHMARK_PUZZLES_PATH, level))
        names = sorted(paths)
        if count:
            names = names[: int(count)]
        for n in names:
            named.append((f"{level}/{n}", Puzzle.from_file(paths[n])))
            paths_by_name[f"{level}/{n}"] = paths[n]
    return named, paths_by_name


def run_reference_baseline(named, paths_by_name, budget: float):
    """Sequential reference-protocol run of the reference binary."""

    def set_limits():
        resource.setrlimit(resource.RLIMIT_CPU, (int(budget), int(budget) + 5))
        resource.setrlimit(resource.RLIMIT_AS, (30 * 1024**3,) * 2)

    solved = 0
    t0 = time.monotonic()
    for name, puzzle in named:
        try:
            proc = subprocess.run(
                [REF_BIN, "N+RGD", paths_by_name[name]],
                capture_output=True, text=True,
                preexec_fn=set_limits, timeout=budget + 30,
            )
            out = proc.stdout.strip()
        except subprocess.TimeoutExpired:
            out = ""
        if out and all(c in ACTION for c in out):
            if puzzle.is_valid_plan([ACTION[c] for c in out]):
                solved += 1
    return solved, time.monotonic() - t0


def run_native_baseline(named, budget: float):
    from pushworld_tpu_torch.native import is_available, solve_native
    from pushworld_tpu_torch.search.host_planner import solve_host

    use_native = is_available()
    solved = 0
    t0 = time.monotonic()
    for n, p in named:
        try:
            if use_native:
                plan = solve_native(p, mode="N+RGD", time_limit=budget)
            else:
                plan = solve_host(p, mode="N+RGD", time_limit=budget)
            if plan is not None and (plan == [] or p.is_valid_plan(plan)):
                solved += 1
        except (TimeoutError, MemoryError):
            pass
    return solved, time.monotonic() - t0


def card_info() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, _, limit = line.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device available", file=sys.stderr)
        return 2

    if os.environ.get("PUSHWORLD_BENCH_PROTOCOL") == "full60":
        default_set, default_budget = "level1,level2,level3,level4", "60"
    else:
        default_set, default_budget = "level1:12,level2:18,level3:18,level4:6", "20"
    spec = os.environ.get("PUSHWORLD_BENCH_SET", default_set)
    budget = float(os.environ.get("PUSHWORLD_BENCH_BUDGET", default_budget))
    baseline_kind = os.environ.get("PUSHWORLD_BENCH_BASELINE", "ref")
    profile_dir = os.environ.get("PW_PROFILE_DIR")
    watchdog_s = float(os.environ.get("PW_BENCH_WATCHDOG_S", "780"))

    # Stack dumps to stderr if anything wedges near the watchdog deadline.
    if watchdog_s > 0:
        faulthandler.dump_traceback_later(max(60.0, watchdog_s - 10.0), file=sys.stderr)

    detail = {"set": spec, "budget_s": budget, "device": card_info()}
    emitted = {"done": False}

    def emit(value: float, vs_baseline: float) -> None:
        if emitted["done"]:
            return
        emitted["done"] = True
        print(
            json.dumps(
                {
                    "metric": "benchmark_puzzles_solved_per_s",
                    "value": round(value, 4),
                    "unit": "puzzles/s",
                    "vs_baseline": round(vs_baseline, 3),
                    "detail": detail,
                }
            ),
            flush=True,
        )

    named, paths_by_name = load_set(spec)
    detail["count"] = len(named)
    log(f"set loaded: {len(named)} puzzles")

    # --- serial baseline first: the reference binary is fork/exec'ed once
    # per puzzle, which must not happen while the fleet's threads run.
    base_solved, base_wall = 0, 0.0
    if baseline_kind == "ref" and os.path.exists(REF_BIN):
        base_solved, base_wall = run_reference_baseline(named, paths_by_name, budget)
        detail["baseline"] = "reference C++ run_planner"
    elif baseline_kind != "skip":
        base_solved, base_wall = run_native_baseline(named, budget)
        detail["baseline"] = "own native serial planner"
    else:
        detail["baseline"] = "skipped"
    detail["baseline_solved"] = base_solved
    detail["baseline_wall_s"] = round(base_wall, 1)
    baseline_rate = base_solved / base_wall if base_wall > 0 else 1e-9
    log(f"baseline ({detail['baseline']}): {base_solved} solved in {base_wall:.1f}s")

    from pushworld_tpu_torch.kernels import _build
    from pushworld_tpu_torch.search import fleet as fleet_mod

    # Build the kernels before any budget clock runs.
    _build.build()

    # Partial results shared with the watchdog: if the caller's budget is
    # about to end the process, print what the fleet has so far and exit 0
    # (a timeout must never erase the capture).
    partial_results = {}
    fleet_t0 = [None]

    def watchdog():
        time.sleep(watchdog_s)
        if emitted["done"]:
            return
        if fleet_mod._device_stats.get("device_failed"):
            # The card did not take part: no result line for such a run.
            log("WATCHDOG fired after the device worker failed: no result")
            os._exit(1)
        # Snapshot first: fleet worker threads insert into this dict
        # concurrently; list() is one atomic C call under the GIL.
        solved = sum(1 for r in list(partial_results.values()) if r.failure_reason is None)
        wall = time.monotonic() - (fleet_t0[0] if fleet_t0[0] is not None else _T0)
        detail["partial"] = True
        detail["fleet_solved"] = solved
        detail["fleet_wall_s"] = round(wall, 1)
        value = solved / wall if wall > 0 else 0.0
        log(f"WATCHDOG fired at +{watchdog_s:.0f}s: emitting partial result")
        faulthandler.dump_traceback(file=sys.stderr)
        emit(value, value / baseline_rate)
        os._exit(0)

    if watchdog_s > 0:
        threading.Thread(target=watchdog, daemon=True).start()

    # --- fleet executor (the headline).
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        trace_cm = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        )
    else:
        trace_cm = contextlib.nullcontext()
    log("fleet phase starting")
    fleet_t0[0] = time.monotonic()
    try:
        with trace_cm as prof:
            results = fleet_mod.plan_puzzles_fleet(
                named, time_limit=budget, group_size=8, results_out=partial_results
            )
            torch.cuda.synchronize()
    except fleet_mod.DeviceWorkerError as e:
        # The hosts finished, but a rate from a run in which the card did
        # nothing is not this benchmark's: print no result line.
        emitted["done"] = True
        log(f"FAILED: {e}")
        return 1
    fleet_wall = time.monotonic() - fleet_t0[0]
    fleet_solved = sum(1 for r in results.values() if r.failure_reason is None)
    log(f"fleet done: {fleet_solved}/{len(named)} in {fleet_wall:.0f}s")
    by_solver = {}
    for r in results.values():
        if r.failure_reason is None:
            by_solver[r.solver] = by_solver.get(r.solver, 0) + 1
    by_level = {}
    for n, r in results.items():
        lvl = n.split("/")[0]
        s, t = by_level.get(lvl, (0, 0))
        by_level[lvl] = (s + (r.failure_reason is None), t + 1)

    detail.update(
        fleet_solved=fleet_solved,
        fleet_by_solver=by_solver,
        fleet_by_level={k: f"{s}/{t}" for k, (s, t) in sorted(by_level.items())},
        fleet_wall_s=round(fleet_wall, 1),
        device_phases=dict(fleet_mod._device_stats),
    )
    if profile_dir:
        prof.export_chrome_trace(os.path.join(profile_dir, "fleet_trace.json"))
        detail["profile_dir"] = profile_dir

    value = fleet_solved / fleet_wall if fleet_wall > 0 else 0.0
    emit(value, value / baseline_rate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
