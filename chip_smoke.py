#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``pushworld_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.

Phases, each printing one JSON line:

1. ``build``: compiles every CUDA kernel of the port with nvcc (sm_90a), in
   parallel, and beside them the empty kernel that measures a launch;
   prints nvcc's and the driver's versions.
2. ``wavefront``: on a 47 x 54 puzzle written from ``--seed`` (border walls,
   agent, one goal object, two obstacles), runs each object's all-pairs
   fields (one field per graph vertex, one shared mask stack) and the goal
   fields through the kernel and through its plain PyTorch version: the
   fields must be bit-equal, and the compact blocks and goal fields must equal
   the scipy / BFS host helpers.  Also bit-equal: a capped run, a batch in
   which every field has its own masks, a batch with seeds other than 0/INF
   (the kernel's general path), and a 9 x 150 grid (rows of several words).
3. ``visited_set``: a 2**21-slot table, batches of 1024 keys forced to share
   home slots, insert and delete rounds on the kernel and on the plain
   version: no torn or lost keys, and the same membership and ``is_new``
   wherever no two lanes of one round ever shared a home slot.  The insert
   and the delete kernels are timed beside their plain versions at table
   loads of 0, 0.5 and 0.75 (filled by the plain version, a tenth of the
   filled keys deleted again, so that tombstones lie on the probe paths):
   batches of 1,024 fresh keys to insert, of 1,024 keys in the table to
   delete, each load's error against the plain version printed.  The fused
   fingerprint + dedup + insert kernel gets batches of states with duplicate
   children, invalid lanes and keys already in the table, under the same
   rule, and is timed beside the three-step composition it replaces.  The
   fingerprint kernel alone (a search's root, the frontier-sharded
   routing) must give the plain int64 fold's keys on 1,024 states at 4, 19
   and 100 objects (random cells, and real searches' children at 4 and
   19); it is timed at 1,024 states and at one.
   Then ``rgd_novelty``: the RGD kernel against its plain version,
   bit-equal (totals and needs-deeper flags), on 1,024 children of real
   search states and on their 256 parents, at the production capacities:
   the 47 x 54 puzzle at depth 0, three_tools and the generator's first
   depth-3 candidate at depth 3, and the four-tool chain at depth 4, and
   on each search's next iteration as ``_iterate`` takes it (the children
   under their ``is_new`` mask, the selected parents under ``sel_valid``);
   the novelty kernels (score, then update) on four such batches of the 47 x 54 search, from its own pair_bits 24
   tables: scores, seen_pos and the pair table bit-equal after every
   batch, and a closed gate (every lane invalid) that scores 3 and leaves
   both tables unchanged.  Each is timed (events and profiler) beside its
   plain version and its bound (the bytes this run's states need; the
   launch floor where larger), RGD also under the iteration's own masks,
   and each kernel at a closed gate.  Then ``iteration_kernels``: the rest of the search iteration's
   kernels against their plain versions, error 0, on real searches at the
   production capacities (the 47 x 54 puzzle at depth 0 and three_tools at
   depth 3 after up to 8 iterations): the gate and the selection, the
   expansion of the selected parents, the RGD kernel with its is_new mask,
   the compaction (idle, and forced by a cursor within a window of the
   end) and the append, every tensor of the state compared; the select on
   the 47 x 54 search at twice the production frontier (2^16 slots); the 47 x 54
   search with the least frontier (2,048 slots) caught at a compaction that
   evicts (the compaction deletes its drops from the visited set itself:
   its table is compared with the plain compaction's bit for bit, the keys
   deleted printed); a closed gate (a solved search), where ``_iterate`` must leave
   the state bit-unchanged (its device time and kernels per iteration are
   printed; the expansion's and the append's closed-gate device time
   too).  Each kernel is timed beside its plain version, its bound and,
   for the select and the compaction, the one PyTorch call that computes
   the same function (``torch.topk``, a stable ``torch.sort``): its event
   time (``library_ms``, the host's enqueue included) and its kernels'
   device time (``library_device_ms``, beside the hand kernel's
   ``device_ms``).
4. ``solve`` (the main path): the launch counts are set to 0, then
   ``solve_puzzle(mode="N+RGD", time_limit=60)`` runs on the card at the
   production capacities of ``plan_puzzles`` for every fixture under
   tests/puzzles and tests/puzzles/heur and for the 47 x 54 puzzle.  Every
   plan must pass the oracle; the unsolvable fixtures must report
   "no solution"; every kernel of the main path must have been launched
   (the standalone visited-set delete is not one since the compaction
   deletes its own drops: phase ``visited_set`` drives it; a search's chunks
   are replays of its captured CUDA graph; each replay adds the kernel
   launches its capture recorded).  Then ``chunk``: at the production
   capacities, graphed chunks and the eager ``_iterate`` loop from the same
   initial state must leave the same search (the visited set compared as a
   set of keys) on the 47 x 54 puzzle (RGD depth 0) and on the first
   depth-3 candidate of the tools phase's generator (a "no solution"
   candidate); a chunk enqueued with no deadline behind 10 ms of queued
   device work must return while the card is still busy; ms per iteration graphed and eager, the graphed
   chunks' card-busy share, graph nodes, ``G``, capture and instantiation seconds, the time of
   a chunk after the search's end (its gate closed: a no-op that costs its
   kernels; host and device time), and the overshoot of a 2 s budget on the
   16 x 16 puzzle are printed; the profiler's rows of a graphed iteration
   must hold no sort and no matrix product.  Two small
   fixtures are also solved on the CPU and must give the same plan and
   expansions.  Between ``solve`` and ``chunk``, ``many_objects``: states of
   33, 64 and 100 objects, which take the wide paths of the expansion, RGD
   and novelty.  On a real search's batch of each (``many_objects_text``)
   the three, and the fingerprint, must equal their plain versions, and RGD
   at depths 1-2 (3 at 33) on walks of the four-tool chain widened by
   obstacles, whose goal needs depth 4 (its deep tables in shared memory at
   33, in device scratch above, there also on 1,024 states, more than the
   scratch path's persistent grid has CTAs); each lane prints its path,
   device time, plain time and bound, and the same lanes run at 32 objects
   on the one-word paths beside them.  The expansion's two paths, equal on
   searches of 4 to 32 objects, are timed side by side.  Then, with the
   launch counts at 0, ``solve_puzzle(mode="N+RGD")`` on the card at the
   production capacities for the three puzzles: valid plans, and, at 64,
   plan, iterations and expansions equal to the CPU's; the 64-movable one
   through ``plan_puzzles(portfolio=True)`` and, with the 33- and an
   8-movable one, the fleet with its native workers (the native planner
   takes at most 31 movables, so the two wide ones must go to the device
   worker); the greedy policy's successor values on 1,024 states, card =
   CPU.
5. ``graphs``: the device graph ops.  ``build_reachability`` on the card
   must equal the native fixpoint's ``E`` and its own CPU run on ten ``heur``
   fixtures and on the 47 x 54 puzzle (iteration counts and seconds are
   printed); ``all_pairs_distances`` of the agent's graph there (2,538 fields)
   goes through the wavefront kernel and must equal the plain version and the
   scipy BFS on the graph's vertices; a capped ``distance_to_targets`` too.
6. ``envs``: the environment half at batch 4096.  The same seed-made actions
   drive ``VectorEnv`` on the card and on the CPU for 64 steps, on the
   47 x 54 puzzle and on a stacked batch of three fixtures: every output of
   every step must be equal, and 256 rollouts must follow the oracle step by
   step, auto-resets included.  The batched one-hot renderer must equal the
   per-state renderer on 256 states and the CPU's result on all.  The greedy
   goal-distance policy, with tables built on the card (the wavefront kernel
   launches, and the tables must equal the CPU's), must reach the goal in
   every rollout.  ``measure_env_throughput`` runs at batch 4096, horizon
   128, 3 reps, with and without observations; a profiled window gives
   kernels per step and the device-busy share, and the step and the renderer
   are timed alone, the renderer beside its bytes bound.  The Gym and dm_env
   wrappers are held against the oracle where their packages are installed.
7. ``native``: the native serial planner, built from
   ``pushworld_tpu_torch/native/planner.cc`` by the host C++ compiler (the
   build starts beside the nvcc builds), must be available; it solves every
   solvable fixture in both modes and through the staged schedule, reports
   "no solution" on the unsolvable ones, and its movement-graph fixpoint
   must equal the Python worklist on every puzzle.  The table build of the
   47 x 54 puzzle is timed with either fixpoint.
8. ``portfolio``: ``plan_puzzles(portfolio=True, time_limit=60)`` on all 29
   puzzles, then a second pass with ``PW_PORTFOLIO_HEADSTART=0`` over two
   fixtures and a 16 x 16 puzzle that outlasts the native planner, in which
   the device member must engage.
9. ``fleet``: ``plan_puzzles_fleet`` on the 29 puzzles with the device worker
   alone in claim mode (again with ``PW_DEVICE_SYNC_EVERY`` at 1 and 4: the
   same results, status reads that do not rise with the setting; and two
   lanes of the 16 x 16 puzzle at 1, 2 and 4: to a full history, reads that
   fall, and to a 3 s budget, the budget's overshoot), with the defaults (shadow mode, one
   native worker per core) and with the device off; then a run in which every core holds a
   native worker on the 16 x 16 puzzle while the device worker shadows the
   fixtures, and the solve of the 47 x 54 puzzle timed alone and beside as
   many native threads as cores.  One lane's device bytes are measured
   beside ``fleet.bytes_per_lane``.
10. ``parallel``: the parallel layer on the card.  (a) The frontier-sharded
   search of the 47 x 54 puzzle at production capacities over a one-rank
   NCCL group: a valid plan; its ms per iteration beside the batched
   search's on the same puzzle, and the collectives' device time
   (torch.profiler; one all-to-all an iteration).  Then spill_grid at
   production capacities in chunks of 4 iterations over the NCCL group and
   over a one-rank gloo group on the CPU: the same plan, chunks, iterations
   and expansions.
   (b) spill_grid with a 64-entry history and the least
   frontier spills at least 2 epochs, evicts and still gives a valid plan;
   no_solution gives None.  (c) ``solve_group`` on the 29 puzzles (one group
   per RGD depth): every lane's plan is ``solve_puzzle``'s.  (d)
   ``scripts/benchmark_distributed.py`` in two processes on the one card:
   each has the whole merged set, and their shards partition it.  (e) The
   fleet in shadow mode with ``PW_DEVICE_SHARDED=1`` and no native worker:
   a 10-movable puzzle is solved by ``"device-sharded"``.  (f)
   ``entry.dryrun_multichip(1)`` and ``entry()`` on the card.
11. ``tools``: the toolkit on the card.  (a) ``generate_level0_puzzles``
   (16 candidates from ``--seed``, sizes 8-12, complex shapes) filtered with
   ``planner="auto"`` on the card (the batched search) and with the host
   planner: every candidate decided by a plan or "no solution", the two
   kept sets byte-equal, every plan valid.  (b) ``create_transformed_puzzles``
   on the kept set: each variant's mapped plan passes the oracle.  (c)
   ``benchmark_planner(planner="batched")`` on the card over the variants
   (at most 64) with its defaults (the portfolio), then again with no
   native planner (as on a host without a C++ compiler: the device search
   alone); every YAML has the schema and a valid plan; then the CLI's
   ``benchmark --device cuda`` in a subprocess on 4 of them.  (d) The host
   tools through the CLI: PDDL export in both modes, the plot of (c)'s
   results (where matplotlib is installed), previews equal to
   ``Puzzle.render``.

The launch counts are set to 0 before each of the phases 4 (and its
``many_objects`` solves and ``chunk``), 5, 6, 8, 9, 10 and 11 (and each
fleet run) and read after it.  Beside ``ms`` (CUDA events around
the wrapper: for the small kernels the host's enqueue time) every kernel has
``device_ms``, its own time from ``torch.profiler``; an empty kernel, built
from a source in this script, is launched and timed the same two ways as the
floor of any launch, and it is the bound (``bound_by: "launch"``) of a kernel
whose bytes take less.  ``device_ms`` is a kernel's traced time over the
calls made; the line ``traced_launches`` gives each reading's calls beside
the launches its trace holds (``short``: the readings whose trace missed
some, which read low).  The card line (nvidia-smi) comes first; the kernels line comes just before
the last line, the result.
Any failure raises and the script exits non-zero.  It exits non-zero without
a result when there is no CUDA device or no port package beside it.
"""

import argparse
import glob
import itertools
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
UNSOLVABLE = {"no_solution", "overlap", "spill_grid_unreachable"}
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
SLEEP_10_MS_CYCLES = 20_000_000  # torch.cuda._sleep: ~10 ms at the H100's 1.98 GHz SM clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def generated_puzzle_text(seed: int) -> str:
    """A 47 x 54 puzzle (45 x 52 content plus the border walls): agent, one
    goal object far from its goal, and two 2 x 2 obstacles."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H, W = 45, 52
    grid = [["." for _ in range(W)] for _ in range(H)]

    def put(tok, x, y, w=1, h=1):
        for yy in range(y, y + h):
            for xx in range(x, x + w):
                check(grid[yy][xx] == ".", "generated puzzle overlaps")
                grid[yy][xx] = tok

    put("A", int(rng.integers(1, 5)), int(rng.integers(1, 5)))
    put("M0", int(rng.integers(6, 10)), int(rng.integers(6, 10)))
    put("G0", int(rng.integers(40, 48)), int(rng.integers(34, 41)))
    put("M1", int(rng.integers(16, 22)), int(rng.integers(18, 24)), 2, 2)
    put("M2", int(rng.integers(28, 34)), int(rng.integers(10, 16)), 2, 2)
    return "\n".join(" ".join(f"{t:>2}" for t in row) for row in grid) + "\n"


# A 16 x 16 puzzle (4 movables, 3 goals, RGD depth 0) that the native
# planner does not solve within 20 s in any stage of its schedule: work that
# keeps a native worker busy and makes the portfolio's device member engage.
HARD_PUZZLE_TEXT = """
 .  .  .  W  .  .  .  .  .  W  .  .  .  .  .  W
 .  .  .  .  W  .  .  W  .  W  .  .  .  .  .  .
 .  .  .  A  .  W  .  .  W  W  .  .  .  .  .  .
 W  W  W  .  .  .  .  .  .  .  .  .  .  .  .  .
 .  .  .  .  .  .  .  .  .  .  .  .  .  .  .  W
 .  .  W  .  W  W  .  W  .  W  .  . G0  . M0  .
 .  .  .  .  .  .  .  W  W  .  .  . G0  . M0  .
 .  W  .  .  .  .  W  .  . M1  .  .  .  .  W  W
 W  W  .  .  .  .  .  .  W M1  W  .  .  .  .  .
 .  .  .  W  .  W  .  W  .  .  .  .  W  .  .  .
 .  .  .  .  .  . M2 M2  .  .  .  .  W  .  .  .
 .  W  .  .  .  .  .  .  . G1  .  .  .  .  .  .
 .  .  .  W  .  .  .  .  . G1  .  .  .  .  .  .
 .  W  W  .  . M3 M3  .  .  .  .  .  .  W  .  W
 .  .  .  .  .  .  .  .  .  .  .  .  W  .  .  .
 .  .  .  .  .  .  .  .  . G2 G2  .  .  .  .  .
""".lstrip("\n")

# The 16 x 16 puzzle's budget runs (phases chunk and fleet) end at their
# budget, not at a full history: production capacities with a history of
# 2^24 entries (2^21 fills in under a second on an H100) and as many
# visited-set slots.  Each run checks that its budget ended it.
BUDGET_HISTORY_BITS = 24


def budget_capacities() -> dict:
    """The planner's capacities for a budget run (see above)."""
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    return dict(PRODUCTION_CAPACITIES, history_capacity=1 << BUDGET_HISTORY_BITS, visited_bits=BUDGET_HISTORY_BITS)


# A 9 x 12 puzzle (with its border walls) of ten movables: the agent, one
# goal object three pushes from its goal, and eight obstacles.  The fleet's
# frontier-sharded branch takes only instances of more than 8 movables, and
# no fixture has that many.
MANY_MOVABLES_TEXT = """
 A  .  .  .  .  .  .  .  .  .
 . M0  .  . G0  .  .  .  .  .
 .  .  .  .  .  .  .  .  .  .
 . M1  . M2  . M3  . M4  .  .
 .  .  .  .  .  .  .  .  .  .
 . M5  . M6  . M7  . M8  .  .
 .  .  .  .  .  .  .  .  .  .
""".lstrip("\n")

def many_objects_text(n_objects: int) -> str:
    """A square puzzle of ``n_objects`` movables: the agent, a goal object
    three pushes from its goal, and single-cell obstacles on every other cell
    of the lower rows.  The grid is 12 x 12 up to 32 movables (30 obstacle
    cells) and grows by two cells a side until the obstacles fit (20 x 20 at
    64, 22 x 22 at 100).  The tests hold the kernels' one-word paths at 32
    objects and their wide paths above with it."""
    size = 12
    while ((size - 2) // 2) * ((size + 1) // 2) < n_objects - 2:
        size += 2
    grid = [["." for _ in range(size)] for _ in range(size)]
    grid[0][0], grid[1][1], grid[1][4] = "A", "M0", "G0"
    cells = [(x, y) for y in range(3, size, 2) for x in range(0, size, 2)]
    for k, (x, y) in enumerate(cells[: n_objects - 2]):
        grid[y][x] = f"M{k + 1}"
    return "\n".join(" ".join(f"{c:>3}" for c in row) for row in grid) + "\n"


# A 14 x 8 puzzle (with its border walls) of six movables whose goal needs
# a chain of four tools: the agent pushes M4 across its wall, M4 pushes M3,
# and so on down to M0.  Pushing depths 4 and 5 run the RGD kernel's loop
# over T(., 2) tables, which no fixture reaches (phase ``rgd_novelty`` and
# the tests).
FOUR_TOOLS_TEXT = """
 .  .  AW    .  .  .
 A  .  AW    .  .  .
 M4 M4 AW+M4 .  .  .
 .  .  AW    .  .  .
 .  .  AW+M3 M3 .  .
 .  .  AW    .  .  .
 .  .  AW    M2 M2 .
 .  .  AW    .  .  .
 .  .  AW    .  M1 M1
 .  .  AW    .  .  M0
 .  .  AW    .  .  G0
 .  .  AW    .  .  .
""".lstrip("\n")



def four_tools_with_obstacles_text(n_objects: int) -> str:
    """FOUR_TOOLS_TEXT widened to the right by single-cell obstacles (every
    other cell of every other row, beyond the agent's wall) up to
    ``n_objects`` movables: its initial state still needs pushing depth 4,
    so RGD at depths 1-3 runs the kernel's deep tables over every movable
    on it and on the states a short walk reaches."""
    rows = FOUR_TOOLS_TEXT.splitlines()
    extra = n_objects - 6
    per_row = -(-extra // ((len(rows) + 1) // 2))
    k = 5
    out = []
    for y, row in enumerate(rows):
        cells = []
        for e in range(2 * per_row):
            if y % 2 == 0 and e % 2 == 1 and k < n_objects - 1:
                cells.append(f"M{k}")
                k += 1
            else:
                cells.append(".")
        out.append(row + " " + " ".join(f"{c:>3}" for c in cells))
    return "\n".join(out) + "\n"


KERNEL_NAMES = ("wavefront", "visited_set.probe_and_insert", "visited_set.probe_delete",
                "visited_set.fingerprint_dedup_insert", "visited_set.fingerprint", "rgd.heuristic",
                "novelty.score", "novelty.absorb", "step.expand", "frontier.select", "frontier.compact",
                "frontier.append")
# The main path launches every kernel but the standalone delete: the
# compaction tombstones the fingerprints it drops inside its own kernel.
OFF_MAIN_PATH = {"visited_set.probe_delete": "inside frontier.compact (compact_kernel's delete_key)"}
MAIN_PATH_KERNELS = tuple(k for k in KERNEL_NAMES if k not in OFF_MAIN_PATH)
# The kernels of a search iteration (one launch each an iteration).
ITERATION_KERNELS = ("frontier.select", "step.expand", "visited_set.fingerprint_dedup_insert", "novelty.score",
                     "novelty.absorb", "rgd.heuristic", "frontier.compact", "frontier.append")


def check_results(named, results, what: str):
    """Every instance has one result, every plan passes the oracle, and the
    unsolvable fixtures report "no solution".  Returns {name: classification}."""
    check(sorted(results) == sorted(n for n, _ in named), f"{what}: lost or extra instances")
    out = {}
    for name, p in named:
        r = results[name]
        if name in UNSOLVABLE:
            check(r.failure_reason == "no solution" and r.plan is None, f"{what}: {name}: {r}")
        elif r.failure_reason is None:
            check(r.plan == [] or p.is_valid_plan(r.plan), f"{what}: {name}: invalid plan")
        out[name] = r.failure_reason or "solved"
    return out


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


LAUNCH_FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void pw_empty_kernel() {}
extern "C" int pw_empty_launch(void* stream) {
  pw_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def start_launch_floor_build():
    """Starts nvcc on the empty kernel (beside the port's own builds);
    returns (process, library path)."""
    from pushworld_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "launch_floor.cu"
    src.write_text(LAUNCH_FLOOR_SRC)
    lib = _build.BUILD_DIR / "liblaunch_floor.so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def profile_device(fn, reps: int = 1, attempts: int = 6) -> dict:
    """``fn`` called ``reps`` times under torch.profiler, as
    ``scripts/profile_search.py`` counts: wall seconds (host clock, ending in
    a synchronise), the device's busy microseconds, the number of device
    kernels (copies and memsets included) and [count, microseconds] by
    kernel name.  A trace that holds no device time (CUPTI now and then
    delivers none for a window) is taken again, up to ``attempts`` traces in
    all, so ``fn`` must bear being called again.  ``retrace`` takes the
    trace anew (:func:`kernel_device_ms` calls it where a trace missed a
    kernel's every launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5 * attempt)  # a trace without device time tends to follow another
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t0
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        if rows:
            break
        print(json.dumps({"profiler": "a trace held no device time; tracing again"}), file=sys.stderr, flush=True)
    check(len(rows) > 0, f"torch.profiler recorded no device time in {attempts} traces")
    return {"wall_s": wall_s, "busy_us": sum(dev_us(e) for e in rows),
            "n_kernels": sum(e.count for e in rows),
            "by_kernel": {e.key: [e.count, dev_us(e)] for e in rows},
            "retrace": lambda: profile_device(fn, reps, attempts)}


def kernel_device_ms(prof: dict, *names: str, calls: int) -> float:
    """Device milliseconds per call of the kernels whose names contain one of
    ``names``, from a :func:`profile_device` result over ``calls`` calls.
    Each such kernel's launch count in the trace goes into
    :data:`TRACED_LAUNCHES` beside ``calls``, so a trace that missed
    launches (and so reads low) shows in the script's output.  A trace that
    holds none of a kernel's launches is taken again (``prof`` is updated in
    place), up to 3 times."""
    for retry in range(4):
        hit = {k: v for k, v in prof["by_kernel"].items() if any(n in k for n in names)}
        if len(hit) >= len(names) or retry == 3:
            break
        print(json.dumps({"profiler": f"a trace missed every launch of {names}; tracing again"}), file=sys.stderr,
              flush=True)
        prof.update(prof["retrace"]())
    check(len(hit) >= len(names), f"profiler saw no kernel named {names}: {sorted(prof['by_kernel'])}")
    TRACED_LAUNCHES.append({"calls": calls, "traced": {_kernel_name(k): count for k, (count, _) in hit.items()}})
    return sum(us for _, us in hit.values()) / 1e3 / calls


# Every kernel_device_ms reading: the calls made and each kernel's launches
# in the trace, emitted as one line at the end of the run.
TRACED_LAUNCHES: list = []


def library_device_ms(fn, reps: int = 50) -> float:
    """Device milliseconds per call of one PyTorch library call (every kernel
    it launches, from :func:`profile_device`): the yardstick beside a hand
    kernel's ``device_ms``, where ``library_ms`` (events) also counts the
    host's enqueue."""
    return profile_device(fn, reps=reps)["busy_us"] / 1e3 / reps


def _kernel_name(key: str) -> str:
    """A hand kernel's name, template arguments included, from a profiler
    key (the key's start where it names none)."""
    m = re.search(r"(\w*kernel\w*(?:<[^(]*>)?)\(", key)
    return m.group(1) if m else key[:80]


def _top_kernels(prof: dict, n: int):
    """The ``n`` kernels with the most device time of a
    :func:`profile_device` result, as (shortened name, microseconds)."""
    by_short = {}
    for name, (_, us) in prof["by_kernel"].items():
        short = name.replace("void ", "").replace("at::native::", "")[:160]
        by_short[short] = by_short.get(short, 0) + us
    return sorted(by_short.items(), key=lambda kv: -kv[1])[:n]


def measure_launch_floor(proc, lib_path) -> dict:
    """The empty kernel through ctypes, as the hand kernels are launched:
    milliseconds per launch by CUDA events over back-to-back launches, and
    the kernel's own device time."""
    import ctypes

    import torch

    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc failed for the empty kernel:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    lib.pw_empty_launch.argtypes = [ctypes.c_void_p]
    lib.pw_empty_launch.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch():
        check(lib.pw_empty_launch(stream) == 0, "empty kernel launch failed")

    event_ms = cuda_time_ms(launch, reps=500)
    prof = profile_device(launch, reps=200)
    out = {"event_ms": event_ms, "device_ms": kernel_device_ms(prof, "pw_empty_kernel", calls=200)}
    emit({"phase": "launch_floor", **out})
    return out


def work_bound(n_bytes, n_ops, floor) -> dict:
    """The least time for ``n_bytes`` moved and ``n_ops`` float32 operations:
    the larger of the bytes over the memory rate and the operations over the
    float32 rate, or the empty kernel's device time (``floor``) where that
    is larger still: no kernel ends sooner than a launch."""
    b_ms, o_ms = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_F32_OPS_PER_S * 1e3
    ms, by = (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")
    if floor["device_ms"] > ms:
        ms, by = floor["device_ms"], "launch"
    return {"bound_ms": ms, "bound_by": by, "bytes_bound_ms": b_ms}


def walk_states(puzzle, count, seed):
    """``count`` states of a random walk from ``puzzle``'s initial state, one
    to five moves apart: (count, N, 2) int32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = puzzle.initial_state
    out = [s]
    for _ in range(count - 1):
        for a in rng.integers(0, 4, size=rng.integers(1, 6)).tolist():
            s = puzzle.get_next_state(s, a)
        out.append(s)
    return np.asarray(out, np.int32)


def phase_wavefront(puzzle, dev):
    """Kernel vs plain version on every field of the table build; returns the
    kernels-line entry (timed on the largest all-pairs launch)."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.ops.graphs import (
        INF, distance_fields_reference, host_distance_to_targets,
        host_graph_distances_compact, host_vertex_mask)
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields
    from pushworld_tpu_torch.ops.rgd import _movement_graphs_host

    cp = compile_puzzle(puzzle)
    H, W = cp.height, cp.width
    E_np = _movement_graphs_host(puzzle, cp)
    E = torch.as_tensor(E_np, device=dev)
    largest = None
    n_fields = 0
    err = 0.0
    for o in range(puzzle.num_movables):
        init = puzzle.initial_state[o]
        verts = np.nonzero(host_vertex_mask(E_np[:, o], init[1] * W + init[0]))[0]
        R = len(verts)
        v = torch.as_tensor(verts, device=dev)
        d0 = torch.full((R, H * W), INF, dtype=torch.float32, device=dev)
        d0[torch.arange(R, device=dev), v] = 0.0
        d0 = d0.reshape(R, H, W)
        E_o = E[None, :, o]
        got = distance_fields(E_o, d0)
        want = distance_fields_reference(E_o, d0)
        err = max(err, abs_err(got, want))
        check(torch.equal(got, want), f"wavefront != plain version (object {o})")
        Dc = got.reshape(R, -1)[:, v].T.cpu().numpy()
        check(np.array_equal(Dc, host_graph_distances_compact(E_np[:, o], verts)),
              f"compact block != scipy BFS (object {o})")
        n_fields += R
        if largest is None or R > largest[0]:
            largest = (R, E_o, d0, got)
    goals = list(range(1, puzzle.num_goals + 1))
    d0g = torch.full((len(goals), H, W), INF, dtype=torch.float32, device=dev)
    for i, o in enumerate(goals):
        g = puzzle.goal_state[o - 1]
        d0g[i, g[1], g[0]] = 0.0
    Eg = E[:, goals].permute(1, 0, 2, 3).contiguous()
    DG = distance_fields(Eg, d0g)
    DG_want = distance_fields_reference(Eg, d0g)
    err = max(err, abs_err(DG, DG_want))
    check(torch.equal(DG, DG_want), "goal fields != plain version")
    for i, o in enumerate(goals):
        g = puzzle.goal_state[o - 1]
        check(np.array_equal(DG[i].cpu().numpy(), host_distance_to_targets(E_np[:, o], g[1] * W + g[0])),
              f"goal field != host BFS (object {o})")

    R, E_o, d0, out = largest
    extra = [("capped", E_o, d0, 5)]
    # Every field its own masks: one field per object, seeded at its start.
    n_obj = puzzle.num_movables
    E_own = E.permute(1, 0, 2, 3).contiguous()
    d0_own = torch.full((n_obj, H, W), INF, dtype=torch.float32, device=dev)
    for o in range(n_obj):
        d0_own[o, puzzle.initial_state[o][1], puzzle.initial_state[o][0]] = 0.0
    extra += [("own masks", E_own, d0_own, 0), ("own masks, capped", E_own, d0_own, 7)]
    # Seeds other than 0/INF in two fields of three: the general path.
    rng = np.random.default_rng(0)
    n_gen = 48
    d0_gen = d0[:n_gen].clone()
    odd = torch.as_tensor(rng.integers(0, 40, (n_gen, H, W)).astype(np.float32), device=dev)
    pick = torch.as_tensor(rng.random((n_gen, H, W)) < 0.02, device=dev)
    pick[::3] = False
    d0_gen = torch.where(pick, odd, d0_gen)
    extra += [("general seeds", E_o, d0_gen, 0), ("general seeds, capped", E_o, d0_gen, 3)]
    # Rows of more than one 64-bit word: the kernel's shared-memory level loop.
    E_wide = torch.as_tensor(rng.random((1, 4, 9, 150)) < 0.7, device=dev)
    d0_wide = torch.full((64, 9 * 150), INF, dtype=torch.float32, device=dev)
    d0_wide[torch.arange(64), torch.as_tensor(rng.integers(0, 9 * 150, 64))] = 0.0
    d0_wide = d0_wide.reshape(64, 9, 150)
    extra += [("wide rows", E_wide, d0_wide, 0), ("wide rows, capped", E_wide, d0_wide, 4)]
    for what, E_x, d0_x, cap in extra:
        got = distance_fields(E_x, d0_x, max_iters=cap)
        want = distance_fields_reference(E_x, d0_x, max_iters=cap)
        err = max(err, abs_err(got, want))
        check(torch.equal(got, want), f"wavefront != plain version ({what})")
        n_fields += d0_x.shape[0]
    ms = cuda_time_ms(lambda: distance_fields(E_o, d0), reps=20)
    plain_ms = cuda_time_ms(lambda: distance_fields_reference(E_o, d0), reps=2)
    device_ms = kernel_device_ms(profile_device(lambda: distance_fields(E_o, d0), reps=10),
                                 "pack_masks_kernel", "wavefront_kernel", calls=10)
    # Bound of the function (a distance transform), not of this kernel's
    # sweeps: each input read once (the 4 shared bool mask planes, the f32
    # seeds), the f32 output written once; one visit per cell per field, 4
    # directions x (add + min).
    n_bytes = 4 * H * W + 2 * R * H * W * 4
    n_ops = 8 * R * H * W
    bound_s = max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_OPS_PER_S)
    emit({"phase": "wavefront", "grid": [H, W], "objects": puzzle.num_movables,
          "fields_checked": n_fields + len(goals), "timed_fields": R, "ms": ms,
          "device_ms": device_ms, "plain_ms": plain_ms, "max_abs_err": err})
    return {
        "name": "wavefront", "route": "cuda", "bytes_bound_ms": n_bytes / H100_BYTES_PER_S * 1e3,
        "source": "pushworld_tpu_torch/kernels/wavefront.cu",
        "replaces": "pushworld_tpu/ops/graphs_pallas.py:38",
        "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / H100_BYTES_PER_S >= n_ops / H100_F32_OPS_PER_S else "operations",
        "library_ms": None,
        "library_device_ms": None,
    }


def _colliding_keys(rng, homes, per_home, bits):
    """Distinct packed keys whose first probe slot is ``homes[i]``, ``per_home[i]`` each."""
    import numpy as np

    mask = (1 << bits) - 1
    keys = []
    for home, k in zip(homes.tolist(), per_home.tolist()):
        for _ in range(k):
            hi = int(rng.integers(1, 1 << 32))
            upper = int(rng.integers(0, 1 << (32 - bits))) << bits
            lo = upper | ((home ^ ((hi * 0x9E3779B1) & 0xFFFFFFFF)) & mask)
            keys.append((hi << 32 | lo) - (1 << 64) if hi >= 1 << 31 else hi << 32 | lo)
    return np.asarray(keys, np.int64)


def _fused_checks_and_times(dev, rng, bits, B):
    """The fused fingerprint + dedup + insert kernel against its plain
    version (the three steps one after the other), then its time at the main
    path's batch for 4 and for 20 objects, beside the time of the three-step
    composition it replaces (eager fingerprint, sort dedup, insert kernel)."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.ops import hashset as hs_mod

    err = compared = 0
    for n_obj in (1, 4, 20):
        kern = hs_mod.init_hashset(bits, device=dev)
        ref = hs_mod.init_hashset(bits, device=dev)
        raced_home = torch.zeros(1 << bits, dtype=torch.bool, device=dev)
        pool = rng.integers(0, 47, size=(4 * B, n_obj, 2)).astype(np.int32)
        for rnd in range(6):
            # Draws with replacement: duplicates in the batch, and from the
            # second round on keys that are already in the table.
            states = torch.as_tensor(pool[rng.integers(0, len(pool), B)], device=dev)
            valid = torch.as_tensor(rng.random(B) < 0.9, device=dev)
            want_keys = hs_mod.fingerprint(states, 54)
            uniq = hs_mod.dedup_batch(want_keys, valid)
            check(int(uniq.sum()) < int(valid.sum()), "fused batch holds no duplicates")
            slot = hs_mod._first_slot(want_keys, bits)
            counts = torch.zeros(1 << bits, dtype=torch.int32, device=dev)
            counts.index_add_(0, slot[uniq], torch.ones_like(slot[uniq], dtype=torch.int32))
            raced_home |= counts > 1
            alone = ~raced_home[slot]
            k_k, n_k = hs_mod.fingerprint_dedup_insert(kern, states, 54, valid)
            k_r, n_r = hs_mod.fingerprint_dedup_insert_reference(ref, states, 54, valid)
            check(torch.equal(k_k, want_keys) and torch.equal(k_r, want_keys),
                  f"fused keys != fingerprint (N={n_obj}, round {rnd})")
            err = max(err, (n_k[alone].int() - n_r[alone].int()).abs().max().item())
            check(torch.equal(n_k[alone], n_r[alone]),
                  f"fused is_new differs on race-free lanes (N={n_obj}, round {rnd})")
            check(not (n_k & ~uniq).any(), "fused is_new set on a duplicate or invalid lane")
            compared += int(alone.sum())
            # No deletes and a sparse table: whichever way a raced cluster is
            # laid out, both tables hold every first occurrence exactly once.
            live_k, live_r = kern.keys[kern.keys != 0], ref.keys[ref.keys != 0]
            check(torch.equal(torch.sort(live_k).values, torch.sort(live_r).values),
                  f"fused membership differs (N={n_obj}, round {rnd})")

    out = {"max_abs_err": err, "lanes_compared": compared}
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    n_kern, n_plain = 51, 6  # warm-up call + reps
    for n_obj in (4, 20):
        fresh = torch.as_tensor(
            rng.integers(0, 47, size=(n_kern, B, n_obj, 2)).astype(np.int32), device=dev)
        check(len(torch.unique(hs_mod.fingerprint(fresh, 54))) == n_kern * B, "timing states repeat")

        def over_batches(fn, table):
            it = itertools.cycle(range(n_kern))  # a second trace (profile_device) meets keys again
            return lambda: fn(table, fresh[next(it)], 54, valid)

        def three_steps(table, states, width, valid):
            keys = hs_mod.fingerprint(states, width)
            return hs_mod.probe_and_insert(table, keys, hs_mod.dedup_batch(keys, valid))

        tables = [hs_mod.init_hashset(bits, device=dev) for _ in range(4)]
        out[f"n_obj_{n_obj}"] = {
            "ms": cuda_time_ms(over_batches(hs_mod.fingerprint_dedup_insert, tables[0]), reps=n_kern - 1),
            "device_ms": kernel_device_ms(
                profile_device(over_batches(hs_mod.fingerprint_dedup_insert, tables[3]), reps=n_kern),
                "fingerprint_dedup_insert_kernel", calls=n_kern),
            "three_step_composition_ms": cuda_time_ms(over_batches(three_steps, tables[1]), reps=n_kern - 1),
            "plain_ms": cuda_time_ms(
                over_batches(hs_mod.fingerprint_dedup_insert_reference, tables[2]), reps=n_plain - 1),
        }
    return out


PROBE_LOADS = (0.0, 0.5, 0.75)


def _probe_times_at_load(dev, rng, bits, B, load):
    """The insert and the delete kernels and their plain versions on a table
    of 2^bits slots filled to ``load`` by the plain version, a tenth of the
    filled keys deleted again: each kernel against its plain version on one
    batch (``is_new`` on the lanes whose windows no other lane meets, the
    table outside the windows of the others), then timed (events and
    profiler) on batches of B fresh keys to insert and, after them, of the
    same keys (now in the table) to delete."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.ops import hashset as hs_mod

    size, mask = 1 << bits, (1 << bits) - 1
    base = hs_mod.init_hashset(bits, device=dev)
    filled = torch.as_tensor(rng.integers(1, (1 << 63) - 1, size=int(load * size), dtype=np.int64), device=dev)
    hs_mod.probe_and_insert_reference(base, filled, torch.ones_like(filled, dtype=torch.bool))
    hs_mod.probe_delete_reference(base, filled, torch.as_tensor(rng.random(len(filled)) < 0.1, device=dev))
    words = base.keys
    row = {"load": load, "keys": int(((words != 0) & (words != -1)).sum()), "tombstones": int((words == -1).sum())}

    n_kern, n_plain = 51, 6  # warm-up call + reps
    batches = torch.as_tensor(rng.integers(1, (1 << 63) - 1, size=(n_kern + 1, B), dtype=np.int64), device=dev)
    check(len(torch.unique(torch.cat([batches.flatten(), filled]))) == batches.numel() + len(filled),
          "timing keys repeat")
    valid = torch.ones(B, dtype=torch.bool, device=dev)

    # One batch, kernel against plain version.
    keys = batches[n_kern]
    window = (hs_mod._first_slot(keys, bits)[:, None] + torch.arange(hs_mod.N_PROBES, device=dev)) & mask
    cover = torch.zeros(size, dtype=torch.int32, device=dev)
    cover.index_add_(0, window.flatten(), torch.ones(window.numel(), dtype=torch.int32, device=dev))
    alone = (cover[window] == 1).all(1)
    calm = torch.ones(size, dtype=torch.bool, device=dev)
    calm[window[~alone].flatten()] = False
    k_set = hs_mod.HashSet(keys=words.clone(), capacity_bits=bits)
    r_set = hs_mod.HashSet(keys=words.clone(), capacity_bits=bits)
    n_k, _ = hs_mod.probe_and_insert(k_set, keys, valid)
    n_r, _ = hs_mod.probe_and_insert_reference(r_set, keys, valid)
    row["insert_max_abs_err"] = abs_err(n_k[alone], n_r[alone])
    differ = int((k_set.keys != r_set.keys)[calm].sum())
    gone = valid & (torch.arange(B, device=dev) % 2 == 0)
    hs_mod.probe_delete(k_set, keys, gone)
    hs_mod.probe_delete_reference(r_set, keys, gone)
    row["table_slots_differing"] = differ + int((k_set.keys != r_set.keys)[calm].sum())
    row.update(lanes_compared=int(alone.sum()), new_lanes=int(n_k.sum()))

    def over_batches(fn, table):
        it = itertools.cycle(range(n_kern))  # a second trace (profile_device) meets keys again
        return lambda: fn(table, batches[next(it)], valid)

    t1, t2, t3 = (hs_mod.HashSet(keys=words.clone(), capacity_bits=bits) for _ in range(3))
    row["insert_ms"] = cuda_time_ms(over_batches(hs_mod.probe_and_insert, t1), reps=n_kern - 1)
    row["insert_plain_ms"] = cuda_time_ms(over_batches(hs_mod.probe_and_insert_reference, t2), reps=n_plain - 1)
    row["delete_ms"] = cuda_time_ms(over_batches(hs_mod.probe_delete, t1), reps=n_kern - 1)
    row["delete_plain_ms"] = cuda_time_ms(over_batches(hs_mod.probe_delete_reference, t2), reps=n_plain - 1)
    row["insert_device_ms"] = kernel_device_ms(
        profile_device(over_batches(hs_mod.probe_and_insert, t3), reps=n_kern), "probe_and_insert_kernel",
        calls=n_kern)
    row["delete_device_ms"] = kernel_device_ms(
        profile_device(over_batches(hs_mod.probe_delete, t3), reps=n_kern), "probe_delete_kernel", calls=n_kern)
    for t in (t1, t2, t3):
        check(not torch.isin(batches[:n_kern].flatten(), t.keys).any(), "timed deletes left keys behind")
    emit({"phase": "visited_set_load", **row})
    return row


def _fingerprint_checks_and_times(dev, rng, generated, floor):
    """The fingerprint kernel against the plain int64 fold on 1,024 states
    at N = 4, 19 and 100: random cells (negative and out-of-grid ones too)
    at each N, and the children of real searches at 4 (the 47 x 54 puzzle)
    and 19 (many_objects_text(19)); every key must be equal.  Times at 1,024
    states (the frontier-sharded search's routing of 4 * 256 children) and
    at 1 (a search's root), N = 4, beside the plain fold and the bound:
    8N bytes read and 8 written a state, or the launch floor."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import hashset as hs_mod

    searches = {4: generated, 19: Puzzle.from_text(many_objects_text(19))}
    compared = differing = 0
    by_n = {}
    for n_obj in (4, 19, 100):
        batches = [(torch.as_tensor(rng.integers(-2, 60, (1024, n_obj, 2)).astype(np.int32), device=dev), 54)]
        if n_obj in searches:
            _, _, found = _search_batches(searches[n_obj], 0, dev, batches=1, iters=2)
            batches.append((found[0][1], searches[n_obj].width))
        for states, width in batches:
            got = hs_mod.fingerprint(states, width)
            want = hs_mod.fingerprint_reference(states, width)
            torch.cuda.synchronize()
            compared += got.numel()
            differing += int((got != want).sum())
        x = batches[0][0]
        if n_obj == 4:
            x4 = x
        by_n[n_obj] = {"device_ms": kernel_device_ms(profile_device(lambda: hs_mod.fingerprint(x, 54), reps=50),
                                                     "fingerprint_kernel", calls=50),
                       **work_bound(x.shape[0] * (8 * n_obj + 8), 0, floor)}
    check(differing == 0, f"fingerprint: {differing} of {compared} keys differ from the fold")
    root = x4[:1]
    out = {"keys_compared": compared, "keys_differing": differing, "by_n": by_n,
           "ms": cuda_time_ms(lambda: hs_mod.fingerprint(x4, 54), reps=50),
           "plain_ms": cuda_time_ms(lambda: hs_mod.fingerprint_reference(x4, 54), reps=10),
           "root": {"ms": cuda_time_ms(lambda: hs_mod.fingerprint(root, 54), reps=50),
                    "device_ms": kernel_device_ms(profile_device(lambda: hs_mod.fingerprint(root, 54), reps=50),
                                                  "fingerprint_kernel", calls=50),
                    "plain_ms": cuda_time_ms(lambda: hs_mod.fingerprint_reference(root, 54), reps=10),
                    "plain_kernels": profile_device(lambda: hs_mod.fingerprint_reference(root, 54))["n_kernels"],
                    **work_bound(16 * 4 + 8, 0, floor)}}
    out["device_ms"] = by_n[4]["device_ms"]
    return out


def phase_visited_set(dev, floor, generated):
    """Insert/delete, fused and fingerprint kernels vs their plain versions;
    returns four kernels-line entries (times at load 0).  ``floor``:
    :func:`measure_launch_floor`'s result.  The insert's error is the largest
    ``is_new`` difference (0 or 1) on the compared lanes; the delete's is the
    number of keys by which the compared memberships differ after a round,
    or of table slots that differ at a load."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.ops import hashset as hs_mod

    bits, B = 21, 1024
    rng = np.random.default_rng(1)
    kern = hs_mod.init_hashset(bits, device=dev)
    ref = hs_mod.init_hashset(bits, device=dev)
    # Home slots 32 apart, fresh ones each round: a cluster (at most two
    # fresh keys per home, plus re-inserted keys) never reaches the next
    # home or exhausts the probes.
    pool = rng.choice(1 << (bits - 5), size=6 * B, replace=False) * 32
    inserted = set()  # keys inserted and not deleted since
    ever = set()  # every key ever offered for insertion
    # Home slots that two lanes of one round ever shared: the race can lay
    # the cluster out in either order, which changes later is_new on it.
    raced_home = torch.zeros(1 << bits, dtype=torch.bool, device=dev)
    checked = raced = 0
    ins_err = del_err = 0
    for rnd in range(6):
        old = np.asarray(sorted(inserted), np.int64)
        again = rng.choice(old, size=min(len(old), B // 4), replace=False)
        n_fresh = B - len(again)
        pairs = n_fresh // 4  # half of the fresh keys share their home slot with another
        per_home = np.concatenate([np.full(pairs, 2), np.ones(n_fresh - 2 * pairs, np.int64)])
        homes = pool[rnd * B: rnd * B + len(per_home)]
        keys_np = np.concatenate([_colliding_keys(rng, homes, per_home, bits), again])
        keys = torch.as_tensor(keys_np, device=dev)
        valid = torch.as_tensor(rng.random(B) < 0.95, device=dev)
        valid &= hs_mod.dedup_batch(keys, valid)
        slot = hs_mod._first_slot(keys, bits)
        counts = torch.zeros(1 << bits, dtype=torch.int32, device=dev)
        counts.index_add_(0, slot[valid], torch.ones_like(slot[valid], dtype=torch.int32))
        raced_home |= counts > 1
        alone = valid & ~raced_home[slot]
        n_k, _ = hs_mod.probe_and_insert(kern, keys, valid)
        n_r, _ = hs_mod.probe_and_insert_reference(ref, keys, valid)
        if alone.any():
            ins_err = max(ins_err, (n_k[alone].int() - n_r[alone].int()).abs().max().item())
        check(torch.equal(n_k[alone], n_r[alone]), f"is_new differs on race-free lanes (round {rnd})")
        checked += int(alone.sum())
        raced += int((valid & ~alone).sum())
        inserted |= set(keys_np[valid.cpu().numpy()].tolist())
        ever |= set(keys_np.tolist())
        dele = valid & torch.as_tensor(rng.random(B) < 0.3, device=dev)
        hs_mod.probe_delete(kern, keys, dele)
        hs_mod.probe_delete_reference(ref, keys, dele)
        inserted -= set(keys_np[dele.cpu().numpy()].tolist())
        live_k = kern.keys[(kern.keys != 0) & (kern.keys != -1)]
        live_r = ref.keys[(ref.keys != 0) & (ref.keys != -1)]
        # A key re-inserted behind a tombstone is stored twice and a delete
        # removes its first copy (the JAX semantics), so the live keys are a
        # superset of ``inserted``; every live word must be a whole key.
        # Where the layout depends on a race it may differ, and with it
        # whether such a copy survives, so membership is compared exactly on
        # the never-raced home slots and bounded on the others.
        live = set(live_k.cpu().tolist())
        check(inserted <= live <= ever, f"torn or lost keys (round {rnd})")
        calm_k = live_k[~raced_home[hs_mod._first_slot(live_k, bits)]]
        calm_r = live_r[~raced_home[hs_mod._first_slot(live_r, bits)]]
        del_err = max(del_err, len(set(calm_k.cpu().tolist()) ^ set(calm_r.cpu().tolist())))
        check(torch.equal(torch.sort(calm_k).values, torch.sort(calm_r).values),
              f"membership differs (round {rnd})")
        check(inserted <= set(live_r.cpu().tolist()) <= ever, f"plain version lost keys (round {rnd})")

    # Timing at the main path's batch, 4 * expand = 1024 keys, as the main
    # path runs it: every insert launch gets fresh keys and claims a slot for
    # each, and every delete launch removes keys that are in the table.  At
    # each load the table is filled first (by the plain version) and a tenth
    # of the filled keys deleted again, so tombstones lie on the probe paths.
    by_load = {load: _probe_times_at_load(dev, rng, bits, B, load) for load in PROBE_LOADS}
    at0 = by_load[0.0]
    ins_ms, ins_dev, ins_plain = at0["insert_ms"], at0["insert_device_ms"], at0["insert_plain_ms"]
    del_ms, del_dev, del_plain = at0["delete_ms"], at0["delete_device_ms"], at0["delete_plain_ms"]
    for load, row in by_load.items():
        check(row["insert_max_abs_err"] == 0 and row["table_slots_differing"] == 0,
              f"visited_set: the kernels differ from the plain versions at load {load}: {row}")
        ins_err = max(ins_err, row["insert_max_abs_err"])
        del_err = max(del_err, row["table_slots_differing"])
    fused = _fused_checks_and_times(dev, rng, bits, B)
    fp = _fingerprint_checks_and_times(dev, rng, generated, floor)
    emit({"phase": "visited_set", "table_slots": 1 << bits, "batch": B,
          "race_free_lanes_compared": checked, "raced_lanes": raced,
          "insert_max_abs_err": ins_err, "delete_max_abs_err": del_err,
          "insert_ms": ins_ms, "insert_device_ms": ins_dev, "insert_plain_ms": ins_plain,
          "delete_ms": del_ms, "delete_device_ms": del_dev, "delete_plain_ms": del_plain,
          "by_load": {str(k): v for k, v in by_load.items()}, "fused": fused, "fingerprint": fp,
          "launch_floor_device_ms": floor["device_ms"]})
    common = {"route": "cuda", "source": "pushworld_tpu_torch/kernels/visited_set.cu",
              "library_ms": None, "library_device_ms": None}

    def bound(lane_bytes):
        """The bytes a batch must move at the card's memory rate, or the
        empty kernel's device time where that is the larger: no kernel ends
        sooner than a launch."""
        bytes_ms = B * lane_bytes / H100_BYTES_PER_S * 1e3
        if bytes_ms >= floor["device_ms"]:
            return {"bound_ms": bytes_ms, "bound_by": "bytes", "bytes_bound_ms": bytes_ms}
        return {"bound_ms": floor["device_ms"], "bound_by": "launch", "bytes_bound_ms": bytes_ms}

    # Per lane the key (8 B), its flag (1 B), one table word read (8 B) and
    # one written (8 B), plus is_new (1 B) for the insert.  Fused: the state
    # (8N B) and its flag read, the key and is_new written, one table word
    # read and one written.
    return [
        dict(common, name="visited_set.probe_and_insert",
             replaces="pushworld_tpu/ops/hashset.py:106", ms=ins_ms, device_ms=ins_dev,
             plain_ms=ins_plain, max_abs_err=ins_err, **bound(26)),
        dict(common, name="visited_set.probe_delete",
             replaces="pushworld_tpu/ops/hashset.py:158", ms=del_ms, device_ms=del_dev,
             plain_ms=del_plain, max_abs_err=del_err, **bound(25)),
        dict(common, name="visited_set.fingerprint_dedup_insert",
             replaces="pushworld_tpu/ops/hashset.py:54,83,106",
             ms=fused["n_obj_4"]["ms"], device_ms=fused["n_obj_4"]["device_ms"],
             plain_ms=fused["n_obj_4"]["plain_ms"], max_abs_err=fused["max_abs_err"],
             **bound(8 * 4 + 26)),
        dict(common, name="visited_set.fingerprint", replaces="pushworld_tpu/ops/hashset.py:54",
             ms=fp["ms"], device_ms=fp["device_ms"], plain_ms=fp["plain_ms"],
             max_abs_err=float(fp["keys_differing"]), **bound(8 * 4 + 8)),
    ]


def _search_batches(puzzle, depth, dev, batches, iters=8, parents=256):
    """Batches of the main path's shape from a real search at the production
    capacities: ``iters`` eager iterations from the initial state, then, for
    each batch, ``parents`` live frontier entries (cycled where fewer) and
    their 4 * ``parents`` children as ``_iterate`` expands them, with the
    moved masks.  Returns (planner, search state, [(parents, children,
    moved)])."""
    import torch

    from pushworld_tpu_torch.ops.step import expand_children
    from pushworld_tpu_torch.search.batched import EMPTY, BatchedPlanner, _iterate
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    pl = BatchedPlanner(puzzle, max_depth=depth, device=dev, **PRODUCTION_CAPACITIES)
    s = pl.init_state()
    for _ in range(iters):
        _iterate(pl.cp_dev, pl.tables, pl.config, s)
    live = torch.nonzero(s.frontier_h < EMPTY).flatten()
    check(len(live) > 0, "the search left an empty frontier")
    out = []
    for k in range(batches):
        par = s.frontier_states[live[(torch.arange(parents, device=dev) + k * parents) % len(live)]]
        children = expand_children(pl.cp_dev, pl.tables.contacts, pl.tables.contacts_mask, par)
        out.append((par, children, (children != par.repeat(4, 1, 1)).any(-1)))
    return pl, s, out


def _rgd_work(t, batch, reached):
    """(bytes, operations) the RGD heuristic of a batch of ``batch`` states
    needs, each table entry it gathers read once: the positions and the
    outputs; per state, each goal's four moves (a feasibility byte, a
    distance-to-goal float) and its agent contacts (an int16 vertex id and
    an int32 distance each); and where ``reached`` (per state, the deepest
    pushing depth its goals take, from the plain version's depth-by-depth
    results) is 1 or more, the pushers' first moves and agent contacts and
    the contact rows of the push table, 26 bytes a contact (mask, offset,
    feasibility, vertex id, four distances): the goal's row at depth 1,
    every row from depth 2.  Operations: an add and a min for each term of
    the tables each depth up to ``reached`` needs (16 nr + ... + 16 nr^d
    terms a goal at depth d)."""
    n, nr = t.n, t.n_real
    ca = t.contacts_a_mask.cpu().numpy().sum(-1)  # (4, N): agent contacts of each pushee and move
    cm = t.contacts_mask.cpu().numpy().sum(-1)  # (4, pusher, pushee)
    goals = [o for o in range(1, t.max_goals + 1) if bool(t.goal_mask[o])]
    pushers = range(1, nr)
    row = {q: 26 * int(cm[:, 1:nr, q].sum()) for q in range(n)}
    per_goal = sum(4 * 5 + 6 * int(ca[:, o].sum()) + 4 for o in goals)
    by_depth = {0: 0, 1: 20 * nr + sum(6 * int(ca[:, q].sum()) for q in pushers) + sum(row[o] for o in goals)}
    by_depth[2] = by_depth[1] + sum(row[q] for q in pushers if q not in goals)
    ops = [0]
    for d in range(1, max(reached, default=0) + 1):
        ops.append(ops[-1] + 2 * len(goals) * sum(16 * nr ** k for k in range(1, d + 1)))
    n_bytes = batch * (8 * n + 5 + per_goal) + sum(by_depth[min(int(r), 2)] for r in reached)
    return n_bytes, sum(ops[int(r)] for r in reached)


def phase_rgd_novelty(generated, seed, dev, floor):
    """The RGD and novelty kernels against their plain versions at the main
    path's shapes, bit-equal (totals, flags, scores and both tables): 1,024
    children of real search states, and their 256 parents (the lazy mode's
    batch), on the 47 x 54 puzzle at depth 0, on three_tools and the
    generator's depth-3 candidate at depth 3 and on the four-tool chain at
    depth 4, and one iteration of each search as ``_iterate`` takes it (the
    children under their ``is_new`` mask, the selected parents under
    ``sel_valid``); the novelty kernel at pair_bits 24 on 4 batches of the
    47 x 54 search, from its own tables.  Times (events and profiler: all
    lanes valid, the iteration's own mask, and a closed gate, every lane
    invalid), plain ms and bounds; returns three kernels-line entries."""
    import dataclasses

    import numpy as np
    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import novelty, rgd

    def bound(n_bytes, n_ops):
        return work_bound(n_bytes, n_ops, floor)

    def rgd_device_ms(t, states, depth, valid=None):
        return kernel_device_ms(profile_device(lambda: rgd.rgd_heuristic_with_flags(t, states, depth, valid),
                                               reps=20), "rgd_kernel", calls=20)

    three = Puzzle.from_file(os.path.join(ROOT, "tests", "puzzles", "heur", "three_tools.pwp"))
    deep, candidate = depth3_candidate(seed)
    lanes = {}
    searches = {}
    for what, puzzle, depth in (("generated_47x54", generated, 0), ("three_tools", three, 3),
                                (f"generator seed {seed} candidate {deep}", candidate, 3),
                                ("four_tools", Puzzle.from_text(FOUR_TOOLS_TEXT), 4)):
        pl, s, batches = _search_batches(puzzle, depth, dev, batches=4 if depth == 0 else 1)
        searches[what] = (pl, s, batches)
        t = pl.tables
        _, it, parents = _iteration_inputs(pl, _open_state(pl))
        masked = [(it["children"], it["is_new"]), (parents, it["sel_valid"])]
        err = 0.0
        for states, valid in [(x, None) for par, children, _ in batches for x in (children, par)] + masked:
            total, flags = rgd.rgd_heuristic_with_flags(t, states, depth, valid)
            want, want_flags = rgd.rgd_heuristic_with_flags_reference(t, states, depth, valid)
            torch.cuda.synchronize()
            err = max(err, abs_err(total, want), abs_err(flags, want_flags))
            check(torch.equal(total, want) and torch.equal(flags, want_flags),
                  f"rgd ({what}): kernel != plain version")
        children = batches[0][1]
        deepest = max(0, min(depth, t.n_real - 2))
        reached = torch.full((children.shape[0],), deepest, dtype=torch.int32, device=dev)
        for d in reversed(range(deepest + 1)):
            finite = rgd.rgd_heuristic_with_flags_reference(t, children, d)[0] < 1e8
            reached = torch.where(finite, d, reached)
        n_bytes, n_ops = _rgd_work(t, children.shape[0], reached.cpu().numpy())
        none = torch.zeros((children.shape[0],), dtype=torch.bool, device=dev)
        lanes[what] = dict(
            depth=depth, batch=children.shape[0], max_abs_err=err, finite=int(finite.sum()),
            reached_depth={d: int((reached == d).sum()) for d in range(depth + 1)},
            ms=cuda_time_ms(lambda: rgd.rgd_heuristic_with_flags(t, children, depth), reps=50),
            device_ms=rgd_device_ms(t, children, depth),
            iteration_mask={"gate": bool(it["gate"]), "new_children": int(it["is_new"].sum()),
                            "device_ms": rgd_device_ms(t, it["children"], depth, it["is_new"]),
                            "lazy_parents": int(it["sel_valid"].sum()),
                            "lazy_device_ms": rgd_device_ms(t, parents, depth, it["sel_valid"])},
            closed_gate_device_ms=rgd_device_ms(t, children, depth, none),
            plain_ms=cuda_time_ms(lambda: rgd.rgd_heuristic_with_flags_reference(t, children, depth), reps=3),
            bytes=n_bytes, operations=n_ops, **bound(n_bytes, n_ops))

    # Novelty at pair_bits 24 from the 47 x 54 search's own tables.
    pl, s, batches = searches["generated_47x54"]
    kern, ref = (dataclasses.replace(s.novelty, seen_pos=s.novelty.seen_pos.clone(),
                                     pair_table=s.novelty.pair_table.clone()) for _ in range(2))
    check(kern.pair_bits == 24, f"the search's pair table has {kern.pair_bits} bits, not 24")
    rng = np.random.default_rng(seed)
    scores, nov_err = {}, 0.0
    score_bytes = absorb_bytes = 0
    for _, children, moved in batches:
        valid = moved.any(-1) & torch.as_tensor(rng.random(children.shape[0]) < 0.9, device=dev)
        got, _ = novelty.novelty_score_and_update(kern, children, moved, valid)
        want, _ = novelty.novelty_score_and_update_reference(ref, children, moved, valid)
        torch.cuda.synchronize()
        nov_err = max(nov_err, abs_err(got, want))
        check(torch.equal(got, want), "novelty: scores != plain version")
        check(torch.equal(kern.seen_pos, ref.seen_pos), "novelty: seen_pos != plain version")
        check(torch.equal(kern.pair_table.view(torch.int16), ref.pair_table.view(torch.int16)),
              "novelty: pair table != plain version")
        for v in want.tolist():
            scores[v] = scores.get(v, 0) + 1
        sb, ab = _novelty_bytes(children, moved, valid, want, kern)
        score_bytes, absorb_bytes = max(score_bytes, sb), max(absorb_bytes, ab)
    # A closed gate (every lane invalid): the fill, and the tables untouched.
    _, children, moved = batches[0]
    none = torch.zeros((children.shape[0],), dtype=torch.bool, device=dev)
    before = (kern.seen_pos.clone(), kern.pair_table.clone())
    got, _ = novelty.novelty_score_and_update(kern, children, moved, none)
    torch.cuda.synchronize()
    check(bool((got == 3.0).all()) and torch.equal(kern.seen_pos, before[0])
          and torch.equal(kern.pair_table.view(torch.int16), before[1].view(torch.int16)),
          "novelty: a closed gate changed the tables or scored a lane")
    valid = moved.any(-1)
    # Device time by kernel from the public call, all lanes valid and at a
    # closed gate; each kernel's event time from its launch alone, on the
    # tables as the search leaves them.
    prof = {gate: profile_device(lambda v=v: novelty.novelty_score_and_update(kern, children, moved, v), reps=20)
            for gate, v in (("open", valid), ("closed", none))}
    args = novelty._checked(kern, children, moved, valid)
    out = torch.empty((children.shape[0],), dtype=torch.float32, device=dev)
    record = torch.empty((*moved.shape, 2), dtype=torch.int32, device=dev)
    nov = {}
    for name, launch in novelty._launches(kern, *args, out, record).items():
        kernel = name.replace(".", "_") + "_kernel"
        nov[name] = {"ms": cuda_time_ms(launch, reps=50),
                     "device_ms": kernel_device_ms(prof["open"], kernel, calls=20),
                     "closed_gate_device_ms": kernel_device_ms(prof["closed"], kernel, calls=20)}
    plain_ms = cuda_time_ms(lambda: novelty.novelty_score_and_update_reference(ref, children, moved, valid), reps=5)
    emit({"phase": "rgd_novelty", "rgd": lanes,
          "novelty": {"pair_bits": 24, "batches": len(batches), "batch": children.shape[0], "scores": scores,
                      "max_abs_err": nov_err, "plain_ms_score_and_absorb": plain_ms,
                      "score_bytes": score_bytes, "absorb_bytes": absorb_bytes, **nov}})
    main = lanes["generated_47x54"]
    common = {"route": "cuda", "library_ms": None, "library_device_ms": None}
    return [
        dict(common, name="rgd.heuristic", source="pushworld_tpu_torch/kernels/rgd.cu",
             replaces="pushworld_tpu/ops/rgd.py:526", lanes=lanes,
             max_abs_err=max(lane["max_abs_err"] for lane in lanes.values()),
             **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes_bound_ms",
                                     "closed_gate_device_ms")}),
        dict(common, name="novelty.score", source="pushworld_tpu_torch/kernels/novelty.cu",
             replaces="pushworld_tpu/ops/novelty.py:106", max_abs_err=nov_err, plain_ms=plain_ms,
             **nov["novelty.score"], **bound(score_bytes, 0)),
        dict(common, name="novelty.absorb", source="pushworld_tpu_torch/kernels/novelty.cu",
             replaces="pushworld_tpu/ops/novelty.py:106", max_abs_err=nov_err, plain_ms=plain_ms,
             **nov["novelty.absorb"], **bound(absorb_bytes, 0)),
    ]


def _novelty_bytes(states, moved, valid, scores, t):
    """(score bytes, absorb bytes) one batch needs, each entry read or
    written once: the positions, masks and scores; for each valid state its
    moved objects' seen_pos bytes, and, where no moved object is at an
    unseen cell (score 2 or 3), the distinct pair-table cells (2 bytes) of
    its (moved bucket, other bucket) pairs; the update writes the moved
    objects' seen_pos bytes and the distinct cells of every valid state's
    pairs, both orders."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.ops.novelty import _atom_hash

    B, n = moved.shape
    cell = (states[..., 1].long() * t.width + states[..., 0].long()).clamp(0, t.height * t.width - 1)
    h = _atom_hash(torch.arange(n, device=states.device)[None, :], cell, t.side).cpu().numpy()
    mv, ok, sc = moved.cpu().numpy(), valid.cpu().numpy(), scores.cpu().numpy()
    read, written = set(), set()
    for b in np.nonzero(ok)[0]:
        X, Y = set(h[b][mv[b]].tolist()), set(h[b].tolist())
        pairs = {(k, l) for l in X for k in Y}
        if sc[b] != 1.0:
            read |= {(k, l) for k, l in pairs if k != l}
        written |= pairs | {(l, k) for k, l in pairs}
    io = B * (8 * n + n + 1)
    n_moved = int((mv & ok[:, None]).sum())
    return io + 4 * B + n_moved + 2 * len(read), io + n_moved + 2 * len(written)


def _clone_state(s):
    """A copy of a search state on its device (tables and visited set too)."""
    import dataclasses

    from pushworld_tpu_torch.ops.hashset import HashSet

    out = dataclasses.replace(s, graph=None, **{k: v.clone() for k, v in vars(s).items()
                                               if k != "graph" and hasattr(v, "clone")})
    out.visited = HashSet(keys=s.visited.keys.clone(), capacity_bits=s.visited.capacity_bits)
    out.novelty = dataclasses.replace(s.novelty, seen_pos=s.novelty.seen_pos.clone(),
                                      pair_table=s.novelty.pair_table.clone())
    return out


def abs_err(x, y) -> float:
    """The largest |x - y| of two tensors of one shape, bools and integers
    compared as int64: 0 when the two are bit-equal in value (equal
    infinities, NaN beside NaN), inf when the shapes differ or where a NaN
    stands beside a number, so that a NaN cannot read as error 0."""
    import torch

    if x.shape != y.shape:
        return float("inf")
    if not x.numel():
        return 0.0
    if not x.is_floating_point():
        return float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
    x, y = x.double(), y.double()
    if not torch.equal(x.isnan(), y.isnan()):
        return float("inf")
    same = (x == y) | x.isnan()
    return float(torch.where(same, 0.0, (x - y).abs()).max())


def _max_abs_err(pairs) -> float:
    """:func:`abs_err` over pairs of tensors, the largest."""
    return max((abs_err(x, y) for x, y in pairs), default=0.0)


def _state_error(a, b) -> float:
    """:func:`_max_abs_err` over every tensor of two search states, the
    visited set and the novelty tables included."""
    import torch

    pairs = [(v, getattr(b, k)) for k, v in vars(a).items() if isinstance(v, torch.Tensor)]
    pairs += [(a.visited.keys, b.visited.keys), (a.novelty.seen_pos, b.novelty.seen_pos),
              (a.novelty.pair_table.view(torch.int16), b.novelty.pair_table.view(torch.int16))]
    return _max_abs_err(pairs)


def _reset_timed(fn, reset, reps: int) -> float:
    """Mean milliseconds of ``fn`` alone (CUDA events around each call),
    with ``reset()`` enqueued before each call outside the events."""
    import torch

    reset()
    fn()
    pairs = []
    for _ in range(reps):
        reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _open_state(pl, iters=8):
    """The planner's search state after up to ``iters`` iterations from the
    start, its gate still open after them (a copy of the state before the
    iteration that would close it)."""
    from pushworld_tpu_torch.search import batched

    s = pl.init_state()
    for _ in range(iters):
        nxt = _clone_state(s)
        batched._iterate(pl.cp_dev, pl.tables, pl.config, nxt)
        if not bool(batched._active(pl.config, nxt)):
            break
        s = nxt
    return s


def _iteration_inputs(pl, s):
    """One iteration's steps on a copy of ``s`` with the kernels, as
    ``_iterate`` takes them: the selection, the expansion, the dedup and the
    scores.  Returns (copy, dict of the append's inputs, gate, parents)."""
    from pushworld_tpu_torch.ops.hashset import fingerprint_dedup_insert
    from pushworld_tpu_torch.ops.novelty import novelty_score_and_update
    from pushworld_tpu_torch.ops.rgd import rgd_heuristic_with_flags
    from pushworld_tpu_torch.ops.step import expand_and_test
    from pushworld_tpu_torch.search.batched import select_and_gate

    cfg, t, cp = pl.config, pl.tables, pl.cp_dev
    w = _clone_state(s)
    parents, parent_hist, sel_valid, gate = select_and_gate(cfg, w)
    children, moved, effective, goal = expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)
    keys, is_new = fingerprint_dedup_insert(w.visited, children, cp.width, effective, gate)
    nov, _ = novelty_score_and_update(w.novelty, children, moved, is_new)
    rgd, deeper = rgd_heuristic_with_flags(t, children, max_depth=cfg.max_depth, valid=is_new)
    args = dict(gate=gate, is_new=is_new, parent_hist=parent_hist, actions=None, goal=goal, nov=nov, rgd=rgd,
                deeper=deeper, sel_valid=sel_valid, children=children, keys=keys)
    return w, args, parents


def _compact_append_error(pl, s, args) -> dict:
    """The compaction and then the append on two copies of ``s``, kernels
    against plain versions: the largest error over the state after each
    (and hist_idx), the visited table's error after the compaction (the
    kernel deletes its drops itself, the plain version through
    probe_delete), the evictions and the fingerprints it deleted."""
    import torch

    from pushworld_tpu_torch.search import batched

    nb = args["children"].shape[0]
    k, r = _clone_state(s), _clone_state(s)
    before = int(s.evictions)
    batched.compact_frontier(k, nb, args["gate"])
    batched.compact_frontier_reference(r, nb, args["gate"])
    torch.cuda.synchronize()
    compact_err = _state_error(k, r)
    table_err = abs_err(k.visited.keys, r.visited.keys)
    deleted = int(((s.visited.keys != -1) & (k.visited.keys == -1)).sum())
    compacted = int(k.ring_cursor) != int(s.ring_cursor)  # a compaction leaves it at min(live, keep) < F - nb
    got = batched.append_children(k, pl.config, **args)
    want = batched.append_children_reference(r, pl.config, **args)
    torch.cuda.synchronize()
    return {"compact_max_abs_err": compact_err, "visited_table_max_abs_err": table_err,
            "append_max_abs_err": max(_state_error(k, r), _max_abs_err([(got, want)])),
            "evicted": int(k.evictions) - before, "keys_deleted": deleted, "compacted": compacted}


def phase_iteration_kernels(generated, dev, floor):
    """The search iteration's kernels of slice 9 (expand, select, compact,
    append; the RGD kernel with its valid mask) against their plain
    versions on real searches at production capacities, error 0: the 47 x 54
    puzzle at depth 0 and three_tools at depth 3 after 8 iterations (an
    idle compaction, and one forced by a cursor within a window of the end),
    the 47 x 54 search with the least frontier (2,048 slots) caught at a
    compaction that evicts, and a closed gate (a solved search: every kernel
    a no-op, the state bit-unchanged).  Times (events and profiler), plain
    ms, library ms (``torch.topk`` for the select, a stable ``torch.sort``
    for the compaction) and bounds at the 47 x 54 shapes; returns four
    kernels-line entries."""
    import dataclasses

    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd, step
    from pushworld_tpu_torch.search import batched
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    t_phase = time.monotonic()

    def bound(n_bytes):
        ms = n_bytes / H100_BYTES_PER_S * 1e3
        b = {"bound_ms": ms, "bound_by": "bytes", "bytes_bound_ms": ms, "bytes": n_bytes}
        if floor["device_ms"] > ms:
            b.update(bound_ms=floor["device_ms"], bound_by="launch")
        return b

    three = Puzzle.from_file(os.path.join(ROOT, "tests", "puzzles", "heur", "three_tools.pwp"))
    lanes, timing = {}, {}
    for what, puzzle, depth in (("generated_47x54", generated, 0), ("three_tools", three, 3)):
        pl = batched.BatchedPlanner(puzzle, max_depth=depth, device=dev, **PRODUCTION_CAPACITIES)
        cfg, t, cp = pl.config, pl.tables, pl.cp_dev
        B, F = cfg.expand, pl.frontier_capacity
        s = _open_state(pl)
        row = {"depth": depth, "iterations": int(s.iterations), "live": int((s.frontier_h < batched.EMPTY).sum()), "ring_cursor": int(s.ring_cursor)}
        # select: the gate and the selection.
        k, r = _clone_state(s), _clone_state(s)
        got = batched.select_and_gate(cfg, k)
        active = batched._active(cfg, r)
        want = (*batched.select_frontier_reference(r, B, active), active)
        torch.cuda.synchronize()
        row["select_max_abs_err"] = max(_max_abs_err(zip(got, want)), _state_error(k, r))
        # expand, on the selected parents.
        parents, _, sel_valid, gate = got
        e_got = step.expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)
        e_want = step.expand_and_test_reference(cp, t.contacts, t.contacts_mask, parents, sel_valid)
        torch.cuda.synchronize()
        row["expand_max_abs_err"] = _max_abs_err(zip(e_got, e_want))
        # the RGD kernel with the is_new mask, and the append after an idle
        # and after a forced compaction.
        w, args, _ = _iteration_inputs(pl, s)
        masked = rgd.rgd_heuristic_with_flags(t, args["children"], depth, args["is_new"])
        want = rgd.rgd_heuristic_with_flags_reference(t, args["children"], depth, args["is_new"])
        torch.cuda.synchronize()
        row["rgd_masked_max_abs_err"] = _max_abs_err(zip(masked, want))
        row["new_children"] = int(args["is_new"].sum())
        row["idle_compaction"] = _compact_append_error(pl, w, args)
        forced = _clone_state(w)
        forced.ring_cursor.fill_(F - 4 * B + 1)
        row["forced_compaction"] = _compact_append_error(pl, forced, args)
        check(row["forced_compaction"]["compacted"], f"iteration_kernels ({what}): the forced compaction did not run")
        for key in ("select_max_abs_err", "expand_max_abs_err", "rgd_masked_max_abs_err"):
            check(row[key] == 0, f"iteration_kernels ({what}): {key} is {row[key]}")
        for key in ("idle_compaction", "forced_compaction"):
            check(row[key]["compact_max_abs_err"] == row[key]["append_max_abs_err"] == 0,
                  f"iteration_kernels ({what}): {key}: kernels != plain versions: {row[key]}")
        # the masked RGD kernel's device time beside the unmasked one.
        row["rgd_device_ms"] = {
            "masked": kernel_device_ms(profile_device(
                lambda: rgd.rgd_heuristic_with_flags(t, args["children"], depth, args["is_new"]), reps=20),
                "rgd_kernel", calls=20),
            "unmasked": kernel_device_ms(profile_device(
                lambda: rgd.rgd_heuristic_with_flags(t, args["children"], depth), reps=20), "rgd_kernel", calls=20)}
        lanes[what] = row
        if what == "generated_47x54":
            timing = dict(pl=pl, s=s, w=w, args=args, parents=parents, sel_valid=sel_valid, gate=gate)

    # The select at twice the production frontier (F = 2^16: tiles of 8,192
    # slots), on the 47 x 54 search after up to 8 iterations.
    pl = batched.BatchedPlanner(generated, max_depth=0, device=dev,
                                **dict(PRODUCTION_CAPACITIES, frontier_capacity=1 << 16))
    s = _open_state(pl)
    k, r = _clone_state(s), _clone_state(s)
    got = batched.select_and_gate(pl.config, k)
    active = batched._active(pl.config, r)
    want = (*batched.select_frontier_reference(r, pl.config.expand, active), active)
    torch.cuda.synchronize()
    wide = {"frontier": pl.frontier_capacity, "iterations": int(s.iterations),
            "live": int((s.frontier_h < batched.EMPTY).sum()),
            "select_max_abs_err": max(_max_abs_err(zip(got, want)), _state_error(k, r))}
    check(wide["select_max_abs_err"] == 0, f"iteration_kernels: the select at F = 2^16: {wide}")

    # A compaction that evicts: the 47 x 54 search with the least frontier,
    # caught before the iteration whose compaction drops live entries.
    pl = batched.BatchedPlanner(generated, max_depth=0, device=dev,
                                **dict(PRODUCTION_CAPACITIES, frontier_capacity=8 * PRODUCTION_CAPACITIES["expand"]))
    cfg = pl.config
    s = pl.init_state()
    F, nb = pl.frontier_capacity, 4 * cfg.expand
    evicting = None
    for it in range(64):
        live = int((s.frontier_h < batched.EMPTY).sum())
        if int(s.ring_cursor) + nb > F and live - cfg.expand > F - max(nb, F // 4):
            evicting = {"iteration": it, "live": live}
            break
        batched._iterate(pl.cp_dev, pl.tables, cfg, s)
    check(evicting is not None, "iteration_kernels: no evicting compaction in 64 iterations")
    w, args, _ = _iteration_inputs(pl, s)
    evicting.update(_compact_append_error(pl, w, args))
    check(evicting["compact_max_abs_err"] == evicting["append_max_abs_err"] == 0 and evicting["evicted"] > 0
          and evicting["visited_table_max_abs_err"] == 0 and evicting["keys_deleted"] > 0,
          f"iteration_kernels: the evicting compaction: {evicting}")
    # Its device time, the deletes included (one launch), each call on the
    # state before it.
    ek = _clone_state(w)
    saved_e = {f: getattr(w, f).clone() for f in ("frontier_h", "frontier_states", "frontier_hist", "frontier_key",
                                                  "ring_cursor", "evictions")}

    def reset_evicting():
        for f, v in saved_e.items():
            getattr(ek, f).copy_(v)
        ek.visited.keys.copy_(w.visited.keys)

    evicting["device_ms"] = kernel_device_ms(profile_device(
        lambda: (reset_evicting(), batched.compact_frontier(ek, nb, args["gate"])), reps=10),
        "compact_kernel", calls=10)

    # A closed gate: every kernel of _iterate on a solved search.
    pl, s = timing["pl"], timing["s"]
    cfg, t, cp = pl.config, pl.tables, pl.cp_dev
    closed = dataclasses.replace(_clone_state(s), solved=torch.ones((), dtype=torch.bool, device=dev))
    snap = _clone_state(closed)
    batched._iterate(cp, t, cfg, closed)
    torch.cuda.synchronize()
    gated = {"iterate_max_abs_err": _state_error(closed, snap)}
    parents, _, sel_valid, gate = batched.select_and_gate(cfg, closed)
    _, _, effective, goal = step.expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)
    torch.cuda.synchronize()
    gated.update(gate=bool(gate), selected=int(sel_valid.sum()), effective=int(effective.sum()),
                 goals=int(goal.sum()))
    gated["select_and_expand_max_abs_err"] = _state_error(closed, snap)
    prof = profile_device(lambda: batched._iterate(cp, t, cfg, closed), reps=20)
    by_kernel = {}  # name: [launches an iteration, device ms an iteration]
    for k, (count, us) in prof["by_kernel"].items():
        launches_ms = by_kernel.setdefault(_kernel_name(k), [0.0, 0.0])
        launches_ms[0] += count / 20
        launches_ms[1] += us / 1e3 / 20
    from pushworld_tpu_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    batched._iterate(cp, t, cfg, closed)
    hand = {k: n - before.get(k, 0) for k, n in LAUNCHES.items() if n != before.get(k, 0)}
    check(hand == {k: 1 for k in ITERATION_KERNELS},
          f"iteration_kernels: a closed-gate iteration is not the {len(ITERATION_KERNELS)} launches: {hand}")
    gated.update(device_ms_per_iter=prof["busy_us"] / 1e3 / 20, kernels_per_iter=prof["n_kernels"] / 20,
                 hand_kernel_launches_per_iter=sum(hand.values()), device_ms_by_kernel=by_kernel)
    check(gated["iterate_max_abs_err"] == 0 and gated["select_and_expand_max_abs_err"] == 0
          and not gated["gate"] and gated["selected"] == gated["effective"] == gated["goals"] == 0,
          f"iteration_kernels: a closed gate is no no-op: {gated}")

    # Times at the 47 x 54 shapes (B = 256, F = 2^15, 1,024 children).
    w, args, parents, sel_valid, gate = (timing[k] for k in ("w", "args", "parents", "sel_valid", "gate"))
    B, F, N = cfg.expand, pl.frontier_capacity, cp.n
    nb = 4 * B
    h0 = s.frontier_h.clone()
    sel_k, sel_r = _clone_state(s), _clone_state(s)
    shut = torch.zeros((), dtype=torch.bool, device=dev)  # a closed gate

    def reset_select(x):
        return lambda: x.frontier_h.copy_(h0)

    kernels = {}
    kernels["frontier.select"] = dict(
        ms=_reset_timed(lambda: batched.select_and_gate(cfg, sel_k), reset_select(sel_k), 50),
        device_ms=kernel_device_ms(profile_device(lambda: (reset_select(sel_k)(), batched.select_and_gate(cfg, sel_k)),
                                                  reps=20), "select_kernel", calls=20),
        plain_ms=_reset_timed(lambda: batched.select_frontier_reference(sel_r, B, batched._active(cfg, sel_r)),
                              reset_select(sel_r), 5),
        library_ms=cuda_time_ms(lambda: torch.topk(h0, B, largest=False), reps=50),
        library_device_ms=library_device_ms(lambda: torch.topk(h0, B, largest=False)),
        **bound(4 * F + B * (2 * (8 * N + 4) + 1) + 4 * B))
    kernels["step.expand"] = dict(
        ms=cuda_time_ms(lambda: step.expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate),
                        reps=50),
        device_ms=kernel_device_ms(profile_device(
            lambda: step.expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate), reps=20),
            "expand_kernel", calls=20),
        plain_ms=cuda_time_ms(lambda: step.expand_and_test_reference(cp, t.contacts, t.contacts_mask, parents,
                                                                     sel_valid), reps=5),
        closed_gate_device_ms=kernel_device_ms(profile_device(
            lambda: step.expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, shut), reps=20),
            "expand_kernel", calls=20),
        library_ms=None,
        library_device_ms=None,
        **bound(B * (8 * N + 1) + 4 * N * N * t.cmax * 5 + nb * N + 4 * N * 10 + nb * (9 * N + 2)))
    saved = {f: getattr(w, f).clone() for f in ("frontier_h", "frontier_states", "frontier_hist", "frontier_key")}
    comp_k, comp_r = _clone_state(w), _clone_state(w)

    def reset_compact(x):
        def reset():
            for f, v in saved.items():
                getattr(x, f).copy_(v)
            x.ring_cursor.fill_(F - nb + 1)
        return reset

    kernels["frontier.compact"] = dict(
        ms=_reset_timed(lambda: batched.compact_frontier(comp_k, nb, gate), reset_compact(comp_k), 20),
        device_ms=kernel_device_ms(profile_device(
            lambda: (reset_compact(comp_k)(), batched.compact_frontier(comp_k, nb, gate)), reps=10),
            "compact_kernel", calls=10),
        plain_ms=_reset_timed(lambda: batched.compact_frontier_reference(comp_r, nb, gate), reset_compact(comp_r), 5),
        library_ms=cuda_time_ms(lambda: torch.sort(saved["frontier_h"], stable=True), reps=50),
        library_device_ms=library_device_ms(lambda: torch.sort(saved["frontier_h"], stable=True)),
        idle_device_ms=kernel_device_ms(profile_device(lambda: batched.compact_frontier(comp_k, nb, gate), reps=20),
                                        "compact_kernel", calls=20),
        **bound(2 * F * (4 + 8 * N + 4 + 8) + F + 1))
    app_k, app_r = _clone_state(w), _clone_state(w)
    scalars = {f: getattr(w, f).clone() for f in ("ring_cursor", "hist_cursor", "solved", "solved_hist",
                                                  "iterations", "expansions", "needs_deeper")}

    def reset_append(x):
        def reset():
            for f, v in scalars.items():
                getattr(x, f).copy_(v)
        return reset

    n_new = int(args["is_new"].sum())
    kernels["frontier.append"] = dict(
        ms=_reset_timed(lambda: batched.append_children(app_k, cfg, **args), reset_append(app_k), 50),
        device_ms=kernel_device_ms(profile_device(
            lambda: (reset_append(app_k)(), batched.append_children(app_k, cfg, **args)), reps=20),
            "append_kernel", calls=20),
        plain_ms=_reset_timed(lambda: batched.append_children_reference(app_r, cfg, **args), reset_append(app_r), 5),
        closed_gate_device_ms=kernel_device_ms(profile_device(
            lambda: batched.append_children(app_k, cfg, **dict(args, gate=shut)), reps=20), "append_kernel", calls=20),
        library_ms=None,
        library_device_ms=None,
        **bound(nb * (1 + 1 + 4 + 4 + 1 + 8 * N + 8) + B * 5 + 8 * n_new + nb * (4 + 8 * N + 4 + 8 + 4) + 32))
    emit({"phase": "iteration_kernels", "lanes": lanes, "select_at_2_16": wide, "evicting_compaction": evicting,
          "closed_gate": gated,
          "kernels": kernels, "total_s": time.monotonic() - t_phase})
    source = {"step.expand": "pushworld_tpu_torch/kernels/expand.cu"}
    replaces = {"step.expand": "pushworld_tpu/ops/step.py:131",
                "frontier.select": "pushworld_tpu/search/batched.py:520",
                "frontier.compact": "pushworld_tpu/search/batched.py:457",
                "frontier.append": "pushworld_tpu/search/batched.py:439"}
    rows = [*lanes.values(), {"forced_compaction": evicting}]
    errors = {"frontier.select": [r["select_max_abs_err"] for r in lanes.values()],
              "step.expand": [r["expand_max_abs_err"] for r in lanes.values()],
              "frontier.compact": [r[k]["compact_max_abs_err"] for r in rows for k in r if k.endswith("compaction")],
              "frontier.append": [r[k]["append_max_abs_err"] for r in rows for k in r if k.endswith("compaction")]}
    errors["frontier.select"] += [gated["select_and_expand_max_abs_err"], wide["select_max_abs_err"]]
    errors["frontier.compact"].append(gated["iterate_max_abs_err"])
    errors["frontier.append"].append(gated["iterate_max_abs_err"])
    return [dict(name=name, route="cuda", source=source.get(name, "pushworld_tpu_torch/kernels/frontier.cu"),
                 replaces=replaces[name], max_abs_err=max(errors[name]), **row) for name, row in kernels.items()]


def phase_solve(puzzles, generated, dev):
    """The main path: solve_puzzle on the card for every puzzle.  Returns the
    launches, each puzzle's classification and each puzzle's plan."""
    import torch

    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES, solve_puzzle

    LAUNCHES.clear()
    t0 = time.monotonic()
    rows, plans = [], {}
    for name, p in puzzles + [("generated_47x54", generated)]:
        t = time.monotonic()
        r = solve_puzzle(p, mode="N+RGD", time_limit=60, device=dev, **PRODUCTION_CAPACITIES)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        plans[name] = r.plan
        row = {"puzzle": name, "result": r.failure_reason or "solved",
               "plan_len": None if r.plan is None else len(r.plan),
               "wall_s": wall, "expansions": r.expansions}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        if name in UNSOLVABLE:
            check(r.failure_reason == "no solution", f"{name}: {r.failure_reason}")
        else:
            check(r.failure_reason is None and p.is_valid_plan(r.plan), f"{name}: {r}")
    launches = dict(LAUNCHES)
    total = time.monotonic() - t0
    for k in MAIN_PATH_KERNELS:
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the main path")
    for k in OFF_MAIN_PATH:
        check(launches.get(k, 0) == 0, f"kernel {k} was launched on the main path")
    gen = rows[-1]
    # A search's start (after the main path's counts were read): the kernels
    # of init_state on the 47 x 54 puzzle (its root's key from the
    # fingerprint kernel, one launch), and of the root's fingerprint by
    # object count, the kernel's beside the plain int64 fold's.
    from pushworld_tpu_torch.ops.hashset import fingerprint, fingerprint_reference
    from pushworld_tpu_torch.search.batched import BatchedPlanner

    pl = BatchedPlanner(generated, max_depth=0, device=dev, **PRODUCTION_CAPACITIES)
    before = LAUNCHES["visited_set.fingerprint"]
    pl.init_state()
    check(LAUNCHES["visited_set.fingerprint"] == before + 1, "init_state did not launch the fingerprint kernel")

    def root_kernels(fn, n):
        return profile_device(lambda: fn(torch.zeros((1, n, 2), dtype=torch.int32, device=dev),
                                         generated.width))["n_kernels"]

    start = {"objects": pl.cp_dev.n, "init_state_kernels": profile_device(pl.init_state)["n_kernels"],
             "root_fingerprint_kernels": {n: root_kernels(fingerprint, n) for n in (4, 19, 100)},
             "root_fingerprint_plain_kernels": {n: root_kernels(fingerprint_reference, n) for n in (4, 19)}}
    emit({"phase": "solve", "puzzles": len(rows), "total_s": total,
          "solved": sum(r["result"] == "solved" for r in rows),
          "no_solution": sum(r["result"] == "no solution" for r in rows),
          "generated": gen, "launches": launches, "search_start": start, "per_puzzle": rows})
    return launches, {r["puzzle"]: r["result"] for r in rows}, plans


WIDE_OBJECTS = (33, 64, 100)


def _wide_kernel_lanes(n, dev, floor, rng):
    """The kernels at ``n`` objects (the wide paths above 32, the one-word
    paths at 32) against their plain versions, error 0: the expansion, the
    novelty score and update (the search's own pair bits 24 tables) and the
    fingerprint on a real search's batch (256 parents of many_objects_text(n)
    after two iterations at the production capacities, their 1,024
    children); RGD on those children at depth 0 and on walk states of the
    four-tool chain widened to n movables, whose goal needs depth 4, so most
    states run the deep tables: 64 at depths 1 and 2, 16 at depth 3 (at 33),
    1,024 at depth 1 (at 64 and 100, the scratch path with more states than
    CTAs).  Device time, plain time, bound and path of each."""
    import dataclasses

    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import hashset, novelty, rgd, step

    wide = "_wide" if n > step.EXPAND_MAX_OBJECTS else ""
    names = {"expand": f"expand{wide}_kernel", "rgd": f"rgd{wide}_kernel",
             "novelty.score": f"novelty_score{wide}_kernel", "novelty.absorb": f"novelty_absorb{wide}_kernel"}
    p = Puzzle.from_text(many_objects_text(n))
    pl, s, batches = _search_batches(p, 0, dev, batches=2, iters=2)
    par, children, moved = batches[0]
    cp, t = pl.cp_dev, pl.tables
    B, C = par.shape[0], t.contacts.shape[3]
    out = {}

    # The expansion of the search's parents, a tenth of them not selected.
    sel = torch.as_tensor(rng.random(B) < 0.9, device=dev)
    args = (cp, t.contacts, t.contacts_mask, par, sel)
    got, want = step.expand_and_test(*args), step.expand_and_test_reference(*args)
    torch.cuda.synchronize()
    err = max(abs_err(g, w) for g, w in zip(got, want))
    check(err == 0, f"step.expand at {n} objects: kernel != plain version")
    n_bytes = B * (8 * n + 1) + 4 * n * n * C * 5 + 4 * B * n + 4 * B * (9 * n + 2)
    out["step.expand"] = dict(
        path=step.expand_path(n), batch=4 * B, max_abs_err=err,
        ms=cuda_time_ms(lambda: step.expand_and_test(*args), reps=20),
        device_ms=kernel_device_ms(profile_device(lambda: step.expand_and_test(*args), reps=20),
                                   names["expand"], calls=20),
        plain_ms=cuda_time_ms(lambda: step.expand_and_test_reference(*args), reps=3),
        **work_bound(n_bytes, 0, floor))

    # The fingerprint of the children.
    keys = hashset.fingerprint(children, p.width)
    differing = int((keys != hashset.fingerprint_reference(children, p.width)).sum())
    check(differing == 0, f"visited_set.fingerprint at {n} objects: {differing} keys differ")
    out["visited_set.fingerprint"] = dict(
        batch=children.shape[0], max_abs_err=float(differing),
        device_ms=kernel_device_ms(profile_device(lambda: hashset.fingerprint(children, p.width), reps=20),
                                   "fingerprint_kernel", calls=20),
        **work_bound(children.shape[0] * (8 * n + 8), 0, floor))

    # Novelty, from the search's own tables, on both batches in turn.
    kern, ref = (dataclasses.replace(s.novelty, seen_pos=s.novelty.seen_pos.clone(),
                                     pair_table=s.novelty.pair_table.clone()) for _ in range(2))
    err, sizes, scores = 0.0, (0, 0), {}
    for _, kids, mv in batches:
        valid = mv.any(-1) & torch.as_tensor(rng.random(kids.shape[0]) < 0.9, device=dev)
        got, _ = novelty.novelty_score_and_update(kern, kids, mv, valid)
        want, _ = novelty.novelty_score_and_update_reference(ref, kids, mv, valid)
        torch.cuda.synchronize()
        err = max(err, abs_err(got, want), abs_err(kern.seen_pos, ref.seen_pos),
                  abs_err(kern.pair_table.view(torch.int16), ref.pair_table.view(torch.int16)))
        check(err == 0, f"novelty at {n} objects: kernels != plain version")
        sizes = tuple(max(a, b) for a, b in zip(sizes, _novelty_bytes(kids, mv, valid, want, kern)))
        for v in want.tolist():
            scores[v] = scores.get(v, 0) + 1
    valid = moved.any(-1)
    prof = profile_device(lambda: novelty.novelty_score_and_update(kern, children, moved, valid), reps=20)
    plain = cuda_time_ms(lambda: novelty.novelty_score_and_update_reference(ref, children, moved, valid), reps=3)
    for name, n_bytes in (("novelty.score", sizes[0]), ("novelty.absorb", sizes[1])):
        out[name] = dict(path=novelty.novelty_path(n), batch=children.shape[0], max_abs_err=err, scores=scores,
                         device_ms=kernel_device_ms(prof, names[name], calls=20), plain_ms_score_and_absorb=plain,
                         **work_bound(n_bytes, 0, floor))

    # RGD: the search's children at depth 0; the widened four-tool chain
    # deeper: 64 walk states at depths 1 and 2, 16 at depth 3 (at 33) and,
    # where the memo lives
    # in the device scratch (64 and 100 objects), 1,024 at depth 1, so that
    # each CTA of the scratch path's persistent grid (2 an SM) walks several
    # states.  The plain version runs once a lane and depth (cached), timed:
    # at depth 3 (seconds a call, whatever the batch) that call's time is its
    # time; shallower, a second call's.
    tools = Puzzle.from_text(four_tools_with_obstacles_text(n))
    t_tools = rgd.build_rgd_tables(tools, compile_puzzle(tools), device=dev)
    walks = torch.as_tensor(walk_states(tools, 1024, seed=n), device=dev)
    specs = [("search_children", t, children, 0), ("four_tools_walks", t_tools, walks[:64], 1),
             ("four_tools_walks", t_tools, walks[:64], 2)]
    if n == 33:
        specs.append(("four_tools_walks_16", t_tools, walks[:16], 3))
    if n >= 64:
        specs.append(("four_tools_walks_1024", t_tools, walks, 1))
    plain, plain_ms = {}, {}

    def reference(what, tt, states, d):
        if (what, d) not in plain:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            plain[(what, d)] = rgd.rgd_heuristic_with_flags_reference(tt, states, d)
            end.record()
            torch.cuda.synchronize()
            plain_ms[(what, d)] = start.elapsed_time(end)
        return plain[(what, d)]

    lanes = {}
    for what, tt, states, depth in specs:
        total, flags = rgd.rgd_heuristic_with_flags(tt, states, depth)
        want_total, want_flags = reference(what, tt, states, depth)
        torch.cuda.synchronize()
        err = max(abs_err(total, want_total), abs_err(flags, want_flags))
        check(err == 0, f"rgd at {n} objects ({what}, {states.shape[0]} states, depth {depth}): "
                        "kernel != plain version")
        # Each state's deepest depth taken: its first finite one, else the last.
        reached = torch.full((states.shape[0],), depth, dtype=torch.int32, device=dev)
        for d in reversed(range(depth)):
            reached = torch.where(reference(what, tt, states, d)[0] < 1e8, d, reached)
        n_bytes, n_ops = _rgd_work(tt, states.shape[0], reached.cpu().numpy())
        if depth < 3:  # the time of a second call
            del plain[(what, depth)]
            reference(what, tt, states, depth)
        lanes[f"{what}_depth_{depth}"] = dict(
            path=rgd.rgd_path(tt, states.shape[0], depth, dev), batch=states.shape[0], max_abs_err=err,
            finite=int((want_total < 1e8).sum()), deep_states=int((reached >= 1).sum()),
            device_ms=kernel_device_ms(profile_device(lambda: rgd.rgd_heuristic_with_flags(tt, states, depth),
                                                      reps=20), names["rgd"], calls=20),
            plain_ms=plain_ms[(what, depth)], **work_bound(n_bytes, n_ops, floor))
    out["rgd.heuristic"] = dict(lanes=lanes, max_abs_err=max(v["max_abs_err"] for v in lanes.values()),
                                **{k: lanes["search_children_depth_0"][k] for k in (
                                    "path", "device_ms", "plain_ms", "bound_ms", "bound_by")})
    return out


def _expand_paths(generated, dev):
    """The expansion's two paths on states that both take: 256 parents of a
    real search (``_search_batches``, two iterations) of the 47 x 54 puzzle
    (N = 4) and of many_objects_text(n), n = 8 to 32.  The paths' outputs
    must be equal; device ms of each (one-word, wide, one-word, wide), which
    place the wrapper's switch between them."""
    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import step

    out = {}
    for n, p in [(4, generated)] + [(n, Puzzle.from_text(many_objects_text(n))) for n in (8, 12, 16, 19, 24, 32)]:
        pl, _, batches = _search_batches(p, 0, dev, batches=1, iters=2)
        par = batches[0][0]
        sel = torch.ones((par.shape[0],), dtype=torch.bool, device=dev)
        args = (pl.cp_dev, pl.tables.contacts, pl.tables.contacts_mask, par, sel, None)
        one, wide = step._expand_cuda(*args, wide=False), step._expand_cuda(*args, wide=True)
        torch.cuda.synchronize()
        err = max(abs_err(a, b) for a, b in zip(one, wide))
        check(err == 0, f"step.expand at {n} objects: the wide path != the one-word path")
        ms = {"one-word": [], "wide": []}
        for _ in range(2):
            for path, w, name in (("one-word", False, "expand_kernel"), ("wide", True, "expand_wide_kernel")):
                prof = profile_device(lambda w=w: step._expand_cuda(*args, wide=w), reps=20)
                ms[path].append(kernel_device_ms(prof, name, calls=20))
        out[n] = {"batch": 4 * par.shape[0], "max_abs_err": err, "device_ms": ms}
    return out


def phase_many_objects(dev, floor, generated):
    """States of more than 32 objects, which take the wide paths of the
    expansion, RGD and novelty: the kernels at N = 33, 64 and 100, and at
    32 on their one-word paths beside them (``_wide_kernel_lanes``); the
    expansion's two paths at N = 4, 19 and 32 (``_expand_paths``); then,
    with the launch counts at 0, ``solve_puzzle(mode="N+RGD")`` on the card
    at the production capacities on the three puzzles, whose plans must pass
    the oracle (counts read after); the 64-movable solve on the CPU, whose
    plan, iterations and expansions the card's must equal; the 64-movable
    puzzle through ``plan_puzzles(portfolio=True)`` (no head start) and,
    with the 33- and an 8-movable one, the fleet with its native workers in
    claim mode; the greedy policy's (B, 4) successor values on 1,024 walk
    states of the 33-movable puzzle, card = CPU.  Returns the kernels' lanes
    by name and N, and the launches."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.envs.policies import successor_values
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops.rgd import build_rgd_tables
    from pushworld_tpu_torch.search import fleet
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES as CAP
    from pushworld_tpu_torch.search.planner import plan_puzzles, solve_puzzle

    rng = np.random.default_rng(14)
    t0 = time.monotonic()
    by_kernel = {}
    for n in (32,) + WIDE_OBJECTS:
        for name, lane in _wide_kernel_lanes(n, dev, floor, rng).items():
            by_kernel.setdefault(name, {})[n] = lane
    expand_paths = _expand_paths(generated, dev)
    kernels_s = time.monotonic() - t0

    puzzles = {n: Puzzle.from_text(many_objects_text(n)) for n in WIDE_OBJECTS}
    LAUNCHES.clear()
    card = {}
    for n, p in puzzles.items():
        t = time.monotonic()
        r = solve_puzzle(p, mode="N+RGD", time_limit=120, device=dev, **CAP)
        torch.cuda.synchronize()
        check(r.failure_reason is None and p.is_valid_plan(r.plan), f"{n} movables on the card: {r}")
        card[n] = (r, time.monotonic() - t)
    launches = dict(LAUNCHES)
    for k in MAIN_PATH_KERNELS:
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the many-objects path")
    solves = {n: {"plan": r.plan, "iterations": r.iterations, "expansions": r.expansions, "wall_s": wall}
              for n, (r, wall) in card.items()}
    t = time.monotonic()
    c = solve_puzzle(puzzles[64], mode="N+RGD", time_limit=120, device="cpu", **CAP)
    r = card[64][0]
    check((r.plan, r.iterations, r.expansions) == (c.plan, c.iterations, c.expansions),
          f"64 movables: card {r} != CPU {c}")
    solves[64]["cpu_wall_s"] = time.monotonic() - t

    named = [("many_objects_64", puzzles[64])]
    old = os.environ.get("PW_PORTFOLIO_HEADSTART")
    os.environ["PW_PORTFOLIO_HEADSTART"] = "0"
    try:
        res = plan_puzzles(named, portfolio=True, time_limit=60, device=dev, **CAP)
    finally:
        if old is None:
            del os.environ["PW_PORTFOLIO_HEADSTART"]
        else:
            os.environ["PW_PORTFOLIO_HEADSTART"] = old
    check_results(named, res, "many objects, portfolio")
    check(res["many_objects_64"].failure_reason is None, f"many objects, portfolio: {res}")
    # The fleet as users run it (its default native workers) in claim mode:
    # the native planner takes at most 31 movables, so the 64- and the
    # 33-movable puzzles go to the device worker alone; the 8-movable one to
    # whichever takes it first.
    wide_named = named + [("many_objects_33", puzzles[33])]
    trio = wide_named + [("many_objects_8", Puzzle.from_text(many_objects_text(8)))]
    fl = fleet.plan_puzzles_fleet(trio, device=dev, time_limit=60, device_mode="claim", device_claim_delay=0,
                                  **CAP)
    check(not fleet._device_stats["device_failed"], "many objects, fleet: the device worker failed")
    check_results(trio, fl, "many objects, fleet")
    check(all(fl[name].failure_reason is None for name, _ in trio), f"many objects, fleet: {fl}")
    check(all(fl[name].solver == "device" for name, _ in wide_named), f"many objects, fleet: {fl}")

    p = puzzles[33]
    positions = walk_states(p, 1024, seed=33)
    values = {}
    for d in (dev, "cpu"):
        cp = compile_puzzle(p).to(d)
        values[d] = successor_values(cp, build_rgd_tables(p, compile_puzzle(p), max_depth=0, device=d),
                                     torch.as_tensor(positions, device=d)).cpu()
    check(values[dev].shape == (1024, 4) and torch.equal(values[dev], values["cpu"]),
          "greedy policy at 33 movables: card != CPU")
    emit({"phase": "many_objects", "objects": list(WIDE_OBJECTS), "kernels": by_kernel, "kernels_s": kernels_s,
          "expand_paths": expand_paths,
          "solves": solves, "launches": launches,
          "portfolio_64": [res["many_objects_64"].solver, res["many_objects_64"].planning_time],
          "fleet_64": [fl["many_objects_64"].solver, fl["many_objects_64"].planning_time],
          "greedy_values_33": {"shape": list(values[dev].shape), "finite": int((values[dev] < 1e8).sum())},
          "seconds": time.monotonic() - t0})
    return by_kernel, launches


def _same_search(a, b, what: str) -> None:
    """Two search states took the same steps, compared as phase
    ``cpu_agreement`` holds a search: counters, frontier keys and, on live
    slots, states, history refs and fingerprints; history, novelty tables;
    the visited set as a SET of keys (a same-round slot race may lay a probe
    cluster out in another order)."""
    import torch

    live = (a.frontier_h < 0x7F000000).cpu()
    check(torch.equal(a.frontier_h.cpu(), b.frontier_h.cpu()), f"{what}: frontier keys differ")
    for f in ("frontier_states", "frontier_hist", "frontier_key"):
        check(torch.equal(getattr(a, f).cpu()[live], getattr(b, f).cpu()[live]), f"{what}: {f} differs")
    for f in ("ring_cursor", "hist_parent", "hist_action", "hist_cursor", "solved", "solved_hist",
              "iterations", "expansions", "evictions", "needs_deeper"):
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f"{what}: {f} differs")
    check(torch.equal(a.novelty.seen_pos.cpu(), b.novelty.seen_pos.cpu()), f"{what}: seen_pos differs")
    check(torch.equal(a.novelty.pair_table.cpu(), b.novelty.pair_table.cpu()), f"{what}: pair_table differs")

    def keys(s):
        k = s.visited.keys.cpu()
        return set(k[(k != 0) & (k != -1)].tolist())

    check(keys(a) == keys(b), f"{what}: visited sets differ")


def _busy(fn) -> dict:
    """Host wall seconds of ``fn`` (ending in a synchronise) and the share of
    it the card was busy (torch.profiler); the share is None where the
    profiler recorded no kernel (it may not trace a graph's nodes)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in rows)
    return {"wall_s": wall_s, "busy_share": busy_us / (wall_s * 1e6) if rows else None,
            "device_ms": busy_us / 1e3 if rows else None, "kernels": sum(e.count for e in rows),
            "by_kernel": {e.key.replace("void ", "")[:120]: [e.count, dev_us(e)] for e in rows}}


def _chunk_lane(what, puzzle, depth, chunk, chunks, dev, masked: bool):
    """One lane at production capacities: ``chunks`` graphed chunks of
    ``chunk`` iterations and, from the same initial state, the eager loop
    for the same iterations; equal searches, and their times.  ``masked``:
    then on to the search's end, and the time of chunks whose every
    iteration has its gate closed (host clock)."""
    import torch

    from pushworld_tpu_torch.search import chunk_graph
    from pushworld_tpu_torch.search.batched import EMPTY, BatchedPlanner, _iterate, run_chunk, search_status
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    pl = BatchedPlanner(puzzle, max_depth=depth, device=dev, **PRODUCTION_CAPACITIES)
    cfg = pl.config
    s_g, s_e = pl.init_state(), pl.init_state()
    torch.cuda.synchronize()
    g = chunk_graph.attach(pl.cp_dev, pl.tables, cfg, s_g)
    torch.cuda.synchronize()
    iters = chunks * -(-chunk // g.iters) * g.iters

    def graphed():
        for _ in range(chunks):
            run_chunk(pl.cp_dev, pl.tables, cfg, s_g, chunk)

    g_row = _busy(graphed)
    # Every kernel of a graphed iteration is a hand kernel (the profiler's
    # rows): no sort, argsort or matrix product is left.
    library = [k for k in g_row["by_kernel"] if any(w in k.lower() for w in ("sort", "gemm", "bmm", "matmul"))]
    check(not library, f"chunk ({what}): library kernels in a graphed iteration: {library}")
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(iters):
        _iterate(pl.cp_dev, pl.tables, cfg, s_e)
    torch.cuda.synchronize()
    eager_s = time.monotonic() - t
    _same_search(s_g, s_e, f"chunk ({what}): graphed vs eager")
    # run_chunk enqueues its replays and returns without waiting for the
    # card.  An iteration's own device work is now shorter than the host's
    # enqueue of it, so the card can be idle again by the time the host
    # looks; with a known 10 ms of device work queued ahead of the chunk, a
    # run_chunk that waited for the card would return after it.
    returned_early = []
    for _ in range(chunks):
        torch.cuda._sleep(SLEEP_10_MS_CYCLES)
        run_chunk(pl.cp_dev, pl.tables, cfg, s_g, chunk)
        done = torch.cuda.Event()
        done.record()
        returned_early.append(not done.query())
        torch.cuda.synchronize()
    check(all(returned_early), f"chunk ({what}): a chunk was complete when run_chunk returned: {returned_early}")
    row = {}
    if masked:
        for _ in range(1000):
            stat = search_status(s_g)
            if stat[0] or stat[2] >= EMPTY or stat[3] >= cfg.history_capacity - 8 * cfg.expand:
                break
            run_chunk(pl.cp_dev, pl.tables, cfg, s_g, chunk)
        before = search_status(s_g)
        torch.cuda.synchronize()
        t = time.monotonic()
        run_chunk(pl.cp_dev, pl.tables, cfg, s_g, 4 * chunk)
        torch.cuda.synchronize()
        closed_iters = 4 * -(-chunk // g.iters) * g.iters
        row["masked_ms_per_iter"] = (time.monotonic() - t) / closed_iters * 1e3
        closed = _busy(lambda: run_chunk(pl.cp_dev, pl.tables, cfg, s_g, 4 * chunk))
        row["masked_device_ms_per_iter"] = None if closed["device_ms"] is None else closed["device_ms"] / closed_iters
        row["masked_kernels_per_iter"] = closed["kernels"] / closed_iters
        row["masked_kernels_by_name"] = {k: [c / closed_iters, us / closed_iters]
                                         for k, (c, us) in closed["by_kernel"].items()}
        row["masked_wall_ms_per_iter_profiled"] = closed["wall_s"] / closed_iters * 1e3
        row["search_iterations"] = int(s_g.iterations)
        check((search_status(s_g) == before).all(), f"chunk ({what}): an inactive chunk changed the status")
    return {**row,"puzzle": what, "depth": depth, "G": g.iters, "nodes": g.nodes, "capture_s": g.capture_s,
            "instantiate_s": g.instantiate_s, "chunk": chunk, "chunks": chunks, "iterations": iters,
            "expansions": int(s_g.expansions), "solved": bool(s_g.solved), "launches_per_replay": g.launches,
            "graphed_kernels_per_iter": g_row["kernels"] / iters,
            "graphed_ms_per_iter": g_row["wall_s"] / iters * 1e3, "graphed_busy_share": g_row["busy_share"],
            "graphed_device_ms_per_iter": None if g_row["device_ms"] is None else g_row["device_ms"] / iters,
            "graphed_kernels_by_name": {k: [c / iters, us / iters] for k, (c, us) in g_row["by_kernel"].items()},
            "eager_ms_per_iter": eager_s / iters * 1e3, "returned_before_the_card": returned_early}


def depth3_candidate(seed: int):
    """The first of the generator's 16 candidates from ``seed`` (the tools
    phase's filter) whose RGD depth at the initial state is 3, and its index."""
    import tempfile

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.search.batched import required_depth
    from pushworld_tpu_torch.tools.generate import generate_level0_puzzles

    with tempfile.TemporaryDirectory(prefix="pw_gen_") as work:
        generate_level0_puzzles(work, num_puzzles=16, random_seed=seed, filter_puzzles=False)
        candidates = [Puzzle.from_file(os.path.join(work, f"puzzle_{i}.pwp")) for i in range(16)]
    deep = next((i for i, p in enumerate(candidates) if required_depth(p) == 3), None)
    check(deep is not None, "no depth-3 candidate from the generator")
    return deep, candidates[deep]


def phase_chunk(generated, hard, seed, dev):
    """The search chunk as CUDA graphs at production capacities: graphed =
    eager on the 47 x 54 puzzle (depth 0) and on a depth-3 lane (a "no
    solution" candidate of the tools phase's generator), each chunk returned
    before the card finished it, and a 2 s budget's overshoot.  Launches
    are counted from 0 for the phase and returned."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth

    t0 = time.monotonic()
    deep, candidate = depth3_candidate(seed)
    LAUNCHES.clear()
    lanes = [_chunk_lane("generated_47x54", generated, required_depth(generated), 32, 2, dev, masked=True),
             _chunk_lane(f"generator seed {seed} candidate {deep}", candidate, 3, 2, 2, dev, masked=False)]
    for row in lanes:
        print(json.dumps({"chunk_lane": row}), file=sys.stderr, flush=True)

    # A 2 s budget on the 16 x 16 puzzle that outlasts it: how late solve()
    # returns (the capture of its graph counts against the budget).  At
    # production capacities the search would fill its history before the
    # budget's end (budget_capacities): the budget must end the search, so
    # that run_chunk's clock check and solve's budget exit run.
    planner = BatchedPlanner(hard, max_depth=required_depth(hard), device=dev, **budget_capacities())
    t = time.monotonic()
    try:
        plan = planner.solve(time_limit=2.0)
        budget = {"result": "solved", "plan_valid": hard.is_valid_plan(plan)}
    except TimeoutError as e:
        budget = {"result": str(e)}
    wall = time.monotonic() - t
    budget.update(wall_s=wall, overshoot_s=wall - 2.0 if budget["result"] == "time budget exhausted" else None,
                  iterations=int(planner.last_state.iterations), G=planner.last_state.graph.iters,
                  capture_s=planner.last_state.graph.capture_s, history=int(planner.last_state.hist_cursor))
    check(budget["result"] == "time budget exhausted",
          f"chunk: the 2 s budget did not end the 16 x 16 search: {budget}")
    launches = dict(LAUNCHES)
    for k in ITERATION_KERNELS:
        check(launches.get(k, 0) > 0, f"chunk: kernel {k} was not launched")
    emit({"phase": "chunk", "lanes": lanes, "budget_2s_hard_16x16": budget, "launches": launches,
          "total_s": time.monotonic() - t0})
    return launches


def phase_cpu_agreement(puzzles, dev):
    """Small fixtures solved on the card and on the CPU give the same search."""
    from pushworld_tpu_torch.search.planner import solve_puzzle

    small = dict(expand=32, frontier_capacity=1 << 10, visited_bits=14,
                 history_capacity=1 << 14, pair_bits=12)
    out = []
    for name, p in puzzles:
        if name not in ("heur/two_tools", "heur/multiple_goals", "multi_goal"):
            continue
        g = solve_puzzle(p, time_limit=60, device=dev, **small)
        c = solve_puzzle(p, time_limit=60, device="cpu", **small)
        check(g.plan == c.plan and g.expansions == c.expansions,
              f"{name}: card and CPU searches differ ({g.expansions} vs {c.expansions})")
        out.append(name)
    emit({"phase": "cpu_agreement", "puzzles": out})


GRAPH_FIXTURES = ("trivial", "trivial_tool", "trivial_tool2", "multiple_goals", "transitive_pushing",
                  "necessary_transitive_pushing1", "necessary_transitive_pushing2",
                  "blocked_transitive_pushing1", "blocked_transitive_pushing2", "shortest_path_tool")


def phase_graphs(puzzles, generated, dev):
    """The device graph ops on the card: the reachability fixpoint against
    the native fixpoint and its CPU run, all-pairs distances through the
    wavefront kernel against the plain version and the scipy BFS."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.ops import graphs
    from pushworld_tpu_torch.ops.graphs_cuda import distance_to_targets

    by_name = dict(puzzles)
    named = [(f"heur/{n}", by_name[f"heur/{n}"]) for n in GRAPH_FIXTURES] + [("generated_47x54", generated)]
    LAUNCHES.clear()
    rows = {}
    for name, p in named:
        cp = compile_puzzle(p)
        stats, stats_cpu = {}, {}
        torch.cuda.synchronize()
        t = time.monotonic()
        E, reached = graphs.build_reachability(cp, device=dev, stats_out=stats)
        torch.cuda.synchronize()
        card_s = time.monotonic() - t
        t = time.monotonic()
        E_cpu, reached_cpu = graphs.build_reachability(cp, device="cpu", stats_out=stats_cpu)
        cpu_s = time.monotonic() - t
        check(torch.equal(E.cpu(), E_cpu) and torch.equal(reached.cpu(), reached_cpu) and stats == stats_cpu,
              f"build_reachability: card != CPU ({name})")
        n = p.num_movables
        check(np.array_equal(E.cpu().numpy()[:, :n], bridge.build_graphs_native(p, cp).astype(bool)),
              f"build_reachability != native fixpoint ({name})")
        rows[name] = {"iterations": stats["iterations"], "card_s": card_s, "cpu_s": cpu_s}

    # All-pairs distances of the agent's graph on the 47 x 54 puzzle.
    cp = compile_puzzle(generated)
    H, W = cp.height, cp.width
    E_o = E[:, 0]  # the generated puzzle came last
    torch.cuda.synchronize()
    t = time.monotonic()
    D = graphs.all_pairs_distances(E_o)
    torch.cuda.synchronize()
    all_pairs_s = time.monotonic() - t
    check(LAUNCHES["wavefront"] == 1, "all_pairs_distances did not launch the wavefront kernel once")
    d0 = torch.full((H * W, H * W), graphs.INF, dtype=torch.float32, device=dev)
    d0.fill_diagonal_(0.0)
    want = graphs.distance_fields_reference(E_o[None], d0.reshape(-1, H, W)).reshape(H * W, H * W).T
    err = abs_err(D, want)
    check(torch.equal(D, want), "all_pairs_distances != plain version")
    E_np = E_o.cpu().numpy()
    init = generated.initial_state[0]
    verts = np.nonzero(graphs.host_vertex_mask(E_np, init[1] * W + init[0]))[0]
    block = D.cpu().numpy()[np.ix_(verts, verts)]
    check(np.array_equal(block, graphs.host_graph_distances_compact(E_np, verts)),
          "all_pairs_distances != scipy BFS on the graph's vertices")
    # One capped field, kernel against plain version and host BFS.
    targets = torch.zeros((H, W), dtype=torch.bool, device=dev)
    targets[init[1], init[0]] = True
    capped = distance_to_targets(E_o, targets, max_iters=9)
    bfs = graphs.host_distance_to_targets(E_np, init[1] * W + init[0])
    check(np.array_equal(capped.cpu().numpy(), np.where(bfs <= 9, bfs, np.float32(graphs.INF))),
          "capped distance_to_targets != host BFS cut at the cap")
    launches = dict(LAUNCHES)
    emit({"phase": "graphs", "puzzles": len(named), "reachability": rows,
          "all_pairs": {"grid": [H, W], "fields": H * W, "vertices": len(verts), "seconds": all_pairs_s,
                        "max_abs_err": err},
          "launches": launches})
    return launches


def _env_card_cpu_oracle(what, puzzle_list, cp, idx_np, max_steps, n_steps, n_oracle, rng, dev):
    """The same actions through VectorEnv on the card and on the CPU: every
    output of every step equal; the first ``n_oracle`` rollouts follow the
    oracle of their puzzle step by step.  Returns the card's last positions."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.envs.vector_env import VectorEnv

    B = len(idx_np)
    env_g = VectorEnv(cp, max_steps=max_steps, device=dev)
    env_c = VectorEnv(cp, max_steps=max_steps, device="cpu")
    idx = torch.as_tensor(idx_np)
    st_g, st_c = env_g.reset(None, B, idx), env_c.reset(None, B, idx)
    oracle = [(puzzle_list[i].initial_state, 0) for i in idx_np[:n_oracle]]
    terminated_n = truncated_n = 0
    for t, a in enumerate(rng.integers(0, 4, (n_steps, B)).astype(np.int32)):
        out_g = env_g.step(st_g, torch.as_tensor(a, device=dev))
        out_c = env_c.step(st_c, torch.as_tensor(a))
        torch.cuda.synchronize()
        st_g, st_c = out_g[0], out_c[0]
        for f in ("positions", "steps", "achieved", "puzzle_idx"):
            check(torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)), f"{what}: EnvState.{f} differs at step {t}")
        for name, g, c in zip(("positions", "reward", "terminated", "truncated"), out_g[1:], out_c[1:]):
            check(g.dtype == c.dtype and torch.equal(g.cpu(), c), f"{what}: {name} differs at step {t}")
        _, pos, reward, term, trunc = out_c
        terminated_n += int(term.sum())
        truncated_n += int(trunc.sum())
        for b in range(n_oracle):
            p = puzzle_list[idx_np[b]]
            s, steps = oracle[b]
            nxt, steps = p.get_next_state(s, int(a[b])), steps + 1
            goal = p.is_goal_state(nxt)
            want_r = 10.0 if goal else np.float32(
                np.float32(p.count_achieved_goals(nxt) - p.count_achieved_goals(s)) - np.float32(0.01))
            cut = (not goal) and max_steps is not None and steps >= max_steps
            check(pos[b, : p.num_movables].tolist() == [list(xy) for xy in nxt]
                  and float(reward[b]) == float(want_r) and bool(term[b]) == goal and bool(trunc[b]) == cut,
                  f"{what}: rollout {b} leaves the oracle at step {t}")
            oracle[b] = (p.initial_state, 0) if goal or cut else (nxt, steps)
    return out_g[1], {"batch": B, "steps": n_steps, "max_steps": max_steps, "oracle_rollouts": n_oracle,
                      "terminated": terminated_n, "truncated": truncated_n}


def _wrappers_against_oracle(puzzle_path, puzzle):
    """The Gym and dm_env wrappers (host code) where their packages exist."""
    import importlib.util

    import numpy as np

    from pushworld_tpu_torch.envs.env_utils import render_observation_padded

    actions = [1, 3, 0, 1, 2, 1, 1]
    out = {}
    if importlib.util.find_spec("gymnasium") or importlib.util.find_spec("gym"):
        from pushworld_tpu_torch.envs.gym_env import PushWorldEnv

        env = PushWorldEnv(puzzle_path, max_steps=5, pixels_per_cell=8)
        obs, info = env.reset(seed=1)
        s, n = puzzle.initial_state, 0
        check(info["puzzle_state"] == s, "gym: reset state")
        for a in actions:
            obs, r, term, trunc, info = env.step(a)
            nxt, n = puzzle.get_next_state(s, a), n + 1
            goal = puzzle.is_goal_state(nxt)
            want_r = 10.0 if goal else puzzle.count_achieved_goals(nxt) - puzzle.count_achieved_goals(s) - 0.01
            check(info["puzzle_state"] == nxt and r == want_r and term == goal and trunc == (n >= 5),
                  "gym: a step leaves the oracle")
            check(np.array_equal(obs, render_observation_padded(puzzle, nxt, puzzle.height, puzzle.width, 8, 2)),
                  "gym: observation != padded render")
            if term or trunc:
                break
            s = nxt
        out["gym"] = "ok"
    else:
        out["gym"] = "not installed"
    if importlib.util.find_spec("dm_env"):
        from pushworld_tpu_torch.envs.dm_env_impl import PushWorldEnv as DmEnv

        env = DmEnv(puzzle_path, max_steps=5, pixels_per_cell=8)
        check(env.reset(seed=1).first(), "dm_env: reset is no first step")
        s, n = puzzle.initial_state, 0
        for a in actions:
            ts = env.step(a)
            nxt, n = puzzle.get_next_state(s, a), n + 1
            goal = puzzle.is_goal_state(nxt)
            want_r = 10.0 if goal else puzzle.count_achieved_goals(nxt) - puzzle.count_achieved_goals(s) - 0.01
            check(env.current_state == nxt and ts.reward == want_r and ts.last() == (goal or n >= 5),
                  "dm_env: a step leaves the oracle")
            if ts.last():
                break
            s = nxt
        out["dm_env"] = "ok"
    else:
        out["dm_env"] = "not installed"
    return out


def phase_envs(puzzles, generated, dev, batch=4096, horizon=128):
    """The environment half on the card, at the JAX benchmark's batch and
    horizon unless a rehearsal asks for less."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_batch, compile_puzzle
    from pushworld_tpu_torch.envs.policies import make_greedy_policy
    from pushworld_tpu_torch.envs.throughput import measure_env_throughput
    from pushworld_tpu_torch.envs.vector_env import VectorEnv
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import render
    from pushworld_tpu_torch.ops.rgd import build_rgd_tables

    LAUNCHES.clear()
    by_name = dict(puzzles)
    rng = np.random.default_rng(4)
    B = batch
    out = {"phase": "envs", "batch": B}

    # (a) one puzzle, the 47 x 54 one; (b) a stacked batch of three sizes.
    cp = compile_puzzle(generated)
    n_oracle = min(B, 256)
    last_pos, out["single_47x54"] = _env_card_cpu_oracle(
        "single", [generated], cp, np.zeros(B, np.int32), 40, 64, n_oracle, rng, dev)
    check(out["single_47x54"]["truncated"] == B, "single: every rollout is truncated once in 64 steps")
    trio = [by_name[n] for n in ("simple", "chain", "push_left")]
    idx = rng.integers(0, 3, B).astype(np.int32)
    _, out["stacked_3"] = _env_card_cpu_oracle("stacked", trio, compile_batch(trio), idx, 9, 64, n_oracle, rng, dev)
    check(out["stacked_3"]["terminated"] > 0 and out["stacked_3"]["truncated"] > 0,
          "stacked: the walks neither reached a goal nor were truncated")

    # (c) the renderers on the states of (a).
    t_g = render.compile_render_tables(generated, cp, device=dev)
    t_c = render.compile_render_tables(generated, cp, device="cpu")
    obs = render.render_cells_onehot_batched(t_g, last_pos)
    torch.cuda.synchronize()
    check(obs.shape == (B, cp.height, cp.width, 6) and obs.dtype == torch.float32 and obs.is_contiguous(),
          "batched renderer: shape, type or layout")
    check(torch.equal(obs[:n_oracle],
                      torch.stack([render.render_cells_onehot(t_g, s) for s in last_pos[:n_oracle]])),
          "batched renderer != per-state renderer")
    check(torch.equal(obs.cpu(), render.render_cells_onehot_batched(t_c, last_pos.cpu())),
          "batched renderer: card != CPU")
    check(torch.equal(render.render_cells_rgb(t_g, last_pos[:n_oracle]).cpu(),
                      render.render_cells_rgb(t_c, last_pos[:n_oracle].cpu())), "rgb renderer: card != CPU")
    del obs

    # (d) the greedy policy with tables built on the card.
    simple = by_name["simple"]
    cp_s = compile_puzzle(simple)
    before = LAUNCHES["wavefront"]
    tables = build_rgd_tables(simple, cp_s, device=dev)
    tables_cpu = build_rgd_tables(simple, cp_s, device="cpu")
    check(LAUNCHES["wavefront"] > before, "the table build launched no wavefront kernel")
    check(torch.equal(tables.Dflat.cpu(), tables_cpu.Dflat) and torch.equal(tables.DG.cpu(), tables_cpu.DG),
          "tables built by the kernel != tables built by the plain version")
    env = VectorEnv(cp_s, max_steps=30, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    _, (rewards, terms) = env.rollout(gen, make_greedy_policy(env.puzzles, tables), batch_size=min(B, 1024), horizon=20)
    check(bool(terms.any(dim=0).all()) and bool((rewards[terms] == 10.0).all()),
          "greedy policy: a rollout never reached the goal")
    out["greedy"] = {"puzzle": "simple", "batch": min(B, 1024), "goals_reached": int(terms.sum())}

    # (e) throughput at the benchmark's size, then a profiled window and the
    # step and the renderer alone.
    for key, with_obs in (("throughput_obs", True), ("throughput_no_obs", False)):
        r = measure_env_throughput(generated, batch_size=B, horizon=horizon, reps=3, observations=with_obs,
                                   host_baseline_steps=200 if with_obs else 0, device=dev)
        check(r["steps_per_s"] > 0 and r["device"]["name"] == torch.cuda.get_device_name(0),
              f"{key}: {r}")
        out[key] = r
    pct = out["throughput_obs"]["hbm_roofline_pct"]
    check(pct is not None and 0 < pct < 100, f"hbm_roofline_pct = {pct}")
    env = VectorEnv(cp, device=dev)
    state = [env.reset(None, B, torch.zeros(B, dtype=torch.int32))]
    gen = torch.Generator(device=dev).manual_seed(0)

    def one_step(with_obs):
        actions = torch.randint(0, 4, (B,), generator=gen, device=dev)
        state[0], pos, reward, _, _ = env.step(state[0], actions)
        if with_obs:
            render.render_cells_onehot_batched(t_g, pos)
        return reward.sum()

    window = 32
    for key, with_obs in (("profile_obs", True), ("profile_no_obs", False)):
        for _ in range(4):
            one_step(with_obs)
        prof = profile_device(lambda: one_step(with_obs), reps=window)
        top = _top_kernels(prof, 8)
        out[key] = {"steps": window, "ms_per_step": prof["wall_s"] / window * 1e3,
                    "kernels_per_step": prof["n_kernels"] / window,
                    "device_busy_share": prof["busy_us"] / (prof["wall_s"] * 1e6),
                    "device_ms_per_step": prof["busy_us"] / 1e3 / window,
                    "top_kernels_device_ms_per_step": {k: us / 1e3 / window for k, us in top}}
    pos = state[0].positions
    obs_bytes = B * cp.height * cp.width * 6 * 4
    out["alone"] = {
        "step_ms": cuda_time_ms(lambda: one_step(False), reps=50),
        "render_ms": cuda_time_ms(lambda: render.render_cells_onehot_batched(t_g, pos), reps=50),
        "render_bytes": obs_bytes,
        "render_bound_ms": obs_bytes / H100_BYTES_PER_S * 1e3,
        # What the card takes to write that many bytes at all: one fill.
        "fill_same_bytes_ms": cuda_time_ms(
            lambda o=render.render_cells_onehot_batched(t_g, pos): o.zero_(), reps=50),
    }

    # (f) the wrappers: host code.
    out["wrappers"] = _wrappers_against_oracle(os.path.join(ROOT, "tests", "puzzles", "simple.pwp"), simple)
    launches = dict(LAUNCHES)
    check(launches.get("wavefront", 0) >= 1, "the envs phase launched no wavefront kernel")
    check(launches.get("rgd.heuristic", 0) >= 1, "the greedy policy launched no RGD kernel")
    out["launches"] = launches
    emit(out)
    return launches


def phase_native(puzzles, generated, dev):
    """The native planner and its fixpoint, from the port's own library."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.ops import rgd

    check(bridge.is_available(), "the native library could not be built or loaded")
    lib = bridge.library_path()
    check(lib.exists() and os.path.dirname(lib) == os.path.join(ROOT, ".torch_ext_build"),
          f"native library not under .torch_ext_build: {lib}")
    t0 = time.monotonic()
    solved = 0
    for name, p in puzzles + [("generated_47x54", generated)]:
        for mode in ("N+RGD", "RGD"):
            plan = bridge.solve_native(p, mode=mode, time_limit=30)
            if name in UNSOLVABLE:
                check(plan is None, f"native {mode}: {name} is not 'no solution'")
            else:
                check(plan is not None and (plan == [] or p.is_valid_plan(plan)),
                      f"native {mode}: {name}: {plan}")
        staged = bridge.solve_native_staged(p, time_limit=30, stages=bridge.stages_for(name))
        if name in UNSOLVABLE:
            check(staged is None, f"native staged: {name} is not 'no solution'")
        else:
            check(staged is not None and (staged == [] or p.is_valid_plan(staged)),
                  f"native staged: {name}: {staged}")
            solved += 1
        E = bridge.build_graphs_native(p)
        check(np.array_equal(E.astype(bool), rgd._movement_graphs_python(p, compile_puzzle(p))),
              f"native fixpoint != Python worklist ({name})")
    solve_s = time.monotonic() - t0

    # The 47 x 54 puzzle's table build with either fixpoint, in turns.
    cp = compile_puzzle(generated)

    def timed(fn, reps=3):
        out = []
        for _ in range(reps):
            t = time.monotonic()
            fn()
            torch.cuda.synchronize()
            out.append(time.monotonic() - t)
        return out

    native_fix = rgd._movement_graphs_host
    times = {"table_build_native_s": [], "table_build_python_s": []}
    try:
        for _ in range(2):
            rgd._movement_graphs_host = native_fix
            times["table_build_native_s"] += timed(
                lambda: rgd.build_rgd_tables(generated, cp, max_depth=0, device=dev), 2)
            rgd._movement_graphs_host = rgd._movement_graphs_python
            times["table_build_python_s"] += timed(
                lambda: rgd.build_rgd_tables(generated, cp, max_depth=0, device=dev), 2)
    finally:
        rgd._movement_graphs_host = native_fix
    times["fixpoint_native_s"] = timed(lambda: rgd._movement_graphs_host(generated, cp))
    times["fixpoint_python_s"] = timed(lambda: rgd._movement_graphs_python(generated, cp))
    emit(dict({"phase": "native", "library": os.path.relpath(lib, ROOT), "puzzles": len(puzzles) + 1,
               "solved_both_modes_and_staged": solved, "no_solution": len(UNSOLVABLE),
               "fixpoints_equal": len(puzzles) + 1, "solve_s": solve_s}, **times))


def phase_portfolio(puzzles, generated, hard, dev):
    """plan_puzzles(portfolio=True) on the card; then, with no head start, the
    device member must engage."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES, plan_puzzles

    named = puzzles + [("generated_47x54", generated)]
    LAUNCHES.clear()
    t0 = time.monotonic()
    res = plan_puzzles(named, portfolio=True, time_limit=60, device=dev, **PRODUCTION_CAPACITIES)
    wall = time.monotonic() - t0
    classes = check_results(named, res, "portfolio")
    check(all(c in ("solved", "no solution") for c in classes.values()), f"portfolio: {classes}")
    launches = dict(LAUNCHES)

    few = [(n, p) for n, p in puzzles if n in ("spill_grid", "heur/shortest_path_tool")]
    few.append(("hard_16x16", hard))
    old = os.environ.get("PW_PORTFOLIO_HEADSTART")
    os.environ["PW_PORTFOLIO_HEADSTART"] = "0"
    LAUNCHES.clear()
    try:
        t0 = time.monotonic()
        res2 = plan_puzzles(few, portfolio=True, time_limit=8, device=dev, **PRODUCTION_CAPACITIES)
        wall2 = time.monotonic() - t0
    finally:
        if old is None:
            del os.environ["PW_PORTFOLIO_HEADSTART"]
        else:
            os.environ["PW_PORTFOLIO_HEADSTART"] = old
    check_results(few, res2, "portfolio, no head start")
    launches2 = dict(LAUNCHES)
    check(launches2.get("visited_set.fingerprint_dedup_insert", 0) > 0,
          "portfolio, no head start: the device member did not engage")
    both = {k: launches.get(k, 0) + launches2.get(k, 0) for k in KERNEL_NAMES}
    for k in MAIN_PATH_KERNELS:
        check(both[k] > 0, f"kernel {k} was not launched on the portfolio's path")
    emit({"phase": "portfolio", "puzzles": len(named), "wall_s": wall,
          "solved": sum(c == "solved" for c in classes.values()),
          "no_solution": sum(c == "no solution" for c in classes.values()),
          "solver": {n: res[n].solver for n, _ in named}, "launches": launches,
          "no_head_start": {
              "wall_s": wall2, "launches": launches2,
              "results": {n: [res2[n].failure_reason or "solved", res2[n].solver,
                              res2[n].planning_time] for n, _ in few}}})
    return both


def _lane_bytes(generated, dev):
    """One production lane's device bytes, measured, beside the fleet's formula."""
    import gc

    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.search import fleet
    from pushworld_tpu_torch.search.batched import BatchedPlanner
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES as CAP

    cp = compile_puzzle(generated)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    planner = BatchedPlanner(generated, cp=cp, max_depth=0, lazy=True, device=dev, **CAP)
    state = planner.init_state()
    gc.collect()
    torch.cuda.synchronize()
    measured = torch.cuda.memory_allocated(dev) - before
    formula = fleet.bytes_per_lane(
        cp.n, cp.height, cp.width, 0, *fleet._lane_shape(generated, cp, 0),
        CAP["history_capacity"], CAP["frontier_capacity"], CAP["visited_bits"], CAP["pair_bits"])
    del planner, state
    check(formula <= measured <= 1.05 * formula + (1 << 20),
          f"one lane holds {measured} bytes, bytes_per_lane says {formula}")
    return {"measured_bytes": measured, "bytes_per_lane": formula}


def _contention(generated, hard, dev):
    """The 47 x 54 puzzle's solve on the card: alone, beside one native
    thread per core (each in a ctypes call that releases the GIL), and the
    same with the solving thread's priority lowered as the fleet lowers its
    device thread's."""
    import threading

    import numpy as np
    import torch

    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES, solve_puzzle

    cores = os.cpu_count() or 1

    def solve(nice: bool, out: dict):
        if nice:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        torch.cuda.set_device(dev)
        t = time.monotonic()
        r = solve_puzzle(generated, time_limit=120, device=dev, **PRODUCTION_CAPACITIES)
        torch.cuda.synchronize()
        out.update(wall_s=time.monotonic() - t, result=r.failure_reason or "solved",
                   expansions=r.expansions)

    def run(n_native: int, nice: bool) -> dict:
        cancel = np.zeros(1, np.int32)

        def grind():
            try:
                bridge.solve_native(hard, time_limit=300, cancel=cancel)
            except TimeoutError:
                pass

        workers = [threading.Thread(target=grind, daemon=True) for _ in range(n_native)]
        cpu0, wall0 = time.process_time(), time.monotonic()
        for w in workers:
            w.start()
        out = {}
        t = threading.Thread(target=solve, args=(nice, out))  # a thread of its own: its priority dies with it
        t.start()
        t.join()
        # CPU seconds of all threads per second of wall: how many cores the
        # process really held while the solve ran.
        out["cores_busy"] = (time.process_time() - cpu0) / (time.monotonic() - wall0)
        cancel[0] = 1
        for w in workers:
            w.join()
        check(out.get("result") == "solved", f"contention run failed: {out}")
        return out

    rows = {}
    for key, n_native, nice in (("alone", 0, False), ("native_threads", cores, False),
                                ("native_threads_low_priority", cores, True),
                                ("alone_again", 0, False)):
        rows[key] = run(n_native, nice)
    return {"cores": cores, "cores_in_affinity": len(os.sched_getaffinity(0)),
            "native_threads": cores, "solve_generated_47x54": rows}


def phase_fleet(puzzles, generated, hard, solve_classes, dev):
    """plan_puzzles_fleet on the card in its three modes, and under load."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search import fleet
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES as CAP

    named = puzzles + [("generated_47x54", generated)]
    fleet_kwargs = dict(expand=CAP["expand"], frontier_capacity=CAP["frontier_capacity"],
                        visited_bits=CAP["visited_bits"], history_capacity=CAP["history_capacity"],
                        pair_bits=CAP["pair_bits"])

    def run(what, puzzles_, **kwargs):
        LAUNCHES.clear()
        t0 = time.monotonic()
        results = fleet.plan_puzzles_fleet(puzzles_, device=dev, **kwargs, **fleet_kwargs)
        wall = time.monotonic() - t0
        stats = dict(fleet._device_stats)
        check(not stats["device_failed"], f"fleet ({what}): the device worker failed")
        classes = check_results(puzzles_, results, f"fleet ({what})")
        by_solver = {}
        for r in results.values():
            if r.failure_reason is None:
                by_solver[r.solver] = by_solver.get(r.solver, 0) + 1
        row = {"wall_s": wall, "fleet_by_solver": by_solver, "device_phases": stats,
               "launches": dict(LAUNCHES),
               "classes": {c: sum(v == c for v in classes.values()) for c in set(classes.values())}}
        print(json.dumps({"fleet": what, **row}), file=sys.stderr, flush=True)
        return row, classes, results

    out = {"phase": "fleet", "puzzles": len(named), "lane_bytes": _lane_bytes(generated, dev)}

    # (a) the device worker alone, claiming; deep lanes too.
    old = os.environ.get("PW_DEVICE_DEEP")
    os.environ["PW_DEVICE_DEEP"] = "1"
    try:
        row, classes, results = run("device only, claim", named, time_limit=60, native_workers=0,
                                    device_mode="claim", device_claim_delay=0, group_size=4)
    finally:
        if old is None:
            del os.environ["PW_DEVICE_DEEP"]
        else:
            os.environ["PW_DEVICE_DEEP"] = old
    check(row["fleet_by_solver"].get("device", 0) > 0, "fleet (a): the device solved nothing")
    check(row["device_phases"]["lanes"] > 0, "fleet (a): no device lane")
    for k in MAIN_PATH_KERNELS:
        check(row["launches"].get(k, 0) > 0, f"fleet (a): kernel {k} was not launched")
    row["device_results"] = {n: [classes[n], results[n].planning_time] for n, _ in named
                             if results[n].solver == "device"}
    out["device_only_claim"] = row
    launches = row["launches"]

    # (a') PW_DEVICE_SYNC_EVERY at 1 and 4 beside (a)'s default 2: the same
    # results, and status reads that do not rise with the setting.  Then two
    # lanes of the 16 x 16 puzzle at 1, 2 and 4: run until their history
    # (2^20) fills, a fixed number of chunks, the status reads must fall
    # strictly; run chunk after chunk to a 3 s budget (budget_capacities),
    # the budget's overshoot.  How many chunks fit in the budget varies more
    # than 2x from one run to the next at one setting, so the budget's reads
    # are reported, not compared.
    reads, overshoot = {2: row["device_phases"]["chunk_dispatches"]}, {}
    fixed_kwargs = dict(fleet_kwargs, history_capacity=1 << 20)
    budget_kwargs = dict(fleet_kwargs, history_capacity=1 << BUDGET_HISTORY_BITS, visited_bits=BUDGET_HISTORY_BITS)
    old_every = os.environ.get("PW_DEVICE_SYNC_EVERY")
    try:
        for every in (1, 4):
            os.environ["PW_DEVICE_SYNC_EVERY"] = str(every)
            os.environ["PW_DEVICE_DEEP"] = "1"
            r_row, r_classes, r_results = run(f"device only, claim, sync every {every}", named, time_limit=60,
                                              native_workers=0, device_mode="claim", device_claim_delay=0,
                                              group_size=4)
            check(r_classes == classes, f"fleet (a'), sync every {every}: classification differs: {r_classes}")
            for n, _ in named:
                if results[n].solver == r_results[n].solver == "device":
                    check(results[n].plan == r_results[n].plan, f"fleet (a'), sync every {every}: {n}: plan differs")
            reads[every] = r_row["device_phases"]["chunk_dispatches"]
        check(reads[1] >= reads[2] >= reads[4], f"fleet (a'): status reads rose with the setting: {reads}")
        full_reads, hard_reads = {}, {}
        for every in (1, 2, 4):
            os.environ["PW_DEVICE_SYNC_EVERY"] = str(every)
            fleet._reset_device_stats()
            lanes = list(fleet._device_multiplex([("hard/0", hard), ("hard/1", hard)], time_limit=60.0,
                                                 device=dev, **fixed_kwargs))
            check(sorted(n for n, _ in lanes) == ["hard/0", "hard/1"], "fleet (a'): lost lanes")
            check(all(r.failure_reason == "time limit" and r.planning_time < 60.0 for _, r in lanes),
                  f"fleet (a'), sync every {every}: the full history did not end both lanes: {lanes}")
            full_reads[every] = fleet._device_stats["chunk_dispatches"]
            fleet._reset_device_stats()
            lanes = list(fleet._device_multiplex([("hard/0", hard), ("hard/1", hard)], time_limit=3.0,
                                                 device=dev, **budget_kwargs))
            check(sorted(n for n, _ in lanes) == ["hard/0", "hard/1"], "fleet (a'): lost lanes")
            hard_reads[every] = fleet._device_stats["chunk_dispatches"]
            overshoot[every] = [r.planning_time - 3.0 for _, r in lanes if r.failure_reason == "time limit"]
            # A full history also reads "time limit", but before the budget's end.
            check(len(overshoot[every]) == 2 and min(overshoot[every]) >= 0,
                  f"fleet (a'), sync every {every}: the 3 s budget did not end both lanes: {overshoot[every]}")
        check(full_reads[1] > full_reads[2] > full_reads[4],
              f"fleet (a'): status reads did not fall: {full_reads}")
    finally:
        for key, old in (("PW_DEVICE_SYNC_EVERY", old_every), ("PW_DEVICE_DEEP", old)):
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
    out["sync_every"] = {"status_reads_fixtures": reads, "status_reads_two_hard_lanes_2e20_history": full_reads,
                         "status_reads_two_hard_lanes_3s": hard_reads, "budget_overshoot_s_3s": overshoot}

    # (b) the defaults: shadow mode, one native worker per core.
    row, classes, _ = run("defaults", named, time_limit=60)
    check(classes == solve_classes, f"fleet (b): classification differs from the solve phase: {classes}")
    out["defaults_shadow"] = row

    # (c) the device off.
    row, classes, _ = run("device off", named, time_limit=60, device_mode="off")
    check(classes == solve_classes, f"fleet (c): classification differs from the solve phase: {classes}")
    out["device_off"] = row

    # (d) every core holds a native worker on the 16 x 16 puzzle for its
    # whole budget, while the device worker shadows the easy tail.
    cores = os.cpu_count() or 1
    loaded = [(f"hard_16x16/{i}", hard) for i in range(cores)] + [
        (n, p) for n, p in puzzles if n not in UNSOLVABLE and not p.is_goal_state(p.initial_state)]
    row, classes, _ = run("native workers fill the cores", loaded, time_limit=6,
                          native_workers=cores, device_claim_delay=0, group_size=16)
    check(all(c in ("solved", "time limit") for c in classes.values()), f"fleet (d): {classes}")
    out["cores_full_shadow"] = dict(row, native_workers=cores)
    out["contention"] = _contention(generated, hard, dev)
    emit(out)
    return launches


def _iterate_rate(generated, dev, caps):
    """The batched search (``_iterate``) of the 47 x 54 puzzle at ``caps``:
    host seconds of the whole call (table build included) per iteration.
    The comparison for the frontier-sharded search; it runs before the
    parallel phase counts launches."""
    import torch

    from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth

    torch.cuda.synchronize()
    t = time.monotonic()
    planner = BatchedPlanner(generated, max_depth=required_depth(generated), device=dev, **caps)
    plan = planner.solve(time_limit=120)
    torch.cuda.synchronize()
    iterate_s = time.monotonic() - t
    check(plan is not None and generated.is_valid_plan(plan), "batched search: no valid plan")
    iterations = int(planner.last_state.iterations)
    return {"iterate_ms_per_iteration": iterate_s / iterations * 1e3, "iterate_iterations": iterations}


def _sharded_rate(generated, mesh, caps):
    """The frontier-sharded search of the 47 x 54 puzzle over ``mesh``: host
    seconds of the whole call (table build included) per iteration, and the
    run again under the profiler."""
    import torch

    from pushworld_tpu_torch.parallel.frontier_sharded import solve_frontier_sharded

    stats = {}
    t = time.monotonic()
    solve_frontier_sharded(generated, mesh=mesh, time_limit=120, stats_out=stats, **caps)
    torch.cuda.synchronize()
    sharded_s = time.monotonic() - t
    sharded_iterations = stats["shard_iterations"][0]
    prof = profile_device(lambda: solve_frontier_sharded(generated, mesh=mesh, time_limit=120, **caps))
    # The collectives' records ("nccl:<op>") carry the device time of what
    # each launched; a one-rank all_reduce launches nothing, so it is absent.
    nccl = {k: v for k, v in prof["by_kernel"].items() if "nccl" in k.lower()}
    check(nccl.get("nccl:all_to_all", [0])[0] == sharded_iterations,
          f"(a) the profiled run made no all-to-all each iteration: {sorted(nccl)}")
    return {
        "sharded_ms_per_iteration": sharded_s / sharded_iterations * 1e3,
        "sharded_iterations": sharded_iterations,
        "profiled": {"wall_s": prof["wall_s"], "device_busy_share": prof["busy_us"] / (prof["wall_s"] * 1e6),
                     "kernels_per_iteration": prof["n_kernels"] / sharded_iterations},
        "nccl_kernels": {k: {"count": c, "device_ms": us / 1e3} for k, (c, us) in nccl.items()},
        "nccl_device_ms_per_iteration": sum(us for _, us in nccl.values()) / 1e3 / sharded_iterations,
    }


def _two_processes_on_one_card(dev):
    """``scripts/benchmark_distributed.py`` in two processes over the 15
    ``heur`` fixtures, both planning on this card (gloo exchanges the
    results).  No native worker: each process's fleet plans its shard on the
    card, and each shard must hold solves of the device."""
    import socket
    import tempfile

    from pushworld_tpu_torch.utils.filesystem import get_puzzle_file_paths

    set_dir = os.path.join(ROOT, "tests", "puzzles", "heur")
    names = sorted(get_puzzle_file_paths(set_dir))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"out{pid}.json") for pid in range(2)]
        procs = []
        t = time.monotonic()
        for pid in range(2):
            env = dict(os.environ, PW_COORDINATOR=f"127.0.0.1:{port}", PW_NUM_PROCESSES="2",
                       PW_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pushworld_tpu_torch.scripts.benchmark_distributed",
                 set_dir, "--device", dev.type, "--time-limit", "60", "--native-workers", "0",
                 "--out", outs[pid]],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        lines = []
        try:
            for p in procs:
                stdout, stderr = p.communicate(timeout=300)
                check(p.returncode == 0, f"benchmark_distributed exited {p.returncode}:\n{stderr[-3000:]}")
                lines.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.monotonic() - t
        docs = []
        for o in outs:
            with open(o) as f:
                docs.append(json.load(f))
    shards = [set(d["local"]) for d in docs]
    check(shards[0].isdisjoint(shards[1]) and shards[0] | shards[1] == set(names),
          "two processes: the local shards are not a partition of the set")
    for line, d in zip(lines, docs):
        check(line["count"] == len(names) and sorted(d["results"]) == names,
              f"two processes: process {line['process_id']} lacks part of the merged set")
        check(d["results"] == docs[0]["results"], "two processes: the merged sets differ")
    solver = {n: r["solver"] for n, r in docs[0]["results"].items()}
    device = [sum(solver[n] == "device" for n in s) for s in shards]
    check(all(device), f"two processes: a shard holds no device solve: {solver}")
    return {"puzzles": len(names), "wall_s": wall, "lines": lines, "local": [len(s) for s in shards],
            "device_solves_by_shard": device, "solvers": sorted(set(solver.values()))}


def phase_parallel(puzzles, generated, solve_plans, dev):
    """The parallel layer on the card: the frontier-sharded search over a
    one-rank NCCL group (the 47 x 54 puzzle at production capacities;
    spill_grid card = CPU; spills and a no-solution proof), solve_group on
    every puzzle, benchmark_distributed in two processes on the card, the
    fleet's PW_DEVICE_SHARDED=1 branch and the multi-chip dry run over one
    rank.

    Launches are counted from after the batched comparison run of (a); each
    kernel must be launched by the frontier-sharded runs of (a) and (b)
    alone, and solve_group's kernels by (c) alone."""
    import torch
    import torch.distributed as dist

    from pushworld_tpu_torch import entry
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.parallel.frontier_sharded import solve_frontier_sharded
    from pushworld_tpu_torch.parallel.mesh import make_mesh
    from pushworld_tpu_torch.parallel.sharded import solve_group
    from pushworld_tpu_torch.search import fleet
    from pushworld_tpu_torch.search.batched import required_depth
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES as CAP

    caps = {k: CAP[k] for k in ("expand", "frontier_capacity", "visited_bits", "history_capacity")}
    by_name = dict(puzzles)
    out = {"phase": "parallel"}
    t0 = time.monotonic()
    iterate_rate = _iterate_rate(generated, dev, caps)
    seconds = {"a_iterate_rate": time.monotonic() - t0}  # host seconds of each part, in order
    LAUNCHES.clear()
    part_launches = {}  # launches of each part
    counted = {}

    def lap(part: str) -> None:
        seconds[part] = time.monotonic() - t0 - sum(seconds.values())
        now = dict(LAUNCHES)
        part_launches[part] = {k: now.get(k, 0) - counted.get(k, 0) for k in KERNEL_NAMES}
        counted.update(now)

    card = make_mesh(device=dev, axis_name="shard")
    cpu = make_mesh(device="cpu", axis_name="shard")
    check(dist.get_backend(card.get_group()) == "nccl" and card.size() == 1, "the card's mesh is no one-rank NCCL group")
    check(dist.get_backend(cpu.get_group()) == "gloo", "the CPU's mesh is no gloo group")
    lap("meshes")

    # (a) The 47 x 54 puzzle at production capacities on the card; then
    # card = CPU on spill_grid, several chunks at the same capacities.
    def run_a(puzzle, mesh, **kw):
        stats = {}
        t = time.monotonic()
        plan = solve_frontier_sharded(puzzle, mesh=mesh, time_limit=120, stats_out=stats, **caps, **kw)
        torch.cuda.synchronize()
        check(plan is not None and puzzle.is_valid_plan(plan), f"(a) {mesh.device_type}: no valid plan")
        return dict(stats, plan=plan, wall_s=time.monotonic() - t)

    card_run = run_a(generated, card)
    lap("a_card")
    out["generated_47x54"] = dict({k: v for k, v in card_run.items() if k != "plan"},
                                  plan_len=len(card_run["plan"]), **iterate_rate,
                                  **_sharded_rate(generated, card, caps))
    lap("a_rate_and_profile")
    runs = {m.device_type: run_a(by_name["spill_grid"], m, chunk=4) for m in (card, cpu)}
    for k in ("plan", "chunks", "spill_epochs", "shard_iterations", "shard_expansions"):
        check(runs["cuda"][k] == runs["cpu"][k], f"(a) spill_grid: card and CPU differ in {k}")
    check(runs["cuda"]["chunks"] > 1, "(a) spill_grid: one chunk only")
    out["card_cpu_spill_grid"] = {"cpu_threads": torch.get_num_threads(), **{
        m: {k: v for k, v in r.items() if k != "plan"} for m, r in runs.items()}}
    lap("a_card_cpu")

    # (b) Spills (and evictions: a frontier of the least size) with a valid
    # plan; a no-solution proof.
    spill_grid = by_name["spill_grid"]
    stats = {}
    plan = solve_frontier_sharded(spill_grid, mesh=card, time_limit=60, stats_out=stats, expand=4,
                                  frontier_capacity=32, visited_bits=14, history_capacity=64, chunk=4)
    check(plan is not None and spill_grid.is_valid_plan(plan) and stats["spill_epochs"] >= 2,
          f"(b) spill run: {plan} {stats}")
    out["spill"] = dict(stats, plan_len=len(plan))
    stats = {}
    plan = solve_frontier_sharded(by_name["no_solution"], mesh=card, time_limit=60, stats_out=stats,
                                  expand=16, frontier_capacity=1 << 10, visited_bits=14,
                                  history_capacity=1 << 14, chunk=8)
    check(plan is None, f"(b) no_solution: {plan}")
    out["no_solution"] = stats
    lap("b")
    frontier = {k: sum(part_launches[p][k] for p in ("a_card", "a_rate_and_profile", "a_card_cpu", "b"))
                for k in KERNEL_NAMES}
    for k in MAIN_PATH_KERNELS:
        check(frontier[k] > 0, f"kernel {k} was not launched by the frontier-sharded runs")

    # (c) solve_group on every puzzle at production capacities, one group
    # per RGD depth: each lane's plan is solve_puzzle's.
    named = puzzles + [("generated_47x54", generated)]
    by_depth = {}
    for name, p in named:
        by_depth.setdefault(required_depth(p), []).append((name, p))
    group_mesh = make_mesh(device=dev)
    t = time.monotonic()
    group = {}
    for depth, sub in sorted(by_depth.items()):
        group.update(solve_group(sub, mesh=group_mesh, time_limit=60, max_depth=depth, **caps))
    check_results(named, group, "(c) solve_group")
    for name, _ in named:
        check(group[name].plan == solve_plans[name], f"(c) {name}: solve_group's plan != solve_puzzle's")
    out["solve_group"] = {"lanes": len(named), "groups": {d: len(v) for d, v in by_depth.items()},
                          "wall_s": time.monotonic() - t,
                          "solved": sum(r.failure_reason is None for r in group.values())}
    lap("c")
    for k in ("wavefront", "visited_set.probe_and_insert", "visited_set.fingerprint_dedup_insert",
              "rgd.heuristic", "novelty.score", "novelty.absorb"):
        check(part_launches["c"][k] > 0, f"kernel {k} was not launched by solve_group")

    # (d) Two processes on this one card.
    out["two_processes"] = _two_processes_on_one_card(dev)
    lap("d")

    # (e) The fleet's frontier-sharded branch: no native worker, so the
    # instance of more than 8 movables goes to it.
    many = Puzzle.from_text(MANY_MOVABLES_TEXT)
    fleet_set = [("many_movables", many)] + [(n, by_name[n]) for n in ("simple", "chain")]
    old = os.environ.get("PW_DEVICE_SHARDED")
    os.environ["PW_DEVICE_SHARDED"] = "1"
    try:
        t = time.monotonic()
        results = fleet.plan_puzzles_fleet(fleet_set, time_limit=60, native_workers=0, device_claim_delay=0.0,
                                           device_mode="shadow", device=dev)
        wall = time.monotonic() - t
    finally:
        if old is None:
            del os.environ["PW_DEVICE_SHARDED"]
        else:
            os.environ["PW_DEVICE_SHARDED"] = old
    check_results(fleet_set, results, "(e) fleet")
    r = results["many_movables"]
    check(r.solver == "device-sharded" and r.failure_reason is None and many.is_valid_plan(r.plan),
          f"(e) the sharded branch did not solve the 10-movable puzzle: {r}")
    out["fleet_sharded_branch"] = {"wall_s": wall, "solver": {n: results[n].solver for n, _ in fleet_set}}
    lap("e")

    # (f) The multi-chip dry run over this process's one rank, and the
    # entry step on the card.
    t = time.monotonic()
    entry.dryrun_multichip(1, device=dev)
    fn, args = entry.entry(device=dev)
    nxt = fn(*args)
    check(nxt.shape == args[1].shape and nxt.device == args[1].device, "entry(): wrong output")
    out["dryrun_s"] = time.monotonic() - t
    lap("f")

    launches = dict(LAUNCHES)
    out.update(launches=launches, launches_by_part=part_launches, total_s=time.monotonic() - t0,
               seconds=seconds)
    emit(out)
    return launches


# Seconds each candidate of the tools phase's generator may take: about twice
# the slowest decision of the same batched search on a CPU for seed 0 (a
# "no solution" proof of 30,111 expansions), so that a plan or "no solution"
# decides every candidate, never the clock.
GEN_TIME_LIMIT = 120.0


def _generate_recorded(path, seed, planner, dev):
    """``generate_level0_puzzles`` with the JAX defaults (16 candidates) and
    ``planner`` on ``dev``; returns the filter's results, candidate by
    candidate, as ``solve_puzzle`` gave them, and each candidate's RGD depth
    (``required_depth``, where the batched search starts) and search
    iterations (the iteration counters of every search state it made, depth
    escalations included)."""
    import pushworld_tpu_torch.search.batched as batched
    import pushworld_tpu_torch.search.planner as planner_mod
    from pushworld_tpu_torch.search.batched import required_depth
    from pushworld_tpu_torch.tools.generate import generate_level0_puzzles

    results, depths, iterations, states = [], [], [], []
    solve, init_state = planner_mod.solve_puzzle, batched.BatchedPlanner.init_state

    def recording(puzzle, **kw):
        depths.append(required_depth(puzzle))
        first = len(states)
        results.append(solve(puzzle, **kw))
        iterations.append(sum(int(s.iterations) for s in states[first:]))
        del states[first:]
        return results[-1]

    def recording_init(self):
        states.append(init_state(self))
        return states[-1]

    planner_mod.solve_puzzle = recording
    batched.BatchedPlanner.init_state = recording_init
    try:
        kept = generate_level0_puzzles(path, num_puzzles=16, random_seed=seed, time_limit=GEN_TIME_LIMIT,
                                       planner=planner, device=dev)
    finally:
        planner_mod.solve_puzzle = solve
        batched.BatchedPlanner.init_state = init_state
    check(len(results) == 16, f"(a) {planner}: {len(results)} candidates planned, not 16")
    reasons = [r.failure_reason for r in results]
    check(set(reasons) <= {None, "no solution"}, f"(a) {planner}: a candidate not decided: {reasons}")
    check(kept == reasons.count(None), f"(a) {planner}: kept {kept}, solved {reasons.count(None)}")
    return results, depths, iterations


def _check_yaml_results(results_path, puzzles_path, planner_name):
    """Every result YAML under ``results_path``: the JAX schema, no failure,
    a plan the oracle accepts on its puzzle."""
    import yaml

    from pushworld_tpu_torch.core.puzzle import Puzzle, plan_from_string

    files = sorted(glob.glob(os.path.join(results_path, "*.yaml")))
    for f in files:
        with open(f) as fh:
            doc = yaml.safe_load(fh)
        name = os.path.basename(f)[: -len(".yaml")]
        check(list(doc) == ["planner", "puzzle", "plan", "planning_time"], f"(c) {name}: keys {list(doc)}")
        check(doc["planner"] == planner_name and doc["puzzle"] == name, f"(c) {name}: {doc}")
        puzzle = Puzzle.from_file(os.path.join(puzzles_path, name + ".pwp"))
        check(puzzle.is_valid_plan(plan_from_string(doc["plan"])), f"(c) {name}: invalid plan")
    return len(files)


def phase_tools(seed, dev):
    """The toolkit on the card: the generator's filter, the transforms, the
    benchmark harness (in this process and through the CLI) and the host
    tools.  Launches are counted from 0 for the whole phase, and by part."""
    import collections
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.scripts import tools_cli
    from pushworld_tpu_torch.tools.benchmark import benchmark_planner
    from pushworld_tpu_torch.tools.transform import ACTION_MAPS, create_transformed_puzzles, transform_plan

    work = tempfile.mkdtemp(prefix="pw_tools_")
    t0 = time.monotonic()
    seconds, part_launches, counted = {}, {}, {}
    LAUNCHES.clear()

    def lap(part: str) -> None:
        seconds[part] = time.monotonic() - t0 - sum(seconds.values())
        now = dict(LAUNCHES)
        part_launches[part] = {k: now.get(k, 0) - counted.get(k, 0) for k in KERNEL_NAMES}
        counted.update(now)

    try:
        out = {"phase": "tools", "seed": seed, "candidates": 16}
        # (a) The generator, filtered on the card and by the host planner.
        card_dir, host_dir = os.path.join(work, "card"), os.path.join(work, "host")
        card, depths, iterations = _generate_recorded(card_dir, seed, "auto", dev)
        lap("a_card")
        host, _, _ = _generate_recorded(host_dir, seed, "host", dev)
        lap("a_host")
        names = sorted(os.listdir(card_dir))
        check(names == sorted(os.listdir(host_dir)), "(a) the card and the host kept different puzzles")
        for n in names:
            with open(os.path.join(card_dir, n), "rb") as a, open(os.path.join(host_dir, n), "rb") as b:
                check(a.read() == b.read(), f"(a) {n} differs between the card's and the host's sets")
        plans = [r.plan for r in card if r.failure_reason is None]
        host_plans = [r.plan for r in host if r.failure_reason is None]
        kept = [Puzzle.from_file(os.path.join(card_dir, f"puzzle_{j}.pwp")) for j in range(len(plans))]
        for j, p in enumerate(kept):
            check(p.is_valid_plan(plans[j]) and p.is_valid_plan(host_plans[j]), f"(a) puzzle_{j}: invalid plan")
        for k in ("wavefront", "visited_set.fingerprint_dedup_insert", "visited_set.probe_and_insert",
                  "rgd.heuristic", "novelty.score", "novelty.absorb"):
            check(part_launches["a_card"][k] > 0, f"(a) kernel {k} was not launched by the filter")
        out["kept"] = len(kept)
        out["decided"] = {w: dict(collections.Counter(r.failure_reason or "solved" for r in rs))
                          for w, rs in (("card", card), ("host", host))}
        out["card_by_depth"] = {d: {"candidates": depths.count(d),
                                    "planning_s": sum(r.planning_time for r, e in zip(card, depths) if e == d),
                                    "slowest_s": max(r.planning_time for r, e in zip(card, depths) if e == d),
                                    "iterations": sum(i for i, e in zip(iterations, depths) if e == d),
                                    "expansions": sum(r.expansions for r, e in zip(card, depths) if e == d)}
                                for d in sorted(set(depths))}

        # (b) The 8 symmetries of every kept puzzle, each with its mapped plan.
        variants = os.path.join(work, "variants")
        create_transformed_puzzles(card_dir, variants)
        check(len(os.listdir(variants)) == 8 * len(kept), "(b) not 8 variants a puzzle")
        for j, plan in enumerate(plans):
            for t in ACTION_MAPS:
                p = Puzzle.from_file(os.path.join(variants, f"puzzle_{j}_{t}.pwp"))
                check(p.is_valid_plan(transform_plan(plan, t)), f"(b) puzzle_{j}_{t}: invalid plan")
        out["variants"] = 8 * len(kept)
        lap("b")

        # (c) The benchmark harness over at most 64 variants: with its
        # defaults (the portfolio), then with no native planner.
        bench_in = os.path.join(work, "bench_in")
        os.makedirs(bench_in)
        for f in sorted(os.listdir(variants))[:64]:
            shutil.copy(os.path.join(variants, f), bench_in)
        name = "pushworld-tpu batched N+RGD"
        res = benchmark_planner(bench_in, os.path.join(work, "results"), time_limit=60, planner="batched",
                                progress=False, device=dev)
        check(_check_yaml_results(os.path.join(work, "results"), bench_in, name) == len(res), "(c) YAMLs missing")
        out["benchmark"] = {"puzzles": len(res), "solver": dict(collections.Counter(r.solver for r in res.values()))}
        lap("c_portfolio")
        available = bridge.is_available
        bridge.is_available = lambda: False
        try:
            res = benchmark_planner(bench_in, os.path.join(work, "results_device"), time_limit=60,
                                    planner="batched", progress=False, device=dev)
        finally:
            bridge.is_available = available
        check(_check_yaml_results(os.path.join(work, "results_device"), bench_in, name) == len(res),
              "(c) YAMLs missing")
        device_solves = sum(r.solver == "device" for r in res.values())
        check(device_solves == len(res), f"(c) no native planner, yet {len(res) - device_solves} not by the device")
        out["benchmark_no_native"] = {"puzzles": len(res), "device_solves": device_solves,
                                      "planning_s": sum(r.planning_time for r in res.values())}
        lap("c_device")
        check(part_launches["c_portfolio"]["wavefront"] > 0, "(c) the harness launched no wavefront kernel")
        for k in ("wavefront", "visited_set.fingerprint_dedup_insert"):
            check(part_launches["c_device"][k] > 0, f"(c) kernel {k} was not launched by the harness")
        cli_in, cli_out = os.path.join(work, "cli_in"), os.path.join(work, "cli_results")
        os.makedirs(cli_in)
        for f in sorted(os.listdir(bench_in))[:4]:
            shutil.copy(os.path.join(bench_in, f), cli_in)
        run = subprocess.run(
            [sys.executable, "-m", "pushworld_tpu_torch.scripts.tools_cli", "benchmark", "--puzzles-path", cli_in,
             "--results-path", cli_out, "--planner", "batched", "--device", dev.type, "--time-limit", "60"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(run.returncode == 0, f"(c) tools_cli benchmark exited {run.returncode}: {run.stderr[-2000:]}")
        check(_check_yaml_results(cli_out, cli_in, name) == 4, "(c) tools_cli benchmark: not 4 results")
        lap("c_cli")

        # (d) The host tools, through the CLI, on (a)'s kept set.
        for mode in ([], ["--for-bfws"]):
            pddl = os.path.join(work, "pddl" + "".join(mode))
            check(tools_cli.main(["convert-to-pddl", pddl, "--puzzle-path", card_dir] + mode) == 0, "(d) pddl")
            for j in range(len(kept)):
                for suffix in ("_domain.pddl", "_problem.pddl"):
                    with open(os.path.join(pddl, f"puzzle_{j}{suffix}")) as f:
                        check(f.read().startswith("(define"), f"(d) puzzle_{j}{suffix} is no PDDL")
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            out["plot"] = "matplotlib not installed"
        else:
            png = os.path.join(work, "solved_vs_time.png")
            tools_cli.main(["plot", os.path.join(work, "results"), "--output", png, "--timeout", "60"])
            check(os.path.getsize(png) > 0, "(d) plot: no PNG")
            out["plot"] = "ok"
        previews = os.path.join(work, "previews")
        check(tools_cli.main(["render-previews", previews, "--puzzle-path", card_dir]) == 0, "(d) previews")
        check(len(os.listdir(previews)) == len(kept), "(d) not one preview a puzzle")
        for j, p in enumerate(kept):
            img = np.asarray(Image.open(os.path.join(previews, f"puzzle_{j}.png")))
            check(np.array_equal(img, p.render(p.initial_state)), f"(d) preview {j} != Puzzle.render")
        lap("d")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    launches = dict(LAUNCHES)
    for k in MAIN_PATH_KERNELS:
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the toolkit's path")
    out.update(launches=launches, launches_by_part=part_launches, total_s=time.monotonic() - t0, seconds=seconds)
    emit(out)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated 47x54 puzzle")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pushworld_tpu_torch")):
        print("chip_smoke: run from a checkout holding pushworld_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    # The host compiler builds the native planner beside the nvcc builds.
    import threading

    from pushworld_tpu_torch.native import bridge

    t = time.monotonic()
    native_build = threading.Thread(target=bridge.is_available)
    native_build.start()
    floor_build = start_launch_floor_build()
    libs = _build.build(verbose=True)
    nvcc_s = time.monotonic() - t
    native_build.join()
    nvcc = [ln for ln in subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, timeout=60,
                                        check=True).stdout.splitlines() if "release" in ln]
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": time.monotonic() - t, "nvcc_seconds": nvcc_s,
          "nvcc_version": nvcc[-1], "driver_version": driver, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})

    generated = Puzzle.from_text(generated_puzzle_text(args.seed))
    check((generated.height, generated.width) == (47, 54), "generated puzzle is not 47x54")
    floor = measure_launch_floor(*floor_build)
    kernels = [phase_wavefront(generated, dev)]
    kernels += phase_visited_set(dev, floor, generated)
    kernels += phase_rgd_novelty(generated, args.seed, dev, floor)
    kernels += phase_iteration_kernels(generated, dev, floor)

    files = sorted(glob.glob(os.path.join(ROOT, "tests", "puzzles", "*.pwp"))
                   + glob.glob(os.path.join(ROOT, "tests", "puzzles", "heur", "*.pwp")))
    puzzles = [(os.path.relpath(f, os.path.join(ROOT, "tests", "puzzles"))[:-4], Puzzle.from_file(f))
               for f in files]
    check(len(puzzles) == 28, f"expected 28 fixtures, found {len(puzzles)}")
    launches, solve_classes, solve_plans = phase_solve(puzzles, generated, dev)
    wide, wide_launches = phase_many_objects(dev, floor, generated)
    hard = Puzzle.from_text(HARD_PUZZLE_TEXT)
    chunk_launches = phase_chunk(generated, hard, args.seed, dev)
    phase_cpu_agreement(puzzles, dev)
    graphs_launches = phase_graphs(puzzles, generated, dev)
    envs_launches = phase_envs(puzzles, generated, dev)
    phase_native(puzzles, generated, dev)
    by_phase = {"solve": launches, "many_objects": wide_launches, "chunk": chunk_launches,
                "graphs": graphs_launches, "envs": envs_launches,
                "portfolio": phase_portfolio(puzzles, generated, hard, dev),
                "fleet": phase_fleet(puzzles, generated, hard, solve_classes, dev),
                "parallel": phase_parallel(puzzles, generated, solve_plans, dev),
                "tools": phase_tools(args.seed, dev)}

    # ``launches`` is the solve phase's count (``solve_puzzle`` on the 29
    # puzzles); ``launches_by_phase`` adds the search chunk, the graph ops, the environments,
    # the portfolio's two passes, the fleet's device-only run, the parallel
    # layer and the toolkit, each counted from 0.
    for k in kernels:
        if k["name"] in wide:  # the lanes at 32 (one-word path), 33, 64 and 100 objects
            k["wide"] = wide[k["name"]]
            k["max_abs_err"] = max([k["max_abs_err"]] + [lane["max_abs_err"] for lane in wide[k["name"]].values()])
        k["launches"] = launches.get(k["name"], 0)
        k["launches_by_phase"] = {ph: c.get(k["name"], 0) for ph, c in by_phase.items()}
        k["main_path_form"] = OFF_MAIN_PATH.get(k["name"])
    emit({"phase": "traced_launches", "readings": TRACED_LAUNCHES,
          "short": [r for r in TRACED_LAUNCHES if min(r["traced"].values()) < r["calls"]]})
    emit({"kernels": [{key: k.get(key) for key in (
        "name", "route", "source", "replaces", "launches", "launches_by_phase", "max_abs_err",
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes_bound_ms", "library_ms",
        "library_device_ms", "closed_gate_device_ms", "main_path_form", "wide")}
        for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
