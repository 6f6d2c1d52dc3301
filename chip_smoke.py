#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``pushworld_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.

Phases, each printing one JSON line:

1. ``build``: compiles every CUDA kernel of the port with nvcc (sm_90a), in
   parallel, and beside them the empty kernel that measures a launch.
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
   wherever no two lanes of one round ever shared a home slot.  The fused
   fingerprint + dedup + insert kernel gets batches of states with duplicate
   children, invalid lanes and keys already in the table, under the same
   rule, and is timed beside the three-step composition it replaces.
4. ``solve`` (the main path): the launch counts are set to 0, then
   ``solve_puzzle(mode="N+RGD", time_limit=60)`` runs on the card at the
   production capacities of ``plan_puzzles`` for every fixture under
   tests/puzzles and tests/puzzles/heur and for the 47 x 54 puzzle.  Every
   plan must pass the oracle; the unsolvable fixtures must report
   "no solution"; every kernel must have been launched.  Two small fixtures
   are also solved on the CPU and must give the same plan and expansions.
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
   alone in claim mode, with the defaults (shadow mode, one native worker per
   core) and with the device off; then a run in which every core holds a
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

The launch counts are set to 0 before each of the phases 4, 5, 6, 8, 9, 10
and 11 (and each fleet run) and read after it.  Beside ``ms`` (CUDA events around
the wrapper: for the small kernels the host's enqueue time) every kernel has
``device_ms``, its own time from ``torch.profiler``; an empty kernel, built
from a source in this script, is launched and timed the same two ways as the
floor of any launch, and it is the bound (``bound_by: "launch"``) of a kernel
whose bytes take less.  The card line (nvidia-smi) comes first; the kernels line comes just before
the last line, the result.
Any failure raises and the script exits non-zero.  It exits non-zero without
a result when there is no CUDA device or no port package beside it.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
UNSOLVABLE = {"no_solution", "overlap", "spill_grid_unreachable"}
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


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

KERNEL_NAMES = ("wavefront", "visited_set.probe_and_insert", "visited_set.probe_delete",
                "visited_set.fingerprint_dedup_insert")


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


def profile_device(fn, reps: int = 1) -> dict:
    """``fn`` called ``reps`` times under torch.profiler, as
    ``scripts/profile_search.py`` counts: wall seconds (host clock, ending in
    a synchronise), the device's busy microseconds, the number of device
    kernels (copies and memsets included) and [count, microseconds] by
    kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    check(len(rows) > 0, "torch.profiler recorded no device time")
    return {"wall_s": wall_s, "busy_us": sum(dev_us(e) for e in rows),
            "n_kernels": sum(e.count for e in rows),
            "by_kernel": {e.key: [e.count, dev_us(e)] for e in rows}}


def kernel_device_ms(prof: dict, *names: str, calls: int) -> float:
    """Device milliseconds per call of the kernels whose names contain one of
    ``names``, from a :func:`profile_device` result over ``calls`` calls."""
    hit = [v for k, v in prof["by_kernel"].items() if any(n in k for n in names)]
    check(len(hit) >= len(names), f"profiler saw no kernel named {names}: {sorted(prof['by_kernel'])}")
    return sum(us for _, us in hit) / 1e3 / calls


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
        err = max(err, (got - want).abs().max().item())
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
    err = max(err, (DG - DG_want).abs().max().item())
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
        err = max(err, (got - want).abs().max().item())
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
            it = iter(range(n_kern))
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


def phase_visited_set(dev, floor):
    """Insert/delete and fused kernels vs their plain versions; returns three
    kernels-line entries.  ``floor``: :func:`measure_launch_floor`'s result.  The insert's error is the largest ``is_new`` difference (0 or 1)
    on the compared lanes; the delete's is the number of keys by which the
    compared memberships differ after a round."""
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
    # each, and every delete launch removes keys that are in the table.
    n_kern, n_plain = 51, 6  # warm-up call + reps
    batches = rng.integers(1, (1 << 63) - 1, size=(n_kern, B), dtype=np.int64)
    check(len(np.unique(batches)) == batches.size, "timing keys repeat")
    batches = torch.as_tensor(batches, device=dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)

    def over_batches(fn, table):
        it = iter(range(len(batches)))
        return lambda: fn(table, batches[next(it)], valid)

    t1 = hs_mod.init_hashset(bits, device=dev)
    t2 = hs_mod.init_hashset(bits, device=dev)
    ins_ms = cuda_time_ms(over_batches(hs_mod.probe_and_insert, t1), reps=n_kern - 1)
    ins_plain = cuda_time_ms(over_batches(hs_mod.probe_and_insert_reference, t2), reps=n_plain - 1)
    del_ms = cuda_time_ms(over_batches(hs_mod.probe_delete, t1), reps=n_kern - 1)
    del_plain = cuda_time_ms(over_batches(hs_mod.probe_delete_reference, t2), reps=n_plain - 1)
    t3 = hs_mod.init_hashset(bits, device=dev)
    ins_dev = kernel_device_ms(profile_device(over_batches(hs_mod.probe_and_insert, t3), reps=n_kern),
                               "probe_and_insert_kernel", calls=n_kern)
    del_dev = kernel_device_ms(profile_device(over_batches(hs_mod.probe_delete, t3), reps=n_kern),
                               "probe_delete_kernel", calls=n_kern)
    for t in (t1, t2, t3):
        check(not ((t.keys != 0) & (t.keys != -1)).any(), "timed deletes left keys behind")
    fused = _fused_checks_and_times(dev, rng, bits, B)
    emit({"phase": "visited_set", "table_slots": 1 << bits, "batch": B,
          "race_free_lanes_compared": checked, "raced_lanes": raced,
          "insert_max_abs_err": ins_err, "delete_max_abs_err": del_err,
          "insert_ms": ins_ms, "insert_device_ms": ins_dev, "insert_plain_ms": ins_plain,
          "delete_ms": del_ms, "delete_device_ms": del_dev, "delete_plain_ms": del_plain,
          "fused": fused})
    common = {"route": "cuda", "source": "pushworld_tpu_torch/kernels/visited_set.cu",
              "library_ms": None}

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
    ]


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
    for k in KERNEL_NAMES:
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the main path")
    gen = rows[-1]
    emit({"phase": "solve", "puzzles": len(rows), "total_s": total,
          "solved": sum(r["result"] == "solved" for r in rows),
          "no_solution": sum(r["result"] == "no solution" for r in rows),
          "generated": gen, "launches": launches, "per_puzzle": rows})
    return launches, {r["puzzle"]: r["result"] for r in rows}, plans


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
    err = (D - want).abs().max().item()
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
    for k in KERNEL_NAMES:
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
    for k in KERNEL_NAMES:
        check(row["launches"].get(k, 0) > 0, f"fleet (a): kernel {k} was not launched")
    row["device_results"] = {n: [classes[n], results[n].planning_time] for n, _ in named
                             if results[n].solver == "device"}
    out["device_only_claim"] = row
    launches = row["launches"]

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
    for k in KERNEL_NAMES:
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
    for k in ("wavefront", "visited_set.probe_and_insert", "visited_set.fingerprint_dedup_insert"):
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
    iterations (its fused-insert launches: one an iteration)."""
    import pushworld_tpu_torch.search.planner as planner_mod
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search.batched import required_depth
    from pushworld_tpu_torch.tools.generate import generate_level0_puzzles

    results, depths, iterations = [], [], []
    solve = planner_mod.solve_puzzle
    fused = "visited_set.fingerprint_dedup_insert"

    def recording(puzzle, **kw):
        depths.append(required_depth(puzzle))
        before = LAUNCHES.get(fused, 0)
        results.append(solve(puzzle, **kw))
        iterations.append(LAUNCHES.get(fused, 0) - before)
        return results[-1]

    planner_mod.solve_puzzle = recording
    try:
        kept = generate_level0_puzzles(path, num_puzzles=16, random_seed=seed, time_limit=GEN_TIME_LIMIT,
                                       planner=planner, device=dev)
    finally:
        planner_mod.solve_puzzle = solve
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
        for k in ("wavefront", "visited_set.fingerprint_dedup_insert", "visited_set.probe_and_insert"):
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
    for k in KERNEL_NAMES:
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
    emit({"phase": "build", "seconds": time.monotonic() - t, "nvcc_seconds": nvcc_s,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})

    generated = Puzzle.from_text(generated_puzzle_text(args.seed))
    check((generated.height, generated.width) == (47, 54), "generated puzzle is not 47x54")
    floor = measure_launch_floor(*floor_build)
    kernels = [phase_wavefront(generated, dev)]
    kernels += phase_visited_set(dev, floor)

    files = sorted(glob.glob(os.path.join(ROOT, "tests", "puzzles", "*.pwp"))
                   + glob.glob(os.path.join(ROOT, "tests", "puzzles", "heur", "*.pwp")))
    puzzles = [(os.path.relpath(f, os.path.join(ROOT, "tests", "puzzles"))[:-4], Puzzle.from_file(f))
               for f in files]
    check(len(puzzles) == 28, f"expected 28 fixtures, found {len(puzzles)}")
    launches, solve_classes, solve_plans = phase_solve(puzzles, generated, dev)
    phase_cpu_agreement(puzzles, dev)
    graphs_launches = phase_graphs(puzzles, generated, dev)
    envs_launches = phase_envs(puzzles, generated, dev)
    phase_native(puzzles, generated, dev)
    hard = Puzzle.from_text(HARD_PUZZLE_TEXT)
    by_phase = {"solve": launches, "graphs": graphs_launches, "envs": envs_launches,
                "portfolio": phase_portfolio(puzzles, generated, hard, dev),
                "fleet": phase_fleet(puzzles, generated, hard, solve_classes, dev),
                "parallel": phase_parallel(puzzles, generated, solve_plans, dev),
                "tools": phase_tools(args.seed, dev)}

    # ``launches`` is the solve phase's count (``solve_puzzle`` on the 29
    # puzzles); ``launches_by_phase`` adds the graph ops, the environments,
    # the portfolio's two passes, the fleet's device-only run, the parallel
    # layer and the toolkit, each counted from 0.
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_phase"] = {ph: c.get(k["name"], 0) for ph, c in by_phase.items()}
    emit({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "launches_by_phase", "max_abs_err",
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes_bound_ms", "library_ms")}
        for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
