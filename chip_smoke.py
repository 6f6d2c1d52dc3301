#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``pushworld_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.

Phases, each printing one JSON line:

1. ``build``: compiles every CUDA kernel of the port with nvcc (sm_90a), in
   parallel.
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
5. ``native``: the native serial planner, built from
   ``pushworld_tpu_torch/native/planner.cc`` by the host C++ compiler (the
   build starts beside the nvcc builds), must be available; it solves every
   solvable fixture in both modes and through the staged schedule, reports
   "no solution" on the unsolvable ones, and its movement-graph fixpoint
   must equal the Python worklist on every puzzle.  The table build of the
   47 x 54 puzzle is timed with either fixpoint.
6. ``portfolio``: ``plan_puzzles(portfolio=True, time_limit=60)`` on all 29
   puzzles, then a second pass with ``PW_PORTFOLIO_HEADSTART=0`` over two
   fixtures and a 16 x 16 puzzle that outlasts the native planner, in which
   the device member must engage.
7. ``fleet``: ``plan_puzzles_fleet`` on the 29 puzzles with the device worker
   alone in claim mode, with the defaults (shadow mode, one native worker per
   core) and with the device off; then a run in which every core holds a
   native worker on the 16 x 16 puzzle while the device worker shadows the
   fixtures, and the solve of the 47 x 54 puzzle timed alone and beside as
   many native threads as cores.  One lane's device bytes are measured
   beside ``fleet.bytes_per_lane``.

The launch counts are set to 0 before each of the phases 4, 6 and 7 (and
each fleet run) and read after it.  The card line (nvidia-smi) comes first; the kernels line comes just before
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
    # Bound of the function (a distance transform), not of this kernel's
    # sweeps: each input read once (the 4 shared bool mask planes, the f32
    # seeds), the f32 output written once; one visit per cell per field, 4
    # directions x (add + min).
    n_bytes = 4 * H * W + 2 * R * H * W * 4
    n_ops = 8 * R * H * W
    bound_s = max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_OPS_PER_S)
    emit({"phase": "wavefront", "grid": [H, W], "objects": puzzle.num_movables,
          "fields_checked": n_fields + len(goals), "timed_fields": R, "ms": ms,
          "plain_ms": plain_ms, "max_abs_err": err})
    return {
        "name": "wavefront", "route": "cuda",
        "source": "pushworld_tpu_torch/kernels/wavefront.cu",
        "replaces": "pushworld_tpu/ops/graphs_pallas.py:38",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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

        tables = [hs_mod.init_hashset(bits, device=dev) for _ in range(3)]
        out[f"n_obj_{n_obj}"] = {
            "ms": cuda_time_ms(over_batches(hs_mod.fingerprint_dedup_insert, tables[0]), reps=n_kern - 1),
            "three_step_composition_ms": cuda_time_ms(over_batches(three_steps, tables[1]), reps=n_kern - 1),
            "plain_ms": cuda_time_ms(
                over_batches(hs_mod.fingerprint_dedup_insert_reference, tables[2]), reps=n_plain - 1),
        }
    return out


def phase_visited_set(dev):
    """Insert/delete and fused kernels vs their plain versions; returns three
    kernels-line entries.  The insert's error is the largest ``is_new`` difference (0 or 1)
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
    for t in (t1, t2):
        check(not ((t.keys != 0) & (t.keys != -1)).any(), "timed deletes left keys behind")
    fused = _fused_checks_and_times(dev, rng, bits, B)
    emit({"phase": "visited_set", "table_slots": 1 << bits, "batch": B,
          "race_free_lanes_compared": checked, "raced_lanes": raced,
          "insert_max_abs_err": ins_err, "delete_max_abs_err": del_err,
          "insert_ms": ins_ms, "insert_plain_ms": ins_plain,
          "delete_ms": del_ms, "delete_plain_ms": del_plain, "fused": fused})
    # Bound: per lane the key (8 B), its flag (1 B), one table word read
    # (8 B) and one written (8 B), plus is_new (1 B) for the insert.
    common = {"route": "cuda", "source": "pushworld_tpu_torch/kernels/visited_set.cu",
              "bound_by": "bytes", "library_ms": None}
    return [
        dict(common, name="visited_set.probe_and_insert",
             replaces="pushworld_tpu/ops/hashset.py:106", ms=ins_ms, plain_ms=ins_plain,
             max_abs_err=ins_err, bound_ms=B * 26 / H100_BYTES_PER_S * 1e3),
        dict(common, name="visited_set.probe_delete",
             replaces="pushworld_tpu/ops/hashset.py:158", ms=del_ms, plain_ms=del_plain,
             max_abs_err=del_err, bound_ms=B * 25 / H100_BYTES_PER_S * 1e3),
        # Per lane: the state (8N B) and its flag read, the key (8 B) and
        # is_new (1 B) written, one table word read and one written.
        dict(common, name="visited_set.fingerprint_dedup_insert",
             replaces="pushworld_tpu/ops/hashset.py:54,83,106",
             ms=fused["n_obj_4"]["ms"], plain_ms=fused["n_obj_4"]["plain_ms"],
             max_abs_err=fused["max_abs_err"],
             bound_ms=B * (8 * 4 + 26) / H100_BYTES_PER_S * 1e3),
    ]


def phase_solve(puzzles, generated, dev):
    """The main path: solve_puzzle on the card for every puzzle."""
    import torch

    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES, solve_puzzle

    LAUNCHES.clear()
    t0 = time.monotonic()
    rows = []
    for name, p in puzzles + [("generated_47x54", generated)]:
        t = time.monotonic()
        r = solve_puzzle(p, mode="N+RGD", time_limit=60, device=dev, **PRODUCTION_CAPACITIES)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
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
    return launches, {r["puzzle"]: r["result"] for r in rows}


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
    libs = _build.build(verbose=True)
    nvcc_s = time.monotonic() - t
    native_build.join()
    emit({"phase": "build", "seconds": time.monotonic() - t, "nvcc_seconds": nvcc_s,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})

    generated = Puzzle.from_text(generated_puzzle_text(args.seed))
    check((generated.height, generated.width) == (47, 54), "generated puzzle is not 47x54")
    kernels = [phase_wavefront(generated, dev)]
    kernels += phase_visited_set(dev)

    files = sorted(glob.glob(os.path.join(ROOT, "tests", "puzzles", "*.pwp"))
                   + glob.glob(os.path.join(ROOT, "tests", "puzzles", "heur", "*.pwp")))
    puzzles = [(os.path.relpath(f, os.path.join(ROOT, "tests", "puzzles"))[:-4], Puzzle.from_file(f))
               for f in files]
    check(len(puzzles) == 28, f"expected 28 fixtures, found {len(puzzles)}")
    launches, solve_classes = phase_solve(puzzles, generated, dev)
    phase_cpu_agreement(puzzles, dev)
    phase_native(puzzles, generated, dev)
    hard = Puzzle.from_text(HARD_PUZZLE_TEXT)
    by_phase = {"solve": launches,
                "portfolio": phase_portfolio(puzzles, generated, hard, dev),
                "fleet": phase_fleet(puzzles, generated, hard, solve_classes, dev)}

    # ``launches`` is the solve phase's count (``solve_puzzle`` on the 29
    # puzzles); ``launches_by_phase`` adds the portfolio's two passes and the
    # fleet's device-only run, each counted from 0.
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_phase"] = {ph: c.get(k["name"], 0) for ph, c in by_phase.items()}
    emit({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "launches_by_phase", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
