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

The card line (nvidia-smi) comes first; the kernels line comes just before
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
    for k in ("wavefront", "visited_set.probe_and_insert", "visited_set.probe_delete",
              "visited_set.fingerprint_dedup_insert"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched on the main path")
    gen = rows[-1]
    emit({"phase": "solve", "puzzles": len(rows), "total_s": total,
          "solved": sum(r["result"] == "solved" for r in rows),
          "no_solution": sum(r["result"] == "no solution" for r in rows),
          "generated": gen, "launches": launches, "per_puzzle": rows})
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

    t = time.monotonic()
    libs = _build.build(verbose=True)
    emit({"phase": "build", "seconds": time.monotonic() - t,
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
    launches = phase_solve(puzzles, generated, dev)
    phase_cpu_agreement(puzzles, dev)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
