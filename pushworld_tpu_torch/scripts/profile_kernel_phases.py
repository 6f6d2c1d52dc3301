"""Where the search iteration's hand kernels spend their time on the card.

``python -m pushworld_tpu_torch.scripts.profile_kernel_phases PUZZLE.pwp
[--kernels expand,append,rgd,novelty,insert,delete,render] [--depth D] [--kernels-dir DIR] [--tag NAME]``
(``--kernels render`` alone takes no puzzle)

The card's machine has no ``ncu``, so a kernel is split into phases by
timing copies of its source that return at successive points.  A source
marks its points with ``PW_STOP(k, value)  // phase: label`` (a no-op in the
normal build); a build with ``-DPW_STOP_AT=k`` returns at point k, after a
store that keeps ``value`` (and the work behind it) from being optimised
away.  A mark ``PW_NEXT(k, value)`` inside a loop (the persistent framed
render's loop over states and slabs) skips the rest of that pass instead
and goes on with the next.  A source that names ``PW_NO_BULK`` is built
once more with it, which takes its bulk copies out (stop -1).  Sources
without marks (each of the four as it stood before its Hopper redesign,
and the framed render as one CTA a state) get the marks of
``LEGACY_STOPS`` inserted at the lines named there; a source with neither
is timed whole.  ``--kernels-dir``
takes the sources from another tree (a checkout of the parent; its headers
are found there); the expansion's, the append's, RGD's and the visited
set's C interfaces must be this tree's, and the novelty source may export either
this tree's two launches (``pw_novelty_score_records``,
``pw_novelty_absorb_records``) or the earlier pair (``pw_novelty_score``,
``pw_novelty_absorb``).  All the threads of a cluster stop at the same
point, so a mark in a cluster kernel lies where every thread passes.

The inputs are the search's own: the puzzle's batched search at the
production capacities (``--depth``, default 0), run for up to 8 iterations,
then one iteration's select, expansion, dedup and scores, as ``chip_smoke.py``
phase ``iteration_kernels`` takes them: the expansion gets the selected
parents, the novelty kernels and RGD the children with the iteration's own
``is_new`` mask as ``valid`` (novelty from the tables as they were before
that iteration's update: the cells it sets are zeroed again before each
call), and the append the
whole iteration's outputs (its state restored before each call).  The
visited set's two probes (``insert``, ``delete``: valid flag and key, then
the window, then the CAS) are timed at each of ``PROBE_LOADS`` (0, 0.5 and
0.75): a 2^21-slot table filled to that share by the plain version, a tenth of the filled keys
deleted again (tombstones on the probe paths); the insert on batches of
1,024 fresh keys (each variant from a copy of that table), the delete on
batches of 1,024 keys that the plain version inserted first.  Every copy
is built in parallel (one ``nvcc`` each), loaded in place of the package's
library and timed under ``torch.profiler`` (the device time of the kernels
whose names hold the kernel's profiler name, ``--reps`` calls, by kernel).
The framed render (``render``) is timed on the 47 x 54 stacked level-0
pool (``pwbench/configs/level0``) at B = 4,096 states (``RENDER_BATCH``)
after 24 steps of ``VectorEnv``, beside a fill of the same output (``zero_``); it
has no gate.  A closed gate is timed on the whole kernels: the gate closed
for the expansion, the append and the delete, an all-false ``valid`` for
RGD, novelty and the insert.  ``--no-stops`` builds and times the whole kernels
only.  Prints one JSON line: per kernel (and load), the device ms at each
stop, of the whole kernel and of a closed gate, and ptxas's register,
spill and shared-memory lines.
Needs a CUDA device.
"""

import argparse
import ctypes
import itertools
import json
import re
import subprocess
import time
from pathlib import Path

# Kernel -> (source, library, profiler name: a part of the kernels' names).
KERNELS = {
    "expand": ("expand.cu", "expand", "expand_kernel"),
    "append": ("frontier.cu", "frontier", "append_kernel"),
    "rgd": ("rgd.cu", "rgd", "rgd_kernel"),
    "novelty": ("novelty.cu", "novelty", "novelty_"),
    "insert": ("visited_set.cu", "visited_set", "probe_and_insert_kernel"),
    "delete": ("visited_set.cu", "visited_set", "probe_delete_kernel"),
    "render": ("render.cu", "render", "render_onehot_framed_kernel"),
}
SEARCH_KERNELS = ("expand", "append", "rgd", "novelty", "insert", "delete")
RENDER_BATCH = 4096  # the framed render's states: the gym cell's rollouts
PROBE_KERNELS = ("insert", "delete")
PROBE_LOADS = (0.0, 0.5, 0.75)
# A stop of a source without marks: (label, the exact text after which the
# mark goes, the value the mark keeps).  The first occurrence of the text.
LEGACY_STOPS = {
    "expand": [
        ("gate, parent pointer", "  const int* pos = e.parents + static_cast<size_t>(b) * n * 2;\n", "pos[0]"),
        ("push relation", "    push[i][t] = mask;\n  }\n", "push[0][t]"),
        ("closure", "    todo |= fresh;\n  }\n", "static_cast<int>(reached)"),
        ("static block", "  const unsigned moved = nothing ? 0u : (reached & live);\n", "static_cast<int>(moved)"),
    ],
    "append": [
        ("cursors, is_new", "  for (int l = lo; l < hi; ++l) mine += a.is_new[l] != 0;\n", "mine + cursor0 + ring0"),
        ("block scan", "  int rank = block_exclusive_scan(mine, &n_new, sh);  // its barriers publish the zeros above\n",
         "rank + n_new"),
        ("lanes: records, keys, window", "      a.fkey[p] = a.keys[l];\n    }\n  }\n", "n_deeper"),
        ("state copy", "    if (p < a.F) a.states[static_cast<size_t>(ring0) * row + i] = a.children[i];\n  }\n", "0"),
        ("counts, barrier", "  __syncthreads();\n  if (tid == 0) {\n    const int cap", None),
    ],
    "rgd": [
        ("valid, positions, CTA barrier", "  if (tid == 0) a0_done = m_done = 0u;\n  __syncthreads();\n", "s.Q[0]"),
        ("goal moves, pushers' moves, goal rows",
         "  for (int r = 1; r < s.nr; ++r) pushers |= 1u << r;\n  __syncthreads();\n",
         "s.EOK[0] + static_cast<int>(s.GD[0]) + static_cast<int>(goal_rows)"),
        ("depth-0 agent costs (A0 rows)", "  ensure_a0(t, s, goal_rows, &a0_done);\n", "static_cast<int>(s.A0[4])"),
        ("deep states: pushers' A0 rows, first M rows",
         "          ensure_m(t, s, D == 1 ? 1u << o : (pushers | 1u << o), &m_done);\n",
         "static_cast<int>(s.M[0] + s.A0[0])"),
    ],
    "novelty": [
        ("score: valid, atoms",
         "  load_atoms(at, states, moved, b, n, H, W, static_cast<unsigned>(side - 1), lane);\n",
         "at.cell[lane & 31]"),
        ("score: seen_pos gathers, vote",
         "  if (__any_sync(0xFFFFFFFFu, unseen)) {\n    if (lane == 0) out[b] = 1.0f;\n    return;\n  }\n",
         "static_cast<int>(at.bucket[lane & 31])"),
        ("absorb: valid, atoms",
         "  if (b >= B || !valid[b]) return;\n  Atoms& at = atoms[threadIdx.x >> 5];\n"
         "  load_atoms(at, states, moved, b, n, H, W, static_cast<unsigned>(side - 1), lane);\n",
         "at.cell[lane & 31]"),
        ("absorb: seen_pos scatter",
         "  if (lane < n && at.moved[lane]) seen_pos[static_cast<size_t>(lane) * H * W + at.cell[lane]] = 1;\n", "0"),
    ],
    # The framed kernel as a CTA a state: its stages before its stores.
    "render": [
        ("base staged", "  const int4 g = r.geom[p];\n  __syncthreads();\n", "grid[t % HW]"),
        ("movables' atomicMax",
         "    atomicMax(grid + at, ((k + 1) << 8) | (grid[at] & 0xFF));\n  }\n  __syncthreads();\n", "grid[t % HW]"),
        ("channel bits", "  to_channel_bits(grid, HW, r.obj_class + p * r.n, t, T);\n  __syncthreads();\n",
         "grid[t % HW]"),
    ],
}
STOP_PRELUDE = """#ifdef PW_STOP_AT
__device__ int pw_stop_sink;
#define PW_STOP(k, v) do { if (PW_STOP_AT == (k)) { if ((v) == 0x5EED5EED) pw_stop_sink = 1; return; } } while (0)
#define PW_NEXT(k, v) if (PW_STOP_AT != (k)) {} else { if ((v) == 0x5EED5EED) pw_stop_sink = 1; continue; }
#else
#define PW_STOP(k, v)
#define PW_NEXT(k, v)
#endif
"""
MARK = re.compile(r"PW_(?:STOP|NEXT)\((\d+),.*//\s*phase:\s*(.+)$", re.M)
_vp, _i = ctypes.c_void_p, ctypes.c_int
# The novelty sources' entry points, either interface: the score leaving
# records for the update, or (the earlier pair) both reading the states.
NOVELTY_SIGNATURES = {
    "pw_novelty_score_records": [_vp] * 7 + [_i] * 5 + [_vp],
    "pw_novelty_absorb_records": [_vp] * 4 + [_i] * 5 + [_vp],
    "pw_novelty_score": [_vp] * 6 + [_i] * 5 + [_vp],
    "pw_novelty_absorb": [_vp] * 5 + [_i] * 5 + [_vp],
}


def _stops(kernel: str, text: str):
    """(text with marks, [(k, label)]) of a source."""
    # A source's kernels may share a mark (visited_set.cu's two probes).
    marked = list(dict((int(k), label.strip()) for k, label in MARK.findall(text)).items())
    if marked or kernel not in LEGACY_STOPS:
        return text, marked
    stops = []
    for k, (label, anchor, value) in enumerate(LEGACY_STOPS[kernel], start=1):
        if anchor not in text:
            raise ValueError(f"{kernel}: no line {anchor!r} in the source")
        if value is None:  # the mark goes between the anchor's first line and the rest
            head, tail = anchor.split("\n", 1)
            text = text.replace(anchor, f"{head}\n  PW_STOP({k}, 0);\n{tail}", 1)
        else:
            text = text.replace(anchor, f"{anchor}  PW_STOP({k}, {value});\n", 1)
        stops.append((k, label))
    return text, stops


def _build_variants(kernels, kernels_dir: Path, tag: str, stops=True):
    """Starts nvcc on every stop of every kernel (with ``stops``) and on the
    whole kernels; returns {kernel: [(k, label, library, process)]} (k = 0:
    the whole)."""
    from pushworld_tpu_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in kernels:
        text, marks = _stops(kernel, (kernels_dir / KERNELS[kernel][0]).read_text())
        src = out_dir / f"{kernel}-{tag}.cu"
        src.write_text(STOP_PRELUDE + text)
        procs[kernel] = []
        # A source that writes by bulk copies builds once more without them
        # (-DPW_NO_BULK): stop -1, the threads' work alone.
        bulk = [(-1, "whole kernel, no bulk copies")] if stops and "PW_NO_BULK" in text else []
        for k, label in [(0, "whole kernel"), *(marks if stops else []), *bulk]:
            lib = out_dir / f"lib{kernel}-{tag}-{k}.so"
            flags = ["-DPW_NO_BULK"] if k < 0 else ([f"-DPW_STOP_AT={k}"] if k else [])
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, f"-I{kernels_dir}", "-o", str(lib), str(src)]
            procs[kernel].append((k, label, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def _clone(s):
    import dataclasses

    from pushworld_tpu_torch.ops.hashset import HashSet

    out = dataclasses.replace(s, graph=None, **{k: v.clone() for k, v in vars(s).items()
                                               if k != "graph" and hasattr(v, "clone")})
    out.visited = HashSet(keys=s.visited.keys.clone(), capacity_bits=s.visited.capacity_bits)
    out.novelty = dataclasses.replace(s.novelty, seen_pos=s.novelty.seen_pos.clone(),
                                      pair_table=s.novelty.pair_table.clone())
    return out


def _device_ms(fn, name: str, reps: int) -> dict:
    """Device ms per call of each kernel whose name holds ``name``, over
    ``reps`` calls: {kernel name: ms}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    fn()
    for _ in range(3):  # a trace now and then holds no device time
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hit = {e.key: dev_us(e) / 1e3 / reps for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key}
        if hit:
            return hit
    raise RuntimeError(f"the profiler saw no {name}")


def _inputs(puzzle, depth: int, dev):
    """One iteration's inputs of the puzzle's search, after up to 8
    iterations: (planner, state, the append's inputs, the selected parents,
    the novelty tables before this iteration's update, its moved masks)."""
    from pushworld_tpu_torch.ops.hashset import fingerprint_dedup_insert
    from pushworld_tpu_torch.ops.novelty import novelty_score_and_update
    from pushworld_tpu_torch.ops.rgd import rgd_heuristic_with_flags
    from pushworld_tpu_torch.ops.step import expand_and_test
    from pushworld_tpu_torch.search import batched
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    pl = batched.BatchedPlanner(puzzle, max_depth=depth, device=dev, **PRODUCTION_CAPACITIES)
    cfg, t, cp = pl.config, pl.tables, pl.cp_dev
    s = pl.init_state()
    for _ in range(8):
        nxt = _clone(s)
        batched._iterate(cp, t, cfg, nxt)
        if not bool(batched._active(cfg, nxt)):
            break
        s = nxt
    w = _clone(s)
    tables = (w.novelty.seen_pos.clone(), w.novelty.pair_table.clone())
    parents, parent_hist, sel_valid, gate = batched.select_and_gate(cfg, w)
    children, moved, effective, goal = expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)
    keys, is_new = fingerprint_dedup_insert(w.visited, children, cp.width, effective, gate)
    nov, _ = novelty_score_and_update(w.novelty, children, moved, is_new)
    rgd, deeper = rgd_heuristic_with_flags(t, children, max_depth=depth, valid=is_new)
    args = dict(gate=gate, is_new=is_new, parent_hist=parent_hist, actions=None, goal=goal, nov=nov, rgd=rgd,
                deeper=deeper, sel_valid=sel_valid, children=children, keys=keys)
    return pl, w, args, parents, tables, moved


def _probe_tables(dev, loads, reps: int, bits: int = 21, B: int = 1024, seed: int = 0):
    """{load: (table, the same table holding every batch, batches)}: a table
    of 2^bits slots filled to ``load`` by the plain version, a tenth of the
    filled keys deleted again, and ``reps + 1`` batches of B fresh keys."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.ops import hashset as hs

    rng = np.random.default_rng(seed)
    out = {}
    for load in loads:
        base = hs.init_hashset(bits, device=dev)
        filled = torch.as_tensor(rng.integers(1, (1 << 63) - 1, size=int(load * (1 << bits)), dtype=np.int64),
                                 device=dev)
        hs.probe_and_insert_reference(base, filled, torch.ones_like(filled, dtype=torch.bool))
        hs.probe_delete_reference(base, filled, torch.as_tensor(rng.random(len(filled)) < 0.1, device=dev))
        batches = torch.as_tensor(rng.integers(1, (1 << 63) - 1, size=(reps + 1, B), dtype=np.int64), device=dev)
        present = hs.HashSet(keys=base.keys.clone(), capacity_bits=bits)
        for keys in batches:
            hs.probe_and_insert_reference(present, keys, torch.ones(B, dtype=torch.bool, device=dev))
        out[load] = (base, present, batches)
    return out


def _probe_call(kernel: str, tables):
    """A call of the insert or the delete wrapper on a copy of the load's
    table, a batch a call (cycling): open, or closed (no valid key for the
    insert, a closed gate for the delete)."""
    import torch

    from pushworld_tpu_torch.ops import hashset as hs

    base, present, batches = tables
    src = base if kernel == "insert" else present
    table = hs.HashSet(keys=src.keys.clone(), capacity_bits=src.capacity_bits)
    dev = batches.device
    ones = torch.ones(batches.shape[1], dtype=torch.bool, device=dev)
    closed = torch.zeros((), dtype=torch.bool, device=dev)
    it = itertools.cycle(range(len(batches)))

    def call(open_):
        keys = batches[next(it)]
        if kernel == "insert":
            hs.probe_and_insert(table, keys, ones if open_ else ones & closed)
        else:
            hs.probe_delete(table, keys, ones, None if open_ else closed)
    return call


def _novelty_call(t, changed, children, moved, valid, out, record):
    """Calls the novelty source's entry points on the loaded library (either
    interface) on the tables ``t`` as they were before the iteration's
    update: the cells in ``changed`` (those that update sets) are zeroed
    again first, which leaves the cache as the iteration has it."""
    import torch

    from pushworld_tpu_torch.kernels import _build, launch_on

    lib = _build._LOADED["novelty"]
    t.seen_pos.view(-1)[changed[0]] = False
    t.pair_table.view(torch.int16).view(-1)[changed[1]] = 0
    ptrs = (children.data_ptr(), moved.data_ptr(), valid.data_ptr(), t.seen_pos.data_ptr(), t.pair_table.data_ptr())
    tables = (t.seen_pos.data_ptr(), t.pair_table.data_ptr())
    dims = (moved.shape[0], moved.shape[1], t.height, t.width, t.side)
    if _has(lib, "pw_novelty_score_records"):
        calls = [(lib.pw_novelty_score_records, (*ptrs, out.data_ptr(), record.data_ptr(), *dims)),
                 (lib.pw_novelty_absorb_records, (valid.data_ptr(), record.data_ptr(), *tables, *dims))]
    else:
        calls = [(lib.pw_novelty_score, (*ptrs, out.data_ptr(), *dims)), (lib.pw_novelty_absorb, (*ptrs, *dims))]
    for fn, args in calls:
        rc = launch_on(children.device, fn, *args)
        if rc != 0:
            raise RuntimeError(f"novelty launch failed: CUDA error {rc}")


def _has(lib, symbol: str) -> bool:
    try:
        getattr(lib, symbol)
    except AttributeError:
        return False
    return True


def _render_call(dev, B: int, frame=(47, 54)):
    """(a call of the framed render on the stacked level-0 pool, B states
    after 24 steps of ``VectorEnv``, into one output; a fill of that
    output)."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_batch
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.envs.vector_env import VectorEnv
    from pushworld_tpu_torch.ops import render

    root = Path(__file__).resolve().parents[2] / "pwbench" / "configs" / "level0"
    pool = [Puzzle.from_file(str(f)) for f in sorted(root.glob("*.pwp"))]
    cp = compile_batch(pool)
    tables = render.compile_framed_render_tables(pool, frame, n=cp.n, device=dev)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, len(pool), B).astype(np.int32), device=dev)
    env = VectorEnv(cp, max_steps=10, device=dev)
    st = env.reset(None, B, idx)
    for _ in range(24):
        st, pos, _, _, _ = env.step(st, torch.as_tensor(rng.integers(0, 4, B), device=dev))
    out = torch.empty((B, *frame, 6), dtype=torch.float32, device=dev)
    return (lambda open_: render.render_framed_onehot_batched(tables, pos, idx, out=out)), out.zero_


def _search_calls(args, dev, out: dict) -> dict:
    """{kernel: call(open_)} of the search kernels on the puzzle's iteration
    inputs (``_inputs``); adds the iteration's counts to ``out``."""
    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd, step
    from pushworld_tpu_torch.search import batched

    pl, w, app, parents, tables, moved = _inputs(Puzzle.from_file(args.puzzle), args.depth, dev)
    cfg, t, cp = pl.config, pl.tables, pl.cp_dev
    closed = torch.zeros((), dtype=torch.bool, device=dev)
    none_valid = torch.zeros_like(app["is_new"])
    scalars = {f: getattr(w, f).clone() for f in ("ring_cursor", "hist_cursor", "solved", "solved_hist",
                                                  "iterations", "expansions", "needs_deeper")}

    def append(open_):
        for f, v in scalars.items():
            getattr(w, f).copy_(v)
        batched.append_children(w, cfg, **dict(app, gate=app["gate"] if open_ else closed))

    def expand(open_):
        step.expand_and_test(cp, t.contacts, t.contacts_mask, parents, app["sel_valid"],
                             app["gate"] if open_ else closed)

    def rgd_call(open_):
        rgd.rgd_heuristic_with_flags(t, app["children"], args.depth, app["is_new"] if open_ else none_valid)

    nov_out = torch.empty_like(app["nov"])
    record = torch.empty((*moved.shape, 2), dtype=torch.int32, device=dev)
    # The cells this iteration's update sets (all 0 before it): what a call
    # restores.
    changed = (torch.nonzero(w.novelty.seen_pos.view(-1) != tables[0].view(-1)).flatten(),
               torch.nonzero(w.novelty.pair_table.view(torch.int16).view(-1)
                             != tables[1].view(torch.int16).view(-1)).flatten())
    w.novelty.seen_pos.copy_(tables[0])
    w.novelty.pair_table.copy_(tables[1])

    def novelty_call(open_):
        _novelty_call(w.novelty, changed, app["children"], moved.contiguous(),
                      app["is_new"] if open_ else none_valid, nov_out, record)

    out.update(new_children=int(app["is_new"].sum()), live_parents=int(app["sel_valid"].sum()),
               lanes=int(app["is_new"].shape[0]))
    return {"expand": expand, "append": append, "rgd": rgd_call, "novelty": novelty_call}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("puzzle", nargs="?", help="path of a .pwp puzzle file (the search kernels)")
    ap.add_argument("--kernels", default=",".join(KERNELS), help="the kernels to split, comma-separated")
    ap.add_argument("--kernels-dir", default=None, help="the .cu sources to split (default: the package's)")
    ap.add_argument("--tag", default="tree", help="name of this tree's builds and row")
    ap.add_argument("--depth", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-stops", action="store_true", help="time the whole kernels only")
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}; known: {sorted(KERNELS)}")
    search = set(kernels) & set(SEARCH_KERNELS)
    if search and args.puzzle is None:
        ap.error(f"the kernels {sorted(search)} need a puzzle")

    import torch

    from pushworld_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    kernels_dir = Path(args.kernels_dir) if args.kernels_dir else _build.KERNEL_DIR
    t0 = time.monotonic()
    procs = _build_variants(kernels, kernels_dir, args.tag, not args.no_stops)
    _build.build()
    out = {"puzzle": args.puzzle, "tag": args.tag, "kernels_dir": str(kernels_dir), "depth": args.depth,
           "device": torch.cuda.get_device_name(0)}
    calls = {}
    if "render" in kernels:
        calls["render"], fill = _render_call(dev, RENDER_BATCH)
        out["render_batch"] = RENDER_BATCH
        out["render_fill_device_ms"] = sum(_device_ms(fill, "elementwise", args.reps).values())
    if search:
        calls.update(_search_calls(args, dev, out))
    probe = _probe_tables(dev, PROBE_LOADS, args.reps) if set(kernels) & set(PROBE_KERNELS) else {}
    for kernel, variants in procs.items():
        _, library, prof_name = KERNELS[kernel]
        by_load, ptxas = {}, []
        for k, label, lib_path, proc in variants:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                for other in procs.values():
                    for *_, p in other:
                        p.kill()
                raise RuntimeError(f"nvcc failed for {kernel} stop {k}:\n{log}")
            lib = ctypes.CDLL(str(lib_path))
            signatures = NOVELTY_SIGNATURES if library == "novelty" else _build.SIGNATURES[library]
            for fn, argtypes in signatures.items():
                if _has(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
            saved = _build._LOADED.get(library)
            _build._LOADED[library] = lib
            try:
                # The probes: each load from a fresh copy of its table.
                for load in PROBE_LOADS if kernel in PROBE_KERNELS else [None]:
                    call = _probe_call(kernel, probe[load]) if load is not None else calls[kernel]
                    by_kernel = _device_ms(lambda: call(True), prof_name, args.reps)
                    row = {"stop": k, "label": label, "device_ms": sum(by_kernel.values()), "by_kernel": by_kernel}
                    if k == 0 and kernel != "render":
                        row["closed_gate_device_ms"] = sum(
                            _device_ms(lambda: call(False), prof_name, args.reps).values())
                    by_load.setdefault(load, []).append(row)
                if k == 0:
                    ptxas = [ln.strip() for ln in log.splitlines()
                             if prof_name in ln or "registers" in ln or "spill" in ln]
            finally:
                if saved is None:
                    _build._LOADED.pop(library, None)
                else:
                    _build._LOADED[library] = saved
        out[kernel] = {"source": KERNELS[kernel][0], "ptxas": ptxas}
        if kernel in PROBE_KERNELS:
            out[kernel]["by_load"] = {str(load): rows for load, rows in by_load.items()}
        else:
            out[kernel]["stops"] = by_load[None]
    out["seconds"] = time.monotonic() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
