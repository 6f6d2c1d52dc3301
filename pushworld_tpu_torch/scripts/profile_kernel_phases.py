"""Where the expansion and the append kernels spend their time on the card.

``python -m pushworld_tpu_torch.scripts.profile_kernel_phases PUZZLE.pwp [--kernels-dir DIR] [--tag NAME]``

The card's machine has no ``ncu``, so a kernel is split into phases by
timing copies of its source that return at successive points.  A source
marks its points with ``PW_STOP(k, value)  // phase: label`` (a no-op in the
normal build); a build with ``-DPW_STOP_AT=k`` returns at point k, after a
store that keeps ``value`` (and the work behind it) from being optimised
away.  Sources without marks (``expand.cu`` and ``frontier.cu`` as PR 10
left them) get the marks of ``LEGACY_STOPS`` inserted at the lines named
there.  ``--kernels-dir`` takes the sources from another tree (a checkout of
the parent), whose C interfaces must be this tree's.

The inputs are the search's own: the puzzle's batched search at the
production capacities (``--depth``, default 0), run for up to 8 iterations,
then one iteration's select, expansion, dedup and scores (the append's
inputs), as ``chip_smoke.py`` phase ``iteration_kernels`` takes them.  Every
copy is built in parallel (one ``nvcc`` each), loaded in place of the
package's library and timed through the package's wrapper under
``torch.profiler`` (the kernel's own device time, ``--reps`` calls); the
append's state is restored before each call.  ``--no-stops`` builds and
times the whole kernels only.  Prints one JSON line: per kernel, the
device ms at each stop, of the whole kernel and of a closed gate, and
ptxas's register, spill and shared-memory lines.
Needs a CUDA device.
"""

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

# Kernel -> (source, C function, profiler name, stops).  A stop of a source
# without marks: (label, the exact text after which the mark goes, the
# value the mark keeps).
KERNELS = {
    "expand": ("expand.cu", "pw_expand", "expand_kernel"),
    "append": ("frontier.cu", "pw_frontier_append", "append_kernel"),
}
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
}
STOP_PRELUDE = """#ifdef PW_STOP_AT
__device__ int pw_stop_sink;
#define PW_STOP(k, v) do { if (PW_STOP_AT == (k)) { if ((v) == 0x5EED5EED) pw_stop_sink = 1; return; } } while (0)
#else
#define PW_STOP(k, v)
#endif
"""
MARK = re.compile(r"PW_STOP\((\d+),.*//\s*phase:\s*(.+)$", re.M)


def _stops(kernel: str, text: str):
    """(text with marks, [(k, label)]) of a source."""
    marked = [(int(k), label.strip()) for k, label in MARK.findall(text)]
    if marked:
        return text, marked
    stops = []
    for k, (label, anchor, value) in enumerate(LEGACY_STOPS[kernel], start=1):
        if value is None:  # the mark goes between the anchor's first line and the rest
            head, tail = anchor.split("\n", 1)
            if head + "\n" + tail not in text:
                raise ValueError(f"{kernel}: no line {anchor!r} in the source")
            text = text.replace(head + "\n" + tail, f"{head}\n  PW_STOP({k}, 0);\n{tail}", 1)
        else:
            if anchor not in text:
                raise ValueError(f"{kernel}: no line {anchor!r} in the source")
            text = text.replace(anchor, f"{anchor}  PW_STOP({k}, {value});\n", 1)
        stops.append((k, label))
    return text, stops


def _build_variants(kernels_dir: Path, tag: str, stops=True):
    """Starts nvcc on every stop of every kernel (with ``stops``) and on the
    whole kernels; returns {kernel: [(k, label, library, process)]} (k = 0:
    the whole)."""
    from pushworld_tpu_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, (src_name, _, _) in KERNELS.items():
        text, marks = _stops(kernel, (kernels_dir / src_name).read_text())
        src = out_dir / f"{kernel}-{tag}.cu"
        src.write_text(STOP_PRELUDE + text)
        procs[kernel] = []
        for k, label in [(0, "whole kernel"), *(marks if stops else [])]:
            lib = out_dir / f"lib{kernel}-{tag}-{k}.so"
            flags = [f"-DPW_STOP_AT={k}"] if k else []
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
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


def _device_ms(fn, name: str, reps: int) -> float:
    """Device ms per call of the kernels named ``name`` over ``reps`` calls."""
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
        hit = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and name in e.key]
        if hit:
            return sum(dev_us(e) for e in hit) / 1e3 / reps
    raise RuntimeError(f"the profiler saw no {name}")


def _inputs(puzzle, depth: int, dev):
    """One iteration's expansion and append inputs of the puzzle's search."""
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
    parents, parent_hist, sel_valid, gate = batched.select_and_gate(cfg, w)
    children, moved, effective, goal = expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)
    keys, is_new = fingerprint_dedup_insert(w.visited, children, cp.width, effective, gate)
    nov, _ = novelty_score_and_update(w.novelty, children, moved, is_new)
    rgd, deeper = rgd_heuristic_with_flags(t, children, max_depth=depth, valid=is_new)
    args = dict(gate=gate, is_new=is_new, parent_hist=parent_hist, actions=None, goal=goal, nov=nov, rgd=rgd,
                deeper=deeper, sel_valid=sel_valid, children=children, keys=keys)
    return pl, w, args, parents


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("puzzle", help="path of a .pwp puzzle file")
    ap.add_argument("--kernels-dir", default=None, help="the .cu sources to split (default: the package's)")
    ap.add_argument("--tag", default="tree", help="name of this tree's builds and row")
    ap.add_argument("--depth", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-stops", action="store_true", help="time the whole kernels only")
    args = ap.parse_args(argv)

    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import _build
    from pushworld_tpu_torch.ops import step
    from pushworld_tpu_torch.search import batched

    dev = torch.device("cuda", 0)
    kernels_dir = Path(args.kernels_dir) if args.kernels_dir else _build.KERNEL_DIR
    t0 = time.monotonic()
    procs = _build_variants(kernels_dir, args.tag, not args.no_stops)
    _build.build()
    pl, w, app, parents = _inputs(Puzzle.from_file(args.puzzle), args.depth, dev)
    cfg, t, cp = pl.config, pl.tables, pl.cp_dev
    closed = torch.zeros((), dtype=torch.bool, device=dev)
    scalars = {f: getattr(w, f).clone() for f in ("ring_cursor", "hist_cursor", "solved", "solved_hist",
                                                  "iterations", "expansions", "needs_deeper")}

    def append(gate):
        for f, v in scalars.items():
            getattr(w, f).copy_(v)
        batched.append_children(w, cfg, **dict(app, gate=gate))

    def expand(gate):
        step.expand_and_test(cp, t.contacts, t.contacts_mask, parents, app["sel_valid"], gate)

    calls = {"expand": expand, "append": append}
    out = {"puzzle": args.puzzle, "tag": args.tag, "kernels_dir": str(kernels_dir), "depth": args.depth,
           "device": torch.cuda.get_device_name(0), "new_children": int(app["is_new"].sum()),
           "live_parents": int(app["sel_valid"].sum()), "lanes": int(app["is_new"].shape[0])}
    source = {"expand": "expand", "append": "frontier"}
    for kernel, variants in procs.items():
        _, c_fn, prof_name = KERNELS[kernel]
        rows, ptxas = [], []
        for k, label, lib_path, proc in variants:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                for other in procs.values():
                    for *_, p in other:
                        p.kill()
                raise RuntimeError(f"nvcc failed for {kernel} stop {k}:\n{log}")
            lib = ctypes.CDLL(str(lib_path))
            for fn, argtypes in _build.SIGNATURES[source[kernel]].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            saved = _build._LOADED.get(source[kernel])
            _build._LOADED[source[kernel]] = lib
            try:
                row = {"stop": k, "label": label,
                       "device_ms": _device_ms(lambda: calls[kernel](app["gate"]), prof_name, args.reps)}
                if k == 0:
                    row["closed_gate_device_ms"] = _device_ms(lambda: calls[kernel](closed), prof_name, args.reps)
                    ptxas = [ln.strip() for ln in log.splitlines()
                             if prof_name in ln or "registers" in ln or "spill" in ln]
            finally:
                _build._LOADED[source[kernel]] = saved
            rows.append(row)
        out[kernel] = {"c_function": c_fn, "stops": rows, "ptxas": ptxas}
    out["seconds"] = time.monotonic() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
