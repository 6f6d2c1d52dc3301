"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, the result line.

    python pwbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

- Set-up (``setup_s``): from the start of ``run.py`` to the start of the
  window: imports, the kernels' build or load, the pool, the driver's
  warm-up on the cell's own shapes.  A run that built kernels (a
  checkout's first, which pays nvcc) says so: ``kernels_built`` true, and
  the libraries it built under ``setup_phases.built``.
- The window: the driver runs the cell's traffic for ``--seconds``.
- With ``--trace 1``: NVML's utilization is sampled through the window, and
  a short slice of the same traffic runs under torch.profiler after it;
  the line then carries the cell's per-layer metrics, else its end-to-end
  ones.
- ``memory_peak_bytes`` is read, the program's state freed, and only then
  does the reference judge what the window produced.

Exit codes: 0 with a result line; 2 without the cards the cell asks for; 3
when a module of JAX or of the JAX package is loaded; 1 on any error.  No
result line is printed unless the exit code is 0.
"""

import argparse
import gc
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from . import cell as cells
from .trace import Trace, record

FORBIDDEN = ("jax", "jaxlib", "flax", "pushworld_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN` (``pushworld_tpu_torch`` is not ``pushworld_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def built_libraries() -> set:
    """The program's built libraries in the checkout (``.torch_ext_build/``,
    where it builds its kernels at first use)."""
    return {p.name for p in (cells.ROOT / ".torch_ext_build").glob("*.so")}


@dataclass
class Run:
    """What a driver and the metric readers share."""

    cell: cells.Cell
    seed: int
    seconds: float
    trace_on: bool
    device: object
    setup_s: float = 0.0
    window: dict = field(default_factory=dict)
    trace: Optional[Trace] = None
    utilization: Optional[list] = None
    traced: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None, device: str = "cuda", benchmark: Optional[dict] = None,
         bench=cells.BENCH) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = cells.resolve(args.workload, benchmark, bench)

    import torch

    t_import = time.perf_counter()
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"pwbench: {cell.name} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
            return 2
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
    else:
        dev, kind = torch.device(device), device
    run = Run(cell, args.seed, args.seconds, bool(args.trace), dev,
              peaks=cells.load_json(cell.bench / "peaks.json").get(kind, {}))
    driver = cell.driver().Driver(run)
    libraries = built_libraries()
    t_driver = time.perf_counter()
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    built = sorted(built_libraries() - libraries)
    setup_phases = {"imports_s": t_import - t_start, "card_s": t_driver - t_import,
                    "driver_setup_s": t_start + run.setup_s - t_driver, "built": built}

    sampler = None
    if run.trace_on and dev.type == "cuda":
        from .nvml import Sampler

        sampler = Sampler()
    try:
        w0 = time.perf_counter()
        run.window = driver.window(args.seconds)
        w1 = time.perf_counter()
    finally:
        if sampler is not None:
            sampler.stop()
    if sampler is not None:
        # A reading averages the period before it: skip the window's first second.
        run.utilization = sampler.between(w0 + 1.0, w1)
    if run.trace_on and dev.type == "cuda":
        run.trace = record(driver.traced)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    driver.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = driver.check()
    correct = all(c["value"] <= c["limit"] for c in checks)
    metrics = {}
    for m in (cell.per_layer if run.trace_on else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        print(f"pwbench: modules loaded that the benchmark may not load: {', '.join(found)}", file=sys.stderr)
        return 3

    result = {"correct": correct, "attempted": run.window["attempted"], "failed": run.window["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    if dev.type == "cuda":
        from .nvml import power_limit

        result["card"] = {"name": kind, "power_limit": power_limit()}
    if run.utilization:
        # NVML's busy share through the window, beside the traced slice's.
        result["nvml_utilization_pct"] = sum(run.utilization) / len(run.utilization)
    # A run that built kernels (a checkout's first) pays nvcc in its set-up.
    result["kernels_built"] = bool(built)
    result["setup_phases"] = setup_phases
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
