"""A copy of the benchmark at sizes the CPU runs in seconds, for the tests:
small batches and horizons, small search capacities, and a cell
``plan.tiny`` over two short level-0 puzzles, with the metrics of the held
cell ``plan.level0``."""

import json
import shutil
from pathlib import Path

from pwbench.harness.cell import with_held

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SMALL_TRAFFIC = {
    "rollout": {"batch": 48, "horizon": 12},
    "plan": {"capacities": {"expand": 16, "frontier_capacity": 1024, "visited_bits": 14,
                            "history_capacity": 1 << 14, "pair_bits": 14}},
}
TINY_POOL = ("puzzle_000", "puzzle_002")


def small_bench(tmp: Path):
    """(bench directory, BENCHMARK.json as a dict) of a small copy under ``tmp``."""
    bench = tmp / "pwbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, params in SMALL_TRAFFIC.items():
        path = bench / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t["params"].update(params)
        path.write_text(json.dumps(t))
    tiny = bench / "configs" / "tiny"
    tiny.mkdir()
    plans = json.loads((BENCH / "configs" / "level0" / "pool.json").read_text())["plans"]
    for name in TINY_POOL:
        shutil.copy(BENCH / "configs" / "level0" / f"{name}.pwp", tiny)
    (tiny / "pool.json").write_text(json.dumps({"plans": {n: plans[n] for n in TINY_POOL}}))
    cfg = json.loads((BENCH / "configs" / "level0.json").read_text())
    cfg["pool"]["size"] = len(TINY_POOL)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / "plan.level0.json", bench / "limits" / "plan.tiny.json")
    benchmark = with_held(json.loads((ROOT / "BENCHMARK.json").read_text()), "plan.level0", bench)
    benchmark["workloads"].append({"name": "plan.tiny", "config": "tiny", "traffic": "plan", "chips": 1,
                                   "why": "test"})
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        if "plan.level0" in m.get("workloads", ()):
            m["workloads"].append("plan.tiny")
    return bench, benchmark


def run_cell(bench, benchmark, workload, capsys, seconds=0.05, seed=3_000_000_019):
    """Runs ``workload`` once on the CPU; (exit code, result line or None)."""
    from pwbench.harness.main import main

    rc = main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
              device="cpu", benchmark=benchmark, bench=bench)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 and out else None)
