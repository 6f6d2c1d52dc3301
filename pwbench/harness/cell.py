"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

- ``configs/<config>.json``: the configuration; its frozen pool of puzzles
  lies in ``configs/<config>/`` (``puzzle_NNN.pwp``, ``pool.json``).
- ``traffic/<traffic>.json``: the mix's parameters and the name of the
  driver that runs it, ``drivers/<driver>.py``.
- ``limits/<cell>.json``: the limit of each number that decides ``correct``.
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``.
- ``held/<cell>.json``: a cell that runs by name but is not in
  ``BENCHMARK.json`` (its ``why_held`` says why): its workload entry and
  its metrics' entries, as ``BENCHMARK.json`` would hold them.

A later cell adds files and entries; nothing here names a cell.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Imports the Python file ``path`` under ``name`` (reader and driver
    files are named after metrics and mixes, which may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: Path = BENCH

    @property
    def pool_dir(self) -> Path:
        return self.bench / "configs" / self.config_name

    def pool(self) -> List[tuple]:
        """[(name, text)] of the configuration's pool, in name order."""
        return [(p.stem, p.read_text()) for p in sorted(self.pool_dir.glob("*.pwp"))]

    def driver(self):
        return load_module(self.bench / "drivers" / f"{self.traffic['driver']}.py", f"pwbench_driver_{self.traffic['driver']}")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py", f"pwbench_metric_{metric}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def with_held(benchmark: dict, workload: str, bench: Path = BENCH) -> dict:
    """``benchmark`` with the held cell ``workload`` (``held/<workload>.json``)
    and the metrics it names merged in, where ``benchmark`` lacks it."""
    path = bench / "held" / f"{workload}.json"
    if any(w["name"] == workload for w in benchmark["workloads"]) or not path.is_file():
        return benchmark
    held = load_json(path)
    merged = dict(benchmark, workloads=benchmark["workloads"] + [held["workload"]])
    for key in ("end_to_end", "per_layer"):
        have = {m["name"] for m in benchmark[key]}
        merged[key] = benchmark[key] + [m for m in held[key] if m["name"] not in have]
    return merged


def resolve(workload: str, benchmark: Optional[dict] = None, bench: Path = BENCH) -> Cell:
    """The cell named ``workload`` of ``benchmark`` (``BENCHMARK.json`` at the
    checkout's root where not given), or the held cell of that name."""
    if benchmark is None:
        benchmark = load_json(bench.parent / "BENCHMARK.json")
    benchmark = with_held(benchmark, workload, bench)
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    e2e = [m for m in benchmark["end_to_end"] if _applies(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
                config=load_json(bench / "configs" / f"{w['config']}.json"),
                traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(bench / "limits" / f"{workload}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer, bench=bench)
