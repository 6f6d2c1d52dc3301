"""What the benchmark loads, how it finds a cell's parts by name, and
``BENCHMARK.json`` against the benchmark's contract."""

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from pwbench.tests.small import BENCH, ROOT, run_cell, small_bench

FORBIDDEN = {"jax", "jaxlib", "flax", "pushworld_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def loaded_top_levels(code: str) -> set:
    """Top-level names of the modules loaded after running ``code`` in a
    fresh interpreter at the checkout's root."""
    script = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_of_every_driver_loads_no_jax(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from pwbench.tests.small import small_bench
from pwbench.harness.main import main
bench, bm = small_bench(Path({str(tmp_path)!r}))
for w in ("rollout.level0", "plan.tiny"):
    assert main(["--workload", w, "--seed", "7", "--seconds", "0.05", "--trace", "0"], device="cpu",
                benchmark=bm, bench=bench) == 0
import pwbench.controls
"""
    mods = loaded_top_levels(code)
    assert "pushworld_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_neither_the_program_nor_jax():
    mods = loaded_top_levels("import pwbench.reference.puzzle, pwbench.reference.dynamics, "
                             "pwbench.reference.env, pwbench.reference.render")
    assert not mods & (FORBIDDEN | {"pushworld_tpu_torch", "torch"})


def test_forbidden_names_are_compared_whole():
    from pwbench.harness import main

    before = dict(sys.modules)
    try:
        sys.modules["pushworld_tpu_torch_x"] = sys  # a name that only begins with one
        assert "pushworld_tpu" not in main.forbidden_modules()
        sys.modules["pushworld_tpu.core"] = sys
        assert "pushworld_tpu" in main.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_metric_and_cell_are_found_without_editing_a_file(tmp_path, capsys):
    bench, bm = small_bench(tmp_path)
    before = _digest(bench)
    # New files only: a configuration with its pool, a mix, a metric's reader, a cell's limits.
    (bench / "configs" / "extra").mkdir()
    for f in sorted((bench / "configs" / "level0").glob("*.pwp"))[:3]:
        (bench / "configs" / "extra" / f.name).write_text(f.read_text())
    (bench / "configs" / "extra.json").write_text((bench / "configs" / "level0.json").read_text())
    mix = json.loads((bench / "traffic" / "rollout.json").read_text())
    mix["params"].update(batch=20, horizon=6)
    (bench / "traffic" / "short-rollout.json").write_text(json.dumps(mix))
    (bench / "metrics" / "replays.extra.py").write_text("def read(run):\n    return float(run.window['replays'])\n")
    (bench / "limits" / "short-rollout.extra.json").write_text(
        (bench / "limits" / "rollout.level0.json").read_text())
    bm["configs"].append({"name": "extra", "source": "test", "file": "pwbench/configs/extra.json", "reduced": [],
                          "why": "test"})
    bm["workloads"].append({"name": "short-rollout.extra", "config": "extra", "traffic": "short-rollout",
                            "chips": 1, "why": "test"})
    # BENCHMARK.json gains entries: the cell, its metric, the cell in steps_per_s's list.
    next(m for m in bm["end_to_end"] if m["name"] == "steps_per_s")["workloads"].append("short-rollout.extra")
    bm["end_to_end"].append({"name": "replays.extra", "unit": "replays", "better": "higher", "bound": 0.05,
                             "source": "host_clock", "workloads": ["short-rollout.extra"]})
    rc, line = run_cell(bench, bm, "short-rollout.extra", capsys)
    assert rc == 0 and line["correct"]
    assert set(line["metrics"]) == {"steps_per_s", "setup_s", "replays.extra"}
    assert line["metrics"]["replays.extra"]["value"] == line["attempted"]
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload", ["rollout.level0", "plan.tiny"])
def test_each_driver_runs_a_small_cell_on_the_cpu(tmp_path, capsys, workload):
    bench, bm = small_bench(tmp_path)
    rc, line = run_cell(bench, bm, workload, capsys)
    assert rc == 0 and line["correct"], line
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    e2e = {m["name"] for m in bm["end_to_end"] if "workloads" not in m or workload in m["workloads"]}
    assert set(line["metrics"]) == e2e


def test_without_a_card_a_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "pwbench/run.py", "--workload", "rollout.level0", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


HELD = sorted(p.stem for p in (BENCH / "held").glob("*.json"))


@pytest.mark.parametrize("held", [None] + HELD)
def test_benchmark_json_keeps_to_the_contract(held):
    """``BENCHMARK.json``, and ``BENCHMARK.json`` with each held cell merged in
    as a later PR would add it."""
    from pwbench.harness.cell import with_held

    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    if held is not None:
        assert held not in {w["name"] for w in bm["workloads"]}
        assert json.loads((BENCH / "held" / f"{held}.json").read_text())["why_held"]
        bm = with_held(bm, held)
        assert held in {w["name"] for w in bm["workloads"]}
    assert set(bm) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bm["paths"] == ["pwbench"] and bm["command"][1] == "pwbench/run.py"
    assert 1 <= bm["run_seconds"] <= 51 and isinstance(bm["run_seconds"], int)
    configs = {c["name"]: c for c in bm["configs"]}
    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("pwbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = {w["name"]: w for w in bm["workloads"]}
    assert len(cells) == len(bm["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bm["workloads"]}) == len(cells)
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    assert {w["config"] for w in bm["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in bm["end_to_end"] + bm["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bm["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bm["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            assert w in cells and ("workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"])
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        mine = [m for m in bm["end_to_end"] if "workloads" not in m or w in m["workloads"]]
        assert len(mine) >= 2 and any(m["name"] != "setup_s" for m in mine)
        assert any(w in m.get("workloads", cells) for m in bm["per_layer"])
    for p in BENCH.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("workload", ["plan.level0", "rollout.level0"])
def test_each_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "pwbench/run.py", "--workload", workload, "--seed", "4000000007",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
