"""The Gym deployment's cell ``rollout-obs.level0-gym`` on the CPU at small
sizes: it runs correct through the program's trajectory rollout, each fault
planted in the program turns ``correct`` false, the control (the reference
in bfloat16) fails one limit and not each, and the cell's four per-layer
readers read hand-made traces and counters."""

import json
import subprocess
import sys
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pwbench import controls
from pwbench.bounds import env_step, render
from pwbench.harness import cell as cells
from pwbench.harness.cell import BENCH, load_module
from pwbench.harness.main import Run
from pwbench.harness.trace import Trace
from pwbench.tests.small import ROOT, run_cell, small_bench

CELL = "rollout-obs.level0-gym"
SMALL = {"batch": 64, "horizon": 40, "max_steps": 7}


@pytest.fixture
def bench(tmp_path):
    bench, bm = small_bench(tmp_path)
    path = bench / "traffic" / "rollout-obs.json"
    t = json.loads(path.read_text())
    t["params"].update(SMALL)
    path.write_text(json.dumps(t))
    return bench, bm


def test_the_gym_cell_is_correct_unbroken(bench, capsys):
    rc, line = run_cell(*bench, CELL, capsys)
    assert rc == 0 and line["correct"], line["checks"]
    assert set(line["checks"]) == {"obs_cells_differing", "step_outputs_differing", "reward_gap_per_rollout",
                                   "positions_differing", "reward_total_gap"}
    assert set(line["metrics"]) == {"steps_per_s", "setup_s"}
    assert line["attempted"] >= 2


def _row(out):
    """(the whole trajectory, step t) of ``out``, a row of a trajectory's
    observations."""
    return out._base, out.storage_offset() // out.numel()


def _plant(monkeypatch, fault):
    from pushworld_tpu_torch.envs import throughput, vector_env
    from pushworld_tpu_torch.ops import render as program_render

    real_render = throughput.render_framed_onehot_batched
    real_step = vector_env.env_step
    real_tables = program_render.compile_framed_render_tables

    def render_fault(tables, positions, puzzle_idx, out=None):
        whole, t = _row(out)
        if fault == "row_unwritten" and t == whole.shape[0] - 1:
            return out
        if fault == "next_row":  # step t's observation written into row t + 1
            if t + 1 < whole.shape[0]:
                real_render(tables, positions, puzzle_idx, out=whole[t + 1])
            return out
        real_render(tables, positions, puzzle_idx, out=out)
        if fault == "pad_as_wall":  # the frame's corner, a pad cell of every level-0 puzzle
            out[:, 0, 0, 0] = 1.0
        return out

    def step_fault(cp, positions, actions, steps, achieved, *args, reward_acc=None, out=None):
        res = real_step(cp, positions, actions, steps, achieved, *args, reward_acc=reward_acc, out=out)
        if fault == "truncation_kept":  # a truncated rollout goes on from where it stood
            trunc = res[6]
            res = (torch.where(trunc[:, None, None], res[3], res[0]), torch.where(trunc, steps + 1, res[1]),
                   res[2]) + tuple(res[3:])
        if fault == "reward_altered":
            res[4][0] += 1.0
        return res

    def offset_tables(puzzles, frame, n=None, device="cuda"):
        t = real_tables(puzzles, frame, n=n, device=device)
        t["base"] = torch.roll(t["base"], 1, dims=1)
        t["geom"][:, 0] += 1
        return t

    if fault in ("next_row", "pad_as_wall", "row_unwritten"):
        monkeypatch.setattr(throughput, "render_framed_onehot_batched", render_fault)
    elif fault == "offset":
        monkeypatch.setattr(program_render, "compile_framed_render_tables", offset_tables)
    else:
        monkeypatch.setattr(vector_env, "env_step", step_fault)


FAULTS = {"next_row": "obs_cells_differing", "pad_as_wall": "obs_cells_differing",
          "offset": "obs_cells_differing", "row_unwritten": "obs_cells_differing",
          "truncation_kept": "positions_differing", "reward_altered": "step_outputs_differing"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_gym_cell_incorrect(bench, capsys, monkeypatch, fault):
    _plant(monkeypatch, fault)
    rc, line = run_cell(*bench, CELL, capsys)
    assert rc == 0 and not line["correct"], line["checks"]
    number = line["checks"][FAULTS[fault]]
    assert number["value"] > number["limit"], line["checks"]


def _driver(bench, seed=13):
    b, bm = bench
    cell = cells.resolve(CELL, bm, b)
    run = Run(cell, seed, 0.05, False, torch.device("cpu"))
    d = cell.driver().Driver(run)
    d.setup()
    run.window = d.window(0.05)
    d.release()
    return cell, d


def test_the_control_fails_a_limit_and_not_each(bench):
    """The reference in bfloat16 (the configuration's rewards are float32)
    against the reference: the rewards fail, the observations and positions
    (which do not depend on the precision) pass."""
    cell, d = _driver(bench)
    movable = d.tables().cmask[d.pidx].any(-1)
    k = d.kept[-1]
    want = d.reference(k)
    program = d.readings(k, want, movable)
    assert all(v <= cell.limits[n] for n, v in program.items()), program
    control = d.reference(k, rounding=controls.bfloat16)
    control = dict(control, total=float(np.asarray(control["totals"], np.float64).sum()))
    control["positions"] = control["last"]
    read = d.readings(control, want, movable)
    failed = {n for n, v in read.items() if v > cell.limits[n]}
    assert failed and failed != set(read), read
    assert {"step_outputs_differing", "reward_total_gap"} <= failed


def test_the_control_tool_reads_every_stand_in_above_a_limit(bench):
    from pwbench.tools import obs_controls

    cell, d = _driver(bench, seed=17)
    r = obs_controls.readings(d)
    assert set(r) == set(cell.limits)
    for number, by in r.items():
        assert by["program"] <= cell.limits[number], (number, by)
    for name in ("control_bfloat16", "state_unchanged", "answer_altered"):
        failed = {n for n, by in r.items() if by[name] > cell.limits[n]}
        assert failed, (name, r)
    assert {n for n, by in r.items() if by["control_bfloat16"] > cell.limits[n]} != set(r)


def test_the_gym_driver_loads_no_jax(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import json
from pathlib import Path
from pwbench.tests.small import small_bench
from pwbench.harness.main import main
bench, bm = small_bench(Path({str(tmp_path)!r}))
path = bench / "traffic" / "rollout-obs.json"
t = json.loads(path.read_text())
t["params"].update({SMALL!r})
path.write_text(json.dumps(t))
assert main(["--workload", {CELL!r}, "--seed", "7", "--seconds", "0.05", "--trace", "0"], device="cpu",
            benchmark=bm, bench=bench) == 0
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pushworld_tpu_torch" in mods and not mods & {"jax", "jaxlib", "flax", "pushworld_tpu"}


def test_the_trajectory_reference_loads_neither_the_program_nor_jax():
    code = ("import sys, json; import pwbench.reference.trajectory; "
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not set(json.loads(out.stdout.strip())) & {"jax", "pushworld_tpu", "pushworld_tpu_torch", "torch"}


# ------------------------------------------------------------------ readers


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"pwbench_metric_{name}").read


SHAPES = {"batch": 4096, "objects": 4, "action_bytes": 4, "stacked": True, "frame": [47, 54],
          "table_bytes": 1000}
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def _trace():
    """A 1,000 µs slice: two framed renders of 100 and 80 µs, two one-step
    env launches of 3 µs, a copy; busy 286 µs."""
    device = [("void (anonymous namespace)::render_onehot_framed_kernel(Framed)", 0, 100),
              ("void (anonymous namespace)::env_step_kernel<4, false>(Env)", 100, 103),
              ("void (anonymous namespace)::env_step_kernel<4, false>(Env)", 200, 203),
              ("void (anonymous namespace)::render_onehot_framed_kernel(Framed)", 203, 283),
              ("Memcpy DtoD", 300, 400)]
    return Trace(device=device, host=[], start=0.0, end=1000.0)


def _run(trace, traced=None):
    return SimpleNamespace(trace=trace, peaks=PEAKS, window={"shapes": SHAPES}, traced=traced or {})


def test_render_roofline_reader():
    want = 100.0 * render.framed_bytes_per_launch(4096, 47, 54, 4, 1000) / 3.35e12 / 90e-6
    assert _reader("render_roofline.obs")(_run(_trace())) == pytest.approx(want)
    assert render.framed_bytes_per_launch(4096, 47, 54, 4) == 4096 * (24 * 47 * 54 + 36)
    no_render = Trace(device=_trace().device[1:3], host=[], start=0.0, end=1000.0)
    assert _reader("render_roofline.obs")(_run(no_render)) is None
    assert _reader("render_roofline.obs")(_run(None)) is None


def test_env_step_roofline_reader():
    want = 100.0 * env_step.bytes_per_launch(4096, 4, 4, True) / 3.35e12 / 3e-6
    assert _reader("env_step_roofline.obs")(_run(_trace())) == pytest.approx(want)
    assert _reader("env_step_roofline.obs")(_run(None)) is None


def test_device_idle_reader():
    assert _reader("device_idle_pct.obs")(_run(_trace())) == pytest.approx(100.0 * (1 - 286 / 1000))
    assert _reader("device_idle_pct.obs")(_run(None)) is None


@pytest.fixture
def counters():
    from pushworld_tpu_torch.utils import tracing

    saved = Counter(tracing.COUNTERS)
    tracing.COUNTERS.clear()
    yield tracing.COUNTERS
    tracing.COUNTERS.clear()
    tracing.COUNTERS.update(saved)


def test_obs_hbm_reader(counters, monkeypatch):
    read = _reader("obs_hbm_pct.obs")
    run = _run(_trace(), {"replays": 2})
    assert read(run) is None  # the program counted no replay (an older program)
    counters.update(replays=4, obs_bytes=4 * 1_000_000)
    assert read(run) == pytest.approx(100.0 * 1_000_000 * 2 / 286e-6 / 3.35e12)
    assert read(_run(None, {"replays": 2})) is None
    monkeypatch.setitem(sys.modules, "pushworld_tpu_torch.utils.tracing", None)
    assert read(run) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def test_the_gym_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "pwbench/run.py", "--workload", CELL, "--seed", "4000000011",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
