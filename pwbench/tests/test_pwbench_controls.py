"""The check that decides ``correct`` fails the control and each planted
fault (CPU, small sizes): the harness runs with the timed path broken
underneath, and the control's readings pass every limit."""

import json

import numpy as np
import pytest
import torch

from pwbench import controls
from pwbench.harness import cell as cells
from pwbench.harness.main import Run
from pwbench.tests.small import run_cell, small_bench

ROLLOUT = {"batch": 256, "horizon": 128}


@pytest.fixture
def bench(tmp_path):
    bench, bm = small_bench(tmp_path)
    path = bench / "traffic" / "rollout.json"
    t = json.loads(path.read_text())
    t["params"].update(ROLLOUT)
    path.write_text(json.dumps(t))
    return bench, bm


def _patch_step(monkeypatch, fault):
    from pushworld_tpu_torch.envs import vector_env

    real = vector_env.env_step
    calls = []

    def broken(cp, positions, actions, steps, achieved, *args, reward_acc=None):
        calls.append(1)
        if fault == "half_batch":  # the second half left out, the total over the first doubled
            out = real(cp, positions, actions, steps, achieved, *args, reward_acc=None)
            half = positions.shape[0] // 2
            reward_acc[:half] += 2 * out[4][:half]
            kept = [x.clone() for x in out]
            for x, before in ((kept[0], positions), (kept[1], steps), (kept[2], achieved), (kept[3], positions)):
                x[half:] = before[half:]
            return tuple(kept)
        out = real(cp, positions, actions, steps, achieved, *args, reward_acc=reward_acc)
        if fault == "state_unchanged":
            return (positions, out[1], out[2], positions) + tuple(out[4:])
        if fault == "answer_altered" and len(calls) % ROLLOUT["horizon"] == 1:
            reward_acc[0] += 1.0  # the first step of each rollout paid for a goal more
        if fault == "cancelling" and len(calls) % ROLLOUT["horizon"] == 1:
            reward_acc[0] += 1.0  # errors that cancel in the sum of the totals
            reward_acc[1] -= 1.0
        if fault == "moved" and len(calls) % ROLLOUT["horizon"] == 0:
            out = list(out)
            out[3] = out[3].clone()
            out[3][0, 0, 0] += 1  # the last step of one rollout leaves its agent a cell over
            out = tuple(out)
        return out

    monkeypatch.setattr(vector_env, "env_step", broken)


def test_the_rollout_cell_is_correct_unbroken(bench, capsys):
    rc, line = run_cell(*bench, "rollout.level0", capsys)
    assert rc == 0 and line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "cancelling", "moved"])
def test_a_planted_fault_makes_the_rollout_cell_incorrect(bench, capsys, monkeypatch, fault):
    _patch_step(monkeypatch, fault)
    rc, line = run_cell(*bench, "rollout.level0", capsys)
    assert rc == 0 and not line["correct"], line["checks"]


def test_a_plan_altered_where_it_is_produced_makes_the_plan_cell_incorrect(bench, capsys, monkeypatch):
    from pushworld_tpu_torch.search import planner

    real = planner.solve_puzzle

    def altered(*args, **kwargs):
        r = real(*args, **kwargs)
        if r.plan:
            r.plan = list(r.plan)
            r.plan[-1] = (r.plan[-1] + 1) % 4
        return r

    monkeypatch.setattr(planner, "solve_puzzle", altered)
    rc, line = run_cell(*bench, "plan.tiny", capsys)
    assert rc == 0 and not line["correct"], line["checks"]


def test_a_no_solution_on_a_pooled_puzzle_makes_the_plan_cell_incorrect(bench, capsys, monkeypatch):
    from pushworld_tpu_torch.search import planner

    monkeypatch.setattr(planner, "solve_puzzle", lambda *a, **k: planner.PlanResult(None, 0.01, "no solution"))
    rc, line = run_cell(*bench, "plan.tiny", capsys)
    assert rc == 0 and not line["correct"] and line["failed"] == line["attempted"]


def _driver(bench, workload, seed=11):
    b, bm = bench
    cell = cells.resolve(workload, bm, b)
    run = Run(cell, seed, 0.05, False, torch.device("cpu"))
    d = cell.driver().Driver(run)
    d.setup()
    run.window = d.window(0.05)
    d.release()
    return cell, d


def test_the_control_and_the_faults_read_above_the_rollout_limit(bench):
    cell, d = _driver(bench, "rollout.level0")
    readings = controls.rollout_readings(d)
    for number, r in readings.items():
        assert r["program"] <= cell.limits[number], (number, r)
    # The control and each fault fail one of the cell's numbers.
    for name in ("control_bfloat16", "state_unchanged", "half_batch", "answer_altered"):
        assert any(r[name] > cell.limits[number] for number, r in readings.items()), (name, readings)


def test_the_control_reads_above_the_plan_limit(bench):
    cell, d = _driver(bench, "plan.tiny")
    r = controls.plan_readings(d)["plans_not_reaching_goal"]
    assert r["program"] == 0 <= cell.limits["plans_not_reaching_goal"]
    assert r["control_truncated"] > cell.limits["plans_not_reaching_goal"]
    assert r["answer_altered"] > cell.limits["plans_not_reaching_goal"]


def test_bfloat16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.01171875, -0.01, 10.0], np.float32)
    assert controls.bfloat16(x).tolist() == [1.0, 1.0, 1.015625, np.float32(-0.010009765625), 10.0]
