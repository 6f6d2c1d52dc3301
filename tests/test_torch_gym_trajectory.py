"""PushWorld's Gym deployment with standard padding on the port, on the CPU:
the framed renderer over stacked puzzles and the trajectory rollout
(``envs.throughput.rollout`` with a ``Trajectory``) against the plain
reference ``pushworld_tpu_torch/reference/gym_trajectory.py``, exactly.  The
same comparisons on the card are in ``tests/test_torch_cuda.py``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pushworld_tpu_torch.core.compiled import compile_batch
from pushworld_tpu_torch.core.puzzle import Puzzle, plan_from_string
from pushworld_tpu_torch.envs.throughput import Trajectory, rollout
from pushworld_tpu_torch.envs.vector_env import VectorEnv
from pushworld_tpu_torch.ops import render
from pushworld_tpu_torch.ops.step import env_step
from pushworld_tpu_torch.reference import gym_trajectory as ref

ROOT = Path(__file__).resolve().parents[1]
PUZZLES = ROOT / "tests" / "puzzles"
LEVEL0 = ROOT / "pwbench" / "configs" / "level0"
# Level-0 puzzles whose pooled plans take at most 6 moves, so that a rollout
# given its plan terminates inside max_steps = 7.
SHORT = ("puzzle_012", "puzzle_068", "puzzle_015", "puzzle_000")
MIXED = ("simple", "chain", "lshape", "multi_goal", "agent_wall", "heur/multiple_goals")


def _level0(name):
    return Puzzle.from_file(str(LEVEL0 / f"{name}.pwp"))


def _mixed():
    return [Puzzle.from_file(str(PUZZLES / f"{n}.pwp")) for n in MIXED] + [_level0(n) for n in SHORT[:2]]


def _walk_states(puzzles, pidx, n, rng, steps=6):
    """Valid states: random walks of up to ``steps`` moves from each
    rollout's initial state, padded to ``n`` movables; (B, n, 2) int32 and
    the states as tuples."""
    out, states = np.zeros((len(pidx), n, 2), np.int32), []
    for b, i in enumerate(pidx):
        p, s = puzzles[i], puzzles[i].initial_state
        for a in rng.integers(0, 4, rng.integers(0, steps + 1)):
            s = p.get_next_state(s, int(a))
        out[b, : p.num_movables] = s
        states.append(s)
    return torch.as_tensor(out), states


def _frames(puzzles):
    h = max(p.height for p in puzzles)
    w = max(p.width for p in puzzles)
    return [(h, w), (h + 3, w + 4), (h + 2, w + 5), (47, 54)]


@pytest.mark.parametrize("frame_k", range(4))
def test_framed_renderer_equals_the_reference_framing(frame_k):
    """Mixed-size puzzles in a frame that fits the largest exactly, in
    larger frames (odd and even pads on each side), and in PushWorld's
    standard 47 x 54: every float of every observation, the pad's too."""
    puzzles = _mixed()
    frame = _frames(puzzles)[frame_k]
    n = max(p.num_movables for p in puzzles)
    tables = render.compile_framed_render_tables(puzzles, frame, n=n, device="cpu")
    rng = np.random.default_rng(frame_k)
    pidx = rng.integers(0, len(puzzles), 96)
    states, raw = _walk_states(puzzles, pidx, n, rng)
    idx = torch.as_tensor(pidx, dtype=torch.int32)
    out = torch.full((len(pidx), *frame, 6), float("nan"))
    got = render.render_framed_onehot_batched(tables, states, idx, out=out)
    assert got is out and got.shape == (len(pidx), *frame, 6)
    want = torch.stack([ref.render_padded(puzzles[i], s, frame) for i, s in zip(pidx, raw)])
    assert torch.equal(got, want)
    assert {(frame[0] - p.height) % 2 for p in puzzles} == {0, 1} or frame_k == 0


def test_framed_tables_place_each_puzzle_at_its_centre():
    puzzles = _mixed()
    h, w = 17, 20
    t = render.compile_framed_render_tables(puzzles, (h, w), device="cpu")
    assert t["base"].shape == (len(puzzles), h, w) and t["obj_mask"].shape[1] == max(p.num_movables for p in puzzles)
    for i, p in enumerate(puzzles):
        top, left = (h - p.height) // 2, (w - p.width) // 2
        assert t["geom"][i].tolist() == [top, left, p.height, p.width]
        inside = torch.zeros((h, w), dtype=torch.bool)
        inside[top: top + p.height, left: left + p.width] = True
        assert (t["base"][i][~inside] == 0).all() and (t["base"][i][inside] == 1).sum() >= 2 * (p.height + p.width) - 4
    with pytest.raises(ValueError, match="do not fit"):
        render.compile_framed_render_tables(puzzles, (h, 4), device="cpu")
    with pytest.raises(ValueError, match="movables"):
        render.compile_framed_render_tables(puzzles, (h, w), n=1, device="cpu")


def test_framed_render_tables_build_in_a_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render.compile_framed_render_tables(_mixed(), (47, 54), device="cpu")
    assert [e.name for e in prof.events()].count("pw.rollout.render_tables") == 1


def _problem(B, T, seed, frame=(47, 54)):
    """The four short level-0 puzzles, each rollout's puzzle and a (T, B)
    block of uniform actions; rollouts 0-3 are given their puzzle's plan
    first, so that each terminates inside 7 steps."""
    puzzles = [_level0(n) for n in SHORT]
    plans = json.loads((LEVEL0 / "pool.json").read_text())["plans"]
    rng = np.random.default_rng(seed)
    pidx = rng.integers(0, len(puzzles), B).astype(np.int32)
    pidx[:4] = np.arange(4)
    actions = rng.integers(0, 4, (T, B))
    for b, name in enumerate(SHORT):
        plan = plan_from_string(plans[name])[:T]
        actions[: len(plan), b] = plan
    return puzzles, pidx, actions, frame


def _program(puzzles, pidx, actions, max_steps, frame, dev):
    cp = compile_batch(puzzles)
    env = VectorEnv(cp, max_steps=max_steps, device=dev)
    tables = render.compile_framed_render_tables(puzzles, frame, n=cp.n, device=dev)
    T, B = actions.shape
    traj = Trajectory.empty(T, B, frame, dev)
    traj.obs.fill_(float("nan"))
    traj.reward.fill_(float("nan"))
    idx = torch.as_tensor(pidx, device=dev)
    total = rollout(env, tables, idx, T, True, None, torch.as_tensor(actions, device=dev), trajectory=traj)
    return total, traj


def test_trajectory_rollout_equals_the_reference():
    """B = 64, T = 40, ``max_steps`` 7: every observation, reward and flag
    equal, with terminations and truncations (and the resets after them)."""
    puzzles, pidx, actions, frame = _problem(64, 40, 0)
    total, traj = _program(puzzles, pidx, actions, 7, frame, "cpu")
    want = ref.trajectory(puzzles, pidx, actions, 7, frame)
    assert int(want["terminated"].sum()) >= 4 and int(want["truncated"].sum()) >= 1
    assert torch.equal(traj.obs, want["obs"])
    for k in ("reward", "terminated", "truncated"):
        assert torch.equal(getattr(traj, k), want[k]), k
    assert float(total) == pytest.approx(float(want["totals"].double().sum()), abs=1e-3)


def test_trajectory_rollout_checks_its_arguments():
    puzzles, pidx, actions, frame = _problem(8, 3, 1)
    cp = compile_batch(puzzles)
    env = VectorEnv(cp, max_steps=7, device="cpu")
    framed = render.compile_framed_render_tables(puzzles, frame, n=cp.n, device="cpu")
    idx = torch.as_tensor(pidx)
    a = torch.as_tensor(actions)
    with pytest.raises(ValueError, match="trajectory needs"):
        rollout(env, framed, idx, 3, False, None, a, trajectory=Trajectory.empty(3, 8, frame, "cpu"))
    with pytest.raises(ValueError, match="trajectory needs"):
        rollout(env, framed, idx, 3, True, None, a, trajectory=Trajectory.empty(2, 8, frame, "cpu"))
    single = render.compile_render_tables(puzzles[0], cp, device="cpu")
    with pytest.raises(ValueError, match="trajectory needs"):
        rollout(env, single, idx, 3, True, None, a, trajectory=Trajectory.empty(3, 8, frame, "cpu"))


def test_env_step_writes_reward_and_flags_into_out():
    puzzles, pidx, actions, _ = _problem(16, 1, 2)
    env = VectorEnv(compile_batch(puzzles), max_steps=1, device="cpu")
    st = env.reset(None, 16, torch.as_tensor(pidx))
    a = torch.as_tensor(actions[0])
    want = env.step(st, a)
    out = (torch.empty(16), torch.empty(16, dtype=torch.bool), torch.empty(16, dtype=torch.bool))
    got = env.step(st, a, out=out)
    assert all(g is o for g, o in zip(got[2:], out))
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    assert int(out[2].sum()) == 16 - int(out[1].sum())  # max_steps 1: every rollout ends
    with pytest.raises(ValueError, match="one step"):
        env.step(st, torch.as_tensor(actions), out=out)
    args = (env.puzzles, st.positions, a, st.steps, st.achieved, st.puzzle_idx, env._init_pos, env._init_achieved, 1)
    assert env_step(*args, out=out)[4] is out[0]


def test_the_reference_imports_no_kernel_op_or_jax():
    code = ("import sys; import pushworld_tpu_torch.reference.gym_trajectory; "
            "print(sorted(m for m in sys.modules if m.startswith(('pushworld_tpu_torch.kernels', "
            "'pushworld_tpu_torch.ops', 'jax', 'pushworld_tpu.')) or m == 'pushworld_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_gym_configuration_pool_is_level0s_byte_for_byte():
    gym = ROOT / "pwbench" / "configs" / "level0-gym"
    names = sorted(p.name for p in LEVEL0.iterdir())
    assert names == sorted(p.name for p in gym.iterdir()) and len(names) == 257
    for name in names:
        assert (gym / name).read_bytes() == (LEVEL0 / name).read_bytes(), name


def test_gym_configuration_states_its_deployment():
    cfg = json.loads((ROOT / "pwbench" / "configs" / "level0-gym.json").read_text())
    assert cfg["frame"] == [47, 54] and cfg["max_steps"] == 100 and cfg["reduced"] == []
    assert len(cfg["assumed"]) == 5
    # The frame holds every pooled puzzle.
    assert all(_level0(p.stem).height <= 47 for p in list(LEVEL0.glob("*.pwp"))[:16])
    assert os.path.basename(cfg["pool"]["copied_from"]) == "level0"
