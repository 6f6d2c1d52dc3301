"""The benchmark's reference on hand-worked cases and on the pools' plans
(CPU, NumPy only)."""

import json
from pathlib import Path

import numpy as np
import pytest

from pwbench.reference import dynamics, env, puzzle, render

BENCH = Path(__file__).resolve().parents[1]
L, R, U, D = range(4)

SIMPLE = """
.  .  .  .
A  M0 .  G0
.  .  .  .
"""
CHAIN = "A  M1 M0 .  G0"
AGENT_WALL = "A  M1 AW ."
TWO_GOALS = """
.  .  .  .
.  G0 .  .
A  M0 .  .
.  M1 .  G1
"""


def run(text, actions, max_steps=100, **kw):
    p = puzzle.parse(text)
    t = dynamics.Tables([p])
    a = np.array(actions, np.int64).reshape(-1, 1)
    return env.rollout(t, np.zeros(1, np.int64), a, max_steps, **kw)


def positions(text, actions):
    p = puzzle.parse(text)
    b = dynamics.Batch(dynamics.Tables([p]), np.zeros(1, np.int64))
    pos = p.init[None].copy()
    for a in actions:
        pos = b.step(pos, np.array([a]))
    return [tuple(x) for x in pos[0]]


def test_parse_orders_movables_and_adds_the_border():
    p = puzzle.parse(TWO_GOALS)
    assert (p.width, p.height) == (6, 6)
    assert p.names == ["a", "m0", "m1"]
    assert [tuple(x) for x in p.init] == [(1, 3), (2, 3), (2, 4)]
    assert [tuple(x) for x in p.goals] == [(2, 2), (4, 4)]
    assert p.walls[0].all() and p.walls[-1].all() and p.walls[:, 0].all() and p.walls[:, -1].all()
    assert not p.walls[1:-1, 1:-1].any()


def test_parse_rejects_ragged_rows_and_missing_agent():
    with pytest.raises(ValueError):
        puzzle.parse("A  .\n.")
    with pytest.raises(ValueError):
        puzzle.parse(".  M0")
    with pytest.raises(ValueError):
        puzzle.parse("A  G3")


def test_push_is_transitive_and_stops_at_walls():
    assert positions(CHAIN, [R]) == [(2, 1), (4, 1), (3, 1)]
    assert positions(CHAIN, [R, R]) == [(3, 1), (5, 1), (4, 1)]
    # M0 would enter the border: nothing moves.
    assert positions(CHAIN, [R, R, R]) == [(3, 1), (5, 1), (4, 1)]
    # The agent alone into the border: nothing moves.
    assert positions(CHAIN, [L]) == [(1, 1), (3, 1), (2, 1)]


def test_agent_walls_stop_the_agent_alone():
    # M1 is pushed onto the agent-only wall; the agent may not follow.
    assert positions(AGENT_WALL, [R]) == [(2, 1), (3, 1)]
    assert positions(AGENT_WALL, [R, R]) == [(2, 1), (3, 1)]


def test_plan_check():
    p = puzzle.parse(SIMPLE)
    assert dynamics.plan_reaches_goal(p, [R, R])
    assert not dynamics.plan_reaches_goal(p, [R])
    assert not dynamics.plan_reaches_goal(p, [R, R, L])  # the goal is reached early
    assert not dynamics.plan_reaches_goal(p, [R, 7])


def test_reward_schedule_by_hand():
    f = np.float32
    # -0.01, then the goal: +10 (and a reset).
    total, _ = run(SIMPLE, [R, R])
    assert total[0] == f(f(-0.01) + f(10))
    # Two goals: D, R -0.01 each; U puts M0 on G0, +1 - 0.01; U takes it off, -1 - 0.01.
    total, last = run(TWO_GOALS, [D, R, U, U])
    want = f(0)
    for r in (f(-0.01), f(-0.01), f(f(1) - f(0.01)), f(f(-1) - f(0.01))):
        want = f(want + r)
    assert total[0] == want
    assert [tuple(x) for x in last[0]] == [(2, 2), (2, 1), (3, 4)]


def test_truncation_resets_the_rollout():
    # R, D, then the truncation at 2 steps puts everything back: R pushes M0 again.
    total, last = run(SIMPLE, [R, D, R], max_steps=2)
    assert [tuple(x) for x in last[0]] == [(2, 2), (3, 2)]
    assert total[0] == np.float32(np.float32(np.float32(-0.01) + np.float32(-0.01)) + np.float32(-0.01))
    _, last = run(SIMPLE, [R, D, R], max_steps=100)
    assert [tuple(x) for x in last[0]] == [(3, 3), (3, 2)]


def test_without_max_steps_nothing_truncates():
    _, last = run(SIMPLE, [R, D, R] * 40, max_steps=None)
    _, want = run(SIMPLE, [R, D, R] * 40, max_steps=1000)
    assert np.array_equal(last, want)


def test_terminal_step_resets_the_rollout():
    total, last = run(SIMPLE, [R, R, R])
    # After the goal the third R starts from the initial state again.
    assert [tuple(x) for x in last[0]] == [(2, 2), (3, 2)]
    f = np.float32
    assert total[0] == f(f(f(-0.01) + f(10)) + f(-0.01))


def test_render_by_hand():
    p = puzzle.parse(SIMPLE)
    obs = render.render_onehot(p, p.init[None])[0]
    assert obs.shape == (5, 6, 6)
    assert obs[..., 0].sum() == 2 * 6 + 2 * 3 and obs[0, :, 0].all()  # the border
    assert obs[2, 1, 2] == 1 and obs[..., 2].sum() == 1  # the agent
    assert obs[2, 2, 3] == 1 and obs[..., 3].sum() == 1  # the goal object
    assert obs[2, 4, 5] == 1 and obs[..., 5].sum() == 1  # the goal
    assert obs.sum() == 18 + 3
    # M0 on its goal covers it.
    on = render.render_onehot(p, np.array([[[3, 2], [4, 2]]]))[0]
    assert on[2, 4, 3] == 1 and on[..., 5].sum() == 0
    aw = puzzle.parse(AGENT_WALL)
    obs = render.render_onehot(aw, aw.init[None])[0]
    assert obs[1, 3, 1] == 1 and obs[1, 2, 4] == 1  # agent-only wall; M1, no goal: a movable
    obs = render.render_onehot(aw, np.array([[[2, 1], [3, 1]]]))[0]
    assert obs[1, 3, 1] == 0 and obs[1, 3, 4] == 1  # M1 over the agent-only wall


def test_batched_step_equals_one_at_a_time():
    p = [puzzle.load(str(f)) for f in sorted((BENCH / "configs" / "level0").glob("*.pwp"))[:12]]
    t = dynamics.Tables(p)
    rng = np.random.default_rng(0)
    pidx = rng.integers(0, len(p), 40)
    actions = rng.integers(0, 4, (30, 40))
    total, last = env.rollout(t, pidx, actions, 9)
    for i in range(40):
        one = dynamics.Tables([p[pidx[i]]])
        want, wlast = env.rollout(one, np.zeros(1, np.int64), actions[:, i: i + 1], 9)
        assert total[i] == want[0]
        n = p[pidx[i]].num_movables
        assert np.array_equal(last[i, :n], wlast[0, :n])


def test_pool_plans_reach_the_goal():
    config = "level0"
    pool = BENCH / "configs" / config
    plans = json.loads((pool / "pool.json").read_text())["plans"]
    files = sorted(pool.glob("*.pwp"))
    assert len(files) == len(plans) == json.loads((BENCH / "configs" / f"{config}.json").read_text())["pool"]["size"]
    for f in files:
        p = puzzle.load(str(f))
        plan = ["LRUD".index(c) for c in plans[f.stem]]
        assert dynamics.plan_reaches_goal(p, plan), f.stem
        assert not dynamics.plan_reaches_goal(p, plan[:-1]), f.stem
