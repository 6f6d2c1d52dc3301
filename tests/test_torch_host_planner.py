"""The port's host heuristics and host planner vs the JAX package's.

Pure Python on both sides, from the same puzzle files: heuristic values and
plans must be equal, exactly.
"""

import os

import pytest

from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.search import heuristics_host as jh
from pushworld_tpu.search import host_planner as jhp
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.search import heuristics_host as th
from pushworld_tpu_torch.search import host_planner as thp
from pushworld_tpu_torch.search.planner import solve_puzzle

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
L, R, U, D = 0, 1, 2, 3


def _pair(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return Puzzle.from_file(path), JPuzzle.from_file(path)


def _walk(p, actions):
    """The states along ``actions`` from the initial state, the start included."""
    states = [p.initial_state]
    for a in actions:
        states.append(p.get_next_state(states[-1], a))
    return states


@pytest.mark.parametrize("name,fewest_tools,expected", [
    ("trivial", True, 2),
    ("multiple_goals", True, 4),
    ("transitive_pushing", False, 3),
    ("transitive_pushing", True, 4),
    ("necessary_transitive_pushing1", True, 9),
    ("necessary_transitive_pushing2", True, 2),
    ("necessary_transitive_pushing3", True, 4),
    ("blocked_transitive_pushing1", True, 2),
    ("blocked_transitive_pushing2", True, 3),
    ("trivial_tool2", True, 4),
    ("shortest_path_tool", True, 13),
    ("shortest_path_tool", False, 6),
    ("two_tools", True, None),
    ("three_tools", True, None),
])
def test_rgd_estimate_equals_jax(name, fewest_tools, expected):
    p, jp = _pair("heur/" + name)
    rgd = th.RecursiveGraphDistance(p, fewest_tools=fewest_tools)
    jrgd = jh.RecursiveGraphDistance(jp, fewest_tools=fewest_tools)
    if expected is not None:
        assert rgd.estimate(p.initial_state) == expected
    # The start and every state one and two actions from it, twice (the
    # second pass reads the push-cost cache).
    states = {s for a in range(4) for b in range(4) for s in _walk(p, [a, b])}
    for _ in range(2):
        for s in sorted(states):
            assert rgd.estimate(s) == jrgd.estimate(s), (name, s)


def test_rgd_values_along_a_walk():
    p, _ = _pair("heur/trivial")
    rgd = th.RecursiveGraphDistance(p)
    assert [rgd.estimate(s) for s in _walk(p, [R, U])] == [2, 3, 4]
    p, _ = _pair("heur/multiple_goals")
    rgd = th.RecursiveGraphDistance(p)
    s0 = p.initial_state
    assert [rgd.estimate(p.get_next_state(s0, a)) for a in (L, R, U, D)] == [4, 4, 6, 6]


def test_novelty_equals_jax_on_walks():
    p, jp = _pair("heur/multiple_goals")
    n = p.num_movables
    h, j = th.NoveltyHeuristic(n), jh.NoveltyHeuristic(n)
    s0 = p.initial_state
    seq = [(s0, list(range(n))), (s0, [])]
    for actions in ([U], [], [L], [L], [L, U, R], [D, D, L], [R, R, U, L]):
        states = _walk(p, actions)
        s, prev = states[-1], states[-2] if len(states) > 1 else s0
        seq.append((s, [i for i in range(n) if s[i] != prev[i]] or [0]))
    got = [h.estimate(s, m) for s, m in seq]
    assert got == [j.estimate(s, m) for s, m in seq]
    assert got[:6] == [1.0, 3.0, 1.0, 3.0, 1.0, 3.0]

    h3, j3 = th.NoveltyHeuristic(3), jh.NoveltyHeuristic(3)
    cases = [(((1, 1), (5, 5), (9, 9)), [0, 1, 2]), (((2, 1), (5, 5), (9, 9)), [0]),
             (((2, 1), (6, 5), (9, 9)), [1]), (((1, 1), (6, 5), (9, 9)), [0])]
    got = [h3.estimate(s, m) for s, m in cases]
    assert got == [j3.estimate(s, m) for s, m in cases] == [1.0, 1.0, 1.0, 2.0]


def test_weighted_sum_equals_jax():
    p, jp = _pair("heur/trivial_tool")
    n = p.num_movables

    def stack(mod, puzzle):
        nov, rgd = mod.NoveltyHeuristic(n), mod.RecursiveGraphDistance(puzzle)
        return mod.WeightedSumHeuristic(
            [(nov.estimate, thp.NOVELTY_WEIGHT), (lambda s, m: rgd.estimate(s), 1.0)])

    ws, jws = stack(th, p), stack(jh, jp)
    prev = p.initial_state
    for s in _walk(p, [R, U, L, U, R, D]):
        moved = [i for i in range(n) if s[i] != prev[i]] or list(range(n))
        assert ws.estimate(s, moved) == jws.estimate(s, moved)
        prev = s
    assert thp.NOVELTY_WEIGHT == jhp.NOVELTY_WEIGHT == 1e6


def test_random_action_order_equals_jax():
    a, b = thp.RandomActionOrder(), jhp.RandomActionOrder()
    assert a._perms == b._perms and len(a._perms) == 1000
    assert [a.next() for _ in range(1003)] == [b.next() for _ in range(1003)]


@pytest.mark.parametrize("mode", ["RGD", "N+RGD"])
@pytest.mark.parametrize("name", [
    "simple", "chain", "push_left", "multi_goal", "lshape", "agent_only",
    "heur/trivial", "heur/trivial_tool", "heur/trivial_tool2", "heur/transitive_pushing",
    "heur/necessary_transitive_pushing1", "heur/blocked_transitive_pushing2",
    "heur/shortest_path_tool", "heur/multiple_goals", "heur/easy_search",
])
def test_solve_host_plan_equals_jax(name, mode):
    p, jp = _pair(name)
    plan = thp.solve_host(p, mode=mode, max_expansions=50000)
    assert plan == jhp.solve_host(jp, mode=mode, max_expansions=50000)
    assert plan == [] if p.is_goal_state(p.initial_state) else p.is_valid_plan(plan)


def test_solve_host_no_solution_budget_and_mode():
    p, jp = _pair("no_solution")
    assert thp.solve_host(p) is None and jhp.solve_host(jp) is None
    p, _ = _pair("heur/shortest_path_tool")
    with pytest.raises(TimeoutError):
        thp.solve_host(p, max_expansions=1)
    with pytest.raises(TimeoutError):
        thp.solve_host(p, time_limit=-1.0)
    with pytest.raises(ValueError):
        thp.solve_host(p, mode="nope")


def test_solve_puzzle_host_planner_needs_no_device():
    p, _ = _pair("heur/trivial_tool")
    r = solve_puzzle(p, planner="host")  # the default device is never resolved
    assert r.failure_reason is None and r.plan == thp.solve_host(p)
    assert solve_puzzle(_pair("no_solution")[0], planner="host").failure_reason == "no solution"
    assert solve_puzzle(p, planner="host", time_limit=-1.0).failure_reason == "time limit"
    with pytest.raises(ValueError):
        solve_puzzle(p, planner="nope")
