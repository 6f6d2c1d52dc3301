"""The port's native bridge vs the JAX package's (``native/bridge.py``).

Both bridges load a library built from a byte-equal ``planner.cc``, so the
same puzzle, mode, queue discipline and seed must give the same plan and the
same exceptions: every comparison here is exact.  ``build_graphs_native``
is also held against the port's Python worklist fixpoint and against the JAX
bridge's ``E`` on every fixture.
"""

import glob
import os
import threading
import time

import numpy as np
import pytest

import pushworld_tpu.native.bridge as jbridge
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.native import bridge
from pushworld_tpu_torch.ops import rgd

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
FIXTURES = sorted(
    os.path.relpath(f, PUZZLES)[:-4]
    for f in glob.glob(os.path.join(PUZZLES, "*.pwp")) + glob.glob(os.path.join(PUZZLES, "heur", "*.pwp"))
)
UNSOLVABLE = ["no_solution", "overlap", "spill_grid_unreachable"]
SOLVABLE = [n for n in FIXTURES if n not in UNSOLVABLE]
QUEUES = ["lifo", "fifo", "lifo+lazy", "lifo+pref", "lifo+eps", "lifo+pref+eps",
          "fifo+pref", "lifo+la", "lifo+gnov", "lifo+pref+la+eps", "fifo+la",
          "lifo+la+gnov", "lifo+eps+gnov"]

# A 16 x 16 puzzle (4 movables, 3 goals, RGD depth 0) on which the native
# planner runs out a 20 s budget in every stage of its schedule.
HARD = """
 .  .  .  W  .  .  .  .  .  W  .  .  .  .  .  W
 .  .  .  .  W  .  .  W  .  W  .  .  .  .  .  .
 .  .  .  A  .  W  .  .  W  W  .  .  .  .  .  .
 W  W  W  .  .  .  .  .  .  .  .  .  .  .  .  .
 .  .  .  .  .  .  .  .  .  .  .  .  .  .  .  W
 .  .  W  .  W  W  .  W  .  W  .  . G0  . M0  .
 .  .  .  .  .  .  .  W  W  .  .  . G0  . M0  .
 .  W  .  .  .  .  W  .  . M1  .  .  .  .  W  W
 W  W  .  .  .  .  .  .  W M1  W  .  .  .  .  .
 .  .  .  W  .  W  .  W  .  .  .  .  W  .  .  .
 .  .  .  .  .  . M2 M2  .  .  .  .  W  .  .  .
 .  W  .  .  .  .  .  .  . G1  .  .  .  .  .  .
 .  .  .  W  .  .  .  .  . G1  .  .  .  .  .  .
 .  W  W  .  . M3 M3  .  .  .  .  .  .  W  .  W
 .  .  .  .  .  .  .  .  .  .  .  .  W  .  .  .
 .  .  .  .  .  .  .  .  . G2 G2  .  .  .  .  .
""".lstrip("\n")


def _pair(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return Puzzle.from_file(path), JPuzzle.from_file(path)


def _outcome(fn, *args, **kwargs):
    """The plan, or the name of the exception the call raised."""
    try:
        return fn(*args, **kwargs)
    except (TimeoutError, MemoryError, RuntimeError) as e:
        return type(e).__name__


def test_available_and_built_outside_the_jax_package():
    assert bridge.is_available() and jbridge.is_available()
    lib = bridge.library_path()
    assert lib.exists() and lib.parent.name == ".torch_ext_build"
    assert bridge._lib._name == str(lib)


def test_planner_sources_are_byte_equal():
    with open(bridge._SRC, "rb") as a, open(jbridge._SRC, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", ["RGD", "N+RGD"])
@pytest.mark.parametrize("name", SOLVABLE)
def test_solve_native_plan_equals_jax_bridge(name, mode):
    p, jp = _pair(name)
    plan = bridge.solve_native(p, mode=mode, max_expansions=500000)
    assert plan == jbridge.solve_native(jp, mode=mode, max_expansions=500000)
    assert plan == [] if p.is_goal_state(p.initial_state) else p.is_valid_plan(plan)


@pytest.mark.parametrize("name", UNSOLVABLE)
def test_no_solution(name):
    p, jp = _pair(name)
    assert bridge.solve_native(p, max_expansions=500000) is None
    assert jbridge.solve_native(jp, max_expansions=500000) is None
    assert bridge.solve_native_staged(p, time_limit=60) is None


@pytest.mark.parametrize("queue", QUEUES + ["lifo+dead", "lifo+prune"])
def test_queue_disciplines_equal_jax_bridge(queue):
    for name in ["chain", "multi_goal", "heur/two_tools", "no_solution"]:
        p, jp = _pair(name)
        got = _outcome(bridge.solve_native, p, max_expansions=500000, queue=queue)
        want = _outcome(jbridge.solve_native, jp, max_expansions=500000, queue=queue)
        assert got == want, (name, queue)
        if name != "no_solution":
            assert p.is_valid_plan(got), (name, queue)
        elif queue in QUEUES:
            assert got is None
        else:  # pruning disciplines are incomplete: exhaustion is a budget end
            assert got == "TimeoutError"


@pytest.mark.parametrize("seed", [0, 1, 2, 17])
def test_seed_streams_equal_jax_bridge(seed):
    p, jp = _pair("chain")
    plan = bridge.solve_native(p, seed=seed, max_expansions=500000)
    assert plan == jbridge.solve_native(jp, seed=seed, max_expansions=500000)
    assert p.is_valid_plan(plan)


def test_unknown_queue_token():
    with pytest.raises(ValueError):
        bridge.solve_native(_pair("chain")[0], queue="lifo+nope")


def test_budget_memory_and_cancel_raise_as_the_jax_bridge_does():
    p, jp = _pair("heur/shortest_path_tool")
    for b, q in ((bridge, p), (jbridge, jp)):
        with pytest.raises(TimeoutError, match="budget"):
            b.solve_native(q, max_expansions=1)
    hard, jhard = Puzzle.from_text(HARD), JPuzzle.from_text(HARD)
    for b, q in ((bridge, hard), (jbridge, jhard)):
        with pytest.raises(MemoryError):
            b.solve_native(q, time_limit=30, mem_limit_gb=0.001)
        cancel = np.ones(1, np.int32)
        with pytest.raises(TimeoutError, match="cancelled"):
            b.solve_native(q, time_limit=30, cancel=cancel)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="budget"):
            b.solve_native(q, time_limit=0.3)
        assert time.monotonic() - t0 < 20.0


def test_cancel_flag_releases_a_running_solve():
    hard = Puzzle.from_text(HARD)
    cancel = np.zeros(1, np.int32)
    timer = threading.Timer(0.3, lambda: cancel.__setitem__(0, 1))
    timer.start()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="cancelled"):
        bridge.solve_native(hard, time_limit=60.0, cancel=cancel)
    assert 0.25 < time.monotonic() - t0 < 30.0  # the budget is 60 s


@pytest.mark.parametrize("name", ["heur/two_tools", "heur/three_tools", "spill_grid"])
def test_staged_equals_jax_bridge(name):
    p, jp = _pair(name)
    plan = bridge.solve_native_staged(p, time_limit=30)
    assert plan == jbridge.solve_native_staged(jp, time_limit=30) and p.is_valid_plan(plan)
    for b, q in ((bridge, p), (jbridge, jp)):
        with pytest.raises(TimeoutError):
            b.solve_native_staged(q, time_limit=1e-4)
    assert bridge.solve_native_staged(p, mode="RGD", time_limit=30) == jbridge.solve_native_staged(
        jp, mode="RGD", time_limit=30)


def test_stages_equal_jax_bridge():
    assert bridge.STAGES_DEFAULT == jbridge.STAGES_DEFAULT
    assert bridge.STAGES_EASY == jbridge.STAGES_EASY
    for name in (None, "", "level1/A", "level2/Spiral", "level3/X", "level4/Y", "heur/two_tools"):
        assert bridge.stages_for(name) == jbridge.stages_for(name)
    assert bridge.stages_for("level2/Spiral") is bridge.STAGES_EASY
    assert abs(sum(s[3] for s in bridge.STAGES_DEFAULT) - 1.0) < 1e-9


@pytest.mark.parametrize("name", FIXTURES + ["ref/multiple_goals", "ref/transitive_pushing"])
def test_build_graphs_native_equals_worklist_and_jax_bridge(name):
    p, jp = _pair(name)
    cp = compile_puzzle(p)
    E = bridge.build_graphs_native(p, cp)
    assert E.dtype == np.uint8 and E.shape == (4, p.num_movables, p.height, p.width)
    assert np.array_equal(E.astype(bool), rgd._movement_graphs_python(p, cp))
    assert np.array_equal(E, jbridge.build_graphs_native(jp))
    assert np.array_equal(rgd._movement_graphs_host(p, cp), E.astype(bool))


def test_movement_graphs_fall_back_to_the_worklist(monkeypatch):
    p, _ = _pair("heur/two_tools")
    cp = compile_puzzle(p)
    want = rgd._movement_graphs_host(p, cp)
    monkeypatch.setattr(bridge, "is_available", lambda: False)
    monkeypatch.setattr(bridge, "build_graphs_native", None)  # must not be reached
    assert np.array_equal(rgd._movement_graphs_host(p, cp), want)
