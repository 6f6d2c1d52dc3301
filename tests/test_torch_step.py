"""Port dynamics vs the JAX package's ``ops/step.py`` (exact equality)."""

import glob
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.ops import step as tstep

# pushworld_tpu.ops re-exports the function ``step`` under the module's name.
jstep = importlib.import_module("pushworld_tpu.ops.step")

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
FIXTURES = sorted(
    os.path.relpath(f, PUZZLES)[:-4]
    for f in glob.glob(os.path.join(PUZZLES, "**", "*.pwp"), recursive=True)
)


def _reachable(puzzle, count, seed):
    """Random-walk sample of reachable states, (count, N, 2) int32."""
    rng = np.random.default_rng(seed)
    s = puzzle.initial_state
    out = [s]
    for _ in range(count - 1):
        for a in rng.integers(0, 4, size=rng.integers(1, 5)).tolist():
            s = puzzle.get_next_state(s, a)
        out.append(s)
    return np.asarray(out, np.int32)


# JAX compiles once per puzzle shape, so the JAX comparison takes a subset;
# every fixture is held against the host oracle.
JAX_FIXTURES = ["chain", "overlap", "lshape", "multi_goal", "heur/three_tools",
                "heur/two_tools", "heur/multiple_goals", "spill_grid_unreachable"]


def _children(p, cp, parents):
    contacts, mask = tstep.build_contact_lists(cp)
    return tstep.expand_children(
        cp.to("cpu"), torch.as_tensor(contacts), torch.as_tensor(mask), torch.as_tensor(parents)
    )


@pytest.mark.parametrize("name", JAX_FIXTURES)
def test_expand_children_matches_jax(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    p, jpz = Puzzle.from_file(path), JPuzzle.from_file(path)
    cp, jcp = compile_puzzle(p), j_compile(jpz)
    parents = _reachable(p, 24, seed=len(name))
    contacts, mask = tstep.build_contact_lists(cp)
    jcontacts, jmask = jstep.build_contact_lists(jcp)
    assert np.array_equal(contacts, jcontacts) and np.array_equal(mask, jmask)
    got = _children(p, cp, parents)
    want = jstep.expand_children(jcp, jnp.asarray(jcontacts), jnp.asarray(jmask), jnp.asarray(parents))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", FIXTURES)
def test_expand_children_matches_oracle(name):
    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    parents = _reachable(p, 24, seed=len(name))
    got = _children(p, compile_puzzle(p), parents)
    # Action-block order: child a*B + b is parent b under action a.
    B = len(parents)
    for a in range(4):
        for b in range(B):
            nxt = p.get_next_state(tuple(map(tuple, parents[b])), a)
            assert tuple(map(tuple, got[a * B + b].tolist())) == nxt


@pytest.mark.parametrize("name", ["chain", "blocked_chain", "multi_goal", "lshape",
                                  "agent_wall", "heur/three_tools", "heur/two_tools"])
def test_step_goal_and_run_plan_match_jax(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    p, jpz = Puzzle.from_file(path), JPuzzle.from_file(path)
    cp, jcp = compile_puzzle(p).to("cpu"), j_compile(jpz)
    states = _reachable(p, 32, seed=3)
    rng = np.random.default_rng(5)
    actions = rng.integers(0, 4, size=len(states)).astype(np.int32)

    got = tstep.step(cp, torch.as_tensor(states), torch.as_tensor(actions))
    want = jstep.step_batch(jcp, jnp.asarray(states), jnp.asarray(actions))
    assert np.array_equal(got.numpy(), np.asarray(want))
    one = tstep.step(cp, torch.as_tensor(states[0]), int(actions[0]))
    assert np.array_equal(one.numpy(), np.asarray(want)[0])

    goal_states = np.concatenate([states, np.asarray(jcp.goal_pos)[None]], 0)
    goal_states[-1, 0] = states[0, 0]
    assert np.array_equal(
        tstep.is_goal_state(cp, torch.as_tensor(goal_states)).numpy(),
        np.asarray([jstep.is_goal_state(jcp, jnp.asarray(s)) for s in goal_states]),
    )
    assert np.array_equal(
        tstep.count_achieved_goals(cp, torch.as_tensor(goal_states)).numpy(),
        np.asarray([jstep.count_achieved_goals(jcp, jnp.asarray(s)) for s in goal_states]),
    )

    plan = rng.integers(0, 4, size=10).astype(np.int32)
    final, traj = tstep.run_plan(cp, torch.as_tensor(plan), return_states=True)
    jfinal, jtraj = jstep.run_plan(jcp, jnp.asarray(plan), return_states=True)
    assert np.array_equal(final.numpy(), np.asarray(jfinal))
    assert np.array_equal(traj.numpy(), np.asarray(jtraj))
    assert tuple(map(tuple, final.tolist())) == p.apply_plan(plan.tolist())
