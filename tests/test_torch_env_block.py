"""``VectorEnv.step`` on a (T, B) block of actions, on the CPU: T steps of the
environment in one call, returning the last step's tuple.

On the card a block of at most 32 objects is one launch of the env kernel's
multi-step path (tests/test_torch_env_kernels.py holds its algorithm, and
tests/test_torch_cuda.py the kernel, against T one-step calls).  On the CPU
the block runs as T calls of ``env_step`` as ``vector_env`` names it, one a
row.  Here the block is held against JAX's ``VectorEnv.step`` over the same
actions and against T one-step calls of the port, bit for bit, and the
rollout without observations is held to one block step.  Inputs are made
from seeds with numpy; tolerance 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pushworld_tpu.core.compiled as jc
import pushworld_tpu.core.puzzle as jp
import pushworld_tpu_torch.core.compiled as tc
import pushworld_tpu_torch.core.puzzle as tp
from pushworld_tpu.envs import vector_env as jenv
from pushworld_tpu_torch import interop
from pushworld_tpu_torch.envs import throughput as tt
from pushworld_tpu_torch.envs import vector_env as tenv
from pushworld_tpu_torch.ops import step as ts

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
STATE_FIELDS = ("positions", "steps", "achieved", "puzzle_idx")

# Stacked puzzles that terminate and reset inside the block, with a
# truncation horizon shorter than the block and without one.
STACKS = [(("simple", "chain", "push_left", "lshape"), 9), (("simple", "chain", "push_left", "lshape"), None),
          (("chain", "agent_wall", "multi_goal"), 4)]


def _both(names, max_steps):
    """JAX's and the port's ``VectorEnv`` over the same stacked puzzles."""
    paths = [os.path.join(PUZZLES, n + ".pwp") for n in names]
    j_env = jenv.VectorEnv(jc.compile_batch([jp.Puzzle.from_file(p) for p in paths]), max_steps=max_steps)
    t_env = tenv.VectorEnv(tc.compile_batch([tp.Puzzle.from_file(p) for p in paths]), max_steps=max_steps,
                           device="cpu")
    return j_env, t_env


def _start(j_env, B, seed):
    js = j_env.reset(jax.random.PRNGKey(seed), B)
    ts_ = interop.env_state_from_numpy({f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}, device="cpu")
    return js, ts_


@pytest.mark.parametrize("names,max_steps", STACKS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_block_matches_jax_and_one_step_calls(names, max_steps, dtype):
    """A (T, B) block against JAX's ``VectorEnv.step`` over its rows and
    against T one-step calls of the port: the state after the block, the
    last step's positions, reward and flags equal, and each rollout's
    running total equal to the float32 running sum, in step order, of JAX's
    rewards; terminations, resets and truncations happen inside the
    block."""
    j_env, t_env = _both(names, max_steps)
    B, T = 24, 28
    js, st = _start(j_env, B, len(names))
    actions = np.random.default_rng(len(names) + (max_steps or 0)).integers(0, 4, (T, B)).astype(dtype)
    acc = torch.full((B,), 0.25)  # a total already begun
    got = t_env.step(st, torch.as_tensor(actions), reward_acc=acc)

    want_acc = np.full(B, 0.25, np.float32)
    n_term = n_trunc = 0
    one, acc_one = (st,), torch.full((B,), 0.25)
    for a in actions:
        js, *j_out = j_env.step(js, jnp.asarray(a.astype(np.int32)))
        one = t_env.step(one[0], torch.as_tensor(a), reward_acc=acc_one)
        want_acc = want_acc + np.asarray(j_out[1])  # float32 + float32: one rounding each
        n_term += int(np.asarray(j_out[2]).sum())
        n_trunc += int(np.asarray(j_out[3]).sum())
    for f in STATE_FIELDS:
        assert np.array_equal(getattr(got[0], f).numpy(), np.asarray(getattr(js, f))), f
        assert torch.equal(getattr(got[0], f), getattr(one[0], f)), f
    for k, (g, w) in enumerate(zip(got[1:], j_out)):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype) and np.array_equal(g.numpy(), np.asarray(w)), k
        assert torch.equal(g, one[1 + k]), k
    assert acc.dtype == torch.float32 and np.array_equal(acc.numpy(), want_acc) and torch.equal(acc, acc_one)
    assert n_term > 0 and (n_trunc > 0 if max_steps is not None else n_trunc == 0)


def test_block_runs_env_step_once_a_row_in_order(monkeypatch):
    """Off the card the block is T calls of ``env_step`` as ``vector_env``
    names it (so a stand-in put there sees every step), row t at call t,
    each given the running total."""
    _, t_env = _both(("simple", "chain"), None)
    st = t_env.reset(None, 8, torch.as_tensor(np.arange(8) % 2, dtype=torch.int32))
    actions = torch.as_tensor(np.random.default_rng(0).integers(0, 4, (5, 8)))
    acc = torch.zeros(8)
    seen = []
    real = tenv.env_step

    def counting(cp, positions, a, *args, reward_acc=None):
        seen.append((a.clone(), reward_acc is acc))
        return real(cp, positions, a, *args, reward_acc=reward_acc)

    monkeypatch.setattr(tenv, "env_step", counting)
    t_env.step(st, actions, reward_acc=acc)
    assert len(seen) == 5
    assert all(torch.equal(a, row) and given for (a, given), row in zip(seen, actions))


def test_block_needs_a_step():
    _, t_env = _both(("simple", "chain"), None)
    st = t_env.reset(None, 4, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="at least one step"):
        t_env.step(st, torch.zeros((0, 4), dtype=torch.int64))


@pytest.mark.parametrize("device,n,fused", [
    ("cuda", 1, True), ("cuda", 4, True), ("cuda", 32, True), ("cuda", 33, False), ("cpu", 4, False),
    ("cpu", 33, False),
])
def test_env_block_path(device, n, fused):
    """The block's path follows what the input shows: its device and its
    objects (the kernel's one-word path takes at most 32)."""
    assert ts.fused_block(torch.device(device), n) is fused


class _Steps:
    """Wraps an environment's ``step``: the shape of the actions of each
    call, and the last call's running total."""

    def __init__(self, env):
        self.step, self.shapes, self.acc = env.step, [], None

    def __call__(self, state, actions, reward_acc=None):
        self.shapes.append(tuple(actions.shape))
        self.acc = reward_acc
        return self.step(state, actions, reward_acc=reward_acc)


def _rollout_env(monkeypatch):
    path = os.path.join(PUZZLES, "simple.pwp")
    puzzle = tp.Puzzle.from_file(path)
    cp = tc.compile_puzzle(puzzle)
    env = tenv.VectorEnv(cp, max_steps=None, device="cpu")
    steps = _Steps(env)
    monkeypatch.setattr(env, "step", steps)
    from pushworld_tpu_torch.ops.render import compile_render_tables

    return env, compile_render_tables(puzzle, cp, device="cpu"), steps


def test_rollout_without_observations_is_one_block_step(monkeypatch):
    """Without observations the rollout is one ``env.step`` on the
    (horizon, B) block; with them, one a step.  On the same actions both
    give every rollout the same total, and the same sum."""
    env, tables, steps = _rollout_env(monkeypatch)
    B, horizon = 32, 20
    idx = torch.zeros(B, dtype=torch.int32)
    actions = torch.as_tensor(np.random.default_rng(4).integers(0, 4, (horizon + 3, B)))
    total = tt.rollout(env, tables, idx, horizon, False, None, actions)
    assert steps.shapes == [(horizon, B)]
    totals = steps.acc.clone()
    steps.shapes.clear()
    assert float(tt.rollout(env, tables, idx, horizon, True, None, actions)) == float(total)
    assert steps.shapes == [(B,)] * horizon and torch.equal(steps.acc, totals)
    steps.shapes.clear()
    assert float(tt.rollout(env, tables, idx, 0, False, None, actions)) == 0.0 and steps.shapes == []


def test_rollout_draws_its_block_in_one_draw(monkeypatch):
    """With a generator, the observation-free rollout draws the block with
    one ``torch.randint(0, 4, (horizon, B))``: the same seed gives the
    total of those actions, and leaves the generator where that draw
    does."""
    env, tables, _ = _rollout_env(monkeypatch)
    B, horizon = 16, 12
    idx = torch.zeros(B, dtype=torch.int32)
    gen, ref = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    total = tt.rollout(env, tables, idx, horizon, False, gen)
    drawn = torch.randint(0, 4, (horizon, B), generator=ref)
    assert float(total) == float(tt.rollout(env, tables, idx, horizon, False, None, drawn))
    assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.parametrize("observations", [False, True])
def test_rollout_raises_on_fewer_rows_of_actions_than_steps(monkeypatch, observations):
    """Given actions, a rollout of ``horizon`` steps needs ``horizon`` rows
    of them, with observations and without: fewer raise, and no step runs."""
    env, tables, steps = _rollout_env(monkeypatch)
    B, horizon = 8, 10
    actions = torch.zeros((horizon - 1, B), dtype=torch.int64)
    with pytest.raises(ValueError, match="10 steps need as many rows of actions, got 9"):
        tt.rollout(env, tables, torch.zeros(B, dtype=torch.int32), horizon, observations, None, actions)
    assert steps.shapes == []
