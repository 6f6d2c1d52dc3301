"""The environment step and the one-hot renderer of the port against the JAX
package, on the CPU: their plain versions (``ops.step.env_step``,
``ops.render.render_cells_onehot_batched_reference``) and the per-rollout
algorithms of ``kernels/env.cu`` and ``kernels/render.cu``.

A CUDA kernel cannot run here.  Its algorithm is written below as a numpy
loop over rollouts (the env kernel: the push masks, the closure as a
worklist on the one-word path and by rounds on the wide path, then the
goals, reward, truncation and reset; the renderer: the staged cell grid,
then the channel bits), behind the kernel's own C signature: the wrappers
``ops.step._env_kernel`` and ``ops.render._render_onehot_cuda`` run on CPU
tensors with this stand-in for the library, so their pointers, geometry
and strides are exercised too.  Inputs are made from seeds with numpy;
everything compared is an integer, a boolean or a float32 of the same
expression: tolerance 0.
"""

import ctypes
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pushworld_tpu.core.compiled as jc
import pushworld_tpu.core.puzzle as jp
import pushworld_tpu.ops.render as jr
import pushworld_tpu_torch.core.compiled as tc
import pushworld_tpu_torch.core.puzzle as tp
from pushworld_tpu.envs import vector_env as jenv
from pushworld_tpu_torch.envs import vector_env as tenv
from pushworld_tpu_torch.ops import render as tr
from pushworld_tpu_torch.ops import step as ts

HERE = os.path.dirname(__file__)
PUZZLES = os.path.join(HERE, "puzzles")
DISP = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], np.int64)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _texts(name):
    if name.startswith("many_objects_"):
        return _smoke().many_objects_text(int(name.rsplit("_", 1)[1]))
    with open(os.path.join(PUZZLES, name + ".pwp")) as f:
        return f.read()


def _load_both(name):
    text = _texts(name)
    return jp.Puzzle.from_text(text), tp.Puzzle.from_text(text)


def _view(ptr, dtype, count):
    """``count`` elements of ``dtype`` at host address ``ptr``, writable."""
    dtype = np.dtype(dtype)
    return np.frombuffer((ctypes.c_byte * (count * dtype.itemsize)).from_address(ptr), dtype)


# ------------------------------------------------ kernels/env.cu, as a numpy loop


def _closure_one_word(push, n):
    """The one-word path: a worklist over the set bits of 32-bit masks."""
    reached = todo = 1
    while todo:
        k = (todo & -todo).bit_length() - 1
        todo &= todo - 1
        fresh = push[k] & ~reached
        reached |= fresh
        todo |= fresh
    return [bool(reached >> i & 1) for i in range(n)]


def _closure_rounds(pushes, live, n):
    """The wide path: breadth-first rounds, each testing every object not
    yet reached against the frontier's pushers."""
    reached, front = {0}, {0}
    while True:
        nxt = {j for j in range(n) if j not in reached and live[j] and any(live[k] and pushes(k, j) for k in front)}
        if not nxt:
            return [i in reached for i in range(n)]
        reached |= nxt
        front = nxt


def env_rollout_np(cells, a, p, t, wide, env=None):
    """One rollout of ``kernels/env.cu``: (next cells, terminated, achieved),
    and with ``env`` = (steps, prev achieved, max_steps) the reward,
    truncated, done, next steps and achieved."""
    n, d = len(cells), t["delta"]
    K, H, W = 2 * d + 1, t["H"], t["W"]
    live = t["obj_mask"][p].astype(bool)

    def pushes(i, j):
        rx, ry = int(cells[i, 0] - cells[j, 0]), int(cells[i, 1] - cells[j, 1])
        if abs(rx) > d or abs(ry) > d:
            return False
        return bool(t["push"][p, a, i, j, ry + d, rx + d])

    if wide:
        reached = _closure_rounds(pushes, live, n)
    else:
        masks = [sum(1 << j for j in range(n) if live[i] and live[j] and pushes(i, j)) for i in range(n)]
        reached = _closure_one_word(masks, n)
    blocked = any(t["static_block"][p, a, i, min(max(cells[i, 1], 0), H - 1), min(max(cells[i, 0], 0), W - 1)]
                  for i in range(n) if reached[i])
    moved = np.array([reached[i] and not blocked and live[i] for i in range(n)])
    nxt = (cells + DISP[a] * moved[:, None]).astype(np.int32)
    has_goal = t["goal_mask"][p].astype(bool)
    at = has_goal & (nxt == t["goal_pos"][p]).all(-1)
    terminated, got = not (has_goal & ~at).any(), int(at.sum())
    if env is None:
        return nxt, terminated, got
    steps, prev, max_steps = env
    steps += 1
    truncated = not terminated and steps >= max_steps
    done = terminated or truncated
    reward = np.float32(10.0) if terminated else np.float32(np.float32(got - prev) - np.float32(0.01))
    return nxt, terminated, got, reward, truncated, done, (0 if done else steps), (
        int(t["init_achieved"][p]) if done else got)


class FakeEnvLib:
    """``pw_env_step`` with the kernel's C signature, on host memory."""

    @staticmethod
    def pw_env_step(positions, actions, pidx, steps, achieved, static_block, push, obj_mask, goal_pos, goal_mask,
                    init_pos, init_achieved, next_pos, new_pos, new_steps, new_achieved, reward, terminated,
                    truncated, reward_acc, geom, stream):
        g = [int(v) for v in _view(geom, np.int64, 28)]
        B, n, H, W, delta, P, action, abytes, pbytes, max_steps, path, ndim = g[:12]
        size, ps, as_, qs = g[12:16], g[16:20], g[20:24], g[24:28]
        K = 2 * delta + 1
        # The kernel's checks: rollouts and batch sizes index in 32 bits, and
        # a running total needs the environment's step.
        if not (0 <= B < 2 ** 31 and all(0 <= v < 2 ** 31 for v in size)) or (steps is None and reward_acc):
            return 1  # cudaErrorInvalidValue

        def span(strides):
            return sum((size[d] - 1) * strides[d] for d in range(ndim)) + 1

        pos = _view(positions, np.int32, span(ps) + 2 * n)
        acts = None if actions is None else _view(actions, np.int64 if abytes == 8 else np.int32, span(as_))
        pids = None if pidx is None else _view(pidx, np.int64 if pbytes == 8 else np.int32, span(qs))
        t = {"delta": delta, "H": H, "W": W,
             "static_block": _view(static_block, np.uint8, P * 4 * n * H * W).reshape(P, 4, n, H, W),
             "push": _view(push, np.uint8, P * 4 * n * n * K * K).reshape(P, 4, n, n, K, K),
             "obj_mask": _view(obj_mask, np.uint8, P * n).reshape(P, n),
             "goal_pos": _view(goal_pos, np.int32, P * n * 2).reshape(P, n, 2),
             "goal_mask": _view(goal_mask, np.uint8, P * n).reshape(P, n)}
        out_next = _view(next_pos, np.int32, B * n * 2).reshape(B, n, 2)
        if steps is not None:
            t["init_achieved"] = _view(init_achieved, np.int32, P)
            init = _view(init_pos, np.int32, P * n * 2).reshape(P, n, 2)
            st, ach = _view(steps, np.int32, B), _view(achieved, np.int32, B)
            o_pos, o_steps = _view(new_pos, np.int32, B * n * 2).reshape(B, n, 2), _view(new_steps, np.int32, B)
            o_ach, o_rew = _view(new_achieved, np.int32, B), _view(reward, np.float32, B)
            o_term, o_trunc = _view(terminated, np.uint8, B), _view(truncated, np.uint8, B)
            acc = None if reward_acc is None else _view(reward_acc, np.float32, B)
        wide = path == 2 or (path == 0 and n > ts.ENV_MAX_OBJECTS)
        for b in range(B):
            # locate: 32-bit unsigned divisions over the dimensions after the
            # first, whose coordinate is what is left (a 1-D batch divides
            # nothing).
            rem, po, ao, qo = np.uint32(b), 0, 0, 0
            for d in reversed(range(1, ndim)):
                rem, c = divmod(rem, np.uint32(size[d]))
                po, ao, qo = po + int(c) * ps[d], ao + int(c) * as_[d], qo + int(c) * qs[d]
            po, ao, qo = po + int(rem) * ps[0], ao + int(rem) * as_[0], qo + int(rem) * qs[0]
            a = action if acts is None else min(max(int(acts[ao]), 0), 3)
            p = 0 if pids is None else min(max(int(pids[qo]), 0), P - 1)
            cells = pos[po: po + 2 * n].reshape(n, 2)
            if steps is None:
                out_next[b] = env_rollout_np(cells, a, p, t, wide)[0]
                continue
            nxt, term, _, rew, trunc, done, s, got = env_rollout_np(cells, a, p, t, wide,
                                                                    (int(st[b]), int(ach[b]), max_steps))
            out_next[b], o_pos[b] = nxt, (init[p] if done else nxt)
            o_steps[b], o_ach[b], o_rew[b], o_term[b], o_trunc[b] = s, got, rew, term, trunc
            if acc is not None:
                acc[b] = np.float32(acc[b] + rew)  # one float32 add a rollout (__fadd_rn)
        return 0


def _host_launch(dev, fn, *args):
    return fn(*args, None)


@pytest.fixture
def fake_kernels(monkeypatch):
    """The wrappers run on CPU tensors with the numpy stand-ins as their
    libraries."""
    libs = {"env": FakeEnvLib, "render": FakeRenderLib}
    monkeypatch.setattr(ts._build, "load", lambda name: libs[name])
    monkeypatch.setattr(ts, "launch_on", _host_launch)
    monkeypatch.setattr(tr, "launch_on", _host_launch)


def _jax_env_and_port(names, max_steps):
    pairs = [_load_both(n) for n in names]
    if len(names) == 1:
        return (jenv.VectorEnv(jc.compile_puzzle(pairs[0][0]), max_steps=max_steps),
                tc.compile_puzzle(pairs[0][1]), pairs)
    return (jenv.VectorEnv(jc.compile_batch([a for a, _ in pairs]), max_steps=max_steps),
            tc.compile_batch([b for _, b in pairs]), pairs)


def _port_env_step(cp, env, state, a, path, reward_acc=None):
    """``env_step`` (path "plain") or the kernel's algorithm through its
    wrapper (paths "auto", "one-word", "wide"), from the port's EnvState;
    each reward added to ``reward_acc`` where given."""
    pidx = env._pidx(state.puzzle_idx)
    args = (state.steps, state.achieved, env._init_pos, env._init_achieved, env.max_steps)
    if path == "plain":
        return ts.env_step(env.puzzles, state.positions, a, args[0], args[1], pidx, *args[2:], reward_acc=reward_acc)
    wide = {"auto": None, "one-word": False, "wide": True}[path]
    return ts._env_kernel(env.puzzles, state.positions, a, pidx, env=args, wide=wide, reward_acc=reward_acc)


# Single and stacked puzzles, with and without truncation, that terminate,
# truncate and reset; many_objects_33 (33 movables) takes the wide path.
ENV_CASES = [
    (("simple",), 5), (("multi_goal",), None), (("heur/two_tools",), 9),
    (("simple", "chain", "push_left", "lshape"), 11), (("chain", "agent_wall", "multi_goal"), None),
    (("many_objects_33",), 6),
]
PATHS = ("plain", "auto", "one-word", "wide")


@pytest.mark.parametrize("names,max_steps,path", [
    (*case, path) for case in ENV_CASES for path in PATHS
    if not (path == "one-word" and case[0] == ("many_objects_33",))  # at most 32 objects
] + [  # each path again, keeping each rollout's running reward total
    (*case, path + "-acc") for case in ENV_CASES[3::2] for path in PATHS
    if not (path == "one-word" and case[0] == ("many_objects_33",))
])
def test_env_step_matches_jax_vector_env(fake_kernels, names, max_steps, path):
    """JAX's ``VectorEnv.step`` against ``ops.step.env_step`` on the CPU
    (path "plain") and the env kernel's algorithm on either path: every
    output of every step equal; terminations, truncations and resets hit.
    On a path "...-acc", each rollout's running total (``reward_acc``) after
    each step equals a float32 running sum, in step order, of JAX's
    rewards."""
    path, acc = path.removesuffix("-acc"), path.endswith("-acc")
    j_env, cp, pairs = _jax_env_and_port(names, max_steps)
    t_env = tenv.VectorEnv(cp, max_steps=max_steps, device="cpu")
    B = 12 if names == ("many_objects_33",) else 24
    js = j_env.reset(jax.random.PRNGKey(len(names)), B)
    st = t_env.reset(None, B, torch.as_tensor(np.array(js.puzzle_idx)))
    rng = np.random.default_rng(len(names) + (max_steps or 0))
    n_term = n_trunc = 0
    reward_acc = torch.full((B,), 0.5) if acc else None  # a total already begun
    want_acc = np.full(B, 0.5, np.float32)
    for t, a in enumerate(rng.integers(0, 4, (16 if B == 12 else 30, B))):
        js, *j_out = j_env.step(js, jnp.asarray(a.astype(np.int32)))
        positions, steps, achieved, *t_out = _port_env_step(cp, t_env, st, torch.as_tensor(a), path, reward_acc)
        st = tenv.EnvState(positions, steps, achieved, st.puzzle_idx)
        for f in ("positions", "steps", "achieved"):
            assert np.array_equal(getattr(st, f).numpy(), np.asarray(getattr(js, f))), (t, f)
        for k, (g, w) in enumerate(zip(t_out, j_out)):
            assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype) and np.array_equal(g.numpy(),
                                                                                             np.asarray(w)), (t, k)
        want_acc = want_acc + np.asarray(j_out[1])  # float32 + float32: one rounding each
        if acc:
            assert reward_acc.dtype == torch.float32 and np.array_equal(reward_acc.numpy(), want_acc), t
        n_term += int(t_out[2].sum())
        n_trunc += int(t_out[3].sum())
    assert n_trunc > 0 if max_steps is not None else n_trunc == 0
    if names not in (("many_objects_33",), ("heur/two_tools",)):
        assert n_term > 0


def test_step_kernel_algorithm_reads_broadcast_batches(fake_kernels):
    """``step``'s transition through the env kernel's wrapper on broadcast
    and strided batches equals ``step_reference``: the greedy policy's four
    actions over a stride-0 batch, a single state and an int action, a
    transposed batch with int32 actions, five batch dimensions (flattened),
    a stacked puzzle with an expanded int64 puzzle index."""
    _, p = _load_both("heur/two_tools")
    cp = tc.compile_puzzle(p).to("cpu")
    rng = np.random.default_rng(0)
    s = p.initial_state
    states = []
    for a in rng.integers(0, 4, 40).tolist():
        s = p.get_next_state(s, a)
        states.append(s)
    pos = torch.as_tensor(np.asarray(states, np.int32))
    cases = [
        (pos[None].expand(4, *pos.shape), torch.arange(4)[:, None]),
        (pos[7], 2),
        (pos.reshape(5, 8, *pos.shape[1:]).transpose(0, 1), torch.as_tensor(rng.integers(0, 4, (8, 5)), dtype=torch.int32)),
        (pos.reshape(2, 2, 2, 5, 1, *pos.shape[1:]), torch.as_tensor(rng.integers(0, 4, (2, 2, 2, 5, 1)))),
    ]
    for state, action in cases:
        got = ts._env_kernel(cp, state, action, None)[0]
        want = ts.step_reference(cp, state, action)
        assert got.shape == want.shape and torch.equal(got, want)
    pairs = [_load_both(n)[1] for n in ("simple", "chain", "push_left")]
    cps = tc.compile_batch(pairs).to("cpu")
    states = cps.init_state[:, None].expand(3, 6, cps.n, 2)
    pidx = torch.arange(3)[:, None].expand(3, 6)
    a = torch.as_tensor(rng.integers(0, 4, (3, 6)))
    assert torch.equal(ts._env_kernel(cps, states, a, pidx)[0], ts.step_reference(cps, states, a, pidx))
    with pytest.raises(ValueError, match="reward_acc needs the environment's step"):
        ts._env_kernel(cps, states, a, pidx, reward_acc=torch.zeros(18))


# --------------------------------------------- kernels/render.cu, as a numpy loop


def render_state_np(cells_b, base, cells, mask, cls):
    """One state of ``kernels/render.cu``: the staged grid (the base, then
    the highest-indexed movable over each of its cells), then the six
    channel bits of each cell."""
    H, W = base.shape
    top = np.zeros((H, W), np.int64)
    for k in range(len(cls)):
        for c in range(mask.shape[1]):
            if not mask[k, c]:
                continue
            x, y = int(cells_b[k, 0]) + int(cells[k, c, 0]), int(cells_b[k, 1]) + int(cells[k, c, 1])
            if 0 <= x < W and 0 <= y < H:
                top[y, x] = max(top[y, x], k + 1)
    cls_grid = np.where(top > 0, cls[np.maximum(top - 1, 0)], base)
    chans = [base == 1] + [cls_grid == c + 1 for c in range(1, 6)]
    return np.stack(chans, -1).astype(np.float32)


class FakeRenderLib:
    """``pw_render_onehot`` with the kernel's C signature, on host memory."""

    @staticmethod
    def pw_render_onehot(states, base, cells, cell_mask, obj_class, out, B, n, C, H, W, stream):
        st = _view(states, np.int32, B * n * 2).reshape(B, n, 2)
        base_ = _view(base, np.int8, H * W).reshape(H, W).astype(np.int64)
        cells_ = _view(cells, np.int16, n * C * 2).reshape(n, C, 2)
        mask_ = _view(cell_mask, np.uint8, n * C).reshape(n, C)
        cls_ = _view(obj_class, np.int8, n).astype(np.int64)
        o = _view(out, np.float32, B * H * W * 6).reshape(B, H, W, 6)
        for b in range(B):
            o[b] = render_state_np(st[b], base_, cells_, mask_, cls_)
        return 0


RENDER_FIXTURES = ["lshape", "multi_goal", "chain", "agent_wall", "heur/two_tools", "heur/multiple_goals"]


def _render_states(p, rng):
    """States of a walk, and the same states translated (objects stay
    disjoint; many cells fall outside the grid)."""
    s = p.initial_state
    walk = [s]
    for a in rng.integers(0, 4, 24).tolist():
        s = p.get_next_state(s, a)
        walk.append(s)
    walk = np.asarray(walk, np.int32)
    shift = np.stack([rng.integers(-p.width, p.width + 1, len(walk)),
                      rng.integers(-p.height, p.height + 1, len(walk))], -1)
    return walk, (walk + shift[:, None, :]).astype(np.int32)


@pytest.mark.parametrize("name", RENDER_FIXTURES)
def test_render_onehot_reference_and_kernel_algorithm_match_jax(fake_kernels, name):
    """JAX's ``render_cells_onehot_batched`` against the port's plain
    version and the render kernel's algorithm through its wrapper, on walk
    states and on translated states with cells outside the grid."""
    jpz, tpz = _load_both(name)
    j_tables = jr.compile_render_tables(jpz, jc.compile_puzzle(jpz))
    t_tables = tr.compile_render_tables(tpz, tc.compile_puzzle(tpz), device="cpu")
    for states in _render_states(tpz, np.random.default_rng(len(name))):
        want = np.asarray(jr.render_cells_onehot_batched(j_tables, jnp.asarray(states)))
        ref = tr.render_cells_onehot_batched_reference(t_tables, torch.as_tensor(states))
        got = tr._render_onehot_cuda(t_tables, torch.as_tensor(states), None)
        out = torch.full_like(got, 3.0)
        assert tr._render_onehot_cuda(t_tables, torch.as_tensor(states), out) is out
        for x in (ref, got, out):
            assert x.dtype == torch.float32 and np.array_equal(x.numpy(), want)
        assert tr.render_cells_onehot_batched(t_tables, torch.as_tensor(states)).equal(ref)


def test_render_onehot_wrapper_raises_on_a_grid_too_large(fake_kernels):
    t = {"base": torch.zeros((241, 242), dtype=torch.int8), "obj_cells": torch.zeros((1, 1, 2), dtype=torch.int16),
         "obj_mask": torch.ones((1, 1), dtype=torch.bool), "obj_class": torch.full((1,), 3, dtype=torch.int8)}
    with pytest.raises(ValueError, match="241 x 242 grid needs 233288 bytes"):
        tr._render_onehot_cuda(t, torch.zeros((2, 1, 2), dtype=torch.int32), None)
