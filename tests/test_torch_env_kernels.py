"""The environment step and the one-hot renderer of the port against the JAX
package, on the CPU: their plain versions (``ops.step.env_step``,
``ops.render.render_cells_onehot_batched_reference``) and the per-rollout
algorithms of ``kernels/env.cu`` and ``kernels/render.cu``.

A CUDA kernel cannot run here.  Its algorithm is written below as a numpy
loop over rollouts (the env kernel: the push masks, the closure as a
worklist on the one-word path and by rounds on the wide path, then the
goals, reward, truncation and reset, and on the multi-step path T such
steps with each rollout's state carried between them and written once; the
renderer: the staged cell grid, then the channel bits, the framed one a
share of its persistent CTAs' split at a time), behind the
kernel's own C signature: the wrappers
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
        g = [int(v) for v in _view(geom, np.int64, 30)]
        B, n, H, W, delta, P, action, abytes, pbytes, max_steps, path, ndim = g[:12]
        size, ps, as_, qs = g[12:16], g[16:20], g[20:24], g[24:28]
        T, tstride = g[28:30]
        K = 2 * delta + 1
        # The kernel's checks: rollouts and batch sizes index in 32 bits, a
        # running total needs the environment's step, and so does the
        # multi-step path, on a 1-D batch of at most 32 objects.
        if not (0 <= B < 2 ** 31 and all(0 <= v < 2 ** 31 for v in size)) or (steps is None and reward_acc) or (
                T and (actions is None or steps is None or ndim != 1 or path == 2 or n > ts.ENV_MAX_OBJECTS)):
            return 1  # cudaErrorInvalidValue

        def span(strides):
            return sum((size[d] - 1) * strides[d] for d in range(ndim)) + 1

        pos = _view(positions, np.int32, span(ps) + 2 * n)
        acts = None if actions is None else _view(actions, np.int64 if abytes == 8 else np.int32,
                                                   span(as_) + max(T - 1, 0) * tstride)
        pids = None if pidx is None else _view(pidx, np.int64 if pbytes == 8 else np.int32, span(qs))
        def table(ptr, shape):
            """A table's bytes, or on the multi-step path its bits: each
            puzzle's in 32-bit words of its own, bit k at bit k % 32 of word
            k // 32."""
            size = int(np.prod(shape[1:]))
            if not T:
                return _view(ptr, np.uint8, P * size).reshape(shape)
            words = _view(ptr, np.uint32, P * (-(-size // 32))).reshape(P, -1)
            return ((words[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(P, -1)[:, :size].reshape(shape)

        t = {"delta": delta, "H": H, "W": W,
             "static_block": table(static_block, (P, 4, n, H, W)),
             "push": table(push, (P, 4, n, n, K, K)),
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
        if T:
            # The multi-step path: a rollout's cells, steps, achieved count
            # and running total carried through T steps, written once.
            for b in range(B):
                p = 0 if pids is None else min(max(int(pids[b * qs[0]]), 0), P - 1)
                cells, s, got = pos[b * ps[0]: b * ps[0] + 2 * n].reshape(n, 2), int(st[b]), int(ach[b])
                total = None if acc is None else acc[b]
                for k in range(T):
                    a = min(max(int(acts[k * tstride + b * as_[0]]), 0), 3)
                    nxt, term, _, rew, trunc, done, s, got = env_rollout_np(cells, a, p, t, False, (s, got, max_steps))
                    if acc is not None:
                        total = np.float32(total + rew)
                    cells = init[p] if done else nxt
                out_next[b], o_pos[b], o_steps[b], o_ach[b] = nxt, cells, s, got
                o_rew[b], o_term[b], o_trunc[b] = rew, term, trunc
                if acc is not None:
                    acc[b] = total
            return 0
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


@pytest.fixture
def fused_on_the_cpu(fake_kernels, monkeypatch):
    """``VectorEnv.step`` takes a block's fused path on CPU tensors too
    (``fused_block`` up to 32 objects), through the numpy stand-in of the
    kernel."""
    def fused(device, n):
        return n <= ts.ENV_MAX_OBJECTS

    monkeypatch.setattr(tenv, "fused_block", fused)


def _port_puzzles(names):
    pz = [_load_both(n)[1] for n in names]
    return tc.compile_puzzle(pz[0]) if len(pz) == 1 else tc.compile_batch(pz)


# Stacked and single puzzles that terminate and reset inside the block, with
# a truncation horizon shorter than the block and without one.
BLOCK_CASES = [
    (("simple", "chain", "push_left", "lshape"), 11), (("simple", "chain", "push_left", "lshape"), None),
    (("chain", "agent_wall", "multi_goal"), 5), (("multi_goal",), None),
]


@pytest.mark.parametrize("names,max_steps", BLOCK_CASES)
@pytest.mark.parametrize("layout", ["int32", "int64", "int64-transposed"])
def test_env_block_kernel_algorithm_equals_one_step_calls(fused_on_the_cpu, names, max_steps, layout):
    """``VectorEnv.step`` on a (T, B) block through the multi-step path
    (``env_steps``, the wrapper, the kernel's algorithm) against T calls of
    ``VectorEnv.step`` on its rows (the plain ``env_step``): the state after
    the block, the last step's positions, reward and flags, and each
    rollout's running total, bit for bit; one ``env.steps`` launch.  The
    block is int32, int64, or int64 stored transposed (strides (1, T))."""
    from pushworld_tpu_torch.kernels import LAUNCHES

    env = tenv.VectorEnv(_port_puzzles(names), max_steps=max_steps, device="cpu")
    rng = np.random.default_rng(len(names) + (max_steps or 0))
    B, T = 24, 30
    st = env.reset(None, B, torch.as_tensor(rng.integers(0, env.num_puzzles, B).astype(np.int32)))
    for a in rng.integers(0, 4, (3, B)):  # the block starts inside the episodes
        st = env.step(st, torch.as_tensor(a))[0]
    actions = torch.as_tensor(rng.integers(0, 4, (T, B)).astype(np.int32 if layout == "int32" else np.int64))
    if layout.endswith("transposed"):
        actions = actions.t().contiguous().t()
    acc_block = torch.as_tensor(rng.random(B).astype(np.float32))
    acc_steps = acc_block.clone()
    before = (LAUNCHES["env.steps"], LAUNCHES["env.step"])
    got = env.step(st, actions, reward_acc=acc_block)
    assert (LAUNCHES["env.steps"], LAUNCHES["env.step"]) == (before[0] + 1, before[1])
    want, n_term, n_trunc = (st,), 0, 0
    for a in actions:
        want = env.step(want[0], a, reward_acc=acc_steps)
        n_term += int(want[3].sum())
        n_trunc += int(want[4].sum())
    for f in ("positions", "steps", "achieved", "puzzle_idx"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    for k, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert g.dtype == w.dtype and torch.equal(g, w), k
    assert torch.equal(acc_block, acc_steps)
    assert n_term > 0 and (n_trunc > 0 if max_steps is not None else n_trunc == 0)


def test_env_block_above_32_objects_runs_step_by_step(fused_on_the_cpu):
    """A block of 33 objects takes the per-step path: no multi-step launch,
    the results of its rows' steps."""
    from pushworld_tpu_torch.kernels import LAUNCHES

    env = tenv.VectorEnv(_port_puzzles(["many_objects_33"]), max_steps=3, device="cpu")
    st = env.reset(None, 6, torch.zeros(6, dtype=torch.int32))
    actions = torch.as_tensor(np.random.default_rng(2).integers(0, 4, (5, 6)))
    before = LAUNCHES["env.steps"]
    got = env.step(st, actions)
    want = (st,)
    for a in actions:
        want = env.step(want[0], a)
    assert LAUNCHES["env.steps"] == before
    assert torch.equal(got[0].positions, want[0].positions) and torch.equal(got[1], want[1])
    assert all(torch.equal(g, w) for g, w in zip(got[2:], want[2:]))


def test_env_block_wrapper_raises_on_what_the_kernel_does_not_take(fake_kernels):
    env = tenv.VectorEnv(_port_puzzles(["simple"]), device="cpu")
    st = env.reset(None, 6, torch.zeros(6, dtype=torch.int32))
    args = (st.steps, st.achieved, env._init_pos, env._init_achieved, None)
    for actions in (torch.zeros((0, 6), dtype=torch.int64), torch.zeros((3, 5), dtype=torch.int64),
                    torch.zeros(6, dtype=torch.int64)):
        with pytest.raises(ValueError, match="a block of actions: expected"):
            ts._env_kernel(env.puzzles, st.positions, actions, None, env=args, block=True)
    with pytest.raises(ValueError, match="a block of actions needs the environment's step"):
        ts._env_kernel(env.puzzles, st.positions, torch.zeros((2, 6), dtype=torch.int64), None, block=True)
    wide = tenv.VectorEnv(_port_puzzles(["many_objects_33"]), device="cpu")
    st = wide.reset(None, 6, torch.zeros(6, dtype=torch.int32))
    with pytest.raises(ValueError, match="a block of actions needs the environment's step .* at most 32 objects"):
        ts.env_steps(wide.puzzles, st.positions, torch.zeros((2, 6), dtype=torch.int64), st.steps, st.achieved, None,
                     wide._init_pos, wide._init_achieved, None)


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


# The multiprocessors of the card the render stand-in splits its output for
# (an H100's).
FAKE_SMS = 132


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


    @staticmethod
    def pw_render_onehot_framed(states, puzzle_idx, base, cells, cell_mask, obj_class, geom, out, B, n, C, H, W,
                                stream):
        st = _view(states, np.int32, B * n * 2).reshape(B, n, 2)
        pidx = _view(puzzle_idx, np.int32, B)
        P = int(pidx.max()) + 1
        base_ = _view(base, np.int8, P * H * W).reshape(P, H, W).astype(np.int64)
        cells_ = _view(cells, np.int16, P * n * C * 2).reshape(P, n, C, 2)
        mask_ = _view(cell_mask, np.uint8, P * n * C).reshape(P, n, C)
        cls_ = _view(obj_class, np.int8, P * n).reshape(P, n).astype(np.int64)
        geom_ = _view(geom, np.int32, P * 4).reshape(P, 4)
        o = _view(out, np.float32, B * H * W * 6)
        S = H * W * 6
        # A CTA a share (the kernel's split on a card of FAKE_SMS
        # multiprocessors), each rendering every state its share touches.
        for f0, f1 in tr.framed_shares(B, H, W, tr.framed_ctas(B, H, W, FAKE_SMS)):
            for b in range(f0 // S, -(-f1 // S)):
                p = pidx[b]
                frame = render_framed_state_np(st[b], base_[p], cells_[p], mask_[p], cls_[p], geom_[p]).reshape(-1)
                lo, hi = max(f0, b * S), min(f1, (b + 1) * S)
                o[lo:hi] = frame[lo - b * S: hi - b * S]
        return 0


def render_framed_state_np(cells_b, base, cells, mask, cls, geom):
    """One state of ``kernels/render.cu``'s framed kernel: a movable cell
    draws where it lies inside its puzzle's own grid (``geom``: top, left,
    height, width), at the puzzle's offset in the frame; the base is read
    inside the puzzle's rectangle alone, every other cell is pad."""
    top_row, left, h, w = (int(v) for v in geom)
    inside = np.zeros(base.shape, bool)
    inside[top_row: top_row + h, left: left + w] = True
    base = np.where(inside, base, 0)
    top = np.zeros(base.shape, np.int64)
    for k in range(len(cls)):
        for c in range(mask.shape[1]):
            if not mask[k, c]:
                continue
            x, y = int(cells_b[k, 0]) + int(cells[k, c, 0]), int(cells_b[k, 1]) + int(cells[k, c, 1])
            if 0 <= x < w and 0 <= y < h:
                top[y + top_row, x + left] = max(top[y + top_row, x + left], k + 1)
    cls_grid = np.where(top > 0, cls[np.maximum(top - 1, 0)], base)
    chans = [base == 1] + [cls_grid == c + 1 for c in range(1, 6)]
    return np.stack(chans, -1).astype(np.float32)


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


# (B, H, W, CTAs): the card tests' shapes (B = 1, 7, 131, 133 and 4,096 on
# 13 x 15, where H W is odd, and on 47 x 54) at the CTAs a card of 132
# multiprocessors gives, and more CTAs than quads, fewer than states, one.
SPLIT_SHAPES = ([(B, H, W, None) for B in (1, 7, 131, 133, 4096) for H, W in ((13, 15), (47, 54))]
                + [(1, 1, 1, 7), (3, 1, 1, 1), (5, 3, 3, 4), (9, 13, 15, 2), (4096, 47, 54, 264),
                   (4096, 47, 54, 132), (4096, 47, 54, 133), (77, 241, 241, 264), (2, 182, 182, 5),
                   (1000, 13, 11, 1000)])


@pytest.mark.parametrize("B,H,W,ctas", SPLIT_SHAPES)
def test_framed_render_split_covers_the_run_once(B, H, W, ctas):
    """``ops.render.framed_shares`` (the framed kernel's split): the shares
    cover every output float once, in order; every boundary but the run's
    two ends lies on a 128-byte line (so on a 16-byte boundary); shares
    differ by at most one slab; the bulk-copied bytes are the run's whole
    lines."""
    ctas = tr.framed_ctas(B, H, W, FAKE_SMS) if ctas is None else ctas
    F, S = B * H * W * 6, H * W * 6
    shares = tr.framed_shares(B, H, W, ctas)
    assert len(shares) == ctas and shares[0][0] == 0 and shares[-1][1] == F
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:])) and all(f0 <= f1 for f0, f1 in shares)
    assert all(f0 % 32 == 0 for f0, _ in shares) and all(f1 % 32 == 0 for _, f1 in shares[:-1])
    sizes = [f1 - f0 for f0, f1 in shares]
    assert max(sizes) - min(sizes) <= tr.FRAMED_SLAB_BYTES // 4
    covered = np.zeros(F, np.int64)
    for f0, f1 in shares:
        covered[f0:f1] += 1
    assert (covered == 1).all()
    # Bulk bytes: every whole 128-byte line of the run, where the buffers fit.
    assert tr.framed_bulk_bytes(B, H, W) == (128 * (F // 32) if tr.framed_bulk(H, W) else 0)


def test_framed_render_ctas_and_bulk_bytes_at_the_cells_shape():
    """At the cell's shape (B = 4,096 on 47 x 54, an H100's 132
    multiprocessors) the kernel takes 2 CTAs an SM and writes every byte by
    bulk copy (the run is whole lines); fewer CTAs where the output holds
    fewer rounds of slabs; no bulk copy where the buffers do not fit a
    CTA."""
    assert tr.framed_ctas(4096, 47, 54, 132) == 264
    assert tr.framed_bulk_bytes(4096, 47, 54) == 4096 * 47 * 54 * 24
    assert tr.framed_ctas(1, 47, 54, 132) == 2 and tr.framed_ctas(1, 1, 1, 132) == 1
    assert tr.framed_bulk(182, 182) and not tr.framed_bulk(183, 183) and tr.framed_bulk_bytes(8, 183, 183) == 0
    assert tr.framed_bulk_bytes(1, 13, 15) == 13 * 15 * 24 - 72  # a frame of 1,170 floats: a last line of 18


@pytest.mark.parametrize("frame", [(12, 13), (15, 18)])
def test_render_framed_kernel_algorithm_matches_jax_padded(fake_kernels, frame):
    """The framed kernel's algorithm through its wrapper, on states of six
    stacked fixtures of mixed sizes: = its plain version on walk and
    translated states (cells outside a puzzle draw nothing), and on walk
    states = JAX's ``render_cells_onehot_batched`` of each puzzle,
    centre zero-padded into the frame as PushWorld's standard padding
    pads."""
    pairs = [_load_both(n) for n in RENDER_FIXTURES]
    tps = [t for _, t in pairs]
    n = max(p.num_movables for p in tps)
    t_tables = tr.compile_framed_render_tables(tps, frame, n=n, device="cpu")
    rng = np.random.default_rng(frame[1])
    walks, moved, idx, want = [], [], [], []
    for i, (jpz, tpz) in enumerate(pairs):
        walk, shifted = _render_states(tpz, rng)
        j = np.asarray(jr.render_cells_onehot_batched(jr.compile_render_tables(jpz, jc.compile_puzzle(jpz)),
                                                      jnp.asarray(walk)))
        top, left = (frame[0] - tpz.height) // 2, (frame[1] - tpz.width) // 2
        want.append(np.pad(j, ((0, 0), (top, frame[0] - tpz.height - top), (left, frame[1] - tpz.width - left),
                               (0, 0))))
        pad = ((0, 0), (0, n - tpz.num_movables), (0, 0))
        walks.append(np.pad(walk, pad))
        moved.append(np.pad(shifted, pad))
        idx.append(np.full(len(walk), i, np.int32))
    idx = torch.as_tensor(np.concatenate(idx))
    for states, expect in ((np.concatenate(walks), np.concatenate(want)), (np.concatenate(moved), None)):
        s = torch.as_tensor(states)
        ref = tr.render_framed_onehot_batched_reference(t_tables, s, idx)
        out = torch.full_like(ref, float("nan"))
        assert tr._render_framed_cuda(t_tables, s, idx, out) is out
        assert out.equal(ref)
        if expect is not None:
            assert np.array_equal(ref.numpy(), expect)
