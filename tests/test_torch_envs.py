"""Port environments vs the JAX package: ``VectorEnv`` (single puzzle and a
stacked batch), the greedy policy's values, and the Gym / dm_env wrappers.

The same actions, made from a seed with numpy, drive both packages; the JAX
``EnvState`` is carried into the port through ``interop.env_state_from_numpy``.
States and flags are integers and booleans and rewards the same float32
expressions: tolerance 0.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pushworld_tpu.core.compiled as jc
import pushworld_tpu.core.puzzle as jp
import pushworld_tpu_torch.core.compiled as tc
import pushworld_tpu_torch.core.puzzle as tp
from pushworld_tpu.envs import policies as jpol
from pushworld_tpu.envs import vector_env as jenv
from pushworld_tpu.ops import rgd as jrgd
from pushworld_tpu_torch import interop
from pushworld_tpu_torch.envs import policies as tpol
from pushworld_tpu_torch.envs import vector_env as tenv
from pushworld_tpu_torch.ops import rgd as trgd

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
STATE_FIELDS = ("positions", "steps", "achieved", "puzzle_idx")


def _load_both(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return jp.Puzzle.from_file(path), tp.Puzzle.from_file(path)


def _state_arrays(js):
    return {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}


def _assert_state_equal(ts, js, what):
    for f in STATE_FIELDS:
        got, want = getattr(ts, f), np.asarray(getattr(js, f))
        assert got.dtype == torch.int32, (what, f)
        assert np.array_equal(got.numpy(), want), (what, f)


def _run_both(j_env, t_env, js, ts, actions):
    """Steps both environments through ``actions`` (T, B), comparing every
    output of every step."""
    for t, a in enumerate(actions):
        js, j_obs, j_rew, j_term, j_trunc = j_env.step(js, jnp.asarray(a))
        ts, t_obs, t_rew, t_term, t_trunc = t_env.step(ts, torch.as_tensor(a))
        _assert_state_equal(ts, js, t)
        assert t_obs.dtype == torch.int32 and np.array_equal(t_obs.numpy(), np.asarray(j_obs)), t
        assert t_rew.dtype == torch.float32 and np.array_equal(t_rew.numpy(), np.asarray(j_rew)), t
        assert t_term.dtype == torch.bool and np.array_equal(t_term.numpy(), np.asarray(j_term)), t
        assert t_trunc.dtype == torch.bool and np.array_equal(t_trunc.numpy(), np.asarray(j_trunc)), t
    return js, ts


@pytest.mark.parametrize("name,max_steps", [
    ("simple", 5), ("multi_goal", None), ("lshape", 7), ("heur/two_tools", 9), ("agent_wall", None),
])
def test_single_puzzle_steps_match_jax(name, max_steps):
    jpz, tpz = _load_both(name)
    j_env = jenv.VectorEnv(jc.compile_puzzle(jpz), max_steps=max_steps)
    t_env = tenv.VectorEnv(tc.compile_puzzle(tpz), max_steps=max_steps, device="cpu")
    B = 24
    js = j_env.reset(jax.random.PRNGKey(0), B)
    ts = interop.env_state_from_numpy(_state_arrays(js), device="cpu")
    _assert_state_equal(t_env.reset(None, B, torch.zeros(B, dtype=torch.int32)), js, "reset")
    actions = np.random.default_rng(len(name)).integers(0, 4, (30, B)).astype(np.int32)
    _run_both(j_env, t_env, js, ts, actions)


def test_stacked_puzzles_steps_match_jax():
    names = ["simple", "chain", "push_left", "lshape"]
    pairs = [_load_both(n) for n in names]
    j_env = jenv.VectorEnv(jc.compile_batch([a for a, _ in pairs]), max_steps=11)
    t_env = tenv.VectorEnv(tc.compile_batch([b for _, b in pairs]), max_steps=11, device="cpu")
    assert t_env.num_puzzles == j_env.num_puzzles == 4
    B = 40
    js = j_env.reset(jax.random.PRNGKey(5), B)
    idx = np.array(js.puzzle_idx)
    assert len(np.unique(idx)) == 4
    ts = t_env.reset(None, B, torch.as_tensor(idx))
    _assert_state_equal(ts, js, "reset")
    actions = np.random.default_rng(2).integers(0, 4, (40, B)).astype(np.int32)
    js, ts = _run_both(j_env, t_env, js, ts, actions)
    # Every rollout follows the oracle of its own puzzle, auto-resets included.
    for b in range(B):
        p = pairs[idx[b]][1]
        s, steps = p.initial_state, 0
        for a in actions[:, b].tolist():
            s, steps = p.get_next_state(s, a), steps + 1
            if p.is_goal_state(s) or steps >= 11:
                s, steps = p.initial_state, 0
        assert ts.positions[b, : p.num_movables].tolist() == [list(xy) for xy in s], b
        assert int(ts.steps[b]) == steps


def test_reward_schedule_truncation_and_auto_reset():
    """The reference's schedule on the port alone: -0.01 a step, +1 / -1 per
    goal gained or lost, +10 and a reset at the goal; truncation excludes
    termination and resets too."""
    L, R, U, D = range(4)
    _, simple = _load_both("simple")
    env = tenv.VectorEnv(tc.compile_puzzle(simple), max_steps=2, device="cpu")
    st = env.reset(None, 3, torch.zeros(3, dtype=torch.int32))
    st, _, rew, term, trunc = env.step(st, torch.full((3,), R))
    assert rew.tolist() == [np.float32(-0.01)] * 3 and not term.any() and not trunc.any()
    st, obs, rew, term, trunc = env.step(st, torch.tensor([R, L, R]))
    assert rew.tolist() == [10.0, np.float32(-0.01), 10.0]
    assert term.tolist() == [True, False, True] and trunc.tolist() == [False, True, False]
    assert (st.steps == 0).all() and (st.positions == env.puzzles.init_state).all()
    assert bool((obs[0] != st.positions[0]).any())  # the observation is the pre-reset state

    _, multi = _load_both("multi_goal")
    env = tenv.VectorEnv(tc.compile_puzzle(multi), device="cpu")
    st = env.reset(None, 2, torch.zeros(2, dtype=torch.int32))
    for a, want in [(D, -0.01), (R, -0.01), (U, 0.99), (U, -0.01), (L, -0.01), (U, -0.01), (R, -1.01)]:
        st, _, rew, term, trunc = env.step(st, torch.full((2,), a))
        np.testing.assert_allclose(rew.numpy(), want, atol=1e-6)
        assert not term.any() and not trunc.any()


def test_reset_draws_from_the_generator():
    pairs = [_load_both(n) for n in ["simple", "chain", "push_left"]]
    env = tenv.VectorEnv(tc.compile_batch([b for _, b in pairs]), device="cpu")
    a = env.reset(torch.Generator().manual_seed(7), 64)
    b = env.reset(torch.Generator().manual_seed(7), 64)
    c = env.reset(torch.Generator().manual_seed(8), 64)
    assert a.puzzle_idx.dtype == torch.int32 and a.puzzle_idx.shape == (64,)
    assert torch.equal(a.puzzle_idx, b.puzzle_idx) and not torch.equal(a.puzzle_idx, c.puzzle_idx)
    assert set(a.puzzle_idx.tolist()) == {0, 1, 2}
    assert torch.equal(a.positions, env.puzzles.init_state[a.puzzle_idx.long()])
    assert (a.steps == 0).all()
    with pytest.raises(ValueError):
        env.reset(None, 4, torch.tensor([0, 1, 2, 3]))  # no fourth puzzle
    with pytest.raises(ValueError):
        env.reset(None, 4, torch.tensor([0, 1]))
    with pytest.raises(ValueError):
        env.reset(None, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tenv.VectorEnv(tc.compile_puzzle(pairs[0][1]))  # the default asks for the card


def test_rollout_with_a_random_policy():
    pairs = [_load_both(n) for n in ["simple", "chain", "push_left"]]
    env = tenv.VectorEnv(tc.compile_batch([b for _, b in pairs]), max_steps=20, device="cpu")

    def random_policy(generator, positions):
        return torch.randint(0, 4, (positions.shape[0],), generator=generator)

    final, (rewards, terms) = env.rollout(torch.Generator().manual_seed(7), random_policy, 64, 50)
    assert rewards.shape == (50, 64) and rewards.dtype == torch.float32
    assert terms.shape == (50, 64) and terms.dtype == torch.bool
    assert len(final.puzzle_idx.unique()) > 1
    assert bool(((rewards == 10.0) == terms).all())
    again, (rewards2, _) = env.rollout(torch.Generator().manual_seed(7), random_policy, 64, 50)
    assert torch.equal(rewards, rewards2) and torch.equal(final.positions, again.positions)


@pytest.mark.parametrize("name", ["simple", "heur/trivial_tool", "heur/multiple_goals"])
def test_greedy_policy_values_match_jax(name):
    jpz, tpz = _load_both(name)
    jcp, tcp = jc.compile_puzzle(jpz), tc.compile_puzzle(tpz)
    j_tables = jrgd.build_rgd_tables(jpz, jcp)
    t_tables = trgd.build_rgd_tables(tpz, tcp, device="cpu")
    rng = np.random.default_rng(len(name))
    states = [tpz.initial_state]
    for _ in range(4):
        s = tpz.initial_state
        for a in rng.integers(0, 4, 8).tolist():
            s = tpz.get_next_state(s, a)
            states.append(s)
    states = np.asarray(states, np.int32)

    def jax_values(positions):
        from pushworld_tpu.ops.step import step

        return jnp.stack([
            jrgd.rgd_heuristic(
                j_tables, jax.vmap(step, in_axes=(None, 0, None))(jcp, positions, np.int32(a)), max_depth=0)
            for a in range(4)], axis=1)

    want = np.asarray(jax_values(jnp.asarray(states)))
    got = tpol.successor_values(tcp.to("cpu"), t_tables, torch.as_tensor(states))
    assert got.dtype == torch.float32 and got.shape == (len(states), 4)
    assert np.array_equal(got.numpy(), want)
    # With the noise below the values' resolution, the action is an argmin of
    # the values in both packages.
    actions = tpol.greedy_goal_distance_actions(
        tcp.to("cpu"), t_tables, torch.Generator().manual_seed(0), torch.as_tensor(states))
    j_actions = np.asarray(jpol.greedy_goal_distance_actions(
        jcp, j_tables, jax.random.PRNGKey(0), jnp.asarray(states)))
    assert actions.dtype == torch.int32
    rows = np.arange(len(states))
    assert np.array_equal(want[rows, actions.numpy()], want.min(1))
    assert np.array_equal(want[rows, j_actions], want.min(1))


def test_greedy_goal_distance_policy_solves_simple():
    _, tpz = _load_both("simple")
    cp = tc.compile_puzzle(tpz)
    tables = trgd.build_rgd_tables(tpz, cp, device="cpu")
    env = tenv.VectorEnv(cp, max_steps=30, device="cpu")
    policy = tpol.make_greedy_policy(env.puzzles, tables)
    _, (rewards, terms) = env.rollout(torch.Generator().manual_seed(3), policy, batch_size=32, horizon=20)
    # Greedy goal-distance reaches the 2-step goal quickly in every rollout.
    assert bool(terms.any(dim=0).all())
    assert bool((rewards[terms] == 10.0).all())


def _episode(env_cls, path, actions, is_gym):
    env = env_cls(path, max_steps=6, pixels_per_cell=8)
    out = []
    first = env.reset(seed=11)
    out.append((first[0] if is_gym else first.observation, None, None, None))
    for a in actions:
        r = env.step(a)
        if is_gym:
            obs, reward, term, trunc, info = r
            out.append((obs, reward, term, trunc))
            assert info["puzzle_state"] == env.current_state
        else:
            out.append((r.observation, r.reward, r.last(), r.step_type))
    return env, out


def test_gym_wrapper_matches_jax_package():
    pytest.importorskip("gymnasium", reason="gymnasium not installed")
    from pushworld_tpu.envs.gym_env import PushWorldEnv as JEnv
    from pushworld_tpu_torch.envs.gym_env import PushWorldEnv as TEnv

    actions = [1, 3, 0, 1, 1, 2, 2, 1]
    for path in (os.path.join(PUZZLES, "simple.pwp"), os.path.join(PUZZLES, "heur")):
        j_env, want = _episode(JEnv, path, actions[:6], True)
        t_env, got = _episode(TEnv, path, actions[:6], True)
        assert t_env.observation_space == j_env.observation_space
        assert t_env.action_space == j_env.action_space
        for (go, gr, gt, gtr), (wo, wr, wt, wtr) in zip(got, want):
            assert go.dtype == np.float32 and np.array_equal(go, wo)
            assert (gr, gt, gtr) == (wr, wt, wtr)
        assert got[-1][3] is True  # truncated at max_steps
        assert np.array_equal(t_env.render(), j_env.render()) and t_env.render().dtype == np.uint8
    env = TEnv(os.path.join(PUZZLES, "simple.pwp"), pixels_per_cell=8)
    with pytest.raises(RuntimeError):
        env.step(0)
    env.reset()
    with pytest.raises(ValueError):
        env.step(17)
    _, r, term, trunc, _ = env.step(1)
    assert r == pytest.approx(-0.01) and not term and not trunc
    _, r, term, trunc, _ = env.step(1)
    assert r == 10.0 and term
    with pytest.raises(ValueError):
        TEnv(os.path.join(os.path.dirname(PUZZLES), "goldens"))  # no puzzles there


def test_dm_env_wrapper_matches_jax_package():
    pytest.importorskip("dm_env", reason="dm_env not installed")
    from pushworld_tpu.envs.dm_env_impl import PushWorldEnv as JEnv
    from pushworld_tpu_torch.envs.dm_env_impl import PushWorldEnv as TEnv

    actions = [1, 3, 0, 1, 1, 2]
    for path in (os.path.join(PUZZLES, "simple.pwp"), os.path.join(PUZZLES, "heur")):
        j_env, want = _episode(JEnv, path, actions, False)
        t_env, got = _episode(TEnv, path, actions, False)
        assert t_env.observation_spec() == j_env.observation_spec()
        assert t_env.action_spec() == j_env.action_spec()
        for (go, gr, gl, gs), (wo, wr, wl, ws) in zip(got, want):
            assert go.dtype == np.float32 and np.array_equal(go, wo)
            assert (gr, gl, gs) == (wr, wl, ws)
        assert got[-1][2] is True  # a termination TimeStep at truncation
        assert np.array_equal(t_env.render(), j_env.render()) and t_env.render().dtype == np.float32
    env = TEnv(os.path.join(PUZZLES, "simple.pwp"), pixels_per_cell=8)
    assert env.reset().first()
    assert env.step(1).reward == pytest.approx(-0.01)
    ts = env.step(1)
    assert ts.last() and ts.reward == 10.0


def test_env_modules_import_without_gym_and_dm_env():
    """The package, the batched env, the policy and the throughput module
    need neither optional package: importing them with both names blocked in
    ``sys.modules`` works, and only the two wrapper modules fail.  In a
    process of its own, so that no other test sees half-imported modules."""
    import subprocess

    code = """
import importlib, sys
for blocked in ("gymnasium", "gym", "dm_env"):
    sys.modules[blocked] = None  # import raises ImportError
pkg = importlib.import_module("pushworld_tpu_torch")
assert pkg.Actions.TO_CHAR == "LRUD" and pkg.Puzzle.from_text("A M0 G0\\n").num_movables == 2
for mod in ("envs", "envs.vector_env", "envs.policies", "envs.throughput", "envs.env_utils",
            "ops.render", "interop"):
    importlib.import_module("pushworld_tpu_torch." + mod)
for mod in ("envs.gym_env", "envs.dm_env_impl"):
    try:
        importlib.import_module("pushworld_tpu_torch." + mod)
    except ImportError:
        continue
    raise AssertionError(mod + " imported without its package")
assert "jax" not in sys.modules and "pushworld_tpu" not in sys.modules
print("imports ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "imports ok", run.stderr
