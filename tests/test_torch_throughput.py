"""The port's env-throughput measurement at a tiny size on the CPU: what it
counts (keys, bytes, sizes), and that a CPU run claims no device metric."""

import os

import pytest
import torch

from pushworld_tpu.envs import throughput as jt
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.envs import throughput as tt

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")


def test_measure_env_throughput_on_the_cpu():
    puzzle = Puzzle.from_file(os.path.join(PUZZLES, "chain.pwp"))
    out = tt.measure_env_throughput(
        puzzle, batch_size=16, horizon=8, reps=1, host_baseline_steps=16, device="cpu")
    assert out["steps_per_s"] > 0 and out["host_steps_per_s"] > 0
    assert out["batch_size"] == 16 and out["horizon"] == 8
    assert out["grid"] == [puzzle.height, puzzle.width]
    assert out["obs_bytes_per_step"] == puzzle.height * puzzle.width * 6 * 4
    # Off the card there is no roofline, and the device says so.
    assert out["hbm_roofline_pct"] is None
    assert out["device"] == {"name": "cpu", "power_limit": None}
    # The JAX function's keys, plus ``device``.
    from pushworld_tpu.core.puzzle import Puzzle as JPuzzle

    want = jt.measure_env_throughput(
        JPuzzle.from_file(os.path.join(PUZZLES, "chain.pwp")),
        batch_size=16, horizon=8, reps=1, host_baseline_steps=16)
    assert set(out) == set(want) | {"device"}
    for k in ("batch_size", "horizon", "grid", "obs_bytes_per_step"):
        assert out[k] == want[k], k


def test_measure_env_throughput_without_observations():
    puzzle = Puzzle.from_file(os.path.join(PUZZLES, "chain.pwp"))
    out = tt.measure_env_throughput(
        puzzle, batch_size=8, horizon=4, reps=1, observations=False, host_baseline_steps=0, device="cpu")
    assert out["steps_per_s"] > 0 and out["obs_bytes_per_step"] == 0
    assert "host_steps_per_s" not in out and out["hbm_roofline_pct"] is None


def test_no_roofline_on_an_unknown_card(monkeypatch):
    """The bandwidth table names the cards it knows; any other card gets no
    roofline rather than another card's rate."""
    assert tt.HBM_BYTES_PER_S == {"NVIDIA H100 80GB HBM3": 3.35e12}
    assert tt._device_hbm_bw(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "Some Other Card")
    assert tt._device_hbm_bw(torch.device("cuda", 0)) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert tt._device_hbm_bw(torch.device("cuda", 0)) == 3.35e12


def test_the_default_device_is_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tt.measure_env_throughput(Puzzle.from_text("A M0 G0\n"), batch_size=2, horizon=1, reps=1)


@pytest.mark.parametrize("observations", [False, True])
def test_rollout_reward_total_matches_jax_rewards(observations):
    """The CPU rollout on given actions returns the sum of its per-rollout
    accumulator: JAX's ``VectorEnv.step`` rewards over the same actions,
    summed in float64, within float32 reassociation: each rollout's total is
    a running float32 sum of ``horizon`` rewards, then the B totals are
    summed in float32, so the error is at most (horizon + log2 B) float32
    roundings of the rewards' absolute sum."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pushworld_tpu.core.compiled import compile_puzzle as j_compile
    from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
    from pushworld_tpu.envs.vector_env import VectorEnv as JVectorEnv
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.envs.vector_env import VectorEnv
    from pushworld_tpu_torch.ops.render import compile_render_tables

    path = os.path.join(PUZZLES, "simple.pwp")
    B, horizon = 64, 24
    actions = np.random.default_rng(5).integers(0, 4, (horizon, B))
    j_env = JVectorEnv(j_compile(JPuzzle.from_file(path)), max_steps=None)
    js = j_env.reset(jax.random.PRNGKey(0), B)
    rewards = []
    for a in actions:
        js, _, r, _, _ = j_env.step(js, jnp.asarray(a.astype(np.int32)))
        rewards.append(np.asarray(r, np.float64))
    rewards = np.asarray(rewards)
    assert (rewards == 10.0).any()  # the rollouts reach the goal, so the total depends on the actions

    puzzle = Puzzle.from_file(path)
    cp = compile_puzzle(puzzle)
    env = VectorEnv(cp, max_steps=None, device="cpu")
    total = tt.rollout(env, compile_render_tables(puzzle, cp, device="cpu"), torch.zeros(B, dtype=torch.int32),
                       horizon, observations, None, torch.as_tensor(actions))
    assert total.dtype == torch.float32 and total.shape == ()
    tol = (horizon + B.bit_length()) * 2.0 ** -24 * np.abs(rewards).sum()
    assert abs(float(total) - rewards.sum()) <= tol, (float(total), rewards.sum(), tol)
