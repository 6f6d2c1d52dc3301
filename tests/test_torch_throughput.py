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
