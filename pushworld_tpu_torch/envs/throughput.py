"""Vectorized-environment throughput measurement.

Port of the JAX package's ``envs/throughput.py``.  The reference RL path
steps ONE environment at a time and re-renders the full observation image on
host every step (reference: python3/src/pushworld/gym_env.py:188-226,
utils/env_utils.py:44-91).  :class:`VectorEnv` advances B rollouts in
lockstep with observations rendered on the same device
(:mod:`pushworld_tpu_torch.ops.render`), so the (step, render, reward)
pipeline runs from device memory with no host round-trips.

:func:`measure_env_throughput` reports environment steps/s on one device
plus a memory-bandwidth estimate (the observation write dominates the bytes
moved), and optionally the reference-style host loop's steps/s on the same
puzzle for comparison.
"""

import time
from typing import Dict, Optional

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, card_info, resolve_device
from pushworld_tpu_torch.envs.vector_env import VectorEnv
from pushworld_tpu_torch.ops.render import (
    NUM_CHANNELS,
    compile_render_tables,
    render_cells_onehot_batched,
)

# Published device-memory bandwidth, bytes/s, by ``torch.cuda.get_device_name``
# (H100 SXM data sheet: HBM3 at 3.35 TB/s).  A card that is not listed has no
# roofline: no other card's rate stands in for it.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _device_hbm_bw(dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    return HBM_BYTES_PER_S.get(torch.cuda.get_device_name(dev))


def measure_env_throughput(
    puzzle: Puzzle,
    batch_size: int = 4096,
    horizon: int = 256,
    observations: bool = True,
    reps: int = 3,
    host_baseline_steps: int = 200,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Dict[str, object]:
    """Measures batched env steps/s on ``device``.

    Runs ``reps`` rollouts (after one warm-up rollout) of ``horizon`` steps ×
    ``batch_size`` lockstep rollouts with a uniform-random policy drawn on
    the device; when ``observations`` is set, every step also renders the
    one-hot observation tensor there.  (Execution is eager: the tensor is
    written whether or not anything reads it.)  Each rollout is timed on the
    host clock around a device synchronisation.  Returns a dict with:

    - ``steps_per_s``: env steps (B × horizon) per wall second, best rep;
    - ``obs_bytes_per_step``: device-memory bytes written per env step for
      the observation tensor (zero when observations are off);
    - ``hbm_roofline_pct``: that write traffic as % of the card's published
      memory bandwidth (a lower bound on attained bandwidth: reads of state
      and tables add more traffic); ``None`` on the CPU and on a card that
      :data:`HBM_BYTES_PER_S` does not list;
    - ``device``: the card's name and power limit (``nvidia-smi``), or
      ``{"name": "cpu", "power_limit": None}``;
    - ``host_steps_per_s``: the reference-style host loop (Python
      ``get_next_state`` + full host render per step) on the same puzzle,
      when ``host_baseline_steps`` > 0.
    """
    dev = resolve_device(device)
    cp = compile_puzzle(puzzle)
    tables = compile_render_tables(puzzle, cp, device=dev)
    env = VectorEnv(cp, max_steps=None, device=dev)
    H, W = cp.height, cp.width
    puzzle_idx = torch.zeros((batch_size,), dtype=torch.int32, device=dev)

    def run(generator: torch.Generator) -> float:
        env_state = env.reset(None, batch_size, puzzle_idx)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(horizon):
            actions = torch.randint(0, 4, (batch_size,), generator=generator, device=dev)
            env_state, next_pos, reward, _, _ = env.step(env_state, actions)
            if observations:
                render_cells_onehot_batched(tables, next_pos)
            acc = acc + reward.sum()
        return float(acc)  # waits for the device

    def generator_for(s: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(s)

    run(generator_for(seed))  # warm-up
    best = float("inf")
    for r in range(reps):
        generator = generator_for(seed + 1 + r)
        t0 = time.monotonic()
        run(generator)
        best = min(best, time.monotonic() - t0)

    steps_per_s = batch_size * horizon / best
    obs_bytes = H * W * NUM_CHANNELS * 4 if observations else 0
    bw = _device_hbm_bw(dev)
    out = {
        "steps_per_s": round(steps_per_s),
        "batch_size": batch_size,
        "horizon": horizon,
        "grid": [H, W],
        "obs_bytes_per_step": obs_bytes,
        "hbm_roofline_pct": None if bw is None else round(100.0 * steps_per_s * obs_bytes / bw, 2),
        "device": card_info() if dev.type == "cuda" else {"name": "cpu", "power_limit": None},
    }

    if host_baseline_steps:
        out["host_steps_per_s"] = round(
            _host_loop_steps_per_s(puzzle, host_baseline_steps)
        )
    return out


def _host_loop_steps_per_s(puzzle: Puzzle, steps: int) -> float:
    """Reference-style loop: host dynamics + full host render per step
    (the work `gym_env.PushWorldEnv.step` does per call, reference:
    gym_env.py:188-226)."""
    rng = np.random.default_rng(0)
    state = puzzle.initial_state
    t0 = time.monotonic()
    for _ in range(steps):
        state = puzzle.get_next_state(state, int(rng.integers(0, 4)))
        puzzle.render(state)
        if puzzle.is_goal_state(state):
            state = puzzle.initial_state
    return steps / (time.monotonic() - t0)
