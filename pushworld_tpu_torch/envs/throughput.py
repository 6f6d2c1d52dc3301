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

The JAX package runs a rollout as one jitted ``lax.scan`` over the action
draw, the step, the render and the reward sum
(pushworld_tpu/envs/throughput.py:82-104).  Here, on the card, the same
rollout (:func:`rollout`: ``horizon`` steps of the draw, ``VectorEnv.step``
(one ``kernels/env.cu`` launch, which also adds each rollout's reward to
its running total) and the render (one ``kernels/render.cu`` launch), then
the sum of the totals) is captured once into a CUDA graph
(:class:`RolloutGraph`), and a timed rollout is one graph launch and one
synchronisation: two kernels a step, three with observations.  On the CPU
it runs eagerly.

The reward total is the sum of JAX's ``acc + reward.sum()`` a step, taken
in another association: each rollout's rewards first, in step order (one
float32 add a step, inside the step kernel), then the B rollouts' totals,
once.  The two agree to float32 rounding, not bit for bit.
"""

import time
from typing import Dict, Optional

import numpy as np
import torch

from pushworld_tpu_torch import kernels
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, card_info, resolve_device
from pushworld_tpu_torch.envs.vector_env import VectorEnv
from pushworld_tpu_torch.ops.render import (
    NUM_CHANNELS,
    RenderTables,
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


def rollout(env: VectorEnv, tables: RenderTables, puzzle_idx: torch.Tensor, horizon: int, observations: bool,
            generator: Optional[torch.Generator], actions: Optional[torch.Tensor] = None,
            obs_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``horizon`` steps of the B rollouts that ``puzzle_idx`` (B,) int32
    names, each from its puzzle's initial state (``env.start``: unchecked),
    with a uniform-random policy drawn from ``generator``, or with
    ``actions`` (horizon, B) where given; with ``observations``, every step
    also renders the one-hot observations (into ``obs_out`` where given).
    Returns the reward total, a float32 scalar on the device, unread: the
    rollout reads nothing back, so a CUDA graph may capture it.  Each step
    adds its rewards to a (B,) accumulator (``VectorEnv.step``'s
    ``reward_acc``); the total is that accumulator's sum, taken once."""
    B = puzzle_idx.shape[0]
    state = env.start(puzzle_idx)
    reward_acc = torch.zeros((B,), dtype=torch.float32, device=env.device)
    for t in range(horizon):
        a = torch.randint(0, 4, (B,), generator=generator, device=env.device) if actions is None else actions[t]
        state, next_pos, _, _, _ = env.step(state, a, reward_acc=reward_acc)
        if observations:
            render_cells_onehot_batched(tables, next_pos, out=obs_out)
    return reward_acc.sum()


class RolloutGraph:
    """:func:`rollout` on the card as one CUDA graph: the counterpart of the
    JAX package's jitted ``lax.scan``.  :meth:`replay` runs a whole rollout
    with one graph launch.

    - ``env.reset`` checks the puzzle indices on the host once, before the
      capture; the graph starts each rollout with ``env.start``.
    - The action draw's generator is registered with the graph
      (``register_generator_state``): a replay draws from its current seed
      and offset, and advances the offset, so each replay draws fresh
      actions and ``generator.manual_seed(s)`` before a replay gives seed
      ``s``'s actions, the eager rollout's.  With ``actions`` given the graph
      reads them from that tensor instead.
    - The observations go to one buffer (``obs``), allocated before the
      capture: the graph's memory is one observation block, not one a step.
    - One step runs eagerly on the capture stream first (libraries loaded,
      lazy initialisations done), none of which may happen in a capture.
    - Launch counts: the capture's are recorded (``kernels.recording_launches``)
      and added to ``kernels.LAUNCHES`` at each replay; the replay itself
      counts in ``kernels.GRAPH_LAUNCHES["envs.rollout"]``.
    """

    def __init__(self, env: VectorEnv, tables: RenderTables, puzzle_idx: torch.Tensor, horizon: int,
                 observations: bool, generator: Optional[torch.Generator], actions: Optional[torch.Tensor] = None):
        dev = env.device
        B = puzzle_idx.shape[0]
        env.reset(None, B, puzzle_idx)  # the range check, on the host, outside the capture
        self.obs = (torch.empty((B, env.puzzles.height, env.puzzles.width, NUM_CHANNELS), dtype=torch.float32,
                                device=dev) if observations else None)
        self._refs = (env, tables, puzzle_idx, actions, generator)  # the graph reads their memory
        args = (env, tables, puzzle_idx)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                rollout(*args, 1, observations, generator, None if actions is None else actions[:1], self.obs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            if actions is None:
                self.graph.register_generator_state(generator)
            with kernels.recording_launches() as recorded:
                with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                    self.total = rollout(*args, horizon, observations, generator, actions, self.obs)
        self.launches = dict(recorded)

    def replay(self) -> torch.Tensor:
        """Enqueues one rollout (one graph launch) on the current stream;
        returns its reward total (a device scalar, overwritten by the next
        replay)."""
        self.graph.replay()
        for name, k in self.launches.items():
            kernels.count_launch(name, k)
        kernels.count_graph_launch("envs.rollout")
        return self.total


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
    one-hot observation tensor there (written whether or not anything reads
    it).  On the card a rollout is one launch of a :class:`RolloutGraph`;
    on the CPU it runs eagerly.  Each rollout is timed on the host clock
    around a device synchronisation.  Returns a dict with:

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
    generator = torch.Generator(device=dev)
    graph = RolloutGraph(env, tables, puzzle_idx, horizon, observations, generator) if dev.type == "cuda" else None

    def run(s: int) -> float:
        generator.manual_seed(s)
        if graph is not None:
            return float(graph.replay())  # waits for the device
        return float(rollout(env, tables, puzzle_idx, horizon, observations, generator))

    run(seed)  # warm-up
    best = float("inf")
    for r in range(reps):
        t0 = time.monotonic()
        run(seed + 1 + r)
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
