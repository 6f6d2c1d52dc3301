"""PushWorld's Gym environment with standard padding, stepped in lockstep
into a trajectory: the plain reference of the trajectory rollout
(``envs.throughput.rollout`` with a ``Trajectory``).

Written from PushWorld's ``python3/src/pushworld/gym_env.py``
(``PushWorldEnv``, ``standard_padding=True``) and ``utils/env_utils.py``
(``render_observation_padded``), with plain ``torch`` on float32 and the
host oracle ``Puzzle.get_next_state``; it imports nothing of the port's
``kernels`` or ``ops`` and nothing of JAX.

- Reward (``gym_env.py:210-222``): +10 on reaching a goal state, else the
  change in goals achieved less 0.01, in float32.
- ``terminated`` on a goal state; ``truncated`` when an episode that did not
  terminate has taken ``max_steps`` steps (None: never).
- The observation of a step is that of its next state, before any reset,
  centred in a frame of H_f x W_f cells: ``top = (H_f - h) // 2``,
  ``left = (W_f - w) // 2``, every cell outside the puzzle all-zero.

Departures from ``gym_env.py``, as the port's batched environment has them:

- the observation is one cell a pixel with 6 one-hot float32 channels
  [wall, agent-only wall, agent, goal object, other movable, goal], not RGB
  pixels: a goal's cells, agent-only walls over them, walls over both,
  then the movables, the agent last;
- on termination or truncation a rollout starts its own puzzle again
  (``VectorEnv``'s auto-reset), where ``PushWorldEnv.reset`` would draw a
  new puzzle and wait for the caller;
- B rollouts step in lockstep, each on the puzzle ``puzzle_idx`` names.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from pushworld_tpu_torch.core.puzzle import Puzzle

TERMINAL_REWARD = 10.0
STEP_PENALTY = 0.01
NUM_CHANNELS = 6
EMPTY, WALL, AGENT_WALL, AGENT, GOAL_OBJECT, MOVABLE, GOAL = range(7)


def _base(puzzle: Puzzle) -> torch.Tensor:
    """(h, w) int64 static classes of ``puzzle``."""
    grid = torch.zeros((puzzle.height, puzzle.width), dtype=torch.int64)
    for (gx, gy), cells in zip(puzzle.goal_state, puzzle.goal_cells):
        for cx, cy in cells:
            grid[gy + cy, gx + cx] = GOAL
    for x, y in puzzle.agent_wall_cells:
        grid[y, x] = AGENT_WALL
    for x, y in puzzle.wall_cells:
        grid[y, x] = WALL
    return grid


def render_padded(puzzle: Puzzle, state, frame: Tuple[int, int], base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(H_f, W_f, 6) float32 one-hot observation of ``state`` (a tuple of
    (x, y)), centred in ``frame`` as ``render_observation_padded`` centres
    its image; the pad all-zero."""
    grid = (_base(puzzle) if base is None else base).clone()
    order = list(range(1, puzzle.num_movables)) + [0]  # the agent on top
    for i in order:
        cls = AGENT if i == 0 else (GOAL_OBJECT if i <= puzzle.num_goals else MOVABLE)
        x, y = state[i]
        for cx, cy in puzzle.movable_cells[i]:
            grid[y + cy, x + cx] = cls
    onehot = (grid[..., None] == torch.arange(1, NUM_CHANNELS + 1)).to(torch.float32)
    H, W = frame
    pad_h, pad_w = H - puzzle.height, W - puzzle.width
    if pad_h < 0 or pad_w < 0:
        raise ValueError(f"a {puzzle.height} x {puzzle.width} puzzle does not fit a {H} x {W} frame")
    top, left = pad_h // 2, pad_w // 2
    return torch.nn.functional.pad(onehot, (0, 0, left, pad_w - left, top, pad_h - top))


def trajectory(puzzles: Sequence[Puzzle], puzzle_idx, actions, max_steps: Optional[int],
               frame: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Runs ``actions`` ((T, B) ints in [0, 4)) from each rollout's initial
    state, rollout b on ``puzzles[puzzle_idx[b]]``.

    Returns ``obs`` (T, B, H_f, W_f, 6) float32, ``reward`` (T, B) float32,
    ``terminated`` and ``truncated`` (T, B) bool, row t those of step t, and
    each rollout's reward total ``totals`` (B,) float32, summed in step
    order."""
    actions = torch.as_tensor(actions).long()
    idx = [int(i) for i in torch.as_tensor(puzzle_idx).tolist()]
    T, B = actions.shape
    bases = {i: _base(puzzles[i]) for i in set(idx)}
    obs = torch.zeros((T, B, *frame, NUM_CHANNELS), dtype=torch.float32)
    reward = torch.zeros((T, B), dtype=torch.float32)
    terminated = torch.zeros((T, B), dtype=torch.bool)
    truncated = torch.zeros((T, B), dtype=torch.bool)
    totals = torch.zeros((B,), dtype=torch.float32)
    states = [puzzles[i].initial_state for i in idx]
    steps = [0] * B
    achieved = [puzzles[i].count_achieved_goals(s) for i, s in zip(idx, states)]
    for t in range(T):
        got = torch.zeros((B,), dtype=torch.float32)
        for b, i in enumerate(idx):
            p = puzzles[i]
            nxt = p.get_next_state(states[b], int(actions[t, b]))
            obs[t, b] = render_padded(p, nxt, frame, bases[i])
            n = p.count_achieved_goals(nxt)
            got[b] = n - achieved[b]
            terminated[t, b] = n == p.num_goals
            steps[b] += 1
            truncated[t, b] = not terminated[t, b] and max_steps is not None and steps[b] >= max_steps
            if terminated[t, b] or truncated[t, b]:
                states[b], steps[b], achieved[b] = p.initial_state, 0, p.count_achieved_goals(p.initial_state)
            else:
                states[b], achieved[b] = nxt, n
        reward[t] = torch.where(terminated[t], torch.tensor(TERMINAL_REWARD), got - STEP_PENALTY)
        totals += reward[t]
    return {"obs": obs, "reward": reward, "terminated": terminated, "truncated": truncated, "totals": totals}
