"""Lockstep rollouts into a trajectory, PushWorld's Gym environment with
standard padding, in NumPy.

The dynamics, goals and rewards are ``env.py``'s (``gym_env.py:210-226``,
truncation after ``max_steps`` steps since the last reset, the automatic
reset to the rollout's own puzzle); every step's reward and flags are kept:
``terminated`` on reaching a goal state, ``truncated`` when an episode that
did not terminate reaches ``max_steps``.  An observation is ``render.py``'s
one-hot of the step's positions before the reset, centred in a frame of
H_f x W_f cells as ``utils/env_utils.py`` ``render_observation_padded``
centres its image (``top = (H_f - h) // 2``, ``left = (W_f - w) // 2``),
every other cell all-zero.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .dynamics import Batch, Tables, count_achieved
from .env import STEP_PENALTY, TERMINAL_REWARD, _float32
from .puzzle import RefPuzzle
from .render import NUM_CHANNELS, render_onehot


def rollout(t: Tables, pidx: np.ndarray, actions: np.ndarray, max_steps: Optional[int], at: Sequence[int] = (),
            rounding: Callable = _float32, step: Optional[Callable] = None) -> Dict[str, object]:
    """Runs ``actions`` (T, B) from each rollout's initial state.

    Returns ``totals`` (B,) float32 each rollout's reward total in step
    order, ``last`` (B, N, 2) the last step's positions before its reset,
    ``positions`` {s: (B, N, 2)} those of each step ``s`` of ``at``, and
    ``reward`` (T, B) float32, ``terminated``, ``truncated`` (T, B) bool.
    ``rounding`` and ``step`` as ``env.rollout``'s."""
    step = step or Batch(t, pidx).step
    terminal, penalty = rounding(TERMINAL_REWARD), rounding(STEP_PENALTY)
    T, B = len(actions), len(pidx)
    pos = t.init[pidx].copy()
    steps = np.zeros(B, np.int64)
    achieved = t.init_achieved[pidx].copy()
    total = rounding(np.zeros(B, np.float32))
    out = {"reward": np.zeros((T, B), np.float32), "terminated": np.zeros((T, B), bool),
           "truncated": np.zeros((T, B), bool), "positions": {}, "last": pos}
    for k, a in enumerate(actions):
        nxt = step(pos, a)
        got = count_achieved(t, pidx, nxt)
        done_goal = got == t.num_goals[pidx]
        reward = rounding(np.where(done_goal, terminal, rounding(rounding(got - achieved) - penalty)))
        total = rounding(total + reward)
        steps = steps + 1
        trunc = ~done_goal & (steps >= max_steps) if max_steps is not None else np.zeros(B, bool)
        done = done_goal | trunc
        out["reward"][k], out["terminated"][k], out["truncated"][k] = reward, done_goal, trunc
        if k in at:
            out["positions"][k] = nxt
        pos = np.where(done[:, None, None], t.init[pidx], nxt)
        steps = np.where(done, 0, steps)
        achieved = np.where(done, t.init_achieved[pidx], got)
        out["last"] = nxt
    out["totals"] = np.asarray(total, np.float32)
    return out


def offsets(puzzle: RefPuzzle, frame: Tuple[int, int]) -> Tuple[int, int]:
    """(top, left) of ``puzzle`` centred in ``frame``."""
    H, W = frame
    if puzzle.height > H or puzzle.width > W:
        raise ValueError(f"a {puzzle.height} x {puzzle.width} puzzle does not fit a {H} x {W} frame")
    return (H - puzzle.height) // 2, (W - puzzle.width) // 2


def framed(puzzles: Sequence[RefPuzzle], pidx: np.ndarray, pos: np.ndarray, frame: Tuple[int, int]) -> np.ndarray:
    """(B, H_f, W_f, 6) float32 observations of states ``pos`` (B, >= N, 2),
    rollout b's of puzzle ``puzzles[pidx[b]]``, each centred in ``frame``."""
    out = np.zeros((len(pidx), *frame, NUM_CHANNELS), np.float32)
    for i in np.unique(pidx):
        p = puzzles[i]
        sel = np.nonzero(pidx == i)[0]
        top, left = offsets(p, frame)
        out[sel, top: top + p.height, left: left + p.width] = render_onehot(p, pos[sel, : p.num_movables])
    return out
