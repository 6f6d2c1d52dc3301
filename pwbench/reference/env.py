"""Lockstep rollouts with PushWorld's reward schedule, in NumPy.

PushWorld ``gym_env.py:210-226``: a step's reward is +10 when it reaches a
goal state, else the change in goals achieved less 0.01, in float32 (the
difference rounded once).  The port's batched environment adds truncation
after ``max_steps`` steps since the last reset and an automatic reset: a
rollout that terminated or was truncated starts its next step from its
puzzle's initial state; with ``max_steps`` None only reaching the goal
ends an episode.  Each rollout's rewards are summed in float32 in
step order.
"""

from typing import Callable, Optional, Tuple

import numpy as np

from .dynamics import Batch, Tables, count_achieved

TERMINAL_REWARD = np.float32(10.0)
STEP_PENALTY = np.float32(0.01)


def _float32(x):
    return np.asarray(x, np.float32)


def rollout(t: Tables, pidx: np.ndarray, actions: np.ndarray, max_steps: Optional[int],
            rounding: Callable = _float32, step: Optional[Callable] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Runs ``actions`` (T, B) from each rollout's initial state.

    Returns each rollout's reward total, (B,) float32, and the last step's
    positions before its reset, (B, N, 2); ``max_steps`` None: no
    truncation.  ``rounding`` rounds every
    value of the reward arithmetic (float32, the configuration's precision;
    the benchmark's control passes a lower one); ``step(pos, action)``
    replaces the dynamics (the benchmark's planted faults)."""
    step = step or Batch(t, pidx).step
    terminal, penalty = rounding(TERMINAL_REWARD), rounding(STEP_PENALTY)
    pos = t.init[pidx].copy()
    steps = np.zeros(pidx.shape, np.int64)
    achieved = t.init_achieved[pidx].copy()
    total = rounding(np.zeros(pidx.shape, np.float32))
    last = pos
    for a in actions:
        nxt = step(pos, a)
        got = count_achieved(t, pidx, nxt)
        done_goal = got == t.num_goals[pidx]
        reward = rounding(np.where(done_goal, terminal, rounding(rounding(got - achieved) - penalty)))
        total = rounding(total + reward)
        steps = steps + 1
        done = done_goal if max_steps is None else done_goal | (steps >= max_steps)
        pos = np.where(done[:, None, None], t.init[pidx], nxt)
        steps = np.where(done, 0, steps)
        achieved = np.where(done, t.init_achieved[pidx], got)
        last = nxt
    return total, last
