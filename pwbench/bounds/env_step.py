"""One launch of the environment step (``kernels/env.cu``,
``VectorEnv.step`` with a running reward total) over ``batch`` rollouts of
``objects`` movables.

Read, a rollout: its positions (8 bytes a movable), action, step count,
goals achieved and running total (4 bytes each), its puzzle index where the
puzzles are stacked.  Written, a rollout: the positions after the step and
its reset and the positions before the reset (8 bytes a movable each), step
count, goals achieved, reward and running total (4 bytes each), the two
flags (1 byte each).  The collision tables are left out: a step looks up a
few entries of them, which the shapes do not tell.
"""


def bytes_per_launch(batch: int, objects: int, action_bytes: int = 4, stacked: bool = False) -> int:
    read = 8 * objects + action_bytes + 4 + 4 + 4 + (4 if stacked else 0)
    written = 16 * objects + 4 + 4 + 4 + 4 + 1 + 1
    return batch * (read + written)
