"""The one-hot observation, in NumPy.

(H, W, 6) float32 a state, channels [wall, agent-only wall, agent, goal
object, other movable, goal].  A cell holds one class: a goal's cells, then
agent-only walls over them, then walls over both; movables over that (a
movable may stand on a goal or an agent-only wall), the agent last.  The
class's channel reads 1, the others 0; an empty cell is all 0.
"""

import numpy as np

from .puzzle import RefPuzzle

EMPTY, WALL, AGENT_WALL, AGENT, GOAL_OBJECT, MOVABLE, GOAL = range(7)
NUM_CHANNELS = 6


def render_onehot(puzzle: RefPuzzle, pos: np.ndarray) -> np.ndarray:
    """(B, H, W, 6) float32 observations of states ``pos`` (B, N, 2)."""
    B = pos.shape[0]
    base = np.zeros((puzzle.height, puzzle.width), np.int8)
    for g, rel in zip(puzzle.goals, puzzle.goal_cells):
        base[g[1] + rel[:, 1], g[0] + rel[:, 0]] = GOAL
    base[puzzle.agent_walls] = AGENT_WALL
    base[puzzle.walls] = WALL
    grid = np.broadcast_to(base, (B,) + base.shape).copy()
    b = np.arange(B)[:, None]
    order = list(range(1, puzzle.num_movables)) + [0]
    for n in order:
        cls = AGENT if n == 0 else (GOAL_OBJECT if n <= puzzle.num_goals else MOVABLE)
        rel = puzzle.cells[n]
        grid[b, pos[:, n, None, 1] + rel[None, :, 1], pos[:, n, None, 0] + rel[None, :, 0]] = cls
    return (grid[..., None] == np.arange(1, NUM_CHANNELS + 1, dtype=np.int8)).astype(np.float32)
