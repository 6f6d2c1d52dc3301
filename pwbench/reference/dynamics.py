"""Batched PushWorld dynamics, goal test and plan replay, in NumPy.

PushWorld ``puzzle.py:348-424``: the agent moves one cell; every movable
that a moving object would overlap moves with it, transitively; nothing
moves when the agent would enter a wall or an agent-only wall, or when any
pushed movable would enter a wall (agent-only walls stop the agent alone).
A state is a goal state when every goal's movable sits on its goal.

:class:`Tables` pads a list of puzzles to one shape so that a batch of
rollouts over different puzzles steps together: padding cells are masked,
padding movables have no cells, and the grid beyond a puzzle is wall.
"""

from typing import List, Sequence

import numpy as np

from .puzzle import RefPuzzle

# (dx, dy) of the actions LEFT, RIGHT, UP, DOWN.
DISPLACEMENTS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], np.int64)


class Tables:
    def __init__(self, puzzles: Sequence[RefPuzzle]):
        P = len(puzzles)
        self.H = max(p.height for p in puzzles)
        self.W = max(p.width for p in puzzles)
        self.N = max(p.num_movables for p in puzzles)
        self.G = max(max(p.num_goals for p in puzzles), 1)
        C = max(len(c) for p in puzzles for c in p.cells)
        self.walls = np.ones((P, self.H, self.W), bool)
        self.agent_walls = np.zeros((P, self.H, self.W), bool)
        self.cells = np.zeros((P, self.N, C, 2), np.int64)
        self.cmask = np.zeros((P, self.N, C), bool)
        self.init = np.zeros((P, self.N, 2), np.int64)
        self.goals = np.zeros((P, self.G, 2), np.int64)
        self.gmask = np.zeros((P, self.G), bool)
        self.num_goals = np.array([p.num_goals for p in puzzles], np.int64)
        self.goal_objects = np.zeros((P, self.N), bool)  # movables 1..G
        for i, p in enumerate(puzzles):
            self.walls[i, : p.height, : p.width] = p.walls
            self.agent_walls[i, : p.height, : p.width] = p.agent_walls
            for n, c in enumerate(p.cells):
                self.cells[i, n, : len(c)] = c
                self.cmask[i, n, : len(c)] = True
            self.init[i, : p.num_movables] = p.init
            self.goals[i, : p.num_goals] = p.goals
            self.gmask[i, : p.num_goals] = True
            self.goal_objects[i, 1: 1 + p.num_goals] = True
        self.init_achieved = count_achieved(self, np.arange(P), self.init)


class Batch:
    """A batch of rollouts' puzzles ``pidx`` (B,) with what each step reads
    of them, gathered once: cell offsets as flat ``dy * W + dx``, their
    mask, each rollout's wall planes, and an occupancy buffer."""

    def __init__(self, t: Tables, pidx: np.ndarray):
        self.t, self.pidx = t, pidx
        B, W, HW = len(pidx), t.W, t.H * t.W
        self.valid = t.cmask[pidx]  # (B, N, C)
        self.offset = (t.cells[pidx][..., 1] * W + t.cells[pidx][..., 0]).astype(np.int64)
        self.plane = (pidx * HW)[:, None, None]  # a rollout's wall planes
        self.row = (np.arange(B) * HW)[:, None, None]  # a rollout's occupancy plane
        self.spare = B * HW  # where padding cells read and write
        self.occupant = np.full(B * HW + 1, -1, np.int8)
        self.index = np.where(self.valid, 1, -1).astype(np.int8) * np.arange(t.N, dtype=np.int8)[None, :, None]
        self.index = np.where(self.valid, self.index, -1).astype(np.int8)

    def step(self, pos: np.ndarray, action: np.ndarray) -> np.ndarray:
        t, valid = self.t, self.valid
        B, N = pos.shape[:2]
        d = DISPLACEMENTS[action]  # (B, 2)
        cell = pos[:, :, 1, None] * t.W + pos[:, :, 0, None] + self.offset  # (B, N, C)
        moved = cell + (d[:, 1] * t.W + d[:, 0])[:, None, None]
        # Which movable covers each cell: written, read at the moved cells,
        # then cleared again.
        at = np.where(valid, self.row + cell, self.spare)
        np.put(self.occupant, at, self.index)
        hit = np.take(self.occupant, np.where(valid, self.row + moved, self.spare))  # (B, N, C)
        np.put(self.occupant, at, -1)
        into_wall = np.take(t.walls.ravel(), np.where(valid, self.plane + moved, 0)) & valid
        agent_blocked = (into_wall[:, 0] | (np.take(t.agent_walls.ravel(), np.where(valid[:, 0], self.plane[:, 0]
                                                                                   + moved[:, 0], 0))
                                            & valid[:, 0])).any(-1)
        # The pushed set, grown from the agent one ring at a time, on the
        # rollouts whose last ring pushed something new.
        pushed = np.zeros((B, N), bool)
        pushed[:, 0] = True
        rows, entered = np.arange(B), hit[:, 0]  # (rows, cells the ring moves into)
        while len(rows):
            newly = np.zeros((len(rows), N), bool)
            for j in range(1, N):
                newly[:, j] = (entered == j).any(-1)
            newly &= ~pushed[rows]
            grew = newly.any(-1)
            rows, newly = rows[grew], newly[grew]
            pushed[rows] |= newly
            entered = np.where(newly[:, :, None], hit[rows], -1).reshape(len(rows), N * hit.shape[2])
        movable_blocked = (into_wall[:, 1:].any(-1) & pushed[:, 1:]).any(-1)
        moves = pushed & ~(agent_blocked | movable_blocked)[:, None]
        return pos + d[:, None, :] * moves[..., None]


def step(t: Tables, pidx: np.ndarray, pos: np.ndarray, action: np.ndarray) -> np.ndarray:
    """Next positions (B, N, 2) of states ``pos`` (B, N, 2) of puzzles
    ``pidx`` (B,) under ``action`` (B,)."""
    return Batch(t, pidx).step(pos, action)


def count_achieved(t: Tables, pidx: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Goals achieved, (B,): goal k is achieved when movable 1 + k is on it."""
    G = t.G
    obj = pos[:, 1: 1 + G]  # (B, <=G, 2)
    g = t.goals[pidx][:, : obj.shape[1]]
    at = (obj == g).all(-1) & t.gmask[pidx][:, : obj.shape[1]]
    return at.sum(-1)


def is_goal(t: Tables, pidx: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return count_achieved(t, pidx, pos) == t.num_goals[pidx]


def plan_reaches_goal(puzzle: RefPuzzle, plan: List[int]) -> bool:
    """PushWorld's plan check (``puzzle.py:413-424``): the plan's moves from
    the initial state end in a goal state, and no earlier state is one."""
    t = Tables([puzzle])
    pidx = np.zeros((1,), np.int64)
    batch = Batch(t, pidx)
    pos = t.init[:1].copy()
    for a in plan:
        if not 0 <= int(a) < 4 or is_goal(t, pidx, pos)[0]:
            return False
        pos = batch.step(pos, np.array([int(a)]))
    return bool(is_goal(t, pidx, pos)[0])
