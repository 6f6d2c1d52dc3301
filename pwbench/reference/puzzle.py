"""``.pwp`` parsing and a puzzle's static tables.

The format (PushWorld ``puzzle.py:130-257``): rows of whitespace-separated
tokens, ``.`` empty, ``A`` the agent, ``W`` a wall, ``AW`` a wall that stops
the agent alone, ``Gk`` goal ``k`` of movable ``Mk``, any other ``M...`` a
movable; ``+`` joins the tokens of one cell, ids are case-blind, blank lines
are skipped.  A border of walls one cell wide is added around the content,
so a content cell (column c, row r), both counted from 1, is cell (x, y) =
(c, r).  Movables are ordered: the agent, the goals' movables in the
lexicographic order of the goal ids, then the other movables in the
lexicographic order of their ids.  An object's position is the top-left
corner of its cells' bounding box.
"""

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

import numpy as np

Cell = Tuple[int, int]


@dataclass
class RefPuzzle:
    width: int  # with the border
    height: int
    walls: np.ndarray  # (H, W) bool, the border included
    agent_walls: np.ndarray  # (H, W) bool
    names: List[str]  # movables in state order
    cells: List[np.ndarray]  # per movable, (C_i, 2) int (dx, dy) offsets from its position
    init: np.ndarray  # (N, 2) int (x, y)
    goals: np.ndarray  # (G, 2) int: the position movable 1 + k must reach
    goal_cells: List[np.ndarray]  # per goal, (C, 2) offsets

    @property
    def num_movables(self) -> int:
        return len(self.names)

    @property
    def num_goals(self) -> int:
        return len(self.goals)


def parse(text: str) -> RefPuzzle:
    elems: Dict[str, Set[Cell]] = {}
    row_len, y = None, 0
    for line in text.splitlines():
        tokens = line.split()
        if not tokens:
            continue
        y += 1
        if row_len is None:
            row_len = len(tokens)
        elif len(tokens) != row_len:
            raise ValueError(f"row {y} has {len(tokens)} tokens, the first row {row_len}")
        for x, token in enumerate(tokens, start=1):
            for eid in token.lower().split("+"):
                if eid != ".":
                    elems.setdefault(eid, set()).add((x, y))
    if y == 0:
        raise ValueError("empty puzzle")
    if "a" not in elems:
        raise ValueError("no agent")
    W, H = row_len + 2, y + 2
    walls = np.zeros((H, W), bool)
    walls[0, :] = walls[-1, :] = walls[:, 0] = walls[:, -1] = True
    for x, yy in elems.get("w", ()):
        walls[yy, x] = True
    agent_walls = np.zeros((H, W), bool)
    for x, yy in elems.get("aw", ()):
        agent_walls[yy, x] = True

    goal_ids = sorted(e for e in elems if e.startswith("g") and e != "g")
    names = ["a"]
    for g in goal_ids:
        m = "m" + g[1:]
        if m not in elems:
            raise ValueError(f"goal {g} has no movable {m}")
        names.append(m)
    names += [e for e in sorted(elems) if e.startswith("m") and e != "m" and e not in names]

    def split(eid):
        pts = np.array(sorted(elems[eid]), dtype=np.int64)
        origin = pts.min(axis=0)
        return origin, pts - origin

    init, cells = [], []
    for m in names:
        origin, rel = split(m)
        init.append(origin)
        cells.append(rel)
    goals, goal_cells = [], []
    for g in goal_ids:
        origin, rel = split(g)
        goals.append(origin)
        goal_cells.append(rel)
    return RefPuzzle(W, H, walls, agent_walls, names, cells, np.array(init, np.int64).reshape(-1, 2),
                     np.array(goals, np.int64).reshape(-1, 2), goal_cells)


def load(path: str) -> RefPuzzle:
    with open(path) as f:
        return parse(f.read())
