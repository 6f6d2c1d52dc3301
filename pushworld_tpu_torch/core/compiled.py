"""Compilation of puzzles into dense, statically-shaped collision tables.

The port's copy of the JAX package's ``core/compiled.py``, in numpy: the
reference's per-object hash-set collision maps (reference:
python3/src/pushworld/puzzle.py:522-593, cpp/src/pushworld_puzzle.cc:123-172)
become dense boolean tables, so that the transition function is a
fixed-shape sequence of gathers and a small boolean closure.

Tables (for a puzzle padded to ``N`` movables, ``H x W`` grid, offset radius
``delta``, ``K = 2*delta + 1``):

- ``static_block[a, i, y, x]``: True iff movable ``i`` placed at ``(x, y)``
  collides with a static obstacle when moved one cell in direction ``a``.
  Row 0 (the agent) uses walls + agent-walls; other rows use walls only.
  Out-of-range placements are marked blocked.
- ``push[a, i, j, ry, rx]``: True iff movable ``i`` at relative offset
  ``(rx - delta, ry - delta) = pos_i - pos_j`` pushes movable ``j`` when
  moving in direction ``a``.  Offsets where the two objects would already
  overlap are excluded (such states are unreachable).

Positions are (x, y) int32 with x in [0, W), y in [0, H).
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pushworld_tpu_torch.core.puzzle import AGENT_IDX, NUM_ACTIONS, Actions, Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device

DISPLACEMENTS_NP = np.array(Actions.DISPLACEMENTS, np.int32)  # (4, 2) (dx, dy)

_ARRAY_FIELDS = ("static_block", "push", "init_state", "goal_pos", "obj_mask", "goal_mask")


@dataclass(frozen=True)
class CompiledPuzzle:
    """Dense-table form of a puzzle.

    :func:`compile_puzzle` fills the array fields with numpy arrays;
    :meth:`to` gives the same puzzle with torch tensors on a device.
    A stacked puzzle (:func:`stack_puzzles`) carries a leading puzzle axis P
    on every array field; :meth:`to` and :meth:`numpy` take either form.
    """

    static_block: object  # bool (4, N, H, W)
    push: object  # bool (4, N, N, K, K)
    init_state: object  # int32 (N, 2)
    goal_pos: object  # int32 (N, 2); zeros where goal_mask is False
    obj_mask: object  # bool (N,)
    goal_mask: object  # bool (N,)

    n: int  # padded number of movables N
    height: int  # padded H
    width: int  # padded W
    delta: int  # offset radius; K = 2*delta + 1

    @property
    def num_movables(self) -> int:
        return int(_to_numpy(self.obj_mask).sum())

    def to(self, device: DeviceLike = "cuda") -> "CompiledPuzzle":
        """The same puzzle with every array field a tensor on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            **{f: torch.as_tensor(_to_numpy(getattr(self, f)), device=dev)
               for f in _ARRAY_FIELDS},
        )

    def numpy(self) -> "CompiledPuzzle":
        """The same puzzle with numpy array fields."""
        return dataclasses.replace(
            self, **{f: _to_numpy(getattr(self, f)) for f in _ARRAY_FIELDS}
        )


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _occupancy(cells, height: int, width: int) -> np.ndarray:
    grid = np.zeros((height, width), bool)
    for x, y in cells:
        grid[y, x] = True
    return grid


def _bbox_dims(cells) -> Tuple[int, int]:
    xs = [c[0] for c in cells]
    ys = [c[1] for c in cells]
    return max(xs) + 1, max(ys) + 1  # cells are origin-relative (min == 0)


def _static_block_table(
    cells, obstacle_grid: np.ndarray, height: int, width: int
) -> np.ndarray:
    """(4, H, W) bool: placement (x, y) collides with ``obstacle_grid`` when
    moved one cell in each direction.  Out-of-range placements are blocked."""
    w_obj, h_obj = _bbox_dims(cells)
    # Pad the obstacle grid so that shifted lookups never go out of bounds.
    pad = max(w_obj, h_obj) + 1
    padded = np.pad(obstacle_grid, pad, constant_values=True)
    out = np.zeros((NUM_ACTIONS, height, width), bool)
    for a in range(NUM_ACTIONS):
        dx, dy = DISPLACEMENTS_NP[a]
        hit = np.zeros((height, width), bool)
        for cx, cy in cells:
            # For placement (x, y): obstacle at (x + cx + dx, y + cy + dy)?
            oy = pad + cy + dy
            ox = pad + cx + dx
            hit |= padded[oy : oy + height, ox : ox + width]
        out[a] = hit
    # Invalid placements (object would stick out of the grid) are blocked.
    xs = np.arange(width)[None, :]
    ys = np.arange(height)[:, None]
    out |= (xs > width - w_obj) | (ys > height - h_obj)
    return out


def _pair_offset_overlap(cells_i, cells_j, radius: int) -> np.ndarray:
    """(2R+1, 2R+1) bool over offsets s = pos_i - pos_j in [-R, R]^2:
    does object i at offset s overlap object j?  Entry [sy + R, sx + R]."""
    w_i, h_i = _bbox_dims(cells_i)
    w_j, h_j = _bbox_dims(cells_j)
    size_y = 2 * radius + max(h_i, h_j) + 2
    size_x = 2 * radius + max(w_i, w_j) + 2
    grid_j = np.zeros((size_y, size_x), bool)
    for x, y in cells_j:
        grid_j[y + radius + 1, x + radius + 1] = True
    K = 2 * radius + 1
    ov = np.zeros((K, K), bool)
    for px, py in cells_i:
        # overlap at offset (sx, sy) iff (px + sx, py + sy) in cells_j
        oy = py + 1
        ox = px + 1
        ov |= grid_j[oy : oy + K, ox : ox + K]
    return ov


def compute_delta(puzzle: Puzzle) -> int:
    """Smallest offset radius that captures every possible push contact."""
    dims = [_bbox_dims(c) for c in puzzle.movable_cells]
    return max(max(w, h) for w, h in dims) + 1


def compile_puzzle(
    puzzle: Puzzle,
    n_pad: Optional[int] = None,
    h_pad: Optional[int] = None,
    w_pad: Optional[int] = None,
    delta: Optional[int] = None,
) -> CompiledPuzzle:
    """Compiles ``puzzle`` into dense tables, padded to the given bucket shape."""
    n_real = puzzle.num_movables
    N = n_pad or n_real
    H = h_pad or puzzle.height
    W = w_pad or puzzle.width
    if N < n_real or H < puzzle.height or W < puzzle.width:
        raise ValueError("Bucket shape smaller than puzzle shape.")
    R = compute_delta(puzzle)
    if delta is None:
        delta = R
    elif delta < R:
        raise ValueError(f"delta={delta} too small; puzzle requires {R}.")
    K = 2 * delta + 1

    wall_grid = _occupancy(puzzle.wall_cells, H, W)
    # Everything beyond the real puzzle area is wall (padding safety).
    wall_grid[puzzle.height :, :] = True
    wall_grid[:, puzzle.width :] = True
    agent_obs_grid = wall_grid | _occupancy(puzzle.agent_wall_cells, H, W)

    static_block = np.ones((NUM_ACTIONS, N, H, W), bool)
    for i in range(n_real):
        obstacles = agent_obs_grid if i == AGENT_IDX else wall_grid
        static_block[:, i] = _static_block_table(puzzle.movable_cells[i], obstacles, H, W)

    push = np.zeros((NUM_ACTIONS, N, N, K, K), bool)
    # Per-pair overlap-at-offset maps, radius delta+1 so shifted slices exist.
    Rbig = delta + 1
    for i in range(n_real):
        for j in range(n_real):
            if i == j:
                continue
            # The agent is the root cause of all motion; pushes *onto* the
            # agent never occur (reference: puzzle.py:295-297), but tables for
            # all ordered pairs are kept — the closure masks row/col 0 anyway.
            if j == AGENT_IDX:
                continue
            ov = _pair_offset_overlap(
                puzzle.movable_cells[i], puzzle.movable_cells[j], Rbig
            )
            pre = ov[1:-1, 1:-1]  # offsets in [-delta, delta]^2
            for a in range(NUM_ACTIONS):
                dx, dy = DISPLACEMENTS_NP[a]
                shifted = ov[1 + dy : 1 + dy + K, 1 + dx : 1 + dx + K]
                push[a, i, j] = shifted & ~pre

    init_state = np.zeros((N, 2), np.int32)
    init_state[:n_real] = np.array(puzzle.initial_state, np.int32)
    goal_pos = np.zeros((N, 2), np.int32)
    goal_mask = np.zeros((N,), bool)
    for k, gp in enumerate(puzzle.goal_state):
        goal_pos[1 + k] = gp
        goal_mask[1 + k] = True
    obj_mask = np.zeros((N,), bool)
    obj_mask[:n_real] = True

    return CompiledPuzzle(
        static_block=static_block,
        push=push,
        init_state=init_state,
        goal_pos=goal_pos,
        obj_mask=obj_mask,
        goal_mask=goal_mask,
        n=N,
        height=H,
        width=W,
        delta=delta,
    )


def bucket_shape(puzzles: Sequence[Puzzle]) -> Tuple[int, int, int, int]:
    """(N, H, W, delta) bucket covering all ``puzzles``."""
    N = max(p.num_movables for p in puzzles)
    H = max(p.height for p in puzzles)
    W = max(p.width for p in puzzles)
    d = max(compute_delta(p) for p in puzzles)
    return N, H, W, d


def compile_batch(puzzles: Sequence[Puzzle]) -> CompiledPuzzle:
    """Compiles ``puzzles`` into one stacked CompiledPuzzle with a leading
    puzzle axis (all padded to a common bucket shape)."""
    N, H, W, d = bucket_shape(puzzles)
    return stack_puzzles([compile_puzzle(p, N, H, W, d) for p in puzzles])


def stack_puzzles(compiled: Sequence[CompiledPuzzle]) -> CompiledPuzzle:
    """Stacks compiled puzzles of one bucket shape along a new leading axis
    (numpy array fields)."""
    first = compiled[0]
    for c in compiled[1:]:
        if (c.n, c.height, c.width, c.delta) != (
            first.n,
            first.height,
            first.width,
            first.delta,
        ):
            raise ValueError("All puzzles in a batch must share a bucket shape.")
    return dataclasses.replace(
        first,
        **{f: np.stack([_to_numpy(getattr(c, f)) for c in compiled]) for f in _ARRAY_FIELDS},
    )
