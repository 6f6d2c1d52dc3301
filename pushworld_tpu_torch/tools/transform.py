"""Symmetry augmentation: all 8 rotations/flips of a puzzle.

The port's copy of the JAX package's ``tools/transform.py``.

reference behavior: python3/src/pushworld/transform.py:21-85 (token-grid
``np.rot90`` transforms; batch version mirrors the directory tree, naming
outputs ``<name>_r{0,90,180,270}[_flipped].pwp``).
"""

import os
from typing import Dict, List, Tuple

import numpy as np

from pushworld_tpu_torch.config import PUZZLE_EXTENSION

# Action remapping under each transform (LEFT, RIGHT, UP, DOWN indices), so
# plans can be carried across symmetries: plan_t[i] = ACTION_MAPS[name][plan[i]].
ACTION_MAPS: Dict[str, Tuple[int, int, int, int]] = {}


def _compose_action_map(rot90_times: int, flipped: bool) -> Tuple[int, int, int, int]:
    # Displacements: L(-1,0) R(1,0) U(0,-1) D(0,1).
    vecs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    out = []
    for dx, dy in vecs:
        if flipped:
            dy = -dy  # top-bottom flip is applied before the rotations
        for _ in range(rot90_times):
            # np.rot90(axes=(1,0)) rotates the grid clockwise: (x, y) ->
            # (H-1-y, x); displacement (dx, dy) -> (-dy, dx).
            dx, dy = -dy, dx
        out.append(vecs.index((dx, dy)))
    return tuple(out)


for _f in (False, True):
    for _r in range(4):
        ACTION_MAPS[f"r{_r * 90}{'_flipped' if _f else ''}"] = _compose_action_map(_r, _f)


def get_puzzle_transforms(puzzle_string: str) -> Dict[str, str]:
    """All 8 symmetry transforms of ``puzzle_string``; keys are
    ``r{0,90,180,270}`` and ``r..._flipped``."""
    lines = [l.split() for l in puzzle_string.splitlines() if l.split()]
    grid = np.array(lines, dtype=object)

    out: Dict[str, str] = {}
    g = grid
    for flipped in (False, True):
        for rotation in range(0, 360, 90):
            name = f"r{rotation}{'_flipped' if flipped else ''}"
            out[name] = "\n".join("  ".join(row) for row in g.tolist())
            g = np.rot90(g, axes=(1, 0))
        g = g[::-1]  # four rotations restore g; flip for the second cycle
    return out


def transform_plan(plan: List[int], transform_name: str) -> List[int]:
    """Maps a plan through the action permutation of a transform."""
    amap = ACTION_MAPS[transform_name]
    return [amap[a] for a in plan]


def create_transformed_puzzles(puzzle_path: str, output_path: str) -> None:
    """Writes all 8 transforms of every puzzle under ``puzzle_path`` into
    ``output_path``, mirroring the directory tree."""
    puzzle_path = puzzle_path.rstrip(os.path.sep)
    for subdir, _, filenames in os.walk(puzzle_path):
        for filename in sorted(filenames):
            if not filename.endswith(PUZZLE_EXTENSION):
                continue
            src = os.path.join(subdir, filename)
            with open(src, "r") as f:
                text = f.read()
            rel_prefix = os.path.splitext(src[len(puzzle_path) + 1 :])[0]
            for name, t_text in get_puzzle_transforms(text).items():
                dst = os.path.join(output_path, f"{rel_prefix}_{name}{PUZZLE_EXTENSION}")
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                with open(dst, "w") as f:
                    f.write(t_text)
