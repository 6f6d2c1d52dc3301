"""Cell/border painting for puzzle rendering.

Pixel-level semantics match the reference renderer (reference:
python3/src/pushworld/puzzle.py:596-638): each occupied cell is filled with the
object's fill color, and a ``border_width``-pixel strip is drawn along every
cell edge (and corner) whose neighboring cell is not part of the same object.
"""

from typing import Tuple

import numpy as np

_BORDER_OFFSETS = (
    (-1, 0),
    (1, 0),
    (0, -1),
    (0, 1),
    (-1, -1),
    (-1, 1),
    (1, -1),
    (1, 1),
)


def draw_object(
    obj,
    position: Tuple[int, int],
    image: np.ndarray,
    pixels_per_cell: int,
    border_width: int,
) -> None:
    """Draws ``obj`` at ``position`` into ``image`` (modified in place)."""
    px, py = position
    cells = obj.cells
    for cx, cy in cells:
        c = (px + cx) * pixels_per_cell
        r = (py + cy) * pixels_per_cell
        if obj.fill_color is not None:
            image[r : r + pixels_per_cell, c : c + pixels_per_cell] = obj.fill_color
        for dr, dc in _BORDER_OFFSETS:
            if (cx + dc, cy + dr) not in cells:
                r1 = r + max(0, dr) * (pixels_per_cell - border_width)
                r2 = (r1 + pixels_per_cell) if dr == 0 else (r1 + border_width)
                c1 = c + max(0, dc) * (pixels_per_cell - border_width)
                c2 = (c1 + pixels_per_cell) if dc == 0 else (c1 + border_width)
                image[r1:r2, c1:c2] = obj.border_color
