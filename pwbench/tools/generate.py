"""A frozen copy of the puzzle generator that made the benchmark's pools.

Copied from ``pushworld_tpu_torch/tools/generate.py`` (``place_object``,
``generate_puzzle`` and the shape sets), itself the port of PushWorld's
``python3/src/pushworld/generate.py:28-297``: rejection-sampled placement
(at most 100 attempts an object), a fixed set of shapes of at most three
cells, goal objects that share their goal's shape.  The copy lives here so
that a change to the program cannot change the traffic; the pools it made
are committed and never drawn again.
"""

import random
from typing import List, Tuple

SIMPLE_SHAPES = [[(0, 0)]]
COMPLEX_SHAPES = [
    [(0, 0)],
    [(0, 0), (0, 1)],
    [(0, 0), (1, 0)],
    [(0, 0), (1, 0), (1, 1)],
    [(0, 0), (0, 1), (1, 1)],
    [(0, 0), (0, 1), (1, 0)],
    [(1, 0), (0, 1), (1, 1)],
    [(0, 0), (0, 1), (0, 2)],
    [(0, 0), (1, 0), (2, 0)],
]
SHAPES = {"simple": SIMPLE_SHAPES, "complex": COMPLEX_SHAPES}


class FailedToGenerateError(Exception):
    """An object found no clear place within the attempt budget."""


def place_object(grid: List[List[str]], symbol: str, shape: List[Tuple[int, int]], rng: random.Random) -> None:
    """Places ``shape`` ((y, x) offsets) at a random clear location, at most
    100 attempts."""
    height, width = len(grid), len(grid[0])
    shape_height = 1 + max(y for y, x in shape)
    shape_width = 1 + max(x for y, x in shape)
    for _ in range(100):
        x = rng.choice(range(width + 1 - shape_width))
        y = rng.choice(range(height + 1 - shape_height))
        if all(grid[y + dy][x + dx] == "." for dy, dx in shape):
            for dy, dx in shape:
                grid[y + dy][x + dx] = symbol
            return
    raise FailedToGenerateError()


def generate_puzzle(width: int, height: int, num_walls: int, num_obstacles: int, num_goal_objects: int,
                    shapes: List[List[Tuple[int, int]]], rng: random.Random) -> str:
    """One candidate puzzle as ``.pwp`` text (it may have no solution)."""
    if len(shapes) < num_goal_objects:
        raise ValueError("need a distinct shape for each goal object")
    grid = [["." for _ in range(width)] for _ in range(height)]
    shape1 = rng.choice(shapes)
    place_object(grid, "M1", shape1, rng)
    place_object(grid, "G1", shape1, rng)
    if num_goal_objects == 2:
        shape2 = None
        while shape2 is None or shape2 == shape1:
            shape2 = rng.choice(shapes)
        place_object(grid, "M2", shape2, rng)
        place_object(grid, "G2", shape2, rng)
    place_object(grid, "A", rng.choice(shapes), rng)
    for i in range(num_obstacles):
        place_object(grid, f"M{1 + i + num_goal_objects}", rng.choice(shapes), rng)
    for _ in range(num_walls):
        place_object(grid, "W", [(0, 0)], rng)
    return "\n".join("  ".join(row) for row in grid)


def candidates(params: dict, rng: random.Random):
    """Endless candidates drawn as ``generate_level0_puzzles`` draws them:
    each size and count uniform in its ``[min, max]`` range of ``params``
    (``size``, ``walls``, ``obstacles``, ``goal_objects``), a candidate whose
    objects find no place drawn again."""
    shapes = SHAPES[params["shapes"]]

    def pick(key):
        lo, hi = params[key]
        return rng.choice(range(lo, hi + 1))

    while True:
        try:
            yield generate_puzzle(width=pick("size"), height=pick("size"), num_walls=pick("walls"),
                                  num_obstacles=pick("obstacles"), num_goal_objects=pick("goal_objects"),
                                  shapes=shapes, rng=rng)
        except FailedToGenerateError:
            continue
