"""Random level-0 puzzle generation with a solvability filter.

The port's copy of the JAX package's ``tools/generate.py``: the same
candidate stream from ``random.Random(random_seed)``, byte for byte.  The
filter plans on ``device`` (see :func:`pushworld_tpu_torch.tools.resolve_planner`).

reference behavior: python3/src/pushworld/generate.py:28-297 — rejection-
sampled placement (<= 100 attempts per object), fixed tromino-or-smaller
shape set, goal objects share their goal's shape, then an optional filter
that solves each candidate with the planner under a time limit and keeps
(renumbering) only the solvable ones.

Differences by design: the solvability filter calls this framework's own
planner in-process (reference fork/execs the C++ RGD binary per candidate).
"""

import os
import random
from typing import List, Optional, Tuple

from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike

# (y, x) offsets, matching the reference's 9-shape set (generate.py:217-227).
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


class FailedToGenerateError(Exception):
    """Raised when an object cannot be placed within the attempt budget."""


def place_object(
    puzzle: List[List[str]],
    object_symbol: str,
    shape: List[Tuple[int, int]],
    rng: random.Random,
) -> None:
    """Places ``shape`` at a random clear location (<= 100 attempts)."""
    height = len(puzzle)
    width = len(puzzle[0])
    shape_height = 1 + max(y for y, x in shape)
    shape_width = 1 + max(x for y, x in shape)

    for _ in range(100):
        x = rng.choice(range(width + 1 - shape_width))
        y = rng.choice(range(height + 1 - shape_height))
        if all(puzzle[y + dy][x + dx] == "." for dy, dx in shape):
            for dy, dx in shape:
                puzzle[y + dy][x + dx] = object_symbol
            return
    raise FailedToGenerateError()


def generate_puzzle(
    puzzle_width: int,
    puzzle_height: int,
    num_walls: int,
    num_obstacles: int,
    num_goal_objects: int,
    possible_object_shapes: List[List[Tuple[int, int]]],
    rng: Optional[random.Random] = None,
) -> str:
    """One candidate puzzle string (may be unsolvable)."""
    rng = rng or random
    assert len(possible_object_shapes) >= num_goal_objects, (
        "need a distinct shape for each goal object"
    )
    grid = [["." for _ in range(puzzle_width)] for _ in range(puzzle_height)]

    shape1 = rng.choice(possible_object_shapes)
    place_object(grid, "M1", shape1, rng)
    place_object(grid, "G1", shape1, rng)
    if num_goal_objects == 2:
        shape2 = None
        while shape2 is None or shape2 == shape1:
            shape2 = rng.choice(possible_object_shapes)
        place_object(grid, "M2", shape2, rng)
        place_object(grid, "G2", shape2, rng)

    place_object(grid, "A", rng.choice(possible_object_shapes), rng)
    for i in range(num_obstacles):
        place_object(
            grid,
            f"M{1 + i + num_goal_objects}",
            rng.choice(possible_object_shapes),
            rng,
        )
    for _ in range(num_walls):
        place_object(grid, "W", [(0, 0)], rng)

    return "\n".join("  ".join(row) for row in grid)


def generate_level0_puzzles(
    save_location_path: str,
    num_puzzles: int = 5,
    random_seed: int = 0,
    filter_puzzles: bool = True,
    time_limit: float = 2.0,
    min_puzzle_size: int = 8,
    max_puzzle_size: int = 12,
    min_num_walls: int = 2,
    max_num_walls: int = 4,
    min_num_obstacles: int = 1,
    max_num_obstacles: int = 2,
    min_num_goal_objects: int = 1,
    max_num_goal_objects: int = 1,
    object_shapes: str = "complex",
    planner: str = "auto",
    device: DeviceLike = "cuda",
) -> int:
    """Generates puzzles into ``save_location_path`` (must be empty/new).

    Returns the number of puzzles remaining after filtering, which plans on
    ``device``."""
    rng = random.Random(random_seed)

    os.makedirs(save_location_path, exist_ok=True)
    if os.listdir(save_location_path):
        raise ValueError(f"{save_location_path} is not empty!")
    if num_puzzles < 1:
        raise ValueError("num_puzzles must be at least 1")
    if min_puzzle_size < 2 or min_puzzle_size > max_puzzle_size:
        raise ValueError(
            "min_puzzle_size must be >1 and no bigger than max_puzzle_size"
        )
    if min_num_walls < 0 or min_num_walls > max_num_walls:
        raise ValueError("min_num_walls must be >=0 and no bigger than max_num_walls")
    if min_num_obstacles < 0 or min_num_obstacles > max_num_obstacles:
        raise ValueError(
            "min_num_obstacles must be >=0 and no bigger than max_num_obstacles"
        )
    if (
        min_num_goal_objects < 1
        or max_num_goal_objects > 2
        or min_num_goal_objects > max_num_goal_objects
    ):
        raise ValueError(
            "min_num_goal_objects must be >0, max_num_goal_objects must be <3, "
            "and min_num_goal_objects must be no bigger than max_num_goal_objects"
        )

    if object_shapes == "simple":
        shapes = SIMPLE_SHAPES
    elif object_shapes == "complex":
        shapes = COMPLEX_SHAPES
    else:
        raise ValueError("object_shapes must be either 'simple' or 'complex'")

    for i in range(num_puzzles):
        while True:
            try:
                text = generate_puzzle(
                    puzzle_width=rng.choice(
                        range(min_puzzle_size, max_puzzle_size + 1)
                    ),
                    puzzle_height=rng.choice(
                        range(min_puzzle_size, max_puzzle_size + 1)
                    ),
                    num_walls=rng.choice(range(min_num_walls, max_num_walls + 1)),
                    num_obstacles=rng.choice(
                        range(min_num_obstacles, max_num_obstacles + 1)
                    ),
                    num_goal_objects=rng.choice(
                        range(min_num_goal_objects, max_num_goal_objects + 1)
                    ),
                    possible_object_shapes=shapes,
                    rng=rng,
                )
                break
            except FailedToGenerateError:
                continue
        with open(os.path.join(save_location_path, f"puzzle_{i}.pwp"), "w") as f:
            f.write(text)

    if not filter_puzzles:
        return num_puzzles
    return filter_puzzles_by_solvability(
        save_location_path, time_limit, num_puzzles, planner=planner, device=device
    )


def filter_puzzles_by_solvability(
    path: str,
    time_limit: float,
    num_puzzles: int,
    planner: str = "auto",
    device: DeviceLike = "cuda",
) -> int:
    """Keeps (renumbering from 0) only solvable puzzles; deletes the rest.
    reference: generate.py:262-297."""
    from pushworld_tpu_torch.search.planner import solve_puzzle
    from pushworld_tpu_torch.tools import resolve_planner

    planner, device = resolve_planner(planner, device)
    solved_map = {}
    for i in range(num_puzzles):
        puzzle = Puzzle.from_file(os.path.join(path, f"puzzle_{i}.pwp"))
        result = solve_puzzle(
            puzzle, mode="N+RGD", time_limit=time_limit, planner=planner, device=device
        )
        if result.failure_reason is None:
            solved_map[i] = len(solved_map)

    print(f"{len(solved_map)}/{num_puzzles} were solvable")
    for i in range(num_puzzles):
        src = os.path.join(path, f"puzzle_{i}.pwp")
        if i in solved_map:
            os.rename(src, os.path.join(path, f"puzzle_{solved_map[i]}.pwp"))
        else:
            os.remove(src)
    return len(solved_map)
