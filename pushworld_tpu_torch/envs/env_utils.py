"""Puzzle loading and observation helpers shared by the Gym/dm_env wrappers
(host only: numpy, no tensors).

reference: python3/src/pushworld/utils/env_utils.py:25-91 (max benchmark
dimensions; center-padded float32 observation render).
"""

from typing import List, Tuple

import numpy as np

from pushworld_tpu_torch import config
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.utils.filesystem import iter_files_with_extension


def get_max_puzzle_dimensions() -> Tuple[int, int]:
    """(max height, max width), including border walls, over the benchmark
    puzzle directory."""
    max_height = 0
    max_width = 0
    for path in iter_files_with_extension(
        config.BENCHMARK_PUZZLES_PATH, config.PUZZLE_EXTENSION
    ):
        with open(path, "r") as f:
            lines = [ln for ln in f.readlines()]
        max_height = max(max_height, len(lines) + 2)
        max_width = max(max_width, len(lines[0].strip().split()) + 2)
    return max_height, max_width


def load_env_puzzles(
    puzzle_path: str, border_width: int, pixels_per_cell: int, standard_padding: bool
) -> Tuple[List[Puzzle], int, int]:
    """The wrappers' shared set-up: the puzzles under ``puzzle_path`` and the
    (height, width) in cells that every observation is padded to — the
    largest puzzle's, or with ``standard_padding`` the benchmark's."""
    puzzles = [
        Puzzle.from_file(p)
        for p in iter_files_with_extension(puzzle_path, config.PUZZLE_EXTENSION)
    ]
    if not puzzles:
        raise ValueError(f"No PushWorld puzzles found in: {puzzle_path}")
    if border_width < 1:
        raise ValueError("border_width must be >= 1")
    if pixels_per_cell < 3:
        raise ValueError("pixels_per_cell must be >= 3")

    widths, heights = zip(*[p.dimensions for p in puzzles])
    max_cell_width = max(widths)
    max_cell_height = max(heights)
    if standard_padding:
        std_h, std_w = get_max_puzzle_dimensions()
        if std_h < max_cell_height:
            raise ValueError(
                "`standard_padding` is True, but the maximum puzzle height in "
                "BENCHMARK_PUZZLES_PATH is less than the height of the "
                "puzzle(s) in the given `puzzle_path`."
            )
        if std_w < max_cell_width:
            raise ValueError(
                "`standard_padding` is True, but the maximum puzzle width in "
                "BENCHMARK_PUZZLES_PATH is less than the width of the "
                "puzzle(s) in the given `puzzle_path`."
            )
        max_cell_height, max_cell_width = std_h, std_w
    return puzzles, max_cell_height, max_cell_width


def render_observation_padded(
    puzzle: Puzzle,
    state,
    max_cell_height: int,
    max_cell_width: int,
    pixels_per_cell: int,
    border_width: int,
) -> np.ndarray:
    """float32 [0, 1] RGB observation, center zero-padded to
    (max_cell_height * ppc, max_cell_width * ppc, 3)."""
    image = (
        puzzle.render(
            state, border_width=border_width, pixels_per_cell=pixels_per_cell
        ).astype(np.float32)
        / 255
    )
    height_padding = max_cell_height * pixels_per_cell - image.shape[0]
    width_padding = max_cell_width * pixels_per_cell - image.shape[1]
    top = height_padding // 2
    left = width_padding // 2
    return np.pad(
        image,
        [(top, height_padding - top), (left, width_padding - left), (0, 0)],
    )
