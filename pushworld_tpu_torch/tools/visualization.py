"""Batch rendering: puzzle preview images and plan videos.

The port's copy of the JAX package's ``tools/visualization.py``, over the
port's oracle renderer (``Puzzle.render`` / ``render_plan``, numpy).

reference behavior: python3/src/pushworld/visualization.py:26-104.
"""

import yaml

from pushworld_tpu_torch import config
from pushworld_tpu_torch.core.puzzle import Puzzle, plan_from_string
from pushworld_tpu_torch.utils.filesystem import (
    get_puzzle_file_paths,
    map_files_with_extension,
)
from pushworld_tpu_torch.utils.images2mp4 import images2mp4


def render_puzzle_previews(
    image_path: str,
    puzzle_path: str = config.BENCHMARK_PUZZLES_PATH,
    image_extension: str = ".png",
) -> None:
    """Renders every puzzle's initial state to an image, mirroring the
    directory tree of ``puzzle_path`` under ``image_path``."""
    from PIL import Image

    for puzzle_file, image_file in map_files_with_extension(
        puzzle_path, config.PUZZLE_EXTENSION, image_path, image_extension
    ):
        puzzle = Puzzle.from_file(puzzle_file)
        Image.fromarray(puzzle.render(puzzle.initial_state)).save(image_file)


def render_plans(
    planning_results_path: str,
    video_path: str,
    puzzle_path: str = config.BENCHMARK_PUZZLES_PATH,
    fps: float = 6.0,
) -> None:
    """Renders an MP4 per solved result YAML under ``planning_results_path``."""
    puzzle_files = get_puzzle_file_paths(puzzle_path)

    for result_file, video_file in map_files_with_extension(
        planning_results_path, ".yaml", video_path, ".mp4"
    ):
        with open(result_file) as f:
            result = yaml.safe_load(f)
        plan = result["plan"]
        if plan is None:
            continue
        name = result["puzzle"]
        if name not in puzzle_files:
            raise ValueError(
                f'No puzzle is named "{name}" in the directory: {puzzle_path}'
            )
        puzzle = Puzzle.from_file(puzzle_files[name])
        images2mp4(video_file, images=puzzle.render_plan(plan_from_string(plan)), fps=fps)
