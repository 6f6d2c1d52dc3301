"""Global configuration: file extensions, the dataset path and tool paths.

The port's copy of the JAX package's ``config.py`` (reference:
python3/src/pushworld/config.py:20-33).

The benchmark dataset (223 puzzles + human solutions) is an external
artifact; its location is configurable via ``PUSHWORLD_BENCHMARK_PATH`` so
the framework stays standalone.  Any folder holding
``puzzles/<level>/*.pwp`` will do.  Without the variable the first candidate
is ``benchmark/`` at the repository root, beside this package.
"""

import os

PUZZLE_EXTENSION = ".pwp"
RESULT_EXTENSION = ".yaml"

# PDDL export file suffixes (reference: config.py:30-33).
DOMAIN_SUFFIX = "_domain.pddl"
PROBLEM_SUFFIX = "_problem.pddl"


def _default_benchmark_root() -> str:
    env = os.environ.get("PUSHWORLD_BENCHMARK_PATH")
    if env:
        return env
    candidate = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark"
    )
    if os.path.isdir(candidate):
        return candidate
    return "benchmark"


BENCHMARK_ROOT = _default_benchmark_root()
BENCHMARK_PUZZLES_PATH = os.path.join(BENCHMARK_ROOT, "puzzles")
BENCHMARK_SOLUTIONS_PATH = os.path.join(BENCHMARK_ROOT, "solutions")

# Optional external binaries (for cross-checking / SAS export).
RGD_PLANNER_PATH = os.environ.get("PUSHWORLD_RGD_PLANNER", "")
FAST_DOWNWARD_PATH = os.environ.get("PUSHWORLD_FAST_DOWNWARD", "")
