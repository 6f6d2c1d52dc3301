"""Puzzles-solved-vs-time curves from result YAML directories.

The port's copy of the JAX package's ``tools/plot.py`` (matplotlib, ``Agg``
backend).

reference behavior: python3/src/pushworld/plot.py:25-120 — log-x step
curves, dual y-axis (count and %), validation that all planners attempted
identical puzzle sets and have unique per-puzzle results.
"""

from collections import defaultdict

import yaml

from pushworld_tpu_torch.utils.filesystem import iter_files_with_extension


def plot_puzzles_solved_vs_time(
    planner_results_path: str,
    output_file_path: str = "puzzles_solved_vs_time.png",
    planning_timeout: float = 60 * 30,
) -> None:
    """Plots cumulative puzzles-solved vs planning time per planner.

    Each ``.yaml`` under ``planner_results_path`` must contain keys
    ``planner``, ``puzzle``, ``plan`` (null if unsolved), ``planning_time``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    solve_times = defaultdict(list)
    attempted = defaultdict(set)

    for path in iter_files_with_extension(planner_results_path, ".yaml"):
        with open(path, "r") as f:
            result = yaml.safe_load(f)
        planner = result["planner"]
        puzzle = result["puzzle"]
        if puzzle in attempted[planner]:
            raise ValueError(
                f'Planner "{planner}" has multiple results for the '
                f'"{puzzle}" puzzle'
            )
        attempted[planner].add(puzzle)
        if result["plan"] is not None:
            solve_times[planner].append(result["planning_time"])

    planners = list(attempted.items())
    if not planners:
        raise ValueError(f"No result files found under {planner_results_path}")
    for planner, puzzles in planners[1:]:
        if puzzles != planners[0][1]:
            raise ValueError(
                f'Planners "{planner}" and "{planners[0][0]}" did not attempt '
                "the same puzzles."
            )

    _, ax1 = plt.subplots()
    ax2 = ax1.twinx()

    for planner, times in sorted(solve_times.items()):
        x = sorted(times)
        y = list(range(1, 1 + len(x)))
        # Log-x cannot show 0: clamp leading zeros to the first positive time.
        first_positive = next((t for t in x if t > 0), planning_timeout)
        x = [t if t > 0 else first_positive for t in x]
        x.append(planning_timeout)
        y.append(y[-1])
        ax1.plot(x, y, label=planner)

    num_puzzles = len(planners[0][1])
    max_solved = max((len(v) for v in solve_times.values()), default=1)

    ax1.set_xscale("log")
    ax1.set_xlabel("Planning Time (seconds)")
    ax1.set_ylabel("Number of Puzzles Solved")
    mn, mx = ax1.set_ylim(0, max_solved * 1.05)
    ax2.set_ylabel("% of Puzzles Solved")
    ax2.set_ylim(mn * 100 / num_puzzles, mx * 100 / num_puzzles)
    ax1.legend()
    plt.tight_layout()
    plt.savefig(output_file_path)
    plt.close()
