"""Argparse CLIs for the toolkit, one sub-entry per reference script.

reference scripts (python3/scripts/*.py): benchmark_rgd, convert_to_pddl,
convert_to_sas, create_transformed_puzzles, generate_level0_puzzles,
plot_puzzles_solved_vs_time, render_plans, render_puzzle_previews.

Usage: ``python -m pushworld_tpu_torch.scripts.tools_cli <command> [options]``.
The port's copy of the JAX package's CLI: the same eight subcommands and
arguments; ``benchmark`` and ``generate-level0`` also take ``--device``
(``cuda``, the default, or ``cpu``), the device they plan on.
"""

import argparse
import sys

from pushworld_tpu_torch import config


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pushworld-tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("benchmark", help="run the planner over a puzzle tree")
    p.add_argument("--puzzles-path", default=config.BENCHMARK_PUZZLES_PATH)
    p.add_argument("--results-path", default="results")
    p.add_argument("--heuristic", default="N+RGD", choices=["RGD", "N+RGD"])
    p.add_argument("--time-limit", type=float, default=1800.0)
    p.add_argument("--planner", default="auto", choices=["auto", "batched", "host"])
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("convert-to-pddl", help="export puzzles as PDDL")
    p.add_argument("pddl_path")
    p.add_argument("--puzzle-path", default=config.BENCHMARK_PUZZLES_PATH)
    p.add_argument("--for-bfws", action="store_true")

    p = sub.add_parser("convert-to-sas", help="translate PDDL pairs to SAS")
    p.add_argument("pddl_path")
    p.add_argument("--fast-downward", default=config.FAST_DOWNWARD_PATH)

    p = sub.add_parser("transform", help="write all 8 symmetries of puzzles")
    p.add_argument("puzzle_path")
    p.add_argument("output_path")

    p = sub.add_parser("generate-level0", help="generate random level-0 puzzles")
    p.add_argument("save_path")
    p.add_argument("--num-puzzles", type=int, default=5)
    p.add_argument("--random-seed", type=int, default=0)
    p.add_argument("--no-filter", action="store_true")
    p.add_argument("--time-limit", type=float, default=2.0)
    p.add_argument("--object-shapes", default="complex", choices=["simple", "complex"])
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("plot", help="plot puzzles-solved-vs-time curves")
    p.add_argument("results_path")
    p.add_argument("--output", default="puzzles_solved_vs_time.png")
    p.add_argument("--timeout", type=float, default=1800.0)

    p = sub.add_parser("render-previews", help="render puzzle preview images")
    p.add_argument("image_path")
    p.add_argument("--puzzle-path", default=config.BENCHMARK_PUZZLES_PATH)

    p = sub.add_parser("render-plans", help="render MP4 videos of result plans")
    p.add_argument("results_path")
    p.add_argument("video_path")
    p.add_argument("--puzzle-path", default=config.BENCHMARK_PUZZLES_PATH)
    p.add_argument("--fps", type=float, default=6.0)

    args = parser.parse_args(argv)

    if args.command == "benchmark":
        from pushworld_tpu_torch.tools.benchmark import benchmark_planner

        benchmark_planner(
            puzzles_path=args.puzzles_path,
            results_path=args.results_path,
            heuristic=args.heuristic,
            time_limit=args.time_limit,
            planner=args.planner,
            device=args.device,
        )
    elif args.command == "convert-to-pddl":
        from pushworld_tpu_torch.tools.pddl import convert_all_puzzles_to_pddl

        convert_all_puzzles_to_pddl(args.pddl_path, args.puzzle_path, args.for_bfws)
    elif args.command == "convert-to-sas":
        from pushworld_tpu_torch.tools.sas import convert_all_pddls_to_sas

        convert_all_pddls_to_sas(args.pddl_path, args.fast_downward)
    elif args.command == "transform":
        from pushworld_tpu_torch.tools.transform import create_transformed_puzzles

        create_transformed_puzzles(args.puzzle_path, args.output_path)
    elif args.command == "generate-level0":
        from pushworld_tpu_torch.tools.generate import generate_level0_puzzles

        generate_level0_puzzles(
            args.save_path,
            num_puzzles=args.num_puzzles,
            random_seed=args.random_seed,
            filter_puzzles=not args.no_filter,
            time_limit=args.time_limit,
            object_shapes=args.object_shapes,
            device=args.device,
        )
    elif args.command == "plot":
        from pushworld_tpu_torch.tools.plot import plot_puzzles_solved_vs_time

        plot_puzzles_solved_vs_time(args.results_path, args.output, args.timeout)
    elif args.command == "render-previews":
        from pushworld_tpu_torch.tools.visualization import render_puzzle_previews

        render_puzzle_previews(args.image_path, args.puzzle_path)
    elif args.command == "render-plans":
        from pushworld_tpu_torch.tools.visualization import render_plans

        render_plans(args.results_path, args.video_path, args.puzzle_path, args.fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
