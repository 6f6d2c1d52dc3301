"""Top-level planning API: solve one puzzle or a set of puzzles.

Port of the JAX package's ``search/planner.py`` for the batched planner.
The host planner (``planner="host"``) and the native portfolio
(``portfolio=True``) are later slices of the port and raise
``NotImplementedError`` here.
"""

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from pushworld_tpu_torch.core.compiled import compile_puzzle, compute_delta
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device

_HOST_PLANNER_TODO = (
    "the host planner is not ported yet (ROADMAP.md, queue 1: slice 2, "
    "search/host_planner.py)"
)
_PORTFOLIO_TODO = (
    "the native portfolio is not ported yet (ROADMAP.md, queue 1: slice 2, "
    "native bridge and plan_puzzles(portfolio=True))"
)

# Shape profiles (n, dim, delta, cmax), as in the JAX package.  The port has
# no compile step, so puzzles are not padded to them; they only group and
# order a set of puzzles as the JAX package does.
_PROFILES = [
    (8, 24, 12, 64),
    (20, 56, 28, 256),
]
_CMAX_LADDER = [p[3] for p in _PROFILES]


def _profile_for(n: int, dim: int, delta: int) -> Tuple[int, int, int, int]:
    for p in _PROFILES:
        if n <= p[0] and dim <= p[1] and delta <= p[2]:
            return p
    return (n, dim, delta, _CMAX_LADDER[-1])


@dataclass
class PlanResult:
    plan: Optional[List[int]]
    planning_time: float
    failure_reason: Optional[str]  # None | "time limit" | "no solution" | ...
    expansions: int = 0
    solver: str = ""


CHUNK = 128  # iterations between host status checks

# The capacities a production run uses: the defaults of ``plan_puzzles``
# (``pair_bits`` is the ``PW_NOVELTY_PAIR_BITS`` default).
PRODUCTION_CAPACITIES = dict(
    expand=256,
    frontier_capacity=1 << 15,
    visited_bits=21,
    history_capacity=1 << 21,
    pair_bits=24,
)


def bucket_key(puzzle: Puzzle, max_depth: int) -> Tuple[int, int, int, int, int]:
    n, dim, d, _ = _profile_for(
        puzzle.num_movables,
        max(puzzle.height, puzzle.width),
        compute_delta(puzzle),
    )
    return (n, dim, dim, d, max_depth)


def solve_puzzle(
    puzzle: Puzzle,
    mode: str = "N+RGD",
    time_limit: Optional[float] = None,
    planner: str = "auto",
    device: DeviceLike = "cuda",
    **kwargs,
) -> PlanResult:
    """Solves one puzzle, returning a :class:`PlanResult`.

    planner: "batched" or "auto" (the same: the batched search on ``device``);
    "host" is not ported yet.  ``kwargs`` go to the batched planner
    (``expand``, ``frontier_capacity``, ``visited_bits``, ...).
    """
    if planner == "host":
        raise NotImplementedError(_HOST_PLANNER_TODO)
    if planner not in ("auto", "batched"):
        raise ValueError(f"unknown planner {planner!r}")
    from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth

    device = resolve_device(device)
    t0 = time.monotonic()
    max_depth = kwargs.pop("max_depth", None)
    bp = None
    try:
        bp = BatchedPlanner(
            puzzle,
            max_depth=required_depth(puzzle) if max_depth is None else max_depth,
            use_novelty=(mode == "N+RGD"),
            device=device,
            **kwargs,
        )
        plan = bp.solve(time_limit=time_limit)
    except TimeoutError:
        return PlanResult(None, time.monotonic() - t0, "time limit", _expansions(bp))
    except MemoryError:
        return PlanResult(None, time.monotonic() - t0, "memory error", _expansions(bp))
    dt = time.monotonic() - t0
    expansions = _expansions(bp)

    if plan is None:
        return PlanResult(None, dt, "no solution", expansions)
    if not puzzle.is_valid_plan(plan) and plan != []:
        return PlanResult(plan, dt, "invalid plan", expansions)
    return PlanResult(plan, dt, None, expansions)


def _expansions(bp) -> int:
    s = None if bp is None else bp.last_state
    return 0 if s is None else int(s.expansions)


def plan_puzzles(
    named_puzzles: Sequence[Tuple[str, Puzzle]],
    mode: str = "N+RGD",
    time_limit: Optional[float] = 60.0,
    expand: int = PRODUCTION_CAPACITIES["expand"],
    frontier_capacity: int = PRODUCTION_CAPACITIES["frontier_capacity"],
    visited_bits: int = PRODUCTION_CAPACITIES["visited_bits"],
    history_capacity: int = PRODUCTION_CAPACITIES["history_capacity"],
    progress: bool = False,
    portfolio: bool = False,
    device: DeviceLike = "cuda",
    **kwargs,
) -> Dict[str, PlanResult]:
    """Solves many puzzles with the batched planner, visiting them grouped by
    the JAX package's bucket keys (sorted), each at its own RGD depth."""
    if portfolio:
        raise NotImplementedError(_PORTFOLIO_TODO)
    from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth

    device = resolve_device(device)
    buckets: Dict[tuple, List[Tuple[str, Puzzle, int]]] = {}
    for name, puzzle in named_puzzles:
        depth = required_depth(puzzle)
        buckets.setdefault(bucket_key(puzzle, depth), []).append((name, puzzle, depth))

    results: Dict[str, PlanResult] = {}
    for key in sorted(buckets):
        for name, puzzle, depth in buckets[key]:
            t0 = time.monotonic()
            try:
                planner = BatchedPlanner(
                    puzzle,
                    cp=compile_puzzle(puzzle),
                    expand=expand,
                    frontier_capacity=frontier_capacity,
                    visited_bits=visited_bits,
                    history_capacity=history_capacity,
                    max_depth=depth,
                    use_novelty=(mode == "N+RGD"),
                    device=device,
                    **kwargs,
                )
                remaining = (
                    None if time_limit is None
                    else max(0.5, time_limit - (time.monotonic() - t0))
                )
                plan = planner.solve(time_limit=remaining, chunk=CHUNK)
                dt = time.monotonic() - t0
                if plan is None:
                    results[name] = PlanResult(None, dt, "no solution")
                elif plan == [] or puzzle.is_valid_plan(plan):
                    results[name] = PlanResult(plan, dt, None)
                else:
                    results[name] = PlanResult(plan, dt, "invalid plan")
            except TimeoutError:
                results[name] = PlanResult(None, time.monotonic() - t0, "time limit")
            if progress:
                r = results[name]
                status = "ok" if r.failure_reason is None else r.failure_reason
                print(
                    f"  {name}: {status} "
                    f"({r.planning_time:.2f}s, plan={len(r.plan) if r.plan else 0})",
                    flush=True,
                )
    return results
