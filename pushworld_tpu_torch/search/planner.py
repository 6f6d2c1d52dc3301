"""Top-level planning API: solve one puzzle or a set of puzzles.

Port of the JAX package's ``search/planner.py``: the batched device planner,
the host planner (``planner="host"``) and the CPU+GPU portfolio that races
the native serial planner against the batched search
(``plan_puzzles(portfolio=True)``, the default).
"""

import concurrent.futures as cf
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from pushworld_tpu_torch.core.compiled import compile_puzzle, compute_delta
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.search.batched import CHUNK
from pushworld_tpu_torch.utils import tracing

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
    solver: str = ""  # which fleet/portfolio member produced the result
    iterations: int = 0  # the batched search's iterations (0 for other solvers)


# Upcoming puzzles whose tables ``plan_puzzles`` builds ahead, on one thread.
PREFETCH = 6

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


def _headstart() -> float:
    """Seconds the native member runs alone (``PW_PORTFOLIO_HEADSTART``)."""
    return float(os.environ.get("PW_PORTFOLIO_HEADSTART", "1.0"))


def _portfolio_solve(
    planner_factory, puzzle, cp, mode, time_limit, solver_out: Optional[list] = None
):
    """Races the native serial planner (host thread; the ctypes call
    releases the GIL) against the batched device search.  Returns the first
    plan found, None only when a complete search proves that no solution is
    possible, and raises TimeoutError when the budget expires.

    ``planner_factory`` is called (and may block on the table build) only
    after the native member fails to finish within a short head start:
    instances the serial planner solves in milliseconds never engage the
    device.  ``solver_out``, when given, receives the winning member's name
    ("native" or "device")."""
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.search.batched import (
        EMPTY,
        PendingStatus,
        reconstruct_plan,
        run_chunk,
    )

    def won(member: str) -> None:
        if solver_out is not None:
            solver_out.append(member)

    if not bridge.is_available():
        won("device")
        return planner_factory().solve(time_limit=time_limit)

    if puzzle.is_goal_state(puzzle.initial_state):
        won("native")
        return []

    ex = cf.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(
        bridge.solve_native_staged, puzzle, compiled=cp, mode=mode, time_limit=time_limit
    )
    ex.shutdown(wait=False)

    deadline = None if time_limit is None else time.monotonic() + time_limit

    # Native head start (poll-based: fut.result(timeout=...) raises the
    # same TimeoutError type the native member uses for budget exhaustion).
    headstart = _headstart()
    headstart_end = time.monotonic() + (
        headstart if time_limit is None else min(headstart, 0.5 * time_limit)
    )
    while time.monotonic() < headstart_end and not fut.done():
        time.sleep(0.005)
    if fut.done():
        try:
            plan = fut.result()
            if plan is None or plan == [] or puzzle.is_valid_plan(plan):
                won("native")
                return plan
        except TimeoutError:
            raise  # native had the full budget and exhausted it
        except Exception:
            pass  # memory limit or an error: fall through to the device member

    planner = planner_factory()
    debug = bool(os.environ.get("PW_DEBUG"))
    cfg = planner.config
    chunks = 0
    device_dead = None  # None = running; otherwise its terminal outcome
    # Pipelined as in BatchedPlanner.solve: chunk k+1 is enqueued before
    # chunk k's status is read; the plan comes from the newest state.
    s = planner.init_state()
    run_chunk(planner.cp_dev, planner.tables, cfg, s, CHUNK, deadline)
    pending = PendingStatus(s)
    while True:
        if fut is not None and fut.done():
            try:
                plan = fut.result()
            except Exception:
                plan = False  # native budget exhausted: keep the device going
            if plan is not False:
                if plan is not None and puzzle.is_valid_plan(plan):
                    won("native")
                    return plan
                if plan is None:
                    won("native")
                    return None  # native search is complete
            fut = None
        if device_dead is None:
            run_chunk(planner.cp_dev, planner.tables, cfg, s, CHUNK, deadline)
            pending, stat = PendingStatus(s), pending.read()
            solved, _, min_key, cursor, _, evictions, iters, _ = stat
            chunks += 1
            if debug:
                print(f"    [chunk {chunks} iters={iters}]", flush=True)
            if solved:
                won("device")
                return reconstruct_plan(s)
            if min_key >= EMPTY:
                device_dead = "no solution" if evictions == 0 else "inconclusive"
                if device_dead == "no solution":
                    won("device")
                    return None
            elif cursor >= cfg.history_capacity - 8 * cfg.expand:
                device_dead = "history full"
        elif fut is None:
            raise TimeoutError("both portfolio members exhausted budgets")
        else:
            time.sleep(0.05)
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError("time budget exhausted")


def solve_puzzle(
    puzzle: Puzzle,
    mode: str = "N+RGD",
    time_limit: Optional[float] = None,
    planner: str = "auto",
    device: DeviceLike = "cuda",
    **kwargs,
) -> PlanResult:
    """Solves one puzzle, returning a :class:`PlanResult`.

    planner: "batched" or "auto" (the same: the batched search on
    ``device``), or "host" (the serial oracle planner, which uses no device).
    ``kwargs`` go to the batched planner (``expand``, ``frontier_capacity``,
    ``visited_bits``, ...).

    Under ``torch.profiler`` the call is the span ``pw.solve`` (with the
    phases of ``utils/tracing.py`` inside it), counts in
    ``tracing.COUNTERS["solves"]`` and, on a card, adds the growth of the
    allocator's reserved bytes to ``COUNTERS["reserved_growth_bytes"]``.
    """
    if planner not in ("auto", "batched", "host"):
        raise ValueError(f"unknown planner {planner!r}")
    if not tracing.recording():
        return _solve_puzzle(puzzle, mode, time_limit, planner, device, kwargs)
    with tracing.span("pw.solve"):
        tracing.count("solves")
        card = planner != "host" and resolve_device(device).type == "cuda"
        reserved = tracing.reserved_bytes(device) if card else 0
        try:
            return _solve_puzzle(puzzle, mode, time_limit, planner, device, kwargs)
        finally:
            if card:
                tracing.count("reserved_growth_bytes", max(0, tracing.reserved_bytes(device) - reserved))


def _solve_puzzle(puzzle: Puzzle, mode: str, time_limit: Optional[float], planner: str, device: DeviceLike,
                  kwargs: dict) -> PlanResult:
    t0 = time.monotonic()
    bp = None
    try:
        if planner == "host":
            from pushworld_tpu_torch.search.host_planner import solve_host

            plan = solve_host(puzzle, mode=mode, time_limit=time_limit)
        else:
            from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth

            device = resolve_device(device)
            max_depth = kwargs.pop("max_depth", None)
            if max_depth is None:
                with tracing.span("pw.solve.required_depth"):
                    max_depth = required_depth(puzzle)
            bp = BatchedPlanner(
                puzzle,
                max_depth=max_depth,
                use_novelty=(mode == "N+RGD"),
                device=device,
                **kwargs,
            )
            plan = bp.solve(time_limit=time_limit)
    except TimeoutError:
        return PlanResult(None, time.monotonic() - t0, "time limit", **_counts(bp))
    except MemoryError:
        return PlanResult(None, time.monotonic() - t0, "memory error", **_counts(bp))
    dt = time.monotonic() - t0
    counts = _counts(bp)

    if plan is None:
        return PlanResult(None, dt, "no solution", **counts)
    with tracing.span("pw.solve.validate"):
        valid = plan == [] or puzzle.is_valid_plan(plan)
    if not valid:
        return PlanResult(plan, dt, "invalid plan", **counts)
    return PlanResult(plan, dt, None, **counts)


def _counts(bp) -> Dict[str, int]:
    """The expansions and iterations of the batched planner's last search."""
    s = None if bp is None else bp.last_state
    return {} if s is None else {"expansions": int(s.expansions), "iterations": int(s.iterations)}


def plan_puzzles(
    named_puzzles: Sequence[Tuple[str, Puzzle]],
    mode: str = "N+RGD",
    time_limit: Optional[float] = 60.0,
    expand: int = PRODUCTION_CAPACITIES["expand"],
    frontier_capacity: int = PRODUCTION_CAPACITIES["frontier_capacity"],
    visited_bits: int = PRODUCTION_CAPACITIES["visited_bits"],
    history_capacity: int = PRODUCTION_CAPACITIES["history_capacity"],
    progress: bool = False,
    portfolio: bool = True,
    device: DeviceLike = "cuda",
    **kwargs,
) -> Dict[str, PlanResult]:
    """Solves many puzzles with the batched planner, visiting them grouped by
    the JAX package's bucket keys (sorted), each at its own RGD depth.

    With ``portfolio=True`` (default) the native serial planner races the
    device search on a host thread per puzzle, a heterogeneous CPU+GPU
    portfolio: the serial planner's strict sequential novelty ordering wins
    on ordering-sensitive instances, the batched device search wins on
    instances needing massive exploration; the first valid plan is taken.

    Upcoming puzzles' tables are built on one worker thread (``PREFETCH``
    deep) while the current puzzle solves; the build launches on the
    device's default stream, which the search uses too, so the tables are
    ordered before the search that reads them."""
    from pushworld_tpu_torch.ops.rgd import build_rgd_tables
    from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth

    device = resolve_device(device)
    buckets: Dict[tuple, List[Tuple[str, Puzzle, int]]] = {}
    for name, puzzle in named_puzzles:
        depth = required_depth(puzzle)
        buckets.setdefault(bucket_key(puzzle, depth), []).append((name, puzzle, depth))

    results: Dict[str, PlanResult] = {}
    for key in sorted(buckets):
        group = buckets[key]
        cps = {name: compile_puzzle(puzzle) for name, puzzle, _ in group}
        prep = cf.ThreadPoolExecutor(max_workers=1)

        def _build(g_idx: int, group=group, cps=cps):
            g_name, g_puzzle, g_depth = group[g_idx]
            if device.type == "cuda":
                torch.cuda.set_device(device)
            return build_rgd_tables(g_puzzle, cps[g_name], max_depth=g_depth, device=device)

        pending = deque(prep.submit(_build, i) for i in range(min(PREFETCH, len(group))))
        for gi, (name, puzzle, depth) in enumerate(group):
            t0 = time.monotonic()
            tables_fut = pending.popleft()
            if gi + PREFETCH < len(group):
                pending.append(prep.submit(_build, gi + PREFETCH))

            def planner_factory(name=name, puzzle=puzzle, depth=depth, tables_fut=tables_fut):
                # Blocks on the prefetched table build only when the device
                # member engages.
                return BatchedPlanner(
                    puzzle,
                    cp=cps[name],
                    tables=tables_fut.result(),
                    expand=expand,
                    frontier_capacity=frontier_capacity,
                    visited_bits=visited_bits,
                    history_capacity=history_capacity,
                    max_depth=depth,
                    use_novelty=(mode == "N+RGD"),
                    device=device,
                    **kwargs,
                )

            solver: List[str] = []
            try:
                remaining = (
                    None if time_limit is None
                    else max(0.5, time_limit - (time.monotonic() - t0))
                )
                if portfolio:
                    plan = _portfolio_solve(
                        planner_factory, puzzle, cps[name], mode, remaining, solver
                    )
                else:
                    solver.append("device")
                    plan = planner_factory().solve(time_limit=remaining, chunk=CHUNK)
                dt = time.monotonic() - t0
                if plan is None:
                    results[name] = PlanResult(None, dt, "no solution")
                elif plan == [] or puzzle.is_valid_plan(plan):
                    results[name] = PlanResult(plan, dt, None)
                else:
                    results[name] = PlanResult(plan, dt, "invalid plan")
            except TimeoutError:
                results[name] = PlanResult(None, time.monotonic() - t0, "time limit")
            results[name].solver = solver[-1] if solver else "portfolio"
            if progress:
                r = results[name]
                status = "ok" if r.failure_reason is None else r.failure_reason
                print(
                    f"  {name}: {status} "
                    f"({r.planning_time:.2f}s, plan={len(r.plan) if r.plan else 0})",
                    flush=True,
                )
        # Wait for a build that is already running, so that no device work
        # of this call is pending when it returns.
        prep.shutdown(wait=True, cancel_futures=True)
    return results
