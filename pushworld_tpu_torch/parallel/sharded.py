"""Puzzle-sharded SPMD planning: one batched search per lane, lanes split
over the ranks of a mesh, advanced in lockstep chunks.

Port of the JAX package's ``parallel/sharded.py``.  Independent puzzles are
the embarrassingly parallel axis of the benchmark (the reference runs its
planner subprocesses one after the other, benchmark_rgd.py:70-84).  A group
of G puzzles is cut into one contiguous block of ceil(G / D) lanes per rank
(the last blocks may be short or empty), as ``NamedSharding(P("puzzle"))``
lays out the JAX package's lanes padded to a multiple of the mesh size.
Each chunk, every rank runs each of its lanes through
``search.batched.run_chunk``; then ONE all-gather of the packed (G, 8)
status (``search_status``'s layout) gives every rank the same stop and
deadline decision.  A short block pads its status rows with finished rows,
so no rank searches a padding lane.  Lanes that finish keep their results (solved
flag and history are sticky) while the others continue.

Nothing is padded to a shape ladder: each lane is the port's
``BatchedPlanner`` search of its own puzzle, which takes the JAX lane's
steps.
"""

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.parallel.mesh import all_gather_flat, make_mesh, mesh_device
from pushworld_tpu_torch.search.batched import (
    EMPTY,
    BatchedPlanner,
    reconstruct_plan,
    run_chunk,
    search_status_tensor,
)
from pushworld_tpu_torch.search.planner import PlanResult


def solve_group(
    named_puzzles: Sequence[Tuple[str, Puzzle]],
    mesh: Optional[DeviceMesh] = None,
    mode: str = "N+RGD",
    time_limit: Optional[float] = 60.0,
    max_depth: int = 1,
    expand: int = 128,
    frontier_capacity: int = 1 << 14,
    visited_bits: int = 19,
    history_capacity: int = 1 << 19,
    chunk: int = 16,
) -> Dict[str, PlanResult]:
    """Solves a group of puzzles concurrently over the ranks of ``mesh``
    (default: :func:`make_mesh` on the card).  Every rank of the mesh calls
    it with the same arguments and gets the whole result dict.

    Each lane searches at ``max_depth`` with no depth escalation, as in the
    JAX package.
    """
    if mesh is None:
        mesh = make_mesh()
    D, me, group = mesh.size(), mesh.get_local_rank(), mesh.get_group()
    dev = mesh_device(mesh)

    names = [n for n, _ in named_puzzles]
    puzzles = [p for _, p in named_puzzles]
    G = len(puzzles)
    per = -(-G // D)
    mine = range(min(me * per, G), min((me + 1) * per, G))
    # A finished row (solved) for each lane this rank lacks.
    pad = torch.zeros((per - len(mine), 8), dtype=torch.int32, device=dev)
    pad[:, 0] = 1

    planners = [
        BatchedPlanner(
            puzzles[i],
            expand=expand,
            frontier_capacity=frontier_capacity,
            visited_bits=visited_bits,
            history_capacity=history_capacity,
            max_depth=max_depth,
            use_novelty=(mode == "N+RGD"),
            device=dev,
        )
        for i in mine
    ]
    states = [pl.init_state() for pl in planners]

    t0 = time.monotonic()
    deadline = None if time_limit is None else t0 + time_limit
    ended = [False] * len(states)  # by the last status: its chunks would be no-ops
    while True:
        for pl, s, done in zip(planners, states, ended):
            if not done:  # on the card a chunk on an ended search still costs one closed iteration
                run_chunk(pl.cp_dev, pl.tables, pl.config, s, chunk)
        # One packed all-gather per chunk: every lane's status, and each
        # rank's vote on the deadline (its own clock), after them.
        over = deadline is not None and time.monotonic() > deadline
        local = torch.cat([torch.stack([search_status_tensor(s) for s in states] + list(pad)).reshape(-1),
                           torch.tensor([int(over)], dtype=torch.int32, device=dev)])
        every = torch.empty((D * local.numel(),), dtype=torch.int32, device=dev)
        all_gather_flat(every, local, group=group)
        every = every.reshape(D, -1).cpu().numpy()
        stat = every[:, :-1].reshape(D * per, 8)[:G]
        solved = stat[:, 0].astype(bool)
        exhausted = stat[:, 2] >= EMPTY
        hist_full = stat[:, 3] >= history_capacity - 8 * expand
        if not (~solved & ~exhausted & ~hist_full).any():
            break
        ended = [bool(solved[i] | exhausted[i] | hist_full[i]) for i in mine]
        if every[:, -1].any():
            break

    # Each rank classifies its own lanes; the results are exchanged.
    elapsed = time.monotonic() - t0
    local_results: Dict[str, PlanResult] = {}
    for i, s in zip(mine, states):
        name, p = names[i], puzzles[i]
        if p.is_goal_state(p.initial_state):
            local_results[name] = PlanResult([], elapsed, None)
        elif stat[i, 0]:
            plan = reconstruct_plan(s)
            local_results[name] = PlanResult(plan, elapsed, None if p.is_valid_plan(plan) else "invalid plan")
        elif stat[i, 2] >= EMPTY and stat[i, 5] == 0:
            local_results[name] = PlanResult(None, elapsed, "no solution")
        else:
            local_results[name] = PlanResult(None, elapsed, "time limit")
    gathered: List[Dict[str, PlanResult]] = [None] * D
    dist.all_gather_object(gathered, local_results, group=group)
    merged = {}
    for part in gathered:
        merged.update(part)
    return {n: merged[n] for n in names}
