"""Entry points of the port: the batched step on the card, and a dry run of
the parallel layer over the ranks of a process group.

The counterpart of the repository's ``__graft_entry__.py`` for the JAX
package.  ``dryrun_multichip(n)`` runs over a group of ``n`` ranks (one
card each, NCCL), or creates a one-rank group when ``n`` is 1 and none
exists; it raises when the group has another number of ranks.
"""

import os
from typing import List

import torch
import torch.distributed as dist

from pushworld_tpu_torch.core.compiled import compile_batch
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.ops.step import is_goal_state, step

_PUZZLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "puzzles")


def _fixture_puzzles() -> List[Puzzle]:
    return [Puzzle.from_file(os.path.join(_PUZZLES, n + ".pwp"))
            for n in ("simple", "chain", "multi_goal", "push_left")]


def entry(device: DeviceLike = "cuda"):
    """(fn, args): the stacked batched dynamics step, ``fn(*args)`` giving
    the next states of 32 rollouts of each of four fixtures, (P, 32, N, 2)."""
    dev = resolve_device(device)
    puzzles = _fixture_puzzles()
    cp = compile_batch(puzzles).to(dev)
    P, B = len(puzzles), 32
    pidx = torch.arange(P, device=dev)[:, None].expand(P, B)

    def forward(cp, states, actions):
        return step(cp, states, actions, puzzle_idx=pidx)

    states = cp.init_state[:, None].expand(P, B, cp.n, 2).contiguous()
    actions = torch.zeros((P, B), dtype=torch.int32, device=dev)
    return forward, (cp, states, actions)


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    """Runs the parallel layer over the group's ``n_devices`` ranks (every
    rank calls it):

    1. ``solve_group``: the fixtures as lanes over a ("puzzle",) mesh, each
       rank advancing its own batched searches, to completion;
    2. ``solve_frontier_sharded``: one puzzle's search over the same mesh;
    3. the batched env step over a ("puzzle", "rollout") mesh, with a global
       solved count (``all_reduce`` along both axes).
    """
    from pushworld_tpu_torch.parallel.frontier_sharded import solve_frontier_sharded
    from pushworld_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, shard_leading
    from pushworld_tpu_torch.parallel.sharded import solve_group

    dev = resolve_device(device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs a process group of "
                           f"{n_devices} ranks, have {have}")
    mesh1 = make_mesh(device=dev)
    puzzles = _fixture_puzzles()
    named = [(f"p{i}", p) for i, p in enumerate(puzzles)]
    results = solve_group(named, mesh=mesh1, time_limit=600, expand=16, frontier_capacity=1 << 8,
                          visited_bits=12, history_capacity=1 << 12, chunk=4)
    solved = sum(1 for r in results.values() if r.failure_reason is None)
    print(f"dryrun sharded planner OK: {solved}/{len(named)} puzzles solved", flush=True)

    fs_puzzle = puzzles[1 % len(puzzles)]
    fs_plan = solve_frontier_sharded(
        fs_puzzle, mesh=make_mesh(device=dev, axis_name="shard"), time_limit=600, expand=8,
        frontier_capacity=max(1 << 10, 64 * n_devices), visited_bits=12,
        history_capacity=1 << 12, chunk=4,
    )
    ok = fs_plan is not None and (fs_plan == [] or fs_puzzle.is_valid_plan(fs_plan))
    print(f"dryrun frontier-sharded OK: plan_len={len(fs_plan) if fs_plan else 0} "
          f"valid={ok} over {n_devices} shards", flush=True)
    if not ok:
        raise RuntimeError("frontier-sharded dryrun produced no valid plan")

    # The env step over a ("puzzle", "rollout") mesh.
    shape = (2, n_devices // 2) if n_devices >= 4 and n_devices % 2 == 0 else (1, n_devices)
    mesh2 = make_mesh_2d(*shape, device=dev)
    reps = max(1, (2 * shape[0]) // len(puzzles) + 1)
    puzzles = (puzzles * reps)[: 2 * shape[0]]
    cp = compile_batch(puzzles).to(dev)
    Pn, B = len(puzzles), 4 * shape[1]
    pidx = shard_leading(mesh2, torch.arange(Pn), "puzzle")
    states = cp.init_state[:, None].expand(Pn, B, cp.n, 2)[pidx]
    states = shard_leading(mesh2, states.transpose(0, 1), "rollout").transpose(0, 1)
    gen = torch.Generator(device=dev).manual_seed(dist.get_rank())
    actions = torch.randint(0, 4, states.shape[:2], generator=gen, device=dev)
    pidx = pidx[:, None].expand(states.shape[:2])
    nxt = step(cp, states, actions, puzzle_idx=pidx)
    solved = is_goal_state(cp, nxt, puzzle_idx=pidx).sum().to(torch.int64).reshape(1)
    for axis in ("rollout", "puzzle"):
        dist.all_reduce(solved, group=mesh2.get_group(axis))
    print(f"dryrun_multichip OK: mesh={shape} puzzles={Pn} rollouts={B} solved={int(solved)}",
          flush=True)
