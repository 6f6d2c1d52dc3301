"""Multi-process (multi-host) benchmark planning over ``torch.distributed``.

Port of the JAX package's ``parallel/distributed.py``.  The reference has no
distributed runtime; its benchmark harness is a sequential single-process
loop (reference: python3/src/pushworld/benchmark_rgd.py:70-84).  Here the
natural axis, independent puzzles, is sharded across *processes* (one per
card or host), each of which runs the local fleet or planner on its own
card; the per-puzzle results are exchanged at the end with an object
all-gather over gloo (kilobytes of host data: no device collective).
Several processes may share one card: they exchange nothing on it.

Launch (the same command in every process):

    PW_COORDINATOR=host0:12345 PW_NUM_PROCESSES=4 PW_PROCESS_ID=<i> \\
        python -m pushworld_tpu_torch.scripts.benchmark_distributed <puzzles_dir>

or under ``torchrun``, whose ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
are read when the ``PW_*`` variables are absent.
"""

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.search.planner import PlanResult

__all__ = [
    "initialize_from_env",
    "shard_puzzles",
    "plan_puzzles_distributed",
]


def initialize_from_env() -> Tuple[int, int]:
    """Initializes the default (gloo) process group from the PW_* variables,
    else from torchrun's; without either the run is single-process.  Returns
    (process_id, n_processes).  Safe to call when already initialized."""
    if not dist.is_initialized():
        coord = os.environ.get("PW_COORDINATOR")
        if coord:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coord}",
                world_size=int(os.environ["PW_NUM_PROCESSES"]),
                rank=int(os.environ["PW_PROCESS_ID"]),
            )
        elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            dist.init_process_group("gloo", init_method="env://")
        else:
            return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_puzzles(
    named_puzzles: Sequence[Tuple[str, Puzzle]],
    process_id: int,
    n_processes: int,
) -> List[Tuple[str, Puzzle]]:
    """Deterministic difficulty-balanced shard.

    Instances are ordered by a difficulty proxy (movable count, grid area)
    and dealt round-robin, so every process receives an interleaved slice
    of the difficulty distribution and all processes finish within about
    one per-puzzle budget of each other.  (A name-ordered round-robin can
    hand one process most of the budget-burning misses — the skewed
    process then outlives the others by minutes, which trips the
    coordination service's cross-process barrier timeout at the result
    exchange/shutdown.)"""
    order = sorted(
        range(len(named_puzzles)),
        key=lambda i: (
            named_puzzles[i][1].num_movables,
            named_puzzles[i][1].height * named_puzzles[i][1].width,
            named_puzzles[i][0],
        ),
    )
    return [
        named_puzzles[j]
        for k, j in enumerate(order)
        if k % n_processes == process_id
    ]


def _result_to_json(name: str, r: PlanResult) -> str:
    return json.dumps(
        {
            "puzzle": name,
            "plan": r.plan,
            "planning_time": r.planning_time,
            "failure_reason": r.failure_reason,
            "solver": r.solver,
        }
    )


def _results_from_json(blob: str) -> Dict[str, PlanResult]:
    out = {}
    for rec in json.loads(blob):
        d = json.loads(rec)
        out[d["puzzle"]] = PlanResult(
            plan=d["plan"],
            planning_time=d["planning_time"],
            failure_reason=d["failure_reason"],
            solver=d.get("solver", ""),
        )
    return out


def plan_puzzles_distributed(
    named_puzzles: Sequence[Tuple[str, Puzzle]],
    mode: str = "N+RGD",
    time_limit: Optional[float] = 60.0,
    use_fleet: bool = True,
    device: DeviceLike = "cuda",
    **kwargs,
) -> Dict[str, PlanResult]:
    """Plans the full set across all processes of the default group; every
    process returns the COMPLETE result dict.

    Each process plans its shard (:func:`shard_puzzles`) on
    ``cuda:{rank % device_count}`` ("cuda", the default, raises without a
    card) or on the CPU (``device="cpu"``); the results are exchanged as JSON
    through an object all-gather over gloo."""
    pid, nproc = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = resolve_device(f"cuda:{pid % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    local = shard_puzzles(named_puzzles, pid, nproc)

    if use_fleet:
        from pushworld_tpu_torch.search.fleet import plan_puzzles_fleet

        local_results = plan_puzzles_fleet(local, mode=mode, time_limit=time_limit, device=dev, **kwargs)
    else:
        from pushworld_tpu_torch.search.planner import plan_puzzles

        local_results = plan_puzzles(local, mode=mode, time_limit=time_limit, device=dev, **kwargs)

    if nproc == 1:
        return local_results

    # Host bytes: exchanged over gloo whatever backend the default group has.
    group = None if "gloo" in dist.get_backend() else dist.new_group(backend="gloo")
    blob = json.dumps([_result_to_json(n, r) for n, r in local_results.items()])
    blobs: List[str] = [None] * nproc
    dist.all_gather_object(blobs, blob, group=group)
    merged: Dict[str, PlanResult] = {}
    for other in blobs:
        merged.update(_results_from_json(other))
    return merged
