"""Frontier sharding: ONE puzzle's search spread over the ranks of a mesh.

Port of the JAX package's ``parallel/frontier_sharded.py``.  The
puzzle-sharded group solver (``parallel/sharded.py``) parallelizes over
independent puzzles; this module shards a SINGLE search in the
hash-distributed style (HDA*): the fingerprint space is partitioned by
``lo % n_shards`` and every state lives on exactly one owner rank —

  - each rank keeps its own ring frontier, visited set, novelty tables and
    history arena (disjoint ownership: dedup needs no global structure);
  - each iteration, every rank expands its best ``expand`` states,
    fingerprints the children and routes each to its owner with ONE
    ``all_to_all_single`` over one packed int32 buffer (per child: state,
    parent id, action, moved mask, valid flag).  A destination's bucket
    holds 4*expand rows, all the children, so routing can never drop one and
    an eviction-free exhaustion stays a complete no-solution proof;
  - the owner deduplicates, appends history, tests the goal, scores and
    appends with the single-puzzle planner's own steps
    (``ops.hashset.fingerprint_dedup_insert``, ``search.batched``);
  - history parent references are GLOBAL ids ``rank * capacity + index``,
    so plans are rebuilt by walking refs across the ranks' arenas;
  - the stop test before each iteration is ONE small ``all_reduce`` (MAX
    over a packed int32 vector) and one host read, so every rank takes the
    same branch.  The smallest solving global id wins; an iteration's goal
    candidate rides in the next test's vector.

Novelty tables are per rank, as in the JAX package: sharing across ranks can
change the search ORDER, never a plan's validity.  Iteration for iteration
the ranks take the JAX shards' steps and stop after the same iterations.
"""

import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pushworld_tpu_torch.core.compiled import CompiledPuzzle, compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.ops.hashset import (
    fingerprint,
    fingerprint_dedup_insert,
    init_hashset,
    split_key,
)
from pushworld_tpu_torch.ops.novelty import (
    _DEFAULT_PAIR_BITS,
    init_novelty,
    novelty_score_and_update,
)
from pushworld_tpu_torch.ops.rgd import RGDTables, build_rgd_tables, rgd_heuristic
from pushworld_tpu_torch.ops.step import expand_and_test, is_goal_state
from pushworld_tpu_torch.parallel.mesh import all_gather_flat, make_mesh, mesh_device
from pushworld_tpu_torch.search.batched import (
    EMPTY,
    SearchConfig,
    SearchState,
    _select_frontier,
    append_children,
    compact_frontier,
    init_search_state,
    required_depth,
)

NO_GOAL = 0x7FFFFFFF  # goal candidate of a rank that found none

# Epoch tag field of a virtual history id: bits 25.. hold (epoch + 1) of the
# referenced entry, 0 = "same epoch as the referencing array" (see the
# history-spill notes in solve_frontier_sharded).  Requires
# n_shards * history_capacity < 2**25 and at most 62 spill epochs.
_EPOCH_SHIFT = 25
_EPOCH_MASK = (1 << _EPOCH_SHIFT) - 1


class _Shard:
    """One rank's part of the search: the puzzle on the device, the tables,
    the configuration and the rank's place in the mesh."""

    def __init__(self, cp: CompiledPuzzle, tables: RGDTables, cfg: SearchConfig, mesh: DeviceMesh):
        self.cp, self.tables, self.cfg = cp, tables, cfg
        self.group = mesh.get_group()
        self.D = mesh.size()
        self.me = mesh.get_local_rank()
        self.dev = cp.init_state.device


def _shard_iterate(sh: _Shard, s: SearchState) -> torch.Tensor:
    """One distributed iteration of this rank, in place on ``s``.  Returns
    the rank's goal candidate: the smallest global history id of a goal
    state it found, or NO_GOAL."""
    cp, t, cfg, D, me = sh.cp, sh.tables, sh.cfg, sh.D, sh.me
    B, N = cfg.expand, cp.n
    Hcap = cfg.history_capacity
    C = 4 * B  # per-destination bucket: all the children, so none is dropped
    i32 = dict(dtype=torch.int32, device=sh.dev)

    # 1. local selection + expansion.
    parents, parent_hist, sel_valid = _select_frontier(s, B)
    actions = torch.arange(4, **i32).repeat_interleave(B)
    children, moved4, effective, _ = expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid)

    # 2. owner routing.  Parent refs become global BEFORE routing (they
    # index this rank's history).
    owner = (split_key(fingerprint(children, cp.width))[0] % D).to(torch.int32)
    parent_gid = me * Hcap + parent_hist.repeat(4)
    # Children sorted by owner (stable); destination d's run is
    # [offsets[d], offsets[d] + counts[d]).  Ineffective children sort last.
    sort_key = torch.where(effective, owner, D)
    order = torch.argsort(sort_key, stable=True)
    counts = (sort_key[None, :] == torch.arange(D, **i32)[:, None]).sum(1)
    offsets = torch.cumsum(counts, 0) - counts
    lane = torch.arange(C, device=sh.dev)
    in_run = lane[None, :] < counts[:, None]  # (D, C)
    src = order[(offsets[:, None] + lane[None, :]).clamp(0, 4 * B - 1)]
    # One int32 row per child: state (2N), parent gid, action, moved (N),
    # valid.  Rows outside a run carry the JAX fill values.
    rows = torch.cat([children.reshape(4 * B, 2 * N), parent_gid[:, None], actions[:, None],
                      moved4.to(torch.int32), torch.ones((4 * B, 1), **i32)], dim=1)
    fill = torch.zeros(3 * N + 3, **i32)
    fill[2 * N : 2 * N + 2] = -1
    snd = torch.where(in_run[..., None], rows[src], fill)  # (D, C, 3N+3)
    rcv = torch.empty_like(snd)
    dist.all_to_all_single(rcv, snd, group=sh.group)
    rcv = rcv.reshape(D * C, 3 * N + 3)
    rcv_states = rcv[:, : 2 * N].reshape(D * C, N, 2).contiguous()
    rcv_parent = rcv[:, 2 * N]
    rcv_action = rcv[:, 2 * N + 1]
    rcv_moved = rcv[:, 2 * N + 2 : 3 * N + 2].bool()
    rcv_valid = rcv[:, 3 * N + 2].bool().contiguous()

    # 3. owner-side dedup + scoring + ring compaction + append (history,
    # keys, window, counters) + goal.
    keys, is_new = fingerprint_dedup_insert(s.visited, rcv_states, cp.width, rcv_valid)
    nov, _ = novelty_score_and_update(s.novelty, rcv_states, rcv_moved, is_new)
    rgd = rgd_heuristic(t, rcv_states, max_depth=cfg.max_depth, valid=is_new)
    compact_frontier(s, D * C)
    hist_idx = append_children(s, cfg, None, is_new, rcv_parent, rcv_action, None, nov, rgd, None, sel_valid,
                               rcv_states, keys, margin=8 * B * D)
    goal = is_goal_state(cp, rcv_states) & is_new
    cand = torch.where(goal.any(), me * Hcap + hist_idx[goal.to(torch.int32).argmax()], NO_GOAL)
    return cand.to(torch.int32)


def _packed_status(sh: _Shard, s: SearchState, cand: Optional[torch.Tensor], vote: bool) -> List[int]:
    """[any solved, global min frontier key, max hist cursor, max evictions,
    any rank's vote] in ONE all_reduce and one host read.

    The pending goal candidate ``cand`` (of the iteration just run) is
    reduced here: the smallest id over the ranks becomes every rank's
    ``solved_hist``.  Evictions are the largest count of a rank, which is
    zero exactly when the sum is."""
    cand = torch.full((), NO_GOAL, dtype=torch.int32, device=sh.dev) if cand is None else cand
    vec = torch.stack([-cand, -s.frontier_h.min(), s.hist_cursor, s.evictions,
                       torch.tensor(int(vote), dtype=torch.int32, device=sh.dev)])
    dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=sh.group)
    neg_best, neg_hmin, cur_max, evictions, vote_any = vec.tolist()
    solved = -neg_best != NO_GOAL
    if solved:  # the search stops at its first solve, so this runs once
        s.solved.fill_(True)
        s.solved_hist.fill_(-neg_best)
    return [int(solved), -neg_hmin, cur_max, evictions, vote_any]


def _run_chunk(sh: _Shard, s: SearchState, chunk: int, vote) -> List[int]:
    """Up to ``chunk`` iterations, each behind the shared stop test (solved,
    global frontier empty, or some rank within one receive window of its
    history capacity: a saturated rank clamps its cursor and would rewrite
    its last window, under refs that children on other ranks hold).
    Returns the status after the chunk; ``vote()`` is this rank's say in the
    last entry (the caller's budget test)."""
    limit = sh.cfg.history_capacity - 8 * sh.cfg.expand * sh.D
    cand = None
    for i in range(chunk + 1):
        stat = _packed_status(sh, s, cand, vote())
        solved, hmin, cur_max = stat[:3]
        if i == chunk or solved or hmin >= EMPTY or cur_max >= limit:
            return stat
        cand = _shard_iterate(sh, s)
    raise AssertionError("unreachable")


def _init_shard_state(sh: _Shard, frontier_capacity: int, visited_bits: int) -> SearchState:
    """This rank's initial state: the root lives ONLY on its owner rank."""
    cp, cfg = sh.cp, sh.cfg
    s = init_search_state(cp, sh.tables, cfg, frontier_capacity, visited_bits,
                          _DEFAULT_PAIR_BITS, False)
    owner0 = int(split_key(fingerprint(cp.init_state[None], cp.width))[0]) % sh.D
    if sh.me != owner0:
        s.frontier_h[0] = EMPTY
        s.visited = init_hashset(visited_bits, device=sh.dev)
        s.novelty = init_novelty(cp.n, cp.height, cp.width, device=sh.dev)
    return s


def _gather(sh: _Shard, x: torch.Tensor) -> np.ndarray:
    """Every rank's ``x`` (same shape on all), stacked on a new leading axis."""
    out = torch.empty((sh.D * x.numel(),), dtype=x.dtype, device=sh.dev)
    all_gather_flat(out, x.to(sh.dev).reshape(-1), group=sh.group)
    return out.reshape((sh.D,) + tuple(x.shape)).cpu().numpy()


def solve_frontier_sharded(
    puzzle: Puzzle,
    mesh: Optional[DeviceMesh] = None,
    mode: str = "N+RGD",
    time_limit: Optional[float] = 60.0,
    max_depth: Optional[int] = None,
    expand: int = 64,
    frontier_capacity: int = 1 << 13,
    visited_bits: int = 18,
    history_capacity: int = 1 << 18,
    chunk: int = 16,
    stats_out: Optional[dict] = None,
) -> Optional[List[int]]:
    """Solves ONE puzzle with its frontier sharded over the ranks of ``mesh``
    (default: :func:`make_mesh` on the card).  Every rank of the mesh calls
    it with the same arguments and gets the same result.

    ``expand`` / ``frontier_capacity`` / ``visited_bits`` /
    ``history_capacity`` are PER RANK; the global expansion width is
    ``mesh.size() * expand``.  Returns the plan (validated against the
    oracle), ``None`` when the search exhausts without evictions (a complete
    no-solution proof: routing drops nothing), and raises TimeoutError when
    the budget runs out.

    ``stats_out`` (when given) receives spill_epochs, chunks,
    in_budget_wall_s (from after the first chunk) and, per rank,
    shard_iterations and shard_expansions.

    BUDGET DISCIPLINE: the clock starts after the first chunk, and a chunk
    is not started unless it can finish before the deadline (estimated by
    the previous chunk's duration).  Each rank votes on its own clock in the
    chunk's last status; one vote stops every rank.

    HISTORY SPILL: the history arena is append-only and its parent refs are
    only read on the host (plan reconstruction), so a full arena does not
    end the search: each rank copies its arrays to the host, tags its live
    frontier refs with their epoch (virtual id = (epoch + 1) << 25 |
    rank * capacity + index; an untagged ref means "same epoch as the array
    it was read from", and entries only reference ancestors, so epochs never
    increase along a walk), and resets its cursor.  The walk at the end
    follows the snapshot chain of every rank.
    """
    if mesh is None:
        mesh = make_mesh()
    D = mesh.size()
    if max_depth is None:
        max_depth = required_depth(puzzle)
    if frontier_capacity < 8 * expand * D:
        # A rank's append window holds the RECEIVED candidates: 4*expand
        # children from every one of the D ranks.
        raise ValueError(
            f"frontier_capacity ({frontier_capacity}) must be >= "
            f"8*expand*n_shards ({8 * expand * D}) per shard"
        )
    dev = mesh_device(mesh)
    cp = compile_puzzle(puzzle)
    tables = build_rgd_tables(puzzle, cp, max_depth=max_depth, device=dev)
    cfg = SearchConfig(expand=expand, history_capacity=history_capacity, max_depth=max_depth,
                       use_novelty=(mode == "N+RGD"))
    if puzzle.is_goal_state(puzzle.initial_state):
        return []
    if D * history_capacity >= (1 << _EPOCH_SHIFT):
        raise ValueError(
            f"n_shards * history_capacity ({D * history_capacity}) must fit "
            f"below 2**{_EPOCH_SHIFT} for epoch-tagged history spilling"
        )
    sh = _Shard(cp.to(dev), tables, cfg, mesh)
    s = _init_shard_state(sh, frontier_capacity, visited_bits)

    # Host-side spill chain of this rank: snapshots[e] = (hist_parent,
    # hist_action) of epoch e; the live arrays are epoch len(snapshots).
    snapshots: List[Tuple[np.ndarray, np.ndarray]] = []
    spill_margin = 8 * expand * D  # the stop test's history gate

    def spill() -> None:
        epoch = len(snapshots)
        if epoch >= (1 << (31 - _EPOCH_SHIFT)) - 2:
            raise TimeoutError("sharded history spill epochs exhausted")
        # A copy: on the CPU, .numpy() would share the live arrays' memory.
        snapshots.append((s.hist_parent.cpu().numpy().copy(), s.hist_action.cpu().numpy().copy()))
        # Tag every still-untagged frontier ref with the epoch just
        # snapshotted; tagged refs keep their older epochs.  The iteration
        # adds rank * capacity to a ref verbatim, so the tag flows into
        # history parent refs as the right virtual id.
        fh = s.frontier_hist
        s.frontier_hist = torch.where(fh < (1 << _EPOCH_SHIFT), fh | ((epoch + 1) << _EPOCH_SHIFT), fh)
        # Cursor back to 1 (slot 0 stays the root/stop sentinel).
        s.hist_cursor = torch.ones_like(s.hist_cursor)

    # The first chunk runs outside the budget; the clock starts when it
    # returns (the JAX package's compile-excluding discipline).
    stat = _run_chunk(sh, s, chunk, lambda: time_limit is not None and time_limit <= 0)
    t0 = time.monotonic()
    deadline = None if time_limit is None else t0 + time_limit
    chunks = 1

    def record_stats() -> None:
        if stats_out is not None:
            per_rank = _gather(sh, torch.stack([s.iterations, s.expansions]))
            stats_out.update(
                spill_epochs=len(snapshots), chunks=chunks,
                in_budget_wall_s=round(time.monotonic() - t0, 2),
                shard_iterations=per_rank[:, 0].tolist(), shard_expansions=per_rank[:, 1].tolist(),
            )

    try:
        while True:
            any_solved, hmin, cur_max, evictions, over = stat
            if any_solved:
                break
            if hmin >= EMPTY:
                record_stats()
                if evictions == 0:
                    return None
                raise TimeoutError("sharded frontier exhausted after evictions")
            if cur_max >= history_capacity - spill_margin:
                spill()
            # Start a chunk only if it can plausibly finish inside the budget
            # (the previous chunk's duration as the estimate).
            if over:
                raise TimeoutError("time budget exhausted")
            c0 = time.monotonic()

            def over_budget() -> bool:
                # Would a chunk as long as this one so far end past the deadline?
                now = time.monotonic()
                return deadline is not None and now + (now - c0) > deadline

            stat = _run_chunk(sh, s, chunk, over_budget)
            chunks += 1
    except TimeoutError:
        record_stats()
        raise
    record_stats()

    # Reconstruct across ranks and epochs by virtual history ids.  The solve
    # always lands in the CURRENT epoch (the loop breaks before any later
    # spill), so the walk starts at the live arrays.
    chain = [np.stack(p) for p in snapshots] + [
        torch.stack([s.hist_parent, s.hist_action]).cpu().numpy()
    ]
    every = _gather(sh, torch.as_tensor(np.stack(chain)))  # (D, epochs, 2, Hcap)
    gid = int(s.solved_hist)
    epoch_ctx = len(snapshots)
    plan: List[int] = []
    # Bounded walk: corrupted refs fail loudly, never hang.
    for _ in range(history_capacity * D * (len(snapshots) + 1)):
        tag = gid >> _EPOCH_SHIFT
        if tag:
            epoch_ctx = tag - 1
        d, idx = divmod(gid & _EPOCH_MASK, history_capacity)
        a = int(every[d, epoch_ctx, 1, idx])
        if a < 0:
            break
        plan.append(a)
        gid = int(every[d, epoch_ctx, 0, idx])
    else:
        raise RuntimeError(
            "sharded plan reconstruction exceeded history capacity (corrupted parent refs)"
        )
    plan.reverse()
    if not puzzle.is_valid_plan(plan):
        raise RuntimeError("sharded search produced an invalid plan")
    return plan
