"""Batched greedy best-first search on the device.

Port of the JAX package's ``search/batched.py``: the replacement for the
reference's serial best-first loop (reference:
cpp/include/search/best_first_search.h:45-98).  Every iteration

1. selects the ``expand`` lowest-key frontier states,
2. expands all 4 actions of each with the batched dynamics,
3. fingerprints and deduplicates children against the device visited set,
4. tests the goal,
5. scores new children with batched novelty (lexicographically stacked over
   RGD in the priority key — reference: run_planner.cc:48-55) + fewest-tools
   RGD,
6. appends them to a compacting ring frontier (with eviction).

Search *order* differs from the reference (lockstep novelty, batch
expansion); acceptance is valid plans within budget.  Plans are rebuilt from
a device-side history of (parent index, action) records.

The loop is a Python loop over iterations.  The host waits for the device
at the stop test of each iteration, at the boolean-mask writes (only new
lanes are written to the history and the novelty position table), and for
the ring cursor when the ring compacts.  State is updated in place where
that saves memory (the visited set, the novelty tables, the history and
frontier arrays).  Iteration for iteration it takes the JAX package's steps
and stops after the same iterations.
"""

import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle, compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.ops.hashset import (
    HashSet,
    fingerprint,
    fingerprint_dedup_insert,
    init_hashset,
    probe_and_insert,
    probe_delete,
)
from pushworld_tpu_torch.ops.novelty import (
    _DEFAULT_PAIR_BITS,
    NoveltyTables,
    init_novelty,
    novelty_score_and_update,
)
from pushworld_tpu_torch.ops.rgd import (
    RGDTables,
    build_rgd_tables,
    rgd_heuristic,
    rgd_heuristic_with_flags,
)
from pushworld_tpu_torch.ops.step import expand_children, is_goal_state

# Frontier priorities are int32 keys: novelty tier (2 bits) | clamped RGD
# value (13 bits) | inverted recency (15 bits).  The recency bits make
# expansion LIFO within equal (novelty, rgd) buckets — the depth-first
# plateau behavior of the reference's bucket priority queue
# (reference: priority_queue.h:43-222, LIFO within equal priority).
EMPTY = 0x7F000000  # int32 sentinel for a free frontier slot


class _EscalateDepth(Exception):
    """Internal: the search should restart at a deeper RGD pushing depth."""


def _priority(nov, rgd, hist_idx, use_novelty: bool) -> torch.Tensor:
    """int32 search key; smaller = expanded earlier."""
    nov_i = nov.to(torch.int32) if use_novelty else torch.ones_like(hist_idx)
    rgd_i = rgd.clamp(0.0, 8190.0).to(torch.int32)
    recency = torch.bitwise_not(hist_idx) & 0x7FFF
    return (nov_i << 28) | (rgd_i << 15) | recency


class SearchConfig(NamedTuple):
    """Search configuration.

    ``lazy``: deferred RGD — the heuristic is evaluated once per SELECTED
    parent (B evaluations) instead of once per generated child (4B), and
    children inherit the parent's RGD in their priority key."""

    expand: int = 256
    history_capacity: int = 1 << 20
    max_depth: int = 1
    use_novelty: bool = True
    lazy: bool = False


@dataclass
class SearchState:
    frontier_states: torch.Tensor  # (F, N, 2) int32
    frontier_h: torch.Tensor  # (F,) int32 priority keys (EMPTY = free slot)
    frontier_hist: torch.Tensor  # (F,) int32
    frontier_key: torch.Tensor  # (F,) int64 packed fingerprints (for eviction deletes)
    ring_cursor: int  # next append window offset (host-side)
    hist_parent: torch.Tensor  # (Hcap,) int32
    hist_action: torch.Tensor  # (Hcap,) int32
    hist_cursor: torch.Tensor  # int32 scalar
    visited: HashSet
    novelty: NoveltyTables
    solved: torch.Tensor  # bool scalar
    solved_hist: torch.Tensor  # int32 scalar
    iterations: torch.Tensor  # int32 scalar
    expansions: torch.Tensor  # int32 scalar
    evictions: torch.Tensor  # int32 scalar — states dropped by the capacity bound
    # Count of scored states whose RGD was INF at the search's depth although
    # the goal was graph-reachable (drives depth escalation).
    needs_deeper: torch.Tensor  # int32 scalar


def init_search_state(
    cp: CompiledPuzzle,
    t: RGDTables,
    cfg: SearchConfig,
    frontier_capacity: int,
    visited_bits: int,
    pair_bits: int,
    solved0: bool,
) -> SearchState:
    """The search state holding only the initial state (``cp`` on the device)."""
    dev = cp.init_state.device
    F, N = frontier_capacity, cp.n
    init = cp.init_state[None]  # (1, N, 2)
    i32 = dict(dtype=torch.int32, device=dev)

    novelty = init_novelty(N, cp.height, cp.width, pair_bits=pair_bits, device=dev)
    visited = init_hashset(visited_bits, device=dev)
    key = fingerprint(init, cp.width)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    _, visited = probe_and_insert(visited, key, one)
    moved = cp.obj_mask[None].clone()
    nov, novelty = novelty_score_and_update(novelty, init, moved, one)
    h = rgd_heuristic(t, init, max_depth=cfg.max_depth)
    prio = _priority(nov, h, torch.zeros((1,), **i32), cfg.use_novelty)

    frontier_states = torch.zeros((F, N, 2), **i32)
    frontier_states[0] = init[0]
    frontier_h = torch.full((F,), EMPTY, **i32)
    frontier_h[0] = prio[0]
    frontier_key = torch.zeros((F,), dtype=torch.int64, device=dev)
    frontier_key[0] = key[0]
    zero = torch.zeros((), **i32)
    return SearchState(
        frontier_states=frontier_states,
        frontier_h=frontier_h,
        frontier_hist=torch.zeros((F,), **i32),
        frontier_key=frontier_key,
        ring_cursor=1,  # slot 0 holds the initial state
        hist_parent=torch.full((cfg.history_capacity,), -1, **i32),
        hist_action=torch.full((cfg.history_capacity,), -1, **i32),
        hist_cursor=torch.ones((), **i32),
        visited=visited,
        novelty=novelty,
        solved=torch.tensor(bool(solved0), device=dev),
        solved_hist=zero.clone(),
        iterations=zero.clone(),
        expansions=zero.clone(),
        evictions=zero.clone(),
        needs_deeper=zero.clone(),
    )


def reconstruct_plan(s: SearchState) -> List[int]:
    """Backtracks the (parent index, action) history of a solved search into
    the action list (host-side; reads back the history arrays)."""
    parent = s.hist_parent.cpu().numpy()
    action = s.hist_action.cpu().numpy()
    idx = int(s.solved_hist)
    plan: List[int] = []
    while idx > 0:
        plan.append(int(action[idx]))
        idx = int(parent[idx])
    plan.reverse()
    return plan


def search_status(s: SearchState) -> np.ndarray:
    """The host-visible search status in one read.

    Layout: [solved, solved_hist, min_frontier_key, hist_cursor,
             expansions, evictions, iterations, needs_deeper].
    """
    return torch.stack([
        s.solved.to(torch.int32),
        s.solved_hist,
        s.frontier_h.min(),
        s.hist_cursor,
        s.expansions,
        s.evictions,
        s.iterations,
        s.needs_deeper,
    ]).cpu().numpy()


def _append_history(s: SearchState, cfg: SearchConfig, is_new, phist4, actions):
    """Appends the new children's (parent, action) records to the history
    (only the new lanes are written).  Returns hist_idx (0 for the others)."""
    offs = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    hist_idx = torch.where(is_new, s.hist_cursor + offs, 0).to(torch.int32)
    w = hist_idx[is_new].long()
    s.hist_parent[w] = phist4[is_new]
    s.hist_action[w] = actions[is_new]
    n_new = is_new.sum(dtype=torch.int32)
    s.hist_cursor = torch.clamp(s.hist_cursor + n_new, max=cfg.history_capacity - 8).to(torch.int32)
    return hist_idx


def _append_frontier(s: SearchState, h, children, hist_idx, keys) -> torch.Tensor:
    """Writes the 4B scored children into free space at the ring cursor.

    The frontier is a COMPACTING ring: the region at and beyond the cursor is
    always EMPTY (holes before it come only from selection), so an append is
    one contiguous slice.  When the next window would overflow the capacity,
    one stable sort gathers the valid entries to the front in key order and,
    only if the frontier is over the keep-bound, drops the WORST tail; dropped
    entries are deleted from the visited set so they can be re-generated
    later.  Returns the number of evicted states (int32 scalar)."""
    nb = h.shape[0]  # 4B
    F = s.frontier_h.shape[0]
    keep = F - max(nb, F // 4)
    n_evicted = torch.zeros((), dtype=torch.int32, device=h.device)
    if s.ring_cursor + nb > F:
        order = torch.argsort(s.frontier_h, stable=True)  # EMPTY slots sort last
        s.frontier_h = s.frontier_h[order]
        s.frontier_states = s.frontier_states[order]
        s.frontier_hist = s.frontier_hist[order]
        s.frontier_key = s.frontier_key[order]
        live = s.frontier_h < EMPTY
        drop = live & (torch.arange(F, device=h.device) >= keep)
        probe_delete(s.visited, s.frontier_key, drop)
        s.frontier_h = torch.where(drop, EMPTY, s.frontier_h).to(torch.int32)
        n_evicted = drop.sum(dtype=torch.int32)
        s.ring_cursor = min(int(live.sum()), keep)
    c = s.ring_cursor
    s.frontier_h[c : c + nb] = h
    s.frontier_states[c : c + nb] = children
    s.frontier_hist[c : c + nb] = hist_idx
    s.frontier_key[c : c + nb] = keys
    s.ring_cursor = c + nb
    return n_evicted


def _select_frontier(s: SearchState, B: int):
    """Picks the B lowest-key frontier entries, in ascending (key, slot)
    order as the JAX package's top-k returns them, and frees their slots.

    Returns (parents, parent_hist, sel_valid)."""
    _, idx = torch.sort(s.frontier_h, stable=True)
    idx = idx[:B]
    sel_h = s.frontier_h[idx]
    sel_valid = sel_h < EMPTY
    parents = s.frontier_states[idx]
    parent_hist = s.frontier_hist[idx]
    s.frontier_h[idx] = torch.where(sel_valid, EMPTY, sel_h).to(torch.int32)
    return parents, parent_hist, sel_valid


def _iterate(cp: CompiledPuzzle, t: RGDTables, cfg: SearchConfig, s: SearchState) -> SearchState:
    """One search iteration, in place on ``s``."""
    B = cfg.expand
    dev = s.frontier_h.device

    # 1. select the B best frontier entries (their slots are freed).
    parents, parent_hist, sel_valid = _select_frontier(s, B)

    # 2. expand all 4 actions (action-block order).
    actions = torch.arange(4, dtype=torch.int32, device=dev).repeat_interleave(B)
    par4 = parents.repeat(4, 1, 1)  # (4B, N, 2)
    phist4 = parent_hist.repeat(4)
    pvalid4 = sel_valid.repeat(4)
    children = expand_children(cp, t.contacts, t.contacts_mask, parents)
    moved = (children != par4).any(-1)  # (4B, N)
    effective = moved.any(-1) & pvalid4  # no-op moves are duplicates

    # 3. dedup against the batch and the visited set.
    keys, is_new = fingerprint_dedup_insert(s.visited, children.contiguous(), cp.width, effective)

    # 4. history append for new children.
    hist_idx = _append_history(s, cfg, is_new, phist4, actions)

    # 5. goal check (the first solved child wins).
    goal = is_goal_state(cp, children) & is_new
    any_goal = goal.any()
    first_goal = goal.to(torch.int32).argmax()
    s.solved_hist = torch.where(
        s.solved, s.solved_hist, torch.where(any_goal, hist_idx[first_goal], 0)
    ).to(torch.int32)
    s.solved = s.solved | any_goal

    # 6. score new children: novelty exact per child; RGD per child (eager)
    # or inherited from the selected parent (lazy).
    nov, _ = novelty_score_and_update(s.novelty, children, moved, is_new)
    if cfg.lazy:
        rgd_p, deeper_p = rgd_heuristic_with_flags(t, parents, max_depth=cfg.max_depth)
        rgd = rgd_p.repeat(4)
        deeper_flag = (deeper_p & sel_valid).repeat(4)
    else:
        rgd, deeper_flag = rgd_heuristic_with_flags(t, children, max_depth=cfg.max_depth)
    h = _priority(nov, rgd, hist_idx, cfg.use_novelty)
    h = torch.where(is_new, h, EMPTY).to(torch.int32)
    n_deeper = (deeper_flag & is_new).sum(dtype=torch.int32)

    # 7. append into the ring frontier (eviction when over capacity).
    n_evicted = _append_frontier(s, h, children, hist_idx, keys)
    s.iterations = s.iterations + 1
    s.expansions = s.expansions + sel_valid.sum(dtype=torch.int32)
    s.evictions = s.evictions + n_evicted
    s.needs_deeper = s.needs_deeper + n_deeper
    return s


def run_chunk(
    cp: CompiledPuzzle,
    tables: RGDTables,
    cfg: SearchConfig,
    s: SearchState,
    chunk: int = 32,
    deadline: Optional[float] = None,
) -> SearchState:
    """Runs up to ``chunk`` iterations, stopping early once the search is
    solved, the frontier is empty, or the history is nearly full (the JAX
    package's gated no-op iterations).  Updates ``s`` in place and returns it.

    ``deadline`` (a ``time.monotonic()`` value) also ends the chunk early, so
    a caller's budget is held to one iteration, not to one chunk; the caller
    still reads the clock itself to tell a budget end from a full chunk."""
    limit = cfg.history_capacity - 8 * cfg.expand
    for _ in range(chunk):
        if deadline is not None and time.monotonic() > deadline:
            break
        solved, min_h, cursor = torch.stack([
            s.solved.to(torch.int32), s.frontier_h.min(), s.hist_cursor
        ]).tolist()
        if solved or min_h >= EMPTY or cursor >= limit:
            break
        _iterate(cp, tables, cfg, s)
    return s


class BatchedPlanner:
    """Device planner for one puzzle.

    Args:
        puzzle: host puzzle (for table construction and plan validation).
        cp: compiled puzzle, numpy (built if omitted).
        tables: RGD tables on ``device`` (built if omitted).
        expand: states expanded per iteration.
        frontier_capacity: max frontier size (worst entries are dropped).
        visited_bits: log2 capacity of the visited hash set.
        history_capacity: max states retained for plan reconstruction.
        max_depth: RGD pushing-depth bound.
        use_novelty: lexicographic novelty stacking ("N+RGD" vs "RGD").
        pair_bits: novelty pair-table size (``PW_NOVELTY_PAIR_BITS``, 24).
        device: "cuda" (default) or "cpu".
    """

    # Depth escalation is capped (matches the required_depth cap).
    MAX_ESCALATED_DEPTH = 3

    def __init__(
        self,
        puzzle: Puzzle,
        cp: Optional[CompiledPuzzle] = None,
        tables: Optional[RGDTables] = None,
        expand: int = 256,
        frontier_capacity: int = 1 << 15,
        visited_bits: int = 20,
        history_capacity: int = 1 << 20,
        max_depth: int = 1,
        use_novelty: bool = True,
        lazy: bool = False,
        pair_bits: int = _DEFAULT_PAIR_BITS,
        device: DeviceLike = "cuda",
    ):
        if frontier_capacity < 8 * expand:
            # The compacting ring needs room for at least two append windows.
            raise ValueError(
                f"frontier_capacity ({frontier_capacity}) must be >= "
                f"8*expand ({8 * expand})"
            )
        self.device = resolve_device(device)
        self.puzzle = puzzle
        self.cp = (cp if cp is not None else compile_puzzle(puzzle)).numpy()
        self.cp_dev = self.cp.to(self.device)
        self.tables = (
            tables
            if tables is not None
            else build_rgd_tables(puzzle, self.cp, max_depth=max_depth, device=self.device)
        )
        self.expand = expand
        self.frontier_capacity = frontier_capacity
        self.visited_bits = visited_bits
        self.history_capacity = history_capacity
        self.max_depth = max_depth
        self.use_novelty = use_novelty
        self.lazy = lazy
        self.pair_bits = pair_bits
        self.last_state: Optional[SearchState] = None

    @property
    def config(self) -> SearchConfig:
        return SearchConfig(
            expand=self.expand,
            history_capacity=self.history_capacity,
            max_depth=self.max_depth,
            use_novelty=self.use_novelty,
            lazy=self.lazy,
        )

    def init_state(self) -> SearchState:
        return init_search_state(
            self.cp_dev,
            self.tables,
            self.config,
            self.frontier_capacity,
            self.visited_bits,
            self.pair_bits,
            bool(self.puzzle.is_goal_state(self.puzzle.initial_state)),
        )

    def solve(
        self,
        time_limit: Optional[float] = None,
        max_expansions: Optional[int] = None,
        chunk: int = 128,
        escalate_depth: bool = True,
    ) -> Optional[List[int]]:
        """Searches for a plan.  Returns the action list, None if the search
        space is exhausted (no solution), or raises TimeoutError on budget
        exhaustion.

        DEPTH ESCALATION: when the best frontier entry is INF-scored and
        states flagged as depth-limited exist, the search restarts one
        pushing depth deeper (reference counterpart: the unbounded
        ``fewest_tools`` iteration, recursive_graph_distance.cc:101-112).
        """
        deadline = None if time_limit is None else time.monotonic() + time_limit
        while True:
            try:
                return self._solve_at_depth(deadline, max_expansions, chunk, escalate_depth)
            except _EscalateDepth:
                self._escalate()

    def _escalate(self) -> None:
        """One pushing depth deeper (depth-0 tables only carry the agent's
        distance block, so they are rebuilt)."""
        new_depth = self.max_depth + 1
        if self.max_depth == 0:
            self.tables = build_rgd_tables(
                self.puzzle, self.cp, max_depth=new_depth, device=self.device
            )
        self.max_depth = new_depth

    def _solve_at_depth(
        self,
        deadline: Optional[float],
        max_expansions: Optional[int],
        chunk: int,
        escalate_depth: bool,
    ) -> Optional[List[int]]:
        """One full search at the current depth; the status of each chunk is
        read before the next one runs."""
        s = self.init_state()
        self.last_state = s
        if self.puzzle.is_goal_state(self.puzzle.initial_state):
            return []
        cfg = self.config
        while True:
            run_chunk(self.cp_dev, self.tables, cfg, s, chunk, deadline)
            solved, _, min_key, cursor, expansions, evictions, _, n_deeper = (
                int(v) for v in search_status(s)
            )
            if solved:
                return reconstruct_plan(s)
            if min_key >= EMPTY:
                # INF-scored states are ordered last but never pruned, so an
                # eviction-free exhaustion is a complete search: no solution.
                if evictions == 0:
                    return None
                raise TimeoutError("frontier exhausted after evictions")
            if (
                escalate_depth
                and n_deeper > 0
                and self.max_depth < self.MAX_ESCALATED_DEPTH
                and ((min_key >> 15) & 0x1FFF) >= 8190
            ):
                raise _EscalateDepth
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("time budget exhausted")
            if max_expansions is not None and expansions >= max_expansions:
                raise TimeoutError("expansion budget exhausted")
            if cursor >= self.history_capacity - 8 * self.expand:
                raise TimeoutError("history capacity exhausted")


def solve_batched(
    puzzle: Puzzle,
    mode: str = "N+RGD",
    time_limit: Optional[float] = None,
    max_depth: Optional[int] = None,
    device: DeviceLike = "cuda",
    **kwargs,
) -> Optional[List[int]]:
    """One-call batched solve.  ``max_depth`` defaults to the fewest-tools
    depth needed at the initial state (computed with the host oracle)."""
    if max_depth is None:
        max_depth = required_depth(puzzle)
    planner = BatchedPlanner(
        puzzle, max_depth=max_depth, use_novelty=(mode == "N+RGD"), device=device, **kwargs
    )
    return planner.solve(time_limit=time_limit)


def required_depth(puzzle: Puzzle, cap: int = 3) -> int:
    """Fewest-tools pushing depth needed at the initial state (host oracle),
    capped at ``cap``."""
    from pushworld_tpu_torch.search.heuristics_host import RecursiveGraphDistance

    rgd = RecursiveGraphDistance(puzzle)
    state = puzzle.initial_state
    worst = 0
    for k in range(puzzle.num_goals):
        for depth in range(cap + 1):
            c = rgd._goal_cost(state, k + 1, puzzle.goal_state[k], depth)
            if c != float("inf"):
                worst = max(worst, depth)
                break
        else:
            return cap
    return worst
