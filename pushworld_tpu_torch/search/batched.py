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

On the card an iteration is eight launches of hand kernels
(``kernels/frontier.cu``'s select, ``kernels/expand.cu``, the visited set's
fused fingerprint + dedup + insert, the novelty score and update, the RGD
heuristic, ``frontier.cu``'s compaction, which deletes its drops from the
visited set, and ``frontier.cu``'s append); the novelty kernels, RGD and the
compaction need only what the dedup has finished, so they run as three
branches side by side (two on side streams, joined before the append).  On
the CPU each wrapper runs its plain version, the JAX package's code
(``*_reference``), one after another.

An iteration reads nothing back to the host: as in the JAX package's
jitted body, it is gated on the device.  The gate (not solved, a live
frontier entry, history below its limit) is computed by the selection and
read by every later kernel, so an inactive iteration expands, inserts and
scores nothing and leaves the state exactly as it was; every write is at
device-computed positions, and the ring's compaction is decided on the
device.  Every field
of :class:`SearchState` is allocated once by :func:`init_search_state` and
updated in place from then on, so a CUDA graph captured once can loop over
fixed addresses on the card (``search/chunk_graph.py``).  :func:`run_chunk`
on the card enqueues that loop and returns without a host read, like the
JAX package's asynchronous ``run_chunk``; the callers read the status of
chunk k while chunk k+1 runs (:class:`PendingStatus`).  Iteration for
iteration it takes the JAX package's steps and stops after the same
iterations.
"""

import contextlib
import functools
import threading
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle, compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.kernels import _build, count_launch, launch_on
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
from pushworld_tpu_torch.ops.step import expand_and_test

# Frontier priorities are int32 keys: novelty tier (2 bits) | clamped RGD
# value (13 bits) | inverted recency (15 bits).  The recency bits make
# expansion LIFO within equal (novelty, rgd) buckets — the depth-first
# plateau behavior of the reference's bucket priority queue
# (reference: priority_queue.h:43-222, LIFO within equal priority).
EMPTY = 0x7F000000  # int32 sentinel for a free frontier slot
# Iterations of a chunk where the caller leaves it open: the JAX package's
# (its BatchedPlanner.solve and planner.CHUNK), one status read each.
CHUNK = 128


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
    ring_cursor: torch.Tensor  # int32 scalar: next append window offset
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
    # The device-side loop of this search's chunks (search/chunk_graph.py),
    # captured at the first run_chunk on the card and released with the state.
    graph: Optional[object] = None


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
        ring_cursor=torch.ones((), **i32),  # slot 0 holds the initial state
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


def search_status_tensor(s: SearchState) -> torch.Tensor:
    """The host-visible search status as one (8,) int32 tensor on the
    search's device.

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
    ])


def search_status(s: SearchState) -> np.ndarray:
    """:func:`search_status_tensor` in one read."""
    return search_status_tensor(s).cpu().numpy()


# ------------------------------------------------------------------ frontier
#
# The frontier's bookkeeping is three hand kernels on the card
# (kernels/frontier.cu: select, compact, append) and their plain versions on
# the CPU, the JAX package's code: select_frontier_reference (with _active,
# the gate), compact_frontier_reference and append_frontier_reference (the
# two halves of JAX's _append_frontier), append_history_reference and
# append_children_reference.


def select_frontier_reference(s: SearchState, B: int, active=None):
    """Plain version of the selection: the B lowest-key frontier entries, in
    ascending (key, slot) order as the JAX package's top-k returns them,
    their slots freed.  ``active`` (a bool scalar, or None for always)
    masks the selection.

    Returns (parents, parent_hist, sel_valid)."""
    _, idx = torch.sort(s.frontier_h, stable=True)
    idx = idx[:B]
    sel_h = s.frontier_h[idx]
    sel_valid = sel_h < EMPTY
    if active is not None:
        sel_valid = sel_valid & active
    parents = s.frontier_states[idx]
    parent_hist = s.frontier_hist[idx]
    s.frontier_h.index_copy_(0, idx, torch.where(sel_valid, EMPTY, sel_h).to(torch.int32))
    return parents, parent_hist, sel_valid


def _active(cfg: SearchConfig, s: SearchState) -> torch.Tensor:
    """The JAX package's gate of an iteration (bool scalar on the device):
    not solved, a live frontier entry, and history below its limit."""
    return (
        ~s.solved
        & (s.frontier_h.min() < EMPTY)
        & (s.hist_cursor < cfg.history_capacity - 8 * cfg.expand)
    )


def _select_frontier(s: SearchState, B: int):
    """The B lowest-key frontier entries in (key, slot) order, their slots
    freed, with no gate (the frontier-sharded search's selection).  Returns
    (parents, parent_hist, sel_valid).

    On a CUDA tensor one launch of ``frontier.cu``'s select kernel; on a CPU
    tensor :func:`select_frontier_reference`."""
    if not s.frontier_h.is_cuda:
        return select_frontier_reference(s, B)
    return _select_cuda(s, B, None)[:3]


def select_and_gate(cfg: SearchConfig, s: SearchState):
    """The gate of an iteration (:func:`_active`, read before the selection)
    and the ``cfg.expand`` lowest-key entries, masked by it.  Returns
    (parents, parent_hist, sel_valid, gate), ``gate`` a bool scalar on the
    device.

    On a CUDA tensor one launch of ``frontier.cu``'s select kernel: with the
    gate closed it writes ``sel_valid`` False and the gate, and leaves
    ``parents`` and ``parent_hist`` unwritten.  On a CPU tensor
    :func:`_active` and :func:`select_frontier_reference`."""
    if not s.frontier_h.is_cuda:
        gate = _active(cfg, s)
        return (*select_frontier_reference(s, cfg.expand, gate), gate)
    return _select_cuda(s, cfg.expand, cfg.history_capacity - 8 * cfg.expand)


def append_history_reference(s: SearchState, cfg: SearchConfig, is_new, phist4, actions, margin: int = 8):
    """Appends the new children's (parent, action) records to the history,
    in place; the cursor stops ``margin`` entries short of the capacity.
    Returns hist_idx (0 for the other lanes).

    As in the JAX package, every lane writes: the others write the last
    entry's own value back to it, so no boolean index is needed."""
    offs = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    hist_idx = torch.where(is_new, s.hist_cursor + offs, 0).to(torch.int32)
    write_idx = torch.where(is_new, hist_idx, cfg.history_capacity - 1).long()
    s.hist_parent.index_copy_(0, write_idx, torch.where(is_new, phist4, s.hist_parent[write_idx]))
    s.hist_action.index_copy_(0, write_idx, torch.where(is_new, actions, s.hist_action[write_idx]))
    n_new = is_new.sum(dtype=torch.int32)
    s.hist_cursor.copy_(torch.clamp(s.hist_cursor + n_new, max=cfg.history_capacity - margin))
    return hist_idx


_FRONTIER_FIELDS = ("frontier_h", "frontier_states", "frontier_hist", "frontier_key")


def compact_frontier_reference(s: SearchState, nb: int, active=None) -> None:
    """Plain version of the compaction, in place: when the next window of
    ``nb`` would overflow the capacity (``need``, and ``active``: a bool
    scalar or None for always), one stable sort gathers the valid entries to
    the front in key order and, only if the frontier is over the keep-bound,
    drops the WORST tail; dropped entries are deleted from the visited set
    so they can be re-generated later, and counted in ``s.evictions``.

    The frontier is a COMPACTING ring: the region at and beyond the cursor is
    always EMPTY (holes before it come only from selection), so an append is
    one contiguous window.  The branch is taken on the host, as the JAX
    package's ``lax.cond`` takes it: the sort runs only when it is needed."""
    F = s.frontier_h.shape[0]
    keep = F - max(nb, F // 4)
    need = s.ring_cursor + nb > F
    if active is not None:
        need = need & active
    if not bool(need):
        return
    order = torch.argsort(s.frontier_h, stable=True)  # EMPTY sorts last
    for name in _FRONTIER_FIELDS:
        buf = getattr(s, name)
        buf.copy_(buf[order])
    live = s.frontier_h < EMPTY
    drop = live & (torch.arange(F, device=s.frontier_h.device) >= keep)
    probe_delete(s.visited, s.frontier_key, drop)
    s.frontier_h.masked_fill_(drop, EMPTY)
    s.evictions.add_(drop.sum(dtype=torch.int32))
    s.ring_cursor.copy_(torch.clamp(live.sum(dtype=torch.int32), max=keep))


def append_frontier_reference(s: SearchState, h, children, hist_idx, keys, active=None) -> None:
    """Plain version of the window write: the nb scored children go into the
    free space at the ring cursor, in place (after
    :func:`compact_frontier_reference`, the window always fits).

    ``active`` (a bool scalar, or None for always) gates the iteration: an
    inactive append does not move the cursor and writes each window slot's
    own contents back."""
    nb = h.shape[0]
    F = s.frontier_h.shape[0]
    pos = s.ring_cursor + torch.arange(nb, device=h.device)
    new = (h, children, hist_idx, keys)
    if active is not None:
        # An active window always fits (the cursor is at most F - nb after a
        # compaction); an inactive one may not, and writes slots back.
        pos = pos % F
        new = tuple(
            torch.where(active.reshape((1,) * v.dim()), v, getattr(s, name)[pos])
            for name, v in zip(_FRONTIER_FIELDS, new)
        )
        nb = nb * active.to(torch.int32)
    for name, v in zip(_FRONTIER_FIELDS, new):
        getattr(s, name).index_copy_(0, pos, v)
    s.ring_cursor.add_(nb)


def compact_frontier(s: SearchState, nb: int, gate=None) -> None:
    """Compacts the ring before a window of ``nb`` children when it would
    overflow (see :func:`compact_frontier_reference`), in place.  ``gate``
    (a bool scalar on the device, or None for open) closes it.

    On a CUDA tensor one launch of ``frontier.cu``'s compact kernel, which
    reads ``need`` on the device and returns at once without it, and deletes
    the dropped entries from the visited set itself (``visited_probe.cuh``'s
    delete, the probe of ``visited_set.cu``'s kernels); on a CPU tensor
    :func:`compact_frontier_reference`, which calls :func:`probe_delete`."""
    if not s.frontier_h.is_cuda:
        return compact_frontier_reference(s, nb, gate)
    _compact_cuda(s, nb, gate)


def append_children_reference(s: SearchState, cfg: SearchConfig, gate, is_new, parent_hist, actions, goal, nov,
                              rgd, deeper, sel_valid, children, keys, margin: int = 8, loop=None) -> torch.Tensor:
    """Plain version of :func:`append_children`: the JAX package's history
    append, goal resolution, priority keys, window write and counters, then
    the loop's tail where ``loop`` is given (``chunk_graph.chunk_continue``)."""
    nb, dev = is_new.shape[0], is_new.device
    phist = parent_hist.repeat(nb // parent_hist.shape[0])
    if actions is None:
        actions = torch.arange(nb, dtype=torch.int32, device=dev) // cfg.expand
    hist_idx = append_history_reference(s, cfg, is_new, phist, actions, margin)
    if goal is not None:
        # The first solved child wins.
        goal = goal & is_new
        any_goal = goal.any()
        first_goal = goal.to(torch.int32).argmax().reshape(1)  # a 1-d index: no host read
        s.solved_hist.copy_(
            torch.where(s.solved, s.solved_hist, torch.where(any_goal, hist_idx[first_goal][0], 0))
        )
        s.solved.logical_or_(any_goal)
    h = _priority(nov, rgd.repeat(nb // rgd.shape[0]), hist_idx, cfg.use_novelty)
    h = torch.where(is_new, h, EMPTY).to(torch.int32)
    append_frontier_reference(s, h, children, hist_idx, keys, gate)
    s.iterations.add_(1 if gate is None else gate.to(torch.int32))
    s.expansions.add_(sel_valid.sum(dtype=torch.int32))
    if deeper is not None:
        s.needs_deeper.add_((deeper.repeat(nb // deeper.shape[0]) & is_new).sum(dtype=torch.int32))
    if loop is not None:
        from pushworld_tpu_torch.search.chunk_graph import chunk_continue

        opened = torch.ones((), dtype=torch.bool, device=dev) if gate is None else gate
        chunk_continue(opened, s.solved, s.hist_cursor, loop.remaining, loop.limit, loop.flag, loop.bodies)
    return hist_idx


def append_children(s: SearchState, cfg: SearchConfig, gate, is_new, parent_hist, actions, goal, nov, rgd,
                    deeper, sel_valid, children, keys, margin: int = 8, loop=None) -> torch.Tensor:
    """Appends an iteration's nb scored children, in place: history records
    for the new ones (the cursor stops ``margin`` short of the capacity),
    the first goal among them in lane order, their priority keys (EMPTY for
    the others) into the window at the ring cursor, and the counters
    (iterations, expansions from ``sel_valid``, needs_deeper).  Returns the
    history indices (0 for lanes that are not new).

    Lanes are in action-block order.  ``parent_hist`` has nb entries, or B
    (``cfg.expand``), read at lane % B; ``actions`` None means lane // B;
    ``rgd`` and ``deeper`` have nb entries or B (the lazy mode's per-parent
    values).  ``goal`` None: no goal resolution (the sharded search resolves
    its goals across ranks); ``deeper`` None: needs_deeper is not counted.
    ``gate`` (a bool scalar, or None for open) closes the append.

    ``loop`` (a ``search.chunk_graph.LoopTail``, or None) is a device-side
    loop's scalars: after the append (or with the gate closed, in its
    place) its tail decides whether the loop runs another body, from the
    state the append leaves, and counts the body
    (``chunk_graph.chunk_continue_reference``); with the loop's handle it
    also sets the loop's condition.

    On a CUDA tensor one launch of ``frontier.cu``'s append kernel, the tail
    in it; on a CPU tensor :func:`append_children_reference`.  The two are
    bit-equal."""
    if not s.frontier_h.is_cuda:
        return append_children_reference(s, cfg, gate, is_new, parent_hist, actions, goal, nov, rgd, deeper,
                                         sel_valid, children, keys, margin, loop)
    return _append_cuda(s, cfg, gate, is_new, parent_hist, actions, goal, nov, rgd, deeper, sel_valid, children,
                        keys, margin, loop)


def _check(name: str, x, dtype, shape, dev) -> None:
    if x is not None and (x.dtype != dtype or x.shape != shape or x.device != dev or not x.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} {tuple(shape)} tensor on {dev}")


def _check_state(s: SearchState) -> None:
    F, N = s.frontier_states.shape[:2]
    dev = s.frontier_h.device
    for name, dtype, shape in (("frontier_h", torch.int32, (F,)), ("frontier_states", torch.int32, (F, N, 2)),
                               ("frontier_hist", torch.int32, (F,)), ("frontier_key", torch.int64, (F,))):
        _check(name, getattr(s, name), dtype, shape, dev)


def _launch(fn_name: str, count_name: str, dev: torch.device, *args) -> None:
    """``fn_name(*args, stream)`` of ``kernels/frontier.cu`` on the current
    stream (tensors pass as their data pointers, None as a null pointer);
    raises if the launch is refused.  No host read: a CUDA graph may
    capture it."""
    fn = getattr(_build.load("frontier"), fn_name)
    rc = launch_on(dev, fn, *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args])
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")
    count_launch(count_name)


def _select_cuda(s: SearchState, B: int, hist_limit: Optional[int]):
    _check_state(s)
    F, N = s.frontier_states.shape[:2]
    dev = s.frontier_h.device
    if not 0 < B <= F:
        raise ValueError(f"cannot select {B} of {F} frontier slots")
    gated = hist_limit is not None
    if gated:
        _check("solved", s.solved, torch.bool, (), dev)
        _check("hist_cursor", s.hist_cursor, torch.int32, (), dev)
    parents = torch.empty((B, N, 2), dtype=torch.int32, device=dev)
    parent_hist = torch.empty((B,), dtype=torch.int32, device=dev)
    sel_valid = torch.empty((B,), dtype=torch.bool, device=dev)
    gate = torch.empty((), dtype=torch.bool, device=dev)
    # The tiles' candidates, where shared memory cannot hold them.
    words = _select_scratch_words(F, B)
    if words < 0:
        raise ValueError(f"the select kernel does not take B = {B} of F = {F} slots")
    scratch = torch.empty((words,), dtype=torch.int64, device=dev) if words else None
    _launch("pw_frontier_select", "frontier.select", dev, s.frontier_h, s.frontier_states, s.frontier_hist,
            s.solved if gated else None, s.hist_cursor if gated else None, hist_limit if gated else 0,
            parents, parent_hist, sel_valid, gate, scratch, F, B, N)
    return parents, parent_hist, sel_valid, gate


@functools.lru_cache(maxsize=None)
def _select_scratch_words(F: int, B: int) -> int:
    return _build.load("frontier").pw_frontier_select_scratch_words(F, B)


def _compact_cuda(s: SearchState, nb: int, gate) -> None:
    _check_state(s)
    F, N = s.frontier_states.shape[:2]
    dev = s.frontier_h.device
    for name, x in (("ring_cursor", s.ring_cursor), ("evictions", s.evictions)):
        _check(name, x, torch.int32, (), dev)
    _check("gate", gate, torch.bool, (), dev)
    table = s.visited.keys
    if (table.dtype != torch.int64 or table.device != dev or not table.is_contiguous()
            or table.numel() != 1 << s.visited.capacity_bits or s.visited.capacity_bits > 31):
        raise ValueError(f"visited: expected a contiguous int64 table of 2**capacity_bits slots on {dev}")
    # One allocation: the kernel's scratch (state copies at the start, 16-byte
    # aligned; the sort's words, fingerprint and hist copies).
    buf = torch.empty((F * (8 * N + 16 + 8 + 4),), dtype=torch.bool, device=dev)
    states_copy = buf.data_ptr()
    sort = states_copy + 8 * N * F
    key_copy = sort + 16 * F
    hist_copy = key_copy + 8 * F
    _launch("pw_frontier_compact", "frontier.compact", dev, s.frontier_h, s.frontier_states, s.frontier_hist,
            s.frontier_key, s.ring_cursor, s.evictions, table, (1 << s.visited.capacity_bits) - 1, gate,
            sort, states_copy, hist_copy, key_copy, F, N, nb, F - max(nb, F // 4))


def _append_cuda(s: SearchState, cfg: SearchConfig, gate, is_new, parent_hist, actions, goal, nov, rgd, deeper,
                 sel_valid, children, keys, margin: int, loop) -> torch.Tensor:
    _check_state(s)
    F, N = s.frontier_states.shape[:2]
    nb, dev = is_new.shape[0], s.frontier_h.device
    parent_hist, actions, rgd, children = (
        None if x is None else x.contiguous() for x in (parent_hist, actions, rgd, children))
    for name, x, dtype, shape in (
        ("gate", gate, torch.bool, ()), ("is_new", is_new, torch.bool, (nb,)),
        ("parent_hist", parent_hist, torch.int32, parent_hist.shape[:1]), ("actions", actions, torch.int32, (nb,)),
        ("goal", goal, torch.bool, (nb,)), ("nov", nov, torch.float32, (nb,)),
        ("rgd", rgd, torch.float32, rgd.shape[:1]), ("deeper", deeper, torch.bool, rgd.shape[:1]),
        ("sel_valid", sel_valid, torch.bool, sel_valid.shape[:1]), ("children", children, torch.int32, (nb, N, 2)),
        ("keys", keys, torch.int64, (nb,)), ("hist_parent", s.hist_parent, torch.int32, (cfg.history_capacity,)),
        ("hist_action", s.hist_action, torch.int32, (cfg.history_capacity,)), ("solved", s.solved, torch.bool, ()),
        ("loop.scalars", None if loop is None else loop.scalars, torch.int64, (2,)),
    ):
        _check(name, x, dtype, shape, dev)
    for name in ("ring_cursor", "hist_cursor", "solved_hist", "iterations", "expansions", "needs_deeper"):
        _check(name, getattr(s, name), torch.int32, (), dev)
    if parent_hist.dim() != 1 or rgd.dim() != 1 or nb % parent_hist.shape[0] or nb % rgd.shape[0]:
        raise ValueError("parent_hist and rgd must be 1-D with a length dividing the lane count")
    hist_idx = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return hist_idx
    if children.data_ptr() % 8:  # the kernel copies a row as 8- or 16-byte vectors
        children = children.clone()
    _launch("pw_frontier_append", "frontier.append", dev, gate, is_new, parent_hist, actions, goal, nov, rgd,
            deeper, sel_valid, children, keys, s.frontier_h, s.frontier_states, s.frontier_hist, s.frontier_key,
            s.ring_cursor, s.hist_parent, s.hist_action, s.hist_cursor, s.solved, s.solved_hist, s.iterations,
            s.expansions, s.needs_deeper, hist_idx, nb, cfg.expand, N, F, cfg.history_capacity, margin,
            int(cfg.use_novelty), parent_hist.shape[0], rgd.shape[0], sel_valid.shape[0],
            None if loop is None else loop.scalars, 0 if loop is None else loop.handle,
            0 if loop is None else loop.limit)
    return hist_idx


# Each thread's three side streams a device: the capture stream of a
# search's loop (search/chunk_graph.py) and the two branches of an
# iteration.  Made once, together, so that they are three distinct streams
# of PyTorch's pool; a thread's own, so that a capture on one thread never
# takes in another thread's launches.
_THREAD_STREAMS = threading.local()


def thread_streams(dev: torch.device):
    """This thread's (capture, branch, branch) streams on CUDA device ``dev``."""
    by_device = getattr(_THREAD_STREAMS, "by_device", None)
    if by_device is None:
        by_device = _THREAD_STREAMS.by_device = {}
    streams = by_device.get(dev.index)
    if streams is None:
        streams = by_device[dev.index] = tuple(torch.cuda.Stream(dev) for _ in range(3))
    return streams


@contextlib.contextmanager
def _branches(dev: torch.device):
    """Two branches beside the current stream's work: yields two contexts,
    in which launches go to this thread's branch streams, each waiting
    first for what the current stream has enqueued; at exit the current
    stream waits for both.  (PyTorch's capture records the waits as edges
    of the graph.)  On the CPU the contexts do nothing.

    Tensors made on the current stream and read on a branch need no more:
    the current stream's next work waits for the branches, so their memory
    is handed out again only after the branches read it.  A tensor made on
    a branch and read after the join is marked with ``record_stream``."""
    if dev.type != "cuda":
        yield contextlib.nullcontext(), contextlib.nullcontext()
        return
    main = torch.cuda.current_stream(dev)
    sides = thread_streams(dev)[1:]
    for side in sides:
        side.wait_stream(main)
    try:
        yield tuple(torch.cuda.stream(side) for side in sides)
    finally:
        for side in sides:
            main.wait_stream(side)


def _iterate(cp: CompiledPuzzle, t: RGDTables, cfg: SearchConfig, s: SearchState, loop=None) -> torch.Tensor:
    """One gated search iteration, in place on ``s``; reads nothing back to
    the host.  When the gate is closed it is an exact no-op.  Returns the
    gate (a bool scalar on the device).  ``loop``: a device-side loop's
    scalars, for the append's tail (see :func:`append_children`).

    On the card it is eight hand-kernel launches, each of which reads the
    gate (or a mask it closed) on the device: select, expand, fingerprint +
    dedup + insert, then three branches side by side (the novelty score and
    update, two launches; the RGD heuristic; the ring's compaction, which
    tombstones the fingerprints it drops in the visited set itself, after
    the dedup's inserts), and, once all three are done, the append."""
    # 1. the gate, and the B best frontier entries (their slots are freed).
    parents, parent_hist, sel_valid, gate = select_and_gate(cfg, s)

    # 2. expand all 4 actions (action-block order); moved masks, effective
    # children (no-op moves are duplicates) and the goal test.
    children, moved, effective, goal = expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)

    # 3. dedup against the batch and the visited set.
    keys, is_new = fingerprint_dedup_insert(s.visited, children, cp.width, effective, gate)

    # 4. score new children: novelty exact per child; RGD per child (eager)
    # or inherited from the selected parent (lazy); and compact the ring if
    # the window would overflow (eviction when over capacity).  The three
    # touch disjoint tensors.
    with _branches(s.frontier_h.device) as (rgd_branch, compact_branch):
        nov, _ = novelty_score_and_update(s.novelty, children, moved, is_new)
        with rgd_branch:
            if cfg.lazy:
                rgd, deeper = rgd_heuristic_with_flags(t, parents, max_depth=cfg.max_depth, valid=sel_valid)
            else:
                rgd, deeper = rgd_heuristic_with_flags(t, children, max_depth=cfg.max_depth, valid=is_new)
        with compact_branch:
            compact_frontier(s, children.shape[0], gate)
    if rgd.is_cuda:  # made on a branch, read by the append here
        for x in (rgd, deeper):
            x.record_stream(torch.cuda.current_stream(rgd.device))

    # 5. append: history, goal, keys, window and counters (and the loop's
    # tail).
    append_children(s, cfg, gate, is_new, parent_hist, None, goal, nov, rgd, deeper, sel_valid, children, keys,
                    loop=loop)
    return gate


def run_chunk(
    cp: CompiledPuzzle,
    tables: RGDTables,
    cfg: SearchConfig,
    s: SearchState,
    chunk: int = 32,
    deadline: Optional[float] = None,
) -> SearchState:
    """Runs ``chunk`` gated iterations on ``s`` in place and returns it:
    once the search is solved, the frontier is empty or the history is
    nearly full, the rest are no-ops (the JAX package's contract).

    On the card the iterations run in a device-side loop
    (``search/chunk_graph.py``; captured at the first call for this state,
    tables and configuration) that stops on the card where the rest would
    be no-ops, after at most one closed iteration: ``ceil(chunk / 128)``
    graph launches of at most 128 iterations each.  With ``deadline=None``
    the launches are enqueued and the call returns without reading anything
    back; with a deadline (a ``time.monotonic()`` value) the host clock is
    read before each launch and at most two launches are left unconfirmed,
    so a budget is held to two chunks of 128, as in the JAX package.  A
    failed capture or launch raises.

    On the CPU the loop reads the gate between iterations and stops early
    (a masked iteration costs a full one there), and ``deadline`` is tested
    before each iteration; the caller still reads the clock itself to tell a
    budget end from a full chunk."""
    if s.frontier_h.is_cuda:
        from pushworld_tpu_torch.search.chunk_graph import run_graphed

        return run_graphed(cp, tables, cfg, s, chunk, deadline)
    for _ in range(chunk):
        if deadline is not None and time.monotonic() > deadline:
            break
        if not bool(_active(cfg, s)):
            break
        _iterate(cp, tables, cfg, s)
    return s


def chunk_length(chunk: Optional[int], cfg: SearchConfig, device: torch.device) -> int:
    """Iterations of a chunk (one status read each): ``chunk`` where the
    caller gives one, else :data:`CHUNK`, the JAX package's, at every RGD
    depth on both devices (on the card a chunk after the search's end costs
    one closed iteration, so it need not be short)."""
    return CHUNK if chunk is None else chunk


class PendingStatus:
    """:func:`search_status_tensor` of a state as it stands after the work
    enqueued so far, copied to the host without a wait.

    On the card the (8,) int32 status goes into pinned host memory with
    ``non_blocking=True`` behind an event: :meth:`ready` asks the event,
    :meth:`read` waits for it.  On the CPU the status is taken at once."""

    def __init__(self, s: SearchState):
        status = search_status_tensor(s)
        self._event = None
        if status.is_cuda:
            self._host = torch.empty(status.shape, dtype=status.dtype, pin_memory=True)
            self._host.copy_(status, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = status

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def read(self) -> List[int]:
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


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
        chunk: Optional[int] = None,
        escalate_depth: bool = True,
    ) -> Optional[List[int]]:
        """Searches for a plan.  Returns the action list, None if the search
        space is exhausted (no solution), or raises TimeoutError on budget
        exhaustion.  ``chunk``: iterations between status reads
        (:func:`chunk_length` when None).

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
        chunk: Optional[int],
        escalate_depth: bool,
    ) -> Optional[List[int]]:
        """One full search at the current depth.

        The chunk loop is PIPELINED as in the JAX package: chunk k+1 is
        enqueued before chunk k's status is read, so on the card the read
        overlaps the device's work.  The plan is rebuilt from the newest
        state (a chunk after a solve is a no-op)."""
        s = self.init_state()
        self.last_state = s
        if self.puzzle.is_goal_state(self.puzzle.initial_state):
            return []
        cfg = self.config
        chunk = chunk_length(chunk, cfg, self.device)
        run_chunk(self.cp_dev, self.tables, cfg, s, chunk, deadline)
        pending = PendingStatus(s)
        while True:
            run_chunk(self.cp_dev, self.tables, cfg, s, chunk, deadline)
            pending, stat = PendingStatus(s), pending.read()
            solved, _, min_key, cursor, expansions, evictions, _, n_deeper = stat
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
