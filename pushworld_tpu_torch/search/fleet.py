"""Heterogeneous fleet executor: benchmark-set planning throughput.

Port of the JAX package's ``search/fleet.py``.  The reference benchmark
harness runs planner subprocesses strictly sequentially on one core
(reference: python3/src/pushworld/benchmark_rgd.py:70-84).  This framework's
unit of value is *throughput*: a work-stealing scheduler drives

  - N host worker threads running the native serial planner (the ctypes
    call releases the GIL, so workers overlap fully), popping puzzles from
    the FRONT of a shared queue, and
  - one device worker thread running single-lane batched searches
    multiplexed over the card (:func:`_device_multiplex`), which either
    shadows the host queue or claims batches from the BACK of it.

Every puzzle gets the reference protocol's per-puzzle budget for its single
attempt (time limit per attempt; failures are classified exactly like the
reference harness: time limit / no solution / memory error / invalid plan).

The device worker runs on ``device`` ("cuda" by default, which raises
without a card).  With ``device="cpu"`` it runs only when forced
(``device_worker="force"``, as the tests do); ``device_worker=False`` or
``device_mode="off"`` touches no device at all.  In shadow mode with
``PW_DEVICE_SHARDED=1`` it also runs the frontier-sharded search, once, on
each instance of more than 8 movables (solver ``"device-sharded"``).
"""

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import compile_puzzle, compute_delta
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.ops.novelty import _DEFAULT_PAIR_BITS
from pushworld_tpu_torch.search.planner import (
    CHUNK,
    PRODUCTION_CAPACITIES,
    PlanResult,
    _profile_for,
)

__all__ = ["plan_puzzles_fleet", "DeviceWorkerError"]


class DeviceWorkerError(RuntimeError):
    """The fleet's device worker failed on a card.  The hosts finished every
    instance (``results`` holds them), but the run is not a GPU run."""

    def __init__(self, message: str, results: Dict[str, "PlanResult"]):
        super().__init__(message)
        self.results = results

# Unstarted device lanes become host-stealable only after this many
# seconds of being held (env PW_DEVICE_STEAL_GRACE_S): long enough for the
# device worker to build a claimed lane's tables and dispatch it, short
# enough that a slow table build does not hold budget-burning instances
# hostage while hosts idle.
DEVICE_STEAL_GRACE_S = float(os.environ.get("PW_DEVICE_STEAL_GRACE_S", "6"))

# Device engagement policy (env PW_DEVICE_MODE):
#   "shadow" (default) — the device runs instances WITHOUT removing them
#       from the host queue: hosts keep every instance, so the fleet can
#       never solve fewer than host-only; the first SUCCESS wins (a host
#       reaching a device-solved instance skips it instantly, and a
#       cooperative cancel flag frees a host mid-solve).  The device works
#       the easy tail first (quick wins that free host time), then turns
#       to the hard head — the instances hosts burn their full budget on
#       and miss — with its capacity-heavy batched search.
#   "claim" — the device removes groups from the back of the queue and
#       owns them (host work-stealing applies).
#   "off" — host workers only.
DEVICE_MODE = os.environ.get("PW_DEVICE_MODE", "shadow")

# On the CPU a device lane's turn ends after CHUNK iterations or after this
# many seconds, whichever comes first, while other lanes of its wave wait: a
# chunk runs to its end before the next lane's starts, so without the cap a
# lane of slow iterations (a deep RGD recursion) would hold the device for
# its whole chunk while the others' budgets run out.  (On the card a chunk
# is one device-side loop, enqueued without a wait: 128 iterations of
# 0.04-0.06 ms of device work each at production capacities.)
LANE_TURN_S = 0.5

# Per-run device phase breakdown: reset by plan_puzzles_fleet, filled by
# _device_multiplex and the device worker, read by bench_torch.py and
# chip_smoke.py.  ``device_failed`` is set when a device worker's exception
# handler ran: the hosts then finish every instance, after which
# plan_puzzles_fleet raises DeviceWorkerError if the worker ran on a card.
_device_stats: Dict[str, float] = {}


def _reset_device_stats() -> None:
    _device_stats.clear()
    _device_stats.update(
        table_build_s=0.0, table_bytes=0, chunk_dispatches=0,
        status_sync_s=0.0, graph_capture_s=0.0, lanes=0, solved=0, mode=DEVICE_MODE,
        device_failed=False,
    )


def _classify(puzzle: Puzzle, plan: Optional[List[int]], dt: float) -> PlanResult:
    if plan is None:
        return PlanResult(None, dt, "no solution")
    if plan == [] or puzzle.is_valid_plan(plan):
        return PlanResult(plan, dt, None)
    return PlanResult(plan, dt, "invalid plan")


def bytes_per_lane(
    n: int,
    height: int,
    width: int,
    depth: int,
    dflat: int,
    cagent: int,
    cmax: int,
    history_capacity: int,
    frontier_capacity: int,
    visited_bits: int,
    pair_bits: int,
) -> int:
    """Device bytes one lane keeps resident while its wave runs: every
    RGDTables tensor plus the search-state buffers, at the port's exact
    shapes and dtypes."""
    hw = height * width
    rows = 1 if depth == 0 else n
    side = 1 << (pair_bits // 2)
    return (
        dflat * 4  # Dflat (int32)
        + rows * hw * 4  # vidx
        + 4 * n * hw  # E (bool)
        + n * hw * 4  # DG
        + 4 * n * hw * cagent * 2  # cvidx_a (int16)
        + 4 * n * n * cmax * 2 * 2  # contacts (int16)
        + 4 * n * n * cmax  # contacts_mask (bool)
        + 4 * n * cagent * (2 * 2 + 1)  # contacts_a + mask
        + 2 * 4 * history_capacity  # hist_parent + hist_action
        + frontier_capacity * (n * 2 * 4 + 4 + 4 + 8)  # states, keys, hist, fingerprints
        + (1 << visited_bits) * 8  # visited hash set (one int64 per slot)
        + n * hw  # novelty position table
        + side * side * 2  # novelty pair table (S x S bf16)
    )


def _lane_shape(p: Puzzle, cp, depth: int) -> Tuple[int, int, int]:
    """(dflat entries, agent-row contacts, contacts) of a lane's tables."""
    from pushworld_tpu_torch.ops.rgd import dflat_required

    counts = cp.push.reshape(4, cp.n, cp.n, -1).sum(-1)
    return (
        dflat_required(p, cp, depth),
        max(1, int(counts[:, 0, :].max())),
        max(1, int(counts.max())),
    )


def _device_multiplex(
    named: Sequence[Tuple[str, Puzzle]],
    mode: str = "N+RGD",
    time_limit: Optional[float] = 60.0,
    expand: int = PRODUCTION_CAPACITIES["expand"],
    frontier_capacity: int = PRODUCTION_CAPACITIES["frontier_capacity"],
    visited_bits: int = PRODUCTION_CAPACITIES["visited_bits"],
    history_capacity: int = PRODUCTION_CAPACITIES["history_capacity"],
    coordination: Optional[dict] = None,
    allow_deep: Optional[bool] = None,
    pair_bits: int = _DEFAULT_PAIR_BITS,
    device: DeviceLike = "cuda",
):
    """Runs one single-lane batched search per puzzle, multiplexed over the
    card in chunks; yields (name, PlanResult) as lanes finish.

    ``coordination`` (when given) is the fleet's work-stealing channel:
    {"lock", "lanes": {name: (puzzle, deadline, since)}, "stolen": set()}.
    Active lanes are registered so idle host workers can steal them back;
    lanes whose name lands in ``stolen`` are dropped without yielding a
    result (the stealing host worker reports the instance instead).

    The lanes are taken in turn, one chunk each, and a wave's lanes share
    one budget clock.  STATUS READS follow the JAX package's rules: a status
    is enqueued behind every ``PW_DEVICE_SYNC_EVERY`` chunks (default 2), it
    is read only once its event says that the card has produced it, a lane
    has at most two unconfirmed sync windows, the thread sleeps 0.02 s when
    every lane waits on the card, and one authoritative read classifies a
    lane when its budget ends (host clock), so that a solve which landed is
    not reported as "time limit".

    On the card a turn is one chunk of ``CHUNK`` (JAX's 128) iterations
    enqueued without a wait: one launch of the lane's device-side loop
    (``search/chunk_graph.py``; a wave's loops are captured into one memory
    pool before its clock starts), which stops on the card after the
    search's end.  A lane has at most ``2 * sync_every`` chunks in flight,
    so a budget ends at most that much device work late for each lane of
    the wave, and a lane that has ended wastes one closed iteration a chunk
    in flight.  On the CPU a turn is a chunk cut at
    ``LANE_TURN_S`` seconds where other lanes wait, and a status is ready
    when it is taken.
    """
    from pushworld_tpu_torch.ops.rgd import build_rgd_tables
    from pushworld_tpu_torch.search import chunk_graph
    from pushworld_tpu_torch.search.batched import (
        EMPTY,
        BatchedPlanner,
        PendingStatus,
        reconstruct_plan,
        required_depth,
        run_chunk,
    )

    device = resolve_device(device)
    on_card = device.type == "cuda"
    sync_every = max(1, int(os.environ.get("PW_DEVICE_SYNC_EVERY", "2")))
    # Full per-lane device-memory budget (tables + search state).
    table_budget = float(os.environ.get("PW_DEVICE_TABLE_BUDGET_GB", "4")) * 1e9

    # Shadow mode: lanes are duplicates of host-owned instances — no
    # work-stealing registration (hosts already own everything); the
    # "stolen" set carries instances RESOLVED elsewhere, whose lanes are
    # dropped at the next chunk boundary.
    shadow = bool(coordination.get("shadow", False)) if coordination else False

    # Group by shape profile, RGD depth and whether the packed distance
    # table is huge, in first-seen order.  Nothing is padded: the key only
    # groups and orders the lanes; waves bound the resident per-lane memory.
    groups: Dict[tuple, list] = {}
    for name, p in named:
        if p.is_goal_state(p.initial_state):
            yield name, PlanResult([], 0.0, None)
            continue
        prof = _profile_for(p.num_movables, max(p.height, p.width), compute_delta(p))
        cp = compile_puzzle(p)
        depth = required_depth(p)
        shape = _lane_shape(p, cp, depth)
        key = (prof, depth, shape[0] > (1 << 20))
        groups.setdefault(key, []).append((name, p, cp, shape))

    # Deep-RGD / huge-distance-table lanes cost seconds of table build and
    # far more per iteration.  They are ALSO where the device adds solves
    # that hosts miss.  The shadow loop therefore enables them only for
    # HEAD waves (the miss-attack phase, where a failure costs nothing —
    # hosts own every instance) via ``allow_deep``; tail waves and claim
    # mode skip them unless PW_DEVICE_DEEP=1.
    if allow_deep is None:
        allow_deep = os.environ.get("PW_DEVICE_DEEP") == "1"
    if os.environ.get("PW_DEVICE_DEEP") == "0":
        allow_deep = False
    for (_, depth, huge), sub in groups.items():
        if coordination is not None and (depth > 0 or huge):
            if not allow_deep:
                continue
            if os.environ.get("PW_DEVICE_DEEP") != "1":
                # Restrict deep attacks to the benchmark tiers where the
                # JAX package measured that they pay.
                sub = [t for t in sub if t[0].split("/", 1)[0] in ("level1", "level2")]
                if not sub:
                    continue
        lane_bytes = max(
            bytes_per_lane(
                cp.n, cp.height, cp.width, depth, *shape,
                history_capacity, frontier_capacity, visited_bits, pair_bits,
            )
            for _, _, cp, shape in sub
        )
        wave = max(1, min(len(sub), int(table_budget // max(lane_bytes, 1))))

        for w0 in range(0, len(sub), wave):
            lanes = []
            for name, p, cp, _ in sub[w0 : w0 + wave]:
                if coordination is not None:
                    with coordination["lock"]:
                        if name in coordination["stolen"]:
                            continue  # a host worker owns it already
                tb0 = time.monotonic()
                tables = build_rgd_tables(p, cp, max_depth=depth, device=device)
                if _device_stats:
                    _device_stats["table_build_s"] += time.monotonic() - tb0
                    _device_stats["table_bytes"] += sum(
                        v.numel() * v.element_size()
                        for v in dataclasses.asdict(tables).values()
                        if isinstance(v, torch.Tensor)
                    )
                    _device_stats["lanes"] += 1
                planner = BatchedPlanner(
                    p,
                    cp=cp,
                    tables=tables,
                    expand=expand,
                    frontier_capacity=frontier_capacity,
                    visited_bits=visited_bits,
                    history_capacity=history_capacity,
                    max_depth=depth,
                    use_novelty=(mode == "N+RGD"),
                    lazy=True,  # parent-evaluated RGD: 4x fewer gathers
                    pair_bits=pair_bits,
                    device=device,
                )
                lanes.append(
                    {
                        "name": name,
                        "puzzle": p,
                        "planner": planner,
                        "s": None,
                        "t0": None,
                        "deadline": None,
                        "chunks": 0,
                        "pending": deque(),
                    }
                )
                if coordination is not None and not shadow:
                    # Register before the first dispatch, so idle host
                    # workers can steal queued lanes (deadline None = the
                    # stealer gets the full per-puzzle budget).  Keep the
                    # CLAIM-time timestamp if the lane is already
                    # registered so the steal-grace clock measures time
                    # since the claim uniformly across a group's lanes.
                    with coordination["lock"]:
                        prev = coordination["lanes"].get(name)
                        ts = prev[2] if prev is not None else time.monotonic()
                        coordination["lanes"][name] = (p, None, ts)

            if on_card and lanes:
                # Every lane's graph is captured before the wave's clock
                # starts (the JAX package warms its compiled program first),
                # into one memory pool for the wave.
                pool = torch.cuda.graph_pool_handle()
                c0 = time.monotonic()
                for lane in lanes:
                    pl = lane["planner"]
                    lane["s"] = pl.init_state()
                    chunk_graph.attach(pl.cp_dev, pl.tables, pl.config, lane["s"], pool)
                if _device_stats:
                    _device_stats["graph_capture_s"] += time.monotonic() - c0

            def read_status(pending: PendingStatus) -> List[int]:
                sync0 = time.monotonic()
                stat = pending.read()
                if _device_stats:
                    _device_stats["status_sync_s"] += time.monotonic() - sync0
                    _device_stats["chunk_dispatches"] += 1
                return stat

            def turn_end(lane) -> Optional[float]:
                """When the lane's turn ends at the latest: its budget's end,
                or ``LANE_TURN_S`` from now where more lanes wait."""
                if len(lanes) == 1:
                    return lane["deadline"]
                turn = time.monotonic() + LANE_TURN_S
                return turn if lane["deadline"] is None else min(turn, lane["deadline"])

            def dispatch(lane) -> None:
                """One turn: one chunk (enqueued without a wait on the card),
                and every ``sync_every`` chunks a status behind it."""
                pl = lane["planner"]
                run_chunk(pl.cp_dev, pl.tables, pl.config, lane["s"], CHUNK, None if on_card else turn_end(lane))
                lane["chunks"] += 1
                if lane["chunks"] % sync_every == 0:
                    lane["pending"].append(PendingStatus(lane["s"]))

            def ended(lane, reason: Optional[str], plan=None) -> PlanResult:
                dt = time.monotonic() - lane["t0"]
                if reason is None and _device_stats:
                    _device_stats["solved"] += 1
                r = PlanResult(None, dt, reason) if reason else _classify(lane["puzzle"], plan, dt)
                r.solver = "device"
                return r

            def classify(lane, stat) -> Optional[PlanResult]:
                """The lane's result if a status says that it has ended."""
                solved, _, min_key, cursor, _, evictions, _, _ = stat
                if solved:
                    return ended(lane, None, reconstruct_plan(lane["s"]))
                if min_key >= EMPTY:
                    # With evictions the search is inconclusive (pruned
                    # states can't be re-generated): distinct reason for
                    # debugging; the harness maps it to the reference's
                    # "time limit" taxonomy at reporting.
                    return ended(lane, "no solution" if evictions == 0
                                 else "frontier exhausted after evictions")
                if cursor >= history_capacity - 8 * expand:
                    return ended(lane, "time limit")
                return None

            wave_t0 = None
            while lanes:
                finished = []
                stolen_now = []
                progressed = False
                for lane in lanes:
                    pl = lane["planner"]
                    if coordination is not None:
                        with coordination["lock"]:
                            if lane["name"] in coordination["stolen"]:
                                stolen_now.append(lane)
                                continue
                    if lane["chunks"] == 0:
                        # First dispatch.  Nothing is compiled here, so the
                        # wave's lanes share ONE budget clock, started at
                        # the wave's first dispatch (the JAX package starts
                        # a lane's clock when its asynchronous first
                        # dispatch returns, which is at once for every
                        # lane): the lanes then share the card inside one
                        # budget.
                        if wave_t0 is None:
                            wave_t0 = time.monotonic()
                        lane["t0"] = wave_t0
                        lane["deadline"] = (
                            None if time_limit is None else lane["t0"] + time_limit
                        )
                        if lane["s"] is None:
                            lane["s"] = pl.init_state()
                        if coordination is not None and not shadow:
                            with coordination["lock"]:
                                coordination["lanes"][lane["name"]] = (
                                    lane["puzzle"],
                                    lane["deadline"],
                                    time.monotonic(),
                                )
                        dispatch(lane)
                        progressed = True
                        continue
                    if lane["deadline"] is not None and time.monotonic() > lane["deadline"]:
                        # Budget over (host clock).  One final authoritative
                        # read of the NEWEST state: a solve that landed since
                        # the last status read is reported, not discarded as
                        # "time limit".
                        if read_status(PendingStatus(lane["s"]))[0]:
                            finished.append((lane, ended(lane, None, reconstruct_plan(lane["s"]))))
                        else:
                            finished.append((lane, ended(lane, "time limit")))
                        continue
                    # The OLDEST pending status is read only once the card
                    # has produced it, so this thread never waits on the
                    # card's compute here.
                    if lane["pending"] and lane["pending"][0].ready():
                        progressed = True
                        r = classify(lane, read_status(lane["pending"].popleft()))
                        if r is not None:
                            finished.append((lane, r))
                            continue
                    # At most two unconfirmed sync windows a lane: a bounded
                    # queue in flight (chunks after a solve, an exhaustion or
                    # a full history are no-ops on the device).
                    if len(lane["pending"]) < 2:
                        dispatch(lane)
                        progressed = True
                if not progressed and not finished and not stolen_now:
                    # Every lane waits on the card: yield the core to the
                    # host planner threads instead of polling hot.
                    time.sleep(0.02)
                for lane in stolen_now:
                    lanes.remove(lane)
                for lane, r in finished:
                    lanes.remove(lane)
                    if coordination is not None:
                        with coordination["lock"]:
                            coordination["lanes"].pop(lane["name"], None)
                            if lane["name"] in coordination["stolen"]:
                                continue  # host worker owns this instance
                    yield lane["name"], r


def plan_puzzles_fleet(
    named_puzzles: Sequence[Tuple[str, Puzzle]],
    mode: str = "N+RGD",
    time_limit: Optional[float] = 60.0,
    native_workers: Optional[int] = None,
    device_worker: bool = True,
    group_size: int = 16,
    device_claim_delay: float = 2.0,
    progress: bool = False,
    results_out: Optional[Dict[str, PlanResult]] = None,
    device_mode: Optional[str] = None,
    device: DeviceLike = "cuda",
    **group_kwargs,
) -> Dict[str, PlanResult]:
    """Solves a set of puzzles with the heterogeneous fleet.

    ``native_workers`` defaults to the host CPU count.  The device worker
    runs on ``device``: "cuda" (default) raises without a card; "cpu" runs
    it only when ``device_worker`` is the string "force" (for tests).  It
    claims a group only after ``device_claim_delay`` seconds AND while the
    queue holds more than the host workers' reserve — on easy sets the host
    workers drain the queue before the device ever engages (per-instance
    native solves are milliseconds), while on hard sets the device takes
    whole groups off the back in parallel.  Puzzles of more movables than
    the native planner takes (``bridge.NATIVE_MAX_MOVABLES``) never reach a
    host worker: the device worker solves them first, and without one (or
    where it fails) the host oracle planner does.

    When the device worker raises (a kernel that does not build or launch,
    say), its instances go back to the hosts, which finish them; on a card
    the call then raises :class:`DeviceWorkerError` (carrying the results)
    instead of returning a host-only run as if the card had taken part.
    """
    from pushworld_tpu_torch.native import bridge

    if native_workers is None:
        native_workers = max(1, os.cpu_count() or 1)
    _reset_device_stats()

    # HARD-FIRST queue order: host workers pop from the front, so the
    # instances that will burn their full budget start as early as possible
    # (they dominate the fleet wall-clock); the device claims groups from
    # the BACK — the easiest unclaimed instances, which its batched search
    # can finish within budget.  Difficulty proxy: benchmark level prefix,
    # then movable count, then grid area.
    def _difficulty(item):
        name, p = item
        lvl = 0
        head = name.split("/", 1)[0]
        if head.startswith("level"):
            try:
                lvl = int(head[5:])
            except ValueError:
                pass
        return (lvl, p.num_movables, p.height * p.width)

    named_puzzles = sorted(named_puzzles, key=_difficulty, reverse=True)

    native_ok = bridge.is_available()

    use_device = bool(device_worker)
    if device_mode is None:
        device_mode = DEVICE_MODE
    if device_mode == "off":
        use_device = False
    if use_device:
        device = resolve_device(device)  # "cuda" raises without a card
        if device.type != "cuda":
            use_device = device_worker == "force"
    shadow = use_device and device_mode == "shadow"
    _device_stats["mode"] = device_mode if use_device else "off"

    # ``results_out`` lets callers observe partial results while the fleet
    # runs (bench_torch.py's watchdog prints them if its deadline expires).
    results: Dict[str, PlanResult] = results_out if results_out is not None else {}
    lock = threading.Lock()
    # Puzzles of more movables than the native planner takes stay off the
    # host workers' queue: the device worker solves them before it claims
    # anything else (no host steals them), and what it leaves, the final
    # drain hands to the host oracle planner.
    wide_names = {
        name for name, p in named_puzzles
        if native_ok and p.num_movables > bridge.NATIVE_MAX_MOVABLES
    }
    wide: deque = deque(it for it in named_puzzles if it[0] in wide_names)
    dq: deque = deque(it for it in named_puzzles if it[0] not in wide_names)
    # Host workers keep at least this many instances for themselves; the
    # device claims groups beyond the reserve (claim mode only).
    reserve = 2 * native_workers if native_ok else 0
    # With the native library and no native worker thread, nothing but the
    # device worker takes from the queue until the final drain.
    no_host_threads = native_ok and native_workers <= 0
    # Coordination channel.  Claim mode: the device registers active lanes
    # and idle host workers steal them back; "pending" counts
    # device-claimed unresolved instances.  Both modes: "stolen" carries
    # instances resolved (solved) elsewhere — device lanes for them are
    # dropped at the next chunk boundary.  Shadow mode adds "started"
    # (instances a host began) so the device prioritizes work hosts have
    # not reached yet.
    coordination = {
        "lock": lock,
        "lanes": {},
        "stolen": set(),
        "pending": 0,
        "shadow": shadow,
        "started": set(),
    }
    # Cooperative cancel flags: the moment an instance is SOLVED anywhere,
    # its flag releases any host worker still grinding on it (checked in
    # the native search loop every 256 expansions).
    cancels: Dict[str, "np.ndarray"] = {
        name: np.zeros(1, np.int32) for name, _ in named_puzzles
    }

    def record(name: str, r: PlanResult) -> None:
        with lock:
            prev = results.get(name)
            if prev is not None and (
                prev.failure_reason is None or r.failure_reason is not None
            ):
                # Keep an existing success; never downgrade a success to a
                # failure.  (A failure may be UPGRADED by a later success:
                # in shadow mode the device keeps attacking instances the
                # hosts already missed.)
                return
            results[name] = r
            if r.failure_reason is None:
                coordination["stolen"].add(name)
                cancels[name][0] = 1
        if progress:
            status = "ok" if r.failure_reason is None else r.failure_reason
            print(f"  {name}: {status} ({r.planning_time:.2f}s)", flush=True)

    def native_loop() -> None:
        while True:
            budget = time_limit
            name = None
            with lock:
                while dq:
                    cand, puzzle = dq.popleft()
                    if cand in coordination["stolen"]:
                        continue  # already SOLVED by the shadow device
                    name = cand
                    coordination["started"].add(name)
                    break
                if name is not None:
                    pass
                elif use_device and coordination["lanes"]:
                    # Steal an unfinished device lane: finish it natively
                    # within its remaining budget.  Unstarted lanes
                    # (deadline None — queued behind a table build) are
                    # only stealable after a grace period, otherwise idle
                    # hosts vacuum every device claim before its first
                    # dispatch and the device never earns a solve; active
                    # lanes are always stealable (first result wins, so
                    # the race is benign).
                    now = time.monotonic()
                    items = list(coordination["lanes"].items())
                    pick = next(
                        ((n, v) for n, v in items
                         if v[1] is None and now - v[2] > DEVICE_STEAL_GRACE_S),
                        next(((n, v) for n, v in items if v[1] is not None), None),
                    )
                    if pick is not None:
                        name, (puzzle, deadline, _) = pick
                        del coordination["lanes"][name]
                        coordination["stolen"].add(name)
                        coordination["pending"] -= 1
                        if deadline is not None:
                            budget = max(0.1, deadline - time.monotonic())
                elif not (use_device and coordination["pending"] > 0):
                    return
            if name is None:
                # The device holds claimed instances that are not yet
                # stealable (table build / grace period): wait for them
                # instead of exiting.
                time.sleep(0.1)
                continue
            t0 = time.monotonic()
            try:
                plan = bridge.solve_native_staged(
                    puzzle, mode=mode, time_limit=budget,
                    stages=bridge.stages_for(name),
                    cancel=cancels.get(name),
                )
                r = _classify(puzzle, plan, time.monotonic() - t0)
                r.solver = "native"
                record(name, r)
            except TimeoutError:
                record(name, PlanResult(None, time.monotonic() - t0, "time limit"))
            except MemoryError:
                record(name, PlanResult(None, time.monotonic() - t0, "memory error"))
            except Exception as e:  # pragma: no cover - defensive
                record(name, PlanResult(None, time.monotonic() - t0, f"error: {e}"))

    def host_fallback_loop() -> None:
        # No native library: the host oracle planner fills in (slow; used
        # only in minimal environments).
        from pushworld_tpu_torch.search.host_planner import solve_host

        while True:
            with lock:
                if not dq:
                    return
                name, puzzle = dq.popleft()
            t0 = time.monotonic()
            try:
                plan = solve_host(puzzle, mode=mode, time_limit=time_limit)
                r = _classify(puzzle, plan, time.monotonic() - t0)
                r.solver = "host"
                record(name, r)
            except TimeoutError:
                record(name, PlanResult(None, time.monotonic() - t0, "time limit"))

    def _enter_device_thread() -> None:
        # The device thread's host-side work (RGD table builds, kernel
        # launches, status fetches) competes with the native planner
        # threads for the same cores.  Lower only THIS thread's scheduling
        # priority (Linux: setpriority on the native TID) so the
        # authoritative host arm always wins the CPU and the device only
        # consumes genuinely spare cycles.
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        except (AttributeError, OSError):  # pragma: no cover - non-Linux
            pass
        if device.type == "cuda":
            torch.cuda.set_device(device)

    device_errors: List[Exception] = []

    def _device_failure(what: str, e: Exception) -> None:
        import traceback

        _device_stats["device_failed"] = True
        device_errors.append(e)
        print(f"[fleet] {what} ({type(e).__name__}: {e})", flush=True)
        traceback.print_exc()

    def device_wide() -> bool:
        """The puzzles no host worker takes, ``group_size`` at a time, each
        result recorded.  False where the device failed: the rest stays in
        ``wide`` for the final drain."""
        while True:
            with lock:
                if not wide:
                    return True
                group = [wide.popleft() for _ in range(min(group_size, len(wide)))]
            done = set()
            try:
                for name, r in _device_multiplex(
                    group, mode=mode, time_limit=time_limit, device=device,
                    **group_kwargs
                ):
                    record(name, r)
                    done.add(name)
            except Exception as e:
                _device_failure(
                    "device worker failed on puzzles the native planner "
                    "refuses; the host oracle planner takes them", e,
                )
                with lock:
                    wide.extend(g for g in group if g[0] not in done)
                return False

    def device_shadow_loop() -> None:
        # SHADOW mode: the device duplicates host-owned instances instead
        # of claiming them — the fleet can never solve fewer than
        # host-only, and every device SUCCESS releases host time (queue
        # skip + cooperative cancel).
        _enter_device_thread()
        if not device_wide():
            return
        # Wave targets alternate between the easy tail (quick wins;
        # solving them before hosts reach them shortens the wall) and the
        # hard head (capacity-heavy parallel attempts on the instances
        # hosts burn full budget on — where a device solve ADDS one).
        # New waves are claimed only while the host queue is nonempty, so
        # the device tail never extends the fleet wall by more than about
        # one lane budget.
        start = time.monotonic()
        shadowed = set()
        prefer_tail = True
        # Opt-in (PW_DEVICE_SHARDED=1): ONE puzzle's frontier sharded over a
        # mesh (parallel.frontier_sharded), attempted once per instance of
        # more than 8 movables, between the multiplex waves.  The mesh is
        # this process's card alone: the fleets of other processes never
        # enter the call with this one, so a mesh over every rank of the
        # default group would wait for them forever.
        sharded_enabled = os.environ.get("PW_DEVICE_SHARDED", "0") == "1"
        sharded_tried = set()
        sharded_mesh = None
        while True:
            if time.monotonic() - start < device_claim_delay:
                time.sleep(0.05)
                continue
            if sharded_enabled:
                with lock:
                    big = next(
                        (
                            it for it in list(dq)
                            if it[1].num_movables > 8
                            and it[0] not in coordination["stolen"]
                            and it[0] not in sharded_tried
                        ),
                        None,
                    )
                if big is not None:
                    sharded_tried.add(big[0])
                    shadowed.add(big[0])
                    from pushworld_tpu_torch.parallel.frontier_sharded import (
                        solve_frontier_sharded,
                    )
                    from pushworld_tpu_torch.parallel.mesh import make_local_mesh

                    t0 = time.monotonic()
                    try:
                        if sharded_mesh is None:
                            sharded_mesh = make_local_mesh(device)
                        plan = solve_frontier_sharded(
                            big[1], mesh=sharded_mesh, time_limit=time_limit,
                            expand=256, frontier_capacity=1 << 15,
                            visited_bits=21, history_capacity=1 << 21,
                        )
                        if plan is not None:
                            r = _classify(big[1], plan, time.monotonic() - t0)
                            r.solver = "device-sharded"
                            if r.failure_reason is None:
                                record(big[0], r)
                    except TimeoutError:
                        pass
                    except Exception as e:
                        _device_failure(f"sharded device path failed on {big[0]}", e)
                        return
                    continue
            with lock:
                queued = list(dq)
                if not queued:
                    return
                resolved = coordination["stolen"]
                started = coordination["started"]
                # Tail waves take easy instances hosts have NOT reached
                # (quick substitution wins).  Head waves take the hardest
                # unresolved instances INCLUDING ones a host is already
                # grinding on — those are the probable misses, and a
                # parallel device attempt with its own budget can only
                # add (first success wins; duplicated effort only costs
                # device time the hosts never had).
                fresh = [
                    it for it in queued
                    if it[0] not in resolved and it[0] not in shadowed
                ]
                if prefer_tail:
                    fresh = [it for it in fresh if it[0] not in started]
                else:
                    head_started = [
                        (n, p) for n, p in named_puzzles
                        if n in started and n not in resolved
                        and n not in shadowed
                    ]
                    fresh = head_started + fresh
                if not fresh:
                    return
                ordered = fresh[::-1] if prefer_tail else fresh
                group = ordered[:group_size]
                for g_name, _ in group:
                    shadowed.add(g_name)
            was_tail_wave = prefer_tail
            prefer_tail = not prefer_tail
            try:
                for name, r in _device_multiplex(
                    group, mode=mode, time_limit=time_limit,
                    coordination=coordination,
                    allow_deep=not was_tail_wave,
                    device=device,
                    **group_kwargs
                ):
                    if r.failure_reason is None:
                        record(name, r)
                    # Device failures are NOT recorded in shadow mode: the
                    # host attempt is authoritative for failure taxonomy.
            except Exception as e:
                _device_failure(
                    "shadow device worker failed; hosts still own every "
                    "instance — no work lost", e,
                )
                return

    def device_loop() -> None:
        _enter_device_thread()
        if not device_wide():
            return
        # CLAIM mode (PW_DEVICE_MODE=claim): multiplexes SINGLE-LANE
        # batched searches over the card.
        start = time.monotonic()
        while True:
            with lock:
                remaining = len(dq)
            if remaining == 0 or (no_host_threads and remaining - reserve < 2):
                # (With no host thread the queue cannot shrink further:
                # the remainder drains on the main thread.)
                return
            if (
                remaining - reserve < 2
                or time.monotonic() - start < device_claim_delay
            ):
                time.sleep(0.05)
                continue
            with lock:
                avail = len(dq) - reserve
                if avail < 2:
                    continue
                group = [dq.pop() for _ in range(min(group_size, avail))]
                coordination["pending"] += len(group)
                # Register the WHOLE claim immediately: instances in later
                # shape-groups/waves would otherwise be unstealable while
                # earlier groups build and run (host workers would
                # spin-wait on "pending").
                for g_name, g_puzzle in group:
                    coordination["lanes"][g_name] = (g_puzzle, None, time.monotonic())
            group.reverse()
            processed = set()
            try:
                for name, r in _device_multiplex(
                    group, mode=mode, time_limit=time_limit,
                    coordination=coordination, device=device, **group_kwargs
                ):
                    record(name, r)
                    processed.add(name)
                    with lock:
                        coordination["pending"] -= 1
            except Exception as e:
                # Give the unprocessed rest of the claim back to the host
                # workers — but loudly: a silent return would degrade every
                # future run to host-only with no trace of the device bug.
                _device_failure(
                    "device worker failed; returning unprocessed puzzles to "
                    "host queue", e,
                )
                with lock:
                    for g in group:
                        if (
                            g[0] not in processed
                            and g[0] not in coordination["stolen"]
                        ):
                            dq.append(g)
                            coordination["pending"] -= 1
                        coordination["lanes"].pop(g[0], None)
                return

    threads: List[threading.Thread] = []
    if native_ok:
        for _ in range(native_workers):
            threads.append(threading.Thread(target=native_loop, daemon=True))
    else:
        threads.append(threading.Thread(target=host_fallback_loop, daemon=True))
    if use_device:
        threads.append(
            threading.Thread(
                target=device_shadow_loop if shadow else device_loop,
                daemon=True,
            )
        )
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # Anything still queued (device gave a group back after host workers
    # exited, or no host workers ran at all) is finished here on the main
    # thread, and so is a claimed lane that the device skipped and no host
    # worker was left to steal; instances already solved elsewhere are
    # skipped.
    with lock:
        for name, (puzzle, _, _) in coordination["lanes"].items():
            if name not in coordination["stolen"] and name not in results:
                dq.append((name, puzzle))
        coordination["lanes"].clear()
    while dq:
        name, puzzle = dq.popleft()
        with lock:
            if name in coordination["stolen"]:
                continue
        t0 = time.monotonic()
        try:
            if native_ok:
                plan = bridge.solve_native_staged(
                    puzzle, mode=mode, time_limit=time_limit,
                    stages=bridge.stages_for(name),
                )
            else:
                from pushworld_tpu_torch.search.host_planner import solve_host

                plan = solve_host(puzzle, mode=mode, time_limit=time_limit)
            record(name, _classify(puzzle, plan, time.monotonic() - t0))
        except TimeoutError:
            record(name, PlanResult(None, time.monotonic() - t0, "time limit"))
        except MemoryError:
            record(name, PlanResult(None, time.monotonic() - t0, "memory error"))
    # Puzzles the native planner refuses and the device did not solve (no
    # device worker, or it failed): the host oracle planner.
    for name, puzzle in wide:
        if name in results:
            continue
        from pushworld_tpu_torch.search.host_planner import solve_host

        t0 = time.monotonic()
        try:
            r = _classify(puzzle, solve_host(puzzle, mode=mode, time_limit=time_limit), time.monotonic() - t0)
            r.solver = "host"
            record(name, r)
        except TimeoutError:
            record(name, PlanResult(None, time.monotonic() - t0, "time limit"))
    if device_errors and device.type == "cuda":
        # No instance was lost, but the card's share of the work moved to
        # the hosts: a caller that asked for the card must not take this
        # for a GPU run.  (A forced CPU device worker only sets the flag.)
        e = device_errors[0]
        raise DeviceWorkerError(
            f"the fleet's device worker failed ({type(e).__name__}: {e}); "
            "the host planners finished its instances",
            results,
        ) from e
    return results
