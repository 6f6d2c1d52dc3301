"""The port's fleet executor (``search/fleet.py``) on the CPU.

The contract of tests/test_fleet.py, on the fixtures: every instance gets
exactly one result in every mode, every plan is valid, failures are
classified as the reference harness does, and the run terminates.  Thread
timing is not deterministic, so the comparison with the JAX package is made
on ``_device_multiplex`` alone (no coordination), where the results must be
equal, exactly.  Each fleet call runs under a timeout of its own, so that a
hang fails its test.
"""

import os
import threading

import pytest
import torch

import pushworld_tpu.search.fleet as jfleet
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.search import fleet
from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth
from pushworld_tpu_torch.search.planner import PlanResult
from test_torch_native import HARD

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
SMALL = dict(expand=16, frontier_capacity=1 << 8, visited_bits=12, history_capacity=1 << 12)
PAIR_BITS = 12
DEPTH0 = ["chain", "spill_grid", "multi_goal", "push_left", "simple", "heur/easy_search",
          "heur/shortest_path_tool"]
MIXED = ["chain", "heur/two_tools", "spill_grid", "heur/trivial_tool", "agent_only",
         "heur/three_tools", "heur/multiple_goals"]
HANG_S = 300.0


def _named(names):
    return [(n, Puzzle.from_file(os.path.join(PUZZLES, n + ".pwp"))) for n in names]


def _fleet(named, **kwargs):
    """``plan_puzzles_fleet`` under a timeout: a hang fails the test."""
    box = {}

    def run():
        try:
            box["results"] = fleet.plan_puzzles_fleet(named, **kwargs)
        except BaseException as e:  # handed to the test's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(HANG_S)
    assert not t.is_alive(), f"the fleet did not terminate within {HANG_S:.0f} s"
    if "error" in box:
        raise box["error"]
    return box["results"]


def _check_all_solved(named, results):
    assert sorted(results) == sorted(n for n, _ in named)  # no loss, no duplicate
    for name, puzzle in named:
        r = results[name]
        assert r.failure_reason is None, (name, r.failure_reason)
        assert r.plan == [] or puzzle.is_valid_plan(r.plan), name


def test_native_workers_only_need_no_device():
    named = _named(MIXED)
    results = _fleet(named, time_limit=30.0, native_workers=2, device_worker=False)
    _check_all_solved(named, results)
    assert {r.solver for r in results.values()} == {"native"}
    assert fleet._device_stats["mode"] == "off" and fleet._device_stats["lanes"] == 0
    # device_mode="off" is the same and resolves no device either.
    _check_all_solved(named, _fleet(named, time_limit=30.0, native_workers=2, device_mode="off"))


def test_device_worker_forced_solves_on_the_device():
    named = _named(DEPTH0[:6])
    results = _fleet(named, time_limit=60.0, native_workers=0, device_worker="force",
                     group_size=2, device_claim_delay=0.0, device_mode="claim",
                     device="cpu", pair_bits=PAIR_BITS, **SMALL)
    _check_all_solved(named, results)
    assert {r.solver for r in results.values()} == {"device"}
    stats = fleet._device_stats
    assert stats["lanes"] == 6 and stats["solved"] == 6 and stats["mode"] == "claim"
    assert stats["chunk_dispatches"] >= 6 and stats["table_bytes"] > 0
    assert stats["device_failed"] is False


def test_device_worker_alone_leaves_nothing_behind():
    # An odd count (the last instance stays below the claim's minimum of two)
    # and deep lanes that claim mode skips: with no native worker to take
    # them, the main thread's final drain does.
    named = _named(MIXED)
    results = _fleet(named, time_limit=60.0, native_workers=0, device_worker="force",
                     group_size=4, device_claim_delay=0.0, device_mode="claim",
                     device="cpu", pair_bits=PAIR_BITS, **SMALL)
    _check_all_solved(named, results)
    assert "device" in {r.solver for r in results.values()}


@pytest.mark.parametrize("mode", ["claim", "shadow"])
def test_work_stealing_no_loss_no_hang(mode, monkeypatch):
    monkeypatch.setattr(fleet, "DEVICE_STEAL_GRACE_S", 0.5)
    named = _named(MIXED)
    results = _fleet(named, time_limit=60.0, native_workers=1, device_worker="force",
                     group_size=4, device_claim_delay=0.0, device_mode=mode,
                     device="cpu", pair_bits=PAIR_BITS, **SMALL)
    _check_all_solved(named, results)
    assert fleet._device_stats["mode"] == mode
    assert fleet._device_stats["device_failed"] is False


def test_deep_lanes_run_when_asked(monkeypatch):
    monkeypatch.setenv("PW_DEVICE_DEEP", "1")
    named = _named(["heur/trivial_tool", "heur/two_tools", "heur/trivial_tool2", "chain"])
    results = _fleet(named, time_limit=60.0, native_workers=0, device_worker="force",
                     group_size=4, device_claim_delay=0.0, device_mode="claim",
                     device="cpu", pair_bits=PAIR_BITS, **SMALL)
    _check_all_solved(named, results)
    assert {r.solver for r in results.values()} == {"device"}


@pytest.mark.parametrize("kwargs", [
    dict(native_workers=1, device_worker=False),
    dict(native_workers=0, device_worker="force", device_mode="claim", device_claim_delay=0.0,
         group_size=2, device="cpu", pair_bits=PAIR_BITS, expand=32, frontier_capacity=1 << 10,
         visited_bits=14, history_capacity=1 << 14),
])
def test_no_solution_classification(kwargs):
    named = _named(["no_solution", "overlap"])
    results = _fleet(named, time_limit=30.0, **kwargs)
    for name in ("no_solution", "overlap"):
        assert results[name].failure_reason == "no solution" and results[name].plan is None


def test_time_limit_classification_and_no_downgrade():
    hard = Puzzle.from_text(HARD)
    results = _fleet([("hard", hard)], time_limit=0.5, native_workers=1, device_worker=False)
    assert results["hard"].failure_reason == "time limit" and results["hard"].plan is None
    # A success already on record is never replaced by a later failure.
    won = PlanResult([1, 2, 3], 0.1, None, solver="device")
    out = {"hard": won}
    results = _fleet([("hard", hard)], time_limit=0.5, native_workers=1, device_worker=False,
                     results_out=out)
    assert results is out and results["hard"] is won


def test_host_fallback_without_the_native_library(monkeypatch):
    from pushworld_tpu_torch.native import bridge

    monkeypatch.setattr(bridge, "is_available", lambda: False)
    named = _named(["chain", "simple", "no_solution"])
    results = _fleet(named, time_limit=30.0, native_workers=2, device_worker=False)
    assert results["no_solution"].failure_reason == "no solution"
    for n in ("chain", "simple"):
        assert results[n].failure_reason is None and results[n].solver == "host"


def test_device_failure_is_flagged_and_hosts_finish(monkeypatch):
    import pushworld_tpu_torch.ops.rgd as rgd

    def broken(*a, **k):
        raise RuntimeError("table build failed (injected by the test)")

    monkeypatch.setattr(rgd, "build_rgd_tables", broken)
    monkeypatch.setattr(fleet, "DEVICE_STEAL_GRACE_S", 0.2)
    named = _named(DEPTH0[:5])
    for mode in ("claim", "shadow"):
        results = _fleet(named, time_limit=30.0, native_workers=1, device_worker="force",
                         group_size=2, device_claim_delay=0.0, device_mode=mode,
                         device="cpu", pair_bits=PAIR_BITS, **SMALL)
        _check_all_solved(named, results)
        assert "device" not in {r.solver for r in results.values()}
        if fleet._device_stats["lanes"] == 0 and fleet._device_stats["device_failed"] is False:
            continue  # the host worker drained the queue before the device's first claim
        assert fleet._device_stats["device_failed"] is True


@pytest.mark.parametrize("mode", ["claim", "shadow"])
def test_device_failure_on_a_card_raises_after_hosts_finish(mode, monkeypatch):
    """On a card the hand-back to the hosts must not pass for a GPU run: the
    call raises, with every instance's result attached.  The card is stood
    in for by a ``cuda`` device whose table build fails."""
    import pushworld_tpu_torch.ops.rgd as rgd

    def broken(*a, **k):
        raise RuntimeError("table build failed (injected by the test)")

    monkeypatch.setattr(rgd, "build_rgd_tables", broken)
    monkeypatch.setattr(fleet, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(fleet, "DEVICE_STEAL_GRACE_S", 0.2)
    named = _named(DEPTH0[:5])
    # No native worker: the device worker takes the first claim for certain.
    with pytest.raises(fleet.DeviceWorkerError, match="table build failed") as info:
        _fleet(named, time_limit=30.0, native_workers=0, group_size=2,
               device_claim_delay=0.0, device_mode=mode, pair_bits=PAIR_BITS, **SMALL)
    assert fleet._device_stats["device_failed"] is True
    _check_all_solved(named, info.value.results)
    assert "device" not in {r.solver for r in info.value.results.values()}


def _many_objects(n):
    """The generated puzzle of ``n`` movables that chip_smoke.py solves."""
    return Puzzle.from_text(_root_module("chip_smoke").many_objects_text(n))


@pytest.mark.parametrize("mode", ["claim", "shadow", "off"])
def test_puzzles_the_native_planner_refuses_never_reach_a_host_worker(mode):
    """A puzzle of more movables than the native planner takes, beside ones
    it takes, with native workers on: the device worker solves it ("off":
    the host oracle planner), and no result is an error."""
    from pushworld_tpu_torch.native import bridge

    big = ("many_objects_33", _many_objects(33))
    assert big[1].num_movables > bridge.NATIVE_MAX_MOVABLES
    named = _named(["chain", "simple", "heur/two_tools"]) + [big]
    results = _fleet(named, time_limit=60.0, native_workers=2, device_worker="force",
                     group_size=4, device_claim_delay=0.0, device_mode=mode,
                     device="cpu", pair_bits=PAIR_BITS, **SMALL)
    _check_all_solved(named, results)
    assert results[big[0]].solver == ("host" if mode == "off" else "device")
    assert fleet._device_stats["device_failed"] is False


def _root_module(name):
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sharded_branch_and_default_device(monkeypatch):
    named = _named(["chain", "simple"])
    # PW_DEVICE_SHARDED=1: the shadow device worker runs the frontier-sharded
    # search on the instance of more than 8 movables (no native worker, so
    # nothing else solves it first).
    many = Puzzle.from_text(_root_module("chip_smoke").MANY_MOVABLES_TEXT)
    assert many.num_movables > 8
    monkeypatch.setenv("PW_DEVICE_SHARDED", "1")
    results = _fleet([("many_movables", many)], device_worker="force", device="cpu",
                     device_mode="shadow", native_workers=0, device_claim_delay=0.0)
    r = results["many_movables"]
    assert r.solver == "device-sharded" and r.failure_reason is None and many.is_valid_plan(r.plan)
    assert fleet._device_stats["device_failed"] is False
    monkeypatch.delenv("PW_DEVICE_SHARDED")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fleet.plan_puzzles_fleet(named)  # the default asks for the card
    # device="cpu" without "force": hosts only.
    results = _fleet(named, native_workers=1, device="cpu")
    assert {r.solver for r in results.values()} == {"native"} and fleet._device_stats["mode"] == "off"


def test_bench_entry_loads_a_set_and_needs_a_card(monkeypatch, capsys):
    from pushworld_tpu_torch import config

    bench = _root_module("bench_torch")
    # A folder with puzzles/<level>/*.pwp: here tests/, with heur as a level.
    monkeypatch.setattr(config, "BENCHMARK_PUZZLES_PATH", PUZZLES)
    named, paths = bench.load_set("heur:3, heur")
    assert len(named) == 3 + 15 and all(n.startswith("heur/") for n, _ in named)
    assert all(os.path.isfile(paths[n]) for n, _ in named)
    assert named[0][1].num_movables >= 1
    solved, _ = bench.run_native_baseline(named[:3], 10.0)
    assert solved == 3
    if not torch.cuda.is_available():
        assert bench.main() == 2  # no fallback to the CPU
        assert capsys.readouterr().out == ""  # and no result line

    # detail["env_throughput"]: on the set's largest grid, with the device
    # beside the rates; PUSHWORLD_BENCH_ENV=0 leaves it out; a failure is
    # reported in its place.
    monkeypatch.setattr(bench, "ENV_BATCH", 8)
    monkeypatch.setattr(bench, "ENV_HORIZON", 4)
    monkeypatch.setattr(bench, "ENV_REPS", 1)
    monkeypatch.delenv("PUSHWORLD_BENCH_ENV", raising=False)
    env = bench.env_throughput_detail(named, device="cpu")
    largest = max(named, key=lambda np_: np_[1].height * np_[1].width)
    assert env["puzzle"] == largest[0] and env["grid"] == [largest[1].height, largest[1].width]
    assert env["steps_per_s"] > 0 and env["batch_size"] == 8 and env["horizon"] == 4
    assert env["device"] == {"name": "cpu", "power_limit": None} and env["hbm_roofline_pct"] is None
    monkeypatch.setenv("PUSHWORLD_BENCH_ENV", "0")
    assert bench.env_throughput_detail(named, device="cpu") is None
    monkeypatch.setenv("PUSHWORLD_BENCH_ENV", "1")
    if not torch.cuda.is_available():
        failed = bench.env_throughput_detail(named)  # the default device: no card here
        assert list(failed) == ["error"] and failed["error"].startswith("RuntimeError:")


def test_launch_counts_lose_no_update_across_threads():
    """Several threads launch kernels (the fleet's device worker, the table
    prefetch): more threads than cores add to one count, no add is lost."""
    import sys

    from pushworld_tpu_torch import kernels

    n_threads, n_adds = 4 * (os.cpu_count() or 1), 500
    before = kernels.LAUNCHES["stress"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.count_launch("stress") for _ in range(n_adds)],
                                    daemon=True) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        added = kernels.LAUNCHES.pop("stress") - before
    assert added == n_threads * n_adds


def test_classify_and_bytes_per_lane():
    p = _named(["chain"])[0][1]
    assert fleet._classify(p, None, 0.1).failure_reason == "no solution"
    assert fleet._classify(p, [], 0.1).failure_reason is None
    assert fleet._classify(p, [0], 0.1).failure_reason == "invalid plan"
    # The sizing formula against the tensors a lane really holds.
    for name in ("spill_grid", "heur/two_tools"):
        p = _named([name])[0][1]
        cp, depth = compile_puzzle(p), required_depth(p)
        planner = BatchedPlanner(p, cp=cp, max_depth=depth, lazy=True, device="cpu",
                                 pair_bits=PAIR_BITS, **SMALL)
        s = planner.init_state()
        held = [v for v in vars(planner.tables).values() if isinstance(v, torch.Tensor)]
        held += [s.frontier_states, s.frontier_h, s.frontier_hist, s.frontier_key, s.hist_parent,
                 s.hist_action, s.visited.keys, s.novelty.seen_pos, s.novelty.pair_table]
        measured = sum(v.numel() * v.element_size() for v in held)
        formula = fleet.bytes_per_lane(
            cp.n, cp.height, cp.width, depth, *fleet._lane_shape(p, cp, depth),
            SMALL["history_capacity"], SMALL["frontier_capacity"], SMALL["visited_bits"], PAIR_BITS)
        assert 0 <= measured - formula <= 64 * cp.n + 64, (name, measured, formula)


def test_a_wave_shares_one_budget_and_the_card(monkeypatch):
    """Three lanes that never finish, one 1.5 s budget for the wave: every
    lane gets turns, all report "time limit" against the same clock, and
    once the first lane has ended no other lane runs on (with a clock per
    lane the second would start its budget when the first ends)."""
    from pushworld_tpu_torch.search import batched

    monkeypatch.setattr(fleet, "LANE_TURN_S", 0.1)
    turns = []
    real = batched.run_chunk

    def counting(cp, tables, cfg, s, chunk, deadline=None):
        turns.append(id(tables))  # one tables object per lane
        return real(cp, tables, cfg, s, chunk, deadline)

    monkeypatch.setattr(batched, "run_chunk", counting)
    hard = Puzzle.from_text(HARD)
    big = dict(expand=64, frontier_capacity=1 << 12, visited_bits=18, history_capacity=1 << 20)
    lanes = fleet._device_multiplex([(f"hard/{i}", hard) for i in range(3)], time_limit=1.5,
                                    device="cpu", pair_bits=PAIR_BITS, **big)
    out = [next(lanes)]
    turns_at_first_end = len(turns)
    out += list(lanes)
    assert len(turns) == turns_at_first_end
    assert sorted(n for n, _ in out) == ["hard/0", "hard/1", "hard/2"]
    assert all(r.failure_reason == "time limit" and r.solver == "device" for _, r in out)
    assert all(r.planning_time >= 1.5 for _, r in out)
    assert len(set(turns)) == 3 and len(set(turns[:3])) == 3  # taken in turn from the start


def test_device_multiplex_equals_jax():
    """No coordination, four fixtures of depth 0 and 1, the JAX package's
    default pair table: the same (name, plan, failure reason) on both sides."""
    names = ["chain", "spill_grid", "heur/trivial_tool", "heur/trivial_tool2", "agent_only"]
    got = sorted(
        (n, r.plan, r.failure_reason, r.solver)
        for n, r in fleet._device_multiplex(_named(names), time_limit=120.0, device="cpu", **SMALL))
    jnamed = [(n, JPuzzle.from_file(os.path.join(PUZZLES, n + ".pwp"))) for n in names]
    want = sorted(
        (n, r.plan, r.failure_reason, r.solver)
        for n, r in jfleet._device_multiplex(jnamed, time_limit=120.0, **SMALL))
    assert got == want
    assert [g[0] for g in got] == sorted(names) and all(g[2] is None for g in got)


def test_status_reads_follow_sync_every_as_in_jax(monkeypatch):
    """``PW_DEVICE_SYNC_EVERY`` at 1, 2 and 4, on both sides with chunks of 2
    iterations, so that a lane takes several chunks: the same (name, plan,
    reason) as the JAX package's fleet at every setting, and fewer status
    reads as the setting grows."""
    import pushworld_tpu.search.planner as jplanner

    names = ["chain", "spill_grid", "heur/trivial_tool"]
    monkeypatch.setattr(fleet, "CHUNK", 2)
    monkeypatch.setattr(jplanner, "CHUNK", 2)
    jnamed = [(n, JPuzzle.from_file(os.path.join(PUZZLES, n + ".pwp"))) for n in names]
    reads = []
    for every in (1, 2, 4):
        monkeypatch.setenv("PW_DEVICE_SYNC_EVERY", str(every))
        fleet._reset_device_stats()
        got = sorted((n, r.plan, r.failure_reason, r.solver)
                     for n, r in fleet._device_multiplex(_named(names), time_limit=120.0, device="cpu",
                                                         **SMALL))
        reads.append(fleet._device_stats["chunk_dispatches"])
        want = sorted((n, r.plan, r.failure_reason, r.solver)
                      for n, r in jfleet._device_multiplex(jnamed, time_limit=120.0, **SMALL))
        assert got == want, every
        assert all(g[2] is None for g in got)
    assert reads[0] > reads[1] > reads[2] > 0, reads
