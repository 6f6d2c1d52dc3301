"""The port's CPU+GPU portfolio (``_portfolio_solve``, ``plan_puzzles``) on
the CPU, against the native planner, the batched planner and the JAX
package's ``_portfolio_solve``.  Every comparison of plans is exact.

The device member runs at the small capacities of tests/test_torch_search.py
and, where it is compared with the JAX package, at the JAX package's default
novelty pair table (2**24 buckets: its planner takes no other).
"""

import os
import threading

import pytest

import pushworld_tpu.native.bridge as jbridge
import pushworld_tpu.search.batched as jb
import pushworld_tpu.search.planner as jplanner
from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.native import bridge
from pushworld_tpu_torch.search import batched as tb
from pushworld_tpu_torch.search import planner as tplanner

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
SMALL = dict(expand=16, frontier_capacity=1 << 8, visited_bits=12, history_capacity=1 << 12)
PAIR_BITS = 12


def _pair(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return Puzzle.from_file(path), JPuzzle.from_file(path)


def _factory(p, depth, calls=None, **kw):
    def make():
        if calls is not None:
            calls.append(1)
        return tb.BatchedPlanner(p, max_depth=depth, device="cpu", **SMALL, **kw)

    return make


@pytest.mark.parametrize("name", ["chain", "heur/two_tools", "spill_grid", "agent_only", "no_solution"])
def test_native_member_wins_inside_the_head_start(name):
    p, _ = _pair(name)
    calls, solver = [], []
    plan = tplanner._portfolio_solve(
        _factory(p, tb.required_depth(p), calls, pair_bits=PAIR_BITS), p, compile_puzzle(p),
        "N+RGD", 30.0, solver)
    assert plan == bridge.solve_native_staged(p, time_limit=30.0)
    assert plan is None or plan == [] or p.is_valid_plan(plan)
    assert solver == ["native"] and not calls  # the device member never engaged


@pytest.mark.parametrize("name", ["chain", "heur/trivial_tool", "no_solution"])
def test_without_the_native_library_the_device_member_solves_alone(name, monkeypatch):
    p, _ = _pair(name)
    depth = tb.required_depth(p)
    want = _factory(p, depth, pair_bits=PAIR_BITS)().solve(time_limit=60.0)
    monkeypatch.setattr(bridge, "is_available", lambda: False)
    solver = []
    got = tplanner._portfolio_solve(
        _factory(p, depth, pair_bits=PAIR_BITS), p, compile_puzzle(p), "N+RGD", 60.0, solver)
    assert got == want and solver == ["device"]
    assert got is None or p.is_valid_plan(got)


@pytest.mark.parametrize("name,depth", [("spill_grid", 0), ("heur/shortest_path_tool", 0),
                                        ("heur/trivial_tool2", 1), ("no_solution", 1)])
def test_device_member_plan_equals_jax_portfolio(name, depth, monkeypatch):
    """No head start and a native member that only times out once the test
    lets it: the plan is the device member's, and equals the JAX package's."""
    p, jp = _pair(name)
    release = threading.Event()

    def slow_native(*args, **kwargs):
        release.wait(120)
        raise TimeoutError("native member held back by the test")

    monkeypatch.setenv("PW_PORTFOLIO_HEADSTART", "0")
    monkeypatch.setattr(jplanner, "HEADSTART", 0.0)
    monkeypatch.setattr(bridge, "solve_native_staged", slow_native)
    monkeypatch.setattr(jbridge, "solve_native_staged", slow_native)
    try:
        solver = []
        got = tplanner._portfolio_solve(
            _factory(p, depth), p, compile_puzzle(p), "N+RGD", 120.0, solver)
        jcp = j_compile(jp)
        want = jplanner._portfolio_solve(
            lambda: jb.BatchedPlanner(jp, cp=jcp, max_depth=depth, **SMALL), jp, jcp, "N+RGD", 120.0)
    finally:
        release.set()
    assert got == want and solver == ["device"]
    if name == "no_solution":
        assert got is None
    else:
        assert p.is_valid_plan(got)


def test_native_no_solution_and_budget_rules(monkeypatch):
    p, _ = _pair("spill_grid")
    cp = compile_puzzle(p)

    # A native member that exhausts its whole budget inside the head start
    # ends the portfolio, as in the JAX package.
    def spent(*a, **k):
        raise TimeoutError("native planner budget exhausted")

    monkeypatch.setattr(bridge, "solve_native_staged", spent)
    calls = []
    with pytest.raises(TimeoutError):
        tplanner._portfolio_solve(_factory(p, 0, calls, pair_bits=PAIR_BITS), p, cp, "N+RGD", 30.0)
    assert not calls

    # A native memory error falls through to the device member.
    def no_memory(*a, **k):
        raise MemoryError("native planner memory limit exhausted")

    monkeypatch.setattr(bridge, "solve_native_staged", no_memory)
    solver = []
    plan = tplanner._portfolio_solve(
        _factory(p, 0, pair_bits=PAIR_BITS), p, cp, "N+RGD", 60.0, solver)
    assert p.is_valid_plan(plan) and solver == ["device"]


def test_budget_ends_the_device_member_inside_a_chunk(monkeypatch):
    import time

    from test_torch_native import HARD

    hard = Puzzle.from_text(HARD)
    release = threading.Event()

    def slow_native(*args, **kwargs):
        release.wait(60)
        raise TimeoutError("held back")

    monkeypatch.setenv("PW_PORTFOLIO_HEADSTART", "0")
    monkeypatch.setattr(bridge, "solve_native_staged", slow_native)
    monkeypatch.setattr(tplanner, "CHUNK", 1 << 20)  # one chunk would never end
    big = dict(expand=64, frontier_capacity=1 << 12, visited_bits=18, history_capacity=1 << 20)
    t0 = time.monotonic()
    try:
        with pytest.raises(TimeoutError):
            tplanner._portfolio_solve(
                lambda: tb.BatchedPlanner(hard, max_depth=0, device="cpu", pair_bits=PAIR_BITS, **big),
                hard, compile_puzzle(hard), "N+RGD", 1.0)
    finally:
        release.set()
    assert time.monotonic() - t0 < 60.0  # the chunk alone would take hours


def test_plan_puzzles_portfolio_is_the_default_and_names_the_solver(monkeypatch):
    names = ["chain", "heur/two_tools", "no_solution", "agent_only", "heur/three_tools", "spill_grid"]
    named = [(n, _pair(n)[0]) for n in names]
    res = tplanner.plan_puzzles(named, device="cpu", pair_bits=PAIR_BITS, **SMALL)
    assert set(res) == set(names)
    for n, p in named:
        r = res[n]
        assert r.solver == "native", (n, r)
        if n == "no_solution":
            assert r.failure_reason == "no solution" and r.plan is None
        else:
            assert r.failure_reason is None and (r.plan == [] or p.is_valid_plan(r.plan))
            assert r.plan == bridge.solve_native_staged(p, time_limit=60.0)

    # Without the native library every result is the device member's, and
    # equals portfolio=False.
    monkeypatch.setattr(bridge, "is_available", lambda: False)
    dev = tplanner.plan_puzzles(named, device="cpu", pair_bits=PAIR_BITS, **SMALL)
    off = tplanner.plan_puzzles(named, portfolio=False, device="cpu", pair_bits=PAIR_BITS, **SMALL)
    for n in names:
        assert dev[n].solver == off[n].solver == "device"
        assert (dev[n].plan, dev[n].failure_reason) == (off[n].plan, off[n].failure_reason)


def test_entry_points_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device resolves")
    p, _ = _pair("chain")
    with pytest.raises(RuntimeError, match="cuda"):
        tplanner.plan_puzzles([("chain", p)])
    with pytest.raises(RuntimeError, match="cuda"):
        tplanner.solve_puzzle(p)
