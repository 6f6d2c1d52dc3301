"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (CUDA kernels have no
CPU mode).  On a machine with a card, and without JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX).
"""

import os

import numpy as np
import pytest
import torch

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _seeds_and_masks(rng, B, H, W, shared, dev):
    from pushworld_tpu_torch.ops.graphs import INF

    E = torch.as_tensor(rng.random((1 if shared else B, 4, H, W)) < 0.6, device=dev)
    d0 = torch.full((B, H, W), INF, dtype=torch.float32, device=dev)
    d0[torch.arange(B), torch.as_tensor(rng.integers(0, H, B)), torch.as_tensor(rng.integers(0, W, B))] = 0.0
    return E, d0


@pytest.mark.parametrize("shape,shared", [
    ((7, 11, 13), False), ((40, 47, 54), True), ((3, 1, 9), False),
    ((9, 5, 64), True), ((11, 9, 150), True), ((5, 6, 131), False), ((2, 160, 160), True),
])
def test_wavefront_kernel_bit_equal(dev, shape, shared):
    """0/INF seeds (the bit-parallel path), shared and per-field masks, rows
    of one and of several 64-bit words, uncapped and capped."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops.graphs import distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    B, H, W = shape
    E, d0 = _seeds_and_masks(np.random.default_rng(B), B, H, W, shared, dev)
    before = LAUNCHES["wavefront"]
    for cap in (0, 2):
        got = distance_fields(E, d0, max_iters=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, distance_fields_reference(E, d0, max_iters=cap))
    assert LAUNCHES["wavefront"] == before + 2


@pytest.mark.parametrize("shape,shared", [((13, 11, 13), False), ((21, 47, 54), True), ((10, 7, 90), True)])
def test_wavefront_kernel_general_seeds(dev, shape, shared):
    """Seeds other than 0/INF take the kernel's float sweeps, field by
    field: a batch that mixes both kinds of field equals the plain version,
    uncapped and capped."""
    from pushworld_tpu_torch.ops.graphs import distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    B, H, W = shape
    rng = np.random.default_rng(B + W)
    E, d0 = _seeds_and_masks(rng, B, H, W, shared, dev)
    odd = torch.as_tensor(rng.integers(0, 30, (B, H, W)).astype(np.float32), device=dev)
    pick = torch.as_tensor(rng.random((B, H, W)) < 0.05, device=dev)
    pick[::3] = False  # every third field keeps its 0/INF seeds
    d0 = torch.where(pick, odd, d0)
    for cap in (0, 2):
        got = distance_fields(E, d0, max_iters=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, distance_fields_reference(E, d0, max_iters=cap))


def test_wavefront_reads_strided_mask_planes(dev):
    """One object's column of a (4, n_obj, H, W) stack is read in place."""
    from pushworld_tpu_torch.ops.graphs import distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    rng = np.random.default_rng(5)
    stack = torch.as_tensor(rng.random((4, 3, 12, 17)) < 0.6, device=dev)
    _, d0 = _seeds_and_masks(rng, 30, 12, 17, True, dev)
    for E in (stack[None, :, 1], stack.permute(1, 0, 2, 3)):
        d = d0[: 30 if E.shape[0] == 1 else 3]
        assert not E.is_contiguous()
        got = distance_fields(E, d)
        torch.cuda.synchronize()
        assert torch.equal(got, distance_fields_reference(E, d))


def test_wavefront_wrapper_raises_on_a_grid_too_large(dev):
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    E = torch.zeros((1, 4, 300, 300), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        distance_fields(E, torch.zeros((1, 300, 300), device=dev))


@pytest.mark.parametrize("n,n_obj", [(1024, 4), (4096, 6), (1, 1), (1024, 20), (20000, 3)])
def test_fused_fingerprint_dedup_insert_matches_plain_version(dev, n, n_obj):
    """Duplicate children, invalid lanes and keys already in the table; a
    sparse table, so no probe run is exhausted.  n = 20,000 takes the
    dedup table in device scratch."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import hashset as hs

    rng = np.random.default_rng(n + n_obj)
    pool = rng.integers(0, 50, size=(max(1, n // 2), n_obj, 2)).astype(np.int32)
    kern, ref = hs.init_hashset(20, device=dev), hs.init_hashset(20, device=dev)
    before = LAUNCHES["visited_set.fingerprint_dedup_insert"]
    for rnd in range(3):  # later rounds meet keys of earlier ones
        states = torch.as_tensor(pool[rng.integers(0, len(pool), n)], device=dev)
        valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
        k_k, n_k = hs.fingerprint_dedup_insert(kern, states, 54, valid)
        k_r, n_r = hs.fingerprint_dedup_insert_reference(ref, states, 54, valid)
        torch.cuda.synchronize()
        assert torch.equal(k_k, k_r) and torch.equal(k_k, hs.fingerprint(states, 54))
        assert torch.equal(n_k, n_r), rnd
        assert torch.equal(torch.sort(kern.keys).values, torch.sort(ref.keys).values)
        if n > 1:
            assert n_k.sum() < valid.sum()  # the batch does hold duplicates
    assert LAUNCHES["visited_set.fingerprint_dedup_insert"] == before + 3


def test_visited_set_kernels_match_plain_version(dev):
    from pushworld_tpu_torch.ops import hashset as hs

    rng = np.random.default_rng(0)
    states = torch.as_tensor(rng.integers(0, 50, size=(4096, 6, 2)).astype(np.int32), device=dev)
    keys = hs.fingerprint(states, 54)
    valid = hs.dedup_batch(keys, torch.ones(4096, dtype=torch.bool, device=dev))
    kern, ref = hs.init_hashset(16, device=dev), hs.init_hashset(16, device=dev)
    n_k, _ = hs.probe_and_insert(kern, keys, valid)
    n_r, _ = hs.probe_and_insert_reference(ref, keys, valid)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_r)  # no probe exhaustion at this load: is_new = valid
    live = kern.keys[kern.keys != 0]
    assert torch.equal(torch.sort(live).values, torch.sort(keys[valid]).values)  # no torn keys
    dele = valid & (torch.arange(4096, device=dev) % 3 == 0)
    hs.probe_delete(kern, keys, dele)
    assert not torch.isin(keys[dele], kern.keys).any()
    again, _ = hs.probe_and_insert(kern, keys, valid)
    # Deleted keys are new again.  (A live key behind a tombstone is also
    # reported new and stored twice: the JAX semantics.)
    assert again[dele].all()
    live = kern.keys[(kern.keys != 0) & (kern.keys != -1)]
    assert set(live.tolist()) == set(keys[valid].tolist())


def test_solve_on_card_matches_cpu(dev):
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.search.planner import solve_puzzle

    small = dict(expand=32, frontier_capacity=1 << 10, visited_bits=14,
                 history_capacity=1 << 14, pair_bits=12)
    for name in ("multi_goal", "heur/two_tools", "heur/shortest_path_tool"):
        p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
        g = solve_puzzle(p, time_limit=60, device=dev, **small)
        c = solve_puzzle(p, time_limit=60, device="cpu", **small)
        assert g.failure_reason is None and p.is_valid_plan(g.plan)
        assert (g.plan, g.expansions) == (c.plan, c.expansions)


def _fixtures(names):
    from pushworld_tpu_torch.core.puzzle import Puzzle

    return [(n, Puzzle.from_file(os.path.join(PUZZLES, n + ".pwp"))) for n in names]


@pytest.mark.parametrize("mode", ["claim", "shadow"])
def test_fleet_device_worker_on_the_card(dev, mode, monkeypatch):
    """The fleet with its device worker on the card: no loss, no duplicate,
    valid plans, no device failure, and lanes that went through the kernels."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search import fleet

    monkeypatch.setattr(fleet, "DEVICE_STEAL_GRACE_S", 1.0)
    named = _fixtures(["chain", "spill_grid", "multi_goal", "heur/shortest_path_tool",
                       "heur/easy_search", "simple", "no_solution"])
    before = LAUNCHES["visited_set.fingerprint_dedup_insert"]
    results = fleet.plan_puzzles_fleet(
        named, time_limit=60.0, native_workers=0 if mode == "claim" else 1, group_size=4,
        device_claim_delay=0.0, device_mode=mode, device=dev)
    assert sorted(results) == sorted(n for n, _ in named)
    for name, p in named:
        r = results[name]
        if name == "no_solution":
            assert r.failure_reason == "no solution"
        else:
            assert r.failure_reason is None and p.is_valid_plan(r.plan), (name, r)
    stats = fleet._device_stats
    assert stats["mode"] == mode and stats["device_failed"] is False
    if mode == "claim":
        assert "device" in {r.solver for r in results.values()}
        assert stats["lanes"] > 0 and stats["solved"] > 0
        assert LAUNCHES["visited_set.fingerprint_dedup_insert"] > before


@pytest.mark.parametrize("mode", ["claim", "shadow"])
def test_fleet_raises_when_a_kernel_fails_on_the_card(dev, mode, monkeypatch):
    """A kernel wrapper that raises on the card: the hosts finish every
    instance, and the call raises instead of returning a host-only run."""
    from pushworld_tpu_torch.ops import rgd
    from pushworld_tpu_torch.search import fleet

    def broken(*a, **k):
        raise RuntimeError("wavefront kernel failed to launch (injected by the test)")

    monkeypatch.setattr(rgd, "distance_fields", broken)
    monkeypatch.setattr(fleet, "DEVICE_STEAL_GRACE_S", 0.2)
    named = _fixtures(["chain", "spill_grid", "multi_goal", "simple"])
    with pytest.raises(fleet.DeviceWorkerError, match="failed to launch") as info:
        fleet.plan_puzzles_fleet(named, time_limit=60.0, native_workers=0, group_size=2,
                                 device_claim_delay=0.0, device_mode=mode, device=dev)
    assert fleet._device_stats["device_failed"] is True
    results = info.value.results
    assert sorted(results) == sorted(n for n, _ in named)
    assert all(r.failure_reason is None and r.solver != "device" for r in results.values())


def test_portfolio_device_member_on_the_card(dev, monkeypatch):
    """No head start and a native member held back: the device member's plan,
    found on the card, equals the one found on the CPU."""
    import threading

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.search import batched, planner

    release = threading.Event()

    def slow_native(*args, **kwargs):
        release.wait(120)
        raise TimeoutError("native member held back by the test")

    monkeypatch.setenv("PW_PORTFOLIO_HEADSTART", "0")
    monkeypatch.setattr(bridge, "solve_native_staged", slow_native)
    small = dict(expand=32, frontier_capacity=1 << 10, visited_bits=14,
                 history_capacity=1 << 14, pair_bits=12)
    try:
        for name, p in _fixtures(["spill_grid", "heur/trivial_tool2"]):
            depth = batched.required_depth(p)
            plans = []
            for d in (dev, "cpu"):
                before = LAUNCHES["visited_set.fingerprint_dedup_insert"]
                solver = []
                plans.append(planner._portfolio_solve(
                    lambda: batched.BatchedPlanner(p, max_depth=depth, device=d, **small),
                    p, compile_puzzle(p), "N+RGD", 120.0, solver))
                assert solver == ["device"]
                rose = LAUNCHES["visited_set.fingerprint_dedup_insert"] > before
                assert rose == (d is dev)
            assert plans[0] == plans[1] and p.is_valid_plan(plans[0]), name
    finally:
        release.set()
