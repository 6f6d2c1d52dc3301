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


@pytest.mark.parametrize("shape,shared", [((7, 11, 13), False), ((40, 47, 54), True), ((3, 1, 9), False)])
def test_wavefront_kernel_bit_equal(dev, shape, shared):
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops.graphs import INF, distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    B, H, W = shape
    rng = np.random.default_rng(B)
    E = torch.as_tensor(rng.random((1 if shared else B, 4, H, W)) < 0.6, device=dev)
    d0 = torch.full((B, H, W), INF, dtype=torch.float32, device=dev)
    d0[torch.arange(B), torch.as_tensor(rng.integers(0, H, B)), torch.as_tensor(rng.integers(0, W, B))] = 0.0
    before = LAUNCHES["wavefront"]
    for cap in (0, 2):
        got = distance_fields(E, d0, max_iters=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, distance_fields_reference(E, d0, max_iters=cap))
    assert LAUNCHES["wavefront"] == before + 2


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
