"""Port RGD tables and heuristic vs the JAX package's ``ops/rgd.py``.

The port builds its distance tables from wavefront fields (the plain version
on the CPU); the JAX package uses host BFS.  Tables must be array-equal on
every fixture, and heuristic values and needs-deeper flags equal (tolerance
0) on reachable states at depths 0..3.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.ops import rgd as jr
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.interop import rgd_tables_from_numpy
from pushworld_tpu_torch.ops import rgd as tr

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
FIXTURES = sorted(
    os.path.relpath(f, PUZZLES)[:-4]
    for f in glob.glob(os.path.join(PUZZLES, "**", "*.pwp"), recursive=True)
)
TABLE_FIELDS = ("E", "Dflat", "vidx", "doff", "dstride", "DG", "contacts", "contacts_mask",
                "contacts_a", "contacts_a_mask", "cvidx_a", "goal_pos", "goal_mask")
STATIC_FIELDS = ("n_real", "n", "max_goals", "height", "width", "cmax", "cmax_agent")


def _both(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return Puzzle.from_file(path), JPuzzle.from_file(path)


def _assert_tables_equal(tt, jt):
    for f in TABLE_FIELDS:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.shape == b.shape and np.array_equal(a.astype(b.dtype), b), f
    for f in STATIC_FIELDS:
        assert int(getattr(tt, f)) == int(getattr(jt, f)), f


@pytest.mark.parametrize("name", FIXTURES)
def test_build_rgd_tables_matches_jax(name):
    p, jp = _both(name)
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    jt = jr.build_rgd_tables(jp, j_compile(jp))
    _assert_tables_equal(tt, jt)
    assert tt.Dflat.dtype == torch.int32


@pytest.mark.parametrize("name", ["multi_goal", "heur/two_tools", "heur/aw_tool_corridor"])
def test_build_rgd_tables_padded_and_depth0_match_jax(name):
    p, jp = _both(name)
    pad = dict(cmax_pad=64, max_goals=4, dflat_cap=1 << 14, cmax_agent_pad=40)
    for depth in (0, 2):
        tt = tr.build_rgd_tables(p, compile_puzzle(p), max_depth=depth, device="cpu", **pad)
        jt = jr.build_rgd_tables(jp, j_compile(jp), max_depth=depth, **pad)
        _assert_tables_equal(tt, jt)
    assert tr.dflat_required(p, compile_puzzle(p), 0) == jr.dflat_required(jp, j_compile(jp), 0)
    assert tr.dflat_required(p, compile_puzzle(p)) == jr.dflat_required(jp, j_compile(jp))
    with pytest.raises(ValueError):
        tr.build_rgd_tables(p, compile_puzzle(p), dflat_cap=1, device="cpu")


def _reachable(puzzle, count, seed):
    rng = np.random.default_rng(seed)
    s = puzzle.initial_state
    out = [s]
    for _ in range(count - 1):
        for a in rng.integers(0, 4, size=rng.integers(1, 6)).tolist():
            s = puzzle.get_next_state(s, a)
        out.append(s)
    return np.asarray(out, np.int32)


@pytest.mark.parametrize(
    "name,depths",
    [
        ("heur/two_tools", (0, 1, 2)),
        ("heur/multiple_goals", (0, 1)),
        ("heur/shortest_path_tool", (1,)),
        ("heur/aw_tool_corridor", (0, 1, 3)),
    ],
)
def test_rgd_values_and_flags_match_jax(name, depths):
    p, jp = _both(name)
    jt = jr.build_rgd_tables(jp, j_compile(jp))
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    states = _reachable(p, 48, seed=7)
    for depth in depths:
        jv, jf = jr.rgd_heuristic_with_flags(jt, jnp.asarray(states), max_depth=depth)
        tv, tf = tr.rgd_heuristic_with_flags(tt, torch.as_tensor(states), max_depth=depth)
        assert tv.dtype == torch.float32
        assert np.array_equal(tv.numpy(), np.asarray(jv)), depth
        assert np.array_equal(tf.numpy(), np.asarray(jf)), depth
        assert torch.equal(tr.rgd_heuristic(tt, torch.as_tensor(states), max_depth=depth), tv)


def test_depth3_matches_host_oracle():
    """three_tools needs pushing depth 3 at the initial state; the port's
    memoized recursion must give the host oracle's exact values (the JAX
    package's own depth-3 test, run through the port)."""
    from pushworld_tpu.search.heuristics_host import RecursiveGraphDistance

    p, jp = _both("heur/three_tools")
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    host = RecursiveGraphDistance(jp, j_compile(jp), fewest_tools=True)
    states = _reachable(p, 32, seed=0)
    got3 = tr.rgd_heuristic(tt, torch.as_tensor(states), max_depth=3).numpy()
    assert tr.rgd_heuristic(tt, torch.as_tensor(states[:1]), max_depth=2)[0] >= 1e8
    for i, s in enumerate(states):
        want = host.estimate(tuple(map(tuple, s.tolist())))
        assert (got3[i] >= 1e8) if np.isinf(want) else (got3[i] == want), (i, want, got3[i])


def test_interop_tables_round_trip():
    p, jp = _both("heur/trivial_tool")
    jt = jr.build_rgd_tables(jp, j_compile(jp))
    d = {f: np.asarray(getattr(jt, f)) for f in TABLE_FIELDS + STATIC_FIELDS}
    tt = rgd_tables_from_numpy(d, device="cpu")
    _assert_tables_equal(tt, jt)
    states = torch.as_tensor(_reachable(p, 16, seed=1))
    ref = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    assert torch.equal(tr.rgd_heuristic(tt, states, 1), tr.rgd_heuristic(ref, states, 1))
