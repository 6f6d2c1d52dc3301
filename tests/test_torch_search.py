"""The port's batched search vs the JAX package's, and end-to-end solves.

Whole slice: the JAX initial SearchState is carried into the port through
``interop.search_state_from_numpy``; after each of k chunks the port's
``run_chunk`` must leave exactly the JAX state (frontier, history, visited
set, novelty tables, counters).  Frontier slots holding EMPTY keys carry
no state (their contents are never read), so states/history/keys are
compared on the live slots.

The JAX package selects the frontier with ``approx_min_k``, whose result
order is implementation-defined; the port takes the exact top-k in
(key, slot) order.  The fixtures here are tie-free (every live key differs
in its recency bits), and the test checks that the JAX selection came out
in key order, so the two searches take identical steps.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pushworld_tpu.search.batched as jb
from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.ops import novelty as jn
from pushworld_tpu.ops import rgd as jr
from pushworld_tpu_torch import interop
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.ops.hashset import pack_key
from pushworld_tpu_torch.search import batched as tb
from pushworld_tpu_torch.search.planner import plan_puzzles, solve_puzzle

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
SMALL = dict(expand=16, frontier_capacity=1 << 8, visited_bits=12, history_capacity=1 << 12)
PAIR_BITS = 12


def _np(x):
    """A JAX dataclass as a dict of numpy arrays (nested dataclasses nested)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _jax_init(jp, depth, caps=SMALL):
    """The JAX planner's initial state with PAIR_BITS novelty tables (the
    JAX init reads the pair-table size from the environment at import)."""
    jcp = j_compile(jp)
    jt = jr.build_rgd_tables(jp, jcp, max_depth=depth)
    planner = jb.BatchedPlanner(jp, cp=jcp, tables=jt, max_depth=depth, **caps)
    s = planner.init_state()
    nt = jn.init_novelty(jcp.n, jcp.height, jcp.width, pair_bits=PAIR_BITS)
    moved = jnp.asarray(np.asarray(jcp.obj_mask)[None])
    _, nt = jn.novelty_score_and_update(nt, jnp.asarray(jcp.init_state)[None], moved, jnp.ones((1,), bool))
    return jcp, jt, planner.config, dataclasses.replace(s, novelty=nt)


def _assert_state_equal(ts, js, where):
    d = _np(js)
    live = d["frontier_h"] < tb.EMPTY
    assert np.array_equal(ts.frontier_h.numpy(), d["frontier_h"]), where
    assert np.array_equal(ts.frontier_states.numpy()[live], d["frontier_states"][live]), where
    assert np.array_equal(ts.frontier_hist.numpy()[live], d["frontier_hist"][live]), where
    jkey = pack_key(torch.as_tensor(d["frontier_lo"].astype(np.int64)),
                    torch.as_tensor(d["frontier_hi"].astype(np.int64)))
    assert torch.equal(ts.frontier_key[torch.as_tensor(live)], jkey[torch.as_tensor(live)]), where
    assert ts.ring_cursor.dtype == torch.int32 and int(ts.ring_cursor) == int(d["ring_cursor"]), where
    assert np.array_equal(ts.hist_parent.numpy(), d["hist_parent"]), where
    assert np.array_equal(ts.hist_action.numpy(), d["hist_action"]), where
    vis = d["visited"]
    jtable = pack_key(torch.as_tensor(vis["key_lo"].astype(np.int64)),
                      torch.as_tensor(vis["key_hi"].astype(np.int64)))
    assert torch.equal(ts.visited.keys, jtable), where
    assert np.array_equal(ts.novelty.seen_pos.numpy(), d["novelty"]["seen_pos"]), where
    assert np.array_equal(ts.novelty.pair_table.float().numpy(),
                          d["novelty"]["pair_table"].astype(np.float32)), where
    for f in ("hist_cursor", "solved", "solved_hist", "iterations", "expansions",
              "evictions", "needs_deeper"):
        assert int(getattr(ts, f)) == int(d[f]), (where, f)


# The last case: a 128-slot ring (the least for expand 16) compacts from the
# second iteration on and evicts from the ninth; spill_grid solves in the
# 23rd, so the fifth chunk of 5 straddles the solve and the sixth runs after.
@pytest.mark.parametrize("name,depth,frontier,chunk,chunks", [
    pytest.param("spill_grid", 0, SMALL["frontier_capacity"], 6, 3, id="spill_grid-0"),
    pytest.param("heur/shortest_path_tool", 1, SMALL["frontier_capacity"], 6, 3,
                 id="heur/shortest_path_tool-1"),
    pytest.param("heur/trivial_tool2", 1, SMALL["frontier_capacity"], 6, 3, id="heur/trivial_tool2-1"),
    pytest.param("spill_grid", 0, 1 << 7, 5, 6, id="spill_grid-0-compacting-across-a-solve"),
])
def test_run_chunk_state_matches_jax(name, depth, frontier, chunk, chunks):
    path = os.path.join(PUZZLES, name + ".pwp")
    p, jp = Puzzle.from_file(path), JPuzzle.from_file(path)
    caps = dict(SMALL, frontier_capacity=frontier)
    jcp, jt, jcfg, js = _jax_init(jp, depth, caps)

    # The port's own init gives the same state as the JAX init.
    cp = compile_puzzle(p)
    tt = tb.build_rgd_tables(p, cp, max_depth=depth, device="cpu")
    cfg = tb.SearchConfig(expand=SMALL["expand"], history_capacity=SMALL["history_capacity"],
                          max_depth=depth)
    own = tb.init_search_state(cp.to("cpu"), tt, cfg, frontier, SMALL["visited_bits"], PAIR_BITS, False)
    _assert_state_equal(own, js, "init")

    # Carry the JAX state (and tables) in; run k chunks on both sides.
    ts = interop.search_state_from_numpy(_np(js), device="cpu")
    tcp = interop.compiled_from_numpy(_np(jcp), device="cpu")
    ttab = interop.rgd_tables_from_numpy(_np(jt), device="cpu")
    cursors, solved_at = [int(ts.ring_cursor)], []
    for k in range(chunks):
        h_before = np.asarray(js.frontier_h)
        js = jb.run_chunk(jcp, jt, jcfg, js, chunk)
        ts = tb.run_chunk(tcp, ttab, cfg, ts, chunk)
        _assert_state_equal(ts, js, f"chunk {k}")
        assert not np.array_equal(h_before, np.asarray(js.frontier_h)) or int(js.solved)
        cursors.append(int(ts.ring_cursor))
        solved_at.append(bool(ts.solved))
    assert int(ts.iterations) > 6
    if frontier == 1 << 7:
        assert int(ts.evictions) > 0  # a compaction that evicted
        assert any(b < a for a, b in zip(cursors, cursors[1:]))  # a compaction moved the cursor back
        # The solve lands inside the fifth chunk (not at its end) and the
        # sixth chunk runs after it.
        assert solved_at == [False] * 4 + [True, True]
        assert int(ts.iterations) % chunk != 0


def test_jax_selection_order_is_key_order_at_test_sizes():
    """The premise of the state test: at its frontier sizes the JAX
    selection comes back in ascending key order, as the port's does."""
    rng = np.random.default_rng(0)
    F = SMALL["frontier_capacity"]
    nov = rng.integers(1, 4, size=F)
    rgd = rng.integers(0, 8191, size=F)
    recency = rng.permutation(0x8000)[:F]  # distinct: the keys are tie-free
    kf = ((nov << 28) | (rgd << 15) | recency).astype(np.int32)
    kf[rng.random(F) < 0.3] = tb.EMPTY
    _, idx = jax.lax.approx_min_k(jax.lax.bitcast_convert_type(jnp.asarray(kf), jnp.float32),
                                  SMALL["expand"])
    assert np.array_equal(np.asarray(idx), np.argsort(kf, kind="stable")[: SMALL["expand"]])


SOLVABLE = ["simple", "chain", "push_left", "multi_goal", "spill_grid", "heur/trivial",
            "heur/easy_search", "heur/multiple_goals", "heur/transitive_pushing",
            "heur/trivial_tool", "heur/trivial_tool2", "heur/necessary_transitive_pushing1",
            "heur/necessary_transitive_pushing3", "heur/blocked_transitive_pushing2",
            "heur/two_tools", "heur/three_tools", "heur/shortest_path_tool"]


@pytest.mark.parametrize("name", SOLVABLE)
def test_solve_puzzle_plans_validate(name):
    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    r = solve_puzzle(p, time_limit=60, device="cpu", pair_bits=PAIR_BITS, **SMALL)
    assert r.failure_reason is None, (name, r)
    assert p.is_valid_plan(r.plan) and r.expansions > 0
    assert JPuzzle.from_file(os.path.join(PUZZLES, name + ".pwp")).is_valid_plan(r.plan)


@pytest.mark.parametrize("name", ["no_solution", "overlap"])
def test_no_solution(name):
    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    r = solve_puzzle(p, time_limit=60, device="cpu", pair_bits=PAIR_BITS, expand=32,
                     frontier_capacity=1 << 10, visited_bits=14, history_capacity=1 << 14)
    assert r.failure_reason == "no solution" and r.plan is None


def test_required_depth_matches_jax():
    for f in sorted(glob.glob(os.path.join(PUZZLES, "heur", "*.pwp"))):
        assert tb.required_depth(Puzzle.from_file(f)) == jb.required_depth(JPuzzle.from_file(f)), f


def test_depth_escalation_and_lazy():
    p = Puzzle.from_file(os.path.join(PUZZLES, "heur", "aw_tool_corridor.pwp"))
    assert tb.required_depth(p) == 0
    planner = tb.BatchedPlanner(p, max_depth=0, pair_bits=PAIR_BITS, device="cpu", **SMALL)
    plan = planner.solve(time_limit=60)
    assert p.is_valid_plan(plan)
    lazy = tb.BatchedPlanner(p, max_depth=1, lazy=True, pair_bits=PAIR_BITS, device="cpu", **SMALL)
    assert p.is_valid_plan(lazy.solve(time_limit=60))


def test_time_limit_ends_a_search_inside_a_chunk():
    """A 1 s budget holds although one chunk alone would run far longer."""
    import time

    from test_torch_native import HARD

    p = Puzzle.from_text(HARD)
    planner = tb.BatchedPlanner(p, max_depth=0, pair_bits=PAIR_BITS, device="cpu", expand=64,
                                frontier_capacity=1 << 12, visited_bits=18, history_capacity=1 << 20)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="time budget"):
        planner.solve(time_limit=1.0, chunk=1 << 20)
    assert 1.0 <= time.monotonic() - t0 < 60.0  # the chunk alone would take hours
    assert 0 < int(planner.last_state.iterations) < 1 << 20
    # With no deadline a chunk runs its full count.
    s = tb.run_chunk(planner.cp_dev, planner.tables, planner.config, planner.init_state(), 7)
    assert int(s.iterations) == 7
    s = tb.run_chunk(planner.cp_dev, planner.tables, planner.config, s, 7, time.monotonic() - 1.0)
    assert int(s.iterations) == 7


def test_plan_puzzles_and_cli(capsys):
    from pushworld_tpu_torch.scripts.run_planner import main

    named = [(n, Puzzle.from_file(os.path.join(PUZZLES, n + ".pwp")))
             for n in ("chain", "heur/two_tools", "no_solution", "agent_only")]
    for portfolio, solver in ((False, "device"), (True, "native")):
        res = plan_puzzles(named, portfolio=portfolio, device="cpu", pair_bits=PAIR_BITS, **SMALL)
        assert res["no_solution"].failure_reason == "no solution"
        assert res["agent_only"].plan == []
        for n in ("chain", "heur/two_tools"):
            assert res[n].failure_reason is None and dict(named)[n].is_valid_plan(res[n].plan)
        assert {r.solver for r in res.values()} == {solver}
    r = solve_puzzle(named[0][1], planner="host", device="cpu")
    assert r.failure_reason is None and named[0][1].is_valid_plan(r.plan)

    assert main(["N+RGD", os.path.join(PUZZLES, "chain.pwp"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip()
    assert named[0][1].is_valid_plan([{"L": 0, "R": 1, "U": 2, "D": 3}[c] for c in out])
    assert main(["RGD", os.path.join(PUZZLES, "no_solution.pwp"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "NO SOLUTION"
