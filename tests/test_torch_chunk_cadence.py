"""The search chunk's cadence: the port against the JAX package, on the CPU.

The JAX package runs a chunk as ``lax.fori_loop(0, chunk, body)`` with the
iteration gated by ``lax.cond`` (``pushworld_tpu/search/batched.py``
``run_chunk``), 128 iterations where the caller leaves the length open, and
reads the search's status once a chunk.  Depth escalation is decided at
those reads, so a search that reads its status at another cadence can
escalate at another iteration and take another path.  On the card the port
runs a chunk as a device-side loop (``search/chunk_graph.py``): at the end
of each gated iteration the append's loop tail (``chunk_continue`` in plain
PyTorch) decides whether the loop goes on.  These tests hold the cadence,
the loop's rule and the loop's result against the JAX package:

- ``BatchedPlanner.solve`` at the card's default chunk gives JAX's plan,
  final depth, iterations and expansions (``heur/aw_tool_corridor``
  escalates at a chunk of 1-3 iterations; JAX's 128 does not);
- the default chunk is JAX's 128 at every depth on both devices;
- ``chunk_continue_reference`` against JAX's ``active`` expression and the
  loop's bound (a countdown from it);
- ``run_chunk(k)`` and the loop's own form (iterations whose append runs
  the loop's tail, on CPU tensors) leave JAX's ``run_chunk(k)`` search.
"""

import dataclasses
import inspect
import itertools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pushworld_tpu.search.batched as jb
import pushworld_tpu.search.planner as jplanner
from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.ops import novelty as jn
from pushworld_tpu.ops import rgd as jr
from pushworld_tpu_torch import interop
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.ops.hashset import pack_key
from pushworld_tpu_torch.search import batched as tb
from pushworld_tpu_torch.search.chunk_graph import LOOP_MAX, LoopTail, chunk_continue_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUZZLES = os.path.join(ROOT, "tests", "puzzles")
CAPS = dict(expand=32, frontier_capacity=1 << 10, visited_bits=14, history_capacity=1 << 14)
PAIR_BITS = 12
# (fixture, RGD depth): aw_tool_corridor escalates to depth 1 when its status
# is read every 1-3 iterations and stays at 0 at JAX's 128; the others do
# not escalate at any cadence.
SOLVES = [("heur/aw_tool_corridor", 0), ("spill_grid", 0), ("heur/shortest_path_tool", 0), ("multi_goal", 0)]

# JAX's BatchedPlanner.solve with its default chunk, in a process of its own
# so that PW_NOVELTY_PAIR_BITS (read when JAX's novelty module is imported)
# is the port's pair_bits.  The last state the search dispatched gives its
# iterations and expansions.
_JAX_SOLVES = """if True:
    import json, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import pushworld_tpu.search.batched as jb
    from pushworld_tpu.core.puzzle import Puzzle
    cases, caps = json.loads(sys.argv[1])
    real, last = jb.run_chunk, []
    def spy(*args, **kwargs):
        s = real(*args, **kwargs)
        last[:] = [s]
        return s
    jb.run_chunk = spy
    out = {}
    for name, depth in cases:
        pl = jb.BatchedPlanner(Puzzle.from_file(f"tests/puzzles/{name}.pwp"), max_depth=depth, **caps)
        plan = pl.solve()
        out[name] = dict(plan=None if plan is None else [int(a) for a in plan], max_depth=pl.max_depth,
                         iterations=int(last[0].iterations), expansions=int(last[0].expansions))
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_solves():
    env = dict(os.environ, PW_NOVELTY_PAIR_BITS=str(PAIR_BITS), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _JAX_SOLVES, json.dumps([SOLVES, CAPS])], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.splitlines()[-1])


@pytest.mark.parametrize("name,depth", SOLVES)
def test_solve_at_the_cards_default_chunk_matches_jax(jax_solves, name, depth):
    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    pl = tb.BatchedPlanner(p, max_depth=depth, pair_bits=PAIR_BITS, device="cpu", **CAPS)
    plan = pl.solve(chunk=tb.chunk_length(None, pl.config, torch.device("cuda")))
    got = dict(plan=plan, max_depth=pl.max_depth, iterations=int(pl.last_state.iterations),
               expansions=int(pl.last_state.expansions))
    assert got == jax_solves[name]
    assert p.is_valid_plan(plan)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_default_chunk_is_jaxs(device, depth):
    cfg = tb.SearchConfig(expand=256, history_capacity=1 << 21, max_depth=depth)
    assert tb.chunk_length(None, cfg, torch.device(device)) == 128 == jplanner.CHUNK
    assert inspect.signature(jb.BatchedPlanner.solve).parameters["chunk"].default == 128 == LOOP_MAX
    assert tb.chunk_length(5, cfg, torch.device(device)) == 5


def _jax_active(s, cfg):
    """JAX's gate of an iteration, pushworld_tpu/search/batched.py:646-650."""
    return (
        (~s.solved)
        & (jnp.min(s.frontier_h) < jb.EMPTY)
        & (s.hist_cursor < cfg.history_capacity - 8 * cfg.expand)
    )


@pytest.mark.parametrize("bound", [1, 2, 128])
def test_chunk_continue_reference_against_jax_active(bound):
    """After a body whose gate was ``gate``, the loop goes on exactly when
    the body ran, JAX's next iteration is active as far as the solve and
    the history say, and the fori_loop has iterations left: the launch's
    countdown, ``bound - counter`` before the body, is above 1.  A frontier
    that emptied is the one condition the rule leaves to the next body's
    gate (one closed body)."""
    cfg = jb.SearchConfig(expand=32, history_capacity=1 << 14, max_depth=0)
    limit = cfg.history_capacity - 8 * cfg.expand
    live = np.array([5, jb.EMPTY], np.int32)
    empty = np.array([jb.EMPTY, jb.EMPTY], np.int32)
    seen = set()
    for gate, solved, cursor, frontier, counter in itertools.product(
            (False, True), (False, True), (limit - 1, limit, limit + 1), (live, empty),
            sorted({0, 1, bound - 2, bound - 1, bound} - {-1})):
        c, left = chunk_continue_reference(torch.tensor(gate), torch.tensor(solved),
                                           torch.tensor(cursor, dtype=torch.int32),
                                           torch.tensor(bound - counter, dtype=torch.int32), limit)
        s = dataclasses.make_dataclass("S", ["solved", "frontier_h", "hist_cursor"])(
            jnp.asarray(solved), jnp.asarray(frontier), jnp.asarray(cursor, jnp.int32))
        active = bool(_jax_active(s, cfg))
        more = counter + 1 < bound
        assert int(left) == bound - (counter + 1)
        assert bool(c) == (gate and not solved and cursor < limit and more)
        assert (bool(c) and frontier is live) == (gate and active and more)
        seen.add(bool(c))
    assert seen == ({False} if bound == 1 else {False, True})


def _jax_init(jp, depth):
    """The JAX planner's initial state with PAIR_BITS novelty tables (the
    JAX init reads the pair-table size from the environment at import)."""
    jcp = j_compile(jp)
    jt = jr.build_rgd_tables(jp, jcp, max_depth=depth)
    planner = jb.BatchedPlanner(jp, cp=jcp, tables=jt, max_depth=depth, **CAPS)
    s = planner.init_state()
    nt = jn.init_novelty(jcp.n, jcp.height, jcp.width, pair_bits=PAIR_BITS)
    moved = jnp.asarray(np.asarray(jcp.obj_mask)[None])
    _, nt = jn.novelty_score_and_update(nt, jnp.asarray(jcp.init_state)[None], moved, jnp.ones((1,), bool))
    return jcp, jt, planner.config, dataclasses.replace(s, novelty=nt)


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _assert_same_search(ts, js, where):
    d = _np(js)
    live = d["frontier_h"] < tb.EMPTY
    assert np.array_equal(ts.frontier_h.numpy(), d["frontier_h"]), where
    assert np.array_equal(ts.frontier_states.numpy()[live], d["frontier_states"][live]), where
    assert np.array_equal(ts.hist_parent.numpy(), d["hist_parent"]), where
    assert np.array_equal(ts.hist_action.numpy(), d["hist_action"]), where
    vis = d["visited"]
    jtable = pack_key(torch.as_tensor(vis["key_lo"].astype(np.int64)),
                      torch.as_tensor(vis["key_hi"].astype(np.int64)))
    assert torch.equal(ts.visited.keys, jtable), where
    assert np.array_equal(ts.novelty.pair_table.float().numpy(), d["novelty"]["pair_table"].astype(np.float32)), where
    for f in ("ring_cursor", "hist_cursor", "solved", "solved_hist", "iterations", "expansions", "evictions",
              "needs_deeper"):
        assert int(getattr(ts, f)) == int(d[f]), (where, f)


def _plan_valid(s, path):
    p = Puzzle.from_file(path)
    return p.is_valid_plan(tb.reconstruct_plan(s))


def _loop_form(cp, t, cfg, s, bound):
    """``chunk_loop.cu``'s loop on CPU tensors: iterations whose append runs
    the loop's tail, until the tail says stop (the countdown set to the
    bound at the launch).  Returns the bodies run."""
    loop = LoopTail.new("cpu", cfg, remaining=bound)
    while True:
        tb._iterate(cp, t, cfg, s, loop)
        if not int(loop.flag):
            return int(loop.bodies)


# spill_grid solves in its 18th iteration at these capacities: chunks of 1
# and 5 straddle the solve, a chunk of 128 holds it.
@pytest.mark.parametrize("k,chunks", [(1, 20), (5, 5), (128, 2)])
def test_run_chunk_and_the_loop_form_match_jax(k, chunks):
    path = os.path.join(PUZZLES, "spill_grid.pwp")
    jcp, jt, jcfg, js = _jax_init(JPuzzle.from_file(path), 0)
    cfg = tb.SearchConfig(expand=CAPS["expand"], history_capacity=CAPS["history_capacity"], max_depth=0)
    tcp = interop.compiled_from_numpy(_np(jcp), device="cpu")
    ttab = interop.rgd_tables_from_numpy(_np(jt), device="cpu")
    ts = interop.search_state_from_numpy(_np(js), device="cpu")
    loop = interop.search_state_from_numpy(_np(js), device="cpu")
    for c in range(chunks):
        before = int(loop.iterations)
        js = jb.run_chunk(jcp, jt, jcfg, js, k)
        tb.run_chunk(tcp, ttab, cfg, ts, k)
        bodies = _loop_form(tcp, ttab, cfg, loop, k)
        _assert_same_search(ts, js, f"run_chunk, chunk {c}")
        _assert_same_search(loop, js, f"loop form, chunk {c}")
        ran = int(loop.iterations) - before
        # Every active iteration ran, and at most one closed body after them.
        assert ran <= bodies <= min(k, ran + 1), (c, ran, bodies)
    assert bool(ts.solved) and _plan_valid(ts, path)
