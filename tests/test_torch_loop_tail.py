"""The search loop's tail, folded into the append, on the CPU.

On the card a search chunk is a device-side loop (``search/chunk_graph.py``)
whose body ends with the append kernel, and the kernel's tail decides
whether the loop runs another body (``kernels/frontier.cu`` ``loop_tail``).
Its plain version is ``append_children_reference`` with a loop: the JAX
package's append, then ``chunk_graph.chunk_continue``.  These tests hold it
against ``chunk_continue_reference`` and against JAX's ``active``
expression (``pushworld_tpu/search/batched.py:646-650``) over every
combination of gate, solve, a goal among the children, the history cursor
at and around its limit, and the countdown of bounds 1, 2 and 128; the tail
must leave the search as the append without it does.  A closed body, the
whole iteration with the gate closed, must leave the search exactly as it
was and write only the loop's scalars.
"""

import dataclasses
import itertools
import os

import jax.numpy as jnp
import pytest
import torch

import pushworld_tpu.search.batched as jb
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.ops.hashset import HashSet, fingerprint_dedup_insert
from pushworld_tpu_torch.ops.novelty import novelty_score_and_update
from pushworld_tpu_torch.ops.rgd import rgd_heuristic_with_flags
from pushworld_tpu_torch.ops.step import expand_and_test
from pushworld_tpu_torch.search import batched as tb
from pushworld_tpu_torch.search.chunk_graph import LoopTail, chunk_continue_reference

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
CAPS = dict(expand=32, frontier_capacity=1 << 10, visited_bits=14, history_capacity=1 << 14, pair_bits=12)


def _clone(s):
    out = dataclasses.replace(s, graph=None, **{k: v.clone() for k, v in vars(s).items()
                                               if isinstance(v, torch.Tensor)})
    out.visited = HashSet(keys=s.visited.keys.clone(), capacity_bits=s.visited.capacity_bits)
    out.novelty = dataclasses.replace(s.novelty, seen_pos=s.novelty.seen_pos.clone(),
                                      pair_table=s.novelty.pair_table.clone())
    return out


def _tensors(s):
    out = {k: v for k, v in vars(s).items() if isinstance(v, torch.Tensor)}
    out.update({"visited.keys": s.visited.keys, "novelty.seen_pos": s.novelty.seen_pos,
                "novelty.pair_table": s.novelty.pair_table})
    return out


def _assert_equal_states(a, b, where):
    for name, x in _tensors(a).items():
        assert torch.equal(x, _tensors(b)[name]), (where, name)


def _jax_active(s, cfg):
    """JAX's gate of an iteration, pushworld_tpu/search/batched.py:646-650,
    on the port's state."""
    limit = cfg.history_capacity - 8 * cfg.expand
    return bool((~jnp.asarray(bool(s.solved)))
                & (jnp.min(jnp.asarray(s.frontier_h.numpy())) < jb.EMPTY)
                & (jnp.asarray(int(s.hist_cursor), jnp.int32) < limit))


@pytest.fixture(scope="module")
def iteration():
    """spill_grid's search after 3 iterations, and the 4th iteration's steps
    up to its append, as ``_iterate`` takes them: (config, state, the
    append's inputs)."""
    pl = tb.BatchedPlanner(Puzzle.from_file(os.path.join(PUZZLES, "spill_grid.pwp")), max_depth=0, device="cpu",
                           **CAPS)
    cfg, t, cp = pl.config, pl.tables, pl.cp_dev
    s = pl.init_state()
    for _ in range(3):
        tb._iterate(cp, t, cfg, s)
    parents, parent_hist, sel_valid, gate = tb.select_and_gate(cfg, s)
    children, moved, effective, goal = expand_and_test(cp, t.contacts, t.contacts_mask, parents, sel_valid, gate)
    keys, is_new = fingerprint_dedup_insert(s.visited, children, cp.width, effective, gate)
    nov, _ = novelty_score_and_update(s.novelty, children, moved, is_new)
    rgd, deeper = rgd_heuristic_with_flags(t, children, max_depth=cfg.max_depth, valid=is_new)
    tb.compact_frontier(s, children.shape[0], gate)
    assert bool(gate) and int(is_new.sum()) > 0 and not bool(goal.any())
    return cfg, s, dict(gate=gate, is_new=is_new, parent_hist=parent_hist, actions=None, goal=goal, nov=nov,
                        rgd=rgd, deeper=deeper, sel_valid=sel_valid, children=children, keys=keys)


@pytest.mark.parametrize("open_gate", [True, False])
@pytest.mark.parametrize("bound", [1, 2, 128])
def test_append_tail_against_chunk_continue_and_jax_active(iteration, bound, open_gate):
    """After the append, the tail's flag is ``chunk_continue_reference`` of
    the state the append left and the countdown; it goes on exactly when
    the body ran, JAX's next iteration is active as far as the solve and the
    history say, and the launch has bodies left.  The tail writes the loop's
    scalars and nothing else."""
    cfg, s, args = iteration
    limit = cfg.history_capacity - 8 * cfg.expand
    gate = args["gate"] if open_gate else torch.tensor(False)
    if not open_gate:  # what a closed iteration's kernels leave: no lane selected, none new
        args = dict(args, is_new=torch.zeros_like(args["is_new"]), sel_valid=torch.zeros_like(args["sel_valid"]))
    n_new = int(args["is_new"].sum()) if open_gate else 0
    first_new = int(args["is_new"].to(torch.int32).argmax())
    flags = set()
    for solved, offset, with_goal, counter in itertools.product(
            (False, True), (-1, 0, 1), (False, True), sorted({0, bound - 2, bound - 1} - {-1})):
        goal = torch.zeros_like(args["goal"])
        goal[first_new] = with_goal and open_gate
        inputs = dict(args, gate=gate, goal=goal)
        w = _clone(s)
        w.solved.fill_(solved)
        w.hist_cursor.fill_(limit + offset - n_new)
        plain, before = _clone(w), _clone(w)
        remaining = bound - counter
        loop = LoopTail.new("cpu", cfg, remaining=remaining)
        tb.append_children(w, cfg, **inputs, loop=loop)
        tb.append_children(plain, cfg, **inputs)
        where = (solved, offset, with_goal, counter)
        _assert_equal_states(w, plain, where)
        if not open_gate:
            _assert_equal_states(w, before, where)
        else:
            assert int(w.hist_cursor) == limit + offset, where
            assert bool(w.solved) == (solved or with_goal), where
        want, left = chunk_continue_reference(gate, w.solved, w.hist_cursor,
                                              torch.tensor(remaining, dtype=torch.int32), limit)
        assert (int(loop.remaining), int(loop.flag), int(loop.bodies)) == (int(left), int(want), 1), where
        assert int(left) == remaining - 1
        more = counter + 1 < bound
        live = bool(w.frontier_h.min() < tb.EMPTY)
        assert (bool(loop.flag) and live) == (open_gate and _jax_active(w, cfg) and more), where
        flags.add(bool(loop.flag))
    assert flags == ({False, True} if open_gate and bound > 1 else {False})


@pytest.mark.parametrize("remaining", [1, 2, 128])
def test_a_closed_body_writes_only_the_loop_scalars(remaining):
    """A whole iteration on a solved search, with the loop's tail: the
    search is bit-unchanged, the loop stops, counts the body and counts its
    countdown down."""
    pl = tb.BatchedPlanner(Puzzle.from_file(os.path.join(PUZZLES, "spill_grid.pwp")), max_depth=0, device="cpu",
                           **CAPS)
    s = pl.init_state()
    tb._iterate(pl.cp_dev, pl.tables, pl.config, s)
    s.solved.fill_(True)
    before = _clone(s)
    loop = LoopTail.new("cpu", pl.config, remaining=remaining)
    loop.bodies.fill_(41)
    loop.flag.fill_(7)
    gate = tb._iterate(pl.cp_dev, pl.tables, pl.config, s, loop)
    assert not bool(gate)
    _assert_equal_states(s, before, "closed body")
    assert (int(loop.remaining), int(loop.flag), int(loop.bodies)) == (remaining - 1, 0, 42)
