"""The search iteration's expansion (``ops/step.py``: ``expand_children``,
``expand_and_test``) against the JAX package's, exactly.

Two things are held against ``pushworld_tpu.ops.step.expand_children`` and
``is_goal_state`` (and the ``moved`` / ``effective`` lines of JAX's
``_iterate``), on the same numpy-seeded parents, on every fixture:

- the plain version, which the CPU runs;
- the algorithm of ``kernels/expand.cu``, written here as a numpy loop per
  (action, parent) lane: the push relation as N bit masks, its closure from
  the agent by a worklist of set bits (where the plain version squares
  float matrices), the all-or-nothing rule, the child, its moved bits,
  ``effective`` and the goal test.

The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Every value is an integer:
tolerance 0.
"""

import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.ops import step as tstep

# pushworld_tpu.ops re-exports the function ``step`` under the module's name.
jstep = importlib.import_module("pushworld_tpu.ops.step")

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
FIXTURES = sorted(
    os.path.relpath(f, PUZZLES)[:-4]
    for f in glob.glob(os.path.join(PUZZLES, "**", "*.pwp"), recursive=True)
)
DISP = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], np.int32)


def _reachable(puzzle, count, seed):
    """Random-walk sample of reachable states, (count, N, 2) int32."""
    rng = np.random.default_rng(seed)
    s = puzzle.initial_state
    out = [s]
    for _ in range(count - 1):
        for a in rng.integers(0, 4, size=rng.integers(1, 5)).tolist():
            s = puzzle.get_next_state(s, a)
        out.append(s)
    return np.asarray(out, np.int32)


def _inputs(name, n_pad=None, count=24):
    """(port puzzle, JAX compiled puzzle, port compiled puzzle on the CPU,
    contact lists, parents padded to the compiled width, sel_valid)."""
    path = os.path.join(PUZZLES, name + ".pwp")
    p, jp = Puzzle.from_file(path), JPuzzle.from_file(path)
    cp, jcp = compile_puzzle(p, n_pad=n_pad), j_compile(jp, n_pad=n_pad)
    real = _reachable(p, count, seed=len(name))
    parents = np.tile(np.asarray(cp.init_state, np.int32)[None], (count, 1, 1))
    parents[:, : real.shape[1]] = real
    contacts, mask = tstep.build_contact_lists(cp)
    sel_valid = np.random.default_rng(len(name) + 1).random(count) < 0.8
    return p, jcp, cp.to("cpu"), contacts, mask, parents, sel_valid


def _jax_expansion(jcp, contacts, mask, parents, sel_valid):
    """JAX's expansion and the lines of its _iterate that follow it."""
    children = jstep.expand_children(jcp, jnp.asarray(contacts.astype(np.int32)), jnp.asarray(mask),
                                     jnp.asarray(parents))
    par4 = jnp.tile(jnp.asarray(parents), (4, 1, 1))
    moved = jnp.any(children != par4, axis=-1)
    effective = jnp.any(moved, axis=-1) & jnp.tile(jnp.asarray(sel_valid), (4,))
    goal = jax.vmap(jstep.is_goal_state, in_axes=(None, 0))(jcp, children)
    return tuple(np.asarray(x) for x in (children, moved, effective, goal))


def expand_kernel_np(parents, contacts, mask, static_block, obj_mask, goal_pos, goal_mask, sel_valid):
    """``kernels/expand.cu`` one lane at a time (lane = a * B + b)."""
    B, n = parents.shape[:2]
    children = np.empty((4 * B, n, 2), np.int32)
    moved = np.zeros((4 * B, n), bool)
    effective = np.zeros(4 * B, bool)
    goal = np.zeros(4 * B, bool)
    for lane in range(4 * B):
        a, b = divmod(lane, B)
        pos = parents[b]
        push = [0] * n
        for i in range(n):
            for j in range(n):
                rel = pos[i] - pos[j]
                hit = mask[a, i, j] & (contacts[a, i, j, :, 0] == rel[0]) & (contacts[a, i, j, :, 1] == rel[1])
                if hit.any():
                    push[i] |= 1 << j
        reached = todo = 1
        while todo:
            i = (todo & -todo).bit_length() - 1
            todo &= todo - 1
            fresh = push[i] & ~reached
            reached |= fresh
            todo |= fresh
        nothing = any(static_block[a, i, pos[i, 1], pos[i, 0]] for i in range(n) if reached >> i & 1)
        live = sum(1 << i for i in range(n) if obj_mask[i])
        bits = 0 if nothing else reached & live
        for i in range(n):
            m = bits >> i & 1
            children[lane, i] = pos[i] + DISP[a] * m
            moved[lane, i] = bool(m)
        effective[lane] = bits != 0 and bool(sel_valid[b])
        goal[lane] = all(not goal_mask[i] or (children[lane, i] == goal_pos[i]).all() for i in range(n))
    return children, moved, effective, goal


def _assert_equal(got, want, what):
    for name, g, w in zip(("children", "moved", "effective", "goal"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and np.array_equal(g, w), (what, name)


@pytest.mark.parametrize("name", FIXTURES)
def test_plain_expansion_matches_jax(name):
    _, jcp, cp, contacts, mask, parents, sel_valid = _inputs(name)
    want = _jax_expansion(jcp, contacts, mask, parents, sel_valid)
    got = tstep.expand_and_test(cp, torch.as_tensor(contacts), torch.as_tensor(mask), torch.as_tensor(parents),
                                torch.as_tensor(sel_valid))
    _assert_equal(got, want, name)
    # The public expand_children is the same children (the plain version on the CPU).
    children = tstep.expand_children(cp, torch.as_tensor(contacts), torch.as_tensor(mask), torch.as_tensor(parents))
    assert torch.equal(children, got[0])


@pytest.mark.parametrize("name", FIXTURES)
def test_kernel_algorithm_matches_jax(name):
    _, jcp, cp, contacts, mask, parents, sel_valid = _inputs(name)
    want = _jax_expansion(jcp, contacts, mask, parents, sel_valid)
    got = expand_kernel_np(parents, contacts, mask, cp.static_block.numpy(), cp.obj_mask.numpy(),
                           cp.goal_pos.numpy(), cp.goal_mask.numpy(), sel_valid)
    _assert_equal(got, want, name)


@pytest.mark.parametrize("name", ["heur/three_tools", "multi_goal", "spill_grid"])
def test_padded_to_32_objects_matches_jax(name):
    """The kernel's widest state: 32 objects (one 32-bit mask a pusher),
    the padding objects cleared by obj_mask."""
    _, jcp, cp, contacts, mask, parents, sel_valid = _inputs(name, n_pad=tstep.EXPAND_MAX_OBJECTS, count=6)
    assert cp.n == 32
    want = _jax_expansion(jcp, contacts, mask, parents, sel_valid)
    got = tstep.expand_and_test(cp, torch.as_tensor(contacts), torch.as_tensor(mask), torch.as_tensor(parents),
                                torch.as_tensor(sel_valid))
    _assert_equal(got, want, name)
    got = expand_kernel_np(parents, contacts, mask, cp.static_block.numpy(), cp.obj_mask.numpy(),
                           cp.goal_pos.numpy(), cp.goal_mask.numpy(), sel_valid)
    _assert_equal(got, want, name)


def test_many_movables_chain_matches_jax():
    """Transitive pushes through a chain of movables (chip_smoke's
    10-movable puzzle): the closure's worklist against JAX's squaring."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    p, jp = Puzzle.from_text(smoke.MANY_MOVABLES_TEXT), JPuzzle.from_text(smoke.MANY_MOVABLES_TEXT)
    cp, jcp = compile_puzzle(p).to("cpu"), j_compile(jp)
    parents = _reachable(p, 16, seed=7)
    contacts, mask = tstep.build_contact_lists(cp)
    sel_valid = np.ones(16, bool)
    want = _jax_expansion(jcp, contacts, mask, parents, sel_valid)
    assert (want[1].sum(-1) > 2).any()  # some child pushes more than one object
    got = expand_kernel_np(parents, contacts, mask, cp.static_block.numpy(), cp.obj_mask.numpy(),
                           cp.goal_pos.numpy(), cp.goal_mask.numpy(), sel_valid)
    _assert_equal(got, want, "many movables")
    _assert_equal(tstep.expand_and_test(cp, torch.as_tensor(contacts), torch.as_tensor(mask),
                                        torch.as_tensor(parents), torch.as_tensor(sel_valid)), want, "many movables")
