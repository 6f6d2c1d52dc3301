"""The search iteration's expansion (``ops/step.py``: ``expand_children``,
``expand_and_test``) against the JAX package's, exactly.

Two things are held against ``pushworld_tpu.ops.step.expand_children`` and
``is_goal_state`` (and the ``moved`` / ``effective`` lines of JAX's
``_iterate``), on the same numpy-seeded parents, on every fixture:

- the plain version, which the CPU runs;
- the algorithm of ``kernels/expand.cu``, written here as numpy loops over
  its CTAs, lanes and (lane, object) threads: the contact lists staged as
  32-bit offset words (or read from device memory above the staging
  budget), the push mask of each object by compares of whole words, its
  closure from the agent by a worklist of set bits (where the plain version
  squares float matrices), the all-or-nothing rule, the child, its moved
  bits, ``effective`` and the goal test.  Cases: every fixture, 32 objects,
  contact lists longer than 3 entries (at 32 objects, past the staging
  budget), and lane counts that are no multiple of a CTA's lanes.

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


def _inputs(name, n_pad=None, count=24, cmax_pad=0):
    """(port puzzle, JAX compiled puzzle, port compiled puzzle on the CPU,
    contact lists (at least ``cmax_pad`` entries a pair), parents padded to
    the compiled width, sel_valid)."""
    path = os.path.join(PUZZLES, name + ".pwp")
    p, jp = Puzzle.from_file(path), JPuzzle.from_file(path)
    cp, jcp = compile_puzzle(p, n_pad=n_pad), j_compile(jp, n_pad=n_pad)
    real = _reachable(p, count, seed=len(name))
    parents = np.tile(np.asarray(cp.init_state, np.int32)[None], (count, 1, 1))
    parents[:, : real.shape[1]] = real
    contacts, mask = tstep.build_contact_lists(cp, cmax_pad=cmax_pad)
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


NO_OFFSET = 0x80008000  # kernels/expand.cu kNoOffset
THREADS, STAGE_WORDS = 128, 2048  # kernels/expand.cu kThreads, kStageWords


def _offset_word(rx, ry):
    """An offset (rx, ry) as the kernel's 32-bit word: the int16 pair."""
    return (int(rx) & 0xFFFF) | (int(ry) & 0xFFFF) << 16


def expand_kernel_np(parents, contacts, mask, static_block, obj_mask, goal_pos, goal_mask, sel_valid):
    """``kernels/expand.cu`` CTA by CTA: P threads a lane (P the power of two
    >= n), 128 / P lanes a CTA (lane = a * B + b); the CTA's contact lists as
    staged 32-bit words (masked entries kNoOffset; above the staging budget
    the same words from device memory); per thread (lane, i) the push mask
    of object i by compares of whole words, no early exit; per lane the
    closure by a worklist over set bits and the group's ballots (blocked,
    live, off-goal bits)."""
    B, n = parents.shape[:2]
    C = contacts.shape[3]
    nb = 4 * B
    P = 1 << (n - 1).bit_length()
    lanes = THREADS // P
    span = min(4, -(-(lanes - 1) // B) + 1)
    staged_path = span * n * n * C <= STAGE_WORDS
    words = (contacts[..., 0].astype(np.int64) & 0xFFFF) | (contacts[..., 1].astype(np.int64) & 0xFFFF) << 16
    words = np.where(mask, words, NO_OFFSET).reshape(-1)  # (4 * n * n * C,)
    per_action = n * n * C
    children = np.empty((nb, n, 2), np.int32)
    moved = np.zeros((nb, n), bool)
    effective = np.zeros(nb, bool)
    goal = np.zeros(nb, bool)
    for lane0 in range(0, nb, lanes):
        a0, a1 = lane0 // B, (min(lane0 + lanes, nb) - 1) // B
        assert a1 - a0 + 1 <= span
        table, first = (words[a0 * per_action:(a1 + 1) * per_action], a0) if staged_path else (words, 0)
        for lane in range(lane0, min(lane0 + lanes, nb)):
            a, b = divmod(lane, B)
            cells = parents[b]
            push = []
            for i in range(n):  # the thread (lane, i)
                row = table[((a - first) * n + i) * n * C:((a - first) * n + i + 1) * n * C]
                m = 0
                for j in range(n):
                    rel = _offset_word(*(cells[i] - cells[j]))
                    m |= int((row[j * C:(j + 1) * C] == rel).any()) << j
                push.append(m)
            reached = todo = 1
            while todo:
                k = (todo & -todo).bit_length() - 1
                todo &= todo - 1
                fresh = push[k] & ~reached
                reached |= fresh
                todo |= fresh
            blocked = sum(int(static_block[a, i, cells[i, 1], cells[i, 0]]) << i for i in range(n))
            live = sum(int(obj_mask[i]) << i for i in range(n))
            bits = 0 if blocked & reached else reached & live
            off_goal = 0
            for i in range(n):
                m = bits >> i & 1
                children[lane, i] = cells[i] + DISP[a] * m
                moved[lane, i] = bool(m)
                off_goal |= int(goal_mask[i] and not (children[lane, i] == goal_pos[i]).all()) << i
            effective[lane] = bits != 0 and bool(sel_valid[b])
            goal[lane] = off_goal == 0
    return children, moved, effective, goal


WIDE_THREADS = 128  # kernels/expand.cu kWideThreads


def expand_wide_kernel_np(parents, contacts, mask, static_block, obj_mask, goal_pos, goal_mask, sel_valid):
    """The wide path of ``kernels/expand.cu`` (n > 32), CTA by CTA: one lane
    a CTA of 128 threads, thread t holding objects t, t + 128, ...; the
    closure by rounds over bit sets of ceil(n / 32) words (reached, frontier,
    next): in a round each thread tests each of its objects j not yet
    reached against every pusher k of the frontier (the contact words of
    (a, k, j) against pos_k - pos_j, masked entries skipped) and ORs j into
    the next frontier; a round that adds nothing ends the walk; then the
    CTA-wide ORs: blocked, moved, off-goal."""
    B, n = parents.shape[:2]
    C = contacts.shape[3]
    words_n = (n + 31) // 32
    nb = 4 * B
    words = (contacts[..., 0].astype(np.int64) & 0xFFFF) | (contacts[..., 1].astype(np.int64) & 0xFFFF) << 16
    children = np.empty((nb, n, 2), np.int32)
    moved = np.zeros((nb, n), bool)
    effective = np.zeros(nb, bool)
    goal = np.zeros(nb, bool)

    def bit(sets, i):
        return sets[i >> 5] >> (i & 31) & 1

    for lane in range(nb):  # a CTA
        a, b = divmod(lane, B)
        cells = parents[b]
        reached = [1] + [0] * (words_n - 1)
        front = list(reached)
        while True:
            nxt = [0] * words_n
            for t in range(WIDE_THREADS):
                for j in range(t, n, WIDE_THREADS):
                    if bit(reached, j):
                        continue
                    hit = False
                    for w in range(words_n):
                        f = front[w]
                        while f and not hit:
                            k = 32 * w + (f & -f).bit_length() - 1
                            f &= f - 1
                            rel = _offset_word(*(cells[k] - cells[j]))
                            hit = bool(((words[a, k, j] == rel) & mask[a, k, j]).any())
                        if hit:
                            break
                    if hit:
                        nxt[j >> 5] |= 1 << (j & 31)
            front = nxt
            reached = [r | f for r, f in zip(reached, nxt)]
            if not any(nxt):  # __syncthreads_or
                break
        nothing = any(bit(reached, i) and static_block[a, i, cells[i, 1], cells[i, 0]] for i in range(n))
        off = False
        for i in range(n):
            m = int(not nothing and bit(reached, i) and bool(obj_mask[i]))
            children[lane, i] = cells[i] + DISP[a] * m
            moved[lane, i] = bool(m)
            off |= bool(goal_mask[i]) and not (children[lane, i] == goal_pos[i]).all()
        effective[lane] = moved[lane].any() and bool(sel_valid[b])
        goal[lane] = not off
    return children, moved, effective, goal


def _smoke():
    """chip_smoke.py as a module (its puzzle texts)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


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
    smoke = _smoke()
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


@pytest.mark.parametrize("name,n_pad,cmax_pad", [("heur/three_tools", None, 8), ("multi_goal", None, 5),
                                                 ("heur/three_tools", 32, 8), ("spill_grid", 32, 6)])
def test_long_contact_lists_match_jax(name, n_pad, cmax_pad):
    """Contact lists of more than 3 entries a pair (the padding masked), at
    the fixture's width and at 32 objects, where the staged words exceed the
    kernel's budget and are read from device memory."""
    _, jcp, cp, contacts, mask, parents, sel_valid = _inputs(name, n_pad=n_pad, count=6, cmax_pad=cmax_pad)
    assert contacts.shape[3] == cmax_pad
    n = cp.n
    if n_pad == 32:
        assert 2 * n * n * cmax_pad > STAGE_WORDS  # the kernel's device-memory path
    want = _jax_expansion(jcp, contacts, mask, parents, sel_valid)
    _assert_equal(expand_kernel_np(parents, contacts, mask, cp.static_block.numpy(), cp.obj_mask.numpy(),
                                   cp.goal_pos.numpy(), cp.goal_mask.numpy(), sel_valid), want, name)
    _assert_equal(tstep.expand_and_test(cp, torch.as_tensor(contacts), torch.as_tensor(mask),
                                        torch.as_tensor(parents), torch.as_tensor(sel_valid)), want, name)


@pytest.mark.parametrize("name,count,n_pad", [("heur/three_tools", 1, None), ("multi_goal", 5, None),
                                              ("heur/two_tools", 13, None), ("spill_grid", 37, None),
                                              ("heur/three_tools", 3, 7)])
def test_lanes_not_a_multiple_of_the_cta_match_jax(name, count, n_pad):
    """4B lanes that do not fill the last CTA, and CTAs whose lanes span
    two or more action blocks (B below a CTA's lanes); n_pad 7: 8 threads a
    lane, one of them idle."""
    _, jcp, cp, contacts, mask, parents, sel_valid = _inputs(name, n_pad=n_pad, count=count)
    P = 1 << (cp.n - 1).bit_length()
    assert (4 * count) % (THREADS // P) or count < THREADS // P
    want = _jax_expansion(jcp, contacts, mask, parents, sel_valid)
    _assert_equal(expand_kernel_np(parents, contacts, mask, cp.static_block.numpy(), cp.obj_mask.numpy(),
                                   cp.goal_pos.numpy(), cp.goal_mask.numpy(), sel_valid), want, name)
    _assert_equal(tstep.expand_and_test(cp, torch.as_tensor(contacts), torch.as_tensor(mask),
                                        torch.as_tensor(parents), torch.as_tensor(sel_valid)), want, name)


@pytest.mark.parametrize("n", [33, 64])
def test_wide_kernel_algorithm_matches_jax(n):
    """The wide path's algorithm (states of more than 32 objects: a CTA a
    lane, the closure by rounds over multi-word bit sets) against JAX's
    expand_children and is_goal_state, and the plain version, on walks of a
    puzzle of ``n`` movables and on random cells of its grid (long chains
    of pushes), the goal object at its goal in some."""
    text = _smoke().many_objects_text(n)
    p, jp = Puzzle.from_text(text), JPuzzle.from_text(text)
    assert p.num_movables == n and tstep.expand_path(n) == "wide"
    cp, jcp = compile_puzzle(p).to("cpu"), j_compile(jp)
    rng = np.random.default_rng(n)
    cells = np.stack([rng.integers(0, p.width, (6, n)), rng.integers(0, p.height, (6, n))], -1).astype(np.int32)
    column = np.asarray(p.initial_state, np.int32)  # the agent above a column of six objects
    x = p.width // 2
    column[0] = (x, 2)
    column[2:8] = [(x, y) for y in range(3, 9)]
    parents = np.concatenate([_reachable(p, 6, seed=n), cells, column[None]])
    parents[-2, 1] = np.asarray(p.goal_state[0], np.int32)  # a parent with the goal object at its goal
    contacts, mask = tstep.build_contact_lists(cp)
    sel_valid = rng.random(len(parents)) < 0.8
    want = _jax_expansion(jcp, contacts, mask, parents, sel_valid)
    assert (want[1].sum(-1) > 2).any()  # some child pushes more than one object
    got = expand_wide_kernel_np(parents, contacts, mask, cp.static_block.numpy(), cp.obj_mask.numpy(),
                                cp.goal_pos.numpy(), cp.goal_mask.numpy(), sel_valid)
    _assert_equal(got, want, f"wide {n}")
    _assert_equal(tstep.expand_and_test(cp, torch.as_tensor(contacts), torch.as_tensor(mask),
                                        torch.as_tensor(parents), torch.as_tensor(sel_valid)), want, f"plain {n}")
