"""Port renderers vs the JAX package: the oracle's pixel renderer
(``Puzzle.render``, goldens included) and the cell renderers of
``ops/render.py`` on states visited by random walks.

Everything compared is an integer, a boolean or a 0/1 float: tolerance 0.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pushworld_tpu.core.puzzle as jp
import pushworld_tpu.ops.render as jr
import pushworld_tpu_torch.core.puzzle as tp
import pushworld_tpu_torch.ops.render as tr
from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu_torch import interop
from pushworld_tpu_torch.core.compiled import compile_puzzle as t_compile

HERE = os.path.dirname(__file__)
PUZZLES = os.path.join(HERE, "puzzles")
FIXTURES = sorted(
    os.path.relpath(f, PUZZLES)[:-4]
    for f in glob.glob(os.path.join(PUZZLES, "**", "*.pwp"), recursive=True)
)
# Renderer fixtures: multi-cell objects (lshape), agent walls, several goals,
# plain movables.
CELL_FIXTURES = ["lshape", "multi_goal", "chain", "agent_wall", "heur/two_tools", "heur/multiple_goals"]


def _load_both(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return jp.Puzzle.from_file(path), tp.Puzzle.from_file(path)


def _walk_states(puzzle, n_walks, n_steps, seed):
    """States visited by seeded random walks of the oracle, (n, N, 2) int32."""
    rng = np.random.default_rng(seed)
    out = [puzzle.initial_state]
    for _ in range(n_walks):
        s = puzzle.initial_state
        for a in rng.integers(0, 4, n_steps).tolist():
            s = puzzle.get_next_state(s, a)
            out.append(s)
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("name", FIXTURES)
def test_puzzle_render_matches_jax(name):
    jpz, tpz = _load_both(name)
    rng = np.random.default_rng(len(name))
    s = tpz.initial_state
    for a in [None] + rng.integers(0, 4, 6).tolist():
        if a is not None:
            s = tpz.get_next_state(s, a)
        got, want = tpz.render(s), jpz.render(s)
        assert got.dtype == np.uint8 and got.shape == (tpz.height * 20, tpz.width * 20, 3)
        assert np.array_equal(got, want)
    assert np.array_equal(tpz.render(s, border_width=1, pixels_per_cell=5),
                          jpz.render(s, border_width=1, pixels_per_cell=5))


@pytest.mark.parametrize("name", ["trivial", "multiple_goals", "transitive_pushing", "trivial_overlap"])
def test_puzzle_render_matches_golden(name):
    """The goldens were rendered by the reference implementation on its own
    fixtures (tests/puzzles/ref), border_width=1, pixels_per_cell=10."""
    tpz = tp.Puzzle.from_file(os.path.join(PUZZLES, "ref", name + ".pwp"))
    golden = np.load(os.path.join(HERE, "goldens", f"render_{name}.npy"))
    img = tpz.render(tpz.initial_state, border_width=1, pixels_per_cell=10)
    assert img.dtype == golden.dtype and np.array_equal(img, golden)


def test_render_plan_and_argument_checks():
    jpz, tpz = _load_both("multi_goal")
    plan = [3, 1, 2, 2, 0]
    got, want = tpz.render_plan(plan, pixels_per_cell=8), jpz.render_plan(plan, pixels_per_cell=8)
    assert len(got) == len(plan) + 1
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError):
        tpz.render(tpz.initial_state, border_width=0)
    with pytest.raises(ValueError):
        tpz.render(tpz.initial_state, border_width=2, pixels_per_cell=4)
    assert (tp.DEFAULT_BORDER_WIDTH, tp.DEFAULT_PIXELS_PER_CELL) == (
        jp.DEFAULT_BORDER_WIDTH, jp.DEFAULT_PIXELS_PER_CELL)
    for attr in ("AGENT", "AGENT_BORDER", "AGENT_WALL", "GOAL", "GOAL_BORDER", "GOAL_OBJECT",
                 "MOVABLE", "MOVABLE_BORDER", "WALL", "WALL_BORDER"):
        assert getattr(tp.Colors, attr) == getattr(jp.Colors, attr)


@pytest.mark.parametrize("name", CELL_FIXTURES)
def test_render_tables_match_jax(name):
    jpz, tpz = _load_both(name)
    want = jr.compile_render_tables(jpz, j_compile(jpz))
    got = tr.compile_render_tables(tpz, t_compile(tpz), device="cpu")
    carried = interop.render_tables_from_numpy(want, device="cpu")
    assert sorted(got) == sorted(want) == sorted(carried)
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k
        assert carried[k].dtype == got[k].dtype and torch.equal(carried[k], got[k]), k
    assert np.array_equal(tr._PALETTE, jr._PALETTE)
    assert (tr.NUM_CHANNELS, tr.C_WALL, tr.C_AGENT_WALL, tr.C_AGENT, tr.C_GOAL_OBJ, tr.C_MOVABLE, tr.C_GOAL) == (
        jr.NUM_CHANNELS, jr.C_WALL, jr.C_AGENT_WALL, jr.C_AGENT, jr.C_GOAL_OBJ, jr.C_MOVABLE, jr.C_GOAL)


@pytest.mark.parametrize("name", CELL_FIXTURES)
def test_cell_renderers_match_jax_on_random_walks(name):
    jpz, tpz = _load_both(name)
    jt = jr.compile_render_tables(jpz, j_compile(jpz))
    tt = tr.compile_render_tables(tpz, t_compile(tpz), device="cpu")
    states = _walk_states(tpz, n_walks=3, n_steps=12, seed=len(name))
    js, ts = jnp.asarray(states), torch.as_tensor(states)

    want_class = np.asarray(jax.vmap(lambda s: jr.render_cells_class(jt, s))(js))
    want_rgb = np.asarray(jax.vmap(lambda s: jr.render_cells_rgb(jt, s))(js))
    want_onehot = np.asarray(jax.vmap(lambda s: jr.render_cells_onehot(jt, s))(js))
    want_batched = np.asarray(jr.render_cells_onehot_batched(jt, js))
    assert np.array_equal(want_batched, want_onehot)  # valid states

    got_class = tr.render_cells_class(tt, ts)
    assert got_class.dtype == torch.int8 and np.array_equal(got_class.numpy(), want_class)
    got_rgb = tr.render_cells_rgb(tt, ts)
    assert got_rgb.dtype == torch.uint8 and np.array_equal(got_rgb.numpy(), want_rgb)
    got_onehot = tr.render_cells_onehot(tt, ts)
    assert got_onehot.dtype == torch.float32 and np.array_equal(got_onehot.numpy(), want_onehot)
    got_batched = tr.render_cells_onehot_batched(tt, ts)
    assert got_batched.dtype == torch.float32 and got_batched.is_contiguous()
    assert got_batched.shape == (len(states), tpz.height, tpz.width, 6)
    assert np.array_equal(got_batched.numpy(), want_batched)
    # One state at a time gives the batch's rows.
    for i in (0, len(states) // 2, len(states) - 1):
        assert torch.equal(tr.render_cells_class(tt, ts[i]), got_class[i])
        assert torch.equal(tr.render_cells_onehot(tt, ts[i]), got_onehot[i])
        assert torch.equal(tr.render_cells_rgb(tt, ts[i]), got_rgb[i])


def test_cells_that_draw_nothing_are_dropped():
    """Padding of the cell lists (lshape's agent has fewer cells than its
    largest object) and cells outside the grid write nowhere: no index leaves
    the tensor, as a CUDA scatter requires."""
    _, tpz = _load_both("lshape")
    tt = tr.compile_render_tables(tpz, t_compile(tpz), device="cpu")
    assert not bool(tt["obj_mask"].all())
    state = torch.as_tensor(np.asarray(tpz.initial_state, np.int32))
    inside = tr.render_cells_class(tt, state)
    far = state.clone()
    far[1] = torch.tensor([tpz.width + 5, -3])  # one movable far outside
    grid = tr.render_cells_class(tt, far)
    onehot = tr.render_cells_onehot_batched(tt, far[None])[0]
    cls = int(tt["obj_class"][1])
    assert int((grid == cls).sum()) < int((inside == cls).sum())
    assert torch.equal(onehot.sum(-1) > 0, grid > 0)
