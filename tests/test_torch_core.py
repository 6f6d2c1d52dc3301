"""Port core vs the JAX package: the puzzle oracle and the compiled tables.

Every fixture under tests/puzzles is parsed by both packages; the port's
tables must be array-equal to ``pushworld_tpu.core.compiled``'s and its
dynamics identical to ``pushworld_tpu.core.puzzle``'s.
"""

import glob
import os

import numpy as np
import pytest
import torch

import pushworld_tpu.core.compiled as jc
import pushworld_tpu.core.puzzle as jp
import pushworld_tpu_torch.core.compiled as tc
import pushworld_tpu_torch.core.puzzle as tp
from pushworld_tpu_torch.device import resolve_device

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
FIXTURES = sorted(
    os.path.relpath(f, PUZZLES)[:-4]
    for f in glob.glob(os.path.join(PUZZLES, "**", "*.pwp"), recursive=True)
)


def _load_both(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return jp.Puzzle.from_file(path), tp.Puzzle.from_file(path)


def test_fixture_count():
    assert len(FIXTURES) == 32


@pytest.mark.parametrize("name", FIXTURES)
def test_puzzle_and_tables_match_jax(name):
    jpz, tpz = _load_both(name)
    for attr in ("width", "height", "initial_state", "goal_state", "movable_names",
                 "wall_cells", "agent_wall_cells", "movable_cells", "goal_cells",
                 "num_movables", "num_goals"):
        assert getattr(tpz, attr) == getattr(jpz, attr), attr
    assert tc.compute_delta(tpz) == jc.compute_delta(jpz)
    jcp, tcp = jc.compile_puzzle(jpz), tc.compile_puzzle(tpz)
    for f in ("static_block", "push", "init_state", "goal_pos", "obj_mask", "goal_mask"):
        a, b = np.asarray(getattr(jcp, f)), getattr(tcp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (tcp.n, tcp.height, tcp.width, tcp.delta) == (jcp.n, jcp.height, jcp.width, jcp.delta)


@pytest.mark.parametrize("name", ["simple", "multi_goal", "heur/two_tools"])
def test_padded_tables_and_device_copy(name):
    jpz, tpz = _load_both(name)
    pad = (tpz.num_movables + 2, tpz.height + 3, tpz.width + 1, tc.compute_delta(tpz) + 1)
    jcp, tcp = jc.compile_puzzle(jpz, *pad), tc.compile_puzzle(tpz, *pad)
    dev = tcp.to("cpu")
    for f in ("static_block", "push", "init_state", "goal_pos", "obj_mask", "goal_mask"):
        t = getattr(dev, f)
        assert isinstance(t, torch.Tensor)
        assert np.array_equal(np.asarray(getattr(jcp, f)), t.numpy()), f
        assert np.array_equal(getattr(dev.numpy(), f), t.numpy())
    assert dev.num_movables == tpz.num_movables
    with pytest.raises(ValueError):
        tc.compile_puzzle(tpz, n_pad=1)


@pytest.mark.parametrize("name", FIXTURES)
def test_dynamics_and_plan_validity_match_jax(name):
    jpz, tpz = _load_both(name)
    rng = np.random.default_rng(len(name))
    s = tpz.initial_state
    for a in rng.integers(0, 4, size=60).tolist():
        assert tpz.get_next_state(s, a) == jpz.get_next_state(s, a)
        assert tpz.get_pushed_objects(s, a) == jpz.get_pushed_objects(s, a)
        assert tpz.is_goal_state(s) == jpz.is_goal_state(s)
        assert tpz.count_achieved_goals(s) == jpz.count_achieved_goals(s)
        s = tpz.get_next_state(s, a)
    plan = rng.integers(0, 4, size=12).tolist()
    assert tpz.is_valid_plan(plan) == jpz.is_valid_plan(plan)
    assert tpz.apply_plan(plan) == jpz.apply_plan(plan)


@pytest.mark.parametrize(
    "text",
    [
        ". M0 .\n",  # no agent
        "A .\n. . .\n",  # ragged rows
        "A G0 .\n",  # goal without movable
        "\n\n",  # empty
    ],
)
def test_parse_errors_match_jax(text):
    with pytest.raises(ValueError) as je:
        jp.Puzzle.from_text(text)
    with pytest.raises(ValueError) as te:
        tp.Puzzle.from_text(text)
    assert str(te.value) == str(je.value)


def test_plan_strings_round_trip():
    assert tp.plan_to_string([0, 1, 2, 3]) == "LRUD" == jp.plan_to_string([0, 1, 2, 3])
    assert tp.plan_from_string(" lrud\n") == jp.plan_from_string(" lrud\n") == [0, 1, 2, 3]


def test_device_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            tc.compile_puzzle(tp.Puzzle.from_text("A M0 G0\n")).to()


ARRAY_FIELDS = ("static_block", "push", "init_state", "goal_pos", "obj_mask", "goal_mask")


@pytest.mark.parametrize("names", [
    ("simple", "chain", "push_left"),
    ("lshape", "multi_goal", "heur/two_tools", "agent_wall"),
    ("heur/trivial",),
])
def test_compile_batch_and_stack_match_jax(names):
    """A stacked batch: bucket shape, every field, and the copy to a device
    and back, which must keep the leading puzzle axis."""
    pairs = [_load_both(n) for n in names]
    jps, tps = [a for a, _ in pairs], [b for _, b in pairs]
    assert tc.bucket_shape(tps) == jc.bucket_shape(jps)
    jcp, tcp = jc.compile_batch(jps), tc.compile_batch(tps)
    assert (tcp.n, tcp.height, tcp.width, tcp.delta) == (jcp.n, jcp.height, jcp.width, jcp.delta)
    dev = tcp.to("cpu")
    for f in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jcp, f)), getattr(tcp, f)
        assert b.shape[0] == len(names)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert isinstance(getattr(dev, f), torch.Tensor)
        assert np.array_equal(getattr(dev, f).numpy(), a), f
        assert np.array_equal(getattr(dev.numpy(), f), a), f


def test_stack_puzzles_needs_one_bucket_shape():
    _, a = _load_both("simple")
    _, b = _load_both("chain")
    with pytest.raises(ValueError, match="bucket shape"):
        tc.stack_puzzles([tc.compile_puzzle(a), tc.compile_puzzle(b)])
    shape = tc.bucket_shape([a, b])
    stacked = tc.stack_puzzles([tc.compile_puzzle(a, *shape), tc.compile_puzzle(b, *shape)])
    assert stacked.init_state.shape == (2, shape[0], 2)
    # Stacking tensors gives numpy fields again.
    again = tc.stack_puzzles([tc.compile_puzzle(a, *shape).to("cpu"), tc.compile_puzzle(b, *shape).to("cpu")])
    assert np.array_equal(again.push, stacked.push)
