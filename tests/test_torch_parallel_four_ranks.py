"""The port's parallel layer over FOUR gloo ranks against the JAX package
on four virtual CPU devices (the checks of tests/test_torch_parallel.py,
which runs one and two ranks; a file of its own so that the test runner can
give it a worker of its own).

- ``solve_frontier_sharded`` on the fixtures, equal to JAX's in every count;
- the spill runs of tests/test_frontier_sharded.py:73-124, equal to JAX's
  in every count.  The recency bits of history indices repeat after a
  spill, so frontier keys tie there; JAX's ``approx_min_k`` picks among
  ties in its own order, so its selection is replaced by an exact top-k in
  (key, slot) order, the port's;
- ``no_solution`` is proved unsolvable, and both capacity checks raise
  ``ValueError`` at capacities one rank accepts;
- ``solve_group`` gives JAX's plan and failure reason per puzzle, with six
  lanes in blocks of two, so the last rank owns none;
- the ranks' mesh blocks are ``NamedSharding``'s.
"""

import os

import pytest

from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.parallel.frontier_sharded import solve_frontier_sharded
from pushworld_tpu_torch.parallel.mesh import make_mesh
from test_torch_parallel import (
    ERRORS,
    FIXTURES,
    FS_KW,
    PUZZLES,
    SPILL,
    _assert_equal_runs,
    _jax_frontier,
    _port,
    check_blocks,
    check_fixture,
    check_group,
    jax_group,
    launch_ranks,
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    yield from launch_ranks(tmp_path_factory, (4,))


@pytest.mark.parametrize("name", FIXTURES)
def test_frontier_sharded_matches_jax_on_four_ranks(ranks, monkeypatch, name):
    check_fixture(ranks, monkeypatch, name, 4)


@pytest.mark.parametrize("name", list(SPILL))
def test_spill_runs_match_jax(ranks, monkeypatch, name):
    jax_run = _jax_frontier(monkeypatch, name, 4, SPILL[name], exact_top_k=True)
    port = _port(ranks, 4, {"kind": "frontier", "puzzle": name, "kwargs": SPILL[name]})
    _assert_equal_runs(port, jax_run, name, 4)
    if name == "spill_grid":
        assert port["plan"] and port["stats"]["spill_epochs"] >= 1
    else:
        assert port["plan"] is None and port["stats"]["spill_epochs"] >= 2
        # The cursor restarts at 1 after a spill, so the recency bits of new
        # keys repeat an earlier epoch's: here keys tie after the second.
        assert port["ties"]


def test_no_solution_is_none(ranks):
    port = _port(ranks, 4, {"kind": "frontier", "puzzle": "no_solution", "kwargs": FS_KW})
    assert port["plan"] is None and port["stats"]["chunks"] >= 1


@pytest.mark.parametrize("kw", ERRORS, ids=["frontier_capacity", "history_capacity"])
def test_capacity_value_errors(ranks, kw):
    assert _port(ranks, 4, {"kind": "frontier", "puzzle": "chain", "kwargs": kw}) == {"raises": "ValueError"}
    # One rank accepts both capacities.
    p = Puzzle.from_file(os.path.join(PUZZLES, "chain.pwp"))
    assert solve_frontier_sharded(p, mesh=make_mesh(device="cpu", axis_name="shard"), **kw)


def test_solve_group_matches_jax_on_four_ranks(ranks, jax_group):
    check_group(ranks, jax_group, 4)


def test_mesh_blocks_match_named_sharding_on_four_ranks(ranks):
    check_blocks(ranks, 4)
