"""The port's parallel layer against the JAX package's, on the CPU.

The port's ranks are processes of their own (``torch_ranks``: gloo over a
FileStore, one thread each); the JAX side runs in this process on a mesh of
the same number of virtual CPU devices (tests/conftest.py gives 8).  All
rank runs start together when the first test asks for them, and each test
computes its JAX result while they work.

- ``solve_frontier_sharded`` over D = 1 and 2 ranks (4 ranks:
  tests/test_torch_parallel_four_ranks.py, with the spill runs) against
  JAX's on a ("shard",) mesh of D devices, with the parameters of
  tests/test_frontier_sharded.py: plans, chunk counts, spill epochs, every
  chunk's status and every shard's iterations and expansions are EQUAL.
  Where frontier keys tie (the spill runs), JAX's selection is replaced by
  an exact top-k in (key, slot) order, the port's order, and the runs are
  still equal in every count.
- ``solve_group`` over 1 and 2 ranks (4 ranks, where the six lanes leave
  the last rank none: tests/test_torch_parallel_four_ranks.py) against
  JAX's on the 8-device mesh (tests/test_sharded.py's parameters): the same
  plan and failure reason per puzzle (times differ).
- ``make_mesh`` / ``make_mesh_2d`` / ``shard_leading``: each rank's block is
  the one ``NamedSharding`` puts on the device at the rank's place.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pushworld_tpu.parallel.frontier_sharded as jfs
import pushworld_tpu.search.batched as jbatched
import torch_ranks
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.parallel import mesh as jmesh
from pushworld_tpu.parallel.sharded import solve_group as j_solve_group
from pushworld_tpu_torch.core.puzzle import Puzzle

PUZZLES = torch_ranks.PUZZLES
FS_KW = dict(time_limit=120.0, expand=16, frontier_capacity=1 << 10, visited_bits=14,
             history_capacity=1 << 14, chunk=8)
FIXTURES = ["simple", "chain", "push_left", "multi_goal", "heur/easy_search"]
# tests/test_frontier_sharded.py:73-124: a history barely above the spill
# margin (8 * expand * D) forces spill epochs.
SPILL = {
    "spill_grid": dict(time_limit=240.0, expand=4, frontier_capacity=1 << 13, visited_bits=14,
                       history_capacity=160, chunk=4),
    "spill_grid_unreachable": dict(time_limit=240.0, expand=8, frontier_capacity=1 << 13,
                                   visited_bits=14, history_capacity=1 << 9, chunk=8),
}
GROUP = ["simple", "chain", "push_left", "multi_goal", "lshape", "no_solution"]
GROUP_KW = dict(time_limit=300, expand=16, frontier_capacity=1 << 8, visited_bits=12,
                history_capacity=1 << 12, chunk=8)
BLOCK_ROWS = 8
# At D = 4: frontier 2**10 < 8 * 64 * 4, and 4 * 2**23 = 2**25.
ERRORS = [dict(FS_KW, expand=64), dict(FS_KW, history_capacity=1 << 23)]


def _jobs(D):
    jobs = [{"kind": "frontier", "puzzle": n, "kwargs": FS_KW} for n in FIXTURES]
    jobs.append({"kind": "blocks", "rows": BLOCK_ROWS})
    jobs.append({"kind": "group", "names": GROUP, "kwargs": GROUP_KW})
    if D == 4:
        jobs += [{"kind": "frontier", "puzzle": n, "kwargs": kw} for n, kw in SPILL.items()]
        jobs.append({"kind": "frontier", "puzzle": "no_solution", "kwargs": FS_KW})
        jobs += [{"kind": "frontier", "puzzle": "chain", "kwargs": kw} for kw in ERRORS]
    return jobs


def launch_ranks(tmp_path_factory, worlds):
    """Starts the rank runs of ``worlds`` together; kills what is left of
    them at the end."""
    tmp = tmp_path_factory.mktemp("parallel")
    runs = {D: torch_ranks.launch(tmp, D, _jobs(D)) for D in worlds}
    yield runs
    for run in runs.values():
        run.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    yield from launch_ranks(tmp_path_factory, (1, 2))


def _port(ranks, D, job):
    """The result of ``job`` (an entry of ``_jobs(D)``): every rank's must be
    the same, and no rank may have imported JAX.  ``ties`` (of a frontier
    job) is the union over the ranks."""
    per_rank = ranks[D].result(_jobs(D).index(job))
    ties = set()
    first = {k: v for k, v in per_rank[0].items() if k != "ties"}
    for r in per_rank:
        ties.update(r.get("ties", []))
        assert {k: v for k, v in r.items() if k != "ties"} == first, f"ranks disagree on {job}"
    assert first.pop("jax") is False
    if "trace" in first:
        first["ties"] = sorted(ties)
    return first


def _exact_select_frontier(s, B):
    """JAX's ``_select_frontier`` with an exact top-k in ascending (key,
    slot) order in place of ``approx_min_k``: the port's selection."""
    idx = jax.numpy.argsort(s.frontier_h, stable=True)[:B]
    sel_valid = s.frontier_h[idx] < jbatched.EMPTY
    frontier_h = s.frontier_h.at[idx].set(jax.numpy.where(sel_valid, jbatched.EMPTY, s.frontier_h[idx]))
    return s.frontier_states[idx], s.frontier_hist[idx], sel_valid, frontier_h


def _jax_frontier(monkeypatch, name, D, kw, exact_top_k=False):
    """JAX's plan and stats, each shard's iterations and expansions as its
    last status read saw them, and the trace of the status reads in the
    port's form.  ``exact_top_k`` selects the frontier in the port's order
    (``_exact_select_frontier``)."""
    seen = {"trace": []}
    status = jfs._packed_status
    if exact_top_k:
        monkeypatch.setattr(jfs, "_select_frontier", _exact_select_frontier)

    def spy(states):
        seen["iterations"] = np.asarray(states.iterations).tolist()
        seen["expansions"] = np.asarray(states.expansions).tolist()
        out = status(states)
        solved, hmin, cur_max, evictions = np.asarray(out).tolist()
        seen["trace"].append([solved, hmin, cur_max, int(evictions == 0)])
        return out

    monkeypatch.setattr(jfs, "_packed_status", spy)
    stats = {}
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    p = JPuzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    plan = jfs.solve_frontier_sharded(p, mesh=mesh, stats_out=stats, **kw)
    return plan, stats, seen


def _assert_equal_runs(port, jax_run, name, D):
    """The two runs are equal in every count."""
    plan, stats, seen = jax_run
    assert port["trace"] == seen["trace"], (name, D)
    assert port["plan"] == plan, (name, D)
    assert port["stats"]["chunks"] == stats["chunks"], (name, D)
    assert port["stats"]["spill_epochs"] == stats["spill_epochs"], (name, D)
    assert port["stats"]["shard_iterations"] == seen["iterations"], (name, D)
    assert port["stats"]["shard_expansions"] == seen["expansions"], (name, D)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("name", FIXTURES)
def test_frontier_sharded_matches_jax(ranks, monkeypatch, name, D):
    check_fixture(ranks, monkeypatch, name, D)


def check_fixture(ranks, monkeypatch, name, D):
    """No selection of these runs meets tied keys, so JAX's own selection
    is the reference."""
    jax_run = _jax_frontier(monkeypatch, name, D, FS_KW)
    assert jax_run[0] and Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp")).is_valid_plan(jax_run[0])
    port = _port(ranks, D, {"kind": "frontier", "puzzle": name, "kwargs": FS_KW})
    assert not port["ties"], (name, D)
    _assert_equal_runs(port, jax_run, name, D)


def test_jax_picks_among_tied_keys_in_no_fixed_order():
    """Why the spill runs replace JAX's selection: with equal keys, JAX's
    ``approx_min_k`` returns neither the lowest slots nor the highest, while
    the port's selection and ``_exact_select_frontier`` are (key, slot)
    order."""
    from pushworld_tpu_torch.search.batched import EMPTY, _select_frontier

    rng = np.random.default_rng(0)
    F, B = 1 << 13, 8
    keys = (rng.integers(0, 40, size=F) + (1 << 28)).astype(np.int32)
    keys[rng.random(F) < 0.5] = EMPTY
    _, idx = jax.lax.approx_min_k(jax.lax.bitcast_convert_type(jax.numpy.asarray(keys), np.float32), B)
    idx = np.asarray(idx)
    ties = np.flatnonzero(keys == keys.min())
    assert len(ties) > B and set(idx) <= set(ties.tolist())
    assert idx.tolist() != ties[:B].tolist() and idx.tolist() != ties[::-1][:B].tolist()

    class Frontier:
        frontier_h = torch.tensor(keys)
        frontier_states = torch.zeros((F, 1, 2), dtype=torch.int32)
        frontier_hist = torch.arange(F, dtype=torch.int32)

    _, hist, _ = _select_frontier(Frontier, B)
    assert hist.tolist() == ties[:B].tolist()
    exact = SimpleNamespace(frontier_h=jax.numpy.asarray(keys), frontier_states=jax.numpy.zeros((F, 1, 2), np.int32),
                            frontier_hist=jax.numpy.arange(F, dtype=np.int32))
    _, jhist, _, _ = _exact_select_frontier(exact, B)
    assert np.asarray(jhist).tolist() == ties[:B].tolist()


@pytest.fixture(scope="module")
def jax_group():
    named = [(n, JPuzzle.from_file(os.path.join(PUZZLES, n + ".pwp"))) for n in GROUP]
    res = j_solve_group(named, mesh=jmesh.make_mesh(), **GROUP_KW)
    return {n: [r.plan, r.failure_reason] for n, r in res.items()}


@pytest.mark.parametrize("D", [1, 2])
def test_solve_group_matches_jax(ranks, jax_group, D):
    check_group(ranks, jax_group, D)


def check_group(ranks, jax_group, D):
    assert len(jax.devices()) == 8
    port = _port(ranks, D, {"kind": "group", "names": GROUP, "kwargs": GROUP_KW})
    assert port == jax_group
    assert port["no_solution"] == [None, "no solution"]


@pytest.mark.parametrize("D", [1, 2])
def test_mesh_blocks_match_named_sharding(ranks, D):
    check_blocks(ranks, D)


def check_blocks(ranks, D):
    x = np.arange(BLOCK_ROWS * 3).reshape(BLOCK_ROWS, 3)
    devices = jax.devices()[:D]
    m1 = jmesh.make_mesh(devices)
    m2 = jmesh.make_mesh_2d(*torch_ranks.mesh_2d_shape(D), devices)
    on1 = {s.device: np.asarray(s.data).tolist() for s in jmesh.shard_leading(m1, x).addressable_shards}
    on2 = {s.device: np.asarray(s.data).tolist()
           for s in jmesh.shard_leading(m2, {"x": x})["x"].addressable_shards}
    per_rank = ranks[D].result(_jobs(D).index({"kind": "blocks", "rows": BLOCK_ROWS}))
    for r, got in enumerate(per_rank):
        assert got["jax"] is False
        assert got["1d"] == on1[m1.devices.flat[r]]
        # Rank r sits where device r sits in JAX's row-major device array.
        assert tuple(got["coord"]) == tuple(int(c) for c in np.argwhere(m2.devices == devices[r])[0])
        assert got["2d"] == on2[m2.devices.flat[r]]


def test_entry_points_default_to_the_card():
    from pushworld_tpu_torch.parallel.frontier_sharded import solve_frontier_sharded
    from pushworld_tpu_torch.parallel.mesh import make_local_mesh, make_mesh, make_mesh_2d
    from pushworld_tpu_torch.parallel.sharded import solve_group

    p = Puzzle.from_file(os.path.join(PUZZLES, "chain.pwp"))
    if not torch.cuda.is_available():
        for call in (make_mesh, make_local_mesh, lambda: make_mesh_2d(1, 1),
                     lambda: solve_frontier_sharded(p), lambda: solve_group([("chain", p)])):
            with pytest.raises(RuntimeError, match="cuda"):
                call()


def test_new_modules_do_not_import_jax():
    """A fresh interpreter imports every module of the parallel layer, the
    entry module and the benchmark script, and JAX stays out."""
    code = (
        "import sys\n"
        "import pushworld_tpu_torch.parallel.mesh, pushworld_tpu_torch.parallel.sharded\n"
        "import pushworld_tpu_torch.parallel.frontier_sharded\n"
        "import pushworld_tpu_torch.parallel.distributed, pushworld_tpu_torch.entry\n"
        "import pushworld_tpu_torch.scripts.benchmark_distributed\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('pushworld_tpu.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=torch_ranks.REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
