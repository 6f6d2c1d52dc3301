"""Port wavefront fields vs the JAX package's Pallas kernel (interpret mode,
as tests/test_graphs_pallas.py runs it), the XLA wavefront and the host BFS.

On the CPU ``graphs_cuda.distance_fields`` runs its plain version
(``graphs.distance_fields_reference``); fields are small integers in float32
and must be bit-equal (tolerance 0).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.ops import graphs as jg
from pushworld_tpu.ops.graphs_pallas import distance_fields_pallas
from pushworld_tpu_torch.ops import graphs as tg
from pushworld_tpu_torch.ops import graphs_cuda
from pushworld_tpu_torch.ops.graphs import INF, distance_fields_reference

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")


def _seeds(rng, B, H, W):
    d0 = np.full((B, H, W), INF, np.float32)
    for b in range(B):
        d0[b, rng.integers(0, H), rng.integers(0, W)] = 0.0
    return d0


@pytest.mark.parametrize("shape", [(5, 9, 10), (3, 11, 13), (2, 1, 7)])
def test_reference_matches_pallas_interpret(shape):
    rng = np.random.default_rng(sum(shape))
    B, H, W = shape
    E = rng.random((B, 4, H, W)) < 0.55
    d0 = _seeds(rng, B, H, W)
    want = np.asarray(distance_fields_pallas(jnp.asarray(E), jnp.asarray(d0), interpret=True))
    got = distance_fields_reference(torch.as_tensor(E), torch.as_tensor(d0))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(graphs_cuda.distance_fields(torch.as_tensor(E), torch.as_tensor(d0)).numpy(), want)


def test_shared_masks_and_iteration_cap_match_pallas():
    rng = np.random.default_rng(11)
    B, H, W = 6, 8, 9
    E1 = rng.random((1, 4, H, W)) < 0.6
    d0 = _seeds(rng, B, H, W)
    full = np.asarray(distance_fields_pallas(jnp.asarray(np.repeat(E1, B, 0)), jnp.asarray(d0), interpret=True))
    got = graphs_cuda.distance_fields(torch.as_tensor(E1), torch.as_tensor(d0))
    assert np.array_equal(got.numpy(), full)
    for cap in (1, 3):
        want = np.asarray(distance_fields_pallas(
            jnp.asarray(np.repeat(E1, B, 0)), jnp.asarray(d0), max_iters=cap, interpret=True))
        got = graphs_cuda.distance_fields(torch.as_tensor(E1), torch.as_tensor(d0), max_iters=cap)
        assert np.array_equal(got.numpy(), want), cap


def test_unreachable_stays_inf_and_bad_shapes_raise():
    E = torch.zeros((4, 8, 8), dtype=torch.bool)
    targets = torch.zeros((8, 8), dtype=torch.bool)
    targets[4, 4] = True
    got = graphs_cuda.distance_to_targets(E, targets)
    assert got[4, 4] == 0.0
    assert int((got == INF).sum()) == 63
    with pytest.raises(ValueError):
        graphs_cuda.distance_fields(torch.zeros((2, 4, 3, 3), dtype=torch.bool), torch.zeros((3, 3, 3)))


@pytest.mark.parametrize(
    "name", ["trivial_tool", "transitive_pushing", "multiple_goals", "two_tools", "three_tools"]
)
def test_fields_and_host_helpers_match_jax_on_fixtures(name):
    path = os.path.join(PUZZLES, "heur", name + ".pwp")
    jp = JPuzzle.from_file(path)
    cp = j_compile(jp)
    E, _ = jg.build_reachability(cp)
    E = np.asarray(E)
    W = cp.width
    for o in range(jp.num_movables):
        init_flat = int(cp.init_state[o, 1]) * W + int(cp.init_state[o, 0])
        want = jg.host_distance_to_targets(E[:, o], init_flat)
        assert np.array_equal(tg.host_distance_to_targets(E[:, o], init_flat), want)
        targets = torch.zeros((cp.height, W), dtype=torch.bool)
        targets[init_flat // W, init_flat % W] = True
        got = graphs_cuda.distance_to_targets(torch.as_tensor(E[:, o].copy()), targets)
        assert np.array_equal(got.numpy(), want)

        vm = tg.host_vertex_mask(E[:, o], init_flat)
        assert np.array_equal(vm, jg.host_vertex_mask(E[:, o], init_flat))
        verts = np.nonzero(vm)[0]
        Dc = tg.host_graph_distances_compact(E[:, o], verts)
        assert np.array_equal(Dc, jg.host_graph_distances_compact(E[:, o], verts))
        # Column j of the compact block is the wavefront field seeded at verts[j].
        d0 = np.full((len(verts), cp.height * W), INF, np.float32)
        d0[np.arange(len(verts)), verts] = 0.0
        fields = graphs_cuda.distance_fields(
            torch.as_tensor(E[None, :, o].copy()), torch.as_tensor(d0.reshape(-1, cp.height, W))
        )
        assert np.array_equal(fields.reshape(len(verts), -1)[:, verts].T.numpy(), Dc)


@pytest.mark.parametrize("cap", [1, 2, 5, 9])
@pytest.mark.parametrize("name", ["two_tools", "three_tools"])
def test_capped_sweeps_on_zero_inf_seeds_are_capped_bfs(name, cap):
    """With 0/INF seeds, ``cap`` Jacobi sweeps give the breadth-first distance
    where it is <= cap and INF elsewhere: the property that lets the CUDA
    kernel run a level-synchronous search for such fields."""
    jp = JPuzzle.from_file(os.path.join(PUZZLES, "heur", name + ".pwp"))
    cp = j_compile(jp)
    E = np.asarray(jg.build_reachability(cp)[0])
    H, W = cp.height, cp.width
    deepest = 0.0
    for o in range(jp.num_movables):
        target = int(cp.init_state[o, 1]) * W + int(cp.init_state[o, 0])
        bfs = tg.host_distance_to_targets(E[:, o], target)
        deepest = max(deepest, float(bfs[bfs < INF].max()))
        d0 = np.full((1, H * W), INF, np.float32)
        d0[0, target] = 0.0
        got = distance_fields_reference(
            torch.as_tensor(E[None, :, o].copy()), torch.as_tensor(d0.reshape(1, H, W)), max_iters=cap)
        want = np.where(bfs <= cap, bfs, np.float32(INF))
        assert np.array_equal(got[0].numpy(), want)
    assert deepest > 2  # the caps of 1 and 2 do cut a field short


def test_general_seeds_match_pallas_interpret():
    """Seeds other than 0/INF (the CUDA kernel's float-sweep path) through the
    plain version and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(21)
    B, H, W = 4, 9, 11
    E = rng.random((B, 4, H, W)) < 0.6
    d0 = np.where(rng.random((B, H, W)) < 0.1, rng.integers(0, 12, (B, H, W)), INF).astype(np.float32)
    for cap in (0, 2):
        want = np.asarray(distance_fields_pallas(jnp.asarray(E), jnp.asarray(d0), max_iters=cap, interpret=True))
        got = graphs_cuda.distance_fields(torch.as_tensor(E), torch.as_tensor(d0), max_iters=cap)
        assert np.array_equal(got.numpy(), want), cap


# ------------------------------------------------------- the device graph ops

from pushworld_tpu_torch.core.compiled import compile_puzzle as t_compile  # noqa: E402
from pushworld_tpu_torch.core.puzzle import Puzzle as TPuzzle  # noqa: E402

# tests/test_graphs.py's HEUR_FIXTURES.
HEUR_FIXTURES = [
    "trivial", "trivial_tool", "trivial_tool2", "multiple_goals", "transitive_pushing",
    "necessary_transitive_pushing1", "necessary_transitive_pushing2",
    "blocked_transitive_pushing1", "blocked_transitive_pushing2", "shortest_path_tool",
]


def _jax_reachability(name):
    path = os.path.join(PUZZLES, "heur", name + ".pwp")
    cp = j_compile(JPuzzle.from_file(path))
    E, reached = jg.build_reachability(cp)
    return path, cp, np.asarray(E), np.asarray(reached)


@pytest.mark.parametrize("name", HEUR_FIXTURES)
def test_build_reachability_matches_jax(name):
    path, _, E_want, reached_want = _jax_reachability(name)
    stats = {}
    E, reached = tg.build_reachability(t_compile(TPuzzle.from_file(path)), device="cpu", stats_out=stats)
    assert E.dtype == torch.bool and reached.dtype == torch.bool
    assert np.array_equal(E.numpy(), E_want)
    assert np.array_equal(reached.numpy(), reached_want)
    assert 1 <= stats["iterations"] < 512
    # The fixpoint is also the host worklist's (what the table build uses).
    from pushworld_tpu_torch.ops.rgd import _movement_graphs_python

    tpz = TPuzzle.from_file(path)
    assert np.array_equal(_movement_graphs_python(tpz, t_compile(tpz)), E_want)


def test_build_reachability_iteration_cap_matches_jax():
    path, cp, E_full, _ = _jax_reachability("shortest_path_tool")
    E2, r2 = jg.build_reachability(cp, max_iters=2)
    stats = {}
    E, reached = tg.build_reachability(
        t_compile(TPuzzle.from_file(path)).to("cpu"), max_iters=2, device="cpu", stats_out=stats)
    assert stats["iterations"] == 2
    assert np.array_equal(E.numpy(), np.asarray(E2)) and np.array_equal(reached.numpy(), np.asarray(r2))
    assert not np.array_equal(np.asarray(E2), E_full)  # the cap did cut it short


@pytest.mark.parametrize("shift", [(1, 0), (-1, 0), (0, 1), (0, -1), (2, -1), (0, 0)])
def test_shift2d_matches_jax(shift):
    rng = np.random.default_rng(3)
    x = rng.random((2, 5, 7)) < 0.5
    dx, dy = shift
    want = np.asarray(jg._shift2d(jnp.asarray(x), dx, dy))
    assert np.array_equal(tg._shift2d(torch.as_tensor(x), dx, dy).numpy(), want)
    xf = rng.random((5, 7)).astype(np.float32)
    want = np.asarray(jg._shift2d(jnp.asarray(xf), dx, dy, fill=INF))
    assert np.array_equal(tg._shift2d(torch.as_tensor(xf), dx, dy, fill=INF).numpy(), want)


@pytest.mark.parametrize("name", ["trivial", "trivial_tool", "shortest_path_tool"])
def test_distance_to_targets_and_all_pairs_match_jax(name):
    _, cp, E, _ = _jax_reachability(name)
    H, W = cp.height, cp.width
    for o in range(int(np.asarray(cp.obj_mask).sum())):
        E_o = E[:, o].copy()
        want = np.asarray(jg.all_pairs_distances(jnp.asarray(E_o)))
        got = tg.all_pairs_distances(torch.as_tensor(E_o))
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert np.array_equal(got.numpy(), want)
        targets = np.zeros((H, W), bool)
        targets[int(cp.init_state[o, 1]), int(cp.init_state[o, 0])] = True
        targets[H // 2, W // 2] = True
        want = np.asarray(jg.distance_to_targets(jnp.asarray(E_o), jnp.asarray(targets)))
        got = graphs_cuda.distance_to_targets(torch.as_tensor(E_o), torch.as_tensor(targets))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [0, 1, 3])
def test_distance_to_targets_cap_matches_jax(cap):
    """``max_iters`` cuts the relaxation short exactly as in the JAX function
    (cap = min(max_iters, H * W + 8); 0 leaves the seeds)."""
    _, cp, E, _ = _jax_reachability("shortest_path_tool")
    E_o = E[:, 0].copy()
    targets = np.zeros((cp.height, cp.width), bool)
    targets[int(cp.init_state[0, 1]), int(cp.init_state[0, 0])] = True
    full = np.asarray(jg.distance_to_targets(jnp.asarray(E_o), jnp.asarray(targets)))
    want = np.asarray(jg.distance_to_targets(jnp.asarray(E_o), jnp.asarray(targets), max_iters=cap))
    got = graphs_cuda.distance_to_targets(torch.as_tensor(E_o), torch.as_tensor(targets), max_iters=cap)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, full)
    # Beyond the diameter bound the cap changes nothing.
    huge = graphs_cuda.distance_to_targets(torch.as_tensor(E_o), torch.as_tensor(targets), max_iters=10**6)
    assert np.array_equal(huge.numpy(), full)
