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
