"""Movement-graph distances: host helpers and the plain PyTorch wavefront.

Port of the parts of the JAX package's ``ops/graphs.py`` that the table
builder needs:

- :func:`host_vertex_mask`, :func:`host_graph_distances_compact` (scipy BFS)
  and :func:`host_distance_to_targets` (host BFS): the host references;
- :func:`distance_fields_reference`: the wavefront relaxation of
  ``graphs.distance_to_targets`` (graphs.py:313-329) over a batch of fields,
  the plain version of the CUDA kernel in ``kernels/wavefront.cu``
  (see :mod:`pushworld_tpu_torch.ops.graphs_cuda`).

Distances replace the reference's lazy incremental BFS objects
(reference: cpp/src/heuristics/domain_transition_graph.cc:218-300).
Unreachable = INF (1e9).
"""

import numpy as np
import torch
import torch.nn.functional as F

# Displacements indexed by action: (dx, dy).
DISPLACEMENTS = ((-1, 0), (1, 0), (0, -1), (0, 1))

INF = 1e9


def host_vertex_mask(E_o: np.ndarray, init_flat: int) -> np.ndarray:
    """Vertex set of one object's movement graph: cells incident to at
    least one feasible transition (as source or target), plus the object's
    initial cell (an object parked where it can never move again still has
    a position the search can observe).

    Every position the RGD kernels ever look up a graph distance for is in
    this set: distance gathers are masked by transition feasibility
    (contact cells are sources, pusher-next cells are targets), and state
    positions are reachable only through feasible transitions from the
    initial position.  This is what makes the compact distance tables of
    :func:`host_graph_distances_compact` lossless (VERDICT round 1, task 3;
    reference analog: the lazy per-position ``PathDistances`` objects of
    domain_transition_graph.cc:266-300 never materialize all HW^2 pairs
    either).

    Args:
        E_o: bool (4, H, W) — feasible transitions of one object.
        init_flat: the object's initial cell as a flat y*W+x index.

    Returns:
        bool (H*W,) vertex mask.
    """
    E_o = np.asarray(E_o)
    H, W = E_o.shape[-2:]
    v = np.zeros((H, W), bool)
    for a, (dx, dy) in enumerate(DISPLACEMENTS):
        src = E_o[a].astype(bool)
        v |= src
        ys, xs = np.nonzero(src)
        ty, tx = ys + dy, xs + dx
        ok = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
        v[ty[ok], tx[ok]] = True
    v = v.reshape(-1)
    v[init_flat] = True
    return v


def host_graph_distances_compact(
    E_o: np.ndarray, verts: np.ndarray
) -> np.ndarray:
    """All-pairs distances restricted to the graph's vertex set.

    Args:
        E_o: bool (4, H, W) — feasible transitions of one object.
        verts: int (R,) flat cell indices (from :func:`host_vertex_mask`).

    Returns:
        float32 (R, R) with D[i, j] = dist(verts[i] -> verts[j]);
        unreachable pairs = INF (1e9).
    """
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    E_o = np.asarray(E_o)
    H, W = E_o.shape[-2:]
    HW = H * W
    R = len(verts)
    inv = np.full((HW,), -1, np.int64)
    inv[verts] = np.arange(R)

    rows = []
    cols = []
    for a, (dx, dy) in enumerate(DISPLACEMENTS):
        ys, xs = np.nonzero(E_o[a])
        ok = (xs + dx >= 0) & (xs + dx < W) & (ys + dy >= 0) & (ys + dy < H)
        src = inv[(ys[ok]) * W + xs[ok]]
        dst = inv[(ys[ok] + dy) * W + (xs[ok] + dx)]
        rows.append(src)
        cols.append(dst)
    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)

    out = np.full((R, R), float(INF), np.float32)
    np.fill_diagonal(out, 0.0)
    if len(rows) == 0 or R == 0:
        return out
    adj = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(R, R))
    d = csgraph.shortest_path(adj, method="D", unweighted=True)
    return np.where(np.isfinite(d), d, float(INF)).astype(np.float32)


def host_distance_to_targets(E_o: np.ndarray, target_flat: int) -> np.ndarray:
    """(H, W) float32 field of graph distances from every position to one
    target (host BFS over reversed edges)."""
    from collections import deque

    E_o = np.asarray(E_o)
    H, W = E_o.shape[-2:]
    # Reversed adjacency: target <- p for each edge p -> p + d_a.
    pred = [[] for _ in range(H * W)]
    for a, (dx, dy) in enumerate(DISPLACEMENTS):
        ys, xs = np.nonzero(E_o[a])
        for y, x in zip(ys, xs):
            tx, ty = x + dx, y + dy
            if 0 <= tx < W and 0 <= ty < H:
                pred[ty * W + tx].append(y * W + x)
    dist = np.full((H * W,), float(INF), np.float32)
    dist[target_flat] = 0.0
    q = deque([target_flat])
    while q:
        t = q.popleft()
        for p in pred[t]:
            if dist[p] >= float(INF):
                dist[p] = dist[t] + 1.0
                q.append(p)
    return dist.reshape(H, W)


def distance_fields_reference(
    E: torch.Tensor, d0: torch.Tensor, max_iters: int = 0
) -> torch.Tensor:
    """Batched wavefront distance fields, plain PyTorch.

    Args:
        E: (B, 4, H, W) or (1, 4, H, W) bool — feasible transitions per field
            (one stack shared by all fields when its batch is 1).
        d0: (B, H, W) float32 — seed field (0 at targets, INF elsewhere).
        max_iters: relaxation cap; 0 -> H*W + 8 (the diameter bound).

    Returns:
        (B, H, W) float32, ``d[p]`` = graph distance from p to the seeds
        along edges p -> p + d_a present iff E[a, p]; unreachable = INF.
    """
    B, H, W = d0.shape
    cap = int(max_iters) if max_iters else H * W + 8
    E = E.to(torch.bool)
    d = d0.to(torch.float32)
    inf = torch.full((), INF, dtype=torch.float32, device=d.device)
    for _ in range(cap):
        # out-of-grid neighbours read INF
        dp = F.pad(d, (1, 1, 1, 1), value=INF)
        best = d
        for a, (dx, dy) in enumerate(DISPLACEMENTS):
            nb = dp[:, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            best = torch.minimum(best, torch.where(E[:, a], nb + 1.0, inf))
        changed = bool((best != d).any())
        d = best
        if not changed:
            break
    return d
