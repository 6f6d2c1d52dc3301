"""Feasible-movement reachability and graph distances on tensors.

Port of the JAX package's ``ops/graphs.py``:

- :func:`build_reachability`: the mutual fixpoint "object o can make move
  (p -> p+d_a) iff p is reachable, the move is not statically blocked, and
  some other object has a feasible transition that pushes o" as a Jacobi
  iteration over dense boolean tensors.  The pusher-support term is a 2-D
  convolution (``F.conv2d``): transitions ``E[q, a]`` are the input
  channels and the pairwise push tables the (pushee, pusher, K, K) kernels;
- :func:`all_pairs_distances`: every target's distance field of one
  object's movement graph, through the wavefront kernel
  (:func:`pushworld_tpu_torch.ops.graphs_cuda.distance_fields`);
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

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pushworld_tpu_torch.device import DeviceLike

# Displacements indexed by action: (dx, dy).
DISPLACEMENTS = ((-1, 0), (1, 0), (0, -1), (0, 1))

INF = 1e9


def _shift2d(x: torch.Tensor, dx: int, dy: int, fill=False) -> torch.Tensor:
    """Shifts the last two axes (y, x) of ``x`` so that
    out[..., y, x] = x[..., y + dy, x + dx] (out-of-range -> fill)."""
    H, W = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    ys, yd = (slice(dy, H), slice(0, H - dy)) if dy >= 0 else (slice(0, H + dy), slice(-dy, H))
    xs, xd = (slice(dx, W), slice(0, W - dx)) if dx >= 0 else (slice(0, W + dx), slice(-dx, W))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def build_reachability(
    cp, max_iters: int = 512, device: DeviceLike = "cuda", stats_out: Optional[dict] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Computes the feasible-movement fixpoint of one (unstacked) compiled
    puzzle on ``device``.

    Returns:
        E: bool (4, N, H, W) — E[a, o, y, x]: the transition of object o at
           (x, y) one cell in direction a is feasible.
        reached: bool (N, H, W) — position is reachable for the object.

    The loop ends when an iteration changes nothing, which the host reads
    from the device once per iteration (a one-time build), or after
    ``max_iters`` iterations.  ``stats_out["iterations"]`` receives the count.

    The convolution's operands are 0/1 and its sums small integers, exact in
    float32 and in TF32 alike; only ``> 0.5`` is read from them.
    """
    cp = cp.to(device)
    N, H, W = cp.n, cp.height, cp.width
    dev = cp.static_block.device
    sb = cp.static_block  # (4, N, H, W)
    delta = cp.delta
    obj_mask = cp.obj_mask

    init_onehot = torch.zeros((N, H, W), dtype=torch.bool, device=dev)
    init_onehot[torch.arange(N, device=dev), cp.init_state[:, 1].long(), cp.init_state[:, 0].long()] = obj_mask

    # Conv kernels: for each action a, kernel[o, q, ky, kx] = push[a, q, o,
    # ky, kx], the pusher q sitting at pushee_pos + (kx - delta, ky - delta).
    # pushed_support[a, o, p] = OR_{q, rel} push[a, q, o, rel] & E[a, q, p+rel]
    # is a cross-correlation, which is what F.conv2d computes:
    # out[o, y, x] = sum_{q, ky, kx} in[q, y + ky - delta, x + kx - delta] * w[o, q, ky, kx].
    # The four actions are the four groups of one grouped convolution.
    K = cp.push.shape[-1]
    kernels = cp.push.permute(0, 2, 1, 3, 4).reshape(4 * N, N, K, K).to(torch.float32)

    E = torch.zeros((4, N, H, W), dtype=torch.bool, device=dev)
    reached = init_onehot
    iterations = 0
    while iterations < max_iters:
        support = F.conv2d(
            E.reshape(1, 4 * N, H, W).to(torch.float32), kernels, padding=delta, groups=4
        ).reshape(4, N, H, W) > 0.5
        support[:, 0] = True  # the agent (object 0) needs no pusher
        E_new = reached[None] & ~sb & support & obj_mask[None, :, None, None]
        # reached grows by transition endpoints.
        arrive = reached
        for a, (dx, dy) in enumerate(DISPLACEMENTS):
            arrive = arrive | _shift2d(E_new[a], -dx, -dy)
        changed = bool((E_new != E).any() | (arrive != reached).any())
        E, reached = E_new, arrive
        iterations += 1
        if not changed:
            break
    if stats_out is not None:
        stats_out["iterations"] = iterations
    return E, reached


def all_pairs_distances(E_o: torch.Tensor) -> torch.Tensor:
    """All-pairs distances D[s, t] = dist(s -> t) over one object's movement
    graph: one wavefront field per target cell, all sharing ``E_o``, in one
    call of :func:`pushworld_tpu_torch.ops.graphs_cuda.distance_fields` (the
    CUDA kernel when ``E_o`` lies on the card).

    Returns float32 (H*W, H*W); unreachable pairs = INF.  (H*W)^2 floats:
    used per puzzle, not per batch.
    """
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields  # imports this module

    H, W = E_o.shape[-2:]
    HW = H * W
    d0 = torch.full((HW, HW), INF, dtype=torch.float32, device=E_o.device)
    d0.fill_diagonal_(0.0)  # field t: 0 at cell t
    d = distance_fields(E_o[None], d0.reshape(HW, H, W))
    # d[t, y, x] = dist((x, y) -> t).  Return D[s, t].
    return d.reshape(HW, HW).T.contiguous()


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
