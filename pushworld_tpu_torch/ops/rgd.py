"""Batched Recursive Graph Distance heuristic.

Port of the JAX package's ``ops/rgd.py``.  Evaluates the RGD heuristic
(reference: cpp/src/heuristics/recursive_graph_distance.cc:43-252) for a
batch of states of one puzzle.  The recursion over pusher chains becomes,
per pushing depth, a tensorized min over (pusher, contact offset,
pusher-next-direction) triples using precomputed tables:

- ``E[a, o, y, x]`` — feasible transitions (host movement graphs),
- compact per-object all-pairs graph distances (``Dflat`` blocks),
- ``DG[o]`` — distance-to-goal fields for goal objects,
- compacted contact-offset lists per (action, pusher, pushee).

The distance tables are wavefront fields: ``DG`` and every column of the
compact blocks come from :func:`pushworld_tpu_torch.ops.graphs_cuda.
distance_fields` — the hand-written CUDA kernel on the card, its plain
version on the CPU.  (The JAX package builds the same tables with host BFS;
the values are identical.)

``fewest_tools`` semantics (the planner default, reference:
recursive_graph_distance.cc:101-112): the cost at the smallest pushing depth
with a finite value, trying depths 0..max_depth.  Table lookups are integer
gathers (the JAX package's one-hot f32 GEMM lookups were a TPU form).

:func:`rgd_heuristic_with_flags` is ONE launch of ``kernels/rgd.cu`` on a
CUDA tensor (a warp a state where the deepest depth is 0; deeper, a CTA a
state with the recursion's memo in shared memory, as the reference's
per-state PushingCostCache) and, on a CPU tensor,
:func:`rgd_heuristic_with_flags_reference`, the tensorized recursion (the
JAX package's ``_rgd_impl``).  The two are bit-equal.  The kernel's
one-word path takes states of at most :data:`RGD_MAX_OBJECTS` objects, its
wide path more; where the wide path's memo outgrows shared memory it lives
in a device scratch allocated here (:func:`rgd_path`).
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.kernels import _build, count_launch, launch_on
from pushworld_tpu_torch.ops.graphs import host_vertex_mask
from pushworld_tpu_torch.ops.graphs_cuda import distance_fields
from pushworld_tpu_torch.ops.step import displacements

INF = 1e9
FINITE_THRESHOLD = 1e8
D_INF = 65535  # the packed distance blocks' encoding of infinity


@dataclass
class RGDTables:
    """Precomputed per-puzzle tensors for batched RGD evaluation.

    Graph distances are stored COMPACTLY: each object's all-pairs table is
    restricted to its movement graph's vertex set (cells incident to a
    feasible transition, plus the initial cell — every cell the heuristic
    ever gathers a distance for, see :func:`host_vertex_mask`) and packed
    row-major into one flat buffer.  ``Dflat`` holds the JAX package's
    uint16 values (65535 = INF) widened to int32, since CUDA gathers on
    uint16 tensors are not supported.
    """

    E: torch.Tensor  # bool (4, N, H, W)
    Dflat: torch.Tensor  # int32 (cap,) packed per-object R_o x R_o blocks (65535 = INF)
    vidx: torch.Tensor  # int32 (rows, HW) flat cell -> compact vertex index, -1 = not a vertex
    doff: torch.Tensor  # int32 (rows,) start offset of object o's block in Dflat
    dstride: torch.Tensor  # int32 (rows,) R_o (row stride of object o's block)
    DG: torch.Tensor  # f32 (N, H, W) distance-to-goal fields (goal rows only)
    contacts: torch.Tensor  # int16 (4, N, N, C, 2) rel offsets (rx, ry)
    contacts_mask: torch.Tensor  # bool (4, N, N, C)
    contacts_a: torch.Tensor  # int16 (4, N, Ca, 2) agent-row contacts
    contacts_a_mask: torch.Tensor  # bool (4, N, Ca)
    # cvidx_a[a, o, p_flat, c]: the agent graph's compact vertex index of
    # contact cell p + contacts_a[a, o, c] where the agent can feasibly push
    # there (E[a, agent] holds and the contact is in bounds), else -1.
    cvidx_a: torch.Tensor  # int16 (4, N, HW, Ca)
    goal_pos: torch.Tensor  # int32 (N, 2)
    goal_mask: torch.Tensor  # bool (N,)
    n_real: int  # actual number of movables
    n: int
    max_goals: int
    height: int
    width: int
    cmax: int
    cmax_agent: int


def _movement_graphs_python(puzzle: Puzzle, cp: CompiledPuzzle) -> np.ndarray:
    """E (4, N, H, W) bool from the Python worklist fixpoint."""
    from pushworld_tpu_torch.search.heuristics_host import MovementGraphs

    cp = cp.numpy()
    E = np.zeros((4, cp.n, cp.height, cp.width), bool)
    disp = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    for o, edges in enumerate(MovementGraphs(puzzle, cp).edges):
        for p, succs in edges.items():
            for q in succs:
                E[disp.index((q[0] - p[0], q[1] - p[1])), o, p[1], p[0]] = True
    return E


# The most movables the native fixpoint takes (native/planner.cc
# pw_build_graphs); larger puzzles take the Python worklist, as in the JAX
# package.
NATIVE_GRAPHS_MAX_MOVABLES = 31


def _movement_graphs_host(puzzle: Puzzle, cp: CompiledPuzzle) -> np.ndarray:
    """E (4, N, H, W) bool via the native fixpoint when the native library
    can be built and takes the puzzle, else from the Python worklist (the two
    give the same E)."""
    from pushworld_tpu_torch.native import bridge

    if puzzle.num_movables > NATIVE_GRAPHS_MAX_MOVABLES or not bridge.is_available():
        return _movement_graphs_python(puzzle, cp)
    n = puzzle.num_movables
    E = np.zeros((4, cp.n, cp.height, cp.width), bool)
    E[:, :n] = bridge.build_graphs_native(puzzle, cp).astype(bool)
    return E


def dflat_required(
    puzzle: Puzzle, cp: CompiledPuzzle, max_depth: Optional[int] = None
) -> int:
    """Packed-distance-buffer entries :func:`build_rgd_tables` will need
    (sum of R_o^2 over built objects)."""
    E_np = _movement_graphs_host(puzzle, cp)
    n_built = 1 if max_depth == 0 else min(cp.n, puzzle.num_movables)
    total = 0
    for o in range(n_built):
        init = puzzle.initial_state[o]
        vm = host_vertex_mask(E_np[:, o], init[1] * cp.width + init[0])
        total += int(vm.sum()) ** 2
    return max(total, 1)


def _compact_block(E_o: torch.Tensor, verts: np.ndarray) -> torch.Tensor:
    """(R, R) int32 compact all-pairs block of one object's movement graph:
    D[i, j] = dist(verts[i] -> verts[j]), 65535 = INF.  One wavefront field
    per vertex, all sharing ``E_o``; column j is field j read at ``verts``."""
    _, H, W = E_o.shape
    R = len(verts)
    v = torch.as_tensor(verts, dtype=torch.long, device=E_o.device)
    d0 = torch.full((R, H * W), INF, dtype=torch.float32, device=E_o.device)
    d0[torch.arange(R, device=E_o.device), v] = 0.0
    fields = distance_fields(E_o[None], d0.reshape(R, H, W))
    Dc = fields.reshape(R, H * W)[:, v].T  # [i, j] = field_j at verts[i]
    return torch.where(Dc >= FINITE_THRESHOLD, D_INF, Dc.to(torch.int32)).to(torch.int32)


def build_rgd_tables(
    puzzle: Puzzle,
    cp: CompiledPuzzle,
    cmax_pad: Optional[int] = None,
    max_goals: Optional[int] = None,
    max_depth: Optional[int] = None,
    dflat_cap: Optional[int] = None,
    cmax_agent_pad: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> RGDTables:
    """Builds all precomputed tensors (one-time per puzzle) on ``device``.

    ``cmax_pad`` / ``max_goals`` / ``dflat_cap`` / ``cmax_agent_pad`` pad the
    contact lists, goal loop bound and packed distance buffer as in the JAX
    package.  With ``max_depth == 0`` only the agent's compact block is
    built (depth 0 only ever gathers the agent's distances)."""
    dev = resolve_device(device)
    cp = cp.numpy()
    N, H, W = cp.n, cp.height, cp.width
    HW = H * W
    if HW > np.iinfo(np.int16).max:
        # cvidx_a narrows vertex ids to int16 (ids < HW).
        raise ValueError(
            f"grid H*W={HW} exceeds int16 vertex-id capacity "
            f"({np.iinfo(np.int16).max}); cvidx_a would overflow"
        )

    n_rows = 1 if max_depth == 0 else N
    n_built = 1 if max_depth == 0 else min(N, puzzle.num_movables)
    E_np = _movement_graphs_host(puzzle, cp)
    E = torch.as_tensor(E_np, device=dev)
    vidx = np.full((n_rows, HW), -1, np.int32)
    doff = np.zeros((n_rows,), np.int32)
    dstride = np.zeros((n_rows,), np.int32)
    blocks: List[torch.Tensor] = []
    off = 0
    for o in range(n_built):
        init = puzzle.initial_state[o]
        verts = np.nonzero(host_vertex_mask(E_np[:, o], init[1] * W + init[0]))[0]
        R = len(verts)
        vidx[o, verts] = np.arange(R, dtype=np.int32)
        doff[o] = off
        dstride[o] = R
        blocks.append(_compact_block(E[:, o], verts).reshape(-1))
        off += R * R
    cap = dflat_cap if dflat_cap is not None else max(off, 1)
    if cap < off:
        raise ValueError(f"dflat_cap={cap} < required {off}")
    Dflat = torch.full((cap,), D_INF, dtype=torch.int32, device=dev)
    if off:
        Dflat[:off] = torch.cat(blocks)

    # Distance-to-goal fields: one wavefront field per goal object.
    DG = torch.full((N, H, W), INF, dtype=torch.float32, device=dev)
    goal_objs = [k + 1 for k in range(puzzle.num_goals) if k + 1 < N]
    if goal_objs:
        d0 = torch.full((len(goal_objs), H, W), INF, dtype=torch.float32, device=dev)
        for i, o in enumerate(goal_objs):
            g = puzzle.goal_state[o - 1]
            d0[i, g[1], g[0]] = 0.0
        E_goal = E[:, goal_objs].permute(1, 0, 2, 3).contiguous()
        DG[goal_objs] = distance_fields(E_goal, d0)

    # Compact contact offsets from the dense push tables.
    push = cp.push  # (4, pusher, pushee, K, K)
    delta = cp.delta
    counts = push.reshape(4, N, N, -1).sum(-1)
    cmax = max(1, int(counts.max()))
    if cmax_pad is not None:
        if cmax_pad < cmax:
            raise ValueError(f"cmax_pad={cmax_pad} < required {cmax}")
        cmax = cmax_pad
    contacts = np.zeros((4, N, N, cmax, 2), np.int16)
    contacts_mask = np.zeros((4, N, N, cmax), bool)
    for a in range(4):
        for q in range(N):
            for o in range(N):
                ys, xs = np.nonzero(push[a, q, o])
                m = len(ys)
                if m:
                    contacts[a, q, o, :m, 0] = xs - delta
                    contacts[a, q, o, :m, 1] = ys - delta
                    contacts_mask[a, q, o, :m] = True

    # Agent-row contacts under their own (small) pad for the depth-0 path.
    cmax_agent = max(1, int(counts[:, 0, :].max()))
    if cmax_agent_pad is not None:
        if cmax_agent_pad < cmax_agent:
            raise ValueError(
                f"cmax_agent_pad={cmax_agent_pad} < required {cmax_agent}"
            )
        cmax_agent = cmax_agent_pad
    contacts_a = np.zeros((4, N, cmax_agent, 2), np.int16)
    contacts_a_mask = np.zeros((4, N, cmax_agent), bool)
    for a in range(4):
        for o in range(N):
            ys, xs = np.nonzero(push[a, 0, o])
            m = len(ys)
            if m:
                contacts_a[a, o, :m, 0] = xs - delta
                contacts_a[a, o, :m, 1] = ys - delta
                contacts_a_mask[a, o, :m] = True

    # Fused depth-0 contact table (see RGDTables.cvidx_a).
    vidx0 = vidx[0].reshape(H, W)
    cvidx_a = np.full((4, N, HW, cmax_agent), -1, np.int16)
    ys_g, xs_g = np.mgrid[0:H, 0:W]
    for a in range(4):
        vidx0_e = np.where(E_np[a, 0], vidx0, -1)  # (H, W)
        for o in range(N):
            for ci in range(cmax_agent):
                if not contacts_a_mask[a, o, ci]:
                    continue
                rx, ry = contacts_a[a, o, ci]
                cy = ys_g + ry
                cx = xs_g + rx
                ok = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
                vals = np.where(
                    ok, vidx0_e[np.clip(cy, 0, H - 1), np.clip(cx, 0, W - 1)], -1
                )
                cvidx_a[a, o, :, ci] = vals.reshape(-1)

    def t(x):
        return torch.as_tensor(x, device=dev)

    return RGDTables(
        E=E,
        Dflat=Dflat,
        vidx=t(vidx),
        doff=t(doff),
        dstride=t(dstride),
        DG=DG,
        contacts=t(contacts),
        contacts_mask=t(contacts_mask),
        contacts_a=t(contacts_a),
        contacts_a_mask=t(contacts_a_mask),
        cvidx_a=t(cvidx_a),
        goal_pos=t(cp.goal_pos),
        goal_mask=t(cp.goal_mask),
        n_real=puzzle.num_movables,
        n=N,
        max_goals=max_goals if max_goals is not None else puzzle.num_goals,
        height=H,
        width=W,
        cmax=cmax,
        cmax_agent=cmax_agent,
    )


# ---------------------------------------------------------------- heuristic


def _gather_D(t: RGDTables, q, u_flat, v_flat) -> torch.Tensor:
    """Graph distance dist(u -> v) in object ``q``'s movement graph, read
    from the compact packed tables.  ``q`` / ``u_flat`` / ``v_flat``
    broadcast together; cells outside the graph's vertex set are INF."""
    iu = t.vidx[q, u_flat].long()
    iv = t.vidx[q, v_flat].long()
    ok = (iu >= 0) & (iv >= 0)
    idx = t.doff[q].long() + iu.clamp(min=0) * t.dstride[q].long() + iv.clamp(min=0)
    d = t.Dflat[torch.where(ok, idx, 0)]
    return torch.where(ok & (d != D_INF), d.to(torch.float32), INF)


def _flat(t: RGDTables, pos: torch.Tensor) -> torch.Tensor:
    """(..., 2) int position -> flat index y*W + x (int64)."""
    return pos[..., 1].long() * t.width + pos[..., 0].long()


def _gather_E(t: RGDTables, a, o, pos: torch.Tensor) -> torch.Tensor:
    """E[a, o, pos] with bounds masking.  a/o/pos broadcast together."""
    x = pos[..., 0].long()
    y = pos[..., 1].long()
    ok = (x >= 0) & (x < t.width) & (y >= 0) & (y < t.height)
    return t.E[a, o, y.clamp(0, t.height - 1), x.clamp(0, t.width - 1)] & ok


def _agent_push_cost(t: RGDTables, states, o: int, a: int, p) -> torch.Tensor:
    """Depth-0 pushing cost: the agent realizes pushee ``o``'s transition
    p -> p + d_a.  Returns (B,) f32 (includes the +1 push action cost).

    The agent graph is symmetric, so dist(A -> c) is read as Dflat[row A,
    col c]; the agent-at-contact case falls out of the zero diagonal."""
    HW = t.width * t.height
    iA = t.vidx[0, _flat(t, states[:, 0, :])].long()  # (B,)
    p_flat = _flat(t, p).clamp(0, HW - 1)
    iv = t.cvidx_a[a, o][p_flat].long()  # (B, Ca)
    ok = (iv >= 0) & (iA >= 0)[:, None]
    idx = t.doff[0].long() + iA[:, None] * t.dstride[0].long() + iv.clamp(min=0)
    d = t.Dflat[torch.where(ok, idx, 0)]
    v = torch.where(ok & (d != D_INF), d.to(torch.float32), INF)
    return 1.0 + v.min(1).values


def _tool_push_cost(t: RGDTables, states, o: int, a: int, p, skip_mask, inner_tbl, disp):
    """Depth-d (d >= 1) pushing cost: some tool q (not skipped) realizes
    pushee ``o``'s transition p -> p + d_a.

    ``inner_tbl``: (B, N, 4) costs of realizing each candidate pusher q's
    own first transition Q -> Q + d_{a'} at depth d-1; ``disp``: the four
    moves' displacements (:func:`ops.step.displacements`).  Returns (B,)
    f32."""
    N = t.n
    HW = t.width * t.height
    dev = states.device
    n_ar = torch.arange(N, device=dev)
    a4 = torch.arange(4, device=dev)

    Q = states  # (B, N, 2) candidate pusher positions (per object)
    rel = t.contacts[a, :, o].to(torch.int32)  # (N, C, 2) pusher q at pushee + rel
    mask = t.contacts_mask[a, :, o]  # (N, C)
    c = p[:, None, None, :] + rel[None]  # (B, N, C, 2)
    feasible = _gather_E(t, a, n_ar[None, :, None], c) & mask[None]  # (B, N, C)
    c_flat = _flat(t, c).clamp(0, HW - 1)  # (B, N, C)

    P_next = Q[:, :, None, :] + disp[None, None]  # (B, N, 4, 2)
    next_ok = _gather_E(t, a4[None, None, :], n_ar[None, :, None], Q[:, :, None, :])  # (B, N, 4)
    P_next_flat = _flat(t, P_next).clamp(0, HW - 1)  # (B, N, 4)

    dist = _gather_D(
        t, n_ar[None, :, None, None], P_next_flat[:, :, :, None], c_flat[:, :, None, :]
    )  # (B, N, 4, C)

    # Simultaneous push: contact == Q and a' == a.
    same_pos = (c == Q[:, :, None, :]).all(-1)  # (B, N, C)
    simultaneous = same_pos[:, :, None, :] & (a4 == a)[None, None, :, None]
    base = torch.where(simultaneous, 0.0, dist + 1.0)  # (B, N, 4, C)
    base = torch.where(feasible[:, :, None, :], base, INF)
    base = torch.where(next_ok[:, :, :, None], base, INF)
    total = base.min(3).values + inner_tbl  # (B, N, 4)
    # Valid pushers: movables 1..n_real-1, not the pushee, not skipped.
    valid_q = (n_ar >= 1) & (n_ar < t.n_real) & (n_ar != o)
    valid_q = valid_q[None, :] & ~skip_mask  # (B, N)
    total = torch.where(valid_q[:, :, None], total, INF)
    return total.amin(dim=(1, 2))


def _push_cost_all_dirs_depth0(t: RGDTables, states) -> torch.Tensor:
    """(B, N, 4): depth-0 cost (agent pushes) of object q's transition
    Q -> Q + d_{a'} for every movable q and direction a'.  Feasibility of the
    transition itself is NOT included (callers mask with E)."""
    B, N = states.shape[0], t.n
    HW = t.width * t.height
    iA = t.vidx[0, _flat(t, states[:, 0, :])].long()  # (B,)
    Q_flat = _flat(t, states).clamp(0, HW - 1)  # (B, N)
    n_idx = torch.arange(N, device=states.device)[None, :].expand(B, N)
    iv = t.cvidx_a[:, n_idx, Q_flat].long()  # (4, B, N, Ca)
    ok = (iv >= 0) & (iA >= 0)[None, :, None, None]
    idx = t.doff[0].long() + iA[None, :, None, None] * t.dstride[0].long() + iv.clamp(min=0)
    d = t.Dflat[torch.where(ok, idx, 0)]
    v = torch.where(ok & (d != D_INF), d.to(torch.float32), INF)
    out = 1.0 + v.min(3).values  # (4, B, N)
    return out.permute(1, 2, 0)  # (B, N, 4)


def rgd_heuristic_with_flags(
    t: RGDTables, states: torch.Tensor, max_depth: int = 1, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`rgd_heuristic` but also returns a per-state bool flag:
    True when some goal object's cost is INF at ``max_depth`` although its
    graph distance to the goal is finite — deeper pushing chains could give
    a finite value.  Drives the planner's depth escalation.

    ``valid`` ((B,) bool, or None for all): states that are not valid get
    the fill (total :data:`INF`, flag False) and are not evaluated by the
    kernel, so their rows may hold anything.

    On a CUDA tensor this is one launch of ``kernels/rgd.cu``; on a CPU
    tensor it runs :func:`rgd_heuristic_with_flags_reference`.  The two are
    bit-equal."""
    if states.device.type == "cpu":
        return rgd_heuristic_with_flags_reference(t, states, max_depth, valid)
    return _rgd_cuda(t, states, max_depth, valid)


def rgd_heuristic(
    t: RGDTables, states: torch.Tensor, max_depth: int = 1, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Fewest-tools RGD estimate for a batch of states.

    Args:
        t: precomputed tables.
        states: (B, N, 2) int32, reachable from the puzzle's initial state
            (the compact tables cover only each object's movement graph).
        max_depth: maximum pushing depth.
        valid: (B,) bool or None; see :func:`rgd_heuristic_with_flags`.

    Returns:
        (B,) float32; unreachable goals yield values >= 1e9.

    The kernel on a CUDA tensor, the plain version on a CPU tensor, as
    :func:`rgd_heuristic_with_flags`.
    """
    return rgd_heuristic_with_flags(t, states, max_depth, valid)[0]


# The largest N (objects a state) of the kernel's one-word path: its skip
# sets are 32-bit masks and its shared memory holds an (N, 4, N, 4) push
# table (kernels/rgd.cu kMaxObjects).  Every fixture, the generator's puzzles
# and the benchmark's have fewer; wider states take the wide path.
RGD_MAX_OBJECTS = 32


def _wide_scratch_floats(t: RGDTables, B: int, max_depth: int, device: torch.device) -> int:
    return _build.load("rgd").pw_rgd_wide_scratch_floats(B, t.n, t.n_real, t.max_goals, max_depth, device.index)


def rgd_path(t: RGDTables, B: int, max_depth: int, device) -> str:
    """The path of ``kernels/rgd.cu`` that a batch of ``B`` states takes on
    ``device``: "one-word"; "wide" where the deepest depth is 0; else "wide,
    shared memory" or "wide, scratch" (the memo in device memory)."""
    if t.n <= RGD_MAX_OBJECTS:
        return "one-word"
    if min(max_depth, t.n_real - 2) < 1:
        return "wide"
    device = torch.device(device)
    return "wide, scratch" if _wide_scratch_floats(t, B, max_depth, device) else "wide, shared memory"

_TABLE_TYPES = (("E", torch.bool), ("Dflat", torch.int32), ("vidx", torch.int32), ("doff", torch.int32),
                ("dstride", torch.int32), ("DG", torch.float32), ("contacts", torch.int16),
                ("contacts_mask", torch.bool), ("cvidx_a", torch.int16), ("goal_pos", torch.int32),
                ("goal_mask", torch.bool))


def _rgd_cuda(t: RGDTables, states: torch.Tensor, max_depth: int, valid: Optional[torch.Tensor],
              wide: Optional[bool] = None):
    """One launch of ``kernels/rgd.cu``: outputs from ``torch.empty``, no host
    read, the launch on the current stream, so a CUDA graph may capture it.
    ``wide``: the path, the one-word path up to :data:`RGD_MAX_OBJECTS`
    objects where None (the wide path takes any N, so the tests run it on
    narrow states too)."""
    if states.dim() != 3 or states.shape[1:] != (t.n, 2) or states.dtype != torch.int32:
        raise ValueError(f"states: expected (B, {t.n}, 2) int32, got {tuple(states.shape)} {states.dtype}")
    if max_depth < 0 or t.max_goals >= t.n:
        raise ValueError(f"max_depth {max_depth} < 0 or max_goals {t.max_goals} >= n {t.n}")
    if min(max_depth, t.n_real - 2) >= 1 and t.vidx.shape[0] < t.n_real:
        raise ValueError("tables built for depth 0 hold the agent's distances only")
    n, H, W = t.n, t.height, t.width
    shapes = {"E": (4, n, H, W), "DG": (n, H, W), "contacts": (4, n, n, t.cmax, 2),
              "contacts_mask": (4, n, n, t.cmax), "cvidx_a": (4, n, H * W, t.cmax_agent)}
    tensors = []
    for name, dtype in _TABLE_TYPES:
        x = getattr(t, name)
        if x.dtype != dtype or x.device != states.device or not x.is_contiguous():
            raise ValueError(f"RGDTables.{name}: expected a contiguous {dtype} tensor on {states.device}")
        if name in shapes and x.shape != shapes[name]:
            raise ValueError(f"RGDTables.{name}: expected shape {shapes[name]}, got {tuple(x.shape)}")
        tensors.append(x)
    states = states.contiguous()
    if states.data_ptr() % 8:  # the kernel loads a position as one 8-byte word
        states = states.clone()
    B = states.shape[0]
    if valid is not None and (valid.shape != (B,) or valid.dtype != torch.bool or valid.device != states.device):
        raise ValueError(f"valid: expected a ({B},) bool tensor on {states.device}")
    valid = None if valid is None else valid.contiguous()
    total = torch.empty((B,), dtype=torch.float32, device=states.device)
    deeper = torch.empty((B,), dtype=torch.bool, device=states.device)
    if B == 0:
        return total, deeper
    lib = _build.load("rgd")
    args = [states.data_ptr(), *(x.data_ptr() for x in tensors), None if valid is None else valid.data_ptr(),
            total.data_ptr(), deeper.data_ptr(), B, t.n, t.n_real, t.max_goals, t.height, t.width, t.cmax,
            t.cmax_agent, max_depth]
    if wide is None:
        wide = t.n > RGD_MAX_OBJECTS
    if not wide:
        rc = launch_on(states.device, lib.pw_rgd_heuristic, *args)
    else:
        floats = _wide_scratch_floats(t, B, max_depth, states.device)
        scratch = torch.empty((floats,), dtype=torch.float32, device=states.device) if floats else None
        rc = launch_on(states.device, lib.pw_rgd_heuristic_wide, *args,
                       None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"pw_rgd_heuristic launch failed: CUDA error {rc}")
    count_launch("rgd.heuristic")
    return total, deeper


def rgd_heuristic_with_flags_reference(
    t: RGDTables, states: torch.Tensor, max_depth: int, valid: Optional[torch.Tensor] = None
):
    """Plain PyTorch version of :func:`rgd_heuristic_with_flags`, the JAX
    package's unrolled recursion of whole-batch gathers: returns (total
    cost, needs-deeper flag) per state, the fill where ``valid`` is False."""
    total, needs_deeper = _rgd_reference(t, states, max_depth)
    if valid is None:
        return total, needs_deeper
    return torch.where(valid, total, INF), needs_deeper & valid


def _rgd_reference(t: RGDTables, states: torch.Tensor, max_depth: int):
    """The JAX package's ``_rgd_impl`` on every state."""
    B = states.shape[0]
    dev = states.device
    total = torch.zeros((B,), dtype=torch.float32, device=dev)
    needs_deeper = torch.zeros((B,), dtype=torch.bool, device=dev)
    # Memoized per-(skip set, depth) pushing-cost tables shared across
    # goals/directions (the reference's PushingCostCache,
    # recursive_graph_distance.cc:176-252).
    cache: dict = {}
    disp = displacements(dev)

    for k in range(t.max_goals):
        o = k + 1
        p = states[:, o, :]  # (B, 2)
        at_goal = (p == t.goal_pos[o][None, :]).all(-1)
        finite_dg = torch.zeros((B,), dtype=torch.bool, device=dev)

        per_depth: List[torch.Tensor] = []
        for depth in range(max_depth + 1):
            cost_dirs = []
            for a in range(4):
                e_ok = _gather_E(t, a, o, p)  # (B,)
                eff = p + disp[a][None, :]
                goal_dist = t.DG[
                    o,
                    eff[:, 1].long().clamp(0, t.height - 1),
                    eff[:, 0].long().clamp(0, t.width - 1),
                ]
                if depth == 0:
                    finite_dg = finite_dg | (e_ok & (goal_dist < FINITE_THRESHOLD))
                    pc = _agent_push_cost(t, states, o, a, p)
                else:
                    inner = _all_dirs_cost(t, states, (o,), depth - 1, cache, disp)
                    skip = torch.zeros((B, t.n), dtype=torch.bool, device=dev)
                    pc = _tool_push_cost(t, states, o, a, p, skip, inner, disp)
                cost_dirs.append(torch.where(e_ok, goal_dist + pc, INF))
            per_depth.append(torch.minimum(
                torch.minimum(cost_dirs[0], cost_dirs[1]),
                torch.minimum(cost_dirs[2], cost_dirs[3]),
            ))

        # Fewest tools: first finite depth (depths beyond n_real - 2 are
        # invalid for this puzzle — the reference iterates depth < n - 1).
        cost = torch.full((B,), INF, dtype=torch.float32, device=dev)
        for d, d_cost in enumerate(per_depth):
            if d > t.n_real - 2:
                d_cost = torch.full_like(d_cost, INF)
            cost = torch.where(cost < FINITE_THRESHOLD, cost, d_cost)
        cost = torch.where(at_goal, 0.0, cost)
        if max_depth < t.n_real - 2:
            needs_deeper = needs_deeper | (
                t.goal_mask[o] & ~at_goal & finite_dg & (cost >= FINITE_THRESHOLD)
            )
        # Objects without a goal contribute nothing.
        cost = torch.where(t.goal_mask[o], cost.clamp(max=INF), 0.0)
        total = total + cost

    return total, needs_deeper


def _all_dirs_cost(
    t: RGDTables, states: torch.Tensor, skip_objs: Tuple[int, ...], depth: int, cache: dict,
    disp: torch.Tensor,
) -> torch.Tensor:
    """(B, N, 4): cost of object q's transition Q -> Q + d_{a'} at pushing
    depth ``depth``, for every candidate q and direction a', with the
    chain-exclusion set ``skip_objs`` (reference:
    recursive_graph_distance.cc:114-174).  Memoized per (skip set, depth)."""
    key = (frozenset(skip_objs), depth)
    if key in cache:
        return cache[key]
    if depth == 0:
        # The skip set never contains the agent, so all depth-0 tables coincide.
        out = cache.get(("depth0",))
        if out is None:
            out = _push_cost_all_dirs_depth0(t, states)
            cache[("depth0",)] = out
    else:
        B, N = states.shape[0], t.n
        skip = torch.zeros((B, N), dtype=torch.bool, device=states.device)
        for s in skip_objs:
            skip[:, s] = True
        cols = []
        for q in range(N):
            inner = _all_dirs_cost(
                t, states, tuple(sorted(set(skip_objs) | {q})), depth - 1, cache, disp
            )
            pq = states[:, q, :]
            cols.append(torch.stack(
                [_tool_push_cost(t, states, q, a2, pq, skip, inner, disp) for a2 in range(4)], dim=1
            ))  # (B, 4)
        out = torch.stack(cols, dim=1)  # (B, N, 4)
    cache[key] = out
    return out
