"""Batched PushWorld dynamics on tensors.

Port of the JAX package's ``ops/step.py``.  The reference computes one
transition with a pushing-frontier BFS over hash-set collision maps
(reference: python3/src/pushworld/puzzle.py:348-394,
cpp/src/pushworld_puzzle.cc:386-460).  Here the same semantics are a
fixed-shape tensor program over a batch of states:

1. build the "who-pushes-whom" boolean matrix ``M[i, j]`` at the current
   relative offsets,
2. compute the transitively pushed movables as a boolean closure from the
   agent (log2(N) squaring steps),
3. apply the all-or-nothing transitive-stopping rule: nothing moves if the
   agent is statically blocked or any pushed movable would hit a wall,
4. advance every pushed movable by the action displacement.

Computing the full closure first and then testing "any pushed movable
blocked" accepts and rejects exactly the transitions of the reference's
early-exit BFS.

The functions take a :class:`CompiledPuzzle` whose fields are tensors
(``CompiledPuzzle.to(device)``); states are int32 ``(..., N, 2)`` (x, y).

The search's expansion (:func:`expand_children`, and :func:`expand_and_test`
with the moved masks, the ``effective`` flags and the goal test) is one
launch of ``kernels/expand.cu`` on a CUDA tensor and its plain version
(:func:`expand_children_reference`, :func:`expand_and_test_reference`) on a
CPU tensor; the two are bit-equal.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.kernels import _build, count_launch, launch_on

DISPLACEMENTS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], np.int32)


def displacements(device) -> torch.Tensor:
    """:data:`DISPLACEMENTS` as an int32 (4, 2) tensor made on ``device``
    from ``arange``: no host-to-device copy, which a search iteration
    captured into a CUDA graph may not make."""
    a = torch.arange(4, device=device)
    sign = (a % 2) * 2 - 1  # -1, 1, -1, 1
    zero = torch.zeros_like(a)
    return torch.stack([torch.where(a < 2, sign, zero), torch.where(a < 2, zero, sign)], -1).to(torch.int32)


def _closure_from_agent(m: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: movables transitively pushed from the agent.
    ``m``: (..., N, N) bool push relation."""
    n = m.shape[-1]
    r = torch.zeros(m.shape[:-1], dtype=torch.float32, device=m.device)
    r[..., 0] = 1.0
    mf = m.to(torch.float32)
    for _ in range(max(1, (n - 1).bit_length())):
        r = torch.clamp(r + torch.matmul(r.unsqueeze(-2), mf).squeeze(-2), max=1.0)
        mf = torch.clamp(mf + torch.matmul(mf, mf), max=1.0)
    return r > 0.5


def step(cp: CompiledPuzzle, state: torch.Tensor, action, puzzle_idx=None) -> torch.Tensor:
    """Exact transitions of a batch.  ``state``: (..., N, 2) int32;
    ``action``: int or int tensor broadcastable to ``state.shape[:-2]``.

    ``puzzle_idx``: with a stacked ``cp`` (leading puzzle axis P on every
    table), the puzzle of each state, an int tensor broadcastable to
    ``state.shape[:-2]``.  It is a leading index into the stacked tables: no
    table is copied per state.

    Returns the next states, (..., N, 2) int32.
    """
    N, delta = cp.n, cp.delta
    K = 2 * delta + 1
    dev = state.device
    batch = state.shape[:-2]
    a = torch.as_tensor(action, device=dev).long().expand(batch)
    x = state[..., 0].long()
    y = state[..., 1].long()
    idx = torch.arange(N, device=dev)
    if puzzle_idx is None:
        lead, obj_mask = (), cp.obj_mask
    else:
        pi = torch.as_tensor(puzzle_idx, device=dev).long().expand(batch)
        lead, obj_mask = (pi,), cp.obj_mask[pi]  # (..., N)
    blocked_static = cp.static_block[
        tuple(i.unsqueeze(-1) for i in lead) + (a.unsqueeze(-1), idx, y, x)
    ]  # (..., N)

    rel = (state.unsqueeze(-2) - state.unsqueeze(-3)).long()  # (..., N, N, 2) pos_i - pos_j
    in_range = (rel.abs() <= delta).all(-1)
    ridx = torch.clamp(rel + delta, 0, K - 1)
    m = cp.push[
        tuple(i[..., None, None] for i in lead)
        + (a[..., None, None], idx[:, None], idx[None, :], ridx[..., 1], ridx[..., 0])
    ]
    mask = obj_mask.unsqueeze(-1) & obj_mask.unsqueeze(-2)
    pushed = _closure_from_agent(m & in_range & mask)  # includes the agent

    movable_blocked = (pushed[..., 1:] & blocked_static[..., 1:]).any(-1)
    nothing_moves = blocked_static[..., 0] | movable_blocked
    moved = pushed & ~nothing_moves.unsqueeze(-1) & obj_mask
    disp = torch.as_tensor(DISPLACEMENTS, device=dev)[a]  # (..., 2)
    return state + disp.unsqueeze(-2) * moved.unsqueeze(-1).to(state.dtype)


def build_contact_lists(cp: CompiledPuzzle, cmax_pad: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Compacts the dense push tables into per-(action, pusher, pushee)
    contact-offset lists (the native planner's representation, planner.cc
    Contact) for :func:`expand_children`.

    Returns (contacts int16 (4, N, N, C, 2) with (rx, ry) = pos_i - pos_j,
    mask bool (4, N, N, C)) as numpy arrays."""
    push = cp.push.cpu().numpy() if isinstance(cp.push, torch.Tensor) else np.asarray(cp.push)
    N, delta = cp.n, cp.delta
    counts = push.reshape(4, N, N, -1).sum(-1)
    C = max(1, int(counts.max()), cmax_pad)
    contacts = np.zeros((4, N, N, C, 2), np.int16)
    mask = np.zeros((4, N, N, C), bool)
    for a in range(4):
        for q in range(N):
            for o in range(N):
                ys, xs = np.nonzero(push[a, q, o])
                m = len(ys)
                if m:
                    contacts[a, q, o, :m, 0] = xs - delta
                    contacts[a, q, o, :m, 1] = ys - delta
                    mask[a, q, o, :m] = True
    return contacts, mask


def expand_children_reference(
    cp: CompiledPuzzle,
    contacts: torch.Tensor,  # int16/int32 (4, N, N, C, 2) rel offsets pos_i - pos_j
    contacts_mask: torch.Tensor,  # bool (4, N, N, C)
    parents: torch.Tensor,  # (B, N, 2) int32
) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand_children`.

    The per-pair push relation is found by comparing the batch's relative
    offsets with the compacted contact lists (packed (rx, ry) into one int per
    slot; offsets are bounded by delta << 2048), all four actions at once."""
    B, N = parents.shape[0], cp.n
    c32 = contacts.to(torch.int32)
    cpack = torch.where(
        contacts_mask, c32[..., 0] * 4096 + c32[..., 1], torch.full_like(c32[..., 0], 1 << 24)
    )  # (4, N, N, C)
    rel = parents[:, :, None, :] - parents[:, None, :, :]  # (B, N, N, 2)
    rpack = rel[..., 0] * 4096 + rel[..., 1]  # (B, N, N)
    m = (rpack[None, :, :, :, None] == cpack[:, None]).any(-1)  # (4, B, N, N)
    pushed = _closure_from_agent(m)  # (4, B, N) includes the agent

    flat = (parents[..., 1] * cp.width + parents[..., 0]).long()  # (B, N)
    sb_flat = cp.static_block.reshape(4, N, cp.height * cp.width)
    a_idx = torch.arange(4, device=parents.device)[:, None, None]
    n_idx = torch.arange(N, device=parents.device)[None, None, :]
    blocked = sb_flat[a_idx, n_idx, flat[None]]  # (4, B, N)
    nothing = blocked[..., 0] | (pushed[..., 1:] & blocked[..., 1:]).any(-1)  # (4, B)
    moved = pushed & ~nothing.unsqueeze(-1) & cp.obj_mask  # (4, B, N)
    disp = displacements(parents.device)  # (4, 2)
    out = parents[None] + disp[:, None, None, :] * moved.unsqueeze(-1).to(parents.dtype)
    return out.reshape(4 * B, N, 2)


def expand_children(
    cp: CompiledPuzzle,
    contacts: torch.Tensor,  # int16/int32 (4, N, N, C, 2) rel offsets pos_i - pos_j
    contacts_mask: torch.Tensor,  # bool (4, N, N, C)
    parents: torch.Tensor,  # (B, N, 2) int32
) -> torch.Tensor:
    """All four children of every parent, in action-block order
    ``[a=0 children..., a=1 children..., ...]`` — (4B, N, 2) int32.

    On a CUDA tensor this is one launch of ``kernels/expand.cu`` (the flags
    it also writes are dropped; at most :data:`EXPAND_MAX_OBJECTS` objects,
    more raise ValueError); on a CPU tensor it runs
    :func:`expand_children_reference`."""
    if parents.device.type == "cpu":
        return expand_children_reference(cp, contacts, contacts_mask, parents)
    return _expand_cuda(cp, contacts, contacts_mask, parents, None, None)[0]


def expand_and_test_reference(
    cp: CompiledPuzzle, contacts: torch.Tensor, contacts_mask: torch.Tensor, parents: torch.Tensor,
    sel_valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`expand_and_test`: the search
    iteration's expansion, moved masks, ``effective`` flags and goal test as
    the JAX package's ``_iterate`` computes them."""
    children = expand_children_reference(cp, contacts, contacts_mask, parents)
    moved = (children != parents.repeat(4, 1, 1)).any(-1)  # (4B, N)
    effective = moved.any(-1) & sel_valid.repeat(4)  # no-op moves are duplicates
    return children, moved, effective, is_goal_state(cp, children)


def expand_and_test(
    cp: CompiledPuzzle, contacts: torch.Tensor, contacts_mask: torch.Tensor, parents: torch.Tensor,
    sel_valid: torch.Tensor, gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The expansion of a search iteration in one step: (children (4B, N, 2)
    int32, moved (4B, N) bool, effective (4B,) bool, goal (4B,) bool), where
    ``moved`` says which objects a child moved, ``effective`` that some
    object moved and the parent (``sel_valid``, (B,) bool) was selected, and
    ``goal`` that the child is a goal state.

    ``gate`` (a bool scalar on the device, or None): where it is False, the
    kernel writes ``effective`` and ``goal`` False and nothing else, so the
    other outputs hold anything (their parents were never written).  On the
    CPU the gate is already in ``sel_valid`` and every output is computed.

    On a CUDA tensor this is one launch of ``kernels/expand.cu``; on a CPU
    tensor it runs :func:`expand_and_test_reference`.  The two are
    bit-equal where the gate is open."""
    if parents.device.type == "cpu":
        return expand_and_test_reference(cp, contacts, contacts_mask, parents, sel_valid)
    return _expand_cuda(cp, contacts, contacts_mask, parents, sel_valid, gate)


# The largest N (objects a state) the expansion kernel takes: a pusher's
# pushees are a 32-bit mask (kernels/expand.cu kMaxObjects).
EXPAND_MAX_OBJECTS = 32


def _expand_cuda(cp: CompiledPuzzle, contacts: torch.Tensor, contacts_mask: torch.Tensor,
                 parents: torch.Tensor, sel_valid: Optional[torch.Tensor], gate: Optional[torch.Tensor]):
    """One launch of ``kernels/expand.cu``: outputs from ``torch.empty``, no
    host read, the launch on the current stream, so a CUDA graph may
    capture it."""
    dev = parents.device
    if parents.dim() != 3 or parents.shape[1:] != (cp.n, 2) or parents.dtype != torch.int32:
        raise ValueError(f"parents: expected (B, {cp.n}, 2) int32, got {tuple(parents.shape)} {parents.dtype}")
    B, N = parents.shape[:2]
    if N > EXPAND_MAX_OBJECTS:
        raise ValueError(f"the expansion kernel takes at most {EXPAND_MAX_OBJECTS} objects a state, got {N}")
    if contacts.dtype == torch.int32:
        contacts = contacts.to(torch.int16)  # offsets are bounded by delta << 2**15
    C = contacts.shape[3]
    H, W = cp.static_block.shape[2:]
    for name, x, dtype, shape in (
        ("contacts", contacts, torch.int16, (4, N, N, C, 2)), ("contacts_mask", contacts_mask, torch.bool, (4, N, N, C)),
        ("static_block", cp.static_block, torch.bool, (4, N, H, W)), ("obj_mask", cp.obj_mask, torch.bool, (N,)),
        ("goal_pos", cp.goal_pos, torch.int32, (N, 2)), ("goal_mask", cp.goal_mask, torch.bool, (N,)),
        ("sel_valid", sel_valid, torch.bool, (B,)), ("gate", gate, torch.bool, ()),
    ):
        if x is not None and (x.dtype != dtype or tuple(x.shape) != shape or x.device != dev
                              or not x.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dtype} {shape} tensor on {dev}")
    # The kernel reads a cell (x, y) as one 8-byte word and a contact entry
    # (rx, ry) as one 4-byte word.
    parents, contacts, goal_pos = (x if x.data_ptr() % align == 0 else x.clone() for x, align in (
        (parents.contiguous(), 8), (contacts, 4), (cp.goal_pos, 8)))
    children = torch.empty((4 * B, N, 2), dtype=torch.int32, device=dev)
    moved = torch.empty((4 * B, N), dtype=torch.bool, device=dev)
    effective = torch.empty((4 * B,), dtype=torch.bool, device=dev)
    goal = torch.empty((4 * B,), dtype=torch.bool, device=dev)
    if B == 0:
        return children, moved, effective, goal
    fn = _build.load("expand").pw_expand
    ptr = [None if x is None else x.data_ptr() for x in (
        parents, contacts, contacts_mask, cp.static_block, cp.obj_mask, goal_pos, cp.goal_mask, sel_valid,
        gate, children, moved, effective, goal)]
    rc = launch_on(dev, fn, *ptr, B, N, C, H, W)
    if rc != 0:
        raise RuntimeError(f"pw_expand launch failed: CUDA error {rc}")
    count_launch("step.expand")
    return children, moved, effective, goal


def _goal_tables(cp: CompiledPuzzle, puzzle_idx):
    """(goal_pos, goal_mask) of each state's puzzle: the puzzle's own, or rows
    ``puzzle_idx`` of a stacked puzzle's."""
    if puzzle_idx is None:
        return cp.goal_pos, cp.goal_mask
    pi = puzzle_idx.long()
    return cp.goal_pos[pi], cp.goal_mask[pi]


def count_achieved_goals(cp: CompiledPuzzle, state: torch.Tensor, puzzle_idx=None) -> torch.Tensor:
    """Number of goal movables at their goal positions.  reference:
    puzzle.py:396-407.  ``puzzle_idx`` (shape ``state.shape[:-2]``) selects
    each state's puzzle of a stacked ``cp``."""
    goal_pos, goal_mask = _goal_tables(cp, puzzle_idx)
    at_goal = (state == goal_pos).all(-1) & goal_mask
    return at_goal.sum(-1)


def is_goal_state(cp: CompiledPuzzle, state: torch.Tensor, puzzle_idx=None) -> torch.Tensor:
    """(...,) bool over a batch of (..., N, 2) states; ``puzzle_idx`` as in
    :func:`count_achieved_goals`."""
    goal_pos, goal_mask = _goal_tables(cp, puzzle_idx)
    return ((state == goal_pos).all(-1) | ~goal_mask).all(-1)


def moved_mask(prev_state: torch.Tensor, next_state: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: which movables changed position."""
    return (prev_state != next_state).any(-1)


def run_plan(cp: CompiledPuzzle, actions, return_states: bool = False):
    """Applies an action sequence from the initial state.

    ``actions``: (T,) ints.  Returns the final state, and the (T+1, N, 2)
    trajectory when ``return_states``.
    """
    state = cp.init_state
    traj = [state]
    for a in torch.as_tensor(actions).tolist():
        state = step(cp, state, int(a))
        traj.append(state)
    if return_states:
        return state, torch.stack(traj)
    return state
