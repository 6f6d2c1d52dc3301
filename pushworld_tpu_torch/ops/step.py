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
CPU tensor; the two are bit-equal.  The kernel has two paths: the one-word
path for states of at most :data:`EXPAND_MAX_OBJECTS` objects and the wide
path for more (:func:`expand_path`).

The environment's step (:func:`env_step`: the transition, the goal test,
the reward, truncation and auto-reset of a batch of rollouts) and
:func:`step` are one launch of ``kernels/env.cu`` on a CUDA tensor and their
plain versions (:func:`env_step_reference`, :func:`step_reference`) on a CPU
tensor; the two are bit-equal.  :func:`env_steps` runs T steps of the
environment, their actions given ahead, in one launch of the same kernel
(its multi-step path), bit-equal to T calls of :func:`env_step`.
"""

import ctypes
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.kernels import _build, count_launch, launch_on

DISPLACEMENTS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], np.int32)
# The environment's rewards (reference: python3/src/pushworld/gym_env.py:210-226).
TERMINAL_REWARD = 10.0
STEP_PENALTY = 0.01


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

    Returns the next states, (..., N, 2) int32.  On a CUDA tensor this is one
    launch of ``kernels/env.cu`` (the transition alone), which reads the
    states, actions and puzzle indices through their strides (a broadcast
    copies nothing); on a CPU tensor it runs :func:`step_reference`.
    """
    if state.device.type == "cpu":
        return step_reference(cp, state, action, puzzle_idx)
    return _env_kernel(cp, state, action, puzzle_idx)[0]


def step_reference(cp: CompiledPuzzle, state: torch.Tensor, action, puzzle_idx=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`step`: the push relation gathered from
    the dense table, its closure by squaring, the static-block gather."""
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
    it also writes are dropped); on a CPU tensor it runs
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


# The largest N (objects a state) of the expansion kernel's one-word path,
# where a pusher's pushees are a 32-bit mask and a lane's objects lie in one
# warp (kernels/expand.cu kMaxObjects); wider states take its wide path.
EXPAND_MAX_OBJECTS = 32


def expand_path(n: int) -> str:
    """The path of ``kernels/expand.cu`` that states of ``n`` objects take:
    "one-word" or "wide"."""
    return "one-word" if n <= EXPAND_MAX_OBJECTS else "wide"


def _expand_cuda(cp: CompiledPuzzle, contacts: torch.Tensor, contacts_mask: torch.Tensor,
                 parents: torch.Tensor, sel_valid: Optional[torch.Tensor], gate: Optional[torch.Tensor],
                 wide: Optional[bool] = None):
    """One launch of ``kernels/expand.cu``: outputs from ``torch.empty``, no
    host read, the launch on the current stream, so a CUDA graph may
    capture it.  ``wide``: the path, by :func:`expand_path` where None (the
    wide path takes any N, so the tests run it on narrow states too)."""
    dev = parents.device
    if parents.dim() != 3 or parents.shape[1:] != (cp.n, 2) or parents.dtype != torch.int32:
        raise ValueError(f"parents: expected (B, {cp.n}, 2) int32, got {tuple(parents.shape)} {parents.dtype}")
    B, N = parents.shape[:2]
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
    lib = _build.load("expand")
    if wide is None:
        wide = expand_path(N) == "wide"
    fn = lib.pw_expand_wide if wide else lib.pw_expand
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


EnvStepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor]


def env_step_reference(
    cp: CompiledPuzzle, positions: torch.Tensor, actions, steps: torch.Tensor, achieved: torch.Tensor,
    puzzle_idx: Optional[torch.Tensor], init_pos: torch.Tensor, init_achieved: torch.Tensor,
    max_steps: Optional[int], reward_acc: Optional[torch.Tensor] = None,
) -> EnvStepOut:
    """Plain PyTorch version of :func:`env_step`: the transition, the goal
    test, the reward, truncation and auto-reset, one op after another."""
    next_pos = step_reference(cp, positions, actions, puzzle_idx)
    terminated = is_goal_state(cp, next_pos, puzzle_idx)
    got = count_achieved_goals(cp, next_pos, puzzle_idx).to(torch.int32)
    reward = torch.where(terminated, TERMINAL_REWARD, (got - achieved).to(torch.float32) - STEP_PENALTY)
    if reward_acc is not None:
        reward_acc += reward
    steps = steps + 1
    if max_steps is None:
        truncated = torch.zeros_like(terminated)
    else:
        truncated = ~terminated & (steps >= max_steps)
    done = terminated | truncated
    sel = 0 if puzzle_idx is None else puzzle_idx.long()
    return (
        torch.where(done[:, None, None], init_pos[sel], next_pos),
        torch.where(done, 0, steps),
        torch.where(done, init_achieved[sel], got),
        next_pos, reward, terminated, truncated,
    )


def env_step(
    cp: CompiledPuzzle, positions: torch.Tensor, actions, steps: torch.Tensor, achieved: torch.Tensor,
    puzzle_idx: Optional[torch.Tensor], init_pos: torch.Tensor, init_achieved: torch.Tensor,
    max_steps: Optional[int], reward_acc: Optional[torch.Tensor] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> EnvStepOut:
    """One step of B rollouts of the batched environment (``VectorEnv.step``).

    ``positions`` (B, N, 2) int32, ``steps`` and ``achieved`` (B,) int32: the
    rollouts' state; ``actions`` (B,) ints in [0, 4) (int64 as
    ``torch.randint`` gives them, or int32); ``puzzle_idx`` (B,) each
    rollout's puzzle of a stacked ``cp``, None for a single puzzle;
    ``init_pos`` (P, N, 2) int32 and ``init_achieved`` (P,) int32 each
    puzzle's initial state and the goals it achieves (P = 1 for a single
    puzzle); ``max_steps`` the truncation horizon or None.

    ``reward_acc`` (keyword; (B,) float32, contiguous, or None): each
    rollout's running reward total, to which this step's reward is added in
    place (one float32 add a rollout, so the kernel and the plain version
    agree bit for bit).  ``out`` (keyword; contiguous (B,) float32, bool
    and bool tensors, or None): where the step writes its reward,
    terminated and truncated (a row of a trajectory), and returns them.

    Returns ``(positions, steps, achieved, next_pos, reward, terminated,
    truncated)``: the next state with auto-reset applied (a rollout that
    terminated or was truncated starts again from its puzzle's initial
    state), then the pre-reset positions, the float32 reward (10 where
    terminated, else the change in achieved goals less 0.01) and the two
    bool flags.  On a CUDA tensor this is one launch of ``kernels/env.cu``;
    on a CPU tensor it runs :func:`env_step_reference`.  The two are
    bit-equal."""
    if positions.device.type == "cpu":
        res = env_step_reference(cp, positions, actions, steps, achieved, puzzle_idx, init_pos, init_achieved,
                                 max_steps, reward_acc)
        if out is None:
            return res
        for o, x in zip(out, res[4:]):
            o.copy_(x)
        return res[:4] + tuple(out)
    if positions.dim() != 3:
        raise ValueError(f"env_step: positions (B, N, 2), got {tuple(positions.shape)}")
    return _env_kernel(cp, positions, actions, puzzle_idx,
                       env=(steps, achieved, init_pos, init_achieved, max_steps), reward_acc=reward_acc, out=out)


def env_steps(
    cp: CompiledPuzzle, positions: torch.Tensor, actions: torch.Tensor, steps: torch.Tensor, achieved: torch.Tensor,
    puzzle_idx: Optional[torch.Tensor], init_pos: torch.Tensor, init_achieved: torch.Tensor,
    max_steps: Optional[int], reward_acc: Optional[torch.Tensor] = None,
) -> EnvStepOut:
    """T steps of :func:`env_step` in one launch of ``kernels/env.cu`` (its
    multi-step path): ``actions`` (T, B), T >= 1, row t the actions of step
    t (int32 or int64); the other arguments as :func:`env_step`'s.

    Returns the last step's tuple: the state after its reset, then its
    pre-reset positions, reward, terminated and truncated.  ``reward_acc``
    gains every step's reward, one float32 add a step in step order, so
    every output equals T calls of :func:`env_step` bit for bit (whose
    chain is this path's plain version).  Only where :func:`fused_block`
    holds: CUDA tensors of at most :data:`ENV_MAX_OBJECTS` objects;
    ``VectorEnv.step`` runs any other block step by step."""
    return _env_kernel(cp, positions, actions, puzzle_idx, env=(steps, achieved, init_pos, init_achieved, max_steps),
                       reward_acc=reward_acc, block=True)


# The most batch dimensions kernels/env.cu reads through strides (kMaxDims);
# a state batch of more is flattened first.
_ENV_MAX_DIMS = 4
# The largest N of the env kernel's one-word path (kernels/env.cu kMaxObjects).
ENV_MAX_OBJECTS = 32


def fused_block(device: torch.device, n: int) -> bool:
    """Whether a (T, B) block of actions of states of ``n`` objects on
    ``device`` runs as one launch of the env kernel's multi-step path
    (:func:`env_steps`): on a card, up to :data:`ENV_MAX_OBJECTS` objects;
    else as T calls of :func:`env_step`."""
    return device.type == "cuda" and n <= ENV_MAX_OBJECTS


def _index_operand(x, batch, dev, what: str):
    """(tensor, element bytes, strides) of an int tensor broadcast to
    ``batch`` on ``dev``: int32 and int64 are read as they are, other types
    cast to int64."""
    if x.device != dev:
        x = x.to(dev)
    if x.dtype not in (torch.int32, torch.int64):
        x = x.long()
    if x.shape != batch:
        try:
            x = x.expand(batch)
        except RuntimeError as err:
            raise ValueError(f"{what} of shape {tuple(x.shape)} does not broadcast to {tuple(batch)}") from err
    return x, x.element_size(), x.stride()


# Per puzzle (by id, with a weak reference that confirms it): what the env
# kernel reads of its tables, checked once; a step's host time is its enqueue.
# An entry is [weakref, device, (P, goal_pos, table pointers), bit tables or
# None]; the entries of dead puzzles go when a new one comes in.
_ENV_TABLES: dict = {}


def _env_tables(cp: CompiledPuzzle, dev: torch.device, bits: bool = False):
    """(P, goal_pos, table pointers) of ``cp`` for ``kernels/env.cu``, its
    tables checked (types, shapes, device, layout) at the first call.  With
    ``bits``, the static-block and push pointers are those of the tables
    bit-packed for the multi-step path (:func:`_pack_bits`), made at the
    puzzle's first block of actions."""
    hit = _ENV_TABLES.get(id(cp))
    if hit is None or hit[0]() is not cp or hit[1] != dev:
        N, H, W, K = cp.n, cp.height, cp.width, 2 * cp.delta + 1
        P = cp.init_state.shape[0] if cp.init_state.dim() == 3 else 1
        lead = (P,) if cp.init_state.dim() == 3 else ()
        for name, x, dtype, shape in (
            ("static_block", cp.static_block, torch.bool, (*lead, 4, N, H, W)),
            ("push", cp.push, torch.bool, (*lead, 4, N, N, K, K)), ("obj_mask", cp.obj_mask, torch.bool, (*lead, N)),
            ("goal_pos", cp.goal_pos, torch.int32, (*lead, N, 2)), ("goal_mask", cp.goal_mask, torch.bool, (*lead, N)),
        ):
            if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev or not x.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous {dtype} {shape} tensor on {dev}")
        goal_pos = cp.goal_pos if cp.goal_pos.data_ptr() % 8 == 0 else cp.goal_pos.clone()  # read as 8-byte cells
        hit = [weakref.ref(cp), dev, (P, goal_pos, [cp.static_block.data_ptr(), cp.push.data_ptr(),
                                                    cp.obj_mask.data_ptr(), goal_pos.data_ptr(),
                                                    cp.goal_mask.data_ptr()]), None]
        for key in [k for k, v in _ENV_TABLES.items() if v[0]() is None]:
            del _ENV_TABLES[key]
        _ENV_TABLES[id(cp)] = hit
    if not bits:
        return hit[2]
    if hit[3] is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("env_steps: run a block of this puzzle once before capturing one into a CUDA graph "
                               "(its bit-packed tables are made at the first)")
        lead = cp.init_state.dim() == 3
        hit[3] = tuple(_pack_bits(x if lead else x[None]) for x in (cp.static_block, cp.push))
    P, goal_pos, ptrs = hit[2]
    return P, goal_pos, [x.data_ptr() for x in hit[3]] + ptrs[2:]


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(P, ...) bool -> (P, ceil(L / 32)) int32: each of the P rows' L values
    as bits, value k at bit k % 32 of word k // 32."""
    flat = x.reshape(x.shape[0], -1).to(torch.int64)
    flat = torch.nn.functional.pad(flat, (0, -flat.shape[1] % 32))
    words = (flat.reshape(x.shape[0], -1, 32) << torch.arange(32, device=x.device)).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


# What a launch's geometry alone decides, by geometry (B, N, the puzzle's
# sizes, the index operands' types and strides, max_steps, the path): the
# ctypes ``geom`` array, and for the environment's step the layout of the
# two output buffers (element counts, then each output's buffer, size,
# stride and offset).  A step's host time is its enqueue.
_ENV_GEOMS: dict = {}


def _env_geometry(key):
    hit = _ENV_GEOMS.get(key)
    if hit is not None:
        return hit
    B, N, H, W, delta, P, value, act_bytes, pidx_bytes, max_steps, path, batch, strides, act_strides, \
        pidx_strides, env, T, tstride = key
    dims = len(batch) or 1
    pad = (0,) * (_ENV_MAX_DIMS - dims)
    geom = (ctypes.c_longlong * (14 + 4 * _ENV_MAX_DIMS))(
        B, N, H, W, delta, P, value, act_bytes, pidx_bytes,
        (1 << 63) - 1 if max_steps is None else min(int(max_steps), (1 << 63) - 1), path, dims,
        *(batch or (1,)), *pad, *(strides or (0,)), *pad, *(act_strides or (0,)), *pad,
        *(pidx_strides or (0,)), *pad, T, tstride)
    layout = None
    if env:
        # One int32 buffer: next_pos, the positions after the reset (8-byte
        # aligned: 8BN bytes in), steps, achieved, the reward's bits; one bool
        # buffer: terminated, truncated.  (buffer, size, stride, offset) of
        # env_step's outputs, in its order.
        cells, stride, scalars = (B, N, 2), (2 * N, 2, 1), 4 * B * N
        layout = (4 * B * N + 3 * B, 2 * B, (
            (0, cells, stride, 2 * B * N), (0, (B,), (1,), scalars), (0, (B,), (1,), scalars + B),
            (0, cells, stride, 0), (0, (B,), (1,), scalars + 2 * B), (1, (B,), (1,), 0), (1, (B,), (1,), B)))
    if len(_ENV_GEOMS) >= 256:  # a caller that varies its batch without end
        _ENV_GEOMS.clear()
    _ENV_GEOMS[key] = hit = (geom, layout)
    return hit


def _env_kernel(cp: CompiledPuzzle, state: torch.Tensor, action, puzzle_idx, env=None,
                wide: Optional[bool] = None, reward_acc: Optional[torch.Tensor] = None, block: bool = False,
                out=None):
    """One launch of ``kernels/env.cu``: the transition of every state of
    ``state`` (..., N, 2), and with ``env`` = (steps, achieved, init_pos,
    init_achieved, max_steps) the environment's step, adding each reward to
    ``reward_acc`` where given and writing reward and flags into ``out``
    where given (see :func:`env_step`).  With ``block``,
    ``action`` is a (T, B) block and the launch runs T steps of the
    environment (:func:`env_steps`; a (B, N, 2) batch, the one-word path).
    Outputs from ``torch.empty`` (two buffers: the int32 and float32
    outputs, the flags), no host read, the launch on the current stream, so
    a CUDA graph may capture it.  Returns :func:`env_step`'s tuple (the
    transition alone: ``(next_pos,)``).  ``wide``: the kernel's path, by N
    where None (the wide path takes any N, so the tests run it on narrow
    states too)."""
    dev, N = state.device, cp.n
    shape = state.shape
    if len(shape) < 2 or shape[-2:] != (N, 2) or state.dtype != torch.int32:
        raise ValueError(f"states: expected (..., {N}, 2) int32, got {tuple(shape)} {state.dtype}")
    if (cp.init_state.dim() == 3) != (puzzle_idx is not None):
        raise ValueError("puzzle_idx names each state's puzzle of a stacked puzzle, and only of one")
    if block and (env is None or wide or len(shape) != 3 or N > ENV_MAX_OBJECTS):
        raise ValueError("a block of actions needs the environment's step on a (B, N, 2) batch of at most "
                         f"{ENV_MAX_OBJECTS} objects")
    P, goal_pos, table_ptrs = _env_tables(cp, dev, bits=block)
    batch = shape[:-2]
    if len(batch) > _ENV_MAX_DIMS:
        batch = (math.prod(batch),)
        state = state.reshape(*batch, N, 2)
        action = action.expand(shape[:-2]).reshape(batch) if isinstance(action, torch.Tensor) else action
        puzzle_idx = None if puzzle_idx is None else puzzle_idx.expand(shape[:-2]).reshape(batch)
    # A state's (N, 2) cells contiguous and 8-byte aligned, batch strides even.
    strides = state.stride()
    if strides[-1] != 1 or (N > 1 and strides[-2] != 2) or any(s % 2 for s in strides[:-2]) or state.data_ptr() % 8:
        state = state.contiguous()
        if state.data_ptr() % 8:
            state = state.clone()
        strides = state.stride()
    T = tstride = 0
    if block:
        if not isinstance(action, torch.Tensor) or action.dim() != 2 or action.shape[1] != batch[0] \
                or action.shape[0] < 1:
            got = tuple(action.shape) if isinstance(action, torch.Tensor) else type(action).__name__
            raise ValueError(f"a block of actions: expected (T, {batch[0]}) with T >= 1, got {got}")
        act, act_bytes, act_strides = _index_operand(action, action.shape, dev, "actions")
        T, tstride, act_strides = act.shape[0], act_strides[0], act_strides[1:]
        value = 0
    elif isinstance(action, torch.Tensor):
        act, act_bytes, act_strides = _index_operand(action, batch, dev, "action")
        value = 0
    else:
        value = int(action)
        if not 0 <= value < 4:
            raise ValueError(f"action {value} outside [0, 4)")
        act, act_bytes, act_strides = None, 0, ()
    pidx, pidx_bytes, pidx_strides = None, 0, ()
    if puzzle_idx is not None:
        pidx, pidx_bytes, pidx_strides = _index_operand(puzzle_idx, batch, dev, "puzzle_idx")
    B = math.prod(batch)
    max_steps = None if env is None else env[4]
    geom, layout = _env_geometry((
        B, N, cp.height, cp.width, cp.delta, P, value, act_bytes, pidx_bytes, max_steps,
        0 if wide is None else (2 if wide else 1), tuple(batch), strides[:-2], tuple(act_strides),
        tuple(pidx_strides), env is not None, T, tstride))
    ptr = [state.data_ptr(), None if act is None else act.data_ptr(), None if pidx is None else pidx.data_ptr()]
    if env is None:
        if reward_acc is not None:
            raise ValueError("reward_acc needs the environment's step")
        next_pos = torch.empty(shape, dtype=torch.int32, device=dev)
        outs = (next_pos,)
        ptr += [None, None, *table_ptrs, None, None, next_pos.data_ptr()] + [None] * 7
    else:
        steps, achieved, init_pos, init_achieved, _ = env
        for name, x, dtype, want in (
            ("steps", steps, torch.int32, (B,)), ("achieved", achieved, torch.int32, (B,)),
            ("init_pos", init_pos, torch.int32, (P, N, 2)), ("init_achieved", init_achieved, torch.int32, (P,)),
            ("reward_acc", reward_acc, torch.float32, (B,)),
        ):
            if x is not None and (x.dtype != dtype or x.shape != want or x.device != dev or not x.is_contiguous()):
                raise ValueError(f"{name}: expected a contiguous {dtype} {want} tensor on {dev}")
        if init_pos.data_ptr() % 8:
            init_pos = init_pos.clone()
        n_words, n_flags, views = layout
        bufs = (torch.empty((n_words,), dtype=torch.int32, device=dev),
                torch.empty((n_flags,), dtype=torch.bool, device=dev))
        outs = tuple(bufs[k].as_strided(size, stride, offset) for k, size, stride, offset in views)
        outs = outs[:4] + (outs[4].view(torch.float32),) + outs[5:]
        if out is not None:
            for name, x, like in zip(("reward", "terminated", "truncated"), out, outs[4:]):
                if x.dtype != like.dtype or x.shape != (B,) or x.device != dev or not x.is_contiguous():
                    raise ValueError(f"out {name}: expected a contiguous {like.dtype} {(B,)} tensor on {dev}")
            outs = outs[:4] + tuple(out)
        ptr += [steps.data_ptr(), achieved.data_ptr(), *table_ptrs, init_pos.data_ptr(), init_achieved.data_ptr()]
        ptr += [x.data_ptr() for x in (outs[3], outs[0], outs[1], outs[2], outs[4], outs[5], outs[6])]
        ptr.append(None if reward_acc is None else reward_acc.data_ptr())
    if B == 0:
        return outs
    rc = launch_on(dev, _build.load("env").pw_env_step, *ptr, ctypes.addressof(geom))
    if rc != 0:
        raise RuntimeError(f"pw_env_step launch failed: CUDA error {rc}")
    count_launch("env.steps" if block else "env.step")
    return outs


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
