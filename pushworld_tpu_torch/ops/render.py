"""Device-side observation rendering for batched rollouts.

Port of the JAX package's ``ops/render.py``.  The reference environments
return pixel observations rendered on host per step (reference:
python3/src/pushworld/puzzle.py:426-469 via utils/env_utils.py:44-91).  This
module renders cell-resolution observations from a puzzle's render tables
and state tensors on the device that holds them: no host round-trip per step.

Formats:
- :func:`render_cells_class` — (H, W) int8 cell classes (0 empty, 1 wall,
  2 agent-wall, 3 agent, 4 goal object, 5 movable, 6 goal).
- :func:`render_cells_rgb` — (H, W, 3) uint8 fill-color image at one pixel
  per cell (the reference's border strokes are a host-rendering concern;
  ``Puzzle.render`` remains the pixel-exact renderer).
- :func:`render_cells_onehot` / :func:`render_cells_onehot_batched` —
  (H, W, C) float32 semantic channels [wall, agent-wall, agent, goal-object,
  movable, goal], the natural input encoding for policies on the device.

The render tables are a dict of tensors on one device
(:func:`compile_render_tables`); states follow that device.

:func:`render_cells_onehot_batched` is one launch of ``kernels/render.cu``
on a CUDA tensor and its plain version
(:func:`render_cells_onehot_batched_reference`) on a CPU tensor; the two are
bit-equal.
"""

from typing import Dict, Optional

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.core.puzzle import Colors
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.kernels import _build, count_launch, launch_on

# Channel indices for the one-hot format.
C_WALL, C_AGENT_WALL, C_AGENT, C_GOAL_OBJ, C_MOVABLE, C_GOAL = range(6)
NUM_CHANNELS = 6

_PALETTE = np.array(
    [
        [255, 255, 255],  # empty
        list(Colors.WALL),
        list(Colors.AGENT_WALL),
        list(Colors.AGENT),
        list(Colors.GOAL_OBJECT),
        list(Colors.MOVABLE),
        list(Colors.GOAL_BORDER),  # goal cells drawn with the goal outline color
    ],
    np.uint8,
)

RenderTables = Dict[str, torch.Tensor]


def compile_render_tables(puzzle, cp: CompiledPuzzle, device: DeviceLike = "cuda") -> RenderTables:
    """Static render tensors for one puzzle, on ``device``.

    Returns a dict of tensors:
        base: (H, W) int8 cell classes for static content (0 empty, 1 wall,
              2 agent-wall, 6 goal).
        obj_cells: (N, C, 2) int16 per-movable cell offsets; obj_mask (N, C).
        obj_class: (N,) int8 cell class per movable (3 agent / 4 goal-obj /
              5 movable).
    """
    dev = resolve_device(device)
    H, W, N = cp.height, cp.width, cp.n
    base = np.zeros((H, W), np.int8)
    for k in range(puzzle.num_goals):
        gx, gy = puzzle.goal_state[k]
        for cx, cy in puzzle.goal_cells[k]:
            base[gy + cy, gx + cx] = 6
    for x, y in puzzle.agent_wall_cells:
        base[y, x] = 2
    for x, y in puzzle.wall_cells:
        base[y, x] = 1

    cmax = max(len(c) for c in puzzle.movable_cells)
    obj_cells = np.zeros((N, cmax, 2), np.int16)
    obj_mask = np.zeros((N, cmax), bool)
    obj_class = np.zeros((N,), np.int8)
    for i, cells in enumerate(puzzle.movable_cells):
        for j, (cx, cy) in enumerate(sorted(cells)):
            obj_cells[i, j] = (cx, cy)
            obj_mask[i, j] = True
        obj_class[i] = 3 if i == 0 else (4 if i <= puzzle.num_goals else 5)
    tables = {"base": base, "obj_cells": obj_cells, "obj_mask": obj_mask, "obj_class": obj_class}
    return {k: torch.as_tensor(v, device=dev) for k, v in tables.items()}


def _cell_rows(tables: RenderTables, states: torch.Tensor):
    """Flat cell index ``y * W + x`` of every movable cell of every state,
    (B, N * C) int64, with the cells that draw nothing (padding of the cell
    lists, cells outside the grid) routed to the spare index ``H * W``."""
    H, W = tables["base"].shape
    cells = tables["obj_cells"].long()  # (N, C, 2)
    mask = tables["obj_mask"]  # (N, C)
    B = states.shape[0]
    xs = states[:, :, None, 0].long() + cells[None, :, :, 0]  # (B, N, C)
    ys = states[:, :, None, 1].long() + cells[None, :, :, 1]
    ok = mask[None] & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    return torch.where(ok, ys * W + xs, H * W).reshape(B, -1)


def render_cells_class(tables: RenderTables, state: torch.Tensor) -> torch.Tensor:
    """Cell-class grid, int8: (H, W) for one state (N, 2), or (B, H, W) for a
    batch of states (B, N, 2).

    Movables are scattered over the static base, the agent last (on top).
    An index outside a CUDA tensor is a device-side fault, so the cells that
    draw nothing go to one spare cell behind the grid, which is cropped
    (the JAX function routes them out of bounds and lets the scatter drop
    them).  For valid states (movables in bounds, not overlapping) no cell
    is written twice by different movables, so the result is defined."""
    single = state.dim() == 2
    states = state[None] if single else state
    base = tables["base"]
    H, W = base.shape
    cls = tables["obj_class"]  # (N,)
    B, N = states.shape[0], cls.shape[0]
    C = tables["obj_mask"].shape[1]
    rows = _cell_rows(tables, states)  # (B, N * C)
    vals = cls[:, None].expand(N, C).reshape(1, -1).expand(B, -1)
    grid = torch.cat(
        [base.reshape(1, -1).expand(B, -1), base.new_zeros((B, 1))], dim=1
    )  # (B, H * W + 1), a fresh tensor
    grid.scatter_(1, rows, vals)
    grid.scatter_(1, rows[:, :C], vals[:, :C])  # the agent again, on top
    grid = grid[:, : H * W].reshape(B, H, W)
    return grid[0] if single else grid


def render_cells_rgb(tables: RenderTables, state: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 fill-color observation (batched like
    :func:`render_cells_class`)."""
    grid = render_cells_class(tables, state)
    return torch.as_tensor(_PALETTE, device=grid.device)[grid.long()]


def render_cells_onehot(tables: RenderTables, state: torch.Tensor) -> torch.Tensor:
    """(H, W, NUM_CHANNELS) float32 semantic observation (batched like
    :func:`render_cells_class`).  Class 0 (empty) is the all-zero row."""
    grid = render_cells_class(tables, state)
    channels = torch.arange(1, NUM_CHANNELS + 1, device=grid.device, dtype=grid.dtype)
    return (grid.unsqueeze(-1) == channels).to(torch.float32)


# The shared memory a CTA of kernels/render.cu may have (an H100's 227 KB):
# the kernel stages a state's grid there, 4 bytes a cell.
RENDER_MAX_SHARED_BYTES = 232448


def render_cells_onehot_batched(tables: RenderTables, states: torch.Tensor,
                                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, NUM_CHANNELS) float32 semantic observations for a state
    batch (B, N, 2), written into ``out`` where given (a contiguous tensor of
    that shape on the states' device) and returned.

    On a CUDA tensor this is one launch of ``kernels/render.cu``, which
    raises for a grid whose 4 H W bytes exceed
    :data:`RENDER_MAX_SHARED_BYTES`; on a CPU tensor it runs
    :func:`render_cells_onehot_batched_reference`.  The two are bit-equal
    (for valid states: see the reference)."""
    if states.device.type == "cpu":
        obs = render_cells_onehot_batched_reference(tables, states)
        return obs if out is None else out.copy_(obs)
    return _render_onehot_cuda(tables, states, out)


def _render_onehot_cuda(tables: RenderTables, states: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of ``kernels/render.cu``: no host read, the launch on the
    current stream, so a CUDA graph may capture it."""
    base, cells, mask, cls = tables["base"], tables["obj_cells"], tables["obj_mask"], tables["obj_class"]
    H, W = base.shape
    N, C = mask.shape
    dev = states.device
    if states.dim() != 3 or states.shape[1:] != (N, 2) or states.dtype != torch.int32:
        raise ValueError(f"states: expected (B, {N}, 2) int32, got {tuple(states.shape)} {states.dtype}")
    for name, x, dtype, shape in (("base", base, torch.int8, (H, W)), ("obj_cells", cells, torch.int16, (N, C, 2)),
                                  ("obj_mask", mask, torch.bool, (N, C)), ("obj_class", cls, torch.int8, (N,))):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} {shape} tensor on {dev}")
    if 4 * H * W > RENDER_MAX_SHARED_BYTES:
        raise ValueError(f"render.onehot: a {H} x {W} grid needs {4 * H * W} bytes of shared memory a CTA, "
                         f"more than the {RENDER_MAX_SHARED_BYTES} a CTA can have")
    B = states.shape[0]
    if out is None:
        out = torch.empty((B, H, W, NUM_CHANNELS), dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (B, H, W, NUM_CHANNELS) or out.device != dev
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out: expected a contiguous, 16-byte aligned float32 {(B, H, W, NUM_CHANNELS)} tensor "
                         f"on {dev}")
    if B == 0:
        return out
    states = states.contiguous()
    if states.data_ptr() % 8:
        states = states.clone()
    lib = _build.load("render")
    rc = launch_on(dev, lib.pw_render_onehot, states.data_ptr(), base.data_ptr(), cells.data_ptr(),
                   mask.data_ptr(), cls.data_ptr(), out.data_ptr(), B, N, C, H, W)
    if rc != 0:
        raise RuntimeError(f"pw_render_onehot launch failed: CUDA error {rc}")
    count_launch("render.onehot")
    return out


def render_cells_onehot_batched_reference(tables: RenderTables, states: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`render_cells_onehot_batched`, written
    channel by channel without a class grid.

    The static channels of the base grid are copied into the output once
    (the one pass over its B * H * W * 6 floats), then every movable cell
    writes its five dynamic channels: its class's channel 1, agent-wall and
    goal 0.  (The JAX function computes the same occupancies as one-hot
    matrix products.)  Channel semantics match the per-state renderer
    exactly FOR VALID STATES (movable cells in bounds): movables paint over
    agent-wall and goal base cells; walls are never covered; movables never
    overlap each other.  The result is materialised: a fresh contiguous
    tensor."""
    base = tables["base"]
    H, W = base.shape
    cls = tables["obj_class"].long()  # (N,)
    B, N = states.shape[0], cls.shape[0]
    C = tables["obj_mask"].shape[1]
    dev = states.device
    channels = torch.arange(1, NUM_CHANNELS + 1, device=dev, dtype=base.dtype)
    base_onehot = (base.reshape(-1, 1) == channels).to(torch.float32)  # (H * W, 6)
    # One spare row behind the last state's grid takes the cells that draw nothing.
    out = torch.empty((B * H * W + 1, NUM_CHANNELS), dtype=torch.float32, device=dev)
    out[: B * H * W].view(B, H * W, NUM_CHANNELS).copy_(base_onehot)
    cell = _cell_rows(tables, states)  # (B, N * C), H * W = draws nothing
    row = torch.arange(B, device=dev)[:, None] * (H * W) + cell
    row = torch.where(cell == H * W, B * H * W, row).reshape(-1)  # (B * N * C,)
    # Per movable cell, the values of channels 1..5 (every channel but wall).
    dyn = (cls[:, None] - 1 == torch.arange(1, NUM_CHANNELS, device=dev)).to(torch.float32)  # (N, 5)
    vals = dyn[:, None, :].expand(N, C, NUM_CHANNELS - 1).reshape(1, N * C, -1)
    vals = vals.expand(B, -1, -1).reshape(-1, NUM_CHANNELS - 1)
    out[:, 1:].index_put_((row[:, None], torch.arange(NUM_CHANNELS - 1, device=dev)[None, :]), vals)
    return out[: B * H * W].view(B, H, W, NUM_CHANNELS)
