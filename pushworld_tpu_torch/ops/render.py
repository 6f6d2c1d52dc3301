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

Framed observations over a stacked pool (PushWorld's ``standard_padding``:
reference gym_env.py with utils/env_utils.py:72-91): each rollout's state is
rendered with its own puzzle (``puzzle_idx``) into one frame of H_f x W_f
cells, centred at ``top = (H_f - h) // 2``, ``left = (W_f - w) // 2``, every
other cell all-zero.  :func:`compile_framed_render_tables` builds the
stacked tables; :func:`render_framed_onehot_batched` is one launch of the
kernel's framed variant on a CUDA tensor and
:func:`render_framed_onehot_batched_reference` on a CPU tensor, bit-equal.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.core.puzzle import Colors
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.kernels import _build, count_launch, launch_on
from pushworld_tpu_torch.utils import tracing

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


def _base_classes(puzzle) -> np.ndarray:
    """(H, W) int8 static cell classes of ``puzzle``: goals, then agent-only
    walls over them, then walls over both."""
    base = np.zeros((puzzle.height, puzzle.width), np.int8)
    for k in range(puzzle.num_goals):
        gx, gy = puzzle.goal_state[k]
        for cx, cy in puzzle.goal_cells[k]:
            base[gy + cy, gx + cx] = 6
    for x, y in puzzle.agent_wall_cells:
        base[y, x] = 2
    for x, y in puzzle.wall_cells:
        base[y, x] = 1
    return base


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
    base[: puzzle.height, : puzzle.width] = _base_classes(puzzle)

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


def compile_framed_render_tables(puzzles, frame, n: Optional[int] = None,
                                 device: DeviceLike = "cuda") -> RenderTables:
    """Stacked render tensors of ``puzzles`` (P of them) for observations in
    one frame of ``frame`` = (H_f, W_f) cells, on ``device``.

    Each puzzle's static classes are placed at its centre offset in the
    frame (``top = (H_f - h) // 2``, ``left = (W_f - w) // 2``, h x w its
    size with the border); pad cells are class 0.  ``n``: the movables of a
    state (a stacked :class:`CompiledPuzzle`'s ``n``; the most of any
    puzzle where None).  Returns a dict of tensors:
        base: (P, H_f, W_f) int8 cell classes, placed in the frame.
        obj_cells: (P, n, C, 2) int16 per-movable cell offsets; obj_mask
              (P, n, C) (False for a puzzle's padding movables).
        obj_class: (P, n) int8 cell class per movable.
        geom: (P, 4) int32 each puzzle's top, left, height and width in the
              frame.
    Raises ValueError for a puzzle larger than the frame."""
    with tracing.span("pw.rollout.render_tables"):
        dev = resolve_device(device)
        Hf, Wf = (int(v) for v in frame)
        P = len(puzzles)
        most = max(p.num_movables for p in puzzles)
        n = most if n is None else int(n)
        if n < most:
            raise ValueError(f"n = {n}: a puzzle has {most} movables")
        C = max(len(c) for p in puzzles for c in p.movable_cells)
        base = np.zeros((P, Hf, Wf), np.int8)
        obj_cells = np.zeros((P, n, C, 2), np.int16)
        obj_mask = np.zeros((P, n, C), bool)
        obj_class = np.zeros((P, n), np.int8)
        geom = np.zeros((P, 4), np.int32)
        for i, p in enumerate(puzzles):
            if p.height > Hf or p.width > Wf:
                raise ValueError(f"puzzle {i}: {p.height} x {p.width} cells do not fit a {Hf} x {Wf} frame")
            top, left = (Hf - p.height) // 2, (Wf - p.width) // 2
            base[i, top: top + p.height, left: left + p.width] = _base_classes(p)
            geom[i] = (top, left, p.height, p.width)
            for k, cells in enumerate(p.movable_cells):
                for j, (cx, cy) in enumerate(sorted(cells)):
                    obj_cells[i, k, j] = (cx, cy)
                    obj_mask[i, k, j] = True
                obj_class[i, k] = 3 if k == 0 else (4 if k <= p.num_goals else 5)
        tables = {"base": base, "obj_cells": obj_cells, "obj_mask": obj_mask, "obj_class": obj_class, "geom": geom}
        return {k: torch.as_tensor(v, device=dev) for k, v in tables.items()}


# The framed kernel's split and buffers (``kernels/render.cu``, the same
# formulas): CTAs an SM, its warps, a warp's slab and ring of slabs, the zeros
# pad rows are copied from, and the 128-byte line (in floats) that every
# share and copy starts and ends on.
FRAMED_CTAS_PER_SM = 2
FRAMED_WARPS = 8
FRAMED_SLAB_BYTES = 4096
FRAMED_RING = 2
FRAMED_ZERO_BYTES = 32768
FRAMED_LINE = 32


def framed_ctas(B: int, H: int, W: int, sms: int) -> int:
    """The CTAs of one framed launch of B states on H x W frames, on a card
    of ``sms`` multiprocessors: :data:`FRAMED_CTAS_PER_SM` an SM, at most one
    a round of slabs (one a warp) of output."""
    lines = -(-B * H * W * NUM_CHANNELS // FRAMED_LINE)
    per_round = FRAMED_WARPS * FRAMED_SLAB_BYTES // (4 * FRAMED_LINE)
    return max(1, min(FRAMED_CTAS_PER_SM * sms, -(-lines // per_round)))


def framed_shares(B: int, H: int, W: int, ctas: int) -> List[Tuple[int, int]]:
    """Each CTA's share ``[f0, f1)`` of a framed launch's output, in floats of
    its (B, H, W, 6) run: the run's L 128-byte lines split evenly, CTA c
    taking lines ``[L c / ctas, L (c + 1) / ctas)``, the last share clipped
    to the run's end."""
    F = B * H * W * NUM_CHANNELS
    L = -(-F // FRAMED_LINE)
    return [(min(F, FRAMED_LINE * (L * c // ctas)), min(F, FRAMED_LINE * (L * (c + 1) // ctas))) for c in range(ctas)]


def framed_bulk(H: int, W: int) -> bool:
    """Whether the framed kernel writes by bulk copies on H x W frames: the
    frame's grid (4 bytes a cell), the warps' rings, the zeros and two carry
    lines fit a CTA's shared memory."""
    buffers = FRAMED_WARPS * FRAMED_RING * FRAMED_SLAB_BYTES + FRAMED_ZERO_BYTES + 2 * 4 * FRAMED_LINE
    return 4 * H * W + buffers <= RENDER_MAX_SHARED_BYTES


def framed_bulk_bytes(B: int, H: int, W: int) -> int:
    """The output bytes one framed launch writes by bulk copy: every whole
    128-byte line of its run (a line that frame boundaries cut is assembled
    before its copy), all but the run's last line where that is not whole;
    0 where the buffers do not fit (:func:`framed_bulk`)."""
    if not framed_bulk(H, W):
        return 0
    return 4 * FRAMED_LINE * (B * H * W * NUM_CHANNELS // FRAMED_LINE)


def is_framed(tables: RenderTables) -> bool:
    """Whether ``tables`` are :func:`compile_framed_render_tables`'s."""
    return "geom" in tables


def render_framed_onehot_batched(tables: RenderTables, states: torch.Tensor, puzzle_idx: torch.Tensor,
                                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H_f, W_f, NUM_CHANNELS) float32 framed observations of states
    (B, n, 2) int32, state b of puzzle ``puzzle_idx[b]`` ((B,) int32, in
    [0, P): unchecked, as ``VectorEnv.start``), written into ``out`` where
    given (a contiguous tensor of that shape on the states' device) and
    returned.  Every float of the output is written, the pad's too: a cell
    outside its puzzle's rectangle (``geom``) is all-zero.

    On a CUDA tensor this is one launch of ``kernels/render.cu``'s framed
    variant (no host read, so a CUDA graph may capture it; persistent CTAs,
    :func:`framed_ctas`, each writing its :func:`framed_shares` share by
    bulk copies), which raises for a frame whose 4 H_f W_f bytes exceed
    :data:`RENDER_MAX_SHARED_BYTES`; on a CPU tensor it runs
    :func:`render_framed_onehot_batched_reference`.  The two are
    bit-equal."""
    if states.device.type == "cpu":
        obs = render_framed_onehot_batched_reference(tables, states, puzzle_idx)
        return obs if out is None else out.copy_(obs)
    return _render_framed_cuda(tables, states, puzzle_idx, out)


def _render_framed_cuda(tables: RenderTables, states: torch.Tensor, puzzle_idx: torch.Tensor,
                        out: Optional[torch.Tensor]) -> torch.Tensor:
    base, cells, mask, cls, geom = (tables[k] for k in ("base", "obj_cells", "obj_mask", "obj_class", "geom"))
    P, H, W = base.shape
    N, C = mask.shape[1:]
    dev = states.device
    if states.dim() != 3 or states.shape[1:] != (N, 2) or states.dtype != torch.int32:
        raise ValueError(f"states: expected (B, {N}, 2) int32, got {tuple(states.shape)} {states.dtype}")
    B = states.shape[0]
    for name, x, dtype, shape in (("base", base, torch.int8, (P, H, W)),
                                  ("obj_cells", cells, torch.int16, (P, N, C, 2)),
                                  ("obj_mask", mask, torch.bool, (P, N, C)), ("obj_class", cls, torch.int8, (P, N)),
                                  ("geom", geom, torch.int32, (P, 4)), ("puzzle_idx", puzzle_idx, torch.int32, (B,))):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} {shape} tensor on {dev}")
    if geom.data_ptr() % 16:
        raise ValueError("geom: expected a 16-byte aligned tensor")
    if 4 * H * W > RENDER_MAX_SHARED_BYTES:
        raise ValueError(f"render.framed: a {H} x {W} frame needs {4 * H * W} bytes of shared memory a CTA, "
                         f"more than the {RENDER_MAX_SHARED_BYTES} a CTA can have")
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
    rc = launch_on(dev, lib.pw_render_onehot_framed, states.data_ptr(), puzzle_idx.data_ptr(), base.data_ptr(),
                   cells.data_ptr(), mask.data_ptr(), cls.data_ptr(), geom.data_ptr(), out.data_ptr(),
                   B, N, C, H, W)
    if rc != 0:
        raise RuntimeError(f"pw_render_onehot_framed launch failed: CUDA error {rc}")
    count_launch("render.framed")
    return out


def render_framed_onehot_batched_reference(tables: RenderTables, states: torch.Tensor,
                                           puzzle_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`render_framed_onehot_batched`, as the
    kernel computes it: each frame cell's class is that of the
    highest-indexed movable with a cell on it (cells outside the puzzle's
    own grid draw nothing), else its base class; channel 0 is the base's
    wall, channels 1-5 the class's.  A cell outside the puzzle's rectangle
    in the frame (``geom``) is pad, every channel 0, whatever ``base`` holds
    there (:func:`compile_framed_render_tables` leaves it 0).  For valid
    states (movables in the grid, not overlapping) this is the puzzle's
    one-hot centred in the frame.  A fresh contiguous tensor."""
    base = tables["base"]
    P, H, W = base.shape
    N, C = tables["obj_mask"].shape[1:]
    B, HW, dev = states.shape[0], H * W, states.device
    p = puzzle_idx.long()
    geom = tables["geom"][p].long()  # (B, 4)
    top, left, h, w = (geom[:, i, None, None] for i in range(4))
    cells = tables["obj_cells"][p].long()  # (B, N, C, 2)
    xs = states[:, :, None, 0].long() + cells[..., 0]  # (B, N, C)
    ys = states[:, :, None, 1].long() + cells[..., 1]
    ok = tables["obj_mask"][p] & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    at = torch.where(ok, (ys + top) * W + xs + left, HW).reshape(B, -1)
    k = torch.arange(1, N + 1, device=dev)[None, :, None].expand(B, N, C).reshape(B, -1)
    topk = torch.zeros((B, HW + 1), dtype=torch.long, device=dev)
    topk.scatter_reduce_(1, at, k, reduce="amax")  # the highest movable on each cell, 0 for none
    topk = topk[:, :HW]
    row, col = torch.arange(H, device=dev)[None, :, None], torch.arange(W, device=dev)[None, None, :]
    inside = (row >= top) & (row < top + h) & (col >= left) & (col < left + w)  # (B, H, W)
    b_cls = torch.where(inside, base[p], 0).reshape(B, HW).long()
    o_cls = tables["obj_class"][p].long()  # (B, N)
    cls = torch.where(topk > 0, o_cls.gather(1, (topk - 1).clamp(min=0)), b_cls)
    channels = torch.arange(2, NUM_CHANNELS + 1, device=dev)
    out = torch.cat([(b_cls == 1)[..., None], cls[..., None] == channels], -1).to(torch.float32)
    return out.reshape(B, H, W, NUM_CHANNELS)
