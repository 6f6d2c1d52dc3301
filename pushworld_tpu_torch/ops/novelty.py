"""Batched width-based novelty heuristic with device-resident visited tables.

Port of the JAX package's ``ops/novelty.py``.  Semantics follow the
reference novelty heuristic (reference: cpp/src/heuristics/novelty.cc:30-77):
novelty 1 if any *moved* object is at a never-seen position, 2 if any
(moved object, other object) position pair is unseen, else 3; the visited
structures absorb every evaluated state.

- single-object visited positions are an exact dense table ``(N, H*W)``;
- pair visits use a FACTORED hash table ``T[h(i, pi), h(j, pj)]`` over an
  ``S x S`` grid of buckets (``S = 2**(pair_bits // 2)``).  ``X[b, k]`` ORs
  the moved-object atoms of state ``b`` and ``Y[b, l]`` the atoms of all its
  objects; the update is ``T |= (X^T Y + Y^T X) > 0`` and a pair of state
  ``b`` is unseen iff some ``(k, l)`` with ``X[b, k] & Y[b, l]`` has
  ``T[k, l] = 0``, counted as ``sum(Y) - Y @ T`` minus the own column.  The
  two products are plain GEMMs on bf16 0/1 operands; every value they give is
  a small count (the query side at most N <= 20, exact in bf16) or only
  tested for being positive (the update side).

That GEMM form is :func:`novelty_score_and_update_reference`, run on CPU
tensors.  On CUDA tensors :func:`novelty_score_and_update` launches
``kernels/novelty.cu`` instead: a state has at most N atoms, so it reads
and writes at most N^2 cells of the table by direct gathers and scatters
(no (B, S) indicator rows, no GEMM over the S x S table).  The two are
bit-equal.

Hash collisions only perturb search order (see the JAX module's docstring);
the scores here are bit-identical to the JAX function's, collisions
included.  States in one batch are scored against the tables as of the
start of the batch, then all their updates are applied at once.  The tables
are updated IN PLACE.
"""

import os
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.kernels import _build, count_launch, launch_on
from pushworld_tpu_torch.ops.hashset import mul32

# Pair-table size knob, as in the JAX package (read once at import).
_DEFAULT_PAIR_BITS = int(os.environ.get("PW_NOVELTY_PAIR_BITS", "24"))


@dataclass
class NoveltyTables:
    seen_pos: torch.Tensor  # bool (N, HW)
    pair_table: torch.Tensor  # bfloat16 (S, S), values 0/1, symmetric
    n: int
    width: int
    height: int
    pair_bits: int

    @property
    def side(self) -> int:
        return 1 << (self.pair_bits // 2)


def init_novelty(
    n: int,
    height: int,
    width: int,
    pair_bits: int = _DEFAULT_PAIR_BITS,
    device: DeviceLike = "cuda",
) -> NoveltyTables:
    dev = resolve_device(device)
    side = 1 << (pair_bits // 2)
    return NoveltyTables(
        seen_pos=torch.zeros((n, height * width), dtype=torch.bool, device=dev),
        pair_table=torch.zeros((side, side), dtype=torch.bfloat16, device=dev),
        n=n,
        width=width,
        height=height,
        pair_bits=pair_bits,
    )


def _atom_hash(i: torch.Tensor, p: torch.Tensor, side: int) -> torch.Tensor:
    """Deterministic mix of one (object, position) atom into [0, side);
    uint32 arithmetic in int64, bit-identical to the JAX function."""
    h = mul32(i.long() & 0xFFFFFFFF, 0x9E3779B1) ^ mul32(p.long() & 0xFFFFFFFF, 0xC2B2AE3D)
    h = mul32(h, 0x165667B1)
    h = h ^ (h >> 15)
    return h & (side - 1)


# The largest N (objects a state) the kernels take: one lane of a warp an
# object (kernels/novelty.cu kMaxObjects).
NOVELTY_MAX_OBJECTS = 32


def novelty_score_and_update(
    t: NoveltyTables,
    states: torch.Tensor,  # (B, N, 2) int32
    moved: torch.Tensor,  # (B, N) bool — which objects moved into this state
    valid: torch.Tensor,  # (B,) bool — score/absorb only valid entries
) -> Tuple[torch.Tensor, NoveltyTables]:
    """Returns ((B,) float32 novelty in {1, 2, 3}, the updated tables).

    On a CUDA tensor this is two launches of ``kernels/novelty.cu`` on the
    current stream (direct gathers and scatters, no GEMM): the scores, which
    also leave each valid state's atoms in a record, then the update from
    the records, so every state is scored against the tables as of the
    call's start.  On a CPU tensor it runs
    :func:`novelty_score_and_update_reference`.  The two are bit-equal."""
    if states.device.type == "cpu":
        return novelty_score_and_update_reference(t, states, moved, valid)
    states, moved, valid = _checked(t, states, moved, valid)
    B, dev = states.shape[0], states.device
    novelty = torch.empty((B,), dtype=torch.float32, device=dev)
    record = torch.empty((B, t.n, 2), dtype=torch.int32, device=dev)  # (cell, bucket | moved bit) an atom
    if B == 0:
        return novelty, t
    for launch in _launches(t, states, moved, valid, novelty, record).values():
        launch()
    return novelty, t


def _checked(t: NoveltyTables, states: torch.Tensor, moved: torch.Tensor, valid: torch.Tensor):
    """The kernels' inputs, contiguous; raises ValueError on what they do not take."""
    B, N = states.shape[0], t.n
    if states.shape != (B, N, 2) or states.dtype != torch.int32:
        raise ValueError(f"states: expected (B, {N}, 2) int32, got {tuple(states.shape)} {states.dtype}")
    if moved.shape != (B, N) or valid.shape != (B,) or moved.dtype != torch.bool or valid.dtype != torch.bool:
        raise ValueError("moved must be (B, N) bool and valid (B,) bool")
    if N > NOVELTY_MAX_OBJECTS:
        raise ValueError(f"the novelty kernels take at most {NOVELTY_MAX_OBJECTS} objects a state, got {N}")
    for name, x, dtype, shape in (("seen_pos", t.seen_pos, torch.bool, (N, t.height * t.width)),
                                  ("pair_table", t.pair_table, torch.bfloat16, (t.side, t.side))):
        if x.dtype != dtype or x.shape != shape or x.device != states.device or not x.is_contiguous():
            raise ValueError(f"NoveltyTables.{name}: expected a contiguous {dtype} {shape} tensor on {states.device}")
    if moved.device != states.device or valid.device != states.device:
        raise ValueError("states, moved and valid must be on one device")
    states = states.contiguous()
    if states.data_ptr() % 8:  # the kernel loads a position as one 8-byte word
        states = states.clone()
    return states, moved.contiguous(), valid.contiguous()


def _launches(t: NoveltyTables, states: torch.Tensor, moved: torch.Tensor, valid: torch.Tensor,
              novelty: torch.Tensor, record: torch.Tensor) -> Dict[str, Callable[[], None]]:
    """The two launches of :func:`novelty_score_and_update` on inputs from
    :func:`_checked`, by launch-count name, in the order the call makes them:
    the scores (into ``novelty``, leaving each valid state's atoms in
    ``record``), then the update of the tables from ``record``."""
    lib, dev = _build.load("novelty"), states.device
    dims = (states.shape[0], t.n, t.height, t.width, t.side)
    tables = (t.seen_pos.data_ptr(), t.pair_table.data_ptr())
    return {
        "novelty.score": lambda: _launch(
            lib.pw_novelty_score_records, "novelty.score", dev, states.data_ptr(), moved.data_ptr(),
            valid.data_ptr(), *tables, novelty.data_ptr(), record.data_ptr(), *dims),
        "novelty.absorb": lambda: _launch(
            lib.pw_novelty_absorb_records, "novelty.absorb", dev, valid.data_ptr(), record.data_ptr(), *tables,
            *dims),
    }


def _launch(fn, count_name: str, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` of ``kernels/novelty.cu`` on the current stream;
    raises if the launch is refused.  No host read: a CUDA graph may capture
    it."""
    rc = launch_on(device, fn, *args)
    if rc != 0:
        raise RuntimeError(f"{count_name} launch failed: CUDA error {rc}")
    count_launch(count_name)


def novelty_score_and_update_reference(
    t: NoveltyTables, states: torch.Tensor, moved: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, NoveltyTables]:
    """Plain PyTorch version of :func:`novelty_score_and_update`: the JAX
    package's factored-table form, one GEMM to score and one to update."""
    B, N, S = states.shape[0], t.n, t.side
    dev = states.device
    flat = (states[..., 1].long() * t.width + states[..., 0].long()).clamp(
        0, t.height * t.width - 1
    )  # (B, N)
    n_idx = torch.arange(N, device=dev)

    # --- novelty 1: moved object at an unseen position (exact dense table).
    pos_seen = t.seen_pos[n_idx[None, :], flat]  # (B, N)
    nov1 = (moved & ~pos_seen).any(1)

    # --- atom indicator rows over the factored bucket space.
    h = _atom_hash(n_idx[None, :], flat, S)  # (B, N)
    X = torch.zeros((B, S), dtype=torch.float32, device=dev).scatter_add_(
        1, h, moved.to(torch.float32)
    ) > 0  # moved-side atoms
    Y = torch.zeros((B, S), dtype=torch.bool, device=dev).scatter_(
        1, h, torch.ones_like(moved)
    )  # all atoms

    # --- novelty 2: an unseen (moved, other) pair — one GEMM.
    Yf = Y.to(torch.float32)
    ny = Yf.sum(1)  # (B,)
    Z = torch.matmul(Y.to(torch.bfloat16), t.pair_table).to(torch.float32)  # (B, S)
    diag = torch.diagonal(t.pair_table).to(torch.float32)  # (S,)
    # Exclude the own column (l = k): a moved atom always co-occurs with
    # itself in Y, and that self-pair is not a reference pair.
    self_unseen = Yf * (1.0 - diag)[None, :]
    unseen_cols = ny[:, None] - Z - self_unseen  # (B, S)
    nov2 = (X & (unseen_cols > 0.5)).any(1)

    novelty = torch.where(
        nov1,
        torch.ones_like(ny),
        torch.where(nov2, torch.full_like(ny, 2.0), torch.full_like(ny, 3.0)),
    )

    # --- absorb: positions of moved objects + symmetric pair outer products.
    # One max-scatter over every lane (masked-off lanes scatter 0), so the
    # update reads nothing back to the host and repeated cells cannot race.
    upd = moved & valid[:, None]
    t.seen_pos.view(-1).view(torch.uint8).scatter_reduce_(
        0, (n_idx[None, :] * (t.height * t.width) + flat).reshape(-1),
        upd.reshape(-1).to(torch.uint8), reduce="amax")
    Xv = (X & valid[:, None]).to(torch.bfloat16)
    Yv = (Y & valid[:, None]).to(torch.bfloat16)
    U = torch.matmul(Xv.T, Yv)  # (S, S): positive exactly where a pair was seen
    torch.maximum(t.pair_table, ((U + U.T) > 0.5).to(torch.bfloat16), out=t.pair_table)

    return torch.where(valid, novelty, torch.full_like(novelty, 3.0)), t
