"""The wavefront distance-field kernel: the port of ``ops/graphs_pallas.py``.

:func:`distance_fields` launches ``kernels/wavefront.cu`` on CUDA tensors and
runs the plain version
:func:`pushworld_tpu_torch.ops.graphs.distance_fields_reference` on CPU
tensors.  The kernel gives one warp to each field.  A field seeded with 0 and
INF only (every field of the table build) is a level-synchronous,
bit-parallel breadth-first search over 64-bit row words; any other seeds
take the float Jacobi sweeps of the definition, in the same launch (see the
source's header).  Both are bit-equal to the plain version.  Semantics are
those of the JAX package's ``distance_fields_pallas`` /
``ops.graphs.distance_to_targets``.
"""

import torch

from pushworld_tpu_torch.kernels import count_launch, launch_on
from pushworld_tpu_torch.ops.graphs import INF, distance_fields_reference


def distance_fields(E: torch.Tensor, d0: torch.Tensor, max_iters: int = 0) -> torch.Tensor:
    """Batched wavefront distance fields.

    Args:
        E: (B, 4, H, W) bool — feasible transitions per field, or
            (1, 4, H, W) — one stack shared by all B fields (read once).
        d0: (B, H, W) float32 — seed field (0 at targets, INF elsewhere).
        max_iters: relaxation cap; 0 -> H*W + 8 (the diameter bound).

    Returns:
        (B, H, W) float32 distance fields; unreachable = INF.

    On a CUDA tensor the kernel takes a grid of at most 65,534 cells whose
    planes fit a CTA's shared memory: 8 bytes per cell plus four 64-bit mask
    words per row and 64 columns.  That is about 25,000 cells for rows of 64
    cells or more, and fewer for much narrower rows, which each still take a
    whole word.  A grid the kernel does not take raises ValueError.
    """
    if d0.dim() != 3 or E.dim() != 4 or E.shape[1] != 4 or E.shape[2:] != d0.shape[1:]:
        raise ValueError(f"bad shapes: E {tuple(E.shape)}, d0 {tuple(d0.shape)}")
    B, H, W = d0.shape
    if E.shape[0] not in (1, B):
        raise ValueError(f"E batch {E.shape[0]} must be 1 or {B}")
    if d0.device.type == "cpu":
        return distance_fields_reference(E, d0, max_iters)
    if E.device != d0.device:
        raise ValueError("E and d0 must be on one device")
    if d0.dtype != torch.float32:
        raise ValueError("d0 must be float32")
    out = torch.empty((B, H, W), dtype=torch.float32, device=d0.device)
    if B == 0:
        return out
    # The kernel reads the bool planes where they lie: each (H, W) plane must
    # be contiguous, the strides between planes and between fields are free
    # (a column ``E[None, :, o]`` of a per-object stack is read in place).
    E = E.to(torch.bool)
    if E.stride(3) != 1 or E.stride(2) != W:
        E = E.contiguous()
    d0 = d0.contiguous()
    e_stride = 0 if E.shape[0] == 1 else E.stride(0)
    # Scratch for the masks as bit rows: ceil(W / 64) 64-bit words per row.
    packed = torch.empty((E.shape[0], 4, H * ((W + 63) // 64)), dtype=torch.int64, device=d0.device)
    cap = int(max_iters) if max_iters else H * W + 8

    from pushworld_tpu_torch.kernels import _build

    lib = _build.load("wavefront")
    if not lib.pw_wavefront_fits(H, W):
        raise ValueError(f"grid {H}x{W} exceeds the kernel's shared-memory planes")
    rc = launch_on(d0.device, lib.pw_wavefront, E.data_ptr(), e_stride, E.stride(1), packed.data_ptr(),
                   d0.data_ptr(), out.data_ptr(), B, H, W, cap)
    if rc != 0:
        raise RuntimeError(f"wavefront launch failed: CUDA error {rc}")
    count_launch("wavefront")
    return out


def distance_to_targets(
    E_o: torch.Tensor, targets: torch.Tensor, max_iters: int = 4096
) -> torch.Tensor:
    """One field: E_o (4, H, W) bool, targets (H, W) bool -> (H, W) float32
    of graph distances to the target set, unreachable = INF.  At most
    ``min(max_iters, H * W + 8)`` relaxations, as in the JAX function."""
    H, W = targets.shape
    d0 = torch.where(targets, 0.0, INF).to(torch.float32)
    cap = min(int(max_iters), H * W + 8)
    if cap <= 0:  # distance_fields reads 0 as "no cap"
        return d0
    return distance_fields(E_o[None], d0[None], max_iters=cap)[0]
