"""The wavefront distance-field kernel: the port of ``ops/graphs_pallas.py``.

:func:`distance_fields` launches ``kernels/wavefront.cu`` (one CTA per field,
the field and its masks resident in shared memory; see the source's header)
on CUDA tensors, and runs the plain version
:func:`pushworld_tpu_torch.ops.graphs.distance_fields_reference` on CPU
tensors.  Semantics are those of the JAX package's
``distance_fields_pallas`` / ``ops.graphs.distance_to_targets``.
"""

import ctypes

import torch

from pushworld_tpu_torch.kernels import LAUNCHES
from pushworld_tpu_torch.ops.graphs import INF, distance_fields_reference

# Per-CTA shared memory the kernel may use (sm_90): 9 bytes per cell.
_MAX_SMEM = 232448


def pack_masks(E: torch.Tensor) -> torch.Tensor:
    """(B, 4, H, W) bool -> (B, H, W) uint8 with bit a set iff E[:, a]."""
    E = E.to(torch.uint8)
    return (E[:, 0] | (E[:, 1] << 1) | (E[:, 2] << 2) | (E[:, 3] << 3)).contiguous()


def distance_fields(E: torch.Tensor, d0: torch.Tensor, max_iters: int = 0) -> torch.Tensor:
    """Batched wavefront distance fields.

    Args:
        E: (B, 4, H, W) bool — feasible transitions per field, or
            (1, 4, H, W) — one stack shared by all B fields (read once).
        d0: (B, H, W) float32 — seed field (0 at targets, INF elsewhere).
        max_iters: relaxation cap; 0 -> H*W + 8 (the diameter bound).

    Returns:
        (B, H, W) float32 distance fields; unreachable = INF.
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
    if H * W * 9 > _MAX_SMEM:
        raise ValueError(f"grid {H}x{W} exceeds the kernel's shared-memory plane")
    out = torch.empty((B, H, W), dtype=torch.float32, device=d0.device)
    if B == 0:
        return out
    masks = pack_masks(E)
    d0 = d0.contiguous()
    e_stride = 0 if masks.shape[0] == 1 else H * W
    cap = int(max_iters) if max_iters else H * W + 8

    from pushworld_tpu_torch.kernels import _build

    lib = _build.load("wavefront")
    with torch.cuda.device(d0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pw_wavefront(masks.data_ptr(), e_stride, d0.data_ptr(), out.data_ptr(),
                              B, H, W, cap, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"wavefront launch failed: CUDA error {rc}")
    LAUNCHES["wavefront"] += 1
    return out


def distance_to_targets(E_o: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """One field: E_o (4, H, W) bool, targets (H, W) bool -> (H, W) float32."""
    d0 = torch.where(targets, 0.0, INF).to(torch.float32)
    return distance_fields(E_o[None], d0[None])[0]
