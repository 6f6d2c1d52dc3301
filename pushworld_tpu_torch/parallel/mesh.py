"""Process meshes for SPMD planning over ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py``.  A JAX ``Mesh`` arranges
devices; its PyTorch counterpart, ``torch.distributed.device_mesh.DeviceMesh``,
arranges the RANKS of a process group, one device each.  The natural
parallel axes are independent *puzzles* and, within a puzzle, *rollouts* or
frontier shards; meshes here are ``("puzzle",)`` (or any one axis name) and
``("puzzle", "rollout")``.

Collectives of CUDA tensors run over NCCL and those of CPU tensors over gloo.
When no process group exists, :func:`make_mesh` creates a one-rank group on
this process's device, so a single process needs no launcher.  NCCL takes
one rank per card: two ranks on one card are refused.
"""

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pushworld_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["make_mesh", "make_mesh_2d", "make_local_mesh", "mesh_device", "shard_leading"]


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _ensure_default_group(dev: torch.device) -> None:
    """Creates a one-rank default group on ``dev``'s backend when none exists."""
    if not dist.is_initialized():
        dist.init_process_group(
            _backend(dev), store=dist.HashStore(), rank=0, world_size=1,
            device_id=dev if dev.type == "cuda" else None,
        )


def _group(dev: torch.device, ranks: Optional[Sequence[int]] = None):
    """The process group that ``dev``'s tensors use over ``ranks`` (default:
    every rank): the default group where it covers them with the device's
    backend, else a new group (a collective call: every rank of the default
    group makes it)."""
    _ensure_default_group(dev)
    world = list(range(dist.get_world_size()))
    ranks = world if ranks is None else sorted(int(r) for r in ranks)
    if ranks == world and _backend(dev) in dist.get_backend():
        return dist.group.WORLD
    return dist.new_group(ranks, backend=_backend(dev))


def make_mesh(
    devices: Optional[Sequence[int]] = None, axis_name: str = "puzzle", device: DeviceLike = "cuda"
) -> DeviceMesh:
    """A 1-D mesh over all ranks of the default process group (or the given
    ranks), for tensors on ``device`` ("cuda", the default, raises without a
    card).  Every rank of the default group calls it."""
    dev = resolve_device(device)
    return DeviceMesh.from_group(_group(dev, devices), dev.type, mesh_dim_names=(axis_name,))


def make_mesh_2d(puzzle_axis: int, rollout_axis: int, device: DeviceLike = "cuda") -> DeviceMesh:
    """A ``("puzzle", "rollout")`` mesh of the given shape over the first
    ``puzzle_axis * rollout_axis`` ranks, row-major as the JAX package
    reshapes its device list.  Every rank of the default group calls it, and
    each must be in the mesh."""
    dev = resolve_device(device)
    _ensure_default_group(dev)
    n = puzzle_axis * rollout_axis
    if not dist.get_rank() < n <= dist.get_world_size():
        raise ValueError(f"a {puzzle_axis} x {rollout_axis} mesh needs the first {n} of "
                         f"{dist.get_world_size()} ranks, rank {dist.get_rank()} among them")
    mesh = torch.arange(n, dtype=torch.int).reshape(puzzle_axis, rollout_axis)
    # This rank's group along each axis: the mesh's columns, then its rows.
    along_puzzle, _ = dist.new_subgroups_by_enumeration(mesh.T.tolist(), backend=_backend(dev))
    along_rollout, _ = dist.new_subgroups_by_enumeration(mesh.tolist(), backend=_backend(dev))
    return DeviceMesh.from_group([along_puzzle, along_rollout], dev.type, mesh=mesh,
                                 mesh_dim_names=("puzzle", "rollout"))


def make_local_mesh(device: DeviceLike = "cuda") -> DeviceMesh:
    """A one-rank ("shard",) mesh of this process alone, on ``device``,
    whatever the default group holds: only this process takes part in its
    collectives."""
    dev = resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(device=dev, axis_name="shard")
    group = dist.new_group([dist.get_rank()], backend=_backend(dev), use_local_synchronization=True)
    return DeviceMesh.from_group(group, dev.type, mesh_dim_names=("shard",))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its current card for a CUDA
    mesh, the CPU for a CPU mesh."""
    return resolve_device(mesh.device_type)


def shard_leading(mesh: DeviceMesh, tensors, axis_name: str = "puzzle"):
    """This rank's contiguous block of the leading axis of every tensor in
    ``tensors`` (a tensor, or a list, tuple or dict of them, nested), on the
    mesh's device: the block that ``NamedSharding(mesh, P(axis_name))``
    places on this rank's device.  Other mesh axes hold replicas."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes: {names})")
    k = mesh.size(names.index(axis_name))
    i = mesh.get_local_rank(axis_name)
    dev = mesh_device(mesh)

    def block(x):
        if isinstance(x, dict):
            return {key: block(v) for key, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(block(v) for v in x)
        x = torch.as_tensor(x)
        if x.dim() == 0 or x.shape[0] % k:
            raise ValueError(f"leading axis of shape {tuple(x.shape)} does not split {k} ways")
        n = x.shape[0] // k
        return x[i * n : (i + 1) * n].to(dev)

    return block(tensors)
