"""Device-resident open-addressing visited set for packed search states.

Port of the JAX package's ``ops/hashset.py``.  States are fingerprinted to
64 bits and stored in a linear-probing table on the device; batch insertion
is up to ``N_PROBES`` probes per key.  Deletion tombstones a slot so the
planner can *un-visit* states evicted from its bounded frontier; tombstones
terminate neither lookups nor insertions.

Layout: ONE packed 64-bit word per slot, ``hi << 32 | lo`` held in an int64
tensor, with 0 as the empty slot and all ones (-1) as the tombstone.  The
JAX package keeps two uint32 arrays written by two scatters; on a GPU a
scatter with duplicate indices has no defined winner per array, so the two
halves of a key could tear.  One word cannot tear: the CUDA kernels
(``kernels/visited_set.cu``) claim a slot with a 64-bit ``atomicCAS``, and
the plain versions write one word per lane with one scatter per round.

The search reaches the table through :func:`fingerprint_dedup_insert`: from
a batch of child states to their keys and ``is_new`` flags in ONE kernel
launch on a CUDA tensor (native uint32 fingerprint folds, a sort-free batch
dedup in the CTA's shared memory, then the probes).  :func:`fingerprint`,
:func:`dedup_batch` and :func:`probe_and_insert` are its three steps as
functions of their own, and their composition is its plain version.

Where each kernel runs on the card: the fused kernel once an iteration;
the insert kernel for a search's root (``search.batched.init_search_state``);
the evictions' deletes inside the frontier's compaction kernel
(``kernels/frontier.cu``), which tombstones the fingerprints it drops with
the same probe (``kernels/visited_probe.cuh``), so the search launches no
delete kernel.  The delete kernel serves :func:`probe_delete` itself, the
plain compaction's callers and the card tests.

``probe_and_insert``, ``probe_delete`` and ``fingerprint_dedup_insert``
update the table IN PLACE (the JAX functions return a new table).

Failure modes and their effect on the search (all benign for greedy search):
- fingerprint collision (~2^-64 per pair): a new state is treated as visited;
- probe exhaustion or a slot race: an insert may be lost, so a state might
  be re-expanded later (wasted work only);
- duplicate keys within one batch must be removed before ``probe_and_insert``
  (:func:`dedup_batch`); ``fingerprint_dedup_insert`` does so itself.
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.kernels import count_launch, launch_on

N_PROBES = 8
EMPTY_KEY = 0
TOMBSTONE_KEY = -1  # all ones
_M32 = 0xFFFFFFFF


@dataclass
class HashSet:
    keys: torch.Tensor  # int64 (capacity,) packed hi << 32 | lo; 0 empty, -1 tombstone
    capacity_bits: int


def init_hashset(capacity_bits: int = 20, device: DeviceLike = "cuda") -> HashSet:
    dev = resolve_device(device)
    return HashSet(
        keys=torch.zeros((1 << capacity_bits,), dtype=torch.int64, device=dev),
        capacity_bits=capacity_bits,
    )


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit constant.

    The constant is split into 16-bit halves so no product leaves int64."""
    lo16, hi16 = c & 0xFFFF, c >> 16
    return (x * lo16 + (((x * hi16) & 0xFFFF) << 16)) & _M32


def pack_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) uint32 values held in int64 -> packed int64 ``hi << 32 | lo``."""
    hi_signed = torch.where(hi >= (1 << 31), hi - (1 << 32), hi)
    return hi_signed * (1 << 32) + lo


def split_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int64 keys -> (lo, hi) uint32 values held in int64."""
    return key & _M32, (key >> 32) & _M32


def fingerprint(states: torch.Tensor, width: int) -> torch.Tensor:
    """64-bit fingerprints of packed states, bit-identical to the JAX
    package's (lo, hi) pair.

    states: (..., N, 2) int32 -> packed int64 keys of shape (...,).
    An FxHash-style fold over per-object packed positions in two 32-bit lanes
    with different multipliers, computed in int64 with ``& 0xFFFFFFFF``.  The
    all-zero key (empty) and the all-ones key (tombstone) are remapped.
    """
    flat = (states[..., 1].long() * width + states[..., 0].long()) & _M32  # (..., N)

    def fold(carry: int, mult: int, xorc: int) -> torch.Tensor:
        h = torch.full(flat.shape[:-1], carry, dtype=torch.int64, device=flat.device)
        for i in range(flat.shape[-1]):
            h = mul32(h ^ ((flat[..., i] + xorc) & _M32), mult)
            h = h ^ (h >> 13)
        return h

    lo = fold(0x811C9DC5, 0x01000193, 0x9E3779B9)
    hi = fold(0xCBF29CE4, 0x85EBCA6B, 0x27D4EB2F)
    lo = torch.where((lo == 0) & (hi == 0), torch.ones_like(lo), lo)
    lo = torch.where((lo == _M32) & (hi == _M32), torch.full_like(lo, 0xFFFFFFFE), lo)
    return pack_key(lo, hi)


def dedup_batch(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Marks the first occurrence of each key in the batch.

    Returns a bool mask, True for entries that are the batch's first (lowest
    index) occurrence of their key; invalid entries are False.  A stable
    sort of the signed packed key groups equal keys exactly as the JAX
    lexsort of (hi, lo) does, and keeps the lowest original index first."""
    k = torch.where(valid, keys, torch.full_like(keys, TOMBSTONE_KEY))
    s, order = torch.sort(k, stable=True)
    first_sorted = torch.ones_like(valid)
    first_sorted[1:] = s[1:] != s[:-1]
    first = torch.empty_like(first_sorted)
    first[order] = first_sorted
    return first & valid


def _mask(hs: HashSet) -> int:
    return (1 << hs.capacity_bits) - 1


def _first_slot(keys: torch.Tensor, capacity_bits: int) -> torch.Tensor:
    lo, hi = split_key(keys)
    return (lo ^ mul32(hi, 0x9E3779B1)) & ((1 << capacity_bits) - 1)


def probe_and_insert_reference(
    hs: HashSet, keys: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, HashSet]:
    """Plain PyTorch version of :func:`probe_and_insert`: the JAX probe
    rounds on the packed table, one scatter per round followed by a
    read-back verify (a same-slot race between different keys leaves one
    whole winner; losers keep probing)."""
    table = hs.keys
    mask = (1 << hs.capacity_bits) - 1
    slot = _first_slot(keys, hs.capacity_bits)
    found = torch.zeros_like(valid)
    remaining = valid.clone()
    for _ in range(N_PROBES):
        cur = table[slot]
        match = remaining & (cur == keys)
        found |= match
        remaining &= ~match
        attempt = remaining & ((cur == EMPTY_KEY) | (cur == TOMBSTONE_KEY))
        table[slot[attempt]] = keys[attempt]
        won = attempt & (table[slot] == keys)
        remaining &= ~won
        slot = (slot + 1) & mask
    # Keys neither found nor inserted (probe exhaustion) are still reported
    # new so the search explores them; they may be re-visited later.
    return valid & ~found, hs


def probe_delete_reference(hs: HashSet, keys: torch.Tensor, valid: torch.Tensor) -> HashSet:
    """Plain PyTorch version of :func:`probe_delete`."""
    table = hs.keys
    mask = (1 << hs.capacity_bits) - 1
    slot = _first_slot(keys, hs.capacity_bits)
    remaining = valid.clone()
    for _ in range(N_PROBES):
        match = remaining & (table[slot] == keys)
        table[slot[match]] = TOMBSTONE_KEY
        remaining &= ~match
        slot = (slot + 1) & mask
    return hs


def _check(hs: HashSet, keys: torch.Tensor, valid: torch.Tensor) -> None:
    for name, t, dtype in (("table", hs.keys, torch.int64), ("keys", keys, torch.int64),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != hs.keys.device:
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor on {hs.keys.device}")
    if keys.dim() != 1 or valid.shape != keys.shape:
        raise ValueError("keys and valid must be 1-D tensors of one length")
    if hs.keys.numel() != 1 << hs.capacity_bits or hs.capacity_bits > 31:
        raise ValueError("table size must be 2**capacity_bits with capacity_bits <= 31")


def _launch(fn_name: str, hs: HashSet, *args) -> None:
    """Calls ``fn_name(table, *args, stream)`` of the kernel library on the
    table's device (tensors pass as their data pointers); raises if the
    launch is refused."""
    from pushworld_tpu_torch.kernels import _build

    fn = getattr(_build.load("visited_set"), fn_name)
    ptrs = [None if a is None else a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = launch_on(hs.keys.device, fn, hs.keys.data_ptr(), *ptrs)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")


def probe_and_insert(
    hs: HashSet, keys: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, HashSet]:
    """Tests membership and inserts new keys, in place.

    Args:
        hs: the table.
        keys: (B,) packed int64 keys (see :func:`fingerprint`).
        valid: (B,) bool — only valid entries are tested/inserted.

    Returns:
        (is_new, hs): is_new[b] True iff the key was not found (it is then
        inserted unless its probes were exhausted).  Within-batch duplicates
        must be removed beforehand (:func:`dedup_batch`).

    On a CUDA tensor this launches ``visited_set.cu``'s insert kernel (8
    threads a key: key and flag, then the window of ``N_PROBES`` slots in
    one wave, a slot a thread, then one CAS); on a CPU tensor it runs
    :func:`probe_and_insert_reference`.  The search launches it for its root
    only.
    """
    if hs.keys.device.type == "cpu":
        return probe_and_insert_reference(hs, keys, valid)
    _check(hs, keys, valid)
    is_new = torch.empty_like(valid)
    if keys.numel():
        _launch("pw_probe_and_insert", hs, keys, valid, is_new, keys.numel(), _mask(hs))
        count_launch("visited_set.probe_and_insert")
    return is_new, hs


def probe_delete(hs: HashSet, keys: torch.Tensor, valid: torch.Tensor, gate=None) -> HashSet:
    """Removes keys from the table (tombstoning their slots), in place.

    Un-visits states evicted from the bounded search frontier so they can
    be re-generated later.  Missing keys are ignored.  ``gate`` (a bool
    scalar on the device, or None for open): where it is False nothing is
    deleted and ``valid`` is not read.  On a CUDA tensor this launches
    ``visited_set.cu``'s delete kernel (the gate read alone first); on a
    CPU tensor it runs :func:`probe_delete_reference`.  The search's
    compaction on the card deletes its drops inside its own kernel with the
    same probe; the plain compaction
    (``search.batched.compact_frontier_reference``) calls this function."""
    if hs.keys.device.type == "cpu":
        return probe_delete_reference(hs, keys, valid if gate is None else valid & gate)
    _check(hs, keys, valid)
    if gate is not None and (gate.dtype != torch.bool or gate.shape != () or gate.device != hs.keys.device):
        raise ValueError(f"gate: expected a bool scalar on {hs.keys.device}")
    if keys.numel():
        _launch("pw_probe_delete", hs, keys, valid, gate, keys.numel(), _mask(hs))
        count_launch("visited_set.probe_delete")
    return hs


def fingerprint_dedup_insert_reference(
    hs: HashSet, states: torch.Tensor, width: int, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fingerprint_dedup_insert`: the three
    steps one after the other."""
    keys = fingerprint(states, width)
    is_new, _ = probe_and_insert_reference(hs, keys, dedup_batch(keys, valid))
    return keys, is_new


def fingerprint_dedup_insert(
    hs: HashSet, states: torch.Tensor, width: int, valid: torch.Tensor, gate=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """From a batch of states to their keys and ``is_new`` flags, inserting
    the new keys in place: :func:`fingerprint`, :func:`dedup_batch` and
    :func:`probe_and_insert` in one step.

    Args:
        hs: the table.
        states: (n, N, 2) int32 packed states.
        width: the grid width the fingerprint flattens positions with.
        valid: (n,) bool — only valid entries are deduplicated and inserted.
        gate: a bool scalar on the device, or None for open.  Where it is
            False (the search iteration is a no-op; ``valid`` is then all
            False) the kernel writes ``is_new`` False and returns, and the
            keys hold anything.  The plain version ignores it.

    Returns:
        (keys, is_new): keys (n,) packed int64 fingerprints of ALL entries;
        is_new[b] True iff entry b is valid, is the batch's first (lowest
        index) occurrence of its key, and the key was not in the table.

    On a CUDA tensor this is one launch of ``visited_set.cu``'s fused kernel
    (its dedup table in shared memory for n <= 8,192, else in device scratch
    allocated here); on a CPU tensor it runs
    :func:`fingerprint_dedup_insert_reference`.
    """
    if hs.keys.device.type == "cpu":
        return fingerprint_dedup_insert_reference(hs, states, width, valid)
    if gate is not None and (gate.dtype != torch.bool or gate.shape != () or gate.device != hs.keys.device):
        raise ValueError(f"gate: expected a bool scalar on {hs.keys.device}")
    if states.dim() != 3 or states.shape[2] != 2 or states.dtype != torch.int32:
        raise ValueError(f"states: expected (n, N, 2) int32, got {tuple(states.shape)} {states.dtype}")
    n, n_obj = states.shape[:2]
    keys = torch.empty((n,), dtype=torch.int64, device=states.device)
    _check(hs, keys, valid)
    if not states.is_contiguous() or not 0 < width < 1 << 31 or n >= 1 << 29:
        raise ValueError("states must be contiguous, width positive, and n below 2**29")
    is_new = torch.empty_like(valid)
    if n:
        from pushworld_tpu_torch.kernels import _build

        slots = max(64, 1 << (2 * n - 1).bit_length())  # a power of two >= 2n
        scratch = None
        if slots > _build.load("visited_set").pw_dedup_shared_slots():
            scratch = torch.empty((slots * 12,), dtype=torch.uint8, device=states.device)
        _launch("pw_fingerprint_dedup_insert", hs, states, valid, gate, keys, is_new, scratch,
                n, n_obj, width, _mask(hs), slots)
        count_launch("visited_set.fingerprint_dedup_insert")
    return keys, is_new
