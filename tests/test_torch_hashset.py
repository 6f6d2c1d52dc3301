"""Port visited set vs the JAX package's ``ops/hashset.py`` (exact equality).

The JAX table keeps (key_lo, key_hi) uint32 lanes; the port packs them into
one int64 word per slot, so tables are compared after packing.  The CPU
wrappers run the plain probe rounds; the CUDA kernels are held against those
on the card (test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushworld_tpu.ops import hashset as jh
from pushworld_tpu_torch.ops import hashset as th


def _pack_np(lo, hi) -> torch.Tensor:
    return th.pack_key(
        torch.as_tensor(np.asarray(lo).astype(np.int64)),
        torch.as_tensor(np.asarray(hi).astype(np.int64)),
    )


def _jax_table(hs) -> torch.Tensor:
    return _pack_np(hs.key_lo, hs.key_hi)


def test_fingerprint_bit_identical():
    rng = np.random.default_rng(0)
    for n, width in ((1, 5), (5, 32), (20, 56)):
        states = rng.integers(-3, 60, size=(4000, n, 2)).astype(np.int32)
        lo, hi = jh.fingerprint(jnp.asarray(states), width)
        got = th.fingerprint(torch.as_tensor(states), width)
        assert torch.equal(got, _pack_np(lo, hi))
        glo, ghi = th.split_key(got)
        assert np.array_equal(glo.numpy(), np.asarray(lo).astype(np.int64))
        assert np.array_equal(ghi.numpy(), np.asarray(hi).astype(np.int64))


def test_mul32_and_key_packing():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, size=5000, dtype=np.uint64)
    for c in (0x9E3779B1, 0x01000193, 0xFFFFFFFF, 1):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        assert np.array_equal(th.mul32(torch.as_tensor(x.astype(np.int64)), c).numpy(), want.astype(np.int64))
    lo = torch.as_tensor(rng.integers(0, 1 << 32, size=100))
    hi = torch.as_tensor(rng.integers(0, 1 << 32, size=100))
    rlo, rhi = th.split_key(th.pack_key(lo, hi))
    assert torch.equal(rlo, lo) and torch.equal(rhi, hi)
    assert th.pack_key(torch.tensor([0xFFFFFFFF]), torch.tensor([0xFFFFFFFF])).item() == th.TOMBSTONE_KEY


def test_dedup_batch_matches_jax():
    rng = np.random.default_rng(2)
    states = rng.integers(0, 6, size=(512, 3, 2)).astype(np.int32)  # many duplicates
    valid = rng.random(512) < 0.8
    lo, hi = jh.fingerprint(jnp.asarray(states), 8)
    want = np.asarray(jh.dedup_batch(lo, hi, jnp.asarray(valid)))
    got = th.dedup_batch(th.fingerprint(torch.as_tensor(states), 8), torch.as_tensor(valid))
    assert np.array_equal(got.numpy(), want)
    assert want.sum() < valid.sum()  # the batch does hold duplicates


@pytest.mark.parametrize("bits", [6, 10, 14])
def test_insert_delete_sequence_matches_jax(bits):
    """Rounds of inserts and deletes on a crowded table (collisions, probe
    runs over tombstones, same-round slot races, probe exhaustion): is_new
    and the whole table must match the JAX probe rounds."""
    rng = np.random.default_rng(bits)
    pool = rng.integers(0, 40, size=(3000, 4, 2)).astype(np.int32)
    lo, hi = jh.fingerprint(jnp.asarray(pool), 41)
    keys = _pack_np(lo, hi)
    jhs = jh.init_hashset(bits)
    ths = th.init_hashset(bits, device="cpu")
    for r in range(12):
        idx = rng.choice(len(pool), size=256, replace=False)
        valid = rng.random(256) < 0.9
        is_new_j, jhs = jh.probe_and_insert(jhs, lo[idx], hi[idx], jnp.asarray(valid))
        is_new_t, ths = th.probe_and_insert(ths, keys[idx], torch.as_tensor(valid))
        assert np.array_equal(is_new_t.numpy(), np.asarray(is_new_j)), r
        assert torch.equal(ths.keys, _jax_table(jhs)), r
        didx = rng.choice(len(pool), size=128, replace=False)
        dvalid = rng.random(128) < 0.7
        jhs = jh.probe_delete(jhs, lo[didx], hi[didx], jnp.asarray(dvalid))
        ths = th.probe_delete(ths, keys[didx], torch.as_tensor(dvalid))
        assert torch.equal(ths.keys, _jax_table(jhs)), r
    assert (ths.keys == th.TOMBSTONE_KEY).any()


def test_probe_delete_unvisits():
    rng = np.random.default_rng(3)
    keys = th.fingerprint(torch.as_tensor(rng.integers(0, 30, size=(32, 4, 2)).astype(np.int32)), 32)
    valid = torch.ones(32, dtype=torch.bool)
    hs = th.init_hashset(8, device="cpu")
    is_new, hs = th.probe_and_insert(hs, keys, valid)
    assert is_new.all()
    hs = th.probe_delete(hs, keys, torch.arange(32) < 16)
    is_new2, hs = th.probe_and_insert(hs, keys, valid)
    assert is_new2[:16].all() and not is_new2[16:].any()
    is_new3, hs = th.probe_and_insert(hs, keys, valid)
    assert not is_new3.any()
