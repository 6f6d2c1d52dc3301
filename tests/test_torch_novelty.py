"""Port novelty vs the JAX package's ``ops/novelty.py`` (exact equality,
hash collisions included: both sides run the same factored-table algorithm)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushworld_tpu.ops import novelty as jn
from pushworld_tpu_torch.ops import novelty as tn


def test_atom_hash_bit_identical():
    rng = np.random.default_rng(0)
    i = rng.integers(0, 20, size=5000).astype(np.int32)
    p = rng.integers(0, 3000, size=5000).astype(np.int32)
    for side in (64, 4096):
        want = np.asarray(jn._atom_hash(jnp.asarray(i), jnp.asarray(p), side))
        got = tn._atom_hash(torch.as_tensor(i), torch.as_tensor(p), side)
        assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("pair_bits,B", [(12, 64), (8, 32)])
def test_score_and_update_sequence_matches_jax(pair_bits, B):
    """Batches of states scored in sequence: scores, the position table and
    the pair table must equal the JAX function's after every batch.  At
    pair_bits=8 (16 buckets) collisions are certain."""
    rng = np.random.default_rng(pair_bits)
    n, H, W = 5, 9, 11
    jt = jn.init_novelty(n, H, W, pair_bits=pair_bits)
    tt = tn.init_novelty(n, H, W, pair_bits=pair_bits, device="cpu")
    scores = []
    for r in range(8):
        states = np.stack([rng.integers(0, W, size=(B, n)), rng.integers(0, H, size=(B, n))], -1)
        states = states.astype(np.int32)
        moved = rng.random((B, n)) < 0.4
        valid = rng.random(B) < 0.85
        js, jt = jn.novelty_score_and_update(jt, jnp.asarray(states), jnp.asarray(moved), jnp.asarray(valid))
        ts, tt = tn.novelty_score_and_update(
            tt, torch.as_tensor(states), torch.as_tensor(moved), torch.as_tensor(valid)
        )
        assert ts.dtype == torch.float32
        assert np.array_equal(ts.numpy(), np.asarray(js)), r
        assert np.array_equal(tt.seen_pos.numpy(), np.asarray(jt.seen_pos)), r
        assert np.array_equal(
            tt.pair_table.to(torch.float32).numpy(), np.asarray(jt.pair_table).astype(np.float32)
        ), r
        scores.append(ts.numpy())
    assert {1.0, 2.0, 3.0} <= set(np.concatenate(scores).tolist())


def test_default_pair_bits_and_side():
    t = tn.init_novelty(3, 4, 5, device="cpu")
    assert t.pair_bits == tn._DEFAULT_PAIR_BITS == jn._DEFAULT_PAIR_BITS
    assert t.side == 1 << (t.pair_bits // 2)
    assert t.pair_table.dtype == torch.bfloat16 and t.seen_pos.shape == (3, 20)


def _novelty_loop_form(seen_pos, table, states, moved, valid, W, H):
    """kernels/novelty.cu's algorithm, one state at a time over SETS of
    buckets: the scores against the tables as of the batch's start, then
    every valid state's writes.  Updates ``seen_pos`` and ``table`` (numpy)
    in place; returns the scores."""
    side = table.shape[0]
    n = states.shape[1]
    i32 = np.arange(n, dtype=np.uint32)
    out, atoms = [], []
    for s, mv, ok in zip(states, moved, valid):
        cell = np.clip(s[:, 1] * W + s[:, 0], 0, H * W - 1)
        bucket = np.asarray(jn._atom_hash(jnp.asarray(i32.astype(np.int32)), jnp.asarray(cell.astype(np.int32)), side))
        X = {int(bucket[i]) for i in range(n) if mv[i]}  # moved atoms' buckets
        Y = {int(b) for b in bucket}  # every atom's bucket
        atoms.append((cell, X, Y))
        if not ok:
            out.append(3.0)
        elif any(mv[i] and not seen_pos[i, cell[i]] for i in range(n)):
            out.append(1.0)
        elif any(k != l and table[k, l] == 0 for l in X for k in Y):
            out.append(2.0)
        else:
            out.append(3.0)
    for (cell, X, Y), mv, ok in zip(atoms, moved, valid):
        if ok:
            seen_pos[np.arange(n)[mv], cell[mv]] = True
            for k in X:
                for l in Y:
                    table[k, l] = table[l, k] = 1.0
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("pair_bits", [4, 12])
def test_kernel_loop_form_matches_jax(pair_bits):
    """The kernels' per-state algorithm over sets of buckets equals the JAX
    function's GEMM form over sequences of batches with invalid lanes:
    scores and both tables after every batch.  At pair_bits 4 (4 buckets)
    atoms collide in most states.  A small grid repeats positions, and
    short sequences from empty tables keep the pair table from filling, so
    every score occurs."""
    rng = np.random.default_rng(100 + pair_bits)
    n, H, W, B = 3, 3, 4, 4
    scores = []
    for seq in range(8):
        jt = jn.init_novelty(n, H, W, pair_bits=pair_bits)
        seen = np.zeros((n, H * W), bool)
        table = np.zeros((1 << (pair_bits // 2),) * 2, np.float32)
        for r in range(4):
            states = np.stack([rng.integers(0, W, (B, n)), rng.integers(0, H, (B, n))], -1).astype(np.int32)
            moved = rng.random((B, n)) < 0.4
            valid = rng.random(B) < 0.85
            js, jt = jn.novelty_score_and_update(jt, jnp.asarray(states), jnp.asarray(moved), jnp.asarray(valid))
            got = _novelty_loop_form(seen, table, states, moved, valid, W, H)
            assert np.array_equal(got, np.asarray(js)), (seq, r)
            assert np.array_equal(seen, np.asarray(jt.seen_pos)), (seq, r)
            assert np.array_equal(table, np.asarray(jt.pair_table).astype(np.float32)), (seq, r)
            scores.append(got)
    assert {1.0, 2.0, 3.0} <= set(np.concatenate(scores).tolist())


def test_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's scores and
    tables and launches no kernel."""
    from pushworld_tpu_torch.kernels import LAUNCHES

    rng = np.random.default_rng(5)
    n, H, W, B = 4, 5, 6, 64
    a = tn.init_novelty(n, H, W, pair_bits=8, device="cpu")
    b = tn.init_novelty(n, H, W, pair_bits=8, device="cpu")
    before = dict(LAUNCHES)
    for _ in range(3):
        states = torch.as_tensor(np.stack([rng.integers(0, W, (B, n)), rng.integers(0, H, (B, n))], -1).astype(np.int32))
        moved = torch.as_tensor(rng.random((B, n)) < 0.5)
        valid = torch.as_tensor(rng.random(B) < 0.9)
        got, _ = tn.novelty_score_and_update(a, states, moved, valid)
        want, _ = tn.novelty_score_and_update_reference(b, states, moved, valid)
        assert torch.equal(got, want)
        assert torch.equal(a.seen_pos, b.seen_pos) and torch.equal(a.pair_table, b.pair_table)
    assert dict(LAUNCHES) == before
