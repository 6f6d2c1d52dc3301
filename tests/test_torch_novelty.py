"""Port novelty vs the JAX package's ``ops/novelty.py`` (exact equality,
hash collisions included: both sides run the same factored-table algorithm)."""

import dataclasses

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
    """kernels/novelty.cu's algorithm, one state at a time, lane j of a
    state's group holding atom j (its cell, its bucket, moved or not): every
    state's score against the tables as of the batch's start (lane j reads
    seen_pos for its moved atom and T[bucket_j, bucket_i] for each moved atom
    i of another bucket), then, past the barrier, every valid state's writes
    (seen_pos of each moved atom, T[bucket_i, bucket_j] = T[bucket_j,
    bucket_i] = 1 for each moved i and each j).  Updates ``seen_pos`` and
    ``table`` (numpy) in place; returns the scores."""
    side = table.shape[0]
    n = states.shape[1]
    i32 = np.arange(n, dtype=np.int32)
    out, atoms = [], []
    for s, mv, ok in zip(states, moved, valid):
        cell = np.clip(s[:, 1] * W + s[:, 0], 0, H * W - 1)
        bucket = np.asarray(jn._atom_hash(jnp.asarray(i32), jnp.asarray(cell.astype(np.int32)), side))
        atoms.append((cell, bucket))
        unseen = [bool(ok and mv[j] and not seen_pos[j, cell[j]]) for j in range(n)]  # lane j
        pair_unseen = [any(ok and mv[i] and bucket[j] != bucket[i] and table[bucket[j], bucket[i]] == 0
                           for i in range(n)) for j in range(n)]  # lane j, over the moved atoms i
        out.append(3.0 if not ok else 1.0 if any(unseen) else 2.0 if any(pair_unseen) else 3.0)
    for (cell, bucket), mv, ok in zip(atoms, moved, valid):  # the barrier: every score is taken
        if not ok:
            continue
        for j in range(n):
            if mv[j]:
                seen_pos[j, cell[j]] = True
            for i in range(n):
                if mv[i]:
                    table[bucket[i], bucket[j]] = table[bucket[j], bucket[i]] = 1.0
    return np.asarray(out, np.float32)


MOVED_BIT = 1 << 31  # kernels/novelty.cu kMovedBit


def _novelty_wide_loop_form(seen_pos, table, states, moved, valid, W, H):
    """The wide path of kernels/novelty.cu (n > 32), one state at a time: a
    warp of 32 lanes, lane j holding atoms j, j + 32, ... in rounds; the
    score writes the state's record (cell; bucket and moved bit) for every
    atom, stops at novelty 1, else each lane reads its atoms' buckets back
    from the record and, in rounds of 32 atoms i (read from the record a lane
    an atom and shuffled) and blocks of 8, T[bucket_j, bucket_i] for each
    moved i of another bucket.  The update, past the barrier, walks the same
    pairs from the records.  Updates ``seen_pos`` and ``table`` in place;
    returns the scores."""
    side = table.shape[0]
    n = states.shape[1]
    out, records = [], []
    for s, mv, ok in zip(states, moved, valid):
        if not ok:
            out.append(3.0)
            records.append(None)
            continue
        record = [None] * n
        unseen = [False] * 32
        for lane in range(32):
            for j in range(lane, n, 32):
                cell = int(np.clip(s[j, 1] * W + s[j, 0], 0, H * W - 1))
                bucket = int(np.asarray(jn._atom_hash(jnp.asarray(np.int32(j)), jnp.asarray(np.int32(cell)), side)))
                unseen[lane] |= bool(mv[j]) and not seen_pos[j, cell]
                record[j] = (cell, bucket | (MOVED_BIT if mv[j] else 0))
        records.append(record)
        if any(unseen):
            out.append(1.0)
            continue
        pair_unseen = [False] * 32
        for j0 in range(0, n, 32):
            for lane in range(32):
                j = j0 + lane
                bj = record[j][1] & ~MOVED_BIT if j < n else 0
                for i0 in range(0, n, 32):
                    ri = [record[i0 + u][1] if i0 + u < n else 0 for u in range(32)]  # a lane each, shuffled
                    for u0 in range(0, min(32, n - i0), 8):
                        for u in range(u0, u0 + 8):
                            r = ri[u]
                            need = i0 + u < n and j < n and bool(r & MOVED_BIT) and bj != r & ~MOVED_BIT
                            pair_unseen[lane] |= need and table[bj, r & ~MOVED_BIT] == 0
        out.append(2.0 if any(pair_unseen) else 3.0)
    for record in records:  # the barrier: every score is taken
        if record is None:
            continue
        for j0 in range(0, n, 32):
            for j in range(j0, min(j0 + 32, n)):
                cell, rj = record[j]
                if rj & MOVED_BIT:
                    seen_pos[j, cell] = True
                for i in range(n):
                    if record[i][1] & MOVED_BIT:
                        k = record[i][1] & ~MOVED_BIT
                        table[k, rj & ~MOVED_BIT] = table[rj & ~MOVED_BIT, k] = 1.0
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


@pytest.mark.parametrize("n", [5, 32, 33, 64, 100])
def test_kernel_loop_form_at_many_objects_matches_jax(n):
    """The kernel's per-state algorithm, the one-word path's (lane groups of
    up to 32 atoms) and above 32 atoms the wide path's (a lane several
    atoms, the record read back), equal to the JAX function over a sequence
    of batches: scores and both tables after every batch."""
    loop_form = _novelty_loop_form if n <= 32 else _novelty_wide_loop_form
    rng = np.random.default_rng(n)
    # Above 32 atoms, few cells and many buckets, so that positions are seen
    # before pairs are and every score occurs.
    H, W, B, pair_bits, p_moved, rounds = (4, 5, 16, 8, 0.2, 3) if n <= 32 else (2, 2, 16, 16, 0.02, 5)
    jt = jn.init_novelty(n, H, W, pair_bits=pair_bits)
    seen = np.zeros((n, H * W), bool)
    table = np.zeros((1 << (pair_bits // 2),) * 2, np.float32)
    scores = []
    for r in range(rounds):
        states = np.stack([rng.integers(0, W, (B, n)), rng.integers(0, H, (B, n))], -1).astype(np.int32)
        moved = rng.random((B, n)) < p_moved
        valid = rng.random(B) < 0.85
        js, jt = jn.novelty_score_and_update(jt, jnp.asarray(states), jnp.asarray(moved), jnp.asarray(valid))
        got = loop_form(seen, table, states, moved, valid, W, H)
        assert np.array_equal(got, np.asarray(js)), r
        assert np.array_equal(seen, np.asarray(jt.seen_pos)), r
        assert np.array_equal(table, np.asarray(jt.pair_table).astype(np.float32)), r
        scores += got.tolist()
    if n > 32:
        assert {1.0, 2.0, 3.0} <= set(scores)


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


def _twin_batch(case):
    """A batch of two valid states with the same atoms, and the tables before
    it, in which the first state's update would change the second state's
    score: both moved objects on cells never seen (``"positions"``: each
    scores 1, and 3 once the other's update is seen), or on seen cells with
    an unseen pair (``"pairs"``: each scores 2, and 3 after the other)."""
    n, H, W, pair_bits = 3, 4, 5, 8
    s = np.array([[0, 0], [2, 1], [3, 3]], np.int32)
    states = np.stack([s, s])
    moved = np.array([[False, True, True]] * 2)
    valid = np.array([True, True])
    seen = np.zeros((n, H * W), bool)
    if case == "pairs":
        seen[1, 1 * W + 2] = seen[2, 3 * W + 3] = True
    return n, H, W, pair_bits, states, moved, valid, seen


@pytest.mark.parametrize("case", ["positions", "pairs"])
def test_states_of_one_batch_are_scored_against_the_tables_at_its_start(case):
    """A state's update is never seen by the score of another state of the
    same batch: the JAX function, the plain version and the kernel's loop
    form score both twins alike, though scoring them one after the other
    does not."""
    n, H, W, pair_bits, states, moved, valid, seen = _twin_batch(case)
    want = {"positions": [1.0, 1.0], "pairs": [2.0, 2.0]}[case]
    side = 1 << (pair_bits // 2)

    jt = dataclasses.replace(jn.init_novelty(n, H, W, pair_bits=pair_bits), seen_pos=jnp.asarray(seen))
    js, jt = jn.novelty_score_and_update(jt, jnp.asarray(states), jnp.asarray(moved), jnp.asarray(valid))
    tt = tn.init_novelty(n, H, W, pair_bits=pair_bits, device="cpu")
    tt.seen_pos.copy_(torch.as_tensor(seen))
    ts, tt = tn.novelty_score_and_update(tt, torch.as_tensor(states), torch.as_tensor(moved), torch.as_tensor(valid))
    loop_seen, loop_table = seen.copy(), np.zeros((side, side), np.float32)
    got = _novelty_loop_form(loop_seen, loop_table, states, moved, valid, W, H)
    assert np.asarray(js).tolist() == ts.tolist() == got.tolist() == want
    assert np.array_equal(loop_seen, np.asarray(jt.seen_pos)) and np.array_equal(tt.seen_pos.numpy(), loop_seen)
    assert np.array_equal(loop_table, np.asarray(jt.pair_table).astype(np.float32))
    assert np.array_equal(tt.pair_table.to(torch.float32).numpy(), loop_table)

    # One at a time, the second twin sees the first one's update.
    seq_seen, seq_table = seen.copy(), np.zeros((side, side), np.float32)
    first = _novelty_loop_form(seq_seen, seq_table, states[:1], moved[:1], valid[:1], W, H)
    second = _novelty_loop_form(seq_seen, seq_table, states[1:], moved[1:], valid[1:], W, H)
    assert first.tolist() == want[:1] and second.tolist() == [3.0]
