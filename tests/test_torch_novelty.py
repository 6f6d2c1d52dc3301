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
