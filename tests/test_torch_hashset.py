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


@pytest.mark.parametrize("n_obj", [1, 4, 20])
def test_fingerprint_dedup_insert_matches_jax_composition(n_obj):
    """The fused entry point on CPU tensors against the JAX fingerprint ->
    dedup_batch -> probe_and_insert on the same states: batches with duplicate
    states and invalid lanes, on a table that already holds some of the keys
    (and tombstones).  keys, is_new and the whole table must be equal."""
    rng = np.random.default_rng(40 + n_obj)
    width, bits = 23, 9
    pool = rng.integers(0, 22, size=(300, n_obj, 2)).astype(np.int32)
    jhs = jh.init_hashset(bits)
    ths = th.init_hashset(bits, device="cpu")
    # Pre-fill both tables through the three-step functions, then delete some.
    lo, hi = jh.fingerprint(jnp.asarray(pool[:120]), width)
    first = jh.dedup_batch(lo, hi, jnp.ones(120, bool))
    _, jhs = jh.probe_and_insert(jhs, lo, hi, first)
    jhs = jh.probe_delete(jhs, lo[:30], hi[:30], first[:30])
    keys = th.fingerprint(torch.as_tensor(pool[:120]), width)
    tfirst = th.dedup_batch(keys, torch.ones(120, dtype=torch.bool))
    th.probe_and_insert(ths, keys, tfirst)
    th.probe_delete(ths, keys[:30], tfirst[:30])
    assert torch.equal(ths.keys, _jax_table(jhs))

    saw_dup = saw_old = False
    for r in range(5):
        states = pool[rng.integers(0, len(pool), 160)]  # duplicates within the batch
        valid = rng.random(160) < 0.85
        lo, hi = jh.fingerprint(jnp.asarray(states), width)
        uniq = jh.dedup_batch(lo, hi, jnp.asarray(valid))
        is_new_j, jhs = jh.probe_and_insert(jhs, lo, hi, uniq)
        got_keys, got_new = th.fingerprint_dedup_insert(
            ths, torch.as_tensor(states), width, torch.as_tensor(valid))
        assert torch.equal(got_keys, _pack_np(lo, hi)), r
        assert np.array_equal(got_new.numpy(), np.asarray(is_new_j)), r
        assert torch.equal(ths.keys, _jax_table(jhs)), r
        saw_dup |= int(np.asarray(uniq).sum()) < int(valid.sum())
        saw_old |= bool((np.asarray(uniq) & ~np.asarray(is_new_j)).any())
    if n_obj > 1:  # 22 one-object states cannot fill a batch with fresh keys
        assert saw_dup and saw_old


def test_fingerprint_dedup_insert_reference_is_the_three_steps():
    rng = np.random.default_rng(9)
    states = torch.as_tensor(rng.integers(0, 5, size=(200, 3, 2)).astype(np.int32))
    valid = torch.as_tensor(rng.random(200) < 0.8)
    a, b = th.init_hashset(10, device="cpu"), th.init_hashset(10, device="cpu")
    keys, is_new = th.fingerprint_dedup_insert_reference(a, states, 7, valid)
    want_keys = th.fingerprint(states, 7)
    want_new, _ = th.probe_and_insert(b, want_keys, th.dedup_batch(want_keys, valid))
    assert torch.equal(keys, want_keys) and torch.equal(is_new, want_new)
    assert torch.equal(a.keys, b.keys)
    assert not is_new[~valid].any() and 0 < int(is_new.sum()) < int(valid.sum())


# ------------------------------------------- the kernels' window probe, lane by lane

M32 = 0xFFFFFFFF


def first_slot_np(key: int, bits: int) -> int:
    lo, hi = key & M32, (key >> 32) & M32
    return (lo ^ ((hi * 0x9E3779B1) & M32)) & ((1 << bits) - 1)


def _windows(table, keys, valid, bits):
    """Each valid key's home slot and the N_PROBES words of its sequence,
    all loaded before any key is compared or written (the kernels' one wave:
    a group of 8 threads a key in the insert and delete kernels, one thread
    a key in the compaction)."""
    mask = (1 << bits) - 1
    out = []
    for key, v in zip(keys.tolist(), np.asarray(valid).tolist()):
        home = first_slot_np(key, bits)
        out.append((key, home, [int(table[(home + r) & mask]) for r in range(th.N_PROBES)]) if v else None)
    return out


def window_insert_np(table, keys, valid, bits):
    """``kernels/visited_probe.cuh``'s insert (``group_find_or_claim``) on the
    int64 ``table`` in place: every key's window of N_PROBES words is loaded,
    then the keys, one after another, scan theirs in probe order (the key:
    found; the first free word: a CAS, whose returned word decides, a lost
    one moving on).  Returns is_new."""
    mask = (1 << bits) - 1
    is_new = np.zeros(len(keys), bool)
    for i, lane in enumerate(_windows(table, keys, valid, bits)):
        if lane is None:
            continue
        key, home, window = lane
        found = False
        for r, cur in enumerate(window):
            if cur == key:
                found = True
                break
            if cur in (th.EMPTY_KEY, th.TOMBSTONE_KEY):
                slot = (home + r) & mask
                old = int(table[slot])  # atomicCAS(slot, cur, key)
                if old == cur:
                    table[slot] = key
                    break
                if old == key:
                    found = True
                    break
        is_new[i] = not found
    return is_new


def window_delete_np(table, keys, valid, bits):
    """``kernels/visited_probe.cuh``'s delete (``group_delete``, and
    ``delete_key`` in the compaction) in place: every key's window is
    loaded, then the keys, one after another, CAS the first slot of theirs
    that held the key to the tombstone (empty slots do not end the scan).
    Two lanes of one key meet on its first copy, as in JAX."""
    mask = (1 << bits) - 1
    for lane in _windows(table, keys, valid, bits):
        if lane is None:
            continue
        key, home, window = lane
        for r, cur in enumerate(window):
            if cur == key:
                slot = (home + r) & mask
                if int(table[slot]) == key:  # atomicCAS(slot, key, tombstone)
                    table[slot] = th.TOMBSTONE_KEY
                break


def key_at_home(rng, home: int, bits: int) -> int:
    """A random packed key (int64) whose first probe slot is ``home``."""
    hi = int(rng.integers(1, M32))
    lo = (int(rng.integers(0, 1 << (32 - bits))) << bits) | ((home ^ ((hi * 0x9E3779B1) & M32)) & ((1 << bits) - 1))
    key = hi << 32 | lo
    return key - (1 << 64) if key >= 1 << 63 else key


def _split_np(keys):
    keys = np.asarray(keys, np.int64)
    return jnp.asarray((keys & M32).astype(np.uint32)), jnp.asarray(((keys >> 32) & M32).astype(np.uint32))


def _disjoint_homes(rng, bits, count, taken=()):
    """``count`` home slots whose windows of N_PROBES slots (wrapping) share
    no slot with each other's: lanes that no other lane of their launch
    writes, where the kernel's order of lanes cannot matter."""
    size, used, homes = 1 << bits, set(taken), []
    for h in rng.permutation(size).tolist():
        window = {(h + r) % size for r in range(th.N_PROBES)}
        if not window & used:
            homes.append(h)
            used |= window
            if len(homes) == count:
                break
    return homes


def _probe_case(case, bits=10):
    """(table, insert keys, insert valid, delete keys, delete valid) of a
    case, the table as JAX's and the port's plain rounds leave it (checked
    equal), the batches race-free.

    "load_0" / "load_50" / "load_75": a table of 2^bits slots filled to that
    share by batches of random keys, then about a tenth of them deleted
    (tombstones); the batches: fresh keys, keys in the table, invalid lanes.
    "wrap": homes within N_PROBES of the table's end, runs that reach past
    it.  "exhaustion": a key whose whole window is taken.
    "duplicate_behind_tombstone": a key whose first slot was freed by a
    delete, inserted again (stored twice), deleted (its first copy goes),
    inserted again."""
    rng = np.random.default_rng(PROBE_CASES.index(case) + 11)
    size = 1 << bits
    jhs = jh.init_hashset(bits)
    ths = th.init_hashset(bits, device="cpu")

    def insert(keys, valid):
        nonlocal jhs
        lo, hi = _split_np(keys)
        _, jhs = jh.probe_and_insert(jhs, lo, hi, jnp.asarray(valid))
        th.probe_and_insert_reference(ths, torch.as_tensor(np.asarray(keys, np.int64)), torch.as_tensor(valid))

    def delete(keys, valid):
        nonlocal jhs
        lo, hi = _split_np(keys)
        jhs = jh.probe_delete(jhs, lo, hi, jnp.asarray(valid))
        th.probe_delete_reference(ths, torch.as_tensor(np.asarray(keys, np.int64)), torch.as_tensor(valid))

    ins, dele = [], []
    if case.startswith("load_"):
        target = size * int(case[5:]) // 100
        filled = []
        while len(filled) < target:
            keys = rng.integers(-(1 << 62), 1 << 62, size=min(64, target - len(filled)))
            insert(keys, np.ones(len(keys), bool))
            filled += keys.tolist()
        if filled:
            gone = rng.choice(len(filled), size=len(filled) // 10, replace=False)
            delete(np.asarray(filled)[gone], np.ones(len(gone), bool))
        live = [k for k in filled if k in set(_jax_table(jhs).tolist())]
        homes = _disjoint_homes(rng, bits, 48)
        by_home = {first_slot_np(k, bits): k for k in live}
        for h in homes:  # a key in the table where one has this home, else a fresh one
            ins.append(by_home[h] if h in by_home and rng.random() < 0.3 else key_at_home(rng, h, bits))
        dhomes = _disjoint_homes(rng, bits, 48)
        for h in dhomes:
            dele.append(by_home[h] if h in by_home and rng.random() < 0.8 else key_at_home(rng, h, bits))
    elif case == "wrap":
        # Slots size-5 .. size-1 and 0 taken: homes at size-5 .. size-2 claim past the end.
        insert([key_at_home(rng, h % size, bits) for h in range(size - 5, size + 1)], np.ones(6, bool))
        ins = [key_at_home(rng, size - 3, bits), key_at_home(rng, size - 1 - 40, bits)]
        dele = [int(k) for k in _jax_table(jhs).tolist() if k not in (0, -1)][:3]
    elif case == "exhaustion":
        home = int(rng.integers(0, size))
        insert([key_at_home(rng, (home + r) % size, bits) for r in range(th.N_PROBES)], np.ones(th.N_PROBES, bool))
        far = (home + 64) % size
        insert([key_at_home(rng, far, bits) for _ in range(th.N_PROBES)], np.ones(th.N_PROBES, bool))
        ins = [key_at_home(rng, home, bits), key_at_home(rng, far, bits)]  # both windows full
        dele = [key_at_home(rng, (home + 200) % size, bits)]  # absent
    elif case == "duplicate_behind_tombstone":
        home = int(rng.integers(0, size))
        first, dup = key_at_home(rng, home, bits), key_at_home(rng, home, bits)
        insert([first], np.ones(1, bool))
        insert([dup], np.ones(1, bool))  # at home + 1
        delete([first], np.ones(1, bool))  # home is a tombstone
        ins, dele = [dup], [dup]
    assert torch.equal(ths.keys, _jax_table(jhs)), case
    ins, dele = np.asarray(ins, np.int64), np.asarray(dele, np.int64)
    return jhs, ths, ins, rng.random(len(ins)) < 0.9 if case.startswith("load_") else np.ones(len(ins), bool), \
        dele, rng.random(len(dele)) < 0.9 if case.startswith("load_") else np.ones(len(dele), bool)


PROBE_CASES = ("load_0", "load_50", "load_75", "wrap", "exhaustion", "duplicate_behind_tombstone")


@pytest.mark.parametrize("case", PROBE_CASES)
def test_window_probe_loop_form_matches_jax(case):
    """The kernels' window probe (visited_probe.cuh), run key by key as a
    numpy loop, against JAX's probe_and_insert / probe_delete rounds and the
    port's plain versions on race-free batches: is_new and the whole table
    equal, exactly, after an insert, a delete and (for the duplicate) the
    rounds after them."""
    bits = 10
    jhs, ths, ins, ins_valid, dele, del_valid = _probe_case(case, bits)
    table = ths.keys.numpy().copy()
    tombs = table == th.TOMBSTONE_KEY
    rounds = [("insert", ins, ins_valid), ("delete", dele, del_valid)]
    if case == "duplicate_behind_tombstone":
        rounds += [("insert", ins, ins_valid), ("delete", dele, del_valid), ("insert", ins, ins_valid)]
    for r, (op, keys, valid) in enumerate(rounds):
        lo, hi = _split_np(keys)
        tk = torch.as_tensor(keys)
        if op == "insert":
            want, jhs = jh.probe_and_insert(jhs, lo, hi, jnp.asarray(valid))
            plain, _ = th.probe_and_insert_reference(ths, tk, torch.as_tensor(valid))
            got = window_insert_np(table, keys, valid, bits)
            assert np.array_equal(got, np.asarray(want)) and np.array_equal(plain.numpy(), got), (case, r)
            if r == 0 and case in ("load_50", "load_75"):  # found keys, and claims of tombstones
                assert (valid & ~got).any() and np.isin(table[tombs], keys[got]).any(), case
        else:
            jhs = jh.probe_delete(jhs, lo, hi, jnp.asarray(valid))
            th.probe_delete_reference(ths, tk, torch.as_tensor(valid))
            window_delete_np(table, keys, valid, bits)
        assert np.array_equal(table, _jax_table(jhs).numpy()), (case, r)
        assert np.array_equal(table, ths.keys.numpy()), (case, r)
    size = 1 << bits
    load = float(((table != 0) & (table != -1)).mean())
    if case.startswith("load_"):
        assert abs(load - int(case[5:]) / 100 * 0.9) < 0.1, load
        assert case == "load_0" or (table == -1).any()  # tombstones on the probe paths
    elif case == "wrap":
        assert got.all() and table[0] != 0 and table[1] == ins[0]  # claimed past the end
    elif case == "exhaustion":
        assert got.all() and not np.isin(ins, table).any()  # reported new, not stored
    else:
        home = first_slot_np(int(ins[0]), bits)
        assert table[home] == ins[0] and table[(home + 1) % size] == ins[0]  # stored twice again


@pytest.mark.parametrize("n_obj", [4, 19, 100])
def test_fingerprint_wrapper_on_cpu_runs_the_fold_and_launches_nothing(n_obj):
    """On CPU tensors the fingerprint wrapper returns the plain fold's keys,
    equal to the JAX package's, for any leading shape (a search's root, a
    batch, a batch of batches), and launches no kernel."""
    from pushworld_tpu_torch.kernels import LAUNCHES

    rng = np.random.default_rng(n_obj)
    states = rng.integers(-3, 60, size=(64, n_obj, 2)).astype(np.int32)
    before = dict(LAUNCHES)
    for x in (states[:1], states, states.reshape(4, 16, n_obj, 2)):
        got = th.fingerprint(torch.as_tensor(x), 54)
        assert got.shape == x.shape[:-2]
        assert torch.equal(got, th.fingerprint_reference(torch.as_tensor(x), 54))
        lo, hi = jh.fingerprint(jnp.asarray(x), 54)
        assert torch.equal(got, _pack_np(lo, hi))
    assert dict(LAUNCHES) == before
