"""The search iteration's frontier bookkeeping (``search/batched.py``: the
gate and the selection, the ring's compaction, the append of the scored
children) against the JAX package's, exactly.

Held against ``pushworld_tpu.search.batched._select_frontier``,
``_append_history``, ``_append_frontier`` and the tail of ``_iterate``
(goal, priority keys, counters), on the same numpy-seeded frontiers,
including adversarial ones: every key tied, mostly EMPTY, a cursor that
forces a compaction, a frontier over its keep-bound (evictions), the
frontier-sharded search's ``nb`` and history ``margin``, and a closed gate
(the state unchanged):

- the plain versions, which the CPU runs;
- the algorithms of ``kernels/frontier.cu``, written here as numpy loops
  over its cluster of 8 CTAs: the select's per-tile radix selects of the
  (key, slot) words, sorted by counting into the regions, and the
  candidates' rows by binary lifting in the 8 regions; the compaction's LSD radix sort with per-warp stable ranks, offsets
  across tiles and skipped passes; and the append's tiles over a cluster
  (ballot ranks a warp, carries and the first goal across tiles).  Tile
  boundaries get their own cases: ragged tiles, ties that span two tiles,
  fewer live keys than B, F = B, one live key.

JAX's ``approx_min_k`` picks among tied keys in its own order (ROADMAP
queue 3); where keys tie, the selection is held against JAX's exact top-k in
(key, slot) order, as tests/test_torch_parallel.py does.  The kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Every value is an integer:
tolerance 0.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pushworld_tpu.search.batched as jb
from pushworld_tpu.ops import hashset as jh
from pushworld_tpu_torch.ops.hashset import HashSet, pack_key
from pushworld_tpu_torch.search import batched as tb
from test_torch_hashset import first_slot_np, key_at_home, window_delete_np

EMPTY = tb.EMPTY
B, N, F, BITS, HCAP = 16, 3, 256, 10, 1 << 12
U32 = 0xFFFFFFFF


# ------------------------------------------------------------ the frontier


def _frontier(kind, seed, F=F, cursor=None, B=B):
    """A numpy frontier of ``kind``: "distinct" (tie-free keys, a quarter
    EMPTY), "tied" (every live key equal), "sparse" (fewer than B live),
    "empty", "full" (every slot live: a compaction evicts), "one" (one live
    key, beside the first tile boundary of frontier.cu's cluster),
    "straddle" (3B equal lowest keys from B / 2 before that boundary: the
    B lowest cut through ties that span two tiles)."""
    rng = np.random.default_rng(seed)
    nov = rng.integers(1, 4, size=F)
    rgd = rng.integers(0, 60, size=F)
    keys = ((nov << 28) | (rgd << 15) | rng.permutation(0x8000)[:F]).astype(np.int32)
    live = rng.random(F) < 0.75
    edge = -(-F // KCLUSTER)
    if kind == "tied":
        keys[:] = (2 << 28) | (7 << 15) | 5
    elif kind == "sparse":
        live = np.zeros(F, bool)
        live[rng.choice(F, B // 2, replace=False)] = True
    elif kind == "empty":
        live[:] = False
    elif kind == "full":
        live[:] = True
    elif kind == "one":
        live[:] = False
        live[min(edge, F - 1)] = True
    elif kind == "straddle":
        keys[max(0, edge - B // 2):edge + 3 * B] = 1 << 28
        live[max(0, edge - B // 2):edge + 3 * B] = True
    keys = np.where(live, keys, EMPTY).astype(np.int32)
    lo = rng.integers(2, U32 - 1, size=F, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(2, U32 - 1, size=F, dtype=np.uint64).astype(np.uint32)
    return dict(h=keys, states=rng.integers(0, 30, size=(F, N, 2)).astype(np.int32),
                hist=rng.integers(0, HCAP, size=F).astype(np.int32), lo=lo, hi=hi,
                cursor=np.int32(F - 4 * B if cursor is None else cursor))


def _visited(fr):
    """A JAX visited set holding the live frontier's fingerprints (and a
    few others)."""
    vis = jh.init_hashset(BITS)
    _, vis = jh.probe_and_insert(vis, jnp.asarray(fr["lo"]), jnp.asarray(fr["hi"]), jnp.asarray(fr["h"] < EMPTY))
    return vis


def _history(seed, cursor, hcap=HCAP):
    rng = np.random.default_rng(seed + 100)
    return dict(parent=rng.integers(-1, hcap, size=hcap).astype(np.int32),
                action=rng.integers(-1, 4, size=hcap).astype(np.int32), cursor=np.int32(cursor))


def _jax_state(fr, hist, vis, solved=False, solved_hist=0):
    j = jnp.asarray
    return SimpleNamespace(frontier_h=j(fr["h"]), frontier_states=j(fr["states"]), frontier_hist=j(fr["hist"]),
                           frontier_lo=j(fr["lo"]), frontier_hi=j(fr["hi"]), ring_cursor=j(fr["cursor"]),
                           hist_parent=j(hist["parent"]), hist_action=j(hist["action"]),
                           hist_cursor=j(hist["cursor"]), visited=vis, solved=j(solved),
                           solved_hist=j(np.int32(solved_hist)))


def _packed(lo, hi):
    return pack_key(torch.as_tensor(np.asarray(lo).astype(np.int64)),
                    torch.as_tensor(np.asarray(hi).astype(np.int64)))


def _port_state(fr, hist, vis, solved=False, solved_hist=0):
    t = torch.as_tensor
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32)  # noqa: E731
    return tb.SearchState(
        frontier_states=t(fr["states"]).clone(), frontier_h=t(fr["h"]).clone(), frontier_hist=t(fr["hist"]).clone(),
        frontier_key=_packed(fr["lo"], fr["hi"]), ring_cursor=i32(fr["cursor"]),
        hist_parent=t(hist["parent"]).clone(), hist_action=t(hist["action"]).clone(), hist_cursor=i32(hist["cursor"]),
        visited=HashSet(keys=_packed(vis.key_lo, vis.key_hi), capacity_bits=BITS), novelty=None,
        solved=torch.tensor(bool(solved)), solved_hist=i32(solved_hist), iterations=i32(3), expansions=i32(40),
        evictions=i32(2), needs_deeper=i32(1))


def _exact_select(s, B):
    """JAX's _select_frontier with an exact top-k in (key, slot) order."""
    idx = jnp.argsort(s.frontier_h, stable=True)[:B]
    sel_valid = s.frontier_h[idx] < EMPTY
    frontier_h = s.frontier_h.at[idx].set(jnp.where(sel_valid, EMPTY, s.frontier_h[idx]))
    return s.frontier_states[idx], s.frontier_hist[idx], sel_valid, frontier_h


# ---------------------------------------------------- kernels as numpy loops


def _ord(h):
    return (np.asarray(h).astype(np.int64) & U32) ^ 0x80000000


KCLUSTER, KTHREADS = 8, 1024  # frontier.cu's cluster of CTAs, threads a CTA
PAD = np.uint64((1 << 64) - 1)


def _words(h, lo, m):
    """The (ord(key) << 32 | slot) words of the slots [lo, lo + m)."""
    return (_ord(h[lo:lo + m]).astype(np.uint64) << np.uint64(32)) | np.arange(lo, lo + m, dtype=np.uint64)


def block_lowest_np(words, take, rng):
    """``frontier.cu``'s block_lowest: a radix select over the keys of the
    64-bit words from the top byte (a histogram of the next 8 bits of the
    words that match the prefix; the digit of the take-th lowest), each pass
    then starting at the highest byte in which the words the last pass
    counted differ (the bytes above join the prefix).  It stops once the
    words that match are exactly those still wanted (every word <= prefix |
    ~mask is taken), or once they share their key: then every lower key is
    taken and, of that key, the first words in array (slot) order.  Returns
    the words and n: the first n (those below the tied key) in the collect's
    atomic order (any: shuffled here), the tied ones after them in order."""
    words = np.asarray(words, dtype=np.uint64)
    lim, tie, tie_take = PAD, None, 0
    if take < len(words):
        prefix = mask = np.uint64(0)
        k, shift = take, 56
        for _ in range(4):
            match = words[(words & mask) == prefix]
            hist = np.bincount(((match >> np.uint64(shift)) & np.uint64(255)).astype(np.int64), minlength=256)
            run, d = 0, 0
            while run + hist[d] < k:
                run += hist[d]
                d += 1
            prefix |= np.uint64(d) << np.uint64(shift)
            mask |= np.uint64(255) << np.uint64(shift)
            k -= run
            if hist[d] == k:
                lim = prefix | ~mask
                break
            if shift == 56 and d == (EMPTY ^ 0x80000000) >> 24:  # no key above EMPTY
                tie, tie_take = np.uint64(EMPTY ^ 0x80000000), k
                lim = (tie << np.uint64(32)) - np.uint64(1)
                break
            w_and, w_or = np.bitwise_and.reduce(match), np.bitwise_or.reduce(match)
            lower = (1 << shift) - 1
            diff = int(w_and ^ w_or) & lower
            nxt = (diff.bit_length() - 1) & ~7
            same = np.uint64(lower & ~((1 << (nxt + 8)) - 1))
            prefix |= w_and & same
            mask |= same
            if nxt < 32:
                tie, tie_take = prefix >> np.uint64(32), k
                lim = (tie << np.uint64(32)) - np.uint64(1)
                break
            shift = nxt
        assert tie is not None or lim != PAD
    below = words[words <= lim]
    tied = words[np.flatnonzero((words >> np.uint64(32)) == tie)[:tie_take]] if tie is not None else words[:0]
    assert len(below) + len(tied) == take
    return np.concatenate([below[rng.permutation(len(below))], tied]), len(below)


def _rank_by_count_np(words):
    """Each word's place among ``words``: the count of those below it, taken
    as the kernel takes it (parts threads a word, each counting a span)."""
    n = len(words)
    parts = 1 if n >= KTHREADS else KTHREADS // n
    span = -(-n // parts)
    rank = np.zeros(n, np.int64)
    for q in range(parts):
        part = words[q * span:(q + 1) * span]
        rank += np.array([int((part < w).sum()) for w in words], np.int64)
    return rank


def _lift_below_np(region, words):
    """For each of ``words``, the words below it in a sorted region, by
    binary lifting from the highest power of two not above its length."""
    top = 1
    while 2 * top <= len(region):
        top *= 2
    pos, bit = np.zeros(len(words), np.int64), top
    while bit:
        t = pos + bit
        pos = np.where((t <= len(region)) & (region[np.minimum(t, len(region)) - 1] < words), t, pos)
        bit >>= 1
    return pos


def select_kernel_np(h, states, fhist, B, solved=None, hist_cursor=None, hist_limit=0):
    """``frontier.cu``'s select kernel, one cluster of 8 CTAs: the gate's
    scalars; each CTA's min(B, m) lowest words of its tile (T = ceil(F / 8)
    slots), those below a tied key placed by counting the words below each
    and the tied ones in their order after them, into its region
    (stride = min(B, T) words, padded with all-ones words); the gate from
    the regions' first words, and each candidate's row as the words below
    it in the 8 regions (binary lifting).  Returns (parents, parent_hist,
    sel_valid, gate, new keys)."""
    F = h.shape[0]
    h = h.copy()
    if solved is not None and (solved or hist_cursor >= hist_limit):
        return None, None, np.zeros(B, bool), False, h
    rng = np.random.default_rng(0)
    T = -(-F // KCLUSTER)
    stride = min(B, T)
    regions = np.full((KCLUSTER, stride), PAD, dtype=np.uint64)
    for c in range(KCLUSTER):
        lo = min(c * T, F)
        m = min(T, F - lo)
        low, n = block_lowest_np(_words(h, lo, m), min(B, m), rng)
        if len(low):
            rank = np.arange(len(low))
            if n:
                rank[:n] = _rank_by_count_np(low[:n])
            assert sorted(rank.tolist()) == list(range(len(low)))
            regions[c, rank] = low
    first = regions[:, 0].min()
    if solved is not None and not (int(first >> np.uint64(32)) ^ 0x80000000) < EMPTY:
        return None, None, np.zeros(B, bool), False, h
    cand = regions.reshape(-1)
    cand = cand[cand != PAD]
    row = sum(_lift_below_np(regions[q], cand) for q in range(KCLUSTER))
    picked = row < B
    assert sorted(row[picked].tolist()) == list(range(B))
    slot_at = np.empty(B, np.int64)
    valid = np.empty(B, bool)
    slot_at[row[picked]] = (cand[picked] & np.uint64(U32)).astype(np.int64)
    valid[row[picked]] = ((cand[picked] >> np.uint64(32)).astype(np.int64) ^ 0x80000000) < EMPTY
    h[slot_at[valid]] = EMPTY
    return states[slot_at], fhist[slot_at], valid, True, h


def compact_kernel_np(h, states, fhist, fkey, cursor, table, nb, gate=True, bits=BITS):
    """``frontier.cu``'s compact kernel, one cluster of 8 CTAs: need; an LSD
    radix sort of the (key, slot) words by key, 4 passes of 8 bits, where CTA
    c owns the positions [c * T, c * T + T), warp w of a CTA the contiguous
    range [w * chunk, (w + 1) * chunk) of its tile, ranked in order; a word
    goes after its digit's words in the lower warps of its tile, and the
    tile's group of a digit after every lower digit's words and after the
    lower tiles' words of that digit; a pass whose digit is one for every
    word skipped;
    the permutation from copies, the drops with their deletes (the thread
    that writes a dropped position deletes its fingerprint from the visited
    set with visited_probe.cuh's window probe), the cursor.  Returns the new
    arrays, the cursor and the evicted count (None, None when it does not
    run)."""
    F = h.shape[0]
    keep = F - max(nb, F // 4)
    if not (gate and cursor + nb > F):
        return None, None
    T = -(-F // KCLUSTER)
    tiles = [(min(c * T, F), min(T, F - min(c * T, F))) for c in range(KCLUSTER)]
    arr = _words(h, 0, F)
    for p in range(4):
        shift = np.uint64(32 + 8 * p)
        digit = ((arr >> shift) & np.uint64(255)).astype(np.int64)
        tot, start = np.zeros((KCLUSTER, 256), np.int64), []
        for c, (lo, m) in enumerate(tiles):
            chunk = -(-m // 32)
            count = np.zeros((256, 32), np.int64)
            for w in range(32):
                wlo = min(w * chunk, m)
                count[:, w] = np.bincount(digit[lo + wlo:lo + min(wlo + chunk, m)], minlength=256)
            start.append(np.cumsum(count, 1) - count)  # a digit's words in the lower warps
            tot[c] = count.sum(1)
        every = tot.sum(0)
        if (every == F).any():
            continue
        first = np.cumsum(every) - every
        out = np.empty_like(arr)
        for c, (lo, m) in enumerate(tiles):
            delta = first + tot[:c].sum(0)  # where the tile's words of a digit start
            chunk = -(-m // 32)
            for w in range(32):
                wlo = min(w * chunk, m)
                for i in range(lo + wlo, lo + min(wlo + chunk, m)):
                    d = digit[i]
                    out[start[c][d, w] + delta[d]] = arr[i]
                    start[c][d, w] += 1
        arr = out
    slots = (arr & np.uint64(U32)).astype(np.int64)
    keys = ((arr >> np.uint64(32)).astype(np.int64) ^ 0x80000000).astype(np.int32)
    n_live = int((keys < EMPTY).sum())
    drop = (keys < EMPTY) & (np.arange(F) >= keep)
    new_key = fkey[slots]
    table = table.copy()
    window_delete_np(table, new_key[drop], np.ones(int(drop.sum()), bool), bits)
    arrays = dict(h=np.where(drop, EMPTY, keys).astype(np.int32), states=states[slots], hist=fhist[slots],
                  key=new_key, table=table)
    return arrays, (min(n_live, keep), int(drop.sum()))


APPEND_THREADS = 512  # frontier.cu kAppendThreads
INT_MAX = 2 ** 31 - 1


def append_shape(nb):
    """frontier.cu append_shape: (threads T, lanes a CTA, rounds) of the
    cluster's KCLUSTER CTAs."""
    per = -(-nb // KCLUSTER)
    T = min(APPEND_THREADS, -(-per // 32) * 32)
    return T, per, -(-per // T)


def _popc(x):
    return bin(x).count("1")


def append_kernel_np(cursor, ring, nb, Bexp, is_new, phist, actions, goal, nov, rgd, deeper, sel_valid,
                     use_novelty, hcap, margin, solved, solved_hist, F=None):
    """``frontier.cu``'s append kernel: a cluster of 8 CTAs, CTA c owning the
    lanes [c * per, c * per + per) one a thread in rounds of T; per (round,
    warp) a ballot of the new lanes, of the new goals and the count of new
    deeper lanes; warp 0's offsets of the words, the tile's sums and its
    first new goal (word, lane, rank); the sums of every tile in every CTA
    (distributed shared memory); a lane's rank = the lower tiles' carry +
    its word's offset + the new lanes below it in the word; the first goal
    = the first tile's goal, at cursor + that tile's carry + its rank.
    Returns the writes it makes (window slots p >= F are not written)."""
    T, per, rounds = append_shape(nb)
    K, W = KCLUSTER, T // 32
    fresh = np.asarray(is_new, bool)
    tiles = []
    for c in range(K):
        lo, hi = c * per, min(nb, c * per + per)
        new_w, goal_w, deeper_c = [], [], []
        for r in range(rounds):
            for w in range(W):
                nw = gw = dc = 0
                for ln in range(32):
                    l = lo + r * T + w * 32 + ln
                    if l < hi and fresh[l]:
                        nw |= 1 << ln
                        if goal is not None and goal[l]:
                            gw |= 1 << ln
                        if deeper is not None and deeper[l % len(rgd)]:
                            dc += 1
                new_w.append(nw)
                goal_w.append(gw)
                deeper_c.append(dc)
        counts = [_popc(x) for x in new_w]
        word_off = list(np.cumsum(counts) - counts)
        n_sel = sum(int(sel_valid[r]) for t in range(T) for r in range(c * T + t, len(sel_valid), K * T))
        goal_lane, goal_rank = INT_MAX, 0
        first = next((j for j, x in enumerate(goal_w) if x), None)
        if first is not None:
            f = (goal_w[first] & -goal_w[first]).bit_length() - 1
            goal_rank = int(word_off[first]) + _popc(new_w[first] & ((1 << f) - 1))
            goal_lane = lo + (first // W) * T + (first % W) * 32 + f
        tiles.append(dict(lo=lo, hi=hi, new_w=new_w, word_off=word_off, n_new=sum(counts), n_deeper=sum(deeper_c),
                          n_sel=n_sel, goal_lane=goal_lane, goal_rank=goal_rank))
    carries = np.cumsum([t["n_new"] for t in tiles]) - [t["n_new"] for t in tiles]
    hist_idx = np.zeros(nb, np.int32)
    records, window = {}, {}
    for c, t in enumerate(tiles):
        for l in range(t["lo"], t["hi"]):
            r, tid = divmod(l - t["lo"], T)
            j, ln = r * W + tid // 32, tid % 32
            idx = int(cursor + carries[c] + t["word_off"][j] + _popc(t["new_w"][j] & ((1 << ln) - 1))) if fresh[l] \
                else 0
            hist_idx[l] = idx
            if fresh[l] and idx < hcap:
                records[idx] = (int(phist[l % len(phist)]), int(actions[l]) if actions is not None else l // Bexp)
            key = EMPTY
            if fresh[l]:
                nv = int(nov[l]) if use_novelty else 1
                rv = int(min(max(float(rgd[l % len(rgd)]), 0.0), 8190.0))
                key = (nv << 28) | (rv << 15) | (~idx & 0x7FFF)
            if F is None or ring + l < F:
                window[ring + l] = (key, idx, l)
    n_new = sum(t["n_new"] for t in tiles)
    out = dict(hist_idx=hist_idx, records=records, window=window, hist_cursor=min(cursor + n_new, hcap - margin),
               ring_cursor=ring + nb, expansions=sum(t["n_sel"] for t in tiles),
               n_deeper=sum(t["n_deeper"] for t in tiles), solved=solved, solved_hist=solved_hist)
    if goal is not None and not solved:
        won = next((c for c, t in enumerate(tiles) if t["goal_lane"] != INT_MAX), None)
        out["solved_hist"] = int(cursor + carries[won] + tiles[won]["goal_rank"]) if won is not None else 0
        out["solved"] = won is not None
    return out


# ------------------------------------------------------------------ select


@pytest.mark.parametrize("kind", ["distinct", "tied", "sparse", "empty", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_matches_jax(kind, seed):
    fr = _frontier(kind, seed)
    js = _jax_state(fr, _history(seed, 10), _visited(fr))
    want = [np.asarray(x) for x in _exact_select(js, B)]
    ts = _port_state(fr, _history(seed, 10), _visited(fr))
    got = [x.numpy() for x in tb._select_frontier(ts, B)] + [ts.frontier_h.numpy()]
    for g, w, what in zip(got, want, ("parents", "parent_hist", "sel_valid", "frontier_h")):
        assert np.array_equal(g, w), (kind, what)
    # JAX's own selection: the same keys freed; where live keys do not tie,
    # the same slots, and where they do not tie at all, the same lanes in
    # the same order.
    jp, jhist, jvalid, jh_after = (np.asarray(x) for x in jb._select_frontier(js, B))
    assert np.array_equal(np.sort(jh_after), np.sort(want[3])) and np.array_equal(jvalid, want[2]), kind
    if kind != "tied":
        assert np.array_equal(jh_after, want[3]), kind
    if kind in ("distinct", "full"):
        assert np.array_equal(jp, want[0]) and np.array_equal(jhist, want[1]), kind
    # The kernel's algorithm.
    kp, khist, kvalid, gate, kh = select_kernel_np(fr["h"], fr["states"], fr["hist"], B)
    assert gate and np.array_equal(kvalid, want[2]) and np.array_equal(kh, want[3]), kind
    assert np.array_equal(kp, want[0]) and np.array_equal(khist, want[1]), kind


@pytest.mark.parametrize("case", ["open", "solved", "exhausted", "history_full"])
def test_gated_select(case):
    """select_and_gate: JAX's gate (read before the selection) and the
    selection masked by it; a closed gate selects nothing and frees
    nothing."""
    fr = _frontier("empty" if case == "exhausted" else "distinct", 5)
    cfg = tb.SearchConfig(expand=B, history_capacity=HCAP)
    limit = HCAP - 8 * B
    hist = _history(5, limit if case == "history_full" else limit - 1)
    ts = _port_state(fr, hist, _visited(fr), solved=case == "solved")
    parents, phist, valid, gate = tb.select_and_gate(cfg, ts)
    assert bool(gate) == (case == "open")
    _, _, kvalid, kgate, kh = select_kernel_np(fr["h"], fr["states"], fr["hist"], B, case == "solved",
                                               int(hist["cursor"]), limit)
    assert kgate == bool(gate) and np.array_equal(kvalid, valid.numpy())
    assert np.array_equal(kh, ts.frontier_h.numpy())
    if case == "open":
        want = [np.asarray(x) for x in _exact_select(_jax_state(fr, hist, _visited(fr)), B)]
        assert np.array_equal(valid.numpy(), want[2]) and np.array_equal(parents.numpy(), want[0])
    else:
        assert not valid.any() and np.array_equal(ts.frontier_h.numpy(), fr["h"])


# (F, B): F = B; F a multiple of the cluster and not; tiles shorter than B
# (F < 8B) and longer than a CTA's 1,024 threads (F > 8,192).
TILE_CASES = [(8, 8), (17, 5), (100, 16), (256, 256), (257, 16), (1000, 64), (1031, 256), (4099, 300),
              (10001, 256)]
TILE_KINDS = ["distinct", "tied", "sparse", "empty", "full", "one", "straddle"]


def _plain_state(fr, bits):
    """A port state of the frontier ``fr``, its live fingerprints in a
    visited set of 2^bits slots (the plain versions' inputs)."""
    from pushworld_tpu_torch.ops import hashset as th

    t = torch.as_tensor
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32)  # noqa: E731
    vis = th.init_hashset(bits, device="cpu")
    key = _packed(fr["lo"], fr["hi"])
    th.probe_and_insert_reference(vis, key, t(fr["h"] < EMPTY))
    return tb.SearchState(
        frontier_states=t(fr["states"]).clone(), frontier_h=t(fr["h"]).clone(), frontier_hist=t(fr["hist"]).clone(),
        frontier_key=key, ring_cursor=i32(fr["cursor"]), hist_parent=None, hist_action=None, hist_cursor=i32(0),
        visited=vis, novelty=None, solved=torch.tensor(False), solved_hist=i32(0), iterations=i32(0),
        expansions=i32(0), evictions=i32(0), needs_deeper=i32(0))


@pytest.mark.parametrize("kind", TILE_KINDS)
@pytest.mark.parametrize("F,b", TILE_CASES)
def test_select_kernel_algorithm_at_tile_boundaries(F, b, kind):
    """The select kernel's cluster algorithm (tiles of ceil(F / 8) slots,
    per-tile candidates sorted into regions, rows by binary lifting) against JAX's exact
    top-k in (key, slot) order and the plain version: the same rows, freed
    keys and gate, wherever tiles split ties, at ragged tiles and F = B."""
    fr = _frontier(kind, F + b, F=F, B=b)
    idx = np.asarray(jnp.argsort(jnp.asarray(fr["h"]), stable=True))[:b]
    want_valid = fr["h"][idx] < EMPTY
    want_h = fr["h"].copy()
    want_h[idx[want_valid]] = EMPTY
    kp, khist, kvalid, gate, kh = select_kernel_np(fr["h"], fr["states"], fr["hist"], b)
    assert gate and np.array_equal(kvalid, want_valid) and np.array_equal(kh, want_h), (F, b, kind)
    assert np.array_equal(kp, fr["states"][idx]) and np.array_equal(khist, fr["hist"][idx]), (F, b, kind)
    ts = _plain_state(fr, BITS)
    got = tb.select_frontier_reference(ts, b)
    assert np.array_equal(got[0].numpy(), kp) and np.array_equal(got[2].numpy(), kvalid), (F, b, kind)
    assert np.array_equal(ts.frontier_h.numpy(), kh), (F, b, kind)
    # Gated: open unless every key is EMPTY.
    _, _, gvalid, ggate, gh = select_kernel_np(fr["h"], fr["states"], fr["hist"], b, False, 0, 1)
    assert ggate == bool((fr["h"] < EMPTY).any()), (F, b, kind)
    assert np.array_equal(gh, kh if ggate else fr["h"]) and np.array_equal(gvalid, kvalid & ggate), (F, b, kind)


@pytest.mark.parametrize("kind", TILE_KINDS)
@pytest.mark.parametrize("F", [9, 100, 257, 1031, 4099, 10001])
def test_compact_kernel_algorithm_at_tile_boundaries(F, kind):
    """The compaction kernel's cluster sort (tiles of ceil(F / 8) slots,
    per-warp stable ranks, (digit, tile) offsets, skipped passes) and its
    drops against JAX's stable argsort of the keys and the plain version,
    with a cursor that forces it."""
    nb = max(1, F // 8)
    fr = _frontier(kind, F + 3, F=F, cursor=F - nb + 1, B=16)
    bits = max(BITS, F.bit_length() + 1)
    ts = _plain_state(fr, bits)
    table = ts.visited.keys.numpy().copy()
    arrays, (ring, n_evicted) = compact_kernel_np(fr["h"], fr["states"], fr["hist"], ts.frontier_key.numpy(),
                                                  int(fr["cursor"]), table, nb, bits=bits)
    order = np.asarray(jnp.argsort(jnp.asarray(fr["h"]), stable=True))
    keep = F - max(nb, F // 4)
    live = fr["h"][order] < EMPTY
    assert np.array_equal(arrays["h"], np.where(live & (np.arange(F) >= keep), EMPTY, fr["h"][order])), (F, kind)
    assert np.array_equal(arrays["states"], fr["states"][order]) and np.array_equal(arrays["hist"],
                                                                                     fr["hist"][order]), (F, kind)
    before = int(ts.evictions)
    tb.compact_frontier_reference(ts, nb)
    for mine, theirs in (("h", "frontier_h"), ("states", "frontier_states"), ("hist", "frontier_hist"),
                         ("key", "frontier_key")):
        assert np.array_equal(arrays[mine], getattr(ts, theirs).numpy()), (F, kind, mine)
    assert np.array_equal(arrays["table"], ts.visited.keys.numpy()), (F, kind)
    assert ring == int(ts.ring_cursor) and n_evicted == int(ts.evictions) - before, (F, kind)
    if kind == "full":
        assert n_evicted > 0


@pytest.mark.parametrize("visited", ["absent", "behind_tombstone", "twice_in_the_frontier"])
@pytest.mark.parametrize("F", [100, 1031, 4099])
def test_compact_kernel_deletes_match_jax(F, visited):
    """The compaction kernel's own deletes (its loop form) against JAX's
    probe_delete of the dropped entries and the plain compaction: the whole
    visited table equal, where dropped fingerprints are absent from the
    visited set, where they sit one slot behind a tombstone of their home,
    and where one key stands in the frontier twice (stored twice in the
    table: both lanes meet on its first copy, the second survives)."""
    nb = max(1, F // 8)
    fr = _frontier("full", F + 5, F=F, cursor=F - nb + 1, B=16)
    bits = max(BITS, F.bit_length() + 1)
    rng = np.random.default_rng(F + len(visited))
    order = np.asarray(jnp.argsort(jnp.asarray(fr["h"]), stable=True))
    keep = F - max(nb, F // 4)
    dropped = order[keep:]  # every slot is live: positions keep .. F - 1 are dropped
    if visited == "twice_in_the_frontier":
        fr["lo"][dropped[1]], fr["hi"][dropped[1]] = fr["lo"][dropped[0]], fr["hi"][dropped[0]]
    keys = _packed(fr["lo"], fr["hi"]).numpy()
    picked = dropped[::3]

    def jax_keys(k):
        k = np.asarray(k, np.int64)
        return jnp.asarray((k & U32).astype(np.uint32)), jnp.asarray(((k >> 32) & U32).astype(np.uint32))

    vis = jh.init_hashset(bits)
    decoys = [key_at_home(rng, first_slot_np(int(keys[s]), bits), bits) for s in picked]
    if visited != "absent":  # each picked key's home holds a decoy inserted first
        _, vis = jh.probe_and_insert(vis, *jax_keys(decoys), jnp.ones(len(decoys), bool))
    stored = np.unique(keys) if visited != "absent" else np.setdiff1d(keys, keys[picked])
    _, vis = jh.probe_and_insert(vis, *jax_keys(stored), jnp.ones(len(stored), bool))
    if visited != "absent":
        vis = jh.probe_delete(vis, *jax_keys(decoys), jnp.ones(len(decoys), bool))
    if visited == "twice_in_the_frontier":  # inserted again behind the tombstone: stored twice
        _, vis = jh.probe_and_insert(vis, *jax_keys(keys[dropped[:1]]), jnp.ones(1, bool))
    table = _packed(vis.key_lo, vis.key_hi).numpy()
    want = jh.probe_delete(vis, *jax_keys(keys[dropped]), jnp.ones(len(dropped), bool))
    want = _packed(want.key_lo, want.key_hi).numpy()

    arrays, (_, n_evicted) = compact_kernel_np(fr["h"], fr["states"], fr["hist"], keys, int(fr["cursor"]), table,
                                               nb, bits=bits)
    ts = _plain_state(fr, bits)
    ts.visited.keys.copy_(torch.as_tensor(table))
    tb.compact_frontier_reference(ts, nb)
    assert n_evicted == len(dropped)
    assert np.array_equal(arrays["table"], want) and np.array_equal(ts.visited.keys.numpy(), want), (F, visited)
    homes = [first_slot_np(int(keys[s]), bits) for s in picked]
    if visited == "absent":
        assert not np.isin(keys[picked], table).any() and np.array_equal(want != table, np.isin(table, keys[dropped]))
    elif visited == "behind_tombstone":
        assert all(want[h] == -1 and table[h] == -1 for h in homes)  # the tombstone ahead of each
        assert not np.isin(keys[dropped], want).any()
    else:
        first = int(keys[dropped[0]])
        assert (table == first).sum() == 2 and (want == first).sum() == 1
        assert table[homes[0]] == first and want[homes[0]] == -1  # the first copy went


# ------------------------------------------------- compaction and append


def _children(seed, nb):
    """nb scored children: states, fingerprints, novelty, rgd, flags."""
    rng = np.random.default_rng(seed + 7)
    return dict(states=rng.integers(0, 30, size=(nb, N, 2)).astype(np.int32),
                lo=rng.integers(2, U32 - 1, size=nb, dtype=np.uint64).astype(np.uint32),
                hi=rng.integers(2, U32 - 1, size=nb, dtype=np.uint64).astype(np.uint32),
                is_new=rng.random(nb) < 0.6, nov=rng.integers(1, 4, size=nb).astype(np.float32),
                rgd=np.where(rng.random(nb) < 0.1, 1e9, rng.integers(0, 9000, size=nb)).astype(np.float32),
                deeper=rng.random(nb) < 0.2, goal=rng.random(nb) < 0.05)


def _jax_tail(js, cfg, ch, phist, actions, sel_valid, nb, margin, rgd_per_lane, deeper_per_lane, with_goal):
    """The JAX package's steps 4-7 of _iterate (the sharded search's margin
    and goal-free form where asked): history, goal, keys, ring append."""
    j = jnp.asarray
    is_new = j(ch["is_new"])
    if margin == 8:
        hist_parent, hist_action, hist_cursor, hist_idx = jb._append_history(js, cfg, is_new, j(phist), j(actions))
    else:  # pushworld_tpu/parallel/frontier_sharded.py's inline append
        offs = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        hist_idx = jnp.where(is_new, js.hist_cursor + offs, 0)
        write_idx = jnp.where(is_new, hist_idx, cfg.history_capacity - 1)
        hist_parent = js.hist_parent.at[write_idx].set(jnp.where(is_new, j(phist), js.hist_parent[write_idx]))
        hist_action = js.hist_action.at[write_idx].set(jnp.where(is_new, j(actions), js.hist_action[write_idx]))
        hist_cursor = jnp.minimum(js.hist_cursor + jnp.sum(is_new.astype(jnp.int32)), cfg.history_capacity - margin)
    out = dict(hist_parent=hist_parent, hist_action=hist_action, hist_cursor=hist_cursor, hist_idx=hist_idx)
    if with_goal:
        goal = j(ch["goal"]) & is_new
        any_goal = jnp.any(goal)
        out["solved"] = js.solved | any_goal
        out["solved_hist"] = jnp.where(js.solved, js.solved_hist, jnp.where(any_goal, hist_idx[jnp.argmax(goal)], 0))
    h = jnp.where(is_new, jb._priority(j(ch["nov"]), j(rgd_per_lane), hist_idx, cfg.use_novelty), np.int32(EMPTY))
    out["n_deeper"] = jnp.sum((j(deeper_per_lane) & is_new).astype(jnp.int32))
    (out["frontier_states"], out["frontier_h"], out["frontier_hist"], lo, hi, out["ring_cursor"], vis,
     out["n_evicted"]) = jb._append_frontier(js, B, h, j(ch["states"]), hist_idx, j(ch["lo"]), j(ch["hi"]),
                                             js.visited)
    out["frontier_key"] = _packed(lo, hi).numpy()
    out["table"] = _packed(vis.key_lo, vis.key_hi).numpy()
    out["expansions"] = int(np.asarray(sel_valid).sum())
    return {k: np.asarray(v) for k, v in out.items()}


CASES = {
    # name: (frontier kind, ring cursor (None: window only), lanes, margin, lazy)
    "window": ("distinct", 40, 4 * B, 8, False),
    "compacts": ("distinct", F - 4 * B + 1, 4 * B, 8, False),
    "evicts": ("full", F - 4 * B + 1, 4 * B, 8, False),
    "evicts_at_the_edge": ("full", F - 1, 4 * B, 8, True),
    "tied_compaction": ("tied", F - 4 * B + 3, 4 * B, 8, False),
    "sharded_two_ranks": ("full", F - 8 * B + 5, 8 * B, 8 * B * 2, False),
    "history_at_its_limit": ("distinct", 12, 4 * B, 8, False),
}


@pytest.mark.parametrize("solved", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_and_append_match_jax(case, solved):
    kind, cursor, nb, margin, lazy = CASES[case]
    seed = len(case)
    fr = _frontier(kind, seed, cursor=cursor)
    ch = _children(seed, nb)
    # At its limit, the new records end 2 short of the capacity, past the
    # cursor's clamp at capacity - margin.
    hist = _history(seed, HCAP - int(ch["is_new"].sum()) - 2 if case == "history_at_its_limit" else 17)
    sharded = margin != 8
    cfg = tb.SearchConfig(expand=B, history_capacity=HCAP, use_novelty=seed % 2 == 0)
    rng = np.random.default_rng(seed)
    sel_valid = rng.random(B) < 0.9
    parent_hist = rng.integers(0, 100, size=nb if sharded else B).astype(np.int32)
    actions = rng.integers(0, 4, size=nb).astype(np.int32) if sharded else None
    phist4 = parent_hist if sharded else np.tile(parent_hist, 4)
    act4 = actions if sharded else np.repeat(np.arange(4, dtype=np.int32), B)
    rgd, deeper = ch["rgd"], ch["deeper"]
    if lazy:  # per-parent values (the lazy mode), repeated over the four action blocks
        rgd, deeper = rgd[:B], deeper[:B]
    js = _jax_state(fr, hist, _visited(fr), solved=solved, solved_hist=9 if solved else 0)
    want = _jax_tail(js, cfg, ch, phist4, act4, sel_valid, nb, margin, np.tile(rgd, nb // len(rgd)),
                     np.tile(deeper, nb // len(deeper)), not sharded)

    ts = _port_state(fr, hist, _visited(fr), solved=solved, solved_hist=9 if solved else 0)
    before = {k: int(getattr(ts, k)) for k in ("iterations", "expansions", "evictions", "needs_deeper")}
    t = torch.as_tensor
    tb.compact_frontier(ts, nb)
    hist_idx = tb.append_children(
        ts, cfg, None, t(ch["is_new"]), t(parent_hist), None if actions is None else t(actions),
        None if sharded else t(ch["goal"]), t(ch["nov"]), t(rgd), None if sharded else t(deeper), t(sel_valid),
        t(ch["states"]), _packed(ch["lo"], ch["hi"]), margin=margin)
    assert np.array_equal(hist_idx.numpy(), want["hist_idx"])
    for f in ("frontier_h", "frontier_states", "frontier_hist", "frontier_key", "hist_parent", "hist_action"):
        assert np.array_equal(getattr(ts, f).numpy(), want[f]), (case, f)
    assert np.array_equal(ts.visited.keys.numpy(), want["table"]), case
    assert int(ts.ring_cursor) == int(want["ring_cursor"]) and int(ts.hist_cursor) == int(want["hist_cursor"])
    assert int(ts.evictions) - before["evictions"] == int(want["n_evicted"])
    assert int(ts.iterations) - before["iterations"] == 1
    assert int(ts.expansions) - before["expansions"] == want["expansions"]
    assert int(ts.needs_deeper) - before["needs_deeper"] == (0 if sharded else int(want["n_deeper"]))
    if not sharded:
        assert bool(ts.solved) == bool(want["solved"]) and int(ts.solved_hist) == int(want["solved_hist"])
    if case.startswith("evicts") or case == "sharded_two_ranks":
        assert int(want["n_evicted"]) > 0
    if case == "history_at_its_limit":
        assert int(want["hist_cursor"]) == HCAP - margin

    # The kernels' algorithms, on the same inputs.
    keys = _packed(fr["lo"], fr["hi"]).numpy()
    table = _packed(js.visited.key_lo, js.visited.key_hi).numpy()
    arrays, counts = compact_kernel_np(fr["h"], fr["states"], fr["hist"], keys, int(fr["cursor"]), table, nb)
    if arrays is None:
        arrays = dict(h=fr["h"].copy(), states=fr["states"].copy(), hist=fr["hist"].copy(), key=keys, table=table)
        counts = (int(fr["cursor"]), 0)
    ring, n_evicted = counts
    assert n_evicted == int(want["n_evicted"]) and np.array_equal(arrays["table"], want["table"]), case
    app = append_kernel_np(int(hist["cursor"]), ring, nb, B, ch["is_new"], parent_hist, actions,
                           None if sharded else ch["goal"], ch["nov"], rgd, None if sharded else deeper, sel_valid,
                           cfg.use_novelty, HCAP, margin, solved, 9 if solved else 0)
    for idx, (p, a) in app["records"].items():
        arrays.setdefault("parent", hist["parent"].copy())[idx] = p
        arrays.setdefault("action", hist["action"].copy())[idx] = a
    new_keys = _packed(ch["lo"], ch["hi"]).numpy()
    for pos, (key, idx, lane) in app["window"].items():
        arrays["h"][pos], arrays["hist"][pos] = key, idx
        arrays["states"][pos], arrays["key"][pos] = ch["states"][lane], new_keys[lane]
    assert np.array_equal(app["hist_idx"], want["hist_idx"])
    for mine, theirs in (("h", "frontier_h"), ("states", "frontier_states"), ("hist", "frontier_hist"),
                         ("key", "frontier_key"), ("parent", "hist_parent"), ("action", "hist_action")):
        assert np.array_equal(arrays.get(mine, hist.get(mine)), want[theirs]), (case, mine)
    assert app["ring_cursor"] == int(want["ring_cursor"]) and app["hist_cursor"] == int(want["hist_cursor"])
    assert app["expansions"] == want["expansions"]
    if not sharded:
        assert app["n_deeper"] == int(want["n_deeper"])
        assert app["solved"] == bool(want["solved"]) and app["solved_hist"] == int(want["solved_hist"])


# name: (lanes nb, the search's B, what): the sharded search's call (4 ranks
# x 4B lanes, actions and per-lane parents given, no goal and no deeper);
# tiles that are no multiple of a warp; the lazy mode's per-parent rgd and
# deeper; a goal in a later tile than the first new child; a solved search;
# history indices that cross capacity - margin; rounds
# (1,024 threads a CTA, several lanes a thread); the fewest lanes.
APPEND_SHAPES = {
    "sharded_four_ranks": (4096, 256, "sharded"),
    "ragged_tiles": (1000, 250, "eager"),
    "lazy_per_parent": (1036, 259, "lazy"),
    "goal_in_a_later_tile": (1024, 256, "late_goal"),
    "already_solved": (1024, 256, "solved"),
    "history_crosses_its_limit": (1024, 256, "hcap"),
    "rounds": (20000, 5000, "eager"),
    "four_lanes": (4, 1, "eager"),
}


@pytest.mark.parametrize("case", sorted(APPEND_SHAPES))
def test_append_kernel_algorithm_across_shapes(case):
    """The append kernel's cluster algorithm and the plain version against
    JAX's history append, goal, keys, window and counters (no compaction:
    the window fits), at lane counts and tiles beyond the search's 1,024."""
    nb, Bexp, what = APPEND_SHAPES[case]
    seed = len(case)
    T, per, rounds = append_shape(nb)
    Fw = max(256, nb + 64)
    fr = _frontier("distinct", seed, F=Fw, cursor=40)
    ch = _children(seed, nb)
    hcap = 1 << 15
    sharded = what == "sharded"
    margin = 8 * Bexp * 4 if sharded else 8
    if what == "late_goal":  # new children in the first tile, the only goal in the second
        ch["goal"][:] = False
        ch["is_new"][:3] = True
        ch["goal"][per + 7] = ch["is_new"][per + 7] = True
        assert per + 7 < nb
    if what == "hcap":  # 10 new children in several tiles, the last 5 past capacity - margin
        ch["is_new"][:] = False
        ch["is_new"][np.linspace(0, nb - 1, 10).astype(int)] = True
    cursor = hcap - margin - 5 if what == "hcap" else 17
    hist = _history(seed, cursor, hcap)
    cfg = tb.SearchConfig(expand=Bexp, history_capacity=hcap, use_novelty=seed % 2 == 1)
    rng = np.random.default_rng(seed)
    sel_valid = rng.random(Bexp) < 0.9
    parent_hist = rng.integers(0, 100, size=nb if sharded else Bexp).astype(np.int32)
    actions = rng.integers(0, 4, size=nb).astype(np.int32) if sharded else None
    phist4 = parent_hist if sharded else np.tile(parent_hist, nb // Bexp)
    act4 = actions if sharded else np.repeat(np.arange(nb // Bexp, dtype=np.int32), Bexp)
    rgd, deeper = ch["rgd"], ch["deeper"]
    if what == "lazy":
        rgd, deeper = rgd[:Bexp], deeper[:Bexp]
    solved = what == "solved"
    js = _jax_state(fr, hist, _visited(fr), solved=solved, solved_hist=9 if solved else 0)
    want = _jax_tail(js, cfg, ch, phist4, act4, sel_valid, nb, margin, np.tile(rgd, nb // len(rgd)),
                     np.tile(deeper, nb // len(deeper)), not sharded)
    if what == "hcap":
        assert want["hist_idx"].max() >= hcap - margin == int(want["hist_cursor"])
    if what == "late_goal":
        assert bool(want["solved"]) and int(want["solved_hist"]) == int(want["hist_idx"][per + 7])

    # The plain version.
    ts = _port_state(fr, hist, _visited(fr), solved=solved, solved_hist=9 if solved else 0)
    before = {k: int(getattr(ts, k)) for k in ("iterations", "expansions", "needs_deeper")}
    t = torch.as_tensor
    hist_idx = tb.append_children(
        ts, cfg, None, t(ch["is_new"]), t(parent_hist), None if actions is None else t(actions),
        None if sharded else t(ch["goal"]), t(ch["nov"]), t(rgd), None if sharded else t(deeper), t(sel_valid),
        t(ch["states"]), _packed(ch["lo"], ch["hi"]), margin=margin)
    assert np.array_equal(hist_idx.numpy(), want["hist_idx"]), case
    for f in ("frontier_h", "frontier_states", "frontier_hist", "frontier_key", "hist_parent", "hist_action"):
        assert np.array_equal(getattr(ts, f).numpy(), want[f]), (case, f)
    assert int(ts.ring_cursor) == int(want["ring_cursor"]) and int(ts.hist_cursor) == int(want["hist_cursor"])
    assert int(ts.iterations) - before["iterations"] == 1
    assert int(ts.expansions) - before["expansions"] == want["expansions"]
    assert int(ts.needs_deeper) - before["needs_deeper"] == (0 if sharded else int(want["n_deeper"]))
    if not sharded:
        assert bool(ts.solved) == bool(want["solved"]) and int(ts.solved_hist) == int(want["solved_hist"])

    # The kernel's algorithm.
    app = append_kernel_np(int(hist["cursor"]), int(fr["cursor"]), nb, Bexp, ch["is_new"], parent_hist, actions,
                           None if sharded else ch["goal"], ch["nov"], rgd, None if sharded else deeper,
                           sel_valid, cfg.use_novelty, hcap, margin, solved, 9 if solved else 0, F=Fw)
    assert np.array_equal(app["hist_idx"], want["hist_idx"]), case
    parent, action = hist["parent"].copy(), hist["action"].copy()
    for idx, (p, a) in app["records"].items():
        parent[idx], action[idx] = p, a
    assert np.array_equal(parent, want["hist_parent"]) and np.array_equal(action, want["hist_action"]), case
    h, fh, states = fr["h"].copy(), fr["hist"].copy(), fr["states"].copy()
    for pos, (key, idx, lane) in app["window"].items():
        h[pos], fh[pos], states[pos] = key, idx, ch["states"][lane]
    assert np.array_equal(h, want["frontier_h"]) and np.array_equal(fh, want["frontier_hist"]), case
    assert np.array_equal(states, want["frontier_states"]), case
    assert app["ring_cursor"] == int(want["ring_cursor"]) and app["hist_cursor"] == int(want["hist_cursor"])
    assert app["expansions"] == want["expansions"]
    if not sharded:
        assert app["n_deeper"] == int(want["n_deeper"])
        assert app["solved"] == bool(want["solved"]) and app["solved_hist"] == int(want["solved_hist"])


@pytest.mark.parametrize("kind", ["distinct", "full"])
def test_closed_gate_leaves_the_state_unchanged(kind):
    """With the gate closed, the compaction (even where the cursor asks for
    one) and the append change nothing."""
    fr = _frontier(kind, 3, cursor=F - 4 * B + 1)
    hist = _history(3, 30)
    ch = _children(3, 4 * B)
    ts = _port_state(fr, hist, _visited(fr))
    before = {k: v.clone() for k, v in vars(ts).items() if isinstance(v, torch.Tensor)}
    table = ts.visited.keys.clone()
    cfg = tb.SearchConfig(expand=B, history_capacity=HCAP)
    closed = torch.tensor(False)
    t = torch.as_tensor
    tb.compact_frontier(ts, 4 * B, closed)
    tb.append_children(ts, cfg, closed, t(ch["is_new"]) & closed, t(np.arange(B, dtype=np.int32)), None,
                       t(ch["goal"]), t(ch["nov"]), t(ch["rgd"]), t(ch["deeper"]), torch.zeros(B, dtype=torch.bool),
                       t(ch["states"]), _packed(ch["lo"], ch["hi"]))
    for k, v in before.items():
        assert torch.equal(getattr(ts, k), v), k
    assert torch.equal(ts.visited.keys, table)
    assert compact_kernel_np(fr["h"], fr["states"], fr["hist"], None, int(fr["cursor"]), None, 4 * B,
                             gate=False) == (None, None)


def test_compaction_sorts_only_when_it_compacts(monkeypatch):
    """The plain compaction takes JAX's lax.cond branch on the host: no
    sort of the keys when the window fits."""
    calls = []
    real = torch.argsort
    monkeypatch.setattr(torch, "argsort", lambda *a, **k: calls.append(1) or real(*a, **k))
    fr = _frontier("distinct", 4, cursor=20)
    ts = _port_state(fr, _history(4, 5), _visited(fr))
    tb.compact_frontier(ts, 4 * B)
    assert not calls and np.array_equal(ts.frontier_h.numpy(), fr["h"])
    ts.ring_cursor.fill_(F - 4 * B + 1)
    tb.compact_frontier(ts, 4 * B)
    assert calls and int(ts.ring_cursor) <= F - 4 * B


# -------------------------------------------------- RGD with a valid mask


@pytest.mark.parametrize("name,depth", [("heur/three_tools", 2), ("heur/two_tools", 1), ("multi_goal", 0)])
def test_rgd_valid_mask_fills_invalid_lanes(name, depth):
    import os

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd

    p = Puzzle.from_file(os.path.join(os.path.dirname(__file__), "puzzles", name + ".pwp"))
    t = rgd.build_rgd_tables(p, compile_puzzle(p), max_depth=depth, device="cpu")
    rng = np.random.default_rng(depth)
    states, s = [p.initial_state], p.initial_state
    for _ in range(31):
        for a in rng.integers(0, 4, size=3).tolist():
            s = p.get_next_state(s, a)
        states.append(s)
    states = torch.as_tensor(np.asarray(states, np.int32))
    valid = torch.as_tensor(rng.random(32) < 0.5)
    total, deeper = rgd.rgd_heuristic_with_flags(t, states, depth)
    vt, vd = rgd.rgd_heuristic_with_flags(t, states, depth, valid=valid)
    assert torch.equal(vt[valid], total[valid]) and torch.equal(vd[valid], deeper[valid])
    assert (vt[~valid] == rgd.INF).all() and not vd[~valid].any()
    assert torch.equal(rgd.rgd_heuristic(t, states, depth, valid=valid), vt)
