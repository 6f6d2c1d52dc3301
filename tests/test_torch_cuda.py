"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (CUDA kernels have no
CPU mode).  On a machine with a card, and without JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX).
"""

import glob
import os

import numpy as np
import pytest
import torch

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _seeds_and_masks(rng, B, H, W, shared, dev):
    from pushworld_tpu_torch.ops.graphs import INF

    E = torch.as_tensor(rng.random((1 if shared else B, 4, H, W)) < 0.6, device=dev)
    d0 = torch.full((B, H, W), INF, dtype=torch.float32, device=dev)
    d0[torch.arange(B), torch.as_tensor(rng.integers(0, H, B)), torch.as_tensor(rng.integers(0, W, B))] = 0.0
    return E, d0


@pytest.mark.parametrize("shape,shared", [
    ((7, 11, 13), False), ((40, 47, 54), True), ((3, 1, 9), False),
    ((9, 5, 64), True), ((11, 9, 150), True), ((5, 6, 131), False), ((2, 160, 160), True),
])
def test_wavefront_kernel_bit_equal(dev, shape, shared):
    """0/INF seeds (the bit-parallel path), shared and per-field masks, rows
    of one and of several 64-bit words, uncapped and capped."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops.graphs import distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    B, H, W = shape
    E, d0 = _seeds_and_masks(np.random.default_rng(B), B, H, W, shared, dev)
    before = LAUNCHES["wavefront"]
    for cap in (0, 2):
        got = distance_fields(E, d0, max_iters=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, distance_fields_reference(E, d0, max_iters=cap))
    assert LAUNCHES["wavefront"] == before + 2


@pytest.mark.parametrize("shape,shared", [((13, 11, 13), False), ((21, 47, 54), True), ((10, 7, 90), True)])
def test_wavefront_kernel_general_seeds(dev, shape, shared):
    """Seeds other than 0/INF take the kernel's float sweeps, field by
    field: a batch that mixes both kinds of field equals the plain version,
    uncapped and capped."""
    from pushworld_tpu_torch.ops.graphs import distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    B, H, W = shape
    rng = np.random.default_rng(B + W)
    E, d0 = _seeds_and_masks(rng, B, H, W, shared, dev)
    odd = torch.as_tensor(rng.integers(0, 30, (B, H, W)).astype(np.float32), device=dev)
    pick = torch.as_tensor(rng.random((B, H, W)) < 0.05, device=dev)
    pick[::3] = False  # every third field keeps its 0/INF seeds
    d0 = torch.where(pick, odd, d0)
    for cap in (0, 2):
        got = distance_fields(E, d0, max_iters=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, distance_fields_reference(E, d0, max_iters=cap))


def test_wavefront_reads_strided_mask_planes(dev):
    """One object's column of a (4, n_obj, H, W) stack is read in place."""
    from pushworld_tpu_torch.ops.graphs import distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    rng = np.random.default_rng(5)
    stack = torch.as_tensor(rng.random((4, 3, 12, 17)) < 0.6, device=dev)
    _, d0 = _seeds_and_masks(rng, 30, 12, 17, True, dev)
    for E in (stack[None, :, 1], stack.permute(1, 0, 2, 3)):
        d = d0[: 30 if E.shape[0] == 1 else 3]
        assert not E.is_contiguous()
        got = distance_fields(E, d)
        torch.cuda.synchronize()
        assert torch.equal(got, distance_fields_reference(E, d))


def test_wavefront_wrapper_raises_on_a_grid_too_large(dev):
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    E = torch.zeros((1, 4, 300, 300), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        distance_fields(E, torch.zeros((1, 300, 300), device=dev))


@pytest.mark.parametrize("n,n_obj", [(1024, 4), (4096, 6), (1, 1), (1024, 20), (20000, 3)])
def test_fused_fingerprint_dedup_insert_matches_plain_version(dev, n, n_obj):
    """Duplicate children, invalid lanes and keys already in the table; a
    sparse table, so no probe run is exhausted.  n = 20,000 takes the
    dedup table in device scratch."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import hashset as hs

    rng = np.random.default_rng(n + n_obj)
    pool = rng.integers(0, 50, size=(max(1, n // 2), n_obj, 2)).astype(np.int32)
    kern, ref = hs.init_hashset(20, device=dev), hs.init_hashset(20, device=dev)
    before = LAUNCHES["visited_set.fingerprint_dedup_insert"]
    for rnd in range(3):  # later rounds meet keys of earlier ones
        states = torch.as_tensor(pool[rng.integers(0, len(pool), n)], device=dev)
        valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
        k_k, n_k = hs.fingerprint_dedup_insert(kern, states, 54, valid)
        k_r, n_r = hs.fingerprint_dedup_insert_reference(ref, states, 54, valid)
        torch.cuda.synchronize()
        assert torch.equal(k_k, k_r) and torch.equal(k_k, hs.fingerprint_reference(states, 54))
        assert torch.equal(n_k, n_r), rnd
        assert torch.equal(torch.sort(kern.keys).values, torch.sort(ref.keys).values)
        if n > 1:
            assert n_k.sum() < valid.sum()  # the batch does hold duplicates
    assert LAUNCHES["visited_set.fingerprint_dedup_insert"] == before + 3
    # A closed gate: nothing is new and nothing is inserted.
    table = kern.keys.clone()
    _, n_k = hs.fingerprint_dedup_insert(kern, states, 54, valid & False, torch.zeros((), dtype=torch.bool,
                                                                                       device=dev))
    torch.cuda.synchronize()
    assert not n_k.any() and torch.equal(kern.keys, table)


@pytest.mark.parametrize("n_obj", [4, 19, 100])
def test_fingerprint_kernel_matches_the_fold(dev, n_obj):
    """1,024 states (random cells, negative and out-of-grid ones too) and a
    search's root: the kernel's keys equal the plain int64 fold's, one
    launch a call, any leading shape."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import hashset as hs

    rng = np.random.default_rng(n_obj)
    states = torch.as_tensor(rng.integers(-3, 60, size=(1024, n_obj, 2)).astype(np.int32), device=dev)
    before = LAUNCHES["visited_set.fingerprint"]
    for x, width in ((states, 54), (states[:1], 7), (states.reshape(8, 128, n_obj, 2), 1 << 20)):
        got = hs.fingerprint(x, width)
        torch.cuda.synchronize()
        assert got.shape == x.shape[:-2] and torch.equal(got, hs.fingerprint_reference(x, width))
    assert LAUNCHES["visited_set.fingerprint"] == before + 3


def test_search_start_runs_the_fingerprint_kernel(dev):
    """init_search_state on the card: the root's key comes from the
    fingerprint kernel (one launch), equal to the fold's."""
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import hashset as hs
    from pushworld_tpu_torch.search.batched import BatchedPlanner

    p = Puzzle.from_file(os.path.join(PUZZLES, "heur", "three_tools.pwp"))
    pl = BatchedPlanner(p, max_depth=1, device=dev, expand=32, frontier_capacity=1 << 10, visited_bits=14,
                        history_capacity=1 << 14, pair_bits=12)
    before = dict(LAUNCHES)
    s = pl.init_state()
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}
    assert launched == {"visited_set.fingerprint": 1, "visited_set.probe_and_insert": 1, "novelty.score": 1,
                        "novelty.absorb": 1, "rgd.heuristic": 1}, launched
    assert int(s.frontier_key[0]) == int(hs.fingerprint_reference(pl.cp_dev.init_state[None], p.width)[0])


@pytest.mark.parametrize("load", [0.0, 0.5, 0.75])
def test_visited_set_kernels_match_plain_version(dev, load):
    """The insert and the delete kernels against their plain versions on a
    table of 2^16 slots filled to ``load`` by the plain version, a tenth of
    it deleted again (tombstones on the probe paths).  On an empty table
    every lane is compared; on a loaded one the lanes whose windows no other
    lane of the batch meets, and the table outside the windows of the
    others (where two lanes race, either may claim a slot first)."""
    from pushworld_tpu_torch.ops import hashset as hs

    rng = np.random.default_rng(0)
    bits = 16
    size, mask = 1 << bits, (1 << bits) - 1
    base = hs.init_hashset(bits, device=dev)
    filled = torch.as_tensor(rng.integers(1, 1 << 62, int(load * size)), device=dev)
    hs.probe_and_insert_reference(base, filled, torch.ones_like(filled, dtype=torch.bool))
    hs.probe_delete_reference(base, filled, torch.as_tensor(rng.random(len(filled)) < 0.1, device=dev))
    if load:
        assert (base.keys == -1).any()
    states = torch.as_tensor(rng.integers(0, 50, size=(4096, 6, 2)).astype(np.int32), device=dev)
    keys = hs.fingerprint(states, 54)
    valid = hs.dedup_batch(keys, torch.ones(4096, dtype=torch.bool, device=dev))
    home = hs._first_slot(keys, bits)
    window = (home[:, None] + torch.arange(hs.N_PROBES, device=dev)) & mask  # (4096, 8)
    cover = torch.zeros(size, dtype=torch.int32, device=dev)
    cover.index_add_(0, window[valid].flatten(), torch.ones_like(window[valid].flatten(), dtype=torch.int32))
    alone = valid & (cover[window] == 1).all(1)
    raced = torch.zeros(size, dtype=torch.bool, device=dev)
    raced[window[valid & ~alone].flatten()] = True
    kern = hs.HashSet(keys=base.keys.clone(), capacity_bits=bits)
    ref = hs.HashSet(keys=base.keys.clone(), capacity_bits=bits)

    n_k, _ = hs.probe_and_insert(kern, keys, valid)
    n_r, _ = hs.probe_and_insert_reference(ref, keys, valid)
    torch.cuda.synchronize()
    assert torch.equal(n_k[alone], n_r[alone]) and torch.equal(kern.keys[~raced], ref.keys[~raced]), load
    assert alone.sum() > 1000
    live = kern.keys[(kern.keys != 0) & (kern.keys != -1)]
    assert torch.isin(live, torch.cat([filled, keys[valid]])).all()  # no torn keys
    if not load:  # no probe exhaustion at this load: is_new = valid, every key stored once
        assert torch.equal(n_k, n_r) and torch.equal(n_k, valid)
        assert torch.equal(torch.sort(live).values, torch.sort(keys[valid]).values)
    dele = valid & (torch.arange(4096, device=dev) % 3 == 0)
    hs.probe_delete(kern, keys, dele)
    hs.probe_delete_reference(ref, keys, dele)
    torch.cuda.synchronize()
    assert torch.equal(kern.keys[~raced], ref.keys[~raced]), load
    assert not torch.isin(keys[dele], kern.keys).any()
    again, _ = hs.probe_and_insert(kern, keys, valid)
    # Deleted keys are new again.  (A live key behind a tombstone is also
    # reported new and stored twice: the JAX semantics.)
    assert again[dele].all()
    if not load:
        live = kern.keys[(kern.keys != 0) & (kern.keys != -1)]
        assert set(live.tolist()) == set(keys[valid].tolist())


def _smoke():
    """chip_smoke.py as a module (its puzzle texts)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _walks(p, count, seed):
    """``count`` states of random walks from the initial state, and the four
    children of each (action-block order, as the search expands)."""
    rng = np.random.default_rng(seed)
    s = p.initial_state
    out = [s]
    for _ in range(count - 1):
        for a in rng.integers(0, 4, size=rng.integers(1, 6)).tolist():
            s = p.get_next_state(s, a)
        out.append(s)
    children = [p.get_next_state(s, a) for a in range(4) for s in out]
    return np.asarray(out, np.int32), np.asarray(children, np.int32)


def _rgd_kernel_equals_plain(t, states, depths):
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import rgd

    before = LAUNCHES["rgd.heuristic"]
    for depth in depths:
        total, deeper = rgd.rgd_heuristic_with_flags(t, states, depth)
        want_total, want_deeper = rgd.rgd_heuristic_with_flags_reference(t, states, depth)
        torch.cuda.synchronize()
        assert torch.equal(total, want_total) and torch.equal(deeper, want_deeper), depth
    assert LAUNCHES["rgd.heuristic"] == before + len(depths)


RGD_FIXTURES = sorted(os.path.relpath(f, PUZZLES)[:-4]
                      for f in glob.glob(os.path.join(PUZZLES, "**", "*.pwp"), recursive=True))


@pytest.mark.parametrize("name", RGD_FIXTURES)
def test_rgd_kernel_bit_equal_on_fixtures(dev, name):
    """Totals and flags at depths 0..4, bit-equal to the plain version on the
    card: parents (the lazy mode's batch) with masked lanes (empty frontier
    slots hold zeros), and their children (the eager mode's)."""
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd

    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    parents, children = _walks(p, 24, seed=len(name))
    parents = np.concatenate([parents, np.zeros((8,) + parents.shape[1:], np.int32)])
    t = rgd.build_rgd_tables(p, compile_puzzle(p), device=dev)
    for states in (parents, children):
        _rgd_kernel_equals_plain(t, torch.as_tensor(states, device=dev), (0, 1, 2, 3, 4))
    t0 = rgd.build_rgd_tables(p, compile_puzzle(p), max_depth=0, device=dev)
    _rgd_kernel_equals_plain(t0, torch.as_tensor(children, device=dev), (0,))


def test_rgd_kernel_bit_equal_on_47x54_and_deep_chains(dev):
    """1,024 children at depth 0 on the 47 x 54 puzzle, and 256 at depths
    0-4 with the deeper tables; depths 3-5 on a goal that needs four tools
    (the kernel's loop over T(., 2) tables); ten movables on unreachable
    states (every INF path), depth 4."""
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd

    smoke = _smoke()
    g = Puzzle.from_text(smoke.generated_puzzle_text(0))
    _, children = _walks(g, 256, seed=0)
    t = rgd.build_rgd_tables(g, compile_puzzle(g), max_depth=0, device=dev)
    _rgd_kernel_equals_plain(t, torch.as_tensor(children, device=dev), (0,))
    t = rgd.build_rgd_tables(g, compile_puzzle(g), device=dev)
    _rgd_kernel_equals_plain(t, torch.as_tensor(children[:256], device=dev), (0, 1, 2, 3, 4))
    four = Puzzle.from_text(smoke.FOUR_TOOLS_TEXT)
    parents, children = _walks(four, 16, seed=5)
    t = rgd.build_rgd_tables(four, compile_puzzle(four), device=dev)
    _rgd_kernel_equals_plain(t, torch.as_tensor(children, device=dev), (3, 4, 5))
    assert bool((rgd.rgd_heuristic(t, torch.as_tensor(parents, device=dev), 4) < 1e8).all())
    many = Puzzle.from_text(smoke.MANY_MOVABLES_TEXT)
    rng = np.random.default_rng(1)
    states = np.stack([rng.integers(0, many.width, (32, 10)), rng.integers(0, many.height, (32, 10))], -1)
    t = rgd.build_rgd_tables(many, compile_puzzle(many), device=dev)
    _rgd_kernel_equals_plain(t, torch.as_tensor(states.astype(np.int32), device=dev), (0, 4))


@pytest.mark.parametrize("pair_bits", [8, 24])
def test_novelty_kernels_bit_equal(dev, pair_bits):
    """Scores, seen_pos and the pair table after every batch of a sequence,
    bit-equal to the plain version's: 1,024 states a batch with invalid
    lanes on a small grid (positions repeat; at pair_bits 24 every score
    occurs, at 8 the 16 x 16 table fills in the first batch) and on the
    47 x 54 grid."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import novelty

    rng = np.random.default_rng(pair_bits)
    for n, H, W in ((4, 3, 4), (4, 47, 54), (20, 5, 6)):
        kern = novelty.init_novelty(n, H, W, pair_bits=pair_bits, device=dev)
        ref = novelty.init_novelty(n, H, W, pair_bits=pair_bits, device=dev)
        before = (LAUNCHES["novelty.score"], LAUNCHES["novelty.absorb"])
        scores = set()
        for r in range(4):
            B = 1024
            states = torch.as_tensor(
                np.stack([rng.integers(0, W, (B, n)), rng.integers(0, H, (B, n))], -1).astype(np.int32), device=dev)
            moved = torch.as_tensor(rng.random((B, n)) < 0.3, device=dev)
            valid = torch.as_tensor(rng.random(B) < 0.9, device=dev)
            got, _ = novelty.novelty_score_and_update(kern, states, moved, valid)
            want, _ = novelty.novelty_score_and_update_reference(ref, states, moved, valid)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, r)
            assert torch.equal(kern.seen_pos, ref.seen_pos), (n, r)
            assert torch.equal(kern.pair_table.view(torch.int16), ref.pair_table.view(torch.int16)), (n, r)
            scores |= set(got.tolist())
        assert (LAUNCHES["novelty.score"], LAUNCHES["novelty.absorb"]) == (before[0] + 4, before[1] + 4)
        if (n, H, pair_bits) == (4, 3, 24):
            assert scores == {1.0, 2.0, 3.0}


@pytest.mark.parametrize("depth", [0, 3])
def test_rgd_and_novelty_kernels_at_a_closed_gate_write_only_the_fill(dev, depth):
    """Every lane invalid (a closed gate's is_new): RGD writes total INF and
    flag False on every lane whatever its rows held, novelty scores 3 and
    leaves both tables bit-unchanged; so does an iteration of a solved
    search, through _iterate."""
    import dataclasses

    from pushworld_tpu_torch.ops import novelty, rgd
    from pushworld_tpu_torch.search import batched

    pl = _planner_on("heur/three_tools", dev, depth, expand=256, frontier_capacity=1 << 12, visited_bits=16,
                     history_capacity=1 << 14, pair_bits=24)
    s = pl.init_state()
    for _ in range(4):
        batched._iterate(pl.cp_dev, pl.tables, pl.config, s)
    parents, _, sel_valid, gate = batched.select_and_gate(pl.config, s)
    children = batched.expand_and_test(pl.cp_dev, pl.tables.contacts, pl.tables.contacts_mask, parents, sel_valid,
                                       gate)[0]
    none = torch.zeros((children.shape[0],), dtype=torch.bool, device=dev)
    total, deeper = rgd.rgd_heuristic_with_flags(pl.tables, children, depth, none)
    moved = torch.ones(children.shape[:2], dtype=torch.bool, device=dev)
    before = (s.novelty.seen_pos.clone(), s.novelty.pair_table.clone())
    nov, _ = novelty.novelty_score_and_update(s.novelty, children, moved, none)
    torch.cuda.synchronize()
    assert bool((total == rgd.INF).all()) and not bool(deeper.any())
    assert bool((nov == 3.0).all())
    assert torch.equal(s.novelty.seen_pos, before[0])
    assert torch.equal(s.novelty.pair_table.view(torch.int16), before[1].view(torch.int16))
    solved = dataclasses.replace(s, solved=torch.ones((), dtype=torch.bool, device=dev))
    batched._iterate(pl.cp_dev, pl.tables, pl.config, solved)
    torch.cuda.synchronize()
    assert torch.equal(solved.novelty.seen_pos, before[0])
    assert torch.equal(solved.novelty.pair_table.view(torch.int16), before[1].view(torch.int16))


@pytest.mark.parametrize("depth", [0, 2, 3])
def test_rgd_kernel_on_the_lazy_batch(dev, depth):
    """The lazy mode's batch: the 256 selected parents of a real search at
    the production capacities, under their sel_valid mask, bit-equal to the
    plain version."""
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd
    from pushworld_tpu_torch.search import batched
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    p = Puzzle.from_text(_smoke().generated_puzzle_text(0)) if depth == 0 else _fixture("heur/three_tools")
    pl = batched.BatchedPlanner(p, max_depth=depth, lazy=True, device=dev, **PRODUCTION_CAPACITIES)
    s = pl.init_state()
    for _ in range(3):  # up to 3 iterations, the gate still open after them
        nxt = _clone_state(s)
        batched._iterate(pl.cp_dev, pl.tables, pl.config, nxt)
        if not bool(batched._active(pl.config, nxt)):
            break
        s = nxt
    parents, _, sel_valid, _ = batched.select_and_gate(pl.config, s)
    assert parents.shape[0] == 256, parents.shape
    assert int(sel_valid.sum()) > 0
    got = rgd.rgd_heuristic_with_flags(pl.tables, parents, depth, sel_valid)
    want = rgd.rgd_heuristic_with_flags_reference(pl.tables, parents, depth, sel_valid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rgd_and_novelty_kernels_at_32_objects(dev):
    """States of 32 objects (the kernels' cap: one lane an object, 32-bit
    skip sets, a 64 KB push table): RGD at depths 0..2 and novelty over a
    sequence of batches, bit-equal to the plain versions."""
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import novelty, rgd

    p = Puzzle.from_text(_smoke().many_objects_text(32))
    assert p.num_movables == 32
    _, children = _walks(p, 16, seed=32)
    t = rgd.build_rgd_tables(p, compile_puzzle(p), device=dev)
    _rgd_kernel_equals_plain(t, torch.as_tensor(children, device=dev), (0, 1, 2))
    rng = np.random.default_rng(32)
    kern = novelty.init_novelty(32, p.height, p.width, pair_bits=12, device=dev)
    ref = novelty.init_novelty(32, p.height, p.width, pair_bits=12, device=dev)
    for _ in range(3):
        B = 512
        states = torch.as_tensor(np.stack([rng.integers(0, p.width, (B, 32)), rng.integers(0, p.height, (B, 32))],
                                          -1).astype(np.int32), device=dev)
        moved = torch.as_tensor(rng.random((B, 32)) < 0.2, device=dev)
        valid = torch.as_tensor(rng.random(B) < 0.9, device=dev)
        got, _ = novelty.novelty_score_and_update(kern, states, moved, valid)
        want, _ = novelty.novelty_score_and_update_reference(ref, states, moved, valid)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(kern.seen_pos, ref.seen_pos)
        assert torch.equal(kern.pair_table.view(torch.int16), ref.pair_table.view(torch.int16))


@pytest.mark.parametrize("case", ["positions", "pairs"])
def test_novelty_kernel_scores_every_state_against_the_batch_start(dev, case):
    """1,024 copies of one state in a batch, all valid: each copy's update
    would change every other copy's score, and the copies lie in all 128 CTAs
    of each of the two launches: the update launch, ordered after the score
    launch on the stream, must not reach any score.  Every copy must score as
    the plain version does (1 on unseen cells, 2 on seen cells with unseen
    pairs), and the tables must equal its tables."""
    from pushworld_tpu_torch.ops import novelty

    n, H, W = 3, 4, 5
    B = 1024
    s = torch.tensor([[0, 0], [2, 1], [3, 3]], dtype=torch.int32, device=dev)
    states = s.expand(B, n, 2).contiguous()
    moved = torch.tensor([False, True, True], device=dev).expand(B, n).contiguous()
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    kern = novelty.init_novelty(n, H, W, pair_bits=8, device=dev)
    ref = novelty.init_novelty(n, H, W, pair_bits=8, device=dev)
    if case == "pairs":
        for t in (kern, ref):
            t.seen_pos[1, 1 * W + 2] = t.seen_pos[2, 3 * W + 3] = True
    got, _ = novelty.novelty_score_and_update(kern, states, moved, valid)
    want, _ = novelty.novelty_score_and_update_reference(ref, states, moved, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((want == (1.0 if case == "positions" else 2.0)).all())
    assert torch.equal(kern.seen_pos, ref.seen_pos)
    assert torch.equal(kern.pair_table.view(torch.int16), ref.pair_table.view(torch.int16))


# ------------------------------------- the search iteration's other kernels


def _expand_inputs(p, dev, count, seed, n_pad=None, cmax_pad=0):
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.ops import step

    cp = compile_puzzle(p, n_pad=n_pad)
    contacts, mask = step.build_contact_lists(cp, cmax_pad=cmax_pad)
    parents, _ = _walks(p, count, seed)
    padded = np.tile(np.asarray(cp.init_state, np.int32)[None], (count, 1, 1))
    padded[:, : parents.shape[1]] = parents
    sel_valid = np.random.default_rng(seed).random(count) < 0.8
    return (cp.to(dev), torch.as_tensor(contacts, device=dev), torch.as_tensor(mask, device=dev),
            torch.as_tensor(padded, device=dev), torch.as_tensor(sel_valid, device=dev))


def _expand_kernel_equals_plain(cp, contacts, mask, parents, sel_valid, wide=None):
    """``wide``: the kernel's path, as the wrapper picks it where None."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import step

    def expand(gate=None):
        if wide is None:
            return step.expand_and_test(cp, contacts, mask, parents, sel_valid, gate)
        return step._expand_cuda(cp, contacts, mask, parents, sel_valid, gate, wide)

    before = LAUNCHES["step.expand"]
    got = expand()
    want = step.expand_and_test_reference(cp, contacts, mask, parents, sel_valid)
    children = step.expand_children(cp, contacts, mask, parents)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(children, want[0])
    closed = torch.zeros((), dtype=torch.bool, device=parents.device)
    _, _, effective, goal = expand(closed)
    torch.cuda.synchronize()
    assert not effective.any() and not goal.any()
    assert LAUNCHES["step.expand"] == before + 3


@pytest.mark.parametrize("name", RGD_FIXTURES)
def test_expand_kernel_bit_equal_on_fixtures(dev, name):
    """Children, moved masks, effective flags and the goal test of 64
    parents (a fifth of them not selected), bit-equal to the plain version;
    with the gate closed, no lane is effective or a goal."""
    from pushworld_tpu_torch.core.puzzle import Puzzle

    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    _expand_kernel_equals_plain(*_expand_inputs(p, dev, 64, len(name)))


def test_expand_kernel_on_47x54_at_32_objects_and_above(dev):
    """256 parents on the 47 x 54 puzzle; the chain of ten movables; a
    puzzle padded to 32 objects (the one-word path's widest); 33, 64 and 100
    movables (the wide path), on walks and on random cells; three_tools
    padded to 33 objects; and the wide path forced on the narrow puzzles."""
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import step

    smoke = _smoke()
    g = Puzzle.from_text(smoke.generated_puzzle_text(0))
    _expand_kernel_equals_plain(*_expand_inputs(g, dev, 256, 0))
    chain = Puzzle.from_text(smoke.MANY_MOVABLES_TEXT)
    _expand_kernel_equals_plain(*_expand_inputs(chain, dev, 64, 1))
    three = Puzzle.from_file(os.path.join(PUZZLES, "heur", "three_tools.pwp"))
    _expand_kernel_equals_plain(*_expand_inputs(three, dev, 32, 2, n_pad=step.EXPAND_MAX_OBJECTS))
    _expand_kernel_equals_plain(*_expand_inputs(three, dev, 32, 3, n_pad=33))
    rng = np.random.default_rng(4)
    for n in (33, 64, 100):
        p = Puzzle.from_text(smoke.many_objects_text(n))
        assert step.expand_path(n) == "wide"
        cp, contacts, mask, parents, sel_valid = _expand_inputs(p, dev, 64, n)
        _expand_kernel_equals_plain(cp, contacts, mask, parents, sel_valid)
        cells = np.stack([rng.integers(0, p.width, (64, n)), rng.integers(0, p.height, (64, n))], -1)
        _expand_kernel_equals_plain(cp, contacts, mask, torch.as_tensor(cells.astype(np.int32), device=dev),
                                    sel_valid)
    for p in (g, chain, three):
        _expand_kernel_equals_plain(*_expand_inputs(p, dev, 64, 5), wide=True)


def _frontier_state(dev, F, kind, seed, cursor, N=4, bits=16, solved=False, hist_cursor=17):
    """A search state on ``dev`` whose frontier is of ``kind`` ("distinct",
    "tied", "sparse": fewer than 256 live, "empty", "full"), with the live
    fingerprints in its visited set."""
    from pushworld_tpu_torch.ops import hashset as hs
    from pushworld_tpu_torch.search import batched

    rng = np.random.default_rng(seed)
    keys = ((rng.integers(1, 4, F) << 28) | (rng.integers(0, 60, F) << 15) | rng.integers(0, 0x8000, F))
    live = rng.random(F) < 0.75
    if kind == "tied":
        keys[:] = (2 << 28) | (7 << 15) | 5
    elif kind == "sparse":
        live = np.zeros(F, bool)
        live[rng.choice(F, 100, replace=False)] = True
    elif kind in ("empty", "full"):
        live[:] = kind == "full"
    i32 = dict(dtype=torch.int32, device=dev)
    h = torch.as_tensor(np.where(live, keys, batched.EMPTY).astype(np.int32), device=dev)
    fkey = torch.as_tensor(rng.integers(1, 1 << 62, F), device=dev)
    visited = hs.init_hashset(bits, device=dev)
    hs.probe_and_insert_reference(visited, fkey, h < batched.EMPTY)
    Hcap = 1 << 16
    return batched.SearchState(
        frontier_states=torch.as_tensor(rng.integers(0, 50, (F, N, 2)).astype(np.int32), device=dev),
        frontier_h=h, frontier_hist=torch.as_tensor(rng.integers(0, Hcap, F).astype(np.int32), device=dev),
        frontier_key=fkey, ring_cursor=torch.tensor(cursor, **i32),
        hist_parent=torch.full((Hcap,), -1, **i32), hist_action=torch.full((Hcap,), -1, **i32),
        hist_cursor=torch.tensor(hist_cursor, **i32), visited=visited, novelty=None,
        solved=torch.tensor(solved, device=dev), solved_hist=torch.tensor(0, **i32),
        iterations=torch.tensor(5, **i32), expansions=torch.tensor(50, **i32), evictions=torch.tensor(0, **i32),
        needs_deeper=torch.tensor(0, **i32))


def _clone_state(s):
    import dataclasses

    from pushworld_tpu_torch.ops.hashset import HashSet

    out = dataclasses.replace(s, **{k: v.clone() for k, v in vars(s).items() if isinstance(v, torch.Tensor)})
    out.visited = HashSet(keys=s.visited.keys.clone(), capacity_bits=s.visited.capacity_bits)
    return out


def _assert_states_equal(a, b, where):
    for k, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b, k)), (where, k)
    assert torch.equal(a.visited.keys, b.visited.keys), where


@pytest.mark.parametrize("F,kind", [(1 << 15, "distinct"), (1 << 15, "tied"), (1 << 15, "sparse"),
                                    (1 << 15, "empty"), (1 << 16, "distinct"), (1 << 8, "full")])
def test_frontier_select_kernel_bit_equal(dev, F, kind):
    """The gate and the (key, slot)-ordered selection of 256 (16 at F =
    256) entries, bit-equal to the plain version; a closed gate selects and
    frees nothing."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search import batched

    B = 16 if F == 256 else 256
    cfg = batched.SearchConfig(expand=B, history_capacity=1 << 16)
    before = LAUNCHES["frontier.select"]
    for solved in (False, True):
        sk = _frontier_state(dev, F, kind, F + len(kind), F // 2, solved=solved)
        sr = _clone_state(sk)
        got = batched.select_and_gate(cfg, sk)
        active = batched._active(cfg, sr)
        want = (*batched.select_frontier_reference(sr, B, active), active)
        torch.cuda.synchronize()
        assert bool(got[3]) == bool(want[3]) == (not solved and kind != "empty")
        assert torch.equal(got[2], want[2]) and torch.equal(sk.frontier_h, sr.frontier_h), (kind, solved)
        if bool(want[3]):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kind
        sk, sr = _frontier_state(dev, F, kind, 1, F // 2), _frontier_state(dev, F, kind, 1, F // 2)
        got, want = batched._select_frontier(sk, B), batched.select_frontier_reference(sr, B)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), kind
        assert torch.equal(sk.frontier_h, sr.frontier_h)
    assert LAUNCHES["frontier.select"] == before + 4


@pytest.mark.parametrize("case", ["window", "compacts", "evicts", "evicts_at_the_edge", "sharded", "lazy",
                                  "closed"])
def test_frontier_compact_and_append_kernels_bit_equal(dev, case):
    """The compaction and the append on 2^15 slots and 1,024 children (2,048
    from two ranks for "sharded", with its margin), bit-equal to the plain
    versions in every tensor of the state, the visited set's deletes
    included; with the gate closed nothing changes."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search import batched

    F, B, N = 1 << 15, 256, 4
    sharded = case == "sharded"
    nb = 8 * B if sharded else 4 * B
    cursor = {"window": 5000, "evicts_at_the_edge": F - 1}.get(case, F - nb + 1)
    kind = "full" if case.startswith("evicts") or sharded else "distinct"
    sk = _frontier_state(dev, F, kind, len(case), cursor, N=N, solved=case == "closed")
    sr, before_state = _clone_state(sk), _clone_state(sk)
    rng = np.random.default_rng(len(case) + 1)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    is_new = t(rng.random(nb) < 0.6)
    per_parent = case == "lazy"
    args = dict(
        gate=None if sharded else t(case != "closed"), is_new=is_new,
        parent_hist=t(rng.integers(0, 1000, nb if sharded else B).astype(np.int32)),
        actions=t(rng.integers(0, 4, nb).astype(np.int32)) if sharded else None,
        goal=None if sharded else t(rng.random(nb) < 0.01),
        nov=t(rng.integers(1, 4, nb).astype(np.float32)),
        rgd=t(np.where(rng.random(B if per_parent else nb) < 0.1, 1e9,
                       rng.integers(0, 9000, B if per_parent else nb)).astype(np.float32)),
        deeper=None if sharded else t(rng.random(B if per_parent else nb) < 0.2),
        sel_valid=t(rng.random(B) < 0.9), children=t(rng.integers(0, 50, (nb, N, 2)).astype(np.int32)),
        keys=t(rng.integers(1, 1 << 62, nb)))
    if case == "closed":  # what the iteration's kernels give at a closed gate
        args["is_new"] = is_new & False
        args["sel_valid"] = args["sel_valid"] & False
    cfg = batched.SearchConfig(expand=B, history_capacity=1 << 16, use_novelty=case != "lazy")
    margin = 8 * B * 2 if sharded else 8
    before = (LAUNCHES["frontier.compact"], LAUNCHES["frontier.append"])
    batched.compact_frontier(sk, nb, args["gate"])
    batched.compact_frontier_reference(sr, nb, args["gate"])
    got = batched.append_children(sk, cfg, margin=margin, **args)
    want = batched.append_children_reference(sr, cfg, margin=margin, **args)
    torch.cuda.synchronize()
    if case != "closed":
        assert torch.equal(got, want)
    _assert_states_equal(sk, sr, case)
    if case.startswith("evicts") or sharded:
        assert int(sk.evictions) > 0
    if case == "closed":
        _assert_states_equal(sk, before_state, case)
    assert (LAUNCHES["frontier.compact"], LAUNCHES["frontier.append"]) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("case", ["window", "compacts", "evicts", "closed"])
def test_compact_frontier_captures_into_a_cuda_graph(dev, case):
    """compact_frontier (the compaction kernel and the gated visited-set
    deletes) reads nothing back: it captures into a CUDA graph, and a replay
    on the state it was captured from equals the plain version."""
    from pushworld_tpu_torch.search import batched

    F, nb = 1 << 15, 1024
    cursor = 5000 if case == "window" else F - nb + 1
    sk = _frontier_state(dev, F, "full" if case == "evicts" else "distinct", len(case) + 7, cursor)
    before, sr = _clone_state(sk), _clone_state(sk)
    gate = torch.tensor(case != "closed", device=dev)

    def restore():
        for k, v in vars(before).items():
            if isinstance(v, torch.Tensor):
                getattr(sk, k).copy_(v)
        sk.visited.keys.copy_(before.visited.keys)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, as PyTorch's capture wants
        batched.compact_frontier(sk, nb, gate)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        batched.compact_frontier(sk, nb, gate)
    restore()
    graph.replay()
    batched.compact_frontier_reference(sr, nb, gate)
    torch.cuda.synchronize()
    _assert_states_equal(sk, sr, case)
    if case == "evicts":
        assert int(sk.evictions) > 0
    if case in ("window", "closed"):
        _assert_states_equal(sk, before, case)


@pytest.mark.parametrize("name,count,n_pad,cmax_pad", [
    ("heur/three_tools", 256, 32, 8), ("spill_grid", 64, 32, 6), ("multi_goal", 13, None, 5),
    ("heur/two_tools", 37, None, 0), ("heur/three_tools", 3, 7, 0), ("lshape", 1, None, 0)])
def test_expand_kernel_bit_equal_at_long_lists_and_ragged_lanes(dev, name, count, n_pad, cmax_pad):
    """Contact lists of more than 3 entries (at 32 objects past the staging
    budget, read from device memory), and lane counts that leave the last
    CTA part empty or put several action blocks in one CTA."""
    from pushworld_tpu_torch.core.puzzle import Puzzle

    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    _expand_kernel_equals_plain(*_expand_inputs(p, dev, count, len(name), n_pad=n_pad, cmax_pad=cmax_pad))


@pytest.mark.parametrize("open_gate", [True, False])
def test_expand_captures_into_a_cuda_graph(dev, open_gate):
    """expand_and_test reads nothing back: it captures into a CUDA graph; a
    replay equals the plain version with the gate open, and with it closed
    writes effective = goal = False and leaves children and moved as they
    were."""
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import step

    g = Puzzle.from_text(_smoke().generated_puzzle_text(0))
    cp, contacts, mask, parents, sel_valid = _expand_inputs(g, dev, 256, 5)
    gate = torch.tensor(open_gate, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, as PyTorch's capture wants
        step.expand_and_test(cp, contacts, mask, parents, sel_valid, gate)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step.expand_and_test(cp, contacts, mask, parents, sel_valid, gate)
    for x in out:
        x.fill_(True if x.dtype == torch.bool else -7)
    graph.replay()
    want = step.expand_and_test_reference(cp, contacts, mask, parents, sel_valid)
    torch.cuda.synchronize()
    if open_gate:
        for got, w in zip(out, want):
            assert torch.equal(got, w)
    else:
        assert (out[0] == -7).all() and out[1].all() and not out[2].any() and not out[3].any()


# name: (lanes, the search's B, what), as tests/test_torch_frontier.py's
# APPEND_SHAPES: the sharded call of four ranks, ragged tiles, per-parent
# rgd, a goal in a later tile, a solved search, history indices crossing
# capacity - margin, several rounds a thread, the fewest lanes.
APPEND_SHAPES = {
    "sharded_four_ranks": (4096, 256, "sharded"), "ragged_tiles": (1000, 250, "eager"),
    "lazy_per_parent": (1036, 259, "lazy"), "goal_in_a_later_tile": (1024, 256, "late_goal"),
    "already_solved": (1024, 256, "solved"), "history_crosses_its_limit": (1024, 256, "hcap"),
    "rounds": (20000, 5000, "eager"), "four_lanes": (4, 1, "eager"),
}


def _append_case(dev, case, gate):
    """(kernel state, plain state, the state before, config, append
    arguments, margin) of an APPEND_SHAPES case on 2^15 slots."""
    from pushworld_tpu_torch.search import batched

    nb, B, what = APPEND_SHAPES[case]
    F, N, Hcap = 1 << 15, 4, 1 << 16
    sharded = what == "sharded"
    margin = 8 * B * 4 if sharded else 8
    rng = np.random.default_rng(len(case))
    is_new = rng.random(nb) < 0.6
    goal = rng.random(nb) < 0.01
    if what == "late_goal":  # the only goal in the second tile, new children in the first
        per = -(-nb // 8)
        goal[:] = False
        is_new[:3] = True
        goal[per + 7] = is_new[per + 7] = True
    if what == "hcap":  # 10 new children, the last 5 past capacity - margin
        is_new[:] = False
        is_new[np.linspace(0, nb - 1, 10).astype(int)] = True
    sk = _frontier_state(dev, F, "distinct", len(case), 40, N=N, solved=what == "solved",
                         hist_cursor=Hcap - margin - 5 if what == "hcap" else 17)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    per_parent = what == "lazy"
    args = dict(
        gate=gate, is_new=t(is_new),
        parent_hist=t(rng.integers(0, 1000, nb if sharded else B).astype(np.int32)),
        actions=t(rng.integers(0, 4, nb).astype(np.int32)) if sharded else None,
        goal=None if sharded else t(goal), nov=t(rng.integers(1, 4, nb).astype(np.float32)),
        rgd=t(np.where(rng.random(B if per_parent else nb) < 0.1, 1e9,
                       rng.integers(0, 9000, B if per_parent else nb)).astype(np.float32)),
        deeper=None if sharded else t(rng.random(B if per_parent else nb) < 0.2),
        sel_valid=t(rng.random(B) < 0.9), children=t(rng.integers(0, 50, (nb, N, 2)).astype(np.int32)),
        keys=t(rng.integers(1, 1 << 62, nb)))
    cfg = batched.SearchConfig(expand=B, history_capacity=Hcap, use_novelty=what != "lazy")
    return sk, _clone_state(sk), _clone_state(sk), cfg, args, margin


@pytest.mark.parametrize("case", sorted(APPEND_SHAPES))
def test_append_kernel_bit_equal_across_shapes(dev, case):
    """The append's cluster of 8 CTAs bit-equal to
    the plain version in every tensor of the state and in hist_idx, at lane
    counts from 4 to 20,000."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search import batched

    sk, sr, _, cfg, args, margin = _append_case(dev, case, None)
    before = LAUNCHES["frontier.append"]
    got = batched.append_children(sk, cfg, margin=margin, **args)
    want = batched.append_children_reference(sr, cfg, margin=margin, **args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), case
    _assert_states_equal(sk, sr, case)
    if case == "goal_in_a_later_tile":
        assert bool(sk.solved) and int(sk.solved_hist) == int(want[APPEND_SHAPES[case][0] // 8 + 7])
    assert LAUNCHES["frontier.append"] == before + 1


@pytest.mark.parametrize("case", ["sharded_four_ranks", "goal_in_a_later_tile", "closed"])
def test_append_captures_into_a_cuda_graph(dev, case):
    """append_children reads nothing back: it captures into a CUDA graph,
    and a replay on the state it was captured from equals the plain
    version; with the gate closed the replay leaves the whole state as it
    was."""
    from pushworld_tpu_torch.search import batched

    gate = torch.tensor(case != "closed", device=dev)
    sk, sr, before, cfg, args, margin = _append_case(dev, "goal_in_a_later_tile" if case == "closed" else case, gate)

    def restore():
        for k, v in vars(before).items():
            if isinstance(v, torch.Tensor):
                getattr(sk, k).copy_(v)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, as PyTorch's capture wants
        batched.append_children(sk, cfg, margin=margin, **args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = batched.append_children(sk, cfg, margin=margin, **args)
    restore()
    graph.replay()
    if case == "closed":
        torch.cuda.synchronize()
        _assert_states_equal(sk, before, case)
        return
    want = batched.append_children_reference(sr, cfg, margin=margin, **args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _assert_states_equal(sk, sr, case)


# The select and the compaction run as one cluster of 8 CTAs, each owning a
# tile of ceil(F / 8) slots: F = 2^10 and 24,581 (not a multiple of 8) give
# ragged tiles, 2^16 the largest tiles held in shared memory, 2^18 tiles in
# device scratch.
CLUSTER_SIZES = [1 << 10, 1 << 15, 1 << 16, 24581, 1 << 18]
KINDS = ["distinct", "tied", "sparse", "empty", "full"]


def _bits_for(F):
    return max(16, F.bit_length() + 1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("F", CLUSTER_SIZES)
def test_frontier_select_kernel_bit_equal_across_sizes(dev, F, kind):
    """The select of 256 entries at every tile layout, gated (open, and
    closed by a solve) and ungated (the sharded search's form), bit-equal to
    the plain version in every output and in the keys it frees."""
    from pushworld_tpu_torch.search import batched

    B = 256
    cfg = batched.SearchConfig(expand=B, history_capacity=1 << 16)
    for solved in (False, True):
        sk = _frontier_state(dev, F, kind, F % 1000 + len(kind), F // 2, bits=_bits_for(F), solved=solved)
        sr = _clone_state(sk)
        got = batched.select_and_gate(cfg, sk)
        active = batched._active(cfg, sr)
        want = (*batched.select_frontier_reference(sr, B, active), active)
        torch.cuda.synchronize()
        assert bool(got[3]) == bool(want[3]) == (not solved and kind != "empty"), (F, kind, solved)
        assert torch.equal(got[2], want[2]) and torch.equal(sk.frontier_h, sr.frontier_h), (F, kind, solved)
        if bool(want[3]):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (F, kind)
    sk = _frontier_state(dev, F, kind, 3, F // 2, bits=_bits_for(F))
    sr = _clone_state(sk)
    got, want = batched._select_frontier(sk, B), batched.select_frontier_reference(sr, B)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), (F, kind)
    assert torch.equal(sk.frontier_h, sr.frontier_h), (F, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("F", CLUSTER_SIZES)
def test_frontier_compact_kernel_bit_equal_across_sizes(dev, F, kind):
    """A forced compaction before 1,024 children at every tile layout, with
    the gate open, closed and absent (the sharded search's form), bit-equal
    to the plain version in every tensor of the state, the visited set's
    deletes included."""
    from pushworld_tpu_torch.search import batched

    nb = 1024
    for gate in (True, False, None):
        sk = _frontier_state(dev, F, kind, F % 1000 + len(kind) + 1, F - nb + 1, bits=_bits_for(F))
        sr, before = _clone_state(sk), _clone_state(sk)
        g = None if gate is None else torch.tensor(gate, device=dev)
        batched.compact_frontier(sk, nb, g)
        batched.compact_frontier_reference(sr, nb, g)
        torch.cuda.synchronize()
        _assert_states_equal(sk, sr, (F, kind, gate))
        if gate is False:
            _assert_states_equal(sk, before, (F, kind, gate))
        else:
            assert int(sk.ring_cursor) <= F - nb, (F, kind, gate)
        if kind == "full" and gate is not False:
            assert int(sk.evictions) > 0, (F, kind, gate)


@pytest.mark.parametrize("F,bits", [(1 << 15, 16), (1 << 15, 21), (2048, 12), (24581, 16)])
def test_evicting_compaction_deletes_bit_equal(dev, F, bits):
    """An evicting compaction's own deletes: the visited table after the
    kernel equals the table after the plain compaction bit for bit, on a
    table that also holds other keys and tombstones, where some dropped
    fingerprints are absent from the visited set (deleted earlier) and one
    key stands in the frontier twice."""
    from pushworld_tpu_torch.ops import hashset as hs
    from pushworld_tpu_torch.search import batched

    nb = 1024
    sk = _frontier_state(dev, F, "full", F + bits, F - nb + 1, bits=bits)
    rng = np.random.default_rng(F + bits)
    table = sk.visited
    others = torch.as_tensor(rng.integers(1, 1 << 62, (1 << bits) // 4), device=dev)
    hs.probe_and_insert_reference(table, others, torch.ones_like(others, dtype=torch.bool))
    hs.probe_delete_reference(table, others, torch.as_tensor(rng.random(len(others)) < 0.2, device=dev))
    order = torch.argsort(sk.frontier_h, stable=True)
    keep = F - max(nb, F // 4)
    dropped = order[keep:]
    sk.frontier_key[dropped[1]] = sk.frontier_key[dropped[0]]  # stored once, dropped twice
    absent = dropped[2::5]
    hs.probe_delete_reference(table, sk.frontier_key[absent], torch.ones_like(absent, dtype=torch.bool))
    sr, before = _clone_state(sk), _clone_state(sk)
    batched.compact_frontier(sk, nb, torch.tensor(True, device=dev))
    batched.compact_frontier_reference(sr, nb, torch.tensor(True, device=dev))
    torch.cuda.synchronize()
    _assert_states_equal(sk, sr, (F, bits))
    deleted = int(((before.visited.keys != -1) & (sk.visited.keys == -1)).sum())
    assert int(sk.evictions) == len(dropped) and 0 < deleted < len(dropped), (F, bits, deleted)


@pytest.mark.parametrize("case", ["open", "solved", "exhausted", "ungated"])
def test_select_captures_into_a_cuda_graph(dev, case):
    """The select (a cluster launch) reads nothing back: it captures into a
    CUDA graph, and a replay on the state it was captured from equals the
    plain version, gate included."""
    from pushworld_tpu_torch.search import batched

    F, B = 1 << 15, 256
    cfg = batched.SearchConfig(expand=B, history_capacity=1 << 16)
    sk = _frontier_state(dev, F, "empty" if case == "exhausted" else "tied" if case == "ungated" else "distinct",
                         len(case) + 11, F // 2, solved=case == "solved")
    before, sr = _clone_state(sk), _clone_state(sk)

    def select():
        if case == "ungated":
            return (*batched._select_frontier(sk, B), None)
        return batched.select_and_gate(cfg, sk)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, as PyTorch's capture wants
        select()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = select()
    sk.frontier_h.copy_(before.frontier_h)
    graph.replay()
    if case == "ungated":
        want = (*batched.select_frontier_reference(sr, B), None)
    else:
        active = batched._active(cfg, sr)
        want = (*batched.select_frontier_reference(sr, B, active), active)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2]) and torch.equal(sk.frontier_h, sr.frontier_h), case
    if case != "ungated":
        assert bool(got[3]) == bool(want[3]) == (case == "open"), case
    if case in ("open", "ungated"):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case
    else:
        assert torch.equal(sk.frontier_h, before.frontier_h), case


def test_rgd_kernel_valid_mask(dev):
    """With a valid mask, valid states keep the kernel's values and the
    others get the fill, as the plain version."""
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd

    p = Puzzle.from_file(os.path.join(PUZZLES, "heur", "three_tools.pwp"))
    _, children = _walks(p, 64, seed=3)
    states = torch.as_tensor(children, device=dev)
    valid = torch.as_tensor(np.random.default_rng(3).random(len(children)) < 0.5, device=dev)
    t = rgd.build_rgd_tables(p, compile_puzzle(p), device=dev)
    for depth in (0, 3):
        got = rgd.rgd_heuristic_with_flags(t, states, depth, valid)
        want = rgd.rgd_heuristic_with_flags_reference(t, states, depth, valid)
        full = rgd.rgd_heuristic_with_flags(t, states, depth)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), depth
        assert torch.equal(got[0][valid], full[0][valid]) and (got[0][~valid] == rgd.INF).all()


def _novelty_kernels_equal_plain(n, H, W, dev, rng, wide=None, batches=3, B=512):
    """The novelty kernels (``wide``: the path, as the wrapper picks it where
    None) against the plain version over a sequence of batches of random
    states: scores and both tables bit-equal after every batch."""
    from pushworld_tpu_torch.ops import novelty

    kern = novelty.init_novelty(n, H, W, pair_bits=12, device=dev)
    ref = novelty.init_novelty(n, H, W, pair_bits=12, device=dev)
    for _ in range(batches):
        states = torch.as_tensor(np.stack([rng.integers(0, W, (B, n)), rng.integers(0, H, (B, n))],
                                          -1).astype(np.int32), device=dev)
        moved = torch.as_tensor(rng.random((B, n)) < 0.2, device=dev)
        valid = torch.as_tensor(rng.random(B) < 0.9, device=dev)
        if wide is None:
            got, _ = novelty.novelty_score_and_update(kern, states, moved, valid)
        else:
            args = novelty._checked(kern, states, moved, valid)
            got = torch.empty((B,), dtype=torch.float32, device=dev)
            record = torch.empty((B, n, 2), dtype=torch.int32, device=dev)
            for launch in novelty._launches(kern, *args, got, record, wide).values():
                launch()
        want, _ = novelty.novelty_score_and_update_reference(ref, states, moved, valid)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(kern.seen_pos, ref.seen_pos)
        assert torch.equal(kern.pair_table.view(torch.int16), ref.pair_table.view(torch.int16))
    return want


@pytest.mark.parametrize("n", [33, 64, 100])
def test_rgd_and_novelty_kernels_above_32_objects(dev, n):
    """The wide paths at 33, 64 and 100 movables, bit-equal to the plain
    versions: RGD on walks and random cells at depths 0-2 (and 3 at 33),
    and on the four-tool chain widened by obstacles (its goal needs depth
    4, so depths 1-3 run the deep tables over every movable: in shared
    memory at 33, in the device scratch at 64), and at 64 and 100 on 1,024
    of its walk states at depth 1, more than the scratch path's persistent
    grid has CTAs, so that each CTA walks several states; novelty over a
    sequence of batches.  The one-word paths' width stays 32."""
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.kernels import _build
    from pushworld_tpu_torch.ops import novelty, rgd

    assert _build.load("rgd").pw_rgd_max_objects() == rgd.RGD_MAX_OBJECTS == 32
    assert _build.load("novelty").pw_novelty_max_objects() == novelty.NOVELTY_MAX_OBJECTS == 32
    smoke = _smoke()
    rng = np.random.default_rng(n)
    p = Puzzle.from_text(smoke.many_objects_text(n))
    _, children = _walks(p, 16, seed=n)
    cells = np.stack([rng.integers(0, p.width, (16, n)), rng.integers(0, p.height, (16, n))], -1)
    t = rgd.build_rgd_tables(p, compile_puzzle(p), device=dev)
    states = torch.as_tensor(np.concatenate([children, cells]).astype(np.int32), device=dev)
    _rgd_kernel_equals_plain(t, states, (0, 1, 2, 3) if n == 33 else (0, 1, 2))
    tools = Puzzle.from_text(smoke.four_tools_with_obstacles_text(n))
    t = rgd.build_rgd_tables(tools, compile_puzzle(tools), device=dev)
    if n <= 64:
        parents, children = _walks(tools, 8, seed=n)
        states = torch.as_tensor(np.concatenate([parents, children]), device=dev)
        want = rgd.rgd_heuristic_with_flags_reference(t, states, 3)
        assert (want[0] >= 1e8).any() and want[1].any()  # goals that need depth 4
        assert rgd.rgd_path(t, len(states), 3, dev) == ("wide, shared memory" if n == 33 else "wide, scratch")
        _rgd_kernel_equals_plain(t, states, (1, 2, 3))
    if n >= 64:
        states = torch.as_tensor(smoke.walk_states(tools, 1024, seed=n), device=dev)
        assert len(states) > 2 * torch.cuda.get_device_properties(dev).multi_processor_count
        assert rgd.rgd_path(t, len(states), 1, dev) == "wide, scratch"
        want = rgd.rgd_heuristic_with_flags_reference(t, states, 0)
        assert (want[0] >= 1e8).sum() > len(states) // 2  # most states run the deep tables
        _rgd_kernel_equals_plain(t, states, (1,))
        valid = torch.as_tensor(rng.random(len(states)) < 0.9, device=dev)
        got = rgd.rgd_heuristic_with_flags(t, states, 1, valid)
        want = rgd.rgd_heuristic_with_flags_reference(t, states, 1, valid)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _novelty_kernels_equal_plain(n, p.height, p.width, dev, rng)


def test_wide_rgd_and_novelty_paths_on_narrow_states(dev):
    """The wide paths take any n: forced on states of at most 32 objects,
    they equal the plain versions too, RGD at depths 0-5 (the four-tool
    chain: the wide walk over T(., 2) tables, which no wide state in reach
    of the plain version's time needs) and on fixtures, novelty at 3 and 32
    objects."""
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops import rgd

    smoke = _smoke()
    cases = [(Puzzle.from_text(smoke.FOUR_TOOLS_TEXT), (3, 4, 5)),
             (Puzzle.from_file(os.path.join(PUZZLES, "heur", "three_tools.pwp")), (0, 1, 2, 3, 4)),
             (Puzzle.from_text(smoke.generated_puzzle_text(0)), (0, 2)),
             (Puzzle.from_text(smoke.many_objects_text(32)), (0, 1, 2))]
    for p, depths in cases:
        parents, children = _walks(p, 16, seed=p.num_movables)
        t = rgd.build_rgd_tables(p, compile_puzzle(p), device=dev)
        states = torch.as_tensor(np.concatenate([parents, children]), device=dev)
        valid = torch.as_tensor(np.random.default_rng(0).random(len(states)) < 0.8, device=dev)
        for depth in depths:
            for v in (None, valid):
                got = rgd._rgd_cuda(t, states, depth, v, wide=True)
                want = rgd.rgd_heuristic_with_flags_reference(t, states, depth, v)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), depth
    rng = np.random.default_rng(7)
    for n, H, W in ((3, 5, 6), (32, 14, 14)):
        _novelty_kernels_equal_plain(n, H, W, dev, rng, wide=True)


@pytest.mark.parametrize("n", [64, 100])
def test_solve_64_movables_on_card_matches_cpu(dev, n):
    """A 64- and a 100-movable puzzle (the wide paths of expand, novelty and
    RGD) solved on the card and on the CPU at the production capacities: the
    plan passes the oracle, and plan, iterations and expansions are the
    CPU port's; solve_puzzle gives the same plan."""
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.search.batched import BatchedPlanner, required_depth
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES, solve_puzzle

    p = Puzzle.from_text(_smoke().many_objects_text(n))
    runs = []
    for d in (dev, "cpu"):
        pl = BatchedPlanner(p, max_depth=required_depth(p), device=d, **PRODUCTION_CAPACITIES)
        plan = pl.solve(time_limit=300)
        runs.append((plan, int(pl.last_state.iterations), int(pl.last_state.expansions)))
    assert runs[0] == runs[1] and p.is_valid_plan(runs[0][0])
    r = solve_puzzle(p, mode="N+RGD", time_limit=120, device=dev, **PRODUCTION_CAPACITIES)
    assert r.failure_reason is None and r.plan == runs[0][0]


def test_solve_on_card_matches_cpu(dev):
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.search.planner import solve_puzzle

    small = dict(expand=32, frontier_capacity=1 << 10, visited_bits=14,
                 history_capacity=1 << 14, pair_bits=12)
    for name in ("multi_goal", "heur/two_tools", "heur/shortest_path_tool"):
        p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
        g = solve_puzzle(p, time_limit=60, device=dev, **small)
        c = solve_puzzle(p, time_limit=60, device="cpu", **small)
        assert g.failure_reason is None and p.is_valid_plan(g.plan)
        assert (g.plan, g.expansions) == (c.plan, c.expansions)


def _fixtures(names):
    from pushworld_tpu_torch.core.puzzle import Puzzle

    return [(n, Puzzle.from_file(os.path.join(PUZZLES, n + ".pwp"))) for n in names]


@pytest.mark.parametrize("mode", ["claim", "shadow"])
def test_fleet_device_worker_on_the_card(dev, mode, monkeypatch):
    """The fleet with its device worker on the card: no loss, no duplicate,
    valid plans, no device failure, and lanes that went through the kernels."""
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search import fleet

    monkeypatch.setattr(fleet, "DEVICE_STEAL_GRACE_S", 1.0)
    named = _fixtures(["chain", "spill_grid", "multi_goal", "heur/shortest_path_tool",
                       "heur/easy_search", "simple", "no_solution"])
    before = LAUNCHES["visited_set.fingerprint_dedup_insert"]
    results = fleet.plan_puzzles_fleet(
        named, time_limit=60.0, native_workers=0 if mode == "claim" else 1, group_size=4,
        device_claim_delay=0.0, device_mode=mode, device=dev)
    assert sorted(results) == sorted(n for n, _ in named)
    for name, p in named:
        r = results[name]
        if name == "no_solution":
            assert r.failure_reason == "no solution"
        else:
            assert r.failure_reason is None and p.is_valid_plan(r.plan), (name, r)
    stats = fleet._device_stats
    assert stats["mode"] == mode and stats["device_failed"] is False
    if mode == "claim":
        assert "device" in {r.solver for r in results.values()}
        assert stats["lanes"] > 0 and stats["solved"] > 0
        assert LAUNCHES["visited_set.fingerprint_dedup_insert"] > before


@pytest.mark.parametrize("mode", ["claim", "shadow"])
def test_fleet_raises_when_a_kernel_fails_on_the_card(dev, mode, monkeypatch):
    """A kernel wrapper that raises on the card: the hosts finish every
    instance, and the call raises instead of returning a host-only run."""
    from pushworld_tpu_torch.ops import rgd
    from pushworld_tpu_torch.search import fleet

    def broken(*a, **k):
        raise RuntimeError("wavefront kernel failed to launch (injected by the test)")

    monkeypatch.setattr(rgd, "distance_fields", broken)
    monkeypatch.setattr(fleet, "DEVICE_STEAL_GRACE_S", 0.2)
    named = _fixtures(["chain", "spill_grid", "multi_goal", "simple"])
    with pytest.raises(fleet.DeviceWorkerError, match="failed to launch") as info:
        fleet.plan_puzzles_fleet(named, time_limit=60.0, native_workers=0, group_size=2,
                                 device_claim_delay=0.0, device_mode=mode, device=dev)
    assert fleet._device_stats["device_failed"] is True
    results = info.value.results
    assert sorted(results) == sorted(n for n, _ in named)
    assert all(r.failure_reason is None and r.solver != "device" for r in results.values())


def test_portfolio_device_member_on_the_card(dev, monkeypatch):
    """No head start and a native member held back: the device member's plan,
    found on the card, equals the one found on the CPU."""
    import threading

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.native import bridge
    from pushworld_tpu_torch.search import batched, planner

    release = threading.Event()

    def slow_native(*args, **kwargs):
        release.wait(120)
        raise TimeoutError("native member held back by the test")

    monkeypatch.setenv("PW_PORTFOLIO_HEADSTART", "0")
    monkeypatch.setattr(bridge, "solve_native_staged", slow_native)
    small = dict(expand=32, frontier_capacity=1 << 10, visited_bits=14,
                 history_capacity=1 << 14, pair_bits=12)
    try:
        for name, p in _fixtures(["spill_grid", "heur/trivial_tool2"]):
            depth = batched.required_depth(p)
            plans = []
            for d in (dev, "cpu"):
                before = LAUNCHES["visited_set.fingerprint_dedup_insert"]
                solver = []
                plans.append(planner._portfolio_solve(
                    lambda: batched.BatchedPlanner(p, max_depth=depth, device=d, **small),
                    p, compile_puzzle(p), "N+RGD", 120.0, solver))
                assert solver == ["device"]
                rose = LAUNCHES["visited_set.fingerprint_dedup_insert"] > before
                assert rose == (d is dev)
            assert plans[0] == plans[1] and p.is_valid_plan(plans[0]), name
    finally:
        release.set()


# ------------------------------------------- the environment half on the card


def _fixture(name):
    from pushworld_tpu_torch.core.puzzle import Puzzle

    return Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))


def _assert_env_outputs_equal(out_card, out_cpu):
    st_g, *rest_g = out_card
    st_c, *rest_c = out_cpu
    for f in ("positions", "steps", "achieved", "puzzle_idx"):
        assert torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)), f
    for g, c in zip(rest_g, rest_c):
        assert g.dtype == c.dtype and torch.equal(g.cpu(), c)


@pytest.mark.parametrize("names", [("lshape",), ("simple", "chain", "push_left")])
def test_env_step_card_equals_cpu(dev, names):
    """The same actions on the card and on the CPU, a single puzzle and a
    stacked batch: every output of every step is equal."""
    from pushworld_tpu_torch.core.compiled import compile_batch, compile_puzzle
    from pushworld_tpu_torch.envs.vector_env import VectorEnv

    puzzles = [_fixture(n) for n in names]
    cp = compile_puzzle(puzzles[0]) if len(puzzles) == 1 else compile_batch(puzzles)
    rng = np.random.default_rng(len(names))
    B = 512
    idx = torch.as_tensor(rng.integers(0, len(puzzles), B).astype(np.int32))
    env_g, env_c = VectorEnv(cp, max_steps=9, device=dev), VectorEnv(cp, max_steps=9, device="cpu")
    st_g, st_c = env_g.reset(None, B, idx), env_c.reset(None, B, idx)
    for a in rng.integers(0, 4, (40, B)):
        out_g = env_g.step(st_g, torch.as_tensor(a, device=dev))
        out_c = env_c.step(st_c, torch.as_tensor(a))
        torch.cuda.synchronize()
        _assert_env_outputs_equal(out_g, out_c)
        st_g, st_c = out_g[0], out_c[0]


@pytest.mark.parametrize("name", ["lshape", "multi_goal", "agent_wall"])
def test_renderers_card_equal_cpu(dev, name):
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.ops import render

    p = _fixture(name)
    cp = compile_puzzle(p)
    rng = np.random.default_rng(len(name))
    states = [p.initial_state]
    for _ in range(6):
        s = p.initial_state
        for a in rng.integers(0, 4, 20).tolist():
            s = p.get_next_state(s, a)
            states.append(s)
    states = torch.as_tensor(np.asarray(states, np.int32))
    t_g = render.compile_render_tables(p, cp, device=dev)
    t_c = render.compile_render_tables(p, cp, device="cpu")
    for fn in (render.render_cells_class, render.render_cells_rgb, render.render_cells_onehot,
               render.render_cells_onehot_batched):
        got = fn(t_g, states.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), fn(t_c, states)), fn.__name__
    assert torch.equal(render.render_cells_onehot_batched(t_g, states.to(dev)),
                       render.render_cells_onehot(t_g, states.to(dev)))


@pytest.mark.parametrize("name", ["heur/shortest_path_tool", "heur/transitive_pushing", "lshape"])
def test_build_reachability_card_equals_cpu(dev, name):
    """The convolution on the card (cuDNN, TF32 allowed) gives the CPU's
    fixpoint in the same number of iterations, and all-pairs distances go
    through the wavefront kernel."""
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.ops import graphs

    cp = compile_puzzle(_fixture(name))
    s_g, s_c = {}, {}
    E_g, r_g = graphs.build_reachability(cp, device=dev, stats_out=s_g)
    E_c, r_c = graphs.build_reachability(cp, device="cpu", stats_out=s_c)
    torch.cuda.synchronize()
    assert torch.equal(E_g.cpu(), E_c) and torch.equal(r_g.cpu(), r_c) and s_g == s_c
    before = LAUNCHES["wavefront"]
    D_g = graphs.all_pairs_distances(E_g[:, 0])
    torch.cuda.synchronize()
    assert LAUNCHES["wavefront"] == before + 1
    assert torch.equal(D_g.cpu(), graphs.all_pairs_distances(E_c[:, 0]))


# ------------------------------------------------------ the parallel layer on the card


@pytest.mark.parametrize("name", ["simple", "chain", "push_left", "multi_goal", "heur/easy_search",
                                  "spill_grid"])
def test_frontier_sharded_nccl_equals_gloo(dev, name):
    """The frontier-sharded search over a one-rank NCCL group on the card
    takes the steps of a one-rank gloo run on the CPU, through the kernels."""
    import torch.distributed as dist

    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.parallel.frontier_sharded import solve_frontier_sharded
    from pushworld_tpu_torch.parallel.mesh import make_mesh

    p = _fixture(name)
    kw = dict(time_limit=120.0, expand=16, frontier_capacity=1 << 10, visited_bits=14,
              history_capacity=1 << 14, chunk=8)
    card, cpu = make_mesh(device=dev, axis_name="shard"), make_mesh(device="cpu", axis_name="shard")
    assert dist.get_backend(card.get_group()) == "nccl" and dist.get_backend(cpu.get_group()) == "gloo"
    before = LAUNCHES["visited_set.fingerprint_dedup_insert"]
    s_card, s_cpu = {}, {}
    plan = solve_frontier_sharded(p, mesh=card, stats_out=s_card, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["visited_set.fingerprint_dedup_insert"] > before
    assert plan == solve_frontier_sharded(p, mesh=cpu, stats_out=s_cpu, **kw)
    assert p.is_valid_plan(plan)
    for k in ("chunks", "spill_epochs", "shard_iterations", "shard_expansions"):
        assert s_card[k] == s_cpu[k], k


# -------------------------------------------- the search chunk as CUDA graphs


def _planner_on(name, d, depth=None, lazy=False, **caps):
    from pushworld_tpu_torch.search import batched

    p = _fixture(name)
    kw = dict(expand=16, frontier_capacity=1 << 7, visited_bits=12, history_capacity=1 << 12, pair_bits=12)
    kw.update(caps)
    depth = batched.required_depth(p) if depth is None else depth
    return batched.BatchedPlanner(p, max_depth=depth, lazy=lazy, device=d, **kw)


def _assert_same_search(a, b, where):
    """Two search states took the same steps: every tensor equal (frontier
    contents on live slots), the visited set as a SET of keys (a same-round
    slot race may lay a probe cluster out in another order)."""
    live = (a.frontier_h < 0x7F000000).cpu()
    assert torch.equal(a.frontier_h.cpu(), b.frontier_h.cpu()), where
    for f in ("frontier_states", "frontier_hist", "frontier_key"):
        assert torch.equal(getattr(a, f).cpu()[live], getattr(b, f).cpu()[live]), (where, f)
    for f in ("ring_cursor", "hist_parent", "hist_action", "hist_cursor", "solved", "solved_hist",
              "iterations", "expansions", "evictions", "needs_deeper"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), (where, f)
    assert torch.equal(a.novelty.seen_pos.cpu(), b.novelty.seen_pos.cpu()), where
    assert torch.equal(a.novelty.pair_table.cpu(), b.novelty.pair_table.cpu()), where

    def keys(s):
        k = s.visited.keys.cpu()
        return set(k[(k != 0) & (k != -1)].tolist())

    assert keys(a) == keys(b), where


@pytest.mark.parametrize("name,depth,lazy", [("spill_grid", 0, False), ("heur/trivial_tool", 1, True)])
def test_graphed_run_chunk_equals_eager_and_cpu(dev, name, depth, lazy):
    """spill_grid's 128-slot ring compacts, evicts and solves inside the
    chunks; the graphed chunks, the eager loop on the card and run_chunk on
    the CPU leave the same search.  (A 2^16-slot visited set: in a crowded
    table a same-round slot race can end in probe exhaustion on one side
    only, ROADMAP queue 3.)"""
    from pushworld_tpu_torch.search import batched, chunk_graph

    pl_g, pl_e, pl_c = (_planner_on(name, d, depth, lazy, visited_bits=16) for d in (dev, dev, "cpu"))
    s_g, s_e, s_c = pl_g.init_state(), pl_e.init_state(), pl_c.init_state()
    G = chunk_graph.graph_iters(depth)
    per_chunk = -(-5 // G) * G  # a chunk of 5 is ceil(5 / G) replays of G iterations
    for k in range(6):
        batched.run_chunk(pl_g.cp_dev, pl_g.tables, pl_g.config, s_g, 5)
        for _ in range(per_chunk):
            batched._iterate(pl_e.cp_dev, pl_e.tables, pl_e.config, s_e)
        batched.run_chunk(pl_c.cp_dev, pl_c.tables, pl_c.config, s_c, per_chunk)
        torch.cuda.synchronize()
        _assert_same_search(s_g, s_e, f"chunk {k}: graphed vs eager")
        _assert_same_search(s_g, s_c, f"chunk {k}: card vs CPU")
    assert s_g.graph is not None and s_g.graph.iters == G and s_g.graph.nodes > 0
    assert bool(s_g.solved) and pl_g.puzzle.is_valid_plan(batched.reconstruct_plan(s_g))
    if name == "spill_grid":
        assert int(s_g.evictions) > 0


# An iteration's eight hand-kernel launches (the compaction deletes its drops
# from the visited set itself: no probe_delete launch).
ITERATION_KERNELS = ("frontier.select", "step.expand", "visited_set.fingerprint_dedup_insert", "novelty.score",
                     "novelty.absorb", "rgd.heuristic", "frontier.compact", "frontier.append")


def test_graph_replays_add_the_captured_launches(dev):
    from pushworld_tpu_torch.kernels import LAUNCHES
    from pushworld_tpu_torch.search import batched, chunk_graph

    pl = _planner_on("spill_grid", dev, 0, history_capacity=1 << 14)
    s = pl.init_state()
    g = chunk_graph.attach(pl.cp_dev, pl.tables, pl.config, s)
    fused = "visited_set.fingerprint_dedup_insert"
    assert g.launches[fused] == g.iters and "visited_set.probe_delete" not in g.launches
    assert g.launches == {k: g.iters for k in ITERATION_KERNELS}  # one launch each an iteration, nothing else
    before = dict(LAUNCHES)
    batched.run_chunk(pl.cp_dev, pl.tables, pl.config, s, 3 * g.iters)
    torch.cuda.synchronize()
    for k, n in g.launches.items():
        assert LAUNCHES[k] - before.get(k, 0) == 3 * n, k
    assert s.graph is g  # the same state, tables and configuration: no new capture


def test_a_failed_capture_raises(dev):
    """A host read inside the captured iteration invalidates the capture:
    run_chunk raises and falls back to nothing.  In a process of its own, as
    PyTorch's own tests run capture errors."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """if True:
        import torch
        from pushworld_tpu_torch.core.puzzle import Puzzle
        from pushworld_tpu_torch.search import batched, chunk_graph
        p = Puzzle.from_file("tests/puzzles/spill_grid.pwp")
        pl = batched.BatchedPlanner(p, max_depth=0, expand=16, frontier_capacity=1 << 7, visited_bits=12,
                                    history_capacity=1 << 12, pair_bits=12, device="cuda")
        s = pl.init_state()
        real = chunk_graph._iterate
        def reading(cp, t, cfg, s):
            int(s.hist_cursor)  # a host read
            return real(cp, t, cfg, s)
        chunk_graph._iterate = reading
        try:
            batched.run_chunk(pl.cp_dev, pl.tables, pl.config, s, 4)
        except RuntimeError as e:
            print("raised:", isinstance(e, RuntimeError), int(s.iterations))
        else:
            print("did not raise")
    """
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert "raised: True 0" in run.stdout, (run.stdout, run.stderr[-3000:])


def test_a_chunk_returns_before_the_card_finishes(dev):
    """run_chunk with deadline=None enqueues its replays and returns: an
    event recorded right after it is not yet complete."""
    import importlib.util

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.search import batched
    from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    p = Puzzle.from_text(smoke.HARD_PUZZLE_TEXT)
    pl = batched.BatchedPlanner(p, max_depth=0, device=dev, **PRODUCTION_CAPACITIES)
    s = pl.init_state()
    batched.run_chunk(pl.cp_dev, pl.tables, pl.config, s, 1)  # the capture
    torch.cuda.synchronize()
    batched.run_chunk(pl.cp_dev, pl.tables, pl.config, s, 128)
    done = torch.cuda.Event()
    done.record()
    assert not done.query()
    done.synchronize()
    assert int(s.iterations) > 1
