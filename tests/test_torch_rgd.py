"""Port RGD tables and heuristic vs the JAX package's ``ops/rgd.py``.

The port builds its distance tables from wavefront fields (the plain version
on the CPU); the JAX package uses host BFS.  Tables must be array-equal on
every fixture, and heuristic values and needs-deeper flags equal (tolerance
0) on reachable states at depths 0..3.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushworld_tpu.core.compiled import compile_puzzle as j_compile
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.ops import rgd as jr
from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.interop import rgd_tables_from_numpy
from pushworld_tpu_torch.ops import rgd as tr

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
FIXTURES = sorted(
    os.path.relpath(f, PUZZLES)[:-4]
    for f in glob.glob(os.path.join(PUZZLES, "**", "*.pwp"), recursive=True)
)
TABLE_FIELDS = ("E", "Dflat", "vidx", "doff", "dstride", "DG", "contacts", "contacts_mask",
                "contacts_a", "contacts_a_mask", "cvidx_a", "goal_pos", "goal_mask")
STATIC_FIELDS = ("n_real", "n", "max_goals", "height", "width", "cmax", "cmax_agent")


def _both(name):
    path = os.path.join(PUZZLES, name + ".pwp")
    return Puzzle.from_file(path), JPuzzle.from_file(path)


def _assert_tables_equal(tt, jt):
    for f in TABLE_FIELDS:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.shape == b.shape and np.array_equal(a.astype(b.dtype), b), f
    for f in STATIC_FIELDS:
        assert int(getattr(tt, f)) == int(getattr(jt, f)), f


@pytest.mark.parametrize("name", FIXTURES)
def test_build_rgd_tables_matches_jax(name):
    p, jp = _both(name)
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    jt = jr.build_rgd_tables(jp, j_compile(jp))
    _assert_tables_equal(tt, jt)
    assert tt.Dflat.dtype == torch.int32


@pytest.mark.parametrize("name", ["multi_goal", "heur/two_tools", "heur/aw_tool_corridor"])
def test_build_rgd_tables_padded_and_depth0_match_jax(name):
    p, jp = _both(name)
    pad = dict(cmax_pad=64, max_goals=4, dflat_cap=1 << 14, cmax_agent_pad=40)
    for depth in (0, 2):
        tt = tr.build_rgd_tables(p, compile_puzzle(p), max_depth=depth, device="cpu", **pad)
        jt = jr.build_rgd_tables(jp, j_compile(jp), max_depth=depth, **pad)
        _assert_tables_equal(tt, jt)
    assert tr.dflat_required(p, compile_puzzle(p), 0) == jr.dflat_required(jp, j_compile(jp), 0)
    assert tr.dflat_required(p, compile_puzzle(p)) == jr.dflat_required(jp, j_compile(jp))
    with pytest.raises(ValueError):
        tr.build_rgd_tables(p, compile_puzzle(p), dflat_cap=1, device="cpu")


def _reachable(puzzle, count, seed):
    rng = np.random.default_rng(seed)
    s = puzzle.initial_state
    out = [s]
    for _ in range(count - 1):
        for a in rng.integers(0, 4, size=rng.integers(1, 6)).tolist():
            s = puzzle.get_next_state(s, a)
        out.append(s)
    return np.asarray(out, np.int32)


@pytest.mark.parametrize(
    "name,depths",
    [
        ("heur/two_tools", (0, 1, 2)),
        ("heur/multiple_goals", (0, 1)),
        ("heur/shortest_path_tool", (1,)),
        ("heur/aw_tool_corridor", (0, 1, 3)),
    ],
)
def test_rgd_values_and_flags_match_jax(name, depths):
    p, jp = _both(name)
    jt = jr.build_rgd_tables(jp, j_compile(jp))
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    states = _reachable(p, 48, seed=7)
    for depth in depths:
        jv, jf = jr.rgd_heuristic_with_flags(jt, jnp.asarray(states), max_depth=depth)
        tv, tf = tr.rgd_heuristic_with_flags(tt, torch.as_tensor(states), max_depth=depth)
        assert tv.dtype == torch.float32
        assert np.array_equal(tv.numpy(), np.asarray(jv)), depth
        assert np.array_equal(tf.numpy(), np.asarray(jf)), depth
        assert torch.equal(tr.rgd_heuristic(tt, torch.as_tensor(states), max_depth=depth), tv)


def test_depth3_matches_host_oracle():
    """three_tools needs pushing depth 3 at the initial state; the port's
    memoized recursion must give the host oracle's exact values (the JAX
    package's own depth-3 test, run through the port)."""
    from pushworld_tpu.search.heuristics_host import RecursiveGraphDistance

    p, jp = _both("heur/three_tools")
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    host = RecursiveGraphDistance(jp, j_compile(jp), fewest_tools=True)
    states = _reachable(p, 32, seed=0)
    got3 = tr.rgd_heuristic(tt, torch.as_tensor(states), max_depth=3).numpy()
    assert tr.rgd_heuristic(tt, torch.as_tensor(states[:1]), max_depth=2)[0] >= 1e8
    for i, s in enumerate(states):
        want = host.estimate(tuple(map(tuple, s.tolist())))
        assert (got3[i] >= 1e8) if np.isinf(want) else (got3[i] == want), (i, want, got3[i])


def test_interop_tables_round_trip():
    p, jp = _both("heur/trivial_tool")
    jt = jr.build_rgd_tables(jp, j_compile(jp))
    d = {f: np.asarray(getattr(jt, f)) for f in TABLE_FIELDS + STATIC_FIELDS}
    tt = rgd_tables_from_numpy(d, device="cpu")
    _assert_tables_equal(tt, jt)
    states = torch.as_tensor(_reachable(p, 16, seed=1))
    ref = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    assert torch.equal(tr.rgd_heuristic(tt, states, 1), tr.rgd_heuristic(ref, states, 1))


# ------------------------------------------- the kernel's algorithm, per state
#
# ``kernels/rgd.cu`` computes each state on its own.  ``_rgd_loop_form`` is
# its algorithm written as a numpy loop over one state, held exactly against
# the JAX function: first the depth-0 pass of every goal (one (goal, move)
# pair a lane: feasibility, distance to goal, the agent's cost), which alone
# gives the result when no goal is infinite at depth 0 and able to move (or
# the deepest depth is 0); else, beside it, what a deeper depth reads first
# (every pusher's own first moves and A0 row), then the goals in order from
# their depth-0 values, with rows of M filled one (pushee, move, pusher)
# triple at a time, a running min over its contacts, nothing computed for
# depths above n_real - 2 or for pushers the valid-pusher mask drops.  The
# card tests hold the kernel itself against its plain version.

F32_INF, F32_FINITE = np.float32(1e9), np.float32(1e8)
MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _rgd_loop_form(t, s, max_depth, wide=False):
    """(total float32, needs_deeper) of one state ``s`` (N, 2) from the
    tables ``t`` (a dict of numpy arrays and ints), as kernels/rgd.cu
    computes it: its one-word path, or with ``wide`` its wide path (any N:
    the deep tables by :func:`_rgd_wide_deep`)."""
    n, nr, H, W = t["n"], t["n_real"], t["height"], t["width"]
    HW = H * W
    E, vidx, Dflat, doff, dstride = t["E"], t["vidx"], t["Dflat"], t["doff"], t["dstride"]
    dmax = min(max_depth, nr - 2)

    def edge(a, o, x, y):
        return 0 <= x < W and 0 <= y < H and bool(E[a, o, y, x])

    def cell(x, y):
        return min(max(y * W + x, 0), HW - 1)

    def dist(r, iu, iv):
        if iu < 0 or iv < 0:
            return F32_INF
        d = int(Dflat[int(doff[r]) + iu * int(dstride[r]) + iv])
        return np.float32(d) if d != 65535 else F32_INF

    def agent_cost(q, a):  # the agent pushes q: 1 + min over its contacts
        iA = int(vidx[0, cell(*s[0])])
        cv = t["cvidx_a"][a, q, cell(*s[q])]
        return np.float32(1) + min([dist(0, iA, int(v)) for v in cv] + [F32_INF])

    def goal_cost(last, finite_dg):  # the fewest-tools rule once the last depth is known
        found = last < F32_FINITE
        cost = last if found else (F32_INF if max_depth > nr - 2 else last)
        return min(cost, F32_INF), max_depth < nr - 2 and finite_dg and cost >= F32_FINITE

    # The depth-0 pass: each (goal, move) pair, then the min over the moves.
    A0, pass0 = {}, []
    for k in range(t["max_goals"]):
        o = k + 1
        eok = [edge(a, o, *s[o]) for a in range(4)]
        gd = [t["DG"][o, min(max(s[o][1] + dy, 0), H - 1), min(max(s[o][0] + dx, 0), W - 1)]
              for dx, dy in MOVES]
        for a in range(4):
            A0[o, a] = agent_cost(o, a)
        pd = min(gd[a] + A0[o, a] if eok[a] else F32_INF for a in range(4))
        row = bool(t["goal_mask"][o]) and tuple(s[o]) != tuple(t["goal_pos"][o])
        pass0.append((row, pd, eok, gd, any(e and g < F32_FINITE for e, g in zip(eok, gd)), any(eok)))
    deep = dmax >= 1 and any(row and pd >= F32_FINITE and moves for row, pd, _, _, _, moves in pass0)
    if not deep:
        total, deeper = np.float32(0), False
        for row, pd, _, _, finite_dg, moves in pass0:
            cost = np.float32(0)
            if row:
                cost, flag = goal_cost(pd if dmax >= 0 and (dmax == 0 or moves) else F32_INF, finite_dg)
                deeper |= flag
            total = total + cost
        return total, deeper

    # Deeper: the pushers' own first moves and A0 rows (read first), then
    # the tables.
    IU = {}
    for r in range(nr):
        for a2, (dx, dy) in enumerate(MOVES):
            IU[r, a2] = int(vidx[r, cell(s[r][0] + dx, s[r][1] + dy)]) if edge(a2, r, *s[r]) else None
    for q in range(t["max_goals"] + 1, nr):
        for a in range(4):
            A0[q, a] = agent_cost(q, a)
    M = {}

    def push_row(q, a, r):  # M[q][a][r]: a running min over the contacts
        m = [F32_INF] * 4
        for c in range(t["cmax"]):
            if not t["contacts_mask"][a, r, q, c]:
                continue
            cx, cy = s[q] + t["contacts"][a, r, q, c]
            if not edge(a, r, cx, cy):
                continue
            iv = int(vidx[r, cell(cx, cy)])
            same = cx == s[r][0] and cy == s[r][1]
            for a2 in range(4):
                if IU[r, a2] is not None:
                    base = np.float32(0) if same and a2 == a else dist(r, IU[r, a2], iv) + np.float32(1)
                    m[a2] = min(m[a2], base)
        return m

    if wide:
        return _rgd_wide_deep(t, pass0, A0, push_row, dmax, goal_cost)

    def fill_m(rows):  # rows of M not filled yet: a (q, a, r) triple at a time
        for q in sorted(set(rows) - {q for q, _, _ in M}):
            for a in range(4):
                for r in range(1, nr):
                    if r != q:
                        M[q, a, r] = push_row(q, a, r)

    def best(q, a, excl, inner):  # min over pushers outside excl of M + inner
        out = F32_INF
        for r in range(1, nr):
            if r not in excl:
                for a2 in range(4):
                    out = min(out, M[q, a, r][a2] + inner(r, a2))
        return out

    def table(S, d):  # T(S, d) as a function of (pusher, move); entries outside S only
        if d == 0:
            return lambda r, a2: A0[r, a2]
        vals = {}
        for q in range(1, nr):
            if q not in S:
                sub = table(S | {q}, d - 1)
                for a in range(4):
                    vals[q, a] = best(q, a, S | {q}, sub)
        return lambda r, a2: vals[r, a2]

    total, deeper = np.float32(0), False
    for k, (row, pd, eok, gd, finite_dg, moves) in enumerate(pass0):
        o = k + 1
        cost = np.float32(0)
        if row:
            last = pd
            for D in range(1, dmax + 1):  # fewest tools: stop at the first finite depth
                if last < F32_FINITE:
                    break
                last = F32_INF
                if moves:
                    fill_m([o] if D == 1 else [o, *range(1, nr)])
                    inner = table({o}, D - 1)
                    last = min(gd[a] + best(o, a, {o}, inner) if eok[a] else F32_INF for a in range(4))
            cost, flag = goal_cost(last, finite_dg)
            deeper |= flag
        total = total + cost
    return total, deeper


def _rgd_wide_deep(t, pass0, A0, push_row, dmax, goal_cost):
    """The wide path's deep part (rgd_wide_kernel_deep past its depth-0
    pass): the goals in order with the skip set's uniform part as a flag an
    object (EX: the goal, and the chain above the current table), a thread's
    own pushee and pusher beside it (e1, e2); M's rows filled for the goal
    at depth 1 and all at once from depth 2 (again, if an earlier goal
    filled some); T(EX, 1), T(EX, 2) through TX, and deeper tables by the
    walk of table_deep_wide, its next pusher of each level in STK.  Table
    entries never written are NaN, and every entry read must be written."""
    n, nr = t["n"], t["n_real"]
    EX = [0] * n
    STK = [0] * (dmax + 1)
    M = np.full((n, 4, nr, 4), np.nan, np.float32)
    A0a = np.full((n, 4), np.nan, np.float32)
    for (q, a), v in A0.items():
        A0a[q, a] = v
    L = {d: np.full((nr, 4), np.nan, np.float32) for d in range(1, max(dmax, 1) + 1)}
    TX = np.full((nr, nr, 4), np.nan, np.float32)
    all_m = False

    def ensure_m(o, all_rows):
        nonlocal all_m
        if all_m:
            return
        for q in range(n):
            if q == o or (all_rows and 1 <= q < nr):
                for a in range(4):
                    for r in range(1, nr):
                        if r != q:
                            M[q, a, r] = push_row(q, a, r)
        all_m = all_rows

    def best(q, a, e1, e2, inner):  # min over the pushers outside EX, e1 and e2 (min is order-free)
        keep = ~np.asarray(EX[:nr], bool)
        keep[[0] + [e for e in (e1, e2) if e >= 0]] = False
        terms = M[q, a, keep] + inner[keep]  # float32 additions, as the kernel's
        assert not np.isnan(terms).any(), (q, a)
        return min(F32_INF, terms.min()) if terms.size else F32_INF

    def table1():
        for q in range(1, nr):
            if not EX[q]:
                for a in range(4):
                    L[1][q, a] = best(q, a, q, -1, A0a)

    def table2():
        for q in range(1, nr):
            for r in range(1, nr):
                if q != r and not EX[q] and not EX[r]:
                    for a in range(4):
                        TX[q, r, a] = best(r, a, q, r, A0a)
        for q in range(1, nr):
            if not EX[q]:
                for a in range(4):
                    L[2][q, a] = best(q, a, q, -1, TX[q])

    def table_deep(d0):
        STK[d0] = 1
        d = d0
        while True:
            q = STK[d]
            while q < nr and EX[q]:
                q += 1
            if q >= nr:  # level d is complete: fold it into its parent's entry
                if d == d0:
                    return
                d += 1
                pq = STK[d]
                for a in range(4):
                    L[d][pq, a] = best(pq, a, -1, -1, L[d - 1])
                EX[pq] = 0
                STK[d] = pq + 1
                continue
            EX[q] = 1
            if d == 3:
                table2()
                for a in range(4):
                    L[3][q, a] = best(q, a, -1, -1, L[2])
                EX[q] = 0
                STK[3] = q + 1
            else:
                STK[d] = q
                STK[d - 1] = 1
                d -= 1

    total, deeper = np.float32(0), False
    for k, (row, pd, eok, gd, finite_dg, moves) in enumerate(pass0):
        o = k + 1
        cost = np.float32(0)
        if row:
            last = pd
            EX[o] = 1
            for D in range(1, dmax + 1):
                if last < F32_FINITE:
                    break
                last = F32_INF
                if moves:
                    ensure_m(o, D >= 2)
                    inner = A0a
                    if D == 2:
                        table1()
                        inner = L[1]
                    elif D == 3:
                        table2()
                        inner = L[2]
                    elif D >= 4:
                        table_deep(D - 1)
                        inner = L[D - 1]
                    last = min(gd[a] + best(o, a, -1, -1, inner) if eok[a] else F32_INF for a in range(4))
            EX[o] = 0
            assert not any(EX)
            cost, flag = goal_cost(last, finite_dg)
            deeper |= flag
        total = total + cost
    return total, deeper


def _chip_smoke():
    """chip_smoke.py as a module (its puzzle texts)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _loop_form_against_jax(jt, states, depths):
    t = {f: np.asarray(getattr(jt, f)) for f in TABLE_FIELDS} | {f: int(getattr(jt, f)) for f in STATIC_FIELDS}
    for depth in depths:
        jv, jf = jr.rgd_heuristic_with_flags(jt, jnp.asarray(states), max_depth=depth)
        got = [_rgd_loop_form(t, s.astype(np.int64), depth) for s in states]
        assert np.array_equal(np.asarray([g[0] for g in got], np.float32), np.asarray(jv)), depth
        assert np.array_equal(np.asarray([g[1] for g in got]), np.asarray(jf)), depth


@pytest.mark.parametrize("name", FIXTURES)
def test_kernel_loop_form_matches_jax(name):
    """The kernel's per-state algorithm, totals and needs-deeper flags, equal
    to the JAX function at depths 0..3 on every fixture."""
    p, jp = _both(name)
    jt = jr.build_rgd_tables(jp, j_compile(jp))
    _loop_form_against_jax(jt, _reachable(p, 12, seed=11), (0, 1, 2, 3))


def test_kernel_loop_form_deep_chain_matches_plain_version_and_host_oracle():
    """Depths 4 and 5 (the kernel's loop over T(., 2) tables): on a puzzle
    whose goal needs four tools, the loop form equals the port's plain
    version (held to JAX at depths 0..3 above) and the host oracle; on
    unreachable states of ten movables (every INF path), the plain version.
    (JAX's trace at these depths takes minutes to compile.)"""
    from pushworld_tpu.search.heuristics_host import RecursiveGraphDistance

    chip_smoke = _chip_smoke()

    def against_plain(puzzle, states, depths):
        tt = tr.build_rgd_tables(puzzle, compile_puzzle(puzzle), device="cpu")
        t = {f: getattr(tt, f).numpy() for f in TABLE_FIELDS} | {f: getattr(tt, f) for f in STATIC_FIELDS}
        for depth in depths:
            want = tr.rgd_heuristic_with_flags_reference(tt, torch.as_tensor(states), depth)
            for wide in (False, True):  # the one-word path's algorithm and the wide path's
                got = [_rgd_loop_form(t, s.astype(np.int64), depth, wide) for s in states]
                assert np.array_equal(np.asarray([g[0] for g in got], np.float32), want[0].numpy()), (depth, wide)
                assert np.array_equal(np.asarray([g[1] for g in got]), want[1].numpy()), (depth, wide)
            yield want[0].numpy()

    p, jp = Puzzle.from_text(chip_smoke.FOUR_TOOLS_TEXT), JPuzzle.from_text(chip_smoke.FOUR_TOOLS_TEXT)
    states = _reachable(p, 8, seed=5)
    d3, d4, d5 = against_plain(p, states, (3, 4, 5))
    host = RecursiveGraphDistance(jp, j_compile(jp), fewest_tools=True)
    for i, s in enumerate(states):
        assert d4[i] == d5[i] == host.estimate(tuple(map(tuple, s.tolist()))) and d3[i] >= 1e8, i
    m = Puzzle.from_text(chip_smoke.MANY_MOVABLES_TEXT)
    rng = np.random.default_rng(1)
    W, H = m.width, m.height
    states = np.stack([rng.integers(0, W, (6, m.num_movables)), rng.integers(0, H, (6, m.num_movables))], -1)
    list(against_plain(m, states.astype(np.int32), (0, 4)))


@pytest.mark.parametrize("n_objects", [8, 32, 33, 48, 64, 100])
def test_kernel_loop_form_at_many_objects_matches_plain_version(n_objects):
    """The kernel's per-state algorithm at depths 0, 1 and 2 equal to the
    plain version (held to JAX above): the one-word path's up to 32 objects
    (one lane an object, 32-bit skip sets) on walks of a puzzle of that
    many movables; above 32 the wide path's on walks of the four-tool chain
    widened by obstacles to that many movables, whose goal needs depth 4,
    so that depths 1 and 2 fill M and T(., 1) over every movable."""
    wide = n_objects > tr.RGD_MAX_OBJECTS
    smoke = _chip_smoke()
    text = smoke.four_tools_with_obstacles_text(n_objects) if wide else smoke.many_objects_text(n_objects)
    p = Puzzle.from_text(text)
    assert p.num_movables == n_objects
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    t = {f: getattr(tt, f).numpy() for f in TABLE_FIELDS} | {f: getattr(tt, f) for f in STATIC_FIELDS}
    states = _reachable(p, 3 if wide else 6, seed=n_objects)
    if wide:
        assert (tr.rgd_heuristic_with_flags_reference(tt, torch.as_tensor(states), 2)[0] >= 1e8).all()
    for depth in (0, 1, 2):
        want = tr.rgd_heuristic_with_flags_reference(tt, torch.as_tensor(states), depth)
        got = [_rgd_loop_form(t, s.astype(np.int64), depth, wide) for s in states]
        assert np.array_equal(np.asarray([g[0] for g in got], np.float32), want[0].numpy()), depth
        assert np.array_equal(np.asarray([g[1] for g in got]), want[1].numpy()), depth


def test_wrappers_on_cpu_run_the_plain_version():
    """On CPU tensors the wrappers return the plain version's values and
    launch no kernel."""
    from pushworld_tpu_torch.kernels import LAUNCHES

    p, _ = _both("heur/two_tools")
    tt = tr.build_rgd_tables(p, compile_puzzle(p), device="cpu")
    states = torch.as_tensor(_reachable(p, 16, seed=2))
    before = dict(LAUNCHES)
    for depth in (0, 2):
        want = tr.rgd_heuristic_with_flags_reference(tt, states, depth)
        got = tr.rgd_heuristic_with_flags(tt, states, depth)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(tr.rgd_heuristic(tt, states, depth), want[0])
    assert dict(LAUNCHES) == before
