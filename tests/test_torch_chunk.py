"""The search iteration that reads nothing back, on the CPU.

On the card ``run_chunk`` is a CUDA graph that loops over one captured,
gated iteration (``search/chunk_graph.py``); a graph can hold an iteration
only if the iteration never waits on the host and never rebinds a state
tensor.  These
tests hold both on the CPU: ``_iterate`` under a dispatch mode that refuses
every host read and every boolean-mask index, and an iteration whose gate is
closed (after a solve, after an exhaustion, with the history at its limit)
leaving every tensor of the state as it was.
"""

import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.search import batched as tb

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
PAIR_BITS = 12
aten = torch.ops.aten


class NoHostReads(TorchDispatchMode):
    """Raises on what waits for the device: a scalar read (``.item()``,
    ``int()``, ``bool()``, ``.tolist()``), ``nonzero``, ``masked_select``,
    ``equal``, and an index or index_put with a boolean index (which
    reaches ``nonzero`` inside the kernel).  ``suspended`` lets a kernel's
    plain version run unchecked: on the card it is one kernel launch."""

    READS = (aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten.equal)
    INDEXING = (aten.index, aten.index_put_, aten.index_put, aten._index_put_impl_)

    def __init__(self):
        super().__init__()
        self.suspended = False
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.suspended:
            self.ops += 1
            if func.overloadpacket in self.READS:
                raise AssertionError(f"host read in the iteration: {func}")
            if func.overloadpacket in self.INDEXING:
                indices = args[1] if len(args) > 1 else kwargs["indices"]
                if any(i is not None and i.dtype in (torch.bool, torch.uint8) for i in indices):
                    raise AssertionError(f"boolean index in the iteration: {func}")
        return func(*args, **kwargs)


def _planner(name, depth, lazy=False, **caps):
    p = Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))
    kw = dict(expand=16, frontier_capacity=1 << 7, visited_bits=12, history_capacity=1 << 12)
    kw.update(caps)
    return tb.BatchedPlanner(p, max_depth=depth, lazy=lazy, pair_bits=PAIR_BITS, device="cpu", **kw)


def _snapshot(s):
    """Every tensor of the state, cloned, by name."""
    out = {k: v.clone() for k, v in vars(s).items() if isinstance(v, torch.Tensor)}
    out["visited.keys"] = s.visited.keys.clone()
    out["novelty.seen_pos"] = s.novelty.seen_pos.clone()
    out["novelty.pair_table"] = s.novelty.pair_table.clone()
    return out


@pytest.mark.parametrize("name,depth,lazy,iters", [
    ("spill_grid", 0, False, 10),  # the 128-slot ring compacts from 2 on, evicts from 9 on
    ("heur/trivial_tool", 1, True, 2),
    ("heur/three_tools", 3, False, 1),
])
def test_iterate_reads_nothing_back(name, depth, lazy, iters, monkeypatch):
    pl = _planner(name, depth, lazy)
    s = pl.init_state()
    mode = NoHostReads()
    # The fused insert and the ring's compaction are single launches on the
    # card, and the compaction deletes its drops from the visited set inside
    # its own kernel; their plain versions (held against the kernels in
    # tests/test_torch_cuda.py and chip_smoke.py) stand in for them here,
    # outside the check.  The plain compaction calls probe_delete, whose
    # plain version stands in too.  (The compaction's plain version takes its
    # branch on the host, as JAX's lax.cond does: it sorts only when it
    # compacts.)
    for fn in ("fingerprint_dedup_insert", "probe_delete", "compact_frontier"):
        plain = getattr(tb, fn)

        def stand_in(*args, _plain=plain):
            mode.suspended = True
            try:
                return _plain(*args)
            finally:
                mode.suspended = False

        monkeypatch.setattr(tb, fn, stand_in)
    # Tensors made from host data are host-to-device copies on the card,
    # which a capture refuses: none may be made inside the iteration.
    for fn in ("tensor", "as_tensor", "from_numpy"):
        made = getattr(torch, fn)

        def refuse(*args, _made=made, _fn=fn, **kwargs):
            if not mode.suspended:
                raise AssertionError(f"torch.{_fn} inside the iteration")
            return _made(*args, **kwargs)

        monkeypatch.setattr(torch, fn, refuse)
    with mode:
        for _ in range(iters):
            tb._iterate(pl.cp_dev, pl.tables, pl.config, s)
    assert mode.ops > 100
    assert int(s.iterations) == iters and int(s.expansions) > 0
    if name == "spill_grid":
        assert int(s.evictions) > 0  # the compaction ran inside the checked iterations


def _run_until(pl, s, stop, limit=400):
    for _ in range(limit):
        if stop(s):
            return s
        tb._iterate(pl.cp_dev, pl.tables, pl.config, s)
    raise AssertionError("the search did not reach the state the test needs")


@pytest.mark.parametrize("case", ["solved", "exhausted", "history_full"])
def test_inactive_iteration_is_a_no_op(case):
    if case == "solved":
        pl = _planner("spill_grid", 0)
        s = _run_until(pl, pl.init_state(), lambda s: bool(s.solved))
    elif case == "exhausted":
        pl = _planner("no_solution", 0, expand=32, frontier_capacity=1 << 10, visited_bits=14,
                      history_capacity=1 << 14)
        s = _run_until(pl, pl.init_state(), lambda s: int(s.frontier_h.min()) >= tb.EMPTY)
        assert not bool(s.solved)
    else:
        pl = _planner("spill_grid", 0, history_capacity=8 * 16 + 64)
        limit = pl.history_capacity - 8 * pl.expand
        s = _run_until(pl, pl.init_state(), lambda s: int(s.hist_cursor) >= limit)
        assert not bool(s.solved) and int(s.frontier_h.min()) < tb.EMPTY
    assert not bool(tb._active(pl.config, s))
    before = _snapshot(s)
    tb._iterate(pl.cp_dev, pl.tables, pl.config, s)
    after = _snapshot(s)
    assert sorted(after) == sorted(before)
    for k in before:
        assert torch.equal(after[k], before[k]), (case, k)
    # run_chunk on the CPU stops at the closed gate without an iteration.
    tb.run_chunk(pl.cp_dev, pl.tables, pl.config, s, 5)
    assert int(s.iterations) == int(before["iterations"])


def test_launch_counts_of_a_capture_are_recorded_not_counted():
    """Inside ``recording_launches`` this thread's counts go to the block's
    counter (a capture launches nothing); a replay adds them with a count."""
    import threading

    from pushworld_tpu_torch import kernels

    before = kernels.LAUNCHES["probe"]
    other = threading.Thread(target=kernels.count_launch, args=("probe",))
    with kernels.recording_launches() as rec:
        kernels.count_launch("probe")
        kernels.count_launch("probe", 2)
        other.start()
        other.join(10)
        with pytest.raises(RuntimeError, match="nest"):
            with kernels.recording_launches():
                pass
    assert not other.is_alive()
    assert dict(rec) == {"probe": 3}
    assert kernels.LAUNCHES["probe"] - before == 1  # the other thread's launch
    for name, n in rec.items():
        kernels.count_launch(name, n)
    assert kernels.LAUNCHES.pop("probe") - before == 4
