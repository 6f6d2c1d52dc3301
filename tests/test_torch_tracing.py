"""The program's spans and counters (``pushworld_tpu_torch/utils/tracing.py``)
on the CPU.

Spans and counters record only while torch.profiler records: without a
profiler a solve and a rollout leave ``COUNTERS`` as they were.  The card's
own span (``pw.solve.capture``) and its bytes are held in
``tests/test_torch_cuda.py``.
"""

import os
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pushworld_tpu_torch.core.compiled import compile_puzzle
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.envs.throughput import rollout
from pushworld_tpu_torch.envs.vector_env import VectorEnv
from pushworld_tpu_torch.search.planner import solve_puzzle
from pushworld_tpu_torch.utils import tracing

PUZZLES = os.path.join(os.path.dirname(__file__), "puzzles")
SMALL = dict(expand=16, frontier_capacity=1 << 8, visited_bits=12, history_capacity=1 << 12, pair_bits=12)
SETUP_SPANS = ("pw.solve.required_depth", "pw.solve.compile", "pw.solve.tables", "pw.solve.init_state")


@pytest.fixture
def counters():
    """``tracing.COUNTERS``, cleared for the test and restored after it."""
    saved = Counter(tracing.COUNTERS)
    tracing.COUNTERS.clear()
    yield tracing.COUNTERS
    tracing.COUNTERS.clear()
    tracing.COUNTERS.update(saved)


def _puzzle(name="heur/two_tools"):
    return Puzzle.from_file(os.path.join(PUZZLES, name + ".pwp"))


def test_without_a_profiler_nothing_is_recorded_or_counted(counters):
    assert not tracing.recording()
    assert tracing.span("pw.a") is tracing.span("pw.b")  # the one shared no-op
    counters.update(solves=3, d2h_bytes=5)
    before = Counter(counters)
    r = solve_puzzle(_puzzle(), time_limit=60, device="cpu", **SMALL)
    assert r.failure_reason is None
    p = _puzzle("simple")
    env = VectorEnv(compile_puzzle(p), max_steps=None, device="cpu")
    rollout(env, None, torch.zeros((8,), dtype=torch.int32), 4, False, torch.Generator().manual_seed(0))
    tracing.count("solves")
    assert counters == before


def _events(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("pw.")]


def test_a_profiled_cpu_solve_records_its_spans_and_counts(counters):
    p = _puzzle()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        r = solve_puzzle(p, time_limit=60, device="cpu", **SMALL)
    assert r.failure_reason is None and p.is_valid_plan(r.plan)
    events = _events(prof)
    names = Counter(n for n, _, _ in events)
    assert names["pw.solve"] == 1
    for name in SETUP_SPANS + ("pw.solve.status_wait",):
        assert names[name] >= 1, name
    assert names["pw.solve.readback"] == 1 and names["pw.solve.validate"] == 1
    assert names["pw.solve.capture"] == 0  # the CPU captures no loop
    (_, s0, e0), = [ev for ev in events if ev[0] == "pw.solve"]
    assert all(s0 <= s <= e <= e0 for _, s, e in events)
    # Nothing came from a card: one solve, no device bytes, no allocator.
    assert counters == Counter(solves=1)


def test_each_solve_counts_once_and_the_host_planner_too(counters):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve_puzzle(_puzzle("simple"), time_limit=60, device="cpu", **SMALL)
        solve_puzzle(_puzzle("simple"), planner="host")
    assert counters["solves"] == 2
    assert sum(n == "pw.solve" for n, _, _ in _events(prof)) == 2


def test_span_and_count_record_only_under_a_profiler(counters):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("pw.outer"):
            with tracing.span("pw.inner"):
                tracing.count("d2h_bytes", 32)
        tracing.count("d2h_bytes", 32)
    tracing.count("d2h_bytes", 1 << 20)
    with tracing.span("pw.after"):
        pass
    assert counters == Counter(d2h_bytes=64)
    events = {n: (s, e) for n, s, e in _events(prof)}
    assert set(events) == {"pw.outer", "pw.inner"}
    assert events["pw.outer"][0] <= events["pw.inner"][0] <= events["pw.inner"][1] <= events["pw.outer"][1]
