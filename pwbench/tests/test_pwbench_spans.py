"""The readers of the program's spans and counters (``pwbench/metrics/``,
``pwbench/harness/spans.py``) on hand-made traces and counters (CPU)."""

import sys
from collections import Counter
from types import SimpleNamespace

import pytest

from pwbench.harness.cell import BENCH, load_module
from pwbench.harness.trace import Trace


@pytest.fixture
def counters():
    """The program's ``COUNTERS``, cleared for the test and restored after it."""
    from pushworld_tpu_torch.utils import tracing

    saved = Counter(tracing.COUNTERS)
    tracing.COUNTERS.clear()
    yield tracing.COUNTERS
    tracing.COUNTERS.clear()
    tracing.COUNTERS.update(saved)


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"pwbench_metric_{name}").read


def _run(trace):
    return SimpleNamespace(trace=trace)


def _plan_trace():
    """Two solves in a 1,000 µs slice: the first's set-up spans are
    disjoint, the second's table build lies inside its capture (counted
    once)."""
    host = [("pw.solve", 0, 400), ("pw.solve.required_depth", 10, 50), ("pw.solve.compile", 50, 60),
            ("pw.solve.tables", 60, 70), ("pw.solve.init_state", 70, 80), ("pw.solve.capture", 80, 150),
            ("pw.solve.status_wait", 200, 250), ("pw.solve.readback", 300, 390), ("aten::copy_", 301, 389),
            ("pw.solve", 500, 900), ("pw.solve.required_depth", 510, 530), ("pw.solve.capture", 540, 560),
            ("pw.solve.tables", 545, 555), ("pw.solve.status_wait", 600, 610)]
    return Trace(device=[("k", 150, 200)], host=host, start=0.0, end=1000.0)


@pytest.mark.parametrize("name,expected", [
    ("setup_ms.plan", (140 + 40) / 2 * 1e-3),
    ("status_wait_ms.plan", (50 + 10) / 2 * 1e-3),
])
def test_span_readers_on_a_hand_made_trace(name, expected):
    trace = _plan_trace()
    assert _reader(name)(_run(trace)) == pytest.approx(expected)
    other = Trace(device=trace.device, host=[("aten::copy_", 1, 2), ("pwbench.solve", 0, 900)],
                  start=trace.start, end=trace.end)
    assert _reader(name)(_run(other)) is None
    assert _reader(name)(_run(None)) is None


@pytest.mark.parametrize("name,expected", [
    ("readback_bytes.plan", 2 * (1 << 21) * 4 + 32 * 3),
    ("reserved_growth_mb.plan", 24.0),
])
def test_counter_readers_on_hand_set_counters(counters, monkeypatch, name, expected):
    read = _reader(name)
    assert read(_run(None)) is None  # no solve counted
    counters.update(solves=4, d2h_bytes=4 * (2 * (1 << 21) * 4 + 32 * 3), reserved_growth_bytes=4 * 24 << 20)
    assert read(_run(None)) == pytest.approx(expected)
    # A program without the tracing module: nothing, and no error.
    monkeypatch.setitem(sys.modules, "pushworld_tpu_torch.utils.tracing", None)
    assert read(_run(None)) is None
