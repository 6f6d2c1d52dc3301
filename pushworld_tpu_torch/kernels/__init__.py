"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their build.

``LAUNCHES`` counts the launches of each kernel: a wrapper calls
:func:`count_launch` where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels.  Several threads launch
kernels (the fleet's device worker, the portfolio's table prefetch), and
``LAUNCHES[name] += 1`` is a read and a write, so the update is made under a
lock.

A capture into a CUDA graph (``search/chunk_graph.py``) runs the wrappers
but launches nothing on the card: inside :func:`recording_launches` the
capturing thread's counts go to the block's own counter.  A search chunk on
the card is a device-side loop over such a graph, which counts the bodies it
runs in device memory; :func:`settle_launches` reads every live loop's count
and adds the bodies run since its last settle, times the kernels of one
body, to ``LAUNCHES`` (a loop also settles when it is released).  So
``LAUNCHES`` keeps meaning kernels launched on the card, once settled.
``envs/throughput.py``'s rollout graph adds its captured counts at each
replay, and counts the replay itself in ``GRAPH_LAUNCHES``.
"""

import threading
import weakref
from collections import Counter
from contextlib import contextmanager
from typing import Iterator

import torch

LAUNCHES: Counter = Counter()
# Launches of captured CUDA graphs, by name (a graph's kernels count in LAUNCHES).
GRAPH_LAUNCHES: Counter = Counter()
_LAUNCHES_LOCK = threading.Lock()
_RECORDING = threading.local()
# Live objects whose launches run on the card uncounted until they settle:
# each has a ``settle()`` that reads its device count and adds the launches.
_UNSETTLED = weakref.WeakSet()


def count_launch(name: str, count: int = 1) -> None:
    recorded = getattr(_RECORDING, "counter", None)
    if recorded is not None:
        recorded[name] += count
        return
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += count


def count_graph_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        GRAPH_LAUNCHES[name] += 1


def track_unsettled(obj) -> None:
    """Registers ``obj`` (with a ``settle()`` method) for :func:`settle_launches`."""
    _UNSETTLED.add(obj)


def settle_launches() -> None:
    """Adds to ``LAUNCHES`` what every live device loop ran since it last
    settled (each waits for its last launch).  Call before reading
    ``LAUNCHES`` or clearing it for a new count."""
    for obj in list(_UNSETTLED):
        obj.settle()


@contextmanager
def recording_launches() -> Iterator[Counter]:
    """Inside the block, this thread's :func:`count_launch` calls add to the
    yielded counter instead of ``LAUNCHES`` (other threads count as usual)."""
    if getattr(_RECORDING, "counter", None) is not None:
        raise RuntimeError("recording_launches does not nest")
    _RECORDING.counter = Counter()
    try:
        yield _RECORDING.counter
    finally:
        _RECORDING.counter = None


def launch_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current and its current CUDA
    stream's handle as the last argument; returns what ``fn`` returns.

    A wrapper's host time is the enqueue of its launch: the raw handle is
    read without building the Python stream object that
    ``torch.cuda.current_stream()`` returns, and the device is switched only
    when it is not current."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if device.index == torch.cuda.current_device():
        return fn(*args, raw(device.index) if raw else torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, raw(device.index) if raw else torch.cuda.current_stream(device).cuda_stream)
