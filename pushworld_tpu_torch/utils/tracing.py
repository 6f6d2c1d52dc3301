"""Spans and counters inside the planner and the rollouts, recorded only
while ``torch.profiler`` records.

An operator who runs a solve under ``torch.profiler`` gets the program's
phases in the same timeline as the device's kernels and copies: each
:func:`span` is a ``record_function`` range on the profiler's clock, named
``pw.*`` so it never collides with an aten op. At any other time a site
costs one flag test (:func:`recording`, one C call) and records nothing:
:func:`span` hands back one shared no-op context and allocates nothing, and
:func:`count` adds nothing.

The spans (each wraps the work where it happens):

- ``pw.solve``: one ``search.planner.solve_puzzle`` call;
- ``pw.solve.required_depth``: the host oracle's pushing depth;
- ``pw.solve.compile``: the planner's compile of the puzzle and its upload;
- ``pw.solve.tables``: the RGD table build's host side and enqueue (no
  synchronise: the device trace holds its kernels);
- ``pw.solve.init_state``: the search state's allocation and start;
- ``pw.solve.capture``: the chunk loop's warm iteration, capture and build;
- ``pw.solve.status_wait``: the host waiting for a chunk's status;
- ``pw.solve.readback``: the history's copy to the host and the backtrack;
- ``pw.solve.validate``: the host's check of the plan;
- ``pw.rollout.render_tables``: ``ops.render.compile_framed_render_tables``,
  the stacked pool's framed render tables.

:data:`COUNTERS` (read it after the profiled block; clear it to start a new
count):

- ``solves``: ``solve_puzzle`` calls;
- ``d2h_bytes``: bytes copied from a CUDA device to the host by status
  reads and the plan's read-back;
- ``reserved_growth_bytes``: per solve on a card, the growth, where
  positive, of the caching allocator's reserved bytes from its start to its
  end;
- ``replays``: replays of a ``envs.throughput.RolloutGraph`` with a
  trajectory;
- ``obs_bytes``: the observation bytes those replays write (T x B x H_f x
  W_f x 6 x 4 a replay);
- ``obs_bulk_bytes``: of those, the bytes the framed render kernel writes by
  bulk copy from shared memory, reckoned from the shapes and its split
  (``ops.render.framed_bulk_bytes``): every whole 128-byte line of a launch's
  output, all of it at 47 x 54.
"""

import contextlib
import threading
from collections import Counter

import torch

COUNTERS: Counter = Counter()
_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()

# recording() is true while a torch.profiler records on this thread: the C
# call itself, with no Python frame around it.
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while recording,
    else a shared no-op context."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


def reserved_bytes(device) -> int:
    """The caching allocator's reserved bytes on the CUDA ``device``, read
    from its nested statistics: ``torch.cuda.memory_reserved`` flattens all
    of them first, 100-141 µs a read on the H100's host against 12-21 µs.
    0 before CUDA is initialised."""
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return stats["reserved_bytes"]["all"]["current"] if stats else 0


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to ``COUNTERS[name]`` while recording; else nothing."""
    if recording():
        with _LOCK:
            COUNTERS[name] += n
