"""The program's own spans and counters in a traced slice.

The program (``pushworld_tpu_torch/utils/tracing.py``) records ``pw.*``
spans and adds to its ``COUNTERS`` only while torch.profiler records, so a
``--trace 1`` run's slice holds them and nothing else does.  A program
without them (an older one) gives no span and no counter, and the readers
built on these functions then read nothing.

Span times are the profiler's microseconds (``Trace.host``).  ``record``
may take its slice more than once and keeps the last; a span's count in
that slice is its own denominator.  The counters add up over every attempt,
and are read as ratios over ``COUNTERS["solves"]``, which adds up alike.
"""

from typing import List, Optional, Tuple

from .trace import Trace, union


def spans(trace: Optional[Trace], *names: str) -> List[Tuple[float, float]]:
    """(start, end) of the host spans named one of ``names``."""
    if trace is None:
        return []
    return [(s, e) for n, s, e in trace.host if n in names]


def per_span(trace: Optional[Trace], per: str, names: Tuple[str, ...]) -> Optional[float]:
    """Host microseconds inside spans named one of ``names`` (their union),
    per ``per`` span; nothing where the slice has no ``per`` span."""
    n = len(spans(trace, per))
    return union(spans(trace, *names)) / n if n else None


def per_solve(counter: str) -> Optional[float]:
    """The program's ``COUNTERS[counter]`` over its ``COUNTERS["solves"]``;
    nothing where the program has no counters or counted no solve."""
    try:
        from pushworld_tpu_torch.utils.tracing import COUNTERS
    except ImportError:
        return None
    solves = COUNTERS["solves"]
    return COUNTERS[counter] / solves if solves else None
