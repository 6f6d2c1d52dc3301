"""Host milliseconds waiting for a chunk's status per ``pw.solve`` span in
the traced slice: the program's ``pw.solve.status_wait`` spans
(``search/batched.py`` ``PendingStatus.read``).  Nothing where the program
records no ``pw.solve`` span."""

from pwbench.harness.spans import per_span


def read(run):
    us = per_span(run.trace, "pw.solve", ("pw.solve.status_wait",))
    return None if us is None else us * 1e-3
