"""Host milliseconds of a solve's set-up per ``pw.solve`` span in the traced
slice: the union of the program's spans ``pw.solve.required_depth``,
``.compile``, ``.tables``, ``.init_state`` and ``.capture`` (the host
oracle's depth, the compile and upload, the table build's enqueue, the
state's allocation, the chunk loop's capture and build).  Nothing where the
program records no ``pw.solve`` span."""

from pwbench.harness.spans import per_span

SETUP = tuple(f"pw.solve.{p}" for p in ("required_depth", "compile", "tables", "init_state", "capture"))


def read(run):
    us = per_span(run.trace, "pw.solve", SETUP)
    return None if us is None else us * 1e-3
