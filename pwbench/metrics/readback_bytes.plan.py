"""Bytes copied from the card to the host per solve in the traced slice: the
program's ``COUNTERS["d2h_bytes"]`` (its status reads and the plan's
history read-back) over ``COUNTERS["solves"]``.  Nothing where the program
has no such counters."""

from pwbench.harness.spans import per_solve


def read(run):
    return per_solve("d2h_bytes")
