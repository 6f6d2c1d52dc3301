"""Growth of the caching allocator's reserved device memory per solve in the
traced slice, in MiB: the program's ``COUNTERS["reserved_growth_bytes"]``
(each solve's end less its start, where positive) over
``COUNTERS["solves"]``.  Nothing where the program has no such counters."""

from pwbench.harness.spans import per_solve


def read(run):
    b = per_solve("reserved_growth_bytes")
    return None if b is None else b / 2**20
