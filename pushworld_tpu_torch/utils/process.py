"""Subprocess execution with CPU-time and memory rlimits.

The port's copy of the JAX package's ``utils/process.py``.
reference behavior: python3/src/pushworld/utils/process.py:26-84 — rlimit
caps installed in a preexec hook; CPU time measured via
``getrusage(RUSAGE_CHILDREN)`` deltas.  Used for running external planners
(e.g. Fast Downward) under benchmark budgets; the in-process device planner
enforces budgets between search chunks instead.
"""

import resource
import subprocess
from typing import List, Optional, Tuple


def get_children_cpu_time() -> float:
    """Total CPU time (user + system) consumed by reaped child processes."""
    usage = resource.getrusage(resource.RUSAGE_CHILDREN)
    return usage.ru_utime + usage.ru_stime


def run_process(
    command: List[str],
    time_limit: Optional[float] = None,
    memory_limit: Optional[int] = None,
) -> Tuple[str, float]:
    """Runs ``command``; returns (stdout, child CPU seconds).

    Args:
        time_limit: CPU-seconds cap (RLIMIT_CPU) for the child.
        memory_limit: address-space cap in bytes (RLIMIT_AS) for the child.

    On limit violation the child is killed by the OS; stdout contains
    whatever was produced (an empty stdout conventionally indicates a
    timeout — reference: benchmark_rgd.py:94-97).
    """

    def set_limits():
        if time_limit is not None:
            limit = int(time_limit) + 1
            resource.setrlimit(resource.RLIMIT_CPU, (limit, limit))
        if memory_limit is not None:
            resource.setrlimit(resource.RLIMIT_AS, (memory_limit, memory_limit))

    cpu_before = get_children_cpu_time()
    proc = subprocess.Popen(
        command,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        preexec_fn=set_limits,
    )
    out = proc.communicate()[0].decode("utf-8")
    cpu_time = get_children_cpu_time() - cpu_before
    if time_limit is not None:
        cpu_time = min(cpu_time, time_limit)
    return out, cpu_time
