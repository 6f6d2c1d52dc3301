"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their build.

``LAUNCHES`` counts the launches of each kernel: a wrapper calls
:func:`count_launch` where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels.  Several threads launch
kernels (the fleet's device worker, the portfolio's table prefetch), and
``LAUNCHES[name] += 1`` is a read and a write, so the update is made under a
lock.
"""

import threading
from collections import Counter

LAUNCHES: Counter = Counter()
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
