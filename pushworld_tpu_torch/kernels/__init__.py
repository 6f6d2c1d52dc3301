"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their build.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from collections import Counter

LAUNCHES: Counter = Counter()
