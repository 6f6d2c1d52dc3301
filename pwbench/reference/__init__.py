"""The benchmark's plain reference of PushWorld, in NumPy.

Written from PushWorld's published semantics (google-deepmind/pushworld:
``python3/src/pushworld/puzzle.py`` for the ``.pwp`` format, the push
dynamics and the goal test, ``gym_env.py`` for the reward schedule) and
from the port's documented one-hot encoding.  It imports nothing of the
program under test, and nothing of JAX: it judges what the program returns.
"""
