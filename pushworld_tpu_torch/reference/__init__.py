"""Plain references that the port's device paths are held to in tests.

Each module is written from PushWorld's published semantics with plain
``torch`` and the host puzzle oracle (``core.puzzle.Puzzle``), and imports
nothing of ``kernels``, ``ops`` or JAX.
"""
