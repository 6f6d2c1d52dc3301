"""pushworld_tpu_torch: the PushWorld planner in PyTorch for NVIDIA Hopper.

The port of ``pushworld_tpu`` (JAX), module for module, with the same
semantics:

- ``core``:    the ``.pwp`` puzzle oracle and its compilation into dense
               collision tables (numpy; ``CompiledPuzzle.to(device)`` gives
               the tensors).
- ``ops``:     batched dynamics, the visited set, novelty, distance fields and
               the RGD heuristic as plain functions on tensors.
- ``kernels``: the CUDA C++ sources of the hand-written Hopper kernels and
               their build (``nvcc`` at first use).
- ``native``:  the C++ serial planner (``planner.cc``, built by the host
               compiler at first use) and its ctypes bridge.
- ``search``:  the batched best-first planner, the host planner, the
               top-level API (``solve_puzzle``, ``plan_puzzles`` with its
               native + device portfolio) and the fleet executor.

Every entry point takes ``device`` and defaults to ``"cuda"``; ``"cpu"`` runs
the plain PyTorch versions of the kernels (what the tests use).  This package
imports neither JAX nor ``pushworld_tpu``.
"""

__version__ = "0.1.0"

from pushworld_tpu_torch.core.puzzle import Actions, Puzzle  # noqa: F401
