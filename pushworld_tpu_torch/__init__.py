"""pushworld_tpu_torch: PushWorld planning and RL environments in PyTorch for NVIDIA Hopper.

The port of ``pushworld_tpu`` (JAX), module for module, with the same
semantics:

- ``core``:    the ``.pwp`` puzzle oracle with its pixel renderer, and its
               compilation into dense collision tables, one puzzle or a
               stacked batch (numpy; ``CompiledPuzzle.to(device)`` gives the
               tensors).
- ``ops``:     batched dynamics, the visited set, novelty, the device graph
               ops (``graphs.build_reachability``, ``all_pairs_distances``
               and ``distance_to_targets`` through the wavefront kernel),
               the RGD heuristic and the cell renderers (``render``) as plain
               functions on tensors.
- ``kernels``: the CUDA C++ sources of the hand-written Hopper kernels and
               their build (``nvcc`` at first use).
- ``native``:  the C++ serial planner (``planner.cc``, built by the host
               compiler at first use) and its ctypes bridge.
- ``search``:  the batched best-first planner, the host planner, the
               top-level API (``solve_puzzle``, ``plan_puzzles`` with its
               native + device portfolio) and the fleet executor.
- ``envs``:    the batched ``VectorEnv`` (``vector_env``), the greedy
               goal-distance policy (``policies``), the env throughput
               measurement (``throughput``) and the Gym / dm_env wrappers
               (``gym_env``, ``dm_env_impl``: the only modules that need
               ``gymnasium`` or ``dm_env``, and nothing imports them for you).
- ``parallel``: over ``torch.distributed`` (NCCL on the card, gloo on the
               CPU): process meshes, puzzle-sharded groups
               (``solve_group``), the frontier-sharded search of one puzzle
               and multi-process planning; ``entry`` holds the batched step
               and the multi-chip dry run.
- ``tools``:   the generator with its solvability filter, symmetry
               transforms, the benchmark harness, PDDL / SAS export, plots
               and previews; ``scripts.tools_cli`` is their CLI.

Every entry point takes ``device`` and defaults to ``"cuda"``; ``"cpu"`` runs
the plain PyTorch versions of the kernels (what the tests use).  This package
imports neither JAX nor ``pushworld_tpu``.
"""

__version__ = "0.1.0"

from pushworld_tpu_torch.core.puzzle import Actions, Puzzle  # noqa: F401
