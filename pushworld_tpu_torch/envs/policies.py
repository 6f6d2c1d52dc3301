"""Reference policies for batched rollouts.

Port of the JAX package's ``envs/policies.py``.  The greedy goal-distance
policy: each rollout picks the action minimizing the depth-0 RGD estimate of
the successor state, breaking ties randomly.
"""

import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.ops.rgd import RGDTables, rgd_heuristic
from pushworld_tpu_torch.ops.step import step


def successor_values(cp: CompiledPuzzle, tables: RGDTables, positions: torch.Tensor) -> torch.Tensor:
    """(B, 4) float32: the depth-0 RGD estimate of each action's successor.

    positions: (B, N, 2) int32 states of one puzzle; ``cp`` and ``tables``
    hold tensors on the positions' device."""
    B = positions.shape[0]
    actions = torch.arange(4, device=positions.device)[:, None]  # (4, 1)
    nxt = step(cp, positions[None].expand(4, *positions.shape), actions)  # (4, B, N, 2)
    h = rgd_heuristic(tables, nxt.reshape(4 * B, *positions.shape[1:]), max_depth=0)
    return h.reshape(4, B).T


def greedy_goal_distance_actions(
    cp: CompiledPuzzle, tables: RGDTables, generator: torch.Generator, positions: torch.Tensor
) -> torch.Tensor:
    """(B,) int32 actions minimizing the successor depth-0 RGD estimate.

    Ties are broken randomly: uniform noise below the heuristic's
    resolution, drawn from ``generator`` on the generator's device."""
    h = successor_values(cp, tables, positions)
    noise = torch.rand(h.shape, generator=generator, device=generator.device) * 0.5
    return torch.argmin(h + noise.to(h.device), dim=1).to(torch.int32)


def make_greedy_policy(cp: CompiledPuzzle, tables: RGDTables):
    """Policy closure compatible with :meth:`VectorEnv.rollout`."""

    def policy(generator, positions):
        return greedy_goal_distance_actions(cp, tables, generator, positions)

    return policy
