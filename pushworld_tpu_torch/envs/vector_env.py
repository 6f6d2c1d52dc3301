"""The batched PushWorld environment on tensors.

Port of the JAX package's ``envs/vector_env.py``.  Reward/termination
semantics match the reference Gym environment exactly (reference:
python3/src/pushworld/gym_env.py:210-226):

- terminal reward +10 when the goal is reached,
- otherwise ``delta(achieved goals) - 0.01`` per step,
- truncation after ``max_steps`` steps since the last reset.

Unlike the reference (one Python env stepping one puzzle with host-side
rendering), this environment advances B independent rollouts per call on one
device.  Observations are the compact state tensor;
:mod:`pushworld_tpu_torch.ops.render` renders image observations from it on
the same device when they are wanted.

Auto-reset: when an episode terminates or truncates, the next ``step``
starts from the initial state again (standard batched-env convention; the
reference requires a manual ``reset``, which the Gym/dm_env wrappers in
:mod:`pushworld_tpu_torch.envs.gym_env` /
:mod:`pushworld_tpu_torch.envs.dm_env_impl` preserve).

On the card a step is one launch of ``kernels/env.cu``
(:func:`pushworld_tpu_torch.ops.step.env_step`), and so is a block of T
steps whose actions are given ahead (:meth:`VectorEnv.step` with (T, B)
actions: :func:`pushworld_tpu_torch.ops.step.env_steps`); on the CPU the
plain version runs, one step a call.

Random numbers come from a ``torch.Generator`` that the caller passes.  A
CPU generator and a CUDA generator give different streams from one seed, and
neither gives the JAX package's: pass ``puzzle_idx`` and the actions to get
the same rollout on two devices.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.device import DeviceLike
from pushworld_tpu_torch.ops.step import (  # noqa: F401 (the rewards: the JAX module's names)
    STEP_PENALTY,
    TERMINAL_REWARD,
    count_achieved_goals,
    env_step,
    env_steps,
    fused_block,
)


@dataclass(frozen=True)
class EnvState:
    """Batched environment state: tensors on the environment's device."""

    positions: torch.Tensor  # int32 (B, N, 2)
    steps: torch.Tensor  # int32 (B,)
    achieved: torch.Tensor  # int32 (B,) goals achieved at current positions
    puzzle_idx: torch.Tensor  # int32 (B,) index into the puzzle batch


class VectorEnv:
    """B lockstep rollouts over a batch of compiled puzzles.

    Args:
        puzzles: a stacked :class:`CompiledPuzzle` with leading puzzle axis P
            (or a single unstacked puzzle); numpy or tensor fields.
        max_steps: truncation horizon (None = no truncation).
        device: where the tables and every state live.

    With a stacked puzzle each rollout's ``puzzle_idx`` is a leading index
    into the stacked tables; no table is copied per rollout.
    """

    def __init__(
        self, puzzles: CompiledPuzzle, max_steps: Optional[int] = None, device: DeviceLike = "cuda"
    ):
        self.puzzles = puzzles.to(device)
        self.device = self.puzzles.init_state.device
        self._single = self.puzzles.init_state.dim() == 2
        self.max_steps = max_steps
        self.num_puzzles = 1 if self._single else int(self.puzzles.init_state.shape[0])
        # Per puzzle: the initial state and the goals it already achieves.
        init = self.puzzles.init_state
        self._init_pos = init[None] if self._single else init  # (P, N, 2)
        pidx = None if self._single else torch.arange(self.num_puzzles, device=self.device)
        self._init_achieved = count_achieved_goals(self.puzzles, self._init_pos, pidx).to(torch.int32)

    def _pidx(self, puzzle_idx: torch.Tensor) -> Optional[torch.Tensor]:
        """What the step functions take as ``puzzle_idx``."""
        return None if self._single else puzzle_idx

    def reset(
        self,
        generator: Optional[torch.Generator],
        batch_size: int,
        puzzle_idx: Optional[torch.Tensor] = None,
    ) -> EnvState:
        """Starts ``batch_size`` rollouts, each from its puzzle's initial state.

        ``puzzle_idx`` (B,) names each rollout's puzzle; without it one is
        drawn per rollout from ``generator``, on the generator's device (so
        the draw depends on where the generator lives)."""
        if puzzle_idx is None:
            if generator is None:
                raise ValueError("reset needs a generator or puzzle_idx")
            puzzle_idx = torch.randint(
                0, self.num_puzzles, (batch_size,), generator=generator, device=generator.device
            )
        idx = torch.as_tensor(puzzle_idx).to(device=self.device, dtype=torch.int32)
        if idx.shape != (batch_size,):
            raise ValueError(f"puzzle_idx must have shape ({batch_size},), got {tuple(idx.shape)}")
        # Checked on the host: an index outside a CUDA table is a device fault.
        if batch_size and not bool(((idx >= 0) & (idx < self.num_puzzles)).all()):
            raise ValueError(f"puzzle_idx outside [0, {self.num_puzzles})")
        return self.start(idx)

    def start(self, puzzle_idx: torch.Tensor) -> EnvState:
        """:meth:`reset`'s state for ``puzzle_idx`` (B,) int32 on the
        environment's device, UNCHECKED: an index outside [0, P) is a device
        fault on the card.  It reads nothing back, so a CUDA graph may
        capture it (``envs/throughput.py`` does, after one :meth:`reset`)."""
        return EnvState(
            positions=self._init_pos.index_select(0, puzzle_idx),
            steps=torch.zeros(puzzle_idx.shape, dtype=torch.int32, device=self.device),
            achieved=self._init_achieved.index_select(0, puzzle_idx),
            puzzle_idx=puzzle_idx,
        )

    def step(self, state: EnvState, actions: torch.Tensor, reward_acc: Optional[torch.Tensor] = None,
             out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
        """Advances every rollout by one action ((B,) ints in [0, 4)), or by
        a block of T actions ((T, B), row t the actions of step t).

        Returns ``(next_state, obs_positions, reward, terminated, truncated)``
        with auto-reset applied to ``next_state`` (the returned observation /
        reward reflect the pre-reset transition); after a block, those of
        its last step.  One :func:`env_step`: on the card, one kernel
        launch.  A block on the card of at most 32 objects is one launch too
        (:func:`env_steps`, where :func:`fused_block` holds), else T calls
        of :func:`env_step`, one a row; the results are the same.
        ``reward_acc`` ((B,) float32 or None): each rollout's running reward
        total, to which each step adds its reward in place (:func:`env_step`).
        ``out`` (one step only): (B,) reward, terminated and truncated
        tensors that the step writes and returns (:func:`env_step`).
        """
        tail = (self._pidx(state.puzzle_idx), self._init_pos, self._init_achieved, self.max_steps)
        if isinstance(actions, torch.Tensor) and actions.dim() == 2:
            if actions.shape[0] == 0:
                raise ValueError("a block of actions needs at least one step")
            if out is not None:
                raise ValueError("out takes one step's outputs, not a block's")
            if fused_block(self.device, self.puzzles.n):
                out = env_steps(self.puzzles, state.positions, actions, state.steps, state.achieved, *tail,
                                reward_acc=reward_acc)
            else:
                out = (state.positions, state.steps, state.achieved)
                for a in actions:
                    out = env_step(self.puzzles, out[0], a, out[1], out[2], *tail, reward_acc=reward_acc)
        else:
            out = env_step(self.puzzles, state.positions, actions, state.steps, state.achieved, *tail,
                           reward_acc=reward_acc, out=out)
        positions, steps, achieved, next_pos, reward, terminated, truncated = out
        new_state = EnvState(positions=positions, steps=steps, achieved=achieved, puzzle_idx=state.puzzle_idx)
        return new_state, next_pos, reward, terminated, truncated

    def rollout(
        self,
        generator: torch.Generator,
        policy_fn: Callable[[torch.Generator, torch.Tensor], torch.Tensor],
        batch_size: int,
        horizon: int,
    ) -> Tuple[EnvState, Tuple[torch.Tensor, torch.Tensor]]:
        """Runs ``horizon`` steps with ``policy_fn(generator, positions) ->
        actions``.

        Returns the final env state and per-step (reward, terminated) stacked
        over time, (horizon, B) each.  A Python loop of ``step`` calls:
        ``policy_fn`` is the caller's, and may read the host (JAX's
        ``lax.scan`` needs it traceable).
        """
        env_state = self.reset(generator, batch_size)
        rewards, terms = [], []
        for _ in range(horizon):
            actions = policy_fn(generator, env_state.positions)
            env_state, _, reward, terminated, _ = self.step(env_state, actions)
            rewards.append(reward)
            terms.append(terminated)
        return env_state, (torch.stack(rewards), torch.stack(terms))
