"""dm_env wrapper with reference-identical semantics.

reference: python3/src/pushworld/dm_env.py:35-252.  Notes preserved from the
reference: a ``dm_env.termination`` TimeStep is returned for both goal
achievement *and* truncation (dm_env.py:230-234), and ``render`` returns
float32/255 (dm_env.py:244-251), unlike the Gym wrapper's uint8.
"""

import random
from typing import Optional

import numpy as np

import dm_env
from dm_env import specs

from pushworld_tpu_torch.core.puzzle import (
    DEFAULT_BORDER_WIDTH,
    DEFAULT_PIXELS_PER_CELL,
    NUM_ACTIONS,
    Puzzle,
)
from pushworld_tpu_torch.envs.env_utils import load_env_puzzles, render_observation_padded


class PushWorldEnv(dm_env.Environment):
    """A dm_env environment over a file or directory of ``.pwp`` puzzles."""

    def __init__(
        self,
        puzzle_path: str,
        max_steps: Optional[int] = None,
        border_width: int = DEFAULT_BORDER_WIDTH,
        pixels_per_cell: int = DEFAULT_PIXELS_PER_CELL,
        standard_padding: bool = False,
    ) -> None:
        self._puzzles, self._max_cell_height, self._max_cell_width = load_env_puzzles(
            puzzle_path, border_width, pixels_per_cell, standard_padding
        )
        self._max_steps = max_steps
        self._pixels_per_cell = pixels_per_cell
        self._border_width = border_width

        self._random_generator = random.Random(123)
        self._current_puzzle: Optional[Puzzle] = None
        self._current_state = None

        self._action_space = specs.DiscreteArray(
            num_values=NUM_ACTIONS, dtype=int, name="action"
        )
        obs_shape = render_observation_padded(
            self._puzzles[0],
            self._puzzles[0].initial_state,
            self._max_cell_height,
            self._max_cell_width,
            self._pixels_per_cell,
            self._border_width,
        ).shape
        self._observation_space = specs.BoundedArray(
            shape=obs_shape, dtype=np.float32, name="board", minimum=0.0, maximum=1.0
        )

    def observation_spec(self) -> specs.BoundedArray:
        return self._observation_space

    def action_spec(self) -> specs.DiscreteArray:
        return self._action_space

    @property
    def current_puzzle(self):
        return self._current_puzzle

    @property
    def current_state(self):
        return self._current_state

    def _observe(self) -> np.ndarray:
        return render_observation_padded(
            self._current_puzzle,
            self._current_state,
            self._max_cell_height,
            self._max_cell_width,
            self._pixels_per_cell,
            self._border_width,
        )

    def reset(self, seed: Optional[int] = None) -> dm_env.TimeStep:
        if seed is not None:
            self._random_generator = random.Random(seed)
        self._current_puzzle = self._random_generator.choice(self._puzzles)
        self._current_state = self._current_puzzle.initial_state
        self._current_achieved_goals = self._current_puzzle.count_achieved_goals(
            self._current_state
        )
        self._steps = 0
        return dm_env.restart(self._observe())

    def step(self, action: int) -> dm_env.TimeStep:
        try:
            self._action_space.validate(action)
        except ValueError:
            raise ValueError("The provided action is not in the action space.")
        if self._current_state is None:
            raise RuntimeError("reset() must be called before step() can be called.")

        self._steps += 1
        previous_state = self._current_state
        self._current_state = self._current_puzzle.get_next_state(
            self._current_state, action
        )
        observation = self._observe()
        terminated = self._current_puzzle.is_goal_state(self._current_state)
        if terminated:
            reward = 10.0
        else:
            reward = (
                self._current_puzzle.count_achieved_goals(self._current_state)
                - self._current_puzzle.count_achieved_goals(previous_state)
                - 0.01
            )
        truncated = False if self._max_steps is None else self._steps >= self._max_steps
        if terminated or truncated:
            return dm_env.termination(reward, observation)
        return dm_env.transition(reward, observation)

    def render(self, mode: str = "rgb_array") -> np.ndarray:
        assert mode == "rgb_array", "mode must be rgb_array."
        return (
            self._current_puzzle.render(
                self._current_state,
                border_width=self._border_width,
                pixels_per_cell=self._pixels_per_cell,
            ).astype(np.float32)
            / 255
        )
