"""OpenAI Gym wrapper with reference-identical semantics.

reference: python3/src/pushworld/gym_env.py:32-240.  Observation = rendered
RGB float32 [0, 1] image center-padded to the maximum puzzle size; reward =
+10 terminal, else delta(achieved goals) - 0.01 per step; truncation at
``max_steps``; reset picks a random puzzle with a seeded RNG (default 123).

Works with either ``gymnasium`` or classic ``gym`` (whichever imports).
"""

import random
from typing import Any, Dict, Optional, Tuple

import numpy as np

try:  # gymnasium first, then classic gym
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym

from pushworld_tpu_torch.core.puzzle import (
    DEFAULT_BORDER_WIDTH,
    DEFAULT_PIXELS_PER_CELL,
    NUM_ACTIONS,
    Puzzle,
)
from pushworld_tpu_torch.envs.env_utils import load_env_puzzles, render_observation_padded


class PushWorldEnv(gym.Env):
    """A Gym environment over a file or directory of ``.pwp`` puzzles."""

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

        # Fixed arbitrary seed for reproducibility (reference: gym_env.py:109).
        self._random_generator = random.Random(123)
        self._current_puzzle: Optional[Puzzle] = None
        self._current_state = None

        self._action_space = gym.spaces.Discrete(NUM_ACTIONS)
        obs_shape = render_observation_padded(
            self._puzzles[0],
            self._puzzles[0].initial_state,
            self._max_cell_height,
            self._max_cell_width,
            self._pixels_per_cell,
            self._border_width,
        ).shape
        self._observation_space = gym.spaces.Box(
            low=0.0, high=1.0, shape=obs_shape, dtype=np.float32
        )

    @property
    def action_space(self):
        return self._action_space

    @action_space.setter
    def action_space(self, value):
        self._action_space = value

    @property
    def observation_space(self):
        return self._observation_space

    @observation_space.setter
    def observation_space(self, value):
        self._observation_space = value

    @property
    def metadata(self) -> Dict[str, Any]:
        return {"render_modes": ["rgb_array"]}

    @metadata.setter
    def metadata(self, value):
        pass

    @property
    def render_mode(self) -> str:
        return "rgb_array"

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

    def reset(
        self, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[np.ndarray, dict]:
        if seed is not None:
            self._random_generator = random.Random(seed)
        self._current_puzzle = self._random_generator.choice(self._puzzles)
        self._current_state = self._current_puzzle.initial_state
        self._current_achieved_goals = self._current_puzzle.count_achieved_goals(
            self._current_state
        )
        self._steps = 0
        return self._observe(), {"puzzle_state": self._current_state}

    def step(self, action: int):
        if not self._action_space.contains(action):
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
        return observation, reward, terminated, truncated, {
            "puzzle_state": self._current_state
        }

    def render(self, mode: str = "rgb_array") -> np.ndarray:
        assert mode == "rgb_array", "mode must be rgb_array."
        return self._current_puzzle.render(
            self._current_state,
            border_width=self._border_width,
            pixels_per_cell=self._pixels_per_cell,
        )
