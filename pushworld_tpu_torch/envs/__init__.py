"""The RL-environment half: the batched ``VectorEnv``, reference policies,
the throughput measurement, and the Gym / dm_env wrappers.

Nothing is imported here: ``gym_env`` and ``dm_env_impl`` need their optional
packages (``gymnasium`` or ``gym``; ``dm_env``), the other modules do not.
"""
