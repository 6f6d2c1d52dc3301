"""The byte counts of ``bounds/`` at small shapes, worked by hand."""

from pwbench.bounds import env_step


def test_env_step_bytes():
    # 2 rollouts of 3 movables, int32 actions, one puzzle: read 24 + 4 + 4 + 4 + 4,
    # written 48 + 4 * 4 + 2, a rollout.
    assert env_step.bytes_per_launch(2, 3) == 2 * (40 + 66)
    # Stacked puzzles add each rollout's 4-byte index; int64 actions 4 more bytes.
    assert env_step.bytes_per_launch(2, 3, action_bytes=8, stacked=True) == 2 * (48 + 66)
    assert env_step.bytes_per_launch(0, 3) == 0


def test_full_size_step_of_the_rollout_cell():
    # rollout.level0: 4,096 stacked rollouts of 4 movables (the pool's most), int32 actions:
    # read 32 + 4 * 5, written 64 + 4 * 4 + 2, a rollout.
    assert env_step.bytes_per_launch(4096, 4, stacked=True) == 4096 * (52 + 82)
