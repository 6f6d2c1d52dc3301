"""Interactive Gym environment demo with matplotlib arrow-key control.

reference behavior: python3/scripts/demo_gym_env.py:30-48.
Usage: ``python -m pushworld_tpu_torch.scripts.demo_gym_env <puzzle.pwp>``.
The port's copy of the JAX package's demo, over the port's wrapper
(``envs/gym_env.py``, host-side: it takes no device).
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Play a PushWorld puzzle (Gym).")
    parser.add_argument("puzzle", help="path of a .pwp file or puzzle directory")
    parser.add_argument("--max-steps", type=int, default=None)
    args = parser.parse_args(argv)

    import matplotlib.pyplot as plt

    from pushworld_tpu_torch.envs.gym_env import PushWorldEnv

    env = PushWorldEnv(args.puzzle, max_steps=args.max_steps)
    obs, _ = env.reset()

    fig, ax = plt.subplots()
    image = ax.imshow(obs)
    ax.set_axis_off()
    status = ax.set_title("arrows: move · r: reset · q: quit")

    key_to_action = {"left": 0, "right": 1, "up": 2, "down": 3}

    def on_key(event):
        nonlocal obs
        if event.key == "q":
            plt.close(fig)
            return
        if event.key == "r":
            obs, _ = env.reset()
            status.set_text("reset")
        elif event.key in key_to_action:
            obs, reward, terminated, truncated, _ = env.step(key_to_action[event.key])
            status.set_text(
                f"reward={reward:+.2f}"
                + (" · SOLVED" if terminated else "")
                + (" · truncated" if truncated else "")
            )
            if terminated or truncated:
                obs, _ = env.reset()
        image.set_data(obs)
        fig.canvas.draw_idle()

    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
