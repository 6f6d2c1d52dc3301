"""The window's lockstep steps x the bytes a step must move (the
environment step's, ``bounds/env_step.py``) over the window and the card's
published memory bandwidth, in %."""

from pwbench.bounds import env_step


def read(run):
    w, bw = run.window, run.peaks.get("hbm_bytes_per_s")
    if not bw or not w.get("window_s"):
        return None
    sh = w["shapes"]
    n_bytes = env_step.bytes_per_launch(sh["batch"], sh["objects"], sh["action_bytes"], sh["stacked"])
    return 100.0 * n_bytes * w["replays"] * w["horizon"] / w["window_s"] / bw
