"""Environment steps (rollouts x steps of every replay) over the whole
window, which ends when the card has finished its last replay."""


def read(run):
    w = run.window
    return w["steps"] / w["window_s"] if w.get("window_s") else None
