"""Puzzles solved with a plan, over the whole window (host clock): the
window ends when its last request returns."""


def read(run):
    w = run.window
    return w["solved"] / w["window_s"] if w.get("window_s") else None
