"""Mean search iterations of the window's solved requests
(``PlanResult.iterations``, the program's counter)."""


def read(run):
    it = run.window.get("iterations", [])
    return sum(it) / len(it) if it else None
