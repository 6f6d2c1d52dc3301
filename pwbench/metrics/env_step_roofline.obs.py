"""The one-step environment kernel's share of its bytes roofline in the
traced slice of the trajectory rollout: one step's bytes
(``bounds/env_step.py``, right for a one-step launch) at the published
bandwidth, over its mean traced launch, in %."""

from pwbench.bounds import env_step


def read(run):
    t, bw = run.trace, run.peaks.get("hbm_bytes_per_s")
    if t is None or not bw:
        return None
    launches = t.kernels("env_step_kernel")
    if not launches:
        return None
    sh = run.window["shapes"]
    mean_s = sum(e - s for _, s, e in launches) / len(launches) * 1e-6
    n_bytes = env_step.bytes_per_launch(sh["batch"], sh["objects"], sh["action_bytes"], sh["stacked"])
    return 100.0 * n_bytes / bw / mean_s
