"""The framed render kernel's share of its bytes roofline in the traced
slice: its bytes (``bounds/render.py``) at the published bandwidth, over
its mean traced launch, in %.  Nothing where the slice holds no launch of
it."""

from pwbench.bounds import render


def read(run):
    t, bw = run.trace, run.peaks.get("hbm_bytes_per_s")
    if t is None or not bw:
        return None
    launches = t.kernels("render_onehot_framed_kernel")
    if not launches:
        return None
    sh = run.window["shapes"]
    mean_s = sum(e - s for _, s, e in launches) / len(launches) * 1e-6
    n_bytes = render.framed_bytes_per_launch(sh["batch"], *sh["frame"], sh["objects"], sh["table_bytes"])
    return 100.0 * n_bytes / bw / mean_s
