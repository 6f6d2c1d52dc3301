"""Device microseconds of the search iteration's kernels per traced loop
body, from the traced slice: the eight kernels of ``_iterate`` (select,
expand, fingerprint + dedup + insert, novelty score and absorb, RGD,
compaction, append), summed, over the bodies traced, one select a body.
(torch 2.11's profiler traces every body of the chunk loop's WHILE node; an
older one traced only the first body of each launch, which this reads as
well.)  Nothing when the trace holds no select."""

ITERATION_KERNELS = ("select_kernel", "expand_kernel", "expand_wide_kernel", "fingerprint_dedup_insert_kernel",
                     "novelty_score_kernel", "novelty_score_wide_kernel", "novelty_absorb_kernel",
                     "novelty_absorb_wide_kernel", "rgd_kernel_d0", "rgd_kernel_deep", "rgd_wide_kernel_d0",
                     "rgd_wide_kernel_deep", "compact_kernel", "append_kernel")


def read(run):
    if run.trace is None:
        return None
    bodies = len(run.trace.kernels("select_kernel"))
    if not bodies:
        return None
    return sum(e - s for _, s, e in run.trace.kernels(*ITERATION_KERNELS)) / bodies
