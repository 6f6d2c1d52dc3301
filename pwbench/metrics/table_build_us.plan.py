"""Device microseconds of the RGD table build per traced request: the
wavefront kernel (``kernels/wavefront.cu``: its mask packing and its
distance fields, ``ops/rgd.py`` ``build_rgd_tables``) summed over the
traced slice, over the slice's requests.  Nothing when the trace holds no
wavefront launch."""

TABLE_BUILD_KERNELS = ("pack_masks_kernel", "wavefront_kernel")


def read(run):
    t, requests = run.trace, run.traced.get("requests")
    if t is None or not requests:
        return None
    launches = t.kernels(*TABLE_BUILD_KERNELS)
    if not launches:
        return None
    return sum(e - s for _, s, e in launches) / requests
