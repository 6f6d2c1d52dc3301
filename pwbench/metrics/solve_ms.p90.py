"""The 90th percentile of the window's solved requests' latencies, call to
return with a device synchronisation, in ms: ``statistics.quantiles``'
inclusive method, which interpolates between the two nearest ranks."""

import statistics


def read(run):
    lat = run.window.get("latencies_s", [])
    if len(lat) < 2:
        return 1e3 * lat[0] if lat else None
    return 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[8]
