"""The card's idle share through the whole window, 100 less the mean of
NVML's ``utilization.gpu`` readings (``harness/nvml.py``); the traced
slice's union of device intervals (``busy_s`` / ``window_s``) covers only
its 8 requests."""


def read(run):
    u = run.utilization
    return 100.0 - sum(u) / len(u) if u else None
