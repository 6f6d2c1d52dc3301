"""A short traced slice of a run, reduced to device intervals and host spans.

``record(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activities) inside a host span ``pwbench.window``, and keeps:

- every device interval (kernels, copies, memsets) that lies in the window,
  with its name;
- the host's spans and operations, to say what the host was doing while
  the device sat idle.

A trace that holds no device interval (CUPTI now and then delivers none for
a window) is taken again, up to three traces in all, so ``fn`` must bear
being called again.  Readers take what they need from :class:`Trace`.
"""

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np

Interval = Tuple[str, float, float]  # name, start, end (microseconds)
WINDOW_SPAN = "pwbench.window"


def kernel_base(name: str) -> str:
    """A device event's function name without ``void``, namespaces,
    template arguments or parameters:
    ``void (anonymous namespace)::select_kernel<true>(...)`` -> ``select_kernel``."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", "").strip())
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def union(intervals) -> float:
    """The length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@dataclass
class Trace:
    device: List[Interval]
    host: List[Interval]
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return union((s, e) for _, s, e in self.device) * 1e-6

    def kernels(self, *names: str) -> List[Interval]:
        """Device intervals whose base name is one of ``names``."""
        return [k for k in self.device if kernel_base(k[0]) in names]

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[kernel_base(n)] = by.get(kernel_base(n), 0.0) + (e - s) * 1e-6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time in the window, summed by what the host was
        doing at each gap's middle: the innermost host event there, under
        the innermost benchmark span (``pwbench.*``)."""
        gaps, cur = [], self.start
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.end > cur:
            gaps.append((cur, self.end))
        by: Dict[str, float] = {}
        if not gaps:
            return []
        hs = np.array([h[1] for h in self.host] or [0.0])
        he = np.array([h[2] for h in self.host] or [-1.0])
        length = he - hs
        span = np.array([h[0].startswith("pwbench.") for h in self.host] or [False])
        names = [h[0] for h in self.host]
        mids = np.array([0.5 * (s + e) for s, e in gaps])
        for lo in range(0, len(gaps), 256):
            m = mids[lo: lo + 256, None]
            inside = (hs[None] <= m) & (m <= he[None])
            for j, row in enumerate(inside):
                label = []
                for want in (True, False):
                    sel = np.nonzero(row & (span == want))[0]
                    if len(sel):
                        label.append(names[sel[np.argmin(length[sel])]])
                    else:
                        label.append(WINDOW_SPAN if want else "no host op")
                s, e = gaps[lo + j]
                key = " / ".join(label)
                by[key] = by.get(key, 0.0) + (e - s) * 1e-6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def record(fn: Callable[[], None], attempts: int = 3) -> Trace:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        window = [e for e in events if e.name == WINDOW_SPAN]
        if not window:
            continue
        start, end = window[0].time_range.start, window[0].time_range.end
        # The device's side of a host span (``record_function``) is no work.
        device = [(e.name, max(e.time_range.start, start), min(e.time_range.end, end)) for e in events
                  if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
                  and e.time_range.end > start and e.time_range.start < end
                  and not e.name.startswith("pwbench.") and not getattr(e, "is_user_annotation", False)]
        if device:
            host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CPU and e.name != WINDOW_SPAN
                    and e.time_range.end > start and e.time_range.start < end]
            return Trace(device, host, start, end)
    raise RuntimeError(f"torch.profiler recorded no device interval in {attempts} traces")
