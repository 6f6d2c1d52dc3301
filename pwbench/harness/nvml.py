"""What ``nvidia-smi`` reads of the card: NVML's utilization, sampled, and
the power limit.

NVML's ``utilization.gpu`` is the share of its last sample period (1/6 s to
1 s) in which a kernel ran on the card; it covers a whole window at no cost
to the traced slice.  :class:`Sampler` reads it every 100 ms in a child
process for as long as it runs, and keeps the readings with the host time
at which they arrived.
"""

import subprocess
import threading
import time
from typing import List, Tuple


class Sampler:
    def __init__(self, index: int = 0, period_ms: int = 100):
        self.samples: List[Tuple[float, float]] = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--id={index}", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             f"--loop-ms={period_ms}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                self.samples.append((time.perf_counter(), float(line.strip())))
            except ValueError:
                continue

    def stop(self) -> None:
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)

    def between(self, start: float, end: float) -> List[float]:
        """Readings that arrived in [start, end] (host ``perf_counter``)."""
        return [u for t, u in self.samples if start <= t <= end]


def power_limit(index: int = 0) -> str:
    """The card's power limit, as ``nvidia-smi`` reads it (a card set below
    700 W runs slower under load)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"
