"""Memory monitoring / overflow guard (the "Monitoring" box in Fig. 1).

The paper's Algorithm 1 breaks the inner prefetch loop when "Memory Overflow
occur[s]".  We guard two ways:

* an *estimate*: outstanding-batch bytes (worker queues + device prefetch
  buffers) against a budget — cheap, deterministic, works in virtual time;
* a *real* RSS watermark read from /proc/self/statm — catches actual
  blow-ups during wall-clock measurement runs.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional


class MemoryOverflow(RuntimeError):
    """Raised when a (nWorker, nPrefetch) trial exceeds the memory budget."""


def process_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):  # pragma: no cover
        return 0


def host_ram_bytes() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):  # pragma: no cover
        return 64 << 30


@dataclasses.dataclass
class MemoryBudget:
    """Budget for loader-owned memory (not the whole process)."""
    loader_bytes: int
    host_ram: int = dataclasses.field(default_factory=host_ram_bytes)
    rss_fraction: float = 0.92     # real watermark: RSS vs host RAM


class MemoryMonitor:
    def __init__(self, budget: Optional[MemoryBudget] = None,
                 check_rss: bool = False):
        self.budget = budget
        self.check_rss = check_rss
        self._lock = threading.Lock()
        self._outstanding = 0
        self.peak = 0
        self.overflowed = False

    def reserve(self, nbytes: int) -> None:
        with self._lock:
            self._outstanding += nbytes
            self.peak = max(self.peak, self._outstanding)
            if (self.budget is not None
                    and self._outstanding > self.budget.loader_bytes):
                self.overflowed = True
                raise MemoryOverflow(
                    f"loader footprint {self._outstanding/2**20:.1f}MiB > "
                    f"budget {self.budget.loader_bytes/2**20:.1f}MiB")
        if self.check_rss and self.budget is not None:
            rss = process_rss_bytes()
            if rss > self.budget.rss_fraction * self.budget.host_ram:
                self.overflowed = True
                raise MemoryOverflow(
                    f"RSS {rss/2**30:.2f}GiB > "
                    f"{self.budget.rss_fraction:.0%} of host RAM")

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._outstanding -= nbytes

    @property
    def outstanding(self) -> int:
        return self._outstanding


def estimate_loader_footprint(batch_bytes: float, num_workers: int,
                              prefetch_factor: int,
                              device_prefetch: int = 2) -> float:
    """Static footprint estimate used by the simulator and the overflow
    pre-check: queued batches + per-worker in-flight batch + device buffers."""
    queued = max(1, num_workers) * max(1, prefetch_factor) * batch_bytes
    in_flight = max(1, num_workers) * batch_bytes
    return queued + in_flight + device_prefetch * batch_bytes
