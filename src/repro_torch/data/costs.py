"""Request-cost tracking for the serving frontend.

A copy of ``KeyedCostTracker`` and ``percentile`` from
``repro/data/costs.py``: an EWMA of cost per request shape, which
``BatchingFrontend`` uses to route predicted-expensive request groups to
its slow lane, and the percentile helper behind its p99 assembly wait.
"""
from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np


class KeyedCostTracker:
    """EWMA cost per hashable key (the serving frontend's request shapes).

    A key is slow when its estimate is at least ``threshold`` times the
    median over the other known keys.  The table is a dict, because
    request shapes are few and arbitrary.
    """

    def __init__(self, *, alpha: float = 0.3, threshold: float = 4.0,
                 min_records: int = 4):
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.min_records = int(min_records)
        self._ewma: Dict[Hashable, float] = {}
        self._lock = threading.Lock()
        self.records = 0

    def record(self, key: Hashable, seconds: float) -> None:
        if seconds < 0:
            return
        with self._lock:
            prev = self._ewma.get(key)
            self._ewma[key] = seconds if prev is None \
                else (1 - self.alpha) * prev + self.alpha * seconds
            self.records += 1

    def predict(self, key: Hashable) -> Optional[float]:
        with self._lock:
            return self._ewma.get(key)

    def is_slow(self, key: Hashable) -> bool:
        with self._lock:
            if self.records < self.min_records or len(self._ewma) < 2:
                return False
            est = self._ewma.get(key)
            if est is None:
                return False
            # median of the OTHER keys: serving mixes often have only a
            # couple of shapes, and a self-inclusive median would let one
            # expensive shape drag the reference up past its own cut
            others = [v for k, v in self._ewma.items() if k != key]
            med = float(np.median(others))
            return med > 0 and est >= self.threshold * med

    def __getstate__(self):
        with self._lock:
            state = self.__dict__.copy()
            state["_ewma"] = dict(self._ewma)
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def state_dict(self) -> dict:
        with self._lock:
            return {"alpha": self.alpha, "threshold": self.threshold,
                    "records": self.records,
                    "keys": [list(k) if isinstance(k, tuple) else k
                             for k in self._ewma],
                    "values": list(self._ewma.values())}

    def load_state_dict(self, d: dict) -> None:
        with self._lock:
            self.alpha = float(d.get("alpha", self.alpha))
            self.threshold = float(d.get("threshold", self.threshold))
            self.records = int(d.get("records", 0))
            self._ewma = {
                (tuple(k) if isinstance(k, list) else k): float(v)
                for k, v in zip(d.get("keys", []), d.get("values", []))}


def percentile(samples: Sequence[float], q: float) -> float:
    """Small helper for latency reservoirs (serving p99)."""
    arr: List[float] = [float(s) for s in samples]
    if not arr:
        return 0.0
    return float(np.quantile(np.asarray(arr), q))
