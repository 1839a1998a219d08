"""Per-sample cost tracking: the signal behind the dual-lane slow path.

Heavy-tailed preprocessing is the one failure mode every tuned
configuration shares: with ``ordered=True`` the reorder window parks every
fast batch behind a single slow decode, so goodput collapses regardless of
(workers, prefetch, locality, cache).  The fix (DESIGN.md §9) needs a
*prediction*: which items will be slow next time?  This module provides it.

``SampleCostTracker`` keeps an EWMA of per-item decode/IO wall time, fed by
the worker pools (one ``record(indices, seconds)`` per collated batch) and
read at dispatch time (``is_slow(indices)``) to route predicted-slow
batches to the slow lane.  Batches only measure an aggregate, so the
recorded time is attributed *proportionally to current predictions*
(EM-style): a known-slow item absorbs the batch's excess instead of
smearing it over its fast neighbours — after a couple of epochs the
per-item estimates separate cleanly even though no per-item timer ever ran.

Buckets: per-item by default; datasets beyond ``max_slots`` items fall
back to chunk-id buckets (``idx // bucket``) so the table stays a few
hundred KB regardless of dataset size.  The whole tracker is plain numpy +
scalars: picklable, checkpointable (``state_dict``/``load_state_dict``),
and cheap enough to update on the hot path.

``KeyedCostTracker`` is the serving-side analogue: an EWMA per hashable
request key (e.g. ``(prompt_len, max_new_tokens)``) used by the
``BatchingFrontend`` to segregate expensive request groups so cheap
requests keep their p99 (DESIGN.md §9).
"""
from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np


class SampleCostTracker:
    """EWMA per-item (or per-bucket) preprocessing cost, with a slow test.

    ``threshold``: an item is predicted slow when its estimated cost is at
    least ``threshold`` times the median estimated cost of everything
    observed so far; a batch is slow when any member is.  Until
    ``min_records`` batches were recorded nothing is ever called slow —
    a cold tracker must not route traffic on noise.
    """

    def __init__(self, num_items: int, *, bucket: Optional[int] = None,
                 alpha: float = 0.3, alpha_down: float = 0.8,
                 threshold: float = 4.0, outlier_mult: float = 2.0,
                 min_records: int = 8, max_slots: int = 1 << 16):
        self.num_items = max(1, int(num_items))
        if bucket is None:
            bucket = max(1, -(-self.num_items // max_slots))
        self.bucket = max(1, int(bucket))
        self.alpha = float(alpha)
        self.alpha_down = float(alpha_down)
        self.threshold = float(threshold)
        self.outlier_mult = float(outlier_mult)
        self.min_records = int(min_records)
        n_slots = -(-self.num_items // self.bucket)
        self._ewma = np.full(n_slots, np.nan, dtype=np.float64)
        self._lock = threading.Lock()
        self._mean = 0.0              # running EWMA of per-item cost
        self._median = 0.0            # cached; refreshed every few records
        self._median_stale = True
        self._median_records = 0      # records at the last refresh
        self.records = 0              # record() calls (one per batch)
        self.items_seen = 0
        self.slow_batches = 0         # batches routed to the slow lane

    # ---- recording ---------------------------------------------------------
    def _slots(self, indices) -> np.ndarray:
        idx = np.asarray(indices, dtype=np.intp).reshape(-1)
        return idx // self.bucket

    def record(self, indices, total_seconds: float) -> None:
        """Attribute one batch's wall time over its items and fold into the
        EWMAs.  Batches only measure an aggregate, so attribution is the EM
        step that separates the estimates:

        * an *outlier* batch (total ≥ ``outlier_mult`` × B × the median
          item cost) is blamed proportionally to current predictions —
          excess lands on the member the tracker already believes is slow;
        * an evidently-*fast* batch is strong evidence every member is
          cheap: equal shares, folded in with the faster ``alpha_down``,
          so an item falsely blamed earlier (it shared a batch with a
          straggler while the tracker was cold) is exonerated within a
          couple of sightings instead of staying sticky-slow forever.
        """
        slots = self._slots(indices)
        if slots.size == 0 or total_seconds < 0:
            return
        with self._lock:
            self._maybe_refresh_median_locked()
            med = self._median
            if med > 0 and total_seconds < \
                    self.outlier_mult * slots.size * med:
                share = np.full(slots.size, total_seconds / slots.size)
                a = self.alpha_down
            else:
                est = self._ewma[slots]
                default = self._mean if self._mean > 0 \
                    else total_seconds / slots.size
                est = np.where(np.isnan(est), default, est)
                total_est = float(est.sum())
                if total_est <= 0:
                    share = np.full(slots.size, total_seconds / slots.size)
                else:
                    share = est * (total_seconds / total_est)
                a = self.alpha
            prev = self._ewma[slots]
            updated = np.where(np.isnan(prev), share,
                               (1 - a) * prev + a * share)
            self._ewma[slots] = updated
            batch_mean = total_seconds / slots.size
            self._mean = batch_mean if self.records == 0 \
                else (1 - self.alpha) * self._mean + self.alpha * batch_mean
            self.records += 1
            self.items_seen += int(slots.size)
            self._median_stale = True

    # ---- prediction --------------------------------------------------------
    def _refresh_median_locked(self) -> None:
        seen = self._ewma[~np.isnan(self._ewma)]
        self._median = float(np.median(seen)) if seen.size else 0.0
        self._median_stale = False
        self._median_records = self.records

    def _maybe_refresh_median_locked(self) -> None:
        """Throttled refresh: the O(slots) median scan runs at most once
        per 8 records (callers run per batch on the hot path)."""
        if self._median_stale and (self._median <= 0
                                   or self.records - self._median_records
                                   >= 8):
            self._refresh_median_locked()

    def predict(self, indices) -> np.ndarray:
        """Estimated per-item cost (the running mean for unseen items)."""
        with self._lock:
            est = self._ewma[self._slots(indices)]
            return np.where(np.isnan(est), self._mean, est)

    def is_slow(self, indices) -> bool:
        """Is any item of this batch predicted slow?  False while cold."""
        with self._lock:
            if self.records < self.min_records:
                return False
            self._maybe_refresh_median_locked()
            if self._median <= 0:
                return False
            est = self._ewma[self._slots(indices)]
            cut = self.threshold * self._median
            return bool(np.any(est[~np.isnan(est)] >= cut))

    def note_slow_batch(self) -> None:
        """Called by a pool when a batch is dispatched to the slow lane."""
        with self._lock:
            self.slow_batches += 1

    def forget(self, indices) -> None:
        """Drop the estimates for quarantined items (DESIGN.md §10): an
        id that exited service must stop dragging the median/tail stats.
        With ``bucket > 1`` the whole shared bucket resets — its surviving
        neighbours re-learn within a couple of sightings."""
        slots = self._slots(indices)
        if slots.size == 0:
            return
        with self._lock:
            self._ewma[slots[slots < self._ewma.size]] = np.nan
            self._median_stale = True

    # ---- tail statistics (io_counters / GoodputMonitor feed) ---------------
    def mean(self) -> float:
        return self._mean

    def quantile(self, q: float) -> float:
        with self._lock:
            seen = self._ewma[~np.isnan(self._ewma)]
            return float(np.quantile(seen, q)) if seen.size else 0.0

    def p99(self) -> float:
        return self.quantile(0.99)

    def tail_ratio(self) -> float:
        """p99 over median of the estimated per-item costs: ~1 on a uniform
        workload, large under a heavy tail — the retune-trigger signal."""
        with self._lock:
            self._refresh_median_locked()
            med = self._median
        return self.p99() / med if med > 0 else 0.0

    # ---- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        with self._lock:
            seen = ~np.isnan(self._ewma)
            return {
                "num_items": self.num_items,
                "bucket": self.bucket,
                "alpha": self.alpha,
                "threshold": self.threshold,
                "mean": self._mean,
                "records": self.records,
                "items_seen": self.items_seen,
                "slow_batches": self.slow_batches,
                # sparse: most datasets only ever touch a fraction of slots
                "slots": np.flatnonzero(seen).tolist(),
                "values": self._ewma[seen].tolist(),
            }

    def load_state_dict(self, d: dict) -> None:
        with self._lock:
            self.bucket = max(1, int(d.get("bucket", self.bucket)))
            n_slots = -(-self.num_items // self.bucket)
            self._ewma = np.full(n_slots, np.nan, dtype=np.float64)
            slots = np.asarray(d.get("slots", []), dtype=np.intp)
            vals = np.asarray(d.get("values", []), dtype=np.float64)
            keep = slots < n_slots
            self._ewma[slots[keep]] = vals[keep]
            self.alpha = float(d.get("alpha", self.alpha))
            self.threshold = float(d.get("threshold", self.threshold))
            self._mean = float(d.get("mean", 0.0))
            self.records = int(d.get("records", 0))
            self.items_seen = int(d.get("items_seen", 0))
            self.slow_batches = int(d.get("slow_batches", 0))
            self._median_stale = True

    # the lock is the only unpicklable member; process pools ship the
    # tracker to forked workers, so drop it and remint on arrival
    def __getstate__(self):
        with self._lock:
            state = self.__dict__.copy()
            state["_ewma"] = self._ewma.copy()
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


class KeyedCostTracker:
    """EWMA cost per hashable key (the serving frontend's request shapes).

    Same slow test as :class:`SampleCostTracker` — a key is slow when its
    estimate is at least ``threshold`` times the median over known keys —
    but the table is a dict, because request shapes are few and arbitrary.
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
