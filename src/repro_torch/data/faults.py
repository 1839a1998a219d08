"""Fault-tolerant data plane (DESIGN.md §10).

PR 7 made the fleet control plane survive partitions and coordinator
death; this module does the same for the path that actually moves bytes.
Four pieces, composed by the worker pools and the loader:

* ``FaultyStorage`` — a seeded, picklable wrapper injecting transient
  ``IOError``s, permanent per-item corruption, latency spikes and timed
  brownout windows into ANY backend's ``read``/``read_batch``.  The
  data-path twin of ``FaultyTransport``: every draw is a pure
  ``splitmix64`` hash, so faults are identical across threads, processes
  and reruns.
* ``RetryPolicy`` — bounded attempts, exponential backoff with
  deterministic jitter, and a per-read deadline.  Attempts bound
  *per-item* transients; the deadline bounds *storage-wide* outages
  (``BrownoutError``), which no per-item budget should count against.
* ``QuarantineLog`` — items that exhausted their retries (or are
  permanently corrupt).  Checkpointable: rides ``DataLoader.state_dict``
  like the cost tracker, so a restored loader keeps skipping known-bad
  ids.
* ``FaultPolicy`` — the bundle a worker-pool task body runs reads
  through: screen quarantined ids, retry transients, attribute failures
  to items (probing one-by-one when the error is unattributed), then
  complete the batch under the declared ``on_bad_sample`` policy:

  - ``"raise"``       — legacy pool-fatal behavior (still the default);
  - ``"skip"``        — drop the bad ids; the delivered multiset is
    provably the epoch permutation minus the quarantined ids;
  - ``"substitute"``  — deterministically resample replacements from the
    non-quarantined population, preserving batch count and size.

``FaultStats`` keeps the health counters (``read_retries``,
``read_faults``, ``resubmits``, windowed ``fault_rate``) and drives the
degraded-mode hysteresis: when the recent fault rate crosses the
threshold the loader flips its cache tier to serve-hits-first read-only
mode, and flips it back once the storage heals.  The counters flow
through ``TransferStats`` → ``io_counters()`` → fleet ``HostReport.io``,
where ``OnlineTuner.fault_rate_trigger`` / ``FleetConfig.
fault_rate_trigger`` turn them into automatic retune/recovery.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.storage import (BrownoutError, CorruptSampleError,
                                SampleReadError, Storage, TransientReadError,
                                splitmix_u01)

_BAD_SAMPLE_POLICIES = ("raise", "skip", "substitute")


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StorageFaultSpec:
    """What ``FaultyStorage`` injects.  ``transient_rate`` is drawn per
    (item, failure-count) — retries deterministically clear; corruption
    (``corrupt_rate`` / explicit ``corrupt_items``) is permanent per item;
    ``brownout=(start, stop)`` fails every request while the wrapper's
    access clock is inside the window; ``spike_rate`` items sleep an extra
    ``spike_s`` per request (latency fault, not an error)."""
    transient_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_items: Tuple[int, ...] = ()
    spike_rate: float = 0.0
    spike_s: float = 0.0
    brownout: Optional[Tuple[int, int]] = None     # [start, stop) accesses
    seed: int = 0


class FaultyStorage(Storage):
    """Seeded fault-injecting wrapper over any ``Storage`` backend — the
    data-path twin of ``FaultyTransport``.  Picklable (locks remint on
    arrival), deterministic (pure-hash draws), and transparent on the
    happy path: batched reads forward to ``inner.read_batch`` so the
    wrapped backend's coalescing still happens."""

    def __init__(self, inner: Storage,
                 spec: StorageFaultSpec = StorageFaultSpec()):
        self.inner = inner
        self.spec = spec
        self._lock = threading.Lock()
        self._accesses = 0
        self._attempts: Dict[int, int] = {}     # idx -> transient failures
        self.transient_raised = 0
        self.corrupt_raised = 0
        self.brownout_raised = 0
        self.spikes_injected = 0

    def __len__(self):
        return len(self.inner)

    def item_nbytes(self, idx):
        return self.inner.item_nbytes(idx)

    def is_corrupt(self, idx: int) -> bool:
        s = self.spec
        if int(idx) in s.corrupt_items:
            return True
        return s.corrupt_rate > 0.0 \
            and splitmix_u01(s.seed, idx, 3) < s.corrupt_rate

    def _check(self, indices) -> None:
        s = self.spec
        with self._lock:
            self._accesses += 1
            clock = self._accesses
        for i in indices:
            if self.is_corrupt(i):
                with self._lock:
                    self.corrupt_raised += 1
                raise CorruptSampleError(
                    f"permanently corrupt item {int(i)}", index=int(i))
        if s.brownout is not None \
                and s.brownout[0] <= clock - 1 < s.brownout[1]:
            with self._lock:
                self.brownout_raised += 1
            raise BrownoutError(
                f"storage brownout (access {clock} in "
                f"window {s.brownout})")
        if s.transient_rate > 0.0:
            for i in indices:
                with self._lock:
                    attempt = self._attempts.get(int(i), 0)
                if splitmix_u01(s.seed, i,
                                101 + attempt) < s.transient_rate:
                    with self._lock:
                        self._attempts[int(i)] = attempt + 1
                        self.transient_raised += 1
                    raise TransientReadError(
                        f"transient fault on item {int(i)} "
                        f"(attempt {attempt})", index=int(i))
        if s.spike_rate > 0.0 and s.spike_s > 0.0:
            if any(splitmix_u01(s.seed, i, 5) < s.spike_rate
                   for i in indices):
                with self._lock:
                    self.spikes_injected += 1
                time.sleep(s.spike_s)

    def read(self, idx):
        self._check((int(idx),))
        return self.inner.read(idx)

    def read_batch(self, indices):
        self._check([int(i) for i in indices])
        return self.inner.read_batch(indices)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"transient_raised": self.transient_raised,
                    "corrupt_raised": self.corrupt_raised,
                    "brownout_raised": self.brownout_raised,
                    "spikes_injected": self.spikes_injected,
                    "accesses": self._accesses}

    def __getstate__(self):
        with self._lock:
            state = self.__dict__.copy()
            state["_attempts"] = dict(self._attempts)
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


# --------------------------------------------------------------------------
# retry policy
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + deterministic jitter.

    ``attempts`` counts *retries after the first try* for item-attributed
    transients; ``deadline_s`` bounds the whole read including storage-wide
    brownouts (which never consume per-item attempts — see
    ``FaultPolicy.get_batch``)."""
    attempts: int = 2
    backoff_s: float = 0.01
    backoff_mult: float = 2.0
    backoff_max_s: float = 0.25
    jitter: float = 0.5
    deadline_s: float = 2.0
    seed: int = 0

    def sleep_s(self, retry: int, key: int = 0) -> float:
        """Backoff before the ``retry``-th re-attempt (1-based), jittered
        deterministically by (seed, key, retry)."""
        base = min(self.backoff_max_s,
                   self.backoff_s * self.backoff_mult ** max(0, retry - 1))
        if self.jitter <= 0.0:
            return base
        u = splitmix_u01(self.seed, key, 211 + retry)
        return base * (1.0 - self.jitter / 2.0 + self.jitter * u)


# --------------------------------------------------------------------------
# quarantine
# --------------------------------------------------------------------------
class QuarantineLog:
    """Items withdrawn from service, with reasons.  Checkpointable and
    mergeable (process-pool children ship deltas back to the parent)."""

    def __init__(self):
        self._items: Dict[int, str] = {}
        self._lock = threading.Lock()

    def add(self, idx: int, reason: str) -> bool:
        """Record one id; True when it was not already quarantined."""
        with self._lock:
            if int(idx) in self._items:
                return False
            self._items[int(idx)] = str(reason)
            return True

    def __contains__(self, idx) -> bool:
        with self._lock:
            return int(idx) in self._items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def ids(self) -> np.ndarray:
        with self._lock:
            return np.array(sorted(self._items), dtype=np.intp)

    def reasons(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._items)

    def state_dict(self) -> dict:
        with self._lock:
            return {"items": sorted(self._items.items())}

    def load_state_dict(self, d: dict) -> None:
        with self._lock:
            self._items = {int(i): str(r) for i, r in d.get("items", [])}

    def __getstate__(self):
        with self._lock:
            state = self.__dict__.copy()
            state["_items"] = dict(self._items)
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


# --------------------------------------------------------------------------
# health counters + degraded-mode hysteresis
# --------------------------------------------------------------------------
class FaultStats:
    """Cumulative fault counters plus a windowed fault rate driving the
    degraded-mode flip: enter when the recent rate reaches
    ``degraded_enter`` (with at least ``min_events`` observations), exit
    when successes dilute it back below a quarter of that.  The
    ``on_degraded(bool)`` callback fires on each transition — the loader
    wires it to the cache tier's read-only switch."""

    WINDOW = 64
    MIN_EVENTS = 8

    def __init__(self, *, degraded_enter: float = 0.5,
                 on_degraded: Optional[Callable[[bool], None]] = None):
        self.degraded_enter = max(0.0, degraded_enter)
        self.on_degraded = on_degraded
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=self.WINDOW)  # 1=fault, 0=ok
        self.read_retries = 0
        self.read_faults = 0
        self.resubmits = 0
        self.degraded = False
        self.degraded_enters = 0

    def fault_rate(self) -> float:
        with self._lock:
            return (sum(self._window) / len(self._window)
                    if self._window else 0.0)

    def _note(self, outcome: int) -> None:
        fire: Optional[bool] = None
        with self._lock:
            self._window.append(outcome)
            if self.degraded_enter > 0.0 \
                    and len(self._window) >= self.MIN_EVENTS:
                rate = sum(self._window) / len(self._window)
                if not self.degraded and rate >= self.degraded_enter:
                    self.degraded = True
                    self.degraded_enters += 1
                    fire = True
                elif self.degraded and rate <= self.degraded_enter / 4.0:
                    self.degraded = False
                    fire = False
        if fire is not None and self.on_degraded is not None:
            self.on_degraded(fire)

    def note_ok(self) -> None:
        self._note(0)

    def note_fault(self) -> None:
        with self._lock:
            self.read_faults += 1
        self._note(1)

    def note_retry(self) -> None:
        with self._lock:
            self.read_retries += 1

    def note_resubmit(self, n: int = 1) -> None:
        with self._lock:
            self.resubmits += n

    def merge_report(self, report: dict) -> None:
        """Fold a process-pool child's per-task tally into the live stats
        (children run on fork-copied stats; deltas ship back)."""
        with self._lock:
            self.read_retries += int(report.get("retries", 0))
            self.read_faults += int(report.get("faults", 0))
        for _ in range(int(report.get("faults", 0))):
            self._note(1)
        for _ in range(int(report.get("ok", 0))):
            self._note(0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"read_retries": float(self.read_retries),
                    "read_faults": float(self.read_faults),
                    "resubmits": float(self.resubmits),
                    "degraded": 1.0 if self.degraded else 0.0}

    # callback and lock stay on the parent; forked/pickled copies tally
    # into a report instead
    def __getstate__(self):
        with self._lock:
            state = self.__dict__.copy()
            state["_window"] = deque(self._window, maxlen=self.WINDOW)
        state["_lock"] = None
        state["on_degraded"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


# --------------------------------------------------------------------------
# the policy the worker pools run reads through
# --------------------------------------------------------------------------
class FaultPolicy:
    """Resilient ``get_batch``: screen quarantined ids, retry transients,
    quarantine what exhausts its budget, and complete the batch under the
    declared ``on_bad_sample`` policy.  One instance is shared by every
    worker thread (the log and stats are lock-guarded); process-pool tasks
    pickle a snapshot and ship their deltas back via ``report``."""

    def __init__(self, *, retry: RetryPolicy = RetryPolicy(),
                 quarantine: Optional[QuarantineLog] = None,
                 stats: Optional[FaultStats] = None,
                 on_bad_sample: str = "raise", num_items: int = 0,
                 seed: int = 0,
                 on_quarantine: Optional[
                     Callable[[List[int]], None]] = None):
        if on_bad_sample not in _BAD_SAMPLE_POLICIES:
            raise ValueError(
                f"on_bad_sample must be one of {_BAD_SAMPLE_POLICIES}, "
                f"got {on_bad_sample!r}")
        self.retry = retry
        # NOT `quarantine or ...`: an EMPTY log is falsy (__len__) but
        # still the caller's live log
        self.quarantine = QuarantineLog() if quarantine is None \
            else quarantine
        self.stats = FaultStats() if stats is None else stats
        self.on_bad_sample = on_bad_sample
        self.num_items = int(num_items)
        self.seed = int(seed)
        self.on_quarantine = on_quarantine

    # ---- quarantine bookkeeping -------------------------------------------
    def _quarantine(self, bad: Dict[int, str],
                    report: Optional[dict]) -> None:
        newly = [i for i, reason in sorted(bad.items())
                 if self.quarantine.add(i, reason)]
        if report is not None and newly:
            report.setdefault("quarantined", []).extend(
                (i, bad[i]) for i in newly)
        if newly and self.on_quarantine is not None:
            self.on_quarantine(newly)

    def _substitute_for(self, bad_idx: int, taken: set) -> Optional[int]:
        """Deterministic replacement drawn uniformly from the
        non-quarantined population (the same shard distribution the
        sampler draws from — coverage stays audit-friendly)."""
        if self.num_items <= 0:
            return None
        for k in range(64):
            cand = int(splitmix_u01(self.seed, bad_idx, 301 + k)
                       * self.num_items)
            if cand not in taken and cand not in self.quarantine:
                return cand
        return None

    def _apply_policy(self, idx: np.ndarray, bad: Dict[int, str],
                      report: Optional[dict],
                      cause: BaseException) -> Optional[np.ndarray]:
        """Quarantine ``bad`` and return the repaired index batch (None =
        nothing left).  Raises ``cause`` under the ``raise`` policy —
        after recording, so the log still names the culprit."""
        self._quarantine(bad, report)
        if self.on_bad_sample == "raise":
            raise cause
        bad_ids = np.array(sorted(bad), dtype=idx.dtype)
        if self.on_bad_sample == "skip":
            kept = idx[~np.isin(idx, bad_ids)]
            return kept if kept.size else None
        # substitute: replace in place, preserving batch size
        out = idx.copy()
        taken = set(int(i) for i in idx)
        for pos in np.flatnonzero(np.isin(idx, bad_ids)):
            sub = self._substitute_for(int(idx[pos]), taken)
            if sub is None:             # population exhausted: drop
                out[pos] = -1
                continue
            taken.add(sub)
            out[pos] = sub
        out = out[out >= 0]
        return out if out.size else None

    # ---- probing ----------------------------------------------------------
    def _probe(self, dataset, idx: np.ndarray, fast: bool,
               catch_all: bool) -> Dict[int, str]:
        """Attribute an unattributed batch failure: read items one by one
        (with quick retries) and blame the ones that still fail.  Brownout
        failures blame nobody — the storage is down, not the item."""
        bad: Dict[int, str] = {}
        for i in idx:
            one = np.array([i], dtype=idx.dtype)
            for attempt in range(1 + max(0, self.retry.attempts)):
                try:
                    dataset.get_batch(one, fast=fast)
                    break
                except BrownoutError:
                    return {}           # unattributable: escalate
                except CorruptSampleError:
                    bad[int(i)] = "corrupt"
                    break
                except (SampleReadError, IOError, OSError) as e:
                    if attempt >= self.retry.attempts:
                        bad[int(i)] = f"retries-exhausted: {e}"
                    else:
                        time.sleep(self.retry.sleep_s(attempt + 1, int(i)))
                except Exception as e:  # noqa: BLE001 - poisoned transform
                    if not catch_all:
                        raise
                    bad[int(i)] = f"poisoned: {type(e).__name__}: {e}"
                    break
        return bad

    # ---- the resilient read ------------------------------------------------
    def get_batch(self, dataset, indices, *, out=None, fast: bool = True,
                  report: Optional[dict] = None):
        """``dataset.get_batch`` with retries, quarantine and batch repair.
        Returns None when every index of the batch is quarantined (the
        pool skips the sequence slot).  ``report``, when given, collects
        the per-task tally a process-pool child ships to its parent."""
        idx = np.asarray(indices).reshape(-1)
        if len(self.quarantine):
            known = self.quarantine.ids()
            mask = np.isin(idx, known)
            if mask.any():
                if self.on_bad_sample == "substitute":
                    repaired = self._apply_policy(
                        idx, {int(i): "quarantined" for i in idx[mask]},
                        report, cause=RuntimeError("unreachable"))
                    idx = repaired if repaired is not None else idx[:0]
                else:
                    idx = idx[~mask]    # raise-mode restores skip too:
                    #                     quarantined means "do not serve"
            if idx.size == 0:
                return None
        deadline = time.monotonic() + self.retry.deadline_s
        fails: Dict[int, int] = {}      # per-ITEM failure counts: one
        #                                 flaky neighbour must not burn
        #                                 another item's retry budget
        while True:
            try:
                batch = dataset.get_batch(idx, out=out, fast=fast)
            except CorruptSampleError as e:
                self.stats.note_fault()
                if report is not None:
                    report["faults"] = report.get("faults", 0) + 1
                bad = {int(e.index): "corrupt"} if e.index is not None \
                    else self._probe(dataset, idx, fast, catch_all=False)
                if not bad:
                    raise
                idx = self._apply_policy(idx, bad, report, cause=e)
                if idx is None:
                    return None
                deadline = time.monotonic() + self.retry.deadline_s
            except (SampleReadError, IOError, OSError) as e:
                self.stats.note_fault()
                if report is not None:
                    report["faults"] = report.get("faults", 0) + 1
                index = getattr(e, "index", None)
                brownout = isinstance(e, BrownoutError)
                if index is not None and not brownout:
                    # item-attributed transient: consumes one of that
                    # item's attempts
                    fails[int(index)] = fails.get(int(index), 0) + 1
                exhausted = (index is not None and not brownout
                             and fails[int(index)]
                             > max(0, self.retry.attempts)) \
                    or time.monotonic() >= deadline
                if not exhausted:
                    retry_no = fails.get(int(index), 1) \
                        if index is not None else 1
                    self.stats.note_retry()
                    if report is not None:
                        report["retries"] = report.get("retries", 0) + 1
                    time.sleep(self.retry.sleep_s(
                        retry_no, int(index if index is not None
                                      else idx[0])))
                    continue
                if index is not None and not brownout:
                    bad = {int(index): f"retries-exhausted: {e}"}
                else:
                    bad = self._probe(dataset, idx, fast, catch_all=False)
                if not bad:
                    raise               # brownout outlasted the deadline
                idx = self._apply_policy(idx, bad, report, cause=e)
                if idx is None:
                    return None
                deadline = time.monotonic() + self.retry.deadline_s
            except Exception as e:      # noqa: BLE001 - poisoned transform
                if self.on_bad_sample == "raise":
                    raise               # legacy behavior: pool-fatal
                self.stats.note_fault()
                if report is not None:
                    report["faults"] = report.get("faults", 0) + 1
                bad = self._probe(dataset, idx, fast, catch_all=True)
                if not bad:
                    raise               # not per-item poison: a real bug
                idx = self._apply_policy(idx, bad, report, cause=e)
                if idx is None:
                    return None
            else:
                self.stats.note_ok()
                if report is not None:
                    report["ok"] = report.get("ok", 0) + 1
                return batch

    # the quarantine-callback closes over loader state; forked/pickled
    # copies report deltas back instead of calling it directly
    def __getstate__(self):
        state = self.__dict__.copy()
        state["on_quarantine"] = None
        return state


def quarantine_complement(n: int, quarantine: QuarantineLog) -> np.ndarray:
    """All ids of range(n) not quarantined — the exact multiset a
    skip-policy epoch must deliver (tests/benches assert against this)."""
    mask = np.ones(n, dtype=bool)
    ids = quarantine.ids()
    mask[ids[ids < n]] = False
    return np.flatnonzero(mask)
