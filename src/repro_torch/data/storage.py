"""Storage backends for the data pipeline.

The loader (and therefore DPT) only sees the ``Storage`` interface, so the
same tuner runs against:

* ``ArrayStorage``   — in-memory items (unit tests, toy examples),
* ``FileStorage``    — real files on disk (.npy per item),
* ``LatencyStorage`` — wraps another storage and injects real ``time.sleep``
  IO latency + bandwidth delays (integration tests exercise real thread
  parallelism against it: sleep releases the GIL),
* ``StorageProfile`` — the *virtual-time* description used by the
  discrete-event simulator for the paper-table benchmarks (this container
  has one CPU core, so multi-core scaling curves are simulated; see
  DESIGN.md §2 "Assumptions changed").

Every backend also exposes a vectorized ``read_batch(indices)`` — the
storage half of the zero-copy fast path (DESIGN.md §3).  The default loops
``read``; real backends do better: ``ArrayStorage`` gathers the whole batch
in one fancy-index pass over a dense array, ``FileStorage`` memory-maps
items, and ``LatencyStorage`` charges one base latency per *coalesced
contiguous run* of misses instead of one per item (what a real storage
stack's readahead/scatter-gather does for batched requests).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class StorageProfile:
    """Virtual-time storage/dataset characteristics (simulator input).

    ``item_bytes`` is the *encoded* on-storage size (what IO and the page
    cache see); ``decoded_item_bytes`` is the in-memory decoded sample (what
    worker queues, the device transfer and decode CPU cost see).  The seek
    model io_latency(K) = io_latency_s * (1 + seek_congestion*K) is fitted
    from the paper's own COCO numbers (405s cold / 8.7s warm epochs at 80x80
    imply ~8 ms base request latency growing ~0.3x per concurrent reader —
    random small reads on consumer storage serialize at the disk).

    Fast-path coalescing fields (DESIGN.md §3): ``coalesced_run_len`` is the
    mean number of items served per storage request when the loader issues
    batched ``read_batch`` calls (1.0 = per-item requests, the legacy
    behavior — also what a fully shuffled access pattern degrades to);
    ``vectorized_decode_fixed_s`` is the amortized per-item fixed decode
    cost under the vectorized batch transform (None = per-sample
    ``decode_cpu_s_fixed``).  Defaults are neutral, so existing simulated
    grids and their optima are bit-for-bit unchanged.
    """
    num_items: int
    item_bytes: float                 # mean encoded item size
    decoded_item_bytes: Optional[float] = None
    item_bytes_std: float = 0.0
    io_latency_s: float = 100e-6      # per-request base latency
    seek_congestion: float = 0.0      # latency growth per concurrent reader
    storage_bw: float = 2.0e9         # aggregate sequential read B/s
    ram_bw: float = 10.0e9            # page-cache read B/s
    decode_cpu_s_per_byte: float = 4e-9  # decode CPU s per *decoded* byte
    decode_cpu_s_fixed: float = 150e-6   # per-item fixed CPU cost
    coalesced_run_len: float = 1.0       # items per request under read_batch
    vectorized_decode_fixed_s: Optional[float] = None
    # Heavy-tailed per-item cost (DESIGN.md §9): ``tail_fraction`` of items
    # cost ``tail_mult``x the mean decode+IO time (corrupt JPEGs, giant
    # outlier images, cold dedup segments...).  Neutral defaults keep every
    # existing simulated grid bit-for-bit identical.
    tail_fraction: float = 0.0           # fraction of items that are slow
    tail_mult: float = 1.0               # cost multiplier for those items

    @property
    def decoded(self) -> float:
        return self.decoded_item_bytes or 4.0 * self.item_bytes

    @property
    def dataset_bytes(self) -> float:
        return self.num_items * self.item_bytes

    @property
    def effective_decode_fixed_s(self) -> float:
        if self.vectorized_decode_fixed_s is None:
            return self.decode_cpu_s_fixed
        return self.vectorized_decode_fixed_s

    def with_fast_path(self, *, run_len: float = 8.0,
                       decode_fixed_s: Optional[float] = None
                       ) -> "StorageProfile":
        """This profile as seen by the batched fast path: requests coalesce
        into runs of ``run_len`` items and the per-item fixed decode cost
        amortizes to ``decode_fixed_s`` (default: 1/8 of per-sample)."""
        if decode_fixed_s is None:
            decode_fixed_s = self.decode_cpu_s_fixed / 8.0
        return dataclasses.replace(
            self, coalesced_run_len=max(1.0, run_len),
            vectorized_decode_fixed_s=decode_fixed_s)

    def with_heavy_tail(self, *, fraction: float = 0.05,
                        mult: float = 20.0) -> "StorageProfile":
        """This profile with a straggler population: ``fraction`` of items
        cost ``mult``x the per-item mean (what the slow-lane knob prices)."""
        return dataclasses.replace(
            self, tail_fraction=max(0.0, min(1.0, fraction)),
            tail_mult=max(1.0, mult))


# --------------------------------------------------------------------------
# fault vocabulary (DESIGN.md §10): storage backends raise these, the
# worker-pool retry machinery (data/faults.py) catches and classifies them
# --------------------------------------------------------------------------
class SampleReadError(IOError):
    """A read failed.  ``index`` names the culprit item when the backend
    can attribute the failure to one (None = whole-request failure)."""

    def __init__(self, message: str, *, index: Optional[int] = None):
        super().__init__(message)
        self.index = index

    # IOError's default __reduce__ drops keyword state; carry ``index``
    # across process boundaries (a child's raise ships back via pickle)
    def __reduce__(self):
        return (self.__class__, (str(self),), {"index": self.index})


class TransientReadError(SampleReadError):
    """Retryable: the same read may succeed on the next attempt."""


class BrownoutError(TransientReadError):
    """The storage itself is unavailable — never attributable to an item,
    so retry budgets treat it as deadline-bounded, not attempt-bounded,
    and nothing is ever quarantined for failing during a brownout."""


class CorruptSampleError(SampleReadError):
    """Permanent: this item will never read correctly (bad bytes on
    storage).  Retrying is pointless; the item is quarantine material."""


_SPLITMIX_M64 = (1 << 64) - 1


def splitmix_u01(seed: int, idx: int, salt: int = 0) -> float:
    """Deterministic uniform in [0, 1) from (seed, idx, salt) — a
    splitmix64-style integer mix with no RNG state to share or fork.
    Shared by the heavy-tail draw, the fault draws and jittered backoff."""
    x = (int(idx) * 0x9E3779B97F4A7C15
         + (int(seed) * 2 + int(salt) + 1) * 0xBF58476D1CE4E5B9) \
        & _SPLITMIX_M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _SPLITMIX_M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _SPLITMIX_M64
    x ^= x >> 31
    return x / float(1 << 64)


def coalesce_runs(indices: Sequence[int]) -> List[Tuple[int, int]]:
    """Group sorted(indices) into maximal contiguous runs [(start, length)].

    This is the request pattern a batched read issues: one storage request
    per run (readahead serves the rest of the run from the same seek).
    """
    if len(indices) == 0:
        return []
    idx = sorted(int(i) for i in indices)
    runs = [(idx[0], 1)]
    for i in idx[1:]:
        start, length = runs[-1]
        if i == start + length:
            runs[-1] = (start, length + 1)
        else:
            runs.append((i, 1))
    return runs


class Storage:
    """Indexable raw-item store."""

    def __len__(self) -> int:
        raise NotImplementedError

    def read(self, idx: int) -> np.ndarray:
        raise NotImplementedError

    def read_batch(self, indices) -> Union[np.ndarray, List[np.ndarray]]:
        """Vectorized gather.  May return a stacked ``(B, ...)`` array when
        items are uniform, or a list of per-item arrays.  The default loops
        ``read``; backends override with genuinely batched IO."""
        return [self.read(int(i)) for i in indices]

    def item_nbytes(self, idx: int) -> int:
        raise NotImplementedError

    def profile(self) -> StorageProfile:
        """Best-effort virtual profile (for DPT cache fingerprints)."""
        n = len(self)
        sizes = [self.item_nbytes(i) for i in range(min(n, 16))]
        return StorageProfile(num_items=n, item_bytes=float(np.mean(sizes)),
                              item_bytes_std=float(np.std(sizes)))


class ArrayStorage(Storage):
    """In-memory items.  Uniform-shape items are densified into one
    ``(N, ...)`` array at construction, so ``read_batch`` is a single
    fancy-index gather (one C call) instead of B Python reads."""

    def __init__(self, items):
        self._items = list(items)
        self._dense: Optional[np.ndarray] = None
        if self._items:
            first = np.asarray(self._items[0])
            if all(isinstance(a, np.ndarray) and a.shape == first.shape
                   and a.dtype == first.dtype for a in self._items):
                self._dense = np.stack(self._items)
                # items become views of the dense array: no duplication
                self._items = list(self._dense)

    def __len__(self):
        return len(self._items)

    def read(self, idx):
        return self._items[idx]

    def read_batch(self, indices):
        if self._dense is not None:
            return self._dense[np.asarray(indices, dtype=np.intp)]
        return [self._items[int(i)] for i in indices]

    def item_nbytes(self, idx):
        return self._items[idx].nbytes


# FileStorage instances whose mmap caches must be dropped in a forked
# child: a fork duplicates the parent's open handles/mappings into the
# child (where they are dead weight at best — the child lazily reopens on
# first use).  Pickling already drops them (__getstate__); this covers the
# fork-without-pickle path (ProcessWorkerPool's fork pool inherits the
# parent's live objects at Pool() creation).
_FORK_RESET_STORAGES: "weakref.WeakSet" = weakref.WeakSet()


def _drop_inherited_mmaps() -> None:   # runs in the CHILD, right after fork
    for fs in list(_FORK_RESET_STORAGES):
        fs._mmaps = {}
        fs._mmap_lock = threading.Lock()


if hasattr(os, "register_at_fork"):    # pragma: no branch - CPython 3.7+
    os.register_at_fork(after_in_child=_drop_inherited_mmaps)


class FileStorage(Storage):
    """One .npy file per item under ``root``.

    Per-item sizes are stat'ed once at construction (DPT's static memory
    pre-check reads them repeatedly); ``read_batch`` goes through cached
    ``np.load(mmap_mode='r')`` handles so repeat epochs hit the page cache
    without re-parsing headers.
    """

    _MAX_MMAPS = 4096   # cap cached file handles

    def __init__(self, root: str):
        self.root = root
        self._files = sorted(
            f for f in os.listdir(root) if f.endswith(".npy"))
        self._paths = [os.path.join(root, f) for f in self._files]
        self._sizes = [os.path.getsize(p) for p in self._paths]
        self._mmaps: dict = {}
        self._mmap_lock = threading.Lock()
        _FORK_RESET_STORAGES.add(self)

    @classmethod
    def create(cls, root: str, items) -> "FileStorage":
        os.makedirs(root, exist_ok=True)
        for i, arr in enumerate(items):
            np.save(os.path.join(root, f"{i:08d}.npy"), arr)
        return cls(root)

    def __len__(self):
        return len(self._files)

    def read(self, idx):
        return np.load(self._paths[idx])

    def _mmap(self, idx: int) -> np.ndarray:
        with self._mmap_lock:
            m = self._mmaps.get(idx)
            if m is None:
                if len(self._mmaps) >= self._MAX_MMAPS:
                    self._mmaps.clear()
                m = self._mmaps[idx] = np.load(self._paths[idx],
                                               mmap_mode="r")
            return m

    def read_batch(self, indices):
        return [np.asarray(self._mmap(int(i))) for i in indices]

    def item_nbytes(self, idx):
        return self._sizes[idx]

    # mmap handles and their lock don't cross process boundaries — a forked
    # ProcessWorkerPool pickles the dataset per task (see _mp_get_batch)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_mmaps"] = {}
        state["_mmap_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._mmap_lock = threading.Lock()
        _FORK_RESET_STORAGES.add(self)


class LatencyStorage(Storage):
    """Wraps a storage and injects real sleep-based IO latency/bandwidth.

    Sleeping releases the GIL, so a thread worker pool sees true concurrency
    gains — this is how the loader's parallel machinery is exercised for
    real on a 1-core container.  An optional page cache makes repeat reads
    cheap (the paper's 1st-vs-2nd-epoch effect).

    ``read_batch`` models what a batched request actually costs: cache
    misses are sorted and coalesced into contiguous runs, each run pays ONE
    base latency plus its total bytes over the bandwidth (``coalesce_runs``)
    — a fully contiguous batch of B items costs 1 seek instead of B.
    Counters: ``reads``/``cache_hits`` are per item, ``batched_reads`` per
    ``read_batch`` call, ``coalesced_requests`` per run actually issued.

    Heavy-tailed cost mode (DESIGN.md §9): with ``tail_fraction > 0`` a
    seeded, *deterministic* subset of items costs extra on every miss —
    ``tail_mode="bimodal"`` charges tail items ``(tail_mult - 1)`` extra
    base latencies (a clean two-population straggler workload, the bench /
    property-test shape), ``"lognormal"`` draws a per-item multiplier from
    a seeded lognormal with median 1 (a smoother real-decode shape).  The
    draw is a pure hash of ``(tail_seed, idx)``: no RNG state, identical
    across threads, processes and epochs — stragglers are reproducible
    without wall-clock-dominating sleeps (tail cost scales with
    ``latency_s``, so CI keeps it tiny).

    Fault mode (DESIGN.md §10): with ``fault_rate > 0`` a cache *miss*
    raises :class:`TransientReadError` with probability ``fault_rate``,
    drawn from ``splitmix_u01(fault_seed, idx, attempt)`` — the draw is
    re-keyed by the item's failure count, so an item that faulted once is
    not doomed to fault forever: retries deterministically clear.
    ``brownout=(start, stop)`` fails EVERY miss while the storage's access
    clock (one tick per ``read``/``read_batch`` call) is inside the
    window, raising :class:`BrownoutError`; retries advance the clock, so
    a brownout heals under sustained traffic.  Cache hits are always
    served — the "serve-hits-first" half of degraded mode is a property of
    the storage, not just the loader.
    """

    def __init__(self, inner: Storage, *, latency_s: float = 1e-3,
                 bandwidth: float = 1e9, cache_bytes: int = 0,
                 concurrent_streams: int = 8, tail_fraction: float = 0.0,
                 tail_mult: float = 1.0, tail_seed: int = 0,
                 tail_mode: str = "bimodal", fault_rate: float = 0.0,
                 fault_seed: int = 0,
                 brownout: Optional[Tuple[int, int]] = None):
        if tail_mode not in ("bimodal", "lognormal"):
            raise ValueError(f"unknown tail_mode: {tail_mode!r}")
        self.inner = inner
        self.latency_s = latency_s
        self.bandwidth = bandwidth
        self.cache_bytes = cache_bytes
        self.tail_fraction = max(0.0, min(1.0, tail_fraction))
        self.tail_mult = max(1.0, tail_mult)
        self.tail_seed = int(tail_seed)
        self.tail_mode = tail_mode
        self.fault_rate = max(0.0, min(1.0, fault_rate))
        self.fault_seed = int(fault_seed)
        self.brownout = tuple(brownout) if brownout else None
        self._cache: dict = {}
        self._cache_used = 0
        self._lock = threading.Lock()
        self._sem = threading.Semaphore(concurrent_streams)
        self.reads = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.batched_reads = 0
        self.coalesced_requests = 0
        self.faults_injected = 0
        self._access_clock = 0          # read/read_batch calls so far
        self._fault_attempts: Dict[int, int] = {}   # idx -> failures so far

    def __len__(self):
        return len(self.inner)

    def item_nbytes(self, idx):
        return self.inner.item_nbytes(idx)

    # ---- heavy tail --------------------------------------------------------
    def _item_u01(self, idx: int, salt: int = 0) -> float:
        """Deterministic uniform in [0, 1) from (tail_seed, idx, salt)."""
        return splitmix_u01(self.tail_seed, idx, salt)

    def tail_multiplier(self, idx: int) -> float:
        """Per-item miss-cost multiplier (1.0 when the tail is off)."""
        if self.tail_fraction <= 0.0 or self.tail_mult <= 1.0:
            return 1.0
        if self.tail_mode == "bimodal":
            tail = self._item_u01(idx) < self.tail_fraction
            return self.tail_mult if tail else 1.0
        # lognormal: median-1 multiplier whose ~p98 reaches tail_mult
        import math
        u1 = max(self._item_u01(idx), 1e-12)
        u2 = self._item_u01(idx, salt=1)
        z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)
        sigma = math.log(self.tail_mult) / 2.0
        return math.exp(sigma * z)

    def is_tail(self, idx: int) -> bool:
        """Is this item in the slow population?  (Tests/benches use this to
        plant known stragglers and check the tracker finds them.)"""
        return self.tail_multiplier(idx) >= max(2.0, self.tail_mult / 2.0)

    def _tail_extra_s(self, indices) -> float:
        """Extra sleep the tail charges for these miss items: each pays
        ``(multiplier - 1)`` additional base latencies."""
        if self.tail_fraction <= 0.0 or self.tail_mult <= 1.0:
            return 0.0
        return self.latency_s * sum(
            max(0.0, self.tail_multiplier(i) - 1.0) for i in indices)

    # ---- fault injection (DESIGN.md §10) -----------------------------------
    def _maybe_fault(self, misses, clock: int) -> None:
        """Raise for faulting misses: a brownout window fails the whole
        request (unattributable), a transient draw fails one item — keyed
        by that item's failure count, so retries clear deterministically."""
        if not misses:
            return                      # hits are always served
        if self.brownout is not None \
                and self.brownout[0] <= clock - 1 < self.brownout[1]:
            with self._lock:
                self.faults_injected += 1
            raise BrownoutError(
                f"storage brownout (access {clock} in "
                f"window {self.brownout})")
        if self.fault_rate <= 0.0:
            return
        for i in misses:
            with self._lock:
                attempt = self._fault_attempts.get(i, 0)
            # salt 101+attempt keeps the fault stream disjoint from the
            # tail draws (salts 0/1) even when the seeds coincide
            if splitmix_u01(self.fault_seed, i,
                            101 + attempt) < self.fault_rate:
                with self._lock:
                    self._fault_attempts[i] = attempt + 1
                    self.faults_injected += 1
                raise TransientReadError(
                    f"transient read fault on item {i} "
                    f"(attempt {attempt})", index=int(i))

    def _maybe_cache(self, idx: int, nbytes: int, data) -> None:
        if self.cache_bytes:
            with self._lock:
                if (idx not in self._cache
                        and self._cache_used + nbytes <= self.cache_bytes):
                    self._cache[idx] = data
                    self._cache_used += nbytes

    def read(self, idx):
        with self._lock:
            self._access_clock += 1
            clock = self._access_clock
            self.reads += 1
            cached = idx in self._cache
            if cached:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
        if cached:
            return self._cache[idx]
        self._maybe_fault((idx,), clock)
        nbytes = self.inner.item_nbytes(idx)
        with self._sem:  # bounded concurrent streams share the bus
            time.sleep(self.latency_s + nbytes / self.bandwidth
                       + self._tail_extra_s((idx,)))
        data = self.inner.read(idx)
        self._maybe_cache(idx, nbytes, data)
        return data

    def read_batch(self, indices):
        indices = [int(i) for i in indices]
        with self._lock:
            self._access_clock += 1
            clock = self._access_clock
            self.reads += len(indices)
            self.batched_reads += 1
            hits = {i for i in indices if i in self._cache}
            self.cache_hits += len(hits)
            self.cache_misses += len(indices) - len(hits)
        misses = [i for i in indices if i not in hits]
        self._maybe_fault(misses, clock)
        runs = coalesce_runs(misses)
        for start, length in runs:
            run_bytes = sum(self.inner.item_nbytes(start + k)
                            for k in range(length))
            run_items = range(start, start + length)
            with self._sem:  # one request per coalesced run
                time.sleep(self.latency_s + run_bytes / self.bandwidth
                           + self._tail_extra_s(run_items))
        with self._lock:
            self.coalesced_requests += len(runs)
        miss_data = {}
        if misses:
            fetched = self.inner.read_batch(misses)
            for i, data in zip(misses, fetched):
                miss_data[i] = data
                self._maybe_cache(i, self.inner.item_nbytes(i), data)
        return [self._cache[i] if i in hits else miss_data[i]
                for i in indices]

    @property
    def achieved_run_len(self) -> float:
        """Mean cache-miss items served per storage request so far — the
        measured counterpart of ``StorageProfile.coalesced_run_len``."""
        if not self.coalesced_requests:
            return 0.0
        return (self.reads - self.cache_hits) / self.coalesced_requests


_IO_COUNTER_FIELDS = ("reads", "cache_hits", "cache_misses",
                      "batched_reads", "coalesced_requests")


def storage_io_counters(storage) -> Optional[Dict[str, float]]:
    """Snapshot of a storage's IO-efficiency counters (None when the
    backend doesn't keep them).  Duck-typed so instrumented backends other
    than ``LatencyStorage`` surface the same numbers; loaders diff two
    snapshots to attribute requests to one measurement window."""
    if not all(hasattr(storage, f) for f in _IO_COUNTER_FIELDS):
        return None
    return {f: float(getattr(storage, f)) for f in _IO_COUNTER_FIELDS}


# --- canonical dataset profiles used by the paper-table benchmarks --------
def cifar10_profile() -> StorageProfile:
    """~60K 32x32x3 images (CIFAR-10): tiny raw items, batched binary files
    (fast IO), decode = tensorize + normalize.  Fits RAM trivially, so the
    paper's CIFAR grid is the warm/CPU-bound regime."""
    return StorageProfile(num_items=60_000, item_bytes=32 * 32 * 3,
                          decoded_item_bytes=4.0 * 32 * 32 * 3,
                          io_latency_s=2e-3, seek_congestion=0.1,
                          storage_bw=200e6,
                          decode_cpu_s_fixed=120e-6,
                          decode_cpu_s_per_byte=10e-9)


def coco_profile(resolution: int) -> StorageProfile:
    """COCO-2017-unlabeled resized to resolution^2 (paper §4.3): JPEG-ish
    encoded items (~0.35 compression), fp32 decoded tensors, seek-bound
    consumer storage (constants back-fitted from paper Table 1b — see
    StorageProfile docstring)."""
    raw = resolution * resolution * 3
    enc = 0.35 * raw
    return StorageProfile(num_items=123_000, item_bytes=float(enc),
                          decoded_item_bytes=4.0 * raw,
                          item_bytes_std=0.15 * enc,
                          io_latency_s=8e-3, seek_congestion=0.31,
                          storage_bw=60e6,
                          decode_cpu_s_fixed=150e-6,
                          decode_cpu_s_per_byte=4e-9)
