"""The DataLoader: sampler + worker pool + device prefetch, parameterized by
exactly the two knobs DPT tunes (nWorker, nPrefetch) plus the device-buffer
depth.  ``measure_transfer_time`` is the paper's objective function
("Measure Dataloader Transfer Time using i, j arguments", Algorithm 1 l.12).

Hot-swap: ``DataLoader.apply_params`` reconfigures a *running* stream.
``LoaderStream`` drains the current worker pool at a batch boundary (every
batch the pool already pulled is delivered; the stateful ShardedSampler is
never rewound) and restarts with the new (nWorker, nPrefetch) — zero
batches lost or duplicated.  This is what lets an online tuner
(``repro.tuning.online``; not ported yet) retune mid-training instead of
only as a preamble.

``device`` (default ``"cuda"``) is where ``stream()`` and
``measure_transfer_time`` deliver with ``to_device=True``; the loader
raises at construction when it is CUDA and there is no card.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.monitor import (MemoryBudget, MemoryMonitor, MemoryOverflow,
                                estimate_loader_footprint)
from repro_torch.data.arena import SlabArena
from repro_torch.data.cache import CachedStorage, CacheTier
from repro_torch.data.costs import SampleCostTracker
from repro_torch.data.dataset import Dataset
from repro_torch.data.faults import (FaultPolicy, FaultStats, QuarantineLog,
                               RetryPolicy)
from repro_torch.data.prefetcher import DevicePrefetcher
from repro_torch.data.sampler import SamplerState, ShardedSampler
from repro_torch.data.storage import storage_io_counters
from repro_torch.data.worker_pool import (ProcessWorkerPool, ThreadWorkerPool,
                                    batch_nbytes)
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoaderParams:
    """The tunable surface.  (num_workers, prefetch_factor) are the paper's
    (nWorker, nPrefetch); device_prefetch is the device-side double-buffer.

    Fast-path knobs (DESIGN.md §3): ``fast_path`` enables batched storage
    reads + the vectorized transform when the dataset supports them (falls
    back silently otherwise); ``zero_copy`` additionally collates into a
    recycled slab arena — batches are then valid only until the next batch
    is requested (copy fields you keep); ``ordered`` turns on the
    order-preserving reordering buffer so delivery matches sampler order at
    any worker count; ``transfer_threads``/``donate_transfer`` configure the
    device prefetcher's HBM copy lanes.

    IO-locality knobs (DESIGN.md §5): ``locality_chunk`` (0/1 = fully
    random) switches the sampler to chunked shuffling so cold-epoch
    ``read_batch`` calls coalesce into contiguous runs — the third axis
    DPT's grid searches next to (nWorker, nPrefetch); ``staging_buffers``
    sizes the device edge's pinned staging ring (0 disables it, restoring
    the copy straight from the slab, which then waits for it).  Both hot-swap via ``apply_params``
    (locality latches at the next epoch boundary — see
    ``ShardedSampler.set_locality``).

    Cache knob (DESIGN.md §7): ``cache_budget_bytes`` (0 = off) bounds the
    host-level cross-epoch ``CacheTier`` that retains raw items so epochs
    2+ stream at memory speed — the fourth DPT axis.  Hot-swaps via
    ``apply_params`` like locality (the cache *plan* — the sampler's
    hot/cold interleave — latches at an epoch boundary; the tier itself
    is resized in place, never dropped).

    Slow-lane knobs (DESIGN.md §9): ``slow_lane_workers`` (0 = off, the
    fifth DPT axis) adds that many dedicated workers whose sequence window
    runs ``slow_lane_lookahead`` batches ahead, taking batches the cost
    tracker predicts slow (≥ ``slow_lane_threshold`` × the median item
    cost) so a straggler is already done when ordered delivery reaches it.
    Ordered thread pools only (process pools translate the knob into
    early ``apply_async`` submission; unordered delivery has no
    head-of-line pathology to fix, so the lane is inert there).

    Fault-tolerance knobs (DESIGN.md §10): ``retry_attempts`` retries per
    item-attributed transient read fault (with ``retry_backoff_s``
    exponential jittered backoff, the whole read bounded by
    ``retry_deadline_s`` — the budget that also rides out storage-wide
    brownouts); ``on_bad_sample`` declares how a batch completes when an
    item exhausts its retries or is permanently corrupt: ``"raise"``
    (pool-fatal, the legacy default), ``"skip"`` (drop the quarantined
    ids — delivered multiset = epoch permutation minus quarantine), or
    ``"substitute"`` (deterministically resample replacements).
    ``degraded_fault_rate`` (0 = off) is the windowed fault rate at which
    the loader flips its cache tier to serve-hits-first read-only mode
    until the storage heals.
    """
    num_workers: int = 0
    prefetch_factor: int = 2
    device_prefetch: int = 2
    use_processes: bool = False
    fast_path: bool = True
    zero_copy: bool = False
    ordered: bool = True
    transfer_threads: int = 1
    donate_transfer: bool = False
    locality_chunk: int = 0
    staging_buffers: int = 2
    cache_budget_bytes: int = 0
    slow_lane_workers: int = 0
    slow_lane_threshold: float = 4.0
    slow_lane_lookahead: int = 8
    retry_attempts: int = 2
    retry_backoff_s: float = 0.01
    retry_deadline_s: float = 2.0
    on_bad_sample: str = "raise"
    degraded_fault_rate: float = 0.5

    def __post_init__(self):
        if self.use_processes and not self.ordered:
            # ProcessWorkerPool delivery is inherently ordered (imap
            # submission order): silently honouring ordered=False would
            # hand back ordered batches under an unordered contract
            raise ValueError(
                "ordered=False is unsupported with use_processes=True "
                "(process delivery is always ordered); use threads for "
                "completion-order delivery")
        if self.slow_lane_workers < 0:
            raise ValueError("slow_lane_workers must be >= 0")
        if self.slow_lane_lookahead < 0:
            raise ValueError("slow_lane_lookahead must be >= 0")
        if self.slow_lane_threshold <= 1.0:
            raise ValueError("slow_lane_threshold must be > 1.0 (it is a "
                             "multiple of the median item cost)")
        if self.on_bad_sample not in ("raise", "skip", "substitute"):
            raise ValueError(
                "on_bad_sample must be 'raise', 'skip' or 'substitute', "
                f"got {self.on_bad_sample!r}")
        if self.retry_attempts < 0:
            raise ValueError("retry_attempts must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.retry_deadline_s <= 0:
            raise ValueError("retry_deadline_s must be > 0")
        if not 0.0 <= self.degraded_fault_rate <= 1.0:
            raise ValueError("degraded_fault_rate must be in [0, 1] "
                             "(0 disables degraded mode)")

    def replace(self, **kw) -> "LoaderParams":
        return dataclasses.replace(self, **kw)

    def arena_capacity(self) -> int:
        """Slab-ring size: every queueable batch + the device buffers.

        With the slow lane on, the pulled-but-undelivered span widens to
        window (queue depth + all workers) + lookahead, and every such
        batch may hold a slot (acquire-before-pull liveness: see
        ``ThreadWorkerPool._acquire_slot``) — size for it, or early-started
        slow batches could exhaust the slots the head sequence needs.
        """
        base = max(2, self.num_workers * self.prefetch_factor
                   + self.device_prefetch)
        if self.slow_lane_workers > 0 and self.ordered \
                and not self.use_processes:
            base += (self.num_workers + self.slow_lane_workers
                     + self.slow_lane_lookahead + 1)
        return base


@dataclasses.dataclass
class TransferStats:
    seconds: float
    batches: int
    bytes: int
    overflowed: bool = False
    peak_loader_bytes: int = 0
    # per-batch arrival deltas (wall-clock evaluators fill this in); the
    # variance-aware win test in repro_torch.tuning needs samples, not just a mean
    batch_seconds: Optional[List[float]] = None
    # IO-efficiency counters (DESIGN.md §5): storage requests issued during
    # the window, mean cache-miss items served per request (the measured
    # coalesced run length), and the device edge's staging-pool hit rate —
    # so retune decisions and benches see *locality*, not just bytes/s.
    # Zero/None when the storage backend keeps no counters / no staging ran.
    coalesced_requests: int = 0
    coalesced_run_len: float = 0.0
    staging_hit_rate: Optional[float] = None
    # cache effectiveness over the window (DESIGN.md §7): items served
    # from a cache (the cross-epoch tier and/or the storage's own page
    # cache) vs items that paid real IO.  Zero when nothing caches.
    cache_hits: int = 0
    cache_misses: int = 0
    # tail-cost signals (DESIGN.md §9): the cost tracker's estimated
    # per-item mean and p99 decode+IO seconds, and how many batches the
    # window routed to the slow lane.  Zero when no tracker ran.
    sample_cost_mean_s: float = 0.0
    sample_cost_p99_s: float = 0.0
    slow_batches: int = 0
    # fault-plane health over the window (DESIGN.md §10): retried reads,
    # raised faults, newly-quarantined items, process-worker resubmits,
    # and whether the loader ended the window in degraded (cache
    # read-only) mode.  Zero/False on a healthy storage.
    read_retries: int = 0
    read_faults: int = 0
    quarantined: int = 0
    resubmits: int = 0
    degraded: bool = False

    @property
    def bytes_per_second(self) -> float:
        return self.bytes / self.seconds if self.seconds > 0 else 0.0


class LoaderStream:
    """A live, hot-swappable batch stream over the loader's stateful sampler.

    ``apply_params`` retunes the stream in place: the current worker pool
    stops pulling new index-batches (``request_drain``), everything it
    already pulled is delivered in turn, then a fresh pool starts with the
    new (num_workers, prefetch_factor) from exactly the sampler position
    where the old pool stopped.  The swap is requested from any thread and
    performed by whoever consumes the stream; ``swaps`` counts completed
    swaps.  ``device_prefetch`` depth is hot-swapped too: the live
    prefetcher's depth gate is retargeted at the same boundary.

    ``apply_reshard`` is the elastic fleet transition (a host died or
    joined).  Unlike a params swap, a reshard must NOT deliver what the
    pool pre-pulled under the old shard map — those index-batches belong
    to the old topology.  The stream stops yielding at the agreed global
    batch barrier (``at_batch``), discards the pool (every in-flight arena
    slot still returns), rewinds the sampler to exactly the delivered
    position, remaps (shard, num_shards), and restarts — so the batches a
    consumer sees are precisely: old-shard slices of global batches before
    the barrier, new-shard slices after it.  Optional ``makeup`` index
    chunks (a dead host's undelivered slices, redistributed by the
    coordinator) are delivered first after the barrier.  ``position`` is
    the stream's absolute global-batch cursor; exact accounting relies on
    ordered delivery (``LoaderParams.ordered``, the default).
    """

    def __init__(self, loader: "DataLoader", *, to_device: bool = True):
        self.loader = loader
        self.to_device = to_device
        self.swaps = 0
        self.reshards = 0
        # schedule-aware: epochs can have different lengths once the
        # geometry schedule has more than one step
        self.position = loader.sampler.absolute()
        # per-yield position log: makeup yields do not advance ``position``,
        # so a consumer's absolute regular-batch position after its k-th
        # consumed yield is position_after(k), NOT initial + k.  The fleet
        # coordinator's makeup accounting for a dead host relies on this
        # (counting observes as regular batches loses samples as soon as a
        # host that consumed makeup dies).
        self.yields = 0
        self._initial_position = self.position
        self._pos_log: deque = deque()
        self._pos_log_base = 0           # yield index of _pos_log[0]
        self._pending: Optional[LoaderParams] = None
        self._pending_locality_epoch: Optional[int] = None
        self._pending_reshard: Optional[
            Tuple[int, int, int, Optional[Tuple[int, ...]]]] = None
        self._pending_makeup: List[np.ndarray] = []  # held until the barrier
        self._makeup: deque = deque()        # index chunks awaiting delivery
        # one flag per index-batch the pool pulled, in pull order (ordered
        # delivery preserves it): True = makeup chunk, whose yield must NOT
        # advance the regular-batch position
        self._pull_kinds: deque = deque()
        # makeup chunks the current pool pulled but has not delivered yet:
        # a reshard's discard boundary regenerates regular batches by
        # rewinding the sampler, but pulled makeup exists nowhere else —
        # it must be pushed back onto the queue or the samples are lost
        self._inflight_makeup: deque = deque()
        # makeup chunks tagged with the yield index that delivered them:
        # yielded-into-a-prefetcher is not consumed, so a dead host's
        # coordinator asks for makeup past its CONSUMED yield count
        # (undelivered_makeup(consumed_yields=...)) — popping at yield
        # time alone would lose prefetcher-buffered makeup with the host
        self._yielded_makeup: deque = deque()   # (yield index, chunk)
        self._lock = threading.Lock()
        self._prefetcher: Optional[DevicePrefetcher] = None
        self._host_gen = self._host_stream()
        if to_device:
            self._prefetcher = DevicePrefetcher(
                self._host_gen, depth=loader.params.device_prefetch,
                device=loader.device,
                transfer_threads=loader.params.transfer_threads,
                donate=loader.params.donate_transfer,
                staging_buffers=loader.params.staging_buffers)
            self._iter = iter(self._prefetcher)
        else:
            self._iter = self._host_gen

    def close(self) -> None:
        """Tear the stream down deterministically: stop the prefetcher,
        close the host generator (its finally shuts the pool down), and
        return every in-flight arena slot to the loader's arena — so an
        abandoned stream can never strand slots a future stream needs."""
        if self._prefetcher is not None:
            self._prefetcher.close()
        self._host_gen.close()

    def apply_params(self, params: LoaderParams, *,
                     locality_epoch: Optional[int] = None) -> None:
        """Request a hot swap; takes effect at the next batch boundary.

        ``locality_epoch`` pins the epoch the new ``locality_chunk``
        latches at (fleet-uniform pushes; see ``ShardedSampler
        .set_locality``); None keeps the per-host natural latch.
        """
        with self._lock:
            self._pending = params
            self._pending_locality_epoch = locality_epoch

    def apply_reshard(self, num_shards: int, shard: int, *,
                      at_batch: Optional[int] = None,
                      makeup: Optional[Sequence[np.ndarray]] = None,
                      sizes: Optional[Sequence[int]] = None) -> int:
        """Request an elastic reshard at global batch ``at_batch``.

        ``at_batch`` is an absolute global-batch position; None means the
        next batch boundary.  If the stream has already yielded past it,
        the boundary is clamped up to ``position`` and the EFFECTIVE
        boundary is returned — the coordinator re-issues the request to
        the whole fleet at the max effective boundary until it is common
        (once a request is pending the stream cannot yield past its
        boundary, so the negotiation converges).  ``makeup`` index chunks
        are delivered right after the barrier, before regular new-shard
        batches; post-settlement chunks arrive via :meth:`add_makeup`.
        ``sizes`` is an explicit per-shard split of the global batch
        (ragged survivor counts, per-host consensus weights); see
        ``ShardedSampler.reshard``.
        """
        with self._lock:
            boundary = self.position if at_batch is None \
                else max(at_batch, self.position)
            self._pending_reshard = (
                num_shards, shard, boundary,
                tuple(int(s) for s in sizes) if sizes is not None else None)
            if makeup:
                # held back until the barrier commits: the pool running
                # NOW must not interleave makeup with old-shard batches
                self._pending_makeup.extend(
                    np.asarray(m) for m in makeup if len(m))
            return boundary

    def undelivered_makeup(self, consumed_yields: Optional[int] = None
                           ) -> List[np.ndarray]:
        """Makeup chunks accepted but not yet delivered (queued, pulled
        in-flight, or parked behind a pending reshard).  A fleet
        coordinator re-redistributes these when THIS host leaves — makeup
        parked on a corpse is otherwise lost.

        ``consumed_yields`` additionally recovers makeup the stream
        *yielded* past that count — batches sitting in a device
        prefetcher the dead host never consumed (None assumes every
        yield was consumed, exact for undecorated host streams)."""
        with self._lock:
            out = (list(self._inflight_makeup) + list(self._makeup)
                   + list(self._pending_makeup))
            if consumed_yields is not None:
                out = [c for y, c in self._yielded_makeup
                       if y > consumed_yields] + out
            return out

    def position_after(self, consumed_yields: int) -> int:
        """Absolute regular-batch position after this stream's first
        ``consumed_yields`` yields (makeup yields do not advance it).

        The log is pruned up to the queried point, so callers must query
        with nondecreasing counts — a consumer tracking its own progress
        does.  Queries past the log's tail return the current position.
        """
        if consumed_yields <= 0:
            return self._initial_position
        with self._lock:
            while len(self._pos_log) > 1 \
                    and self._pos_log_base < consumed_yields - 1:
                self._pos_log.popleft()
                self._pos_log_base += 1
            if not self._pos_log:
                return self._initial_position if self.yields == 0 \
                    else self.position
            idx = consumed_yields - 1 - self._pos_log_base
            if idx < 0:                  # pruned past (capped log)
                return self._pos_log[0]
            if idx >= len(self._pos_log):  # consumer claims > yielded
                return self._pos_log[-1]
            return self._pos_log[idx]

    def add_makeup(self, makeup: Sequence[np.ndarray]) -> None:
        """Queue makeup index chunks for delivery.

        Before the reshard commits they are parked with the pending
        request; afterwards they go straight into the live feed (the
        pull-kind FIFO keeps position accounting exact wherever they
        interleave).
        """
        with self._lock:
            arrays = [np.asarray(m) for m in makeup if len(m)]
            if self._pending_reshard is not None:
                self._pending_makeup.extend(arrays)
            else:
                self._makeup.extend(arrays)

    # ---- internals ---------------------------------------------------------
    def _reshard_due_locked(self) -> bool:
        return (self._pending_reshard is not None
                and self.position >= self._pending_reshard[2])

    def _commit_reshard(self) -> None:
        """At the barrier, with no pool running: rewind the sampler to the
        delivered position, remap the shard, and re-spec the slab arena
        (the local batch shape changed)."""
        with self._lock:
            num_shards, shard, _, sizes = self._pending_reshard
            self._pending_reshard = None
            # makeup the discarded pool pulled but never delivered goes
            # back to the FRONT of the queue (it was next in line); the
            # chunks are absolute sample indices, so they remain valid
            # under the new shard map
            self._makeup.extendleft(reversed(self._inflight_makeup))
            self._inflight_makeup.clear()
            self._makeup.extend(self._pending_makeup)
            self._pending_makeup = []
            # pulled-but-undelivered flags belong to the discarded pool
            self._pull_kinds.clear()
        sampler = self.loader.sampler
        sampler.state = sampler.state_at(self.position)
        sampler.reshard(num_shards, shard, sizes=sizes)
        if self.loader._stream_arena is not None:
            # only batches of the NEW local size may establish the fresh
            # spec — a ragged makeup chunk must not pin the arena shape
            self.loader._stream_arena.respec(
                expected_leading=sampler.local_batch)
        # the cache tier keys on ABSOLUTE sample indices, so a shard remap
        # leaves every resident item valid: re-spec, never drop
        self.loader._sync_cache_plan()
        self.reshards += 1

    def _indices(self):
        """The pool's index feed: queued makeup chunks first (pulled from
        the shared deque, so chunks an outgoing pool never pulled remain
        for the next pool), then the stateful sampler.  Each pull logs its
        kind so the consumer can tell a yielded makeup batch (no position
        advance) from a regular one at any interleaving."""
        sampler_it = iter(self.loader.sampler)
        last_lb = self.loader.sampler.local_batch
        while True:
            with self._lock:             # pool pump thread vs. consumer /
                idx = None               # coordinator readers
                if self._makeup:
                    idx = self._makeup.popleft()
                    self._pull_kinds.append(True)
                    self._inflight_makeup.append(idx)
            if idx is not None:
                yield idx
            else:
                idx = next(sampler_it)
                if len(idx) != last_lb:
                    # a geometry latch crossed an epoch boundary (or the
                    # split went ragged): the local batch changed shape,
                    # so the slab arena must re-spec — in-flight slots of
                    # the old spec drain out via their generation stamp
                    last_lb = len(idx)
                    arena = self.loader._stream_arena
                    if arena is not None:
                        arena.respec(expected_leading=last_lb)
                self._pull_kinds.append(False)
                yield idx

    def _note_skip(self) -> None:
        """A pool-level skip (fault policy dropped an all-quarantined
        batch) consumed one pulled index-batch without a yield: pop its
        pull-kind so the FIFO stays aligned, and advance the regular-batch
        cursor — the sampler moved past it.  A skipped makeup chunk is
        consumed, not re-queued: its samples are quarantined.  Runs on the
        consumer thread, in delivery order, like the accounting below."""
        with self._lock:
            if self._pull_kinds and self._pull_kinds.popleft():
                if self._inflight_makeup:
                    self._inflight_makeup.popleft()
            else:
                self.position += 1

    def _host_stream(self):
        while True:
            with self._lock:
                due = self._reshard_due_locked()
            if due:
                self._commit_reshard()
            pool, _monitor = self.loader._pool(self._indices(),
                                               for_stream=True,
                                               on_skip=self._note_skip)
            draining = False
            resharding = False
            it = iter(pool)
            try:
                while True:
                    with self._lock:
                        if self._reshard_due_locked():
                            resharding = True
                    if resharding:
                        # discard boundary: pre-pulled batches belong to
                        # the old shard map and must not be delivered
                        break
                    if not draining and self._pending is not None:
                        pool.request_drain()
                        draining = True
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    # account BEFORE the yield: the generator parks there,
                    # and the consumer holding the batch means the position
                    # has advanced past it.  The pull-kind FIFO (ordered
                    # delivery preserves pull order) tells makeup batches —
                    # which never advance the position — from regular ones.
                    # under the lock: with to_device=True this loop runs
                    # on the prefetcher thread while consumed_position /
                    # undelivered_makeup read the same structures from
                    # the trainer or coordinator thread
                    with self._lock:
                        if self._pull_kinds and self._pull_kinds.popleft():
                            chunk = self._inflight_makeup.popleft()
                            self._yielded_makeup.append((self.yields + 1,
                                                         chunk))
                            if len(self._yielded_makeup) > 1024:
                                self._yielded_makeup.popleft()
                        else:
                            self.position += 1
                        self.yields += 1
                        self._pos_log.append(self.position)
                        if len(self._pos_log) > 65536:   # unconsulted cap
                            self._pos_log.popleft()
                            self._pos_log_base += 1
                    yield batch
            finally:
                # normal end (drain swap / reshard discard) or the stream
                # being closed/abandoned: either way every in-flight slot
                # must return to the arena
                it.close()
                pool.shutdown()
            with self._lock:
                params, self._pending = self._pending, None
                latch, self._pending_locality_epoch = \
                    self._pending_locality_epoch, None
            if params is not None:
                # re-assert the pending params at the boundary: trial
                # measurements may have mutated loader.params via
                # with_params between the request and this drain
                self.loader.params = params
                # locality latches at the next epoch boundary — an
                # in-progress epoch keeps its permutation (coverage);
                # a fleet push pins one common latch epoch instead
                self.loader.sampler.set_locality(params.locality_chunk,
                                                 epoch=latch)
                # the cache tier survives the swap (resized in place); the
                # sampler's hot/cold interleave latches at the same epoch
                self.loader._sync_cache_plan(epoch=latch)
                self.swaps += 1
                if self._prefetcher is not None:
                    self._prefetcher.set_depth(params.device_prefetch)
                    self._prefetcher.set_staging(params.staging_buffers)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._iter)


class DataLoader:
    def __init__(self, dataset: Dataset, global_batch: int, *,
                 params: LoaderParams = LoaderParams(),
                 shuffle: bool = True, seed: int = 0,
                 host_index: int = 0, host_count: int = 1,
                 memory_budget: Optional[MemoryBudget] = None,
                 device="cuda",
                 sampler_state: Optional[SamplerState] = None):
        self.dataset = dataset
        self.params = params
        self.memory_budget = memory_budget
        self.device = resolve_device(device)
        self._live_stream: Optional[LoaderStream] = None
        self._stream_arena: Optional[SlabArena] = None
        self._cache_tier: Optional[CacheTier] = None
        self._mean_item_nbytes: Optional[float] = None
        # per-item cost EWMAs persist across pools/streams/hot swaps: the
        # slow-lane predictor must survive the very retune that enables it
        self.cost_tracker = SampleCostTracker(
            len(dataset), threshold=params.slow_lane_threshold)
        # fault-plane state (DESIGN.md §10), shared by every pool this
        # loader creates: the quarantine rides state_dict like costs, and
        # the stats' degraded flip drives the cache tier's read-only mode
        self.quarantine = QuarantineLog()
        self.fault_stats = FaultStats(
            degraded_enter=params.degraded_fault_rate,
            on_degraded=self._on_degraded)
        self.sampler = ShardedSampler(
            len(dataset), global_batch, shuffle=shuffle, seed=seed,
            host_index=host_index, host_count=host_count,
            state=sampler_state, locality_chunk=params.locality_chunk)
        if params.cache_budget_bytes > 0:
            self._sync_cache_plan()

    @property
    def global_batch(self) -> int:
        """The current epoch's global batch (elastic — follows the
        sampler's geometry schedule)."""
        return self.sampler.global_batch

    def set_geometry(self, global_batch: int, *,
                     epoch: Optional[int] = None) -> int:
        """Change the global batch, epoch-latched (see ``ShardedSampler
        .set_geometry``).  A live stream needs no restart: batch
        boundaries only move from the latch epoch on, the stateful
        sampler crosses into the new geometry naturally, and the stream's
        index feed re-specs the slab arena when the local batch shape
        changes.  Returns the effective first epoch."""
        return self.sampler.set_geometry(global_batch, epoch=epoch)

    # ---- fault plane (DESIGN.md §10) ---------------------------------------
    def _on_degraded(self, degraded: bool) -> None:
        """Degraded-mode flip: the cache tier serves hits but admits
        nothing while the storage is browning out (read-only survives a
        flush-refill cycle the failing reads could never win), and goes
        back to normal admission once successes dilute the fault rate."""
        tier = self._cache_tier
        if tier is not None:
            tier.read_only = degraded

    def _on_quarantine(self, ids: List[int]) -> None:
        """Quarantined items exit cost tracking: a permanently-failing id
        must stop dragging the tail stats and slow-lane routing."""
        self.cost_tracker.forget(ids)

    def _fault_policy(self) -> FaultPolicy:
        """The policy pools run reads through, rebuilt per pool from the
        (hot-swappable) params; the quarantine/stats live on the loader."""
        p = self.params
        self.fault_stats.degraded_enter = max(0.0, p.degraded_fault_rate)
        return FaultPolicy(
            retry=RetryPolicy(attempts=p.retry_attempts,
                              backoff_s=p.retry_backoff_s,
                              deadline_s=p.retry_deadline_s),
            quarantine=self.quarantine, stats=self.fault_stats,
            on_bad_sample=p.on_bad_sample, num_items=len(self.dataset),
            seed=getattr(self.sampler, "seed", 0),
            on_quarantine=self._on_quarantine)

    # ---- cache tier (DESIGN.md §7) -----------------------------------------
    @property
    def cache_tier(self) -> Optional[CacheTier]:
        return self._cache_tier

    def _item_nbytes_mean(self) -> float:
        if self._mean_item_nbytes is None:
            st = self.dataset.storage
            n = min(len(st), 16)
            sizes = [st.item_nbytes(i) for i in range(n)] or [0]
            self._mean_item_nbytes = float(np.mean(sizes))
        return self._mean_item_nbytes

    def _ensure_tier(self) -> int:
        """Create or re-spec the cross-epoch cache tier from the current
        params; returns the planned hot-chunk count.  The tier is owned by
        the loader and persists across hot swaps and reshards — a budget
        change is a resize (trim/grow), never a flush."""
        p = self.params
        budget = max(0, p.cache_budget_bytes)
        chunk = max(1, p.locality_chunk)
        if budget <= 0:
            if self._cache_tier is not None:
                self._cache_tier.reconfigure(budget_bytes=0, chunk=chunk)
            return 0
        if self._cache_tier is None:
            # the live stream's slab arena shares the budget: its in-use
            # bytes are deducted from the tier's effective budget (late
            # bound — the arena is created lazily by the first stream)
            def arena_bytes() -> int:
                arena = self._stream_arena
                return arena.nbytes_in_use() if arena is not None else 0

            self._cache_tier = CacheTier(
                budget, chunk=chunk, num_items=len(self.dataset),
                item_nbytes=self._item_nbytes_mean(),
                arena_bytes=arena_bytes)
        else:
            self._cache_tier.reconfigure(
                budget_bytes=budget, chunk=chunk,
                num_items=len(self.dataset),
                item_nbytes=self._item_nbytes_mean())
        return self._cache_tier.hot_chunks

    def _sync_cache_plan(self, *, epoch: Optional[int] = None) -> None:
        """Re-derive the tier spec AND the sampler's hot/cold interleave
        from the current params.  Called wherever ``set_locality`` is —
        the plan changes the epoch permutation, so it rides the exact same
        epoch latch (a fleet pins one common epoch for both)."""
        self.sampler.set_cache_plan(self._ensure_tier(), epoch=epoch)

    def _cached_dataset(self, *, admit: bool) -> Dataset:
        """The dataset as read through the cache tier (identity when the
        tier is off or a process pool would fork it away)."""
        if (self._cache_tier is None or self._cache_tier.budget_bytes <= 0
                or self._uses_processes()):
            return self.dataset
        return self.dataset.with_storage(
            CachedStorage(self.dataset.storage, self._cache_tier,
                          admit=admit))

    # ---- checkpointable state ---------------------------------------------
    def state_dict(self):
        return {"sampler": self.sampler.state.to_dict(),
                "params": dataclasses.asdict(self.params),
                "locality": self.sampler.locality_state(),
                "cache_plan": self.sampler.cache_state(),
                "geometry": self.sampler.geometry_state(),
                "shard_sizes": list(self.sampler.shard_sizes)
                if self.sampler.shard_sizes is not None else None,
                "costs": self.cost_tracker.state_dict(),
                "quarantine": self.quarantine.state_dict()}

    def load_state_dict(self, d):
        self.sampler.state = SamplerState.from_dict(d["sampler"])
        self.params = LoaderParams(**d["params"])
        if "locality" in d:
            # the full schedule restores a mid-epoch deferred change exactly
            self.sampler.load_locality(d["locality"])
        else:                          # pre-locality checkpoint
            self.sampler.force_locality(self.params.locality_chunk)
        if "geometry" in d:            # pre-elastic checkpoints keep the
            self.sampler.load_geometry(d["geometry"])   # constructed batch
        if d.get("shard_sizes") is not None:
            self.sampler._shard_sizes = tuple(
                int(s) for s in d["shard_sizes"])
        hot_k = self._ensure_tier()    # re-spec (never flush) the tier
        if "cache_plan" in d:
            self.sampler.load_cache_plan(d["cache_plan"])
        else:                          # pre-cache checkpoint
            self.sampler.force_cache_plan(hot_k)
        if "costs" in d:               # pre-costs checkpoints start cold
            self.cost_tracker.load_state_dict(d["costs"])
        if "quarantine" in d:          # pre-fault checkpoints start clean
            self.quarantine.load_state_dict(d["quarantine"])

    def with_params(self, params: LoaderParams) -> "DataLoader":
        """Set params for *future* pools (trial measurements, restarts).
        Does not swap a live stream's pool — use ``apply_params`` for
        that.  ``locality_chunk`` does latch into the (shared) sampler
        schedule, effective from the next epoch that hasn't started — so
        a restart honours it; a live stream keeps its current epoch's
        order either way.  (DPT trials never hit this: they preserve the
        loader's locality via ``replace`` and measure candidate chunks
        through the ``measure_transfer_time(locality_chunk=...)``
        override.)"""
        self.params = params
        self.sampler.set_locality(params.locality_chunk)
        self._sync_cache_plan()
        return self

    def apply_params(self, params: LoaderParams, *,
                     locality_epoch: Optional[int] = None) -> LoaderParams:
        """Hot-swap tuned parameters in.

        ``self.params`` is set immediately (any future pool — a new
        stream, a trial measurement default — uses the new values even if
        the current stream was abandoned mid-iteration), and the latest
        live ``stream()`` is asked to swap at its next batch boundary
        (pool drained, sampler position preserved, no batch lost or
        duplicated).  ``locality_epoch`` pins the epoch a changed
        ``locality_chunk`` latches at (fleet-uniform pushes must land on
        one common epoch across hosts; see ``locality_latch_epoch``).
        """
        self.params = params
        if self._live_stream is not None:
            # sampler locality syncs when the stream commits the swap
            self._live_stream.apply_params(params,
                                           locality_epoch=locality_epoch)
        else:
            self.sampler.set_locality(params.locality_chunk,
                                      epoch=locality_epoch)
            self._sync_cache_plan(epoch=locality_epoch)
        return params

    def locality_latch_epoch(self) -> int:
        """The earliest epoch a locality change pushed NOW is guaranteed
        to be latchable at, accounting for producer run-ahead.

        The sampler's producer cursor advances ahead of delivery by at
        most the pipeline's in-flight capacity (worker queues + device
        prefetch) before a pending swap pins it, so a chunk pinned to
        this epoch can always be honoured exactly — the per-host clamp
        in ``set_locality`` never has to move it.  A fleet coordinator
        takes the max over hosts and pushes that one epoch everywhere.
        """
        p = self.params
        inflight = p.num_workers * p.prefetch_factor + p.device_prefetch + 1
        if p.slow_lane_workers > 0 and p.ordered:
            # the slow lane's wider sequence window lets the producer pull
            # that much further ahead of delivery
            inflight += p.slow_lane_workers + p.slow_lane_lookahead
        return self.sampler.latch_epoch_for(
            self.sampler.absolute() + inflight)

    def reshard(self, num_shards: int, shard: int, *,
                at_batch: Optional[int] = None,
                makeup: Optional[Sequence[np.ndarray]] = None,
                sizes: Optional[Sequence[int]] = None) -> int:
        """Elastic reshard: remap this host's shard of the global stream.

        With a live stream the remap happens at the ``at_batch`` barrier
        via :meth:`LoaderStream.apply_reshard` (in-flight old-shard batches
        discarded, sampler rewound to the delivered position, optional
        ``makeup`` chunks delivered first).  Without one the sampler is
        remapped in place — its position IS the consumed position; makeup
        would have no delivery channel, so it is rejected.  Returns the
        effective barrier (see ``apply_reshard``).
        """
        if self._live_stream is not None:
            return self._live_stream.apply_reshard(
                num_shards, shard, at_batch=at_batch, makeup=makeup,
                sizes=sizes)
        if makeup:
            raise ValueError("makeup delivery needs a live stream; "
                             "start one with stream() first")
        self.sampler.reshard(num_shards, shard, sizes=sizes)
        return self.sampler.absolute()

    def add_makeup(self, makeup: Sequence[np.ndarray]) -> None:
        """Queue makeup chunks on the live stream (see
        ``LoaderStream.add_makeup``)."""
        if self._live_stream is None:
            raise ValueError("makeup delivery needs a live stream; "
                             "start one with stream() first")
        self._live_stream.add_makeup(makeup)

    def undelivered_makeup(self, consumed_yields: Optional[int] = None
                           ) -> List[np.ndarray]:
        """Makeup chunks the live stream has accepted but not delivered
        (empty without a stream; see ``LoaderStream.undelivered_makeup``
        for ``consumed_yields``)."""
        if self._live_stream is None:
            return []
        return self._live_stream.undelivered_makeup(consumed_yields)

    # ---- iteration ----------------------------------------------------------
    def _arena(self, *, for_stream: bool) -> Optional[SlabArena]:
        """The slab arena for a new pool, when zero-copy engages.

        The live stream's arena is owned by the loader and persists across
        hot swaps (a drain delivers every in-flight slot and the consumer's
        releases return them here, so the new pool starts with warm slabs);
        side-channel pools (trial measurements racing the live stream,
        one-epoch ``host_batches``) get their own throwaway arena so they
        never contend with the stream for slots.
        """
        p = self.params
        use_processes = p.use_processes and p.num_workers > 0
        if not (p.fast_path and p.zero_copy and not use_processes
                and self.dataset.supports_fast_path):
            return None
        if not for_stream:
            return SlabArena(p.arena_capacity())
        if self._stream_arena is None:
            self._stream_arena = SlabArena(p.arena_capacity())
        else:
            self._stream_arena.resize(p.arena_capacity())
        return self._stream_arena

    def _pool(self, index_iter, *, for_stream: bool = False,
              dataset: Optional[Dataset] = None, on_skip=None):
        monitor = MemoryMonitor(self.memory_budget)
        cls = ProcessWorkerPool if (self.params.use_processes
                                    and self.params.num_workers > 0) \
            else ThreadWorkerPool
        if dataset is None:
            # the live stream reads (and admits) through the cache tier;
            # side-channel pools default to the plain dataset unless the
            # caller hands in its own view (trial isolation)
            dataset = self._cached_dataset(admit=True) if for_stream \
                else self.dataset
        # the (hot-swappable) threshold lives in params; the EWMA table in
        # the long-lived tracker — sync at pool birth so a retuned
        # threshold reclassifies without losing learned costs
        self.cost_tracker.threshold = self.params.slow_lane_threshold
        pool = cls(dataset, index_iter,
                   num_workers=self.params.num_workers,
                   prefetch_factor=self.params.prefetch_factor,
                   monitor=monitor,
                   ordered=self.params.ordered,
                   fast=self.params.fast_path,
                   arena=self._arena(for_stream=for_stream),
                   cost_tracker=self.cost_tracker,
                   slow_lane_workers=self.params.slow_lane_workers,
                   slow_lane_lookahead=self.params.slow_lane_lookahead,
                   fault_policy=self._fault_policy(),
                   on_skip=on_skip)
        return pool, monitor

    def host_batches(self, *, epoch: Optional[int] = None,
                     num_batches: Optional[int] = None) -> Iterator:
        """Host-side numpy batches (one epoch, or the stateful stream)."""
        idx_iter = self.sampler.epoch_iter(epoch) if epoch is not None \
            else iter(self.sampler)
        if num_batches is not None:
            idx_iter = _take(idx_iter, num_batches)
        pool, _monitor = self._pool(idx_iter)
        return iter(pool)

    def stream(self, *, to_device: bool = True) -> LoaderStream:
        """The live, hot-swappable stream (see LoaderStream).  A previous
        live stream is closed first: its worker pool would otherwise keep
        holding slots of the shared stream arena forever."""
        if self._live_stream is not None:
            self._live_stream.close()
        self._live_stream = LoaderStream(self, to_device=to_device)
        return self._live_stream

    def __iter__(self):
        """Device-side batches (stateful stream, prefetched, swappable)."""
        return iter(self.stream())

    # ---- the DPT objective ---------------------------------------------------
    def _uses_processes(self) -> bool:
        return self.params.use_processes and self.params.num_workers > 0

    def io_counters(self) -> dict:
        """Live IO-efficiency snapshot for the monitor report: storage
        request counters (+ achieved coalesced run length), the live
        stream's staging-pool hit rate, and the arena hit rate.  Empty
        when nothing in the pipeline keeps counters — including process
        pools, whose reads increment counters in the forked children, not
        here (zeros would read as "no locality", which is a lie)."""
        out: dict = {}
        c = None if self._uses_processes() \
            else storage_io_counters(self.dataset.storage)
        if c is not None:
            out.update(c)
            misses = c["reads"] - c["cache_hits"]
            out["coalesced_run_len"] = (
                misses / c["coalesced_requests"]
                if c["coalesced_requests"] else 0.0)
        tier = self._cache_tier
        if tier is not None and not self._uses_processes():
            out.update(tier.counters())
            if c is not None:
                # tier hits never reach the storage at all; fold them into
                # the request totals so cache effectiveness reads out of
                # the same reads/cache_hits split controllers already use
                # (reads - cache_hits, the true-IO miss count, is
                # unchanged: tier hits add to both sides)
                out["reads"] = c["reads"] + tier.hits
                out["cache_hits"] = c["cache_hits"] + tier.hits
        stream = self._live_stream
        if stream is not None and stream._prefetcher is not None:
            hr = stream._prefetcher.staging_hit_rate
            if hr is not None:
                out["staging_hit_rate"] = hr
        if self._stream_arena is not None:
            out["arena_hit_rate"] = self._stream_arena.hit_rate
        tracker = self.cost_tracker
        if tracker.records:
            # tail-cost signals (DESIGN.md §9): these ride HostReport.io to
            # the fleet coordinator and feed the online retune trigger
            out["sample_cost_mean_s"] = tracker.mean()
            out["sample_cost_p99_s"] = tracker.p99()
            out["sample_cost_tail_ratio"] = tracker.tail_ratio()
            out["slow_batches"] = float(tracker.slow_batches)
        fs = self.fault_stats
        if fs.read_faults or fs.read_retries or fs.resubmits \
                or len(self.quarantine) or fs.degraded:
            # fault-plane health (DESIGN.md §10): valid in process mode too
            # — children ship their tallies back and the parent merges them
            out["read_retries"] = float(fs.read_retries)
            out["read_faults"] = float(fs.read_faults)
            out["quarantined"] = float(len(self.quarantine))
            out["resubmits"] = float(fs.resubmits)
            out["degraded"] = 1.0 if fs.degraded else 0.0
            out["fault_rate"] = fs.fault_rate()
        return out

    def _prewarm_tier(self, tier: CacheTier) -> None:
        """Fill ``tier``'s hot set as a warm epoch would find it.

        Reads bypass a latency-injecting wrapper's delay (via its
        ``inner``) — the pre-warm models "these items were admitted in a
        PREVIOUS epoch", whose IO cost was already paid there, so it must
        not charge this trial's measurement window either."""
        src = getattr(self.dataset.storage, "inner", self.dataset.storage)
        n = min(tier.hot_chunks * tier.chunk, len(self.dataset.storage))
        for start in range(0, n, 256):
            idx = list(range(start, min(start + 256, n)))
            for i, item in zip(idx, src.read_batch(idx)):
                tier.admit(i, np.asarray(item))

    def measure_transfer_time(self, num_batches: int, *,
                              epoch: int = 0,
                              to_device: bool = True,
                              locality_chunk: Optional[int] = None,
                              cache_budget_bytes: Optional[int] = None,
                              slow_lane_workers: Optional[int] = None,
                              global_batch: Optional[int] = None
                              ) -> TransferStats:
        """Wall-clock time to deliver ``num_batches`` (storage->host[->HBM]).

        With ``to_device`` the window ends only after the last batch's copy
        has landed: the prefetcher's lane waits for each copy's event
        before it hands the batch on, so the time holds the copies and not
        only their enqueue.

        Raises MemoryOverflow through TransferStats.overflowed=True so
        Algorithm 1's inner-loop break can act on it.  ``locality_chunk``
        overrides the sampler's scheduled chunking for this measurement
        only (how DPT trials price the locality axis without perturbing a
        live stream's epoch order).

        ``cache_budget_bytes`` is the cache axis's measurement-only
        override: ``None`` (default) reads through the LIVE tier without
        admitting (hits are real, the trial never pollutes the cache);
        ``0`` bypasses the tier entirely; ``B > 0`` measures a throwaway
        tier of budget B — pre-warmed when ``epoch >= 1``, since a warm
        epoch finds the hot set already resident.

        ``slow_lane_workers`` is the slow-lane axis's measurement-only
        override: the trial pool runs with that lane width (sharing the
        loader's learned cost tracker — the lane is only as good as its
        predictor), ``self.params`` restored afterwards.

        ``global_batch`` is the geometry axis's measurement-only
        override: the trial iterates a THROWAWAY sampler with the
        candidate global batch (even per-host split), so DPT can price
        batch geometries without touching the live sampler's schedule or
        position.
        """
        if slow_lane_workers is not None \
                and slow_lane_workers != self.params.slow_lane_workers:
            saved = self.params
            self.params = self.params.replace(
                slow_lane_workers=slow_lane_workers)
            try:
                return self.measure_transfer_time(
                    num_batches, epoch=epoch, to_device=to_device,
                    locality_chunk=locality_chunk,
                    cache_budget_bytes=cache_budget_bytes,
                    global_batch=global_batch)
            finally:
                self.params = saved
        trial_sampler = self.sampler
        if global_batch is not None \
                and int(global_batch) != self.sampler.gb_for_epoch(epoch):
            s = self.sampler
            trial_sampler = ShardedSampler(
                s.num_items, int(global_batch), shuffle=s.shuffle,
                seed=s.seed, drop_last=s.drop_last,
                host_index=s.host_index, host_count=s.host_count,
                layout=s.layout,
                shard_sizes=ShardedSampler.even_split(int(global_batch),
                                                      s.host_count))
            trial_sampler.load_locality(s.locality_state())
            trial_sampler.load_cache_plan(s.cache_state())
        # static pre-check (the paper's N/A cells fail before running)
        if self.memory_budget is not None:
            probe = self.dataset.get_batch(
                trial_sampler.local_indices(epoch, 0, locality_chunk)[:1])
            est_batch = batch_nbytes(probe) * trial_sampler.local_batch
            est = estimate_loader_footprint(
                est_batch, self.params.num_workers,
                self.params.prefetch_factor, self.params.device_prefetch)
            if est > self.memory_budget.loader_bytes * 4:
                return TransferStats(float("inf"), 0, 0, overflowed=True)

        # the trial's read view (cache axis): live tier read-only, plain
        # dataset, or a throwaway tier — never admit into the live tier
        trial_tier: Optional[CacheTier] = None
        if self._uses_processes() or (cache_budget_bytes is not None
                                      and cache_budget_bytes <= 0):
            trial_dataset = self.dataset
        elif cache_budget_bytes is None:
            trial_dataset = self._cached_dataset(admit=False)
            if trial_dataset is not self.dataset:
                trial_tier = self._cache_tier
        else:
            chunk = locality_chunk if locality_chunk is not None \
                else self.params.locality_chunk
            trial_tier = CacheTier(int(cache_budget_bytes),
                                   chunk=max(1, chunk),
                                   num_items=len(self.dataset),
                                   item_nbytes=self._item_nbytes_mean())
            if epoch >= 1:     # a warm epoch finds the hot set resident
                self._prewarm_tier(trial_tier)
            trial_dataset = self.dataset.with_storage(
                CachedStorage(self.dataset.storage, trial_tier, admit=True))

        idx_iter = _take(trial_sampler.epoch_iter(epoch, locality_chunk),
                         num_batches)
        # snapshot BEFORE _pool(): worker threads start reading the moment
        # the pool is constructed, and their requests belong to this window.
        # Process pools read in the forked children — their parent-side
        # counters never move, so skip attribution rather than report 0.
        io_before = None if self._uses_processes() \
            else storage_io_counters(self.dataset.storage)
        tier_before = (trial_tier.hits, trial_tier.misses) \
            if trial_tier is not None else (0, 0)
        slow_before = self.cost_tracker.slow_batches
        fault_before = self.fault_stats.snapshot()
        q_before = len(self.quarantine)
        pool, monitor = self._pool(idx_iter, dataset=trial_dataset)
        total_bytes = 0
        n = 0

        def _counted(it):
            nonlocal total_bytes
            for b in it:
                total_bytes += batch_nbytes(b)
                yield b

        start = time.perf_counter()
        prev = start
        deltas: List[float] = []
        prefetcher = None
        try:
            it = _counted(iter(pool))
            if to_device:
                prefetcher = DevicePrefetcher(
                    it, depth=self.params.device_prefetch,
                    device=self.device,
                    transfer_threads=self.params.transfer_threads,
                    donate=self.params.donate_transfer,
                    staging_buffers=self.params.staging_buffers)
                it = iter(prefetcher)
            for _batch in it:
                n += 1
                now = time.perf_counter()
                deltas.append(now - prev)
                prev = now
        except MemoryOverflow:
            pool.shutdown()
            return TransferStats(float("inf"), n, total_bytes,
                                 overflowed=True,
                                 peak_loader_bytes=monitor.peak)
        elapsed = time.perf_counter() - start
        stats = TransferStats(elapsed, n, total_bytes,
                              peak_loader_bytes=monitor.peak,
                              batch_seconds=deltas)
        io_after = storage_io_counters(self.dataset.storage)
        if io_before is not None and io_after is not None:
            req = int(io_after["coalesced_requests"]
                      - io_before["coalesced_requests"])
            misses = ((io_after["reads"] - io_after["cache_hits"])
                      - (io_before["reads"] - io_before["cache_hits"]))
            stats.coalesced_requests = req
            stats.coalesced_run_len = misses / req if req else 0.0
            stats.cache_hits = int(io_after["cache_hits"]
                                   - io_before["cache_hits"])
            stats.cache_misses = int(io_after.get("cache_misses", 0)
                                     - io_before.get("cache_misses", 0))
        if trial_tier is not None:
            # tier hits never reach the storage counters; add them on top.
            # Tier MISSES do (they forward to the inner storage), so only
            # count them here when the storage kept no counters itself.
            stats.cache_hits += trial_tier.hits - tier_before[0]
            if io_before is None or io_after is None:
                stats.cache_misses += trial_tier.misses - tier_before[1]
        if prefetcher is not None:
            stats.staging_hit_rate = prefetcher.staging_hit_rate
        if self.cost_tracker.records:
            stats.sample_cost_mean_s = self.cost_tracker.mean()
            stats.sample_cost_p99_s = self.cost_tracker.p99()
            stats.slow_batches = self.cost_tracker.slow_batches - slow_before
        fault_after = self.fault_stats.snapshot()
        stats.read_retries = int(fault_after["read_retries"]
                                 - fault_before["read_retries"])
        stats.read_faults = int(fault_after["read_faults"]
                                - fault_before["read_faults"])
        stats.resubmits = int(fault_after["resubmits"]
                              - fault_before["resubmits"])
        stats.quarantined = len(self.quarantine) - q_before
        stats.degraded = self.fault_stats.degraded
        return stats


def _take(it, n):
    for i, x in enumerate(it):
        if i >= n:
            return
        yield x
