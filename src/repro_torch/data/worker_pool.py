"""Worker pools: the parallel fetch+transform lanes that DPT's nWorker tunes.

``ThreadWorkerPool`` is the default (DESIGN.md: numpy/IO transforms release
the GIL, so threads overlap reads and transforms in one process).
``ProcessWorkerPool`` is the fallback for GIL-heavy transforms.

``ProcessWorkerPool`` forks (``mp.get_context("fork")``).  On the card the
parent holds a CUDA context by then, which a forked child inherits in a
state it cannot use: a child must never touch ``torch.cuda``, and should
run no ``torch`` op at all (torch's intra-op thread pool does not survive
a fork).  The children read and transform with numpy only; the parent's
device prefetcher makes every tensor.

Backpressure implements PyTorch ``prefetch_factor`` semantics: at most
``num_workers * prefetch_factor`` finished batches may be queued; workers
block (stop consuming memory) when the consumer lags.  ``ProcessWorkerPool``
bounds its in-flight task window to the same depth (its consumer-driven
pump submits at most that many sequences ahead), so process mode has real
backpressure too.

Fault tolerance (DESIGN.md §10): with a ``fault_policy`` the task bodies
run reads through retry/quarantine/batch-repair machinery (data/faults.py)
so transient storage faults never escape a worker; a policy-skipped batch
consumes its sequence slot (``on_skip`` tells the stream) instead of
killing the pool, and a SIGKILL'd process-pool child costs one resubmit
instead of the stream.  Without a policy, any worker exception remains
pool-fatal exactly as before.

Delivery is **order-preserving** by default (``ordered=True``): every
index-batch gets a sequence number when it is pulled from the sampler, and
a small reordering buffer on the consumer side yields batches in exactly
sampler order at any worker count — what lets hot-swap accounting assert
exact batch sequences.  ``ordered=False`` restores completion-order
delivery (slightly lower head-of-line latency); it is thread-pool only —
``ProcessWorkerPool`` rejects it (its delivery is inherently ordered).

Dual-lane slow-sample isolation (DESIGN.md §9): ordered delivery has a
straggler pathology — the sequence window parks every fast batch behind
one slow decode.  With ``slow_lane_workers > 0`` and a ``cost_tracker``
(data/costs.py), index-batches are *classified at pull time*: predicted-
slow batches go to a dedicated slow lane whose sequence window runs
``slow_lane_lookahead`` batches AHEAD of the fast lane's, so stragglers
start early and finish by the time the consumer's cursor reaches them.
Lanes share the sequence space and merge at the existing reorder buffer,
so delivered order and the byte-identical multiset guarantee are
unchanged; the lanes differ only in *when* work starts.  Dispatch is
work-conserving: an idle lane steals the other lane's head rather than
sleeping next to pending work.

Zero-copy fast path (DESIGN.md §3): given a ``SlabArena``, workers acquire
a recycled slot, collate straight into its slabs, and pass the *slot token*
through the queue — ``nbytes`` comes from the slot (computed once at spec
time), and the consumer's advance recycles the slot.  Hot-swap drain
delivers every in-flight slot before the pool retires, so nothing leaks.

Both pools support ``request_drain()``: stop pulling new index-batches but
deliver everything already pulled, then end the consumer's iteration.
Because indices are only pulled under a lock and every pulled index-batch
is eventually enqueued (parked lane entries are pulled: they drain too),
a drain loses nothing and duplicates nothing — this is what lets a live
DataLoader hot-swap (nWorker, nPrefetch) at a batch boundary (see
data/loader.py LoaderStream).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.monitor import MemoryMonitor, MemoryOverflow
from repro_torch.data.arena import ArenaBatch, SlabArena, maybe_release

_SENTINEL = object()
_SKIPPED = object()      # a fault policy dropped the whole batch: the
#                          sequence slot is consumed but nothing is yielded
_POOL_STOPPED = object()


def _mp_get_batch(dataset, fast, idx):
    """Module-level task fn so the fork pool pickles only (dataset, fast)."""
    return dataset.get_batch(idx, fast=fast)


def _mp_get_batch_timed(dataset, fast, idx):
    """Timed variant: ships (batch, wall seconds) back so the parent can
    feed its cost tracker — children stay stateless across tasks."""
    t0 = time.perf_counter()
    batch = dataset.get_batch(idx, fast=fast)
    return batch, time.perf_counter() - t0


def _mp_resilient_batch(dataset, fast, policy, idx):
    """Fault-tolerant task body (DESIGN.md §10): the child runs the read
    through a pickled ``FaultPolicy`` snapshot and ships back (batch or
    None, wall seconds, tally) — the parent merges quarantined ids and
    fault counts into its live log/stats."""
    report: dict = {}
    t0 = time.perf_counter()
    batch = policy.get_batch(dataset, idx, fast=fast, report=report)
    return batch, time.perf_counter() - t0, report


def _record_cost(cost_tracker, fault_policy, idx, dt) -> None:
    """Fold a batch's wall time into the cost tracker, excluding ids the
    policy just quarantined — their forgotten EWMA slots must not be
    repopulated by the very batch that withdrew them."""
    if fault_policy is not None and len(fault_policy.quarantine):
        idx = np.asarray(idx).reshape(-1)
        idx = idx[~np.isin(idx, fault_policy.quarantine.ids())]
        if idx.size == 0:
            return
    cost_tracker.record(idx, dt)


def batch_nbytes(batch) -> int:
    if isinstance(batch, ArenaBatch):
        return batch.nbytes          # computed once at slot reservation
    if isinstance(batch, dict):
        return int(sum(np.asarray(v).nbytes for v in batch.values()))
    return int(np.asarray(batch).nbytes)


class _DrainableIter:
    """Iterator wrapper that can be told to stop yielding at a boundary.

    ``drain()`` makes the next ``__next__`` raise StopIteration; items
    already handed out are unaffected.  Thread-safe by virtue of callers
    serializing ``__next__`` (the pools pull under a lock / from a single
    thread) and ``drain`` being a single Event set.
    """

    def __init__(self, it: Iterator):
        self._it = iter(it)
        self._stop = threading.Event()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        return next(self._it)

    def drain(self) -> None:
        self._stop.set()

    @property
    def drained(self) -> bool:
        return self._stop.is_set()


class ThreadWorkerPool:
    """Pulls index-batches from ``index_iter``, emits collated batches."""

    def __init__(self, dataset, index_iter: Iterator[np.ndarray], *,
                 num_workers: int, prefetch_factor: int = 2,
                 monitor: Optional[MemoryMonitor] = None,
                 ordered: bool = True, fast: bool = True,
                 arena: Optional[SlabArena] = None,
                 cost_tracker=None, slow_lane_workers: int = 0,
                 slow_lane_lookahead: int = 8,
                 fault_policy=None, on_skip=None):
        self.dataset = dataset
        self.num_workers = max(0, num_workers)
        self.prefetch_factor = max(1, prefetch_factor)
        self.monitor = monitor or MemoryMonitor()
        self.ordered = ordered
        self.fast = fast
        # data/faults.py FaultPolicy: retries + quarantine + batch repair
        # inside the task body, so transient faults never kill the pool.
        # ``on_skip`` fires (on the consumer thread) for each sequence
        # slot the policy dropped entirely — streams keep their position
        # accounting exact.
        self.fault_policy = fault_policy
        self.on_skip = on_skip
        self.arena = arena if (fast and getattr(
            dataset, "supports_fast_path", False)) else None
        self.cost_tracker = cost_tracker
        # The slow lane only makes sense where the straggler pathology
        # exists (ordered + threaded) and a predictor is available.
        self.slow_lane_workers = max(0, slow_lane_workers) if (
            ordered and cost_tracker is not None
            and self.num_workers > 0) else 0
        self.slow_lane_lookahead = max(0, slow_lane_lookahead)
        self._index_iter = _DrainableIter(index_iter)
        # One condition guards all dispatch state (_seq/_delivered/_ready/
        # _exhausted) and is notified on EVERY transition — delivery, lane
        # hand-off, drain, stop, exhaustion — so waits are event-driven;
        # the wait timeout below is a backstop, not the reaction latency.
        self._cond = threading.Condition()
        self._seq = 0
        self._delivered = 0
        self._ready = {False: deque(), True: deque()}   # lane -> (seq, idx)
        self._exhausted = False
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

        if self.num_workers == 0:
            self._queue = None
            self._threads = []
            return
        depth = self.num_workers * self.prefetch_factor
        # Ordered mode: the consumer parks out-of-order arrivals in a
        # reordering buffer, which frees queue slots — without a cap on the
        # *sequence window*, workers behind one straggler could pull and
        # collate the whole epoch (unbounded memory).  A worker may not pull
        # sequence S until S - delivered < window.  The slow lane's window
        # is `slow_lane_lookahead` wider: that headroom is the early start.
        total_workers = self.num_workers + self.slow_lane_workers
        self._window = depth + total_workers
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._live = total_workers
        self._live_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._work, args=(False,),
                             name=f"loader-worker-{i}", daemon=True)
            for i in range(self.num_workers)]
        self._threads += [
            threading.Thread(target=self._work, args=(True,),
                             name=f"loader-slow-{i}", daemon=True)
            for i in range(self.slow_lane_workers)]
        for t in self._threads:
            t.start()

    # ---- batch production --------------------------------------------------
    def _mark_delivered(self):
        with self._cond:
            self._delivered += 1
            self._cond.notify_all()

    def _lane_limit(self, lane_slow: bool) -> float:
        """Sequence-window bound for this lane.  A drain lifts the bound:
        the consumer may have stopped advancing, and everything already
        pulled must still deliver."""
        if not self.ordered or self._index_iter.drained:
            return float("inf")
        return self._window + (self.slow_lane_lookahead if lane_slow else 0)

    def _classify(self, idx) -> bool:
        """Route one pulled index-batch: True = slow lane."""
        if self.slow_lane_workers == 0:
            return False
        if not self.cost_tracker.is_slow(idx):
            return False
        self.cost_tracker.note_slow_batch()
        return True

    def _next_indices(self, lane_slow: bool = False):
        """One (seq, idx) for this lane, honoring the lane's window.

        Under the single condition: serve the lane's own parked queue
        first (lowest seq — parked entries arrive in pull order), else
        pull+classify from the shared stream (handing off batches
        classified for the other lane), else steal the other lane's head
        (work conservation: never sleep next to admissible work).  Raises
        StopIteration when the stream is exhausted/drained and every
        parked entry has been taken.
        """
        with self._cond:
            while True:
                if self._stop.is_set():
                    raise StopIteration
                limit = self._lane_limit(lane_slow)
                own = self._ready[lane_slow]
                if own and own[0][0] - self._delivered < limit:
                    return own.popleft()
                if not self._exhausted \
                        and self._seq - self._delivered < limit:
                    try:
                        idx = next(self._index_iter)
                    except StopIteration:
                        self._exhausted = True
                        self._cond.notify_all()
                        continue
                    seq = self._seq
                    self._seq += 1
                    if self._classify(idx) == lane_slow:
                        return seq, idx
                    self._ready[not lane_slow].append((seq, idx))
                    self._cond.notify_all()
                    continue
                other = self._ready[not lane_slow]
                if other and other[0][0] - self._delivered < limit:
                    return other.popleft()
                if (self._exhausted or self._index_iter.drained) \
                        and not own and not other:
                    raise StopIteration
                self._cond.wait(0.5)

    def _acquire_slot(self):
        """Reserve an arena slot (None: no arena / spec unknown / stopped).

        Workers call this BEFORE pulling a sequence number.  Ordering
        matters for liveness: the ordered consumer pins later-sequence
        batches in its reordering buffer until the head sequence arrives,
        so a worker that pulled a sequence and only then waited for a slot
        could starve behind its own successors.  Acquire-first guarantees
        every pulled-but-undelivered batch already owns its buffer and can
        always complete.  (With the slow lane on, ``LoaderParams.
        arena_capacity`` widens by the lookahead so early-started slow
        batches can't exhaust the slots the head still needs.)
        """
        if self.arena is None:
            return None
        return self.arena.acquire(stop=self._stop)

    def _get(self, idx, out=None):
        """The read, through the fault policy when one is armed (None =
        every index of the batch is quarantined: skip the slot)."""
        if self.fault_policy is not None:
            return self.fault_policy.get_batch(self.dataset, idx, out=out,
                                               fast=self.fast)
        return self.dataset.get_batch(idx, out=out, fast=self.fast)

    def _collate(self, idx, slot):
        """One collated batch (+ its nbytes), into ``slot`` if given.
        ``(None, 0)`` means the fault policy dropped the whole batch."""
        if slot is not None:
            batch = self._get(idx, out=slot.arrays)
            if batch is None:
                slot.release()
                return None, 0
            if batch is not slot.arrays:    # slab didn't fit (ragged tail)
                slot.release()
                return batch, batch_nbytes(batch)
            return ArenaBatch(slot), slot.nbytes
        batch = self._get(idx)
        if batch is None:
            return None, 0
        if self.arena is not None:
            adopted = self.arena.adopt(batch)   # establishes the spec
            if adopted is not None:
                return ArenaBatch(adopted), adopted.nbytes
        return batch, batch_nbytes(batch)

    # ---- worker body -------------------------------------------------------
    def _halt(self):
        """Stop flag + wake everything that might be parked on it."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self.arena is not None:
            self.arena.wake()

    def _work(self, lane_slow: bool = False):
        try:
            while not self._stop.is_set():
                slot = self._acquire_slot()
                if slot is None and self.arena is not None \
                        and self._stop.is_set():
                    break
                try:
                    seq, idx = self._next_indices(lane_slow)
                except StopIteration:
                    if slot is not None:
                        slot.release()
                    break
                try:
                    t0 = time.perf_counter()
                    batch, nbytes = self._collate(idx, slot)
                    dt = time.perf_counter() - t0
                except BaseException:
                    if slot is not None:    # not yet wrapped: recycle it
                        slot.release()
                    raise
                if batch is None:           # policy dropped the batch: the
                    #                         slot still consumes its seq
                    self._queue.put((seq, _SKIPPED, 0))
                    continue
                if self.cost_tracker is not None:
                    _record_cost(self.cost_tracker, self.fault_policy,
                                 idx, dt)
                try:
                    self.monitor.reserve(nbytes)
                    self._queue.put((seq, batch, nbytes))
                except BaseException:
                    maybe_release(batch, owned_only=False)
                    raise
        except BaseException as e:  # noqa: BLE001 - surfaced to consumer
            self._error = e
            # A died worker leaves a hole in the sequence: the ordered
            # consumer would park every later batch forever while healthy
            # workers keep producing.  An error is pool-fatal — stop the
            # siblings so the sentinel (and the raise) arrives promptly.
            self._halt()
        finally:
            with self._live_lock:
                self._live -= 1
                if self._live == 0:
                    self._queue.put(_SENTINEL)

    # ---- consumer side -----------------------------------------------------
    def request_drain(self) -> None:
        """Stop pulling new index-batches; already-pulled batches still
        deliver, then iteration ends (the hot-swap batch boundary)."""
        self._index_iter.drain()
        with self._cond:            # drain lifts windows: wake the waiters
            self._cond.notify_all()

    def _iter_inline(self):
        prev = None
        try:
            for idx in self._index_iter:   # _DrainableIter ends on drain
                slot = self._acquire_slot()
                if slot is None and self.arena is not None \
                        and self._stop.is_set():
                    return
                t0 = time.perf_counter()
                batch, _ = self._collate(idx, slot)
                if batch is None:
                    if self.on_skip is not None:
                        self.on_skip()
                    continue
                if self.cost_tracker is not None:
                    _record_cost(self.cost_tracker, self.fault_policy,
                                 idx, time.perf_counter() - t0)
                maybe_release(prev)        # consumer advanced past it
                prev = batch               # set BEFORE yield: teardown at
                yield batch                # the yield still recycles it
        finally:
            maybe_release(prev)

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._iter_inline()
            return
        reorder: dict = {}
        next_seq = 0
        prev = None
        try:
            while True:
                if self.ordered and next_seq in reorder:
                    batch, nbytes = reorder.pop(next_seq)
                else:
                    item = self._queue.get()
                    if item is _SENTINEL:
                        if self._error is not None:
                            raise self._error
                        # drain any stragglers the buffer still holds
                        for seq in sorted(reorder):
                            batch, nbytes = reorder.pop(seq)
                            self.monitor.release(nbytes)
                            if batch is _SKIPPED:
                                if self.on_skip is not None:
                                    self.on_skip()
                                continue
                            maybe_release(prev)
                            prev = batch
                            yield batch
                        return
                    seq, batch, nbytes = item
                    if self.ordered and seq != next_seq:
                        reorder[seq] = (batch, nbytes)
                        continue
                self.monitor.release(nbytes)
                next_seq += 1
                self._mark_delivered()
                if self._error is not None:
                    maybe_release(batch, owned_only=False)  # in hand, unyielded
                    self.shutdown()
                    raise self._error
                if batch is _SKIPPED:      # every id was quarantined: the
                    #                        slot advances, nothing arrives
                    if self.on_skip is not None:
                        self.on_skip()
                    continue
                maybe_release(prev)        # consumer advanced past it
                prev = batch               # set BEFORE yield: teardown at
                yield batch                # the yield still recycles it
        finally:
            maybe_release(prev)
            for batch, nbytes in reorder.values():   # abandoned mid-buffer
                self.monitor.release(nbytes)
                maybe_release(batch, owned_only=False)
            reorder.clear()

    def shutdown(self):
        """Stop workers and recycle everything in flight.

        Must leave NO arena slot behind: workers parked in ``queue.put``
        hold reserved batches, so the queue is drained repeatedly (each get
        admits a blocked put, whose worker then sees the stop flag and
        exits) until every worker thread is gone and the queue is empty.
        """
        self._index_iter.drain()
        self._halt()
        if self._queue is None:
            return
        while (any(t.is_alive() for t in self._threads)
               or not self._queue.empty()):
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is not _SENTINEL:
                self.monitor.release(item[2])
                maybe_release(item[1], owned_only=False)


def _pw_worker_main(conn, dataset, fast, timed):
    """Child loop: recv ``(seq, idx, policy)`` tasks on a private duplex
    pipe, ship ``(seq, err, payload)`` back.  ``None`` is the shutdown
    sentinel.  Exceptions are shipped, not raised — the parent re-raises
    them in sequence order."""
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        seq, idx, pol = msg
        try:
            if pol is not None:
                out = _mp_resilient_batch(dataset, fast, pol, idx)
            elif timed:
                out = _mp_get_batch_timed(dataset, fast, idx)
            else:
                out = _mp_get_batch(dataset, fast, idx)
            err = None
        except BaseException as e:  # noqa: BLE001 — shipped to the parent
            out, err = None, e
        try:
            conn.send((seq, err, out))
        except Exception:
            try:  # the error itself may not pickle; a repr always does
                conn.send((seq, RuntimeError(repr(err)), None))
            except Exception:
                break
    try:
        conn.close()
    except Exception:
        pass


class _PipeWorker:
    """One child process on a private duplex pipe.  No queue or lock is
    shared between workers, so a SIGKILL'd child poisons only its own
    channel — which the parent reads as EOF, not as a wedged lock."""

    __slots__ = ("proc", "conn", "pid", "inflight", "dead")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        self.pid = proc.pid
        self.inflight = {}      # seq -> idx array, sent but unanswered
        self.dead = False


class ProcessWorkerPool:
    """Process-based fallback (GIL-heavy transforms).  Heavier per-batch
    overhead than the thread pool, same interface.

    One consumer-driven pump serves every mode: tasks are submitted at
    most ``num_workers * prefetch_factor`` sequences ahead of the
    consumer (real ``prefetch_factor`` backpressure) and joined strictly
    in sequence, so delivery is ALWAYS ordered — ``ordered=False`` is
    rejected loudly; completion-order delivery needs the thread pool.
    Arena slabs cannot cross the process boundary; batches arrive as
    fresh (pickled) dicts, but workers still use the batched read +
    vectorized transform inside the child.

    Transport is per-worker ``Process`` + private duplex ``Pipe`` rather
    than ``multiprocessing.Pool`` — that choice IS the crash containment
    (DESIGN.md §10).  A shared-queue pool cannot survive SIGKILL: idle
    workers block in ``SimpleQueue.get`` *while holding* the queue's read
    lock, so killing one wedges every other worker (and the pool's own
    ``terminate``) on a lock no process will ever release.  With
    point-to-point pipes a corpse only breaks its own channel; the parent
    sees EOF, drains any results the worker managed to ship, respawns a
    replacement, and resubmits exactly the dead worker's in-flight
    sequences — up to ``resubmit_budget`` per task.  A SIGKILL mid-batch
    costs one resubmit, not the stream.

    Dual-lane variant (DESIGN.md §9): with ``slow_lane_workers > 0`` and a
    ``cost_tracker``, predicted-slow batches are submitted as soon as they
    enter the extended (``+ slow_lane_lookahead``) window, fast batches
    only inside the base window.  Same early-start effect as the thread
    pool's slow lane; the lane *width* is shared pool capacity here
    (processes are fungible), so the knob buys lookahead rather than
    dedicated children.

    With a ``fault_policy`` (data/faults.py) the task body runs reads
    through a pickled policy snapshot and ships its tally back; the parent
    merges quarantined ids and fault counts into the live log/stats, and
    ``on_skip`` fires for sequence slots the policy dropped entirely.
    """

    def __init__(self, dataset, index_iter, *, num_workers: int,
                 prefetch_factor: int = 2,
                 monitor: Optional[MemoryMonitor] = None,
                 ordered: bool = True, fast: bool = True,
                 arena: Optional[SlabArena] = None,
                 cost_tracker=None, slow_lane_workers: int = 0,
                 slow_lane_lookahead: int = 8,
                 fault_policy=None, on_skip=None,
                 resubmit_budget: int = 2):
        import multiprocessing as mp
        if not ordered:
            raise ValueError(
                "ProcessWorkerPool delivery is always ordered (strict "
                "in-sequence join); ordered=False is unsupported with "
                "use_processes=True — use the thread pool for "
                "completion-order delivery")
        self.dataset = dataset
        self.monitor = monitor or MemoryMonitor()
        self._indices = _DrainableIter(index_iter)
        self.num_workers = max(1, num_workers)
        self.prefetch_factor = max(1, prefetch_factor)
        self.fast = fast
        self.cost_tracker = cost_tracker
        self.slow_lane_workers = max(0, slow_lane_workers) \
            if cost_tracker is not None else 0
        self.slow_lane_lookahead = max(0, slow_lane_lookahead)
        self.fault_policy = fault_policy
        self.on_skip = on_skip
        self.resubmit_budget = max(0, resubmit_budget)
        self.resubmits = 0
        self._stopped = False
        self._ctx = mp.get_context("fork")
        self._pending: dict = {}    # seq -> [idx, resubmits]
        self._results: dict = {}    # seq -> (err, payload)
        self._workers = [self._spawn_worker()
                         for _ in range(self.num_workers)]
        self._worker_pids = {w.pid for w in self._workers}
        self._dead_pids: set = set()

    def request_drain(self) -> None:
        self._indices.drain()

    # ---- crash containment -------------------------------------------------
    def _spawn_worker(self) -> _PipeWorker:
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_pw_worker_main,
            args=(child, self.dataset, self.fast,
                  self.cost_tracker is not None),
            daemon=True)
        proc.start()
        child.close()   # the child's fork copy is the only live end now
        return _PipeWorker(proc, parent)

    def _send_task(self, seq: int, idx) -> None:
        """Assign to the least-loaded live worker.  A broken pipe at send
        time is a death like any other: contain it and retry on the
        replacement."""
        while True:
            w = min((w for w in self._workers if not w.dead),
                    key=lambda w: len(w.inflight))
            w.inflight[seq] = idx
            try:
                w.conn.send((seq, idx, self.fault_policy))
                return
            except (OSError, ValueError):
                del w.inflight[seq]     # never sent — not a resubmit
                self._on_death(w)

    def _on_msg(self, w: _PipeWorker, msg) -> None:
        seq, err, out = msg
        w.inflight.pop(seq, None)
        self._results[seq] = (err, out)

    def _on_death(self, w: _PipeWorker) -> None:
        """A worker died (pipe EOF / broken pipe).  Drain any results it
        shipped before dying, respawn a replacement, and resubmit exactly
        its lost in-flight sequences — each up to ``resubmit_budget``."""
        if w.dead:
            return
        w.dead = True
        self._dead_pids.add(w.pid)
        self._worker_pids.discard(w.pid)
        try:
            while w.conn.poll(0):
                self._on_msg(w, w.conn.recv())
        except (EOFError, OSError):
            pass
        try:
            w.conn.close()
        except Exception:
            pass
        w.proc.join(timeout=0.1)
        lost = dict(w.inflight)
        w.inflight.clear()
        if self._stopped:
            return
        replacement = self._spawn_worker()
        self._workers[self._workers.index(w)] = replacement
        self._worker_pids.add(replacement.pid)
        for seq, idx in sorted(lost.items()):
            entry = self._pending.get(seq)
            if entry is None:
                continue
            if entry[1] >= self.resubmit_budget:
                raise RuntimeError(
                    f"process-pool worker died (pid {w.pid}) and an "
                    f"in-flight batch exhausted its resubmit budget "
                    f"({self.resubmit_budget})")
            entry[1] += 1
            self.resubmits += 1
            if self.fault_policy is not None:
                self.fault_policy.stats.note_resubmit()
            self._send_task(seq, idx)

    def _poll(self, timeout: float) -> None:
        """One multiplexed wait over every live worker pipe; EOF on a
        pipe is a worker death handled inline."""
        from multiprocessing import connection as mpc
        live = {w.conn: w for w in self._workers if not w.dead}
        if not live:
            return
        for conn in mpc.wait(list(live), timeout):
            w = live[conn]
            try:
                self._on_msg(w, conn.recv())
            except (EOFError, OSError):
                self._on_death(w)

    def _merge_report(self, report) -> None:
        """Fold a child task's fault tally into the parent's live state."""
        pol = self.fault_policy
        if not report or pol is None:
            return
        newly = []
        for i, reason in report.get("quarantined", ()):
            if pol.quarantine.add(int(i), reason):
                newly.append(int(i))
        if newly and pol.on_quarantine is not None:
            pol.on_quarantine(newly)
        pol.stats.merge_report(report)

    def _join(self, seq: int):
        """Block until the head-of-sequence result arrives, polling the
        worker pipes — a pipe EOF mid-wait is a death and is contained
        inline (respawn + resubmit).  ``_POOL_STOPPED`` = shut down.
        Shipped exceptions re-raise here, in sequence order."""
        while True:
            if seq in self._results:
                err, out = self._results.pop(seq)
                if err is not None:
                    raise err
                return out
            if self._stopped:
                return _POOL_STOPPED
            self._poll(0.05)

    # ---- the pump ----------------------------------------------------------
    def _iter_pump(self):
        pol = self.fault_policy
        timed = self.cost_tracker is not None
        cap = self.num_workers * self.prefetch_factor
        lane = self.slow_lane_workers > 0
        look = cap + (self.slow_lane_lookahead if lane else 0)
        staged: deque = deque()   # (seq, idx) parked outside the base cap
        pending = self._pending   # seq -> [idx, resubmits]
        seq_in = 0
        next_out = 0
        exhausted = False
        it = iter(self._indices)
        while not self._stopped:
            # pull ahead through the window, launching predicted-slow
            # batches immediately (extended window) and parking fast ones
            while not exhausted and seq_in - next_out < look:
                try:
                    idx = next(it)
                except StopIteration:
                    exhausted = True
                    break
                s, seq_in = seq_in, seq_in + 1
                if lane and self.cost_tracker.is_slow(idx):
                    self.cost_tracker.note_slow_batch()
                    pending[s] = [idx, 0]
                    self._send_task(s, idx)
                else:
                    staged.append((s, idx))
            while staged and staged[0][0] - next_out < cap:
                s, idx = staged.popleft()
                pending[s] = [idx, 0]
                self._send_task(s, idx)
            if next_out not in pending:     # everything pulled is delivered
                return
            out = self._join(next_out)
            if out is _POOL_STOPPED:
                return
            idx_done = pending.pop(next_out)[0]
            next_out += 1
            if pol is not None:
                batch, dt, report = out
                self._merge_report(report)
            elif timed:
                batch, dt = out
            else:
                batch, dt = out, None
            if timed and batch is not None:
                _record_cost(self.cost_tracker, pol, idx_done, dt)
            if batch is None:               # policy dropped the batch
                if self.on_skip is not None:
                    self.on_skip()
                continue
            nbytes = batch_nbytes(batch)
            self.monitor.reserve(nbytes)
            self.monitor.release(nbytes)
            yield batch

    def __iter__(self):
        try:
            yield from self._iter_pump()
        finally:
            self.shutdown()

    def shutdown(self):
        # Point-to-point pipes mean no shared queue lock a corpse could
        # hold: send each live worker the sentinel, give the set a short
        # grace to finish the batch in hand, then kill stragglers.  This
        # never blocks on a dead worker (mp.Pool.terminate does — its
        # wind-down acquires the task queue's read lock, which a
        # SIGKILL'd idle worker takes to the grave).
        self._stopped = True
        for w in self._workers:
            if not w.dead:
                try:
                    w.conn.send(None)
                except Exception:
                    pass
        deadline = time.monotonic() + 1.0
        for w in self._workers:
            w.proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=1.0)
            try:
                w.conn.close()
            except Exception:
                pass
