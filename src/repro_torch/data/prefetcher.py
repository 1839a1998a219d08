"""Device prefetcher: overlaps host->device transfer with consumption.

The paper's pinned-memory + ``.cuda()`` copy.  Batches are copied onto the
card ``depth`` steps ahead of the training loop, from a transfer lane that
owns a CUDA stream of its own, so the copies run concurrently with the
previous step's compute.  The structure, names and knobs are those of
``repro``'s prefetcher (``jax.device_put`` onto a sharding there):

* every put is ``non_blocking`` on the lane's stream, followed by an event
  recorded on that stream.  The lane waits for the event before it lets
  go of the source (an arena slab or a staging buffer) and before it
  queues the batch: a host buffer read by an unfinished copy is never
  reused, and a batch that reaches the consumer has landed, so a timed
  window that ends at the last delivered batch contains its copies;
* ``transfer_threads=2`` overlaps two copies: a submitter thread feeds a
  small executor in batch order and queues the futures, so delivery order
  is kept.  Each executor thread has its own stream (two threads on one
  stream would serialise);
* arena-backed batches (``ArenaBatch``) are ``detach``ed before the copy
  and released the moment it lands, returning the slab to the ring as
  early as possible;
* a ``StagingPool`` (``staging_buffers > 0``, the default) interposes a
  small ring of page-locked staging buffers: the slab is copied into a
  pooled buffer once and released at once, and the device copy runs from
  the pinned buffer, which the card reads by DMA while the host goes on;
* before a batch is yielded, the consumer's stream waits on its event, and
  each tensor is marked as used by that stream (``record_stream``): the
  tensors were allocated on the copy stream, and the caching allocator
  must not hand their memory back to it while the consumer still reads.

On the CPU device every put is a real copy (``torch.tensor``), never a
view of the host array, so a recycled slab can never show through.  A
device tensor never aliases host memory either, so ``StagingPool.retire``
is never called here; it is kept, with its counter, so the pool's
interface matches ``repro``'s.  ``donate`` is accepted and has no effect:
the inputs are host arrays, which are copied regardless (``repro`` says
the same of numpy inputs).
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.data.arena import ArenaBatch
from repro_torch.utils.device import resolve_device

_SENTINEL = object()


def put_global_batch(batch, device, *, donate: bool = False,
                     stream=None) -> Dict[str, torch.Tensor]:
    """Host batch (numpy dict) -> dict of tensors on ``device``.

    Under a process group of more than one rank, ``batch`` is this rank's
    rows (the loader's ``host_index`` / ``host_count`` slice) and each rank
    copies them to its own device: the counterpart of ``repro``'s
    ``make_array_from_process_local_data``, with the ranks' rows together
    making the global batch.

    On a CUDA device each field is copied with ``non_blocking=True`` on
    ``stream`` (the current stream when None): the copy may still be
    reading the host array when this returns, so the caller records an
    event after it and waits for that before reusing the source.  On the
    CPU each field is copied at once.  ``donate`` has no effect on host
    inputs.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.tensor(np.asarray(v), device=device)
                for k, v in batch.items()}
    with torch.cuda.stream(stream):
        return {k: torch.from_numpy(np.asarray(v)).to(device,
                                                      non_blocking=True)
                for k, v in batch.items()}


class StagingPool:
    """Pinned staging-buffer ring for the device edge (DESIGN.md §5).

    The zero-copy pipeline's last host hop: an arena slab must not be
    recycled while a device copy might still read it.  The slab is copied
    ONCE into a pooled buffer shaped like the device batch and released on
    the spot, and the device copy runs from the pooled buffer.  With
    ``pin_memory=True`` (a CUDA device) the buffers are page-locked, so
    the copy is a true asynchronous DMA; the pool hands out their numpy
    views, so ``ArenaBatch.copy_into`` fills them as it fills any array.
    A buffer returns to the ring once its copy has landed.

    The spec (field shapes/dtypes) latches from the first batch; a batch
    of a different shape (reshard, ragged makeup chunk) drops the stale
    ring and re-establishes it.  ``hit_rate``/``retired`` feed
    ``TransferStats.staging_hit_rate`` and the monitor report.
    """

    def __init__(self, capacity: int, *, pin_memory: bool = False):
        self.capacity = max(1, capacity)
        self.pin_memory = pin_memory
        self._spec: Optional[Dict[str, tuple]] = None
        self._free: deque = deque()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.retired = 0

    def _alloc(self, spec) -> Dict[str, np.ndarray]:
        if not self.pin_memory:
            return {k: np.empty(shape, dtype)
                    for k, (shape, dtype) in spec.items()}
        # the numpy view keeps its page-locked tensor alive
        return {k: torch.empty(shape, pin_memory=True,
                               dtype=torch.from_numpy(
                                   np.empty(0, dtype)).dtype).numpy()
                for k, (shape, dtype) in spec.items()}

    def acquire(self, batch: Dict) -> Dict[str, np.ndarray]:
        """A staging dict matching ``batch``'s field spec.  Never blocks
        and never fails: a miss allocates (transfers already in flight
        bound how many buffers can be out; ``release`` drops surplus)."""
        spec = {k: (np.asarray(v).shape, np.asarray(v).dtype)
                for k, v in batch.items()}
        with self._lock:
            if self._spec != spec:
                if self._ragged_of(spec, self._spec):
                    # a short batch (skip-mode quarantine, makeup tail):
                    # transient — allocate pageable memory (page-locking
                    # is slow) without thrashing the ring the full-size
                    # batches still need
                    self.misses += 1
                    return {k: np.empty(shape, dtype)
                            for k, (shape, dtype) in spec.items()}
                # first batch, or the batch shape changed (reshard):
                # pooled buffers of the old shape are useless — drop them
                self._free.clear()
                self._spec = spec
            if self._free:
                self.hits += 1
                return self._free.popleft()
            self.misses += 1
        return self._alloc(spec)

    @staticmethod
    def _ragged_of(spec, latched) -> bool:
        """Is ``spec`` the latched spec with a smaller leading dim (same
        fields, dtypes, trailing dims)?"""
        if latched is None or set(spec) != set(latched):
            return False
        for k, (shape, dtype) in spec.items():
            lshape, ldtype = latched[k]
            if (dtype != ldtype or len(shape) != len(lshape)
                    or not shape or shape[0] >= lshape[0]
                    or shape[1:] != lshape[1:]):
                return False
        return True

    def release(self, buf: Dict[str, np.ndarray]) -> None:
        """The device copy landed: back to the ring (dropped if the spec
        moved on or the ring is full)."""
        with self._lock:
            spec = {k: (v.shape, v.dtype) for k, v in buf.items()}
            if spec == self._spec and len(self._free) < self.capacity:
                self._free.append(buf)

    def retire(self, buf: Dict[str, np.ndarray]) -> None:
        """A device array that aliases this buffer owns it: never reuse.
        A torch device put always copies, so the port never calls this."""
        with self._lock:
            self.retired += 1

    def resize(self, capacity: int) -> None:
        with self._lock:
            self.capacity = max(1, capacity)
            while len(self._free) > self.capacity:
                self._free.pop()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class _DepthGate:
    """Resizable in-flight bound (the hot-swappable ``device_prefetch``).

    A plain ``queue.Queue(maxsize=depth)`` fixes the depth at construction;
    this gate moves the bound into a permit counter so ``set_depth`` can
    grow it (release extra permits) or shrink it (absorb permits as the
    consumer returns them) on a LIVE prefetcher without blocking either
    side — which is what lets ``apply_params`` retune the device buffer
    depth mid-stream instead of only at stream creation.
    """

    def __init__(self, depth: int):
        self.depth = max(1, depth)
        self._sem = threading.Semaphore(self.depth)
        self._lock = threading.Lock()
        self._deficit = 0            # permits to absorb after a shrink

    def acquire(self, stop: threading.Event) -> bool:
        """Producer side: take a permit (False when stopped while waiting)."""
        while not stop.is_set():
            if self._sem.acquire(timeout=0.05):
                return True
        return False

    def release(self) -> None:
        """Consumer side: return a permit (absorbed if the depth shrank)."""
        with self._lock:
            if self._deficit > 0:
                self._deficit -= 1
                return
        self._sem.release()

    def set_depth(self, depth: int) -> None:
        depth = max(1, depth)
        with self._lock:
            delta = depth - self.depth
            self.depth = depth
            if delta > 0:
                absorb = min(self._deficit, delta)
                self._deficit -= absorb
                for _ in range(delta - absorb):
                    self._sem.release()
            elif delta < 0:
                self._deficit += -delta


class DevicePrefetcher:
    def __init__(self, host_iter: Iterator, *, depth: int = 2,
                 device="cuda", transfer_threads: int = 1,
                 donate: bool = False, staging_buffers: int = 2):
        self.device = resolve_device(device)
        self.donate = donate
        self.transfer_threads = max(1, transfer_threads)
        self._pin = self.device.type == "cuda"
        self._staging = (StagingPool(staging_buffers, pin_memory=self._pin)
                         if staging_buffers > 0 else None)
        # one copy stream per transfer thread, made by the thread itself
        self._lane = threading.local()
        self._gate = _DepthGate(depth)
        self._queue: queue.Queue = queue.Queue()   # bounded by the gate
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._executor = (ThreadPoolExecutor(
            max_workers=self.transfer_threads,
            thread_name_prefix="device-transfer")
            if self.transfer_threads > 1 else None)
        self._thread = threading.Thread(target=self._run, args=(host_iter,),
                                        daemon=True)
        self._thread.start()

    @property
    def depth(self) -> int:
        return self._gate.depth

    def set_depth(self, depth: int) -> None:
        """Retune the prefetch depth on the live stream (hot swap)."""
        self._gate.set_depth(depth)

    def set_staging(self, staging_buffers: int) -> None:
        """Retune (or disable) the staging ring on the live stream.  Runs
        at the same params boundary as ``set_depth``; in-flight transfers
        finish against the pool they started with."""
        if staging_buffers <= 0:
            self._staging = None
        elif self._staging is None:
            self._staging = StagingPool(staging_buffers, pin_memory=self._pin)
        else:
            self._staging.resize(staging_buffers)

    @property
    def staging_hit_rate(self) -> Optional[float]:
        """Staging-pool hit rate (None when the pool is disabled)."""
        return self._staging.hit_rate if self._staging is not None else None

    def close(self) -> None:
        """Stop prefetching and unblock the producer thread (which may be
        parked on the depth gate).  Safe to call more than once."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)

    def _put(self, payload):
        """Copy ``payload`` onto the device and wait until it has landed.
        Returns (tensors, the event recorded after the copy, or None on
        the CPU)."""
        if self.device.type != "cuda":
            return put_global_batch(payload, self.device,
                                    donate=self.donate), None
        stream = getattr(self._lane, "stream", None)
        if stream is None:
            stream = self._lane.stream = torch.cuda.Stream(self.device)
        dev = put_global_batch(payload, self.device, donate=self.donate,
                               stream=stream)
        event = torch.cuda.Event()
        event.record(stream)
        # the copy may still be reading the host buffer: the source is
        # reused, and the batch delivered, only once it has landed
        event.synchronize()
        return dev, event

    def _transfer(self, batch):
        arena_backed = isinstance(batch, ArenaBatch)
        payload = dict(batch) if arena_backed else batch
        # snapshot the pool: set_staging(0) may null self._staging while a
        # transfer is in flight — it must finish against the pool it
        # started with
        staging = self._staging
        if arena_backed and staging is not None:
            try:
                staged = staging.acquire(payload)
            except BaseException:
                batch.release()    # allocation failed: never strand a slot
                raise
            return self._transfer_staged(batch, staged, staging)
        try:
            return self._put(payload)
        finally:
            if arena_backed:
                batch.release()    # even on a failed transfer: never leak

    def _transfer_staged(self, batch: ArenaBatch, staged, pool: StagingPool):
        """Staging fast path: one host memcpy frees the slab immediately;
        the device copy runs from the pooled (pinned) buffer, which goes
        back to the ring once the copy has landed."""
        try:
            batch.copy_into(staged)
        finally:
            batch.release()        # slab is free the moment the copy ends
        try:
            return self._put(staged)
        finally:
            pool.release(staged)   # landed, or unused after a failed put

    def _run(self, host_iter):
        try:
            for batch in host_iter:
                if self._stop.is_set():
                    break
                # take ownership *before* advancing host_iter (the pool
                # would otherwise recycle the slab under an in-flight copy)
                if isinstance(batch, ArenaBatch):
                    batch.detach()
                if not self._gate.acquire(self._stop):
                    # closed while waiting for a free depth slot: the batch
                    # never transfers — recycle it rather than leak
                    if isinstance(batch, ArenaBatch):
                        batch.release()
                    break
                if self._executor is None:
                    # synchronous put: the slab is free once _transfer
                    # returns, before the pool's auto-release even runs
                    self._queue.put(self._transfer(batch))
                else:
                    self._queue.put(self._executor.submit(
                        self._transfer, batch))
        except BaseException as e:  # noqa: BLE001
            self._error = e
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
            self._queue.put(_SENTINEL)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            self._gate.release()
            if isinstance(item, Future):
                item = item.result()
            dev, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in dev.values():
                    t.record_stream(consumer)
            yield dev
