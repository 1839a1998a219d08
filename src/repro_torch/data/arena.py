"""Slab arena: the recycled batch buffers behind the zero-copy fast path.

A ``SlabArena`` owns a small ring of *slots*.  Each slot is a dict of
per-field numpy slabs preallocated with the batch shapes/dtypes of the
pipeline's steady state, plus the slot's total ``nbytes`` computed exactly
once when the field spec is established.  Workers collate directly into a
slot (``Dataset.get_batch(..., out=slot.arrays)``), pass the slot token
through the queue, and the consumer's advance recycles it — so steady-state
delivery allocates no new per-field batch arrays at all.

Lifetime contract (see DESIGN.md §3): a zero-copy batch is valid until the
consumer requests the *next* batch.  A downstream stage that needs to hold
the buffers across that boundary (e.g. an async device transfer) calls
``ArenaBatch.detach()`` and later ``ArenaBatch.release()`` itself; the
producing pool then skips its automatic release.  Hot-swap drains deliver
every in-flight slot to the consumer, whose releases return them to the
(persistent, loader-owned) arena — nothing is leaked and nothing is lost.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np


class SlabSlot:
    """One preallocated batch buffer: field name -> numpy slab."""

    __slots__ = ("arena", "arrays", "nbytes", "epoch")

    def __init__(self, arena: "SlabArena", arrays: Dict[str, np.ndarray]):
        self.arena = arena
        self.arrays = arrays
        self.nbytes = int(sum(np.asarray(v).nbytes for v in arrays.values()))
        self.epoch = arena._epoch     # spec generation this slot was cut for

    def release(self) -> None:
        self.arena._release(self)


class ArenaBatch(dict):
    """A batch whose field arrays are views of an arena slot.

    Behaves as a plain ``{field: ndarray}`` dict for every consumer.  The
    producing worker pool auto-releases the slot when the consumer advances,
    unless ``detach()`` transferred release responsibility downstream.
    """

    def __init__(self, slot: SlabSlot):
        super().__init__(slot.arrays)
        self.slot = slot
        self.nbytes = slot.nbytes
        self._detached = False
        self._released = False
        self._lock = threading.Lock()

    def detach(self) -> "ArenaBatch":
        """Take over release responsibility from the producing pool."""
        self._detached = True
        return self

    def copy_into(self, out: Dict[str, np.ndarray]) -> None:
        """Copy every field into matching preallocated buffers (the device
        edge's staging pool): after this returns, nothing downstream holds a
        view of the slot and the caller may ``release()`` immediately —
        decoupling the arena's lifetime from the device transfer."""
        for k, v in self.items():
            np.copyto(out[k], v)

    def release(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
        self.slot.release()

    def release_if_owned(self) -> None:
        """Called by the producing pool when the consumer advances."""
        if not self._detached:
            self.release()


def maybe_release(batch, *, owned_only: bool = True) -> None:
    """Recycle ``batch``'s slot if it is arena-backed (no-op otherwise)."""
    if isinstance(batch, ArenaBatch):
        if owned_only:
            batch.release_if_owned()
        else:
            batch.release()


class SlabArena:
    """Bounded pool of recycled batch slots.

    The field spec (shapes/dtypes) is discovered from the first batch the
    pipeline produces: that batch's freshly-allocated arrays are *adopted*
    as slot zero, and every further slot is cut to the same spec.  A
    mismatched batch (e.g. a ragged tail when ``drop_last=False``) simply
    bypasses the arena.

    ``capacity`` bounds live slots; ``acquire`` blocks (with a stop check,
    so draining workers never deadlock) until one is recycled.  ``resize``
    retargets capacity across a hot swap: surplus slots are dropped on
    release, missing ones are allocated on demand (counted as misses).
    """

    def __init__(self, capacity: int):
        self.capacity = max(1, capacity)
        self._spec: Optional[Dict[str, tuple]] = None
        self._spec_nbytes = 0
        self._expected_leading: Optional[int] = None
        self._free: deque = deque()
        self._allocated = 0
        self._epoch = 0
        self._cond = threading.Condition()
        self.hits = 0
        self.misses = 0

    # ---- stats -------------------------------------------------------------
    @property
    def allocated(self) -> int:
        return self._allocated

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self._allocated - len(self._free)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def nbytes_in_use(self) -> int:
        """Bytes currently pinned by allocated slots.

        This is the number the cache tier deducts from its own budget so
        arena + cache share one memory budget without double-counting
        (DESIGN.md §7).  Asserts the arena itself never exceeds its
        capacity-implied byte budget — ``resize`` shrinks lazily, so a
        transient over-allocation is legal only while every surplus slot is
        in use (frees drain immediately, on resize and on release)."""
        with self._cond:
            assert (self._allocated <= self.capacity
                    or not self._free), \
                (self._allocated, self.capacity, len(self._free))
            return self._allocated * self._spec_nbytes

    # ---- spec --------------------------------------------------------------
    def matches(self, batch: Dict[str, np.ndarray]) -> bool:
        spec = {k: (np.asarray(v).shape, np.asarray(v).dtype)
                for k, v in batch.items()}
        return self._spec is None or spec == self._spec

    def adopt(self, batch: Dict[str, np.ndarray]) -> Optional[SlabSlot]:
        """Turn a freshly-allocated batch into a slot (establishes the spec
        on first use).  Returns None if the batch doesn't fit the spec —
        or, while the spec is unset, if its leading dim differs from the
        expected local batch (a ragged makeup chunk delivered right after
        a reshard must not pin the arena to the wrong shape)."""
        arrays = {k: np.asarray(v) for k, v in batch.items()}
        spec = {k: (v.shape, v.dtype) for k, v in arrays.items()}
        with self._cond:
            if self._spec is None:
                if self._expected_leading is not None and any(
                        v.ndim == 0 or v.shape[0] != self._expected_leading
                        for v in arrays.values()):
                    return None
                self._spec = spec
                self._spec_nbytes = int(
                    sum(v.nbytes for v in arrays.values()))
            elif spec != self._spec:
                return None
            self._allocated += 1
            self.misses += 1
        return SlabSlot(self, arrays)

    # ---- acquire / release -------------------------------------------------
    def acquire(self, stop: Optional[threading.Event] = None,
                poll_s: float = 0.5) -> Optional[SlabSlot]:
        """Pop a free slot, or allocate one while under capacity.

        Returns None when the spec is still unknown (caller produces a fresh
        batch and ``adopt``s it) or when ``stop`` was set while waiting.
        Waiters are woken by every release and by ``wake()`` (which pools
        call when setting their stop flag), so ``poll_s`` is only a backstop
        against a missed transition, not the reaction latency.
        """
        while True:
            with self._cond:
                if self._free:
                    self.hits += 1
                    return self._free.popleft()
                if self._spec is None:
                    return None
                if self._allocated < self.capacity:
                    self._allocated += 1
                    self.misses += 1
                    arrays = {k: np.empty(shape, dtype)
                              for k, (shape, dtype) in self._spec.items()}
                    return SlabSlot(self, arrays)
                self._cond.wait(poll_s)
            if stop is not None and stop.is_set():
                return None

    def wake(self) -> None:
        """Wake every blocked ``acquire`` so it re-checks its stop event —
        called by pools on stop/drain/error transitions."""
        with self._cond:
            self._cond.notify_all()

    def _release(self, slot: SlabSlot) -> None:
        with self._cond:
            if slot.epoch != self._epoch:
                self._allocated -= 1      # stale spec (respec): drop it
                return
            if self._allocated > self.capacity:
                self._allocated -= 1      # shrink toward the new capacity
                return
            self._free.append(slot)
            self._cond.notify()

    def resize(self, capacity: int) -> None:
        with self._cond:
            self.capacity = max(1, capacity)
            while self._allocated > self.capacity and self._free:
                self._free.pop()
                self._allocated -= 1

    def respec(self, *, expected_leading: Optional[int] = None) -> None:
        """Forget the slab spec — the batch shape is about to change (an
        elastic reshard resizes the local batch).  Free slots are dropped
        now; in-use slots are dropped when their holder releases them (the
        spec generation stamped on each slot tells stale from current), and
        the next batch produced re-establishes the spec at the new shape.
        ``expected_leading`` restricts which batch may do so (the new local
        batch size) — odd-shaped makeup chunks bypass the arena instead.
        """
        with self._cond:
            self._epoch += 1
            self._allocated -= len(self._free)
            self._free.clear()
            self._spec = None
            self._spec_nbytes = 0
            self._expected_leading = expected_leading
            self._cond.notify_all()
