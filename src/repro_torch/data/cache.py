"""Cross-epoch host-level cache tier (DESIGN.md §7).

``CacheTier`` retains raw storage items across epochs inside a hard byte
budget so epochs 2+ stream at memory speed instead of re-paying cold IO.
Admission is *deterministic*: the tier derives a hot set — the first
``hot_chunks`` locality chunks of the index space — purely from
``(budget_bytes, chunk, num_items, mean item bytes)``, so every host of a
fleet, a restored checkpoint, and a resharded stream all converge on the
same resident set without coordination.  That same ``hot_chunks`` count is
what ``ShardedSampler.set_cache_plan`` uses to interleave cached chunks
with cold ones in the epoch permutation, which is what lets the prefetcher
fill misses while hits are consumed.

``CachedStorage`` is the read-path adapter: a ``Storage``-shaped view over
an inner storage that serves hits from the tier and (optionally) admits
misses.  Trials use ``admit=False`` views (or throwaway tiers) so
measurement never pollutes the live cache.

Budget accounting: the tier can be handed an ``arena_bytes`` callable
(late-bound to the loader's persistent slab arena) whose current usage is
deducted from the effective budget, so arena + cache share one memory
budget without double-counting (see ``SlabArena.nbytes_in_use``).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.storage import Storage


def plan_hot_chunks(budget_bytes: int, chunk: int, num_items: int,
                    item_nbytes: float) -> int:
    """Number of leading index-space chunks that fit in ``budget_bytes``.

    Deterministic in its scalar inputs — every host computes the same plan
    from the same (budget, chunk, dataset) triple, no coordination needed.
    """
    if budget_bytes <= 0 or num_items <= 0 or item_nbytes <= 0:
        return 0
    chunk = max(1, int(chunk))
    n_chunks = -(-num_items // chunk)
    per_chunk = chunk * float(item_nbytes)
    return max(0, min(n_chunks, int(budget_bytes // per_chunk)))


class CacheTier:
    """Budget-bounded, index-keyed raw-item cache with a deterministic
    hot-set admission filter.

    Items are bucketed by locality chunk id (``index // chunk``); only
    indices inside the hot set (chunk ids ``< hot_chunks``) are admitted,
    and eviction (needed only after a ``resize``/``reconfigure`` shrink)
    drops the *highest* resident chunk id first — so after any one full
    epoch the resident set equals the hot set exactly, regardless of
    consumption order.
    """

    def __init__(self, budget_bytes: int, *, chunk: int = 1,
                 num_items: int = 0, item_nbytes: float = 0.0,
                 arena_bytes: Optional[Callable[[], int]] = None):
        self._lock = threading.Lock()
        self._arena_bytes = arena_bytes
        self._items: Dict[int, np.ndarray] = {}
        self._chunk_bytes: Dict[int, int] = {}
        self._nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # brownout degraded mode (DESIGN.md §10): when the loader's fault
        # rate crosses its threshold, the tier stops admitting new items —
        # serve-hits-first read-only mode — so a failing backend can't
        # churn the resident set it is about to depend on
        self.read_only = False
        self._configure(budget_bytes, chunk, num_items, item_nbytes)

    # -- configuration -----------------------------------------------------
    def _configure(self, budget_bytes, chunk, num_items, item_nbytes):
        self.budget_bytes = max(0, int(budget_bytes))
        self.chunk = max(1, int(chunk))
        self.num_items = int(num_items)
        self.item_nbytes = float(item_nbytes)
        self.hot_chunks = plan_hot_chunks(
            self.budget_bytes, self.chunk, self.num_items, self.item_nbytes)

    def reconfigure(self, *, budget_bytes: Optional[int] = None,
                    chunk: Optional[int] = None,
                    num_items: Optional[int] = None,
                    item_nbytes: Optional[float] = None) -> None:
        """Re-spec the tier in place (hot-swap / reshard path): recompute
        the hot set and evict whatever fell out of it.  Entries that stay
        hot are kept — a resize is a trim, never a flush."""
        with self._lock:
            self._configure(
                self.budget_bytes if budget_bytes is None else budget_bytes,
                self.chunk if chunk is None else chunk,
                self.num_items if num_items is None else num_items,
                self.item_nbytes if item_nbytes is None else item_nbytes)
            self._evict_over_budget()

    def resize(self, budget_bytes: int) -> None:
        self.reconfigure(budget_bytes=budget_bytes)

    # -- accounting --------------------------------------------------------
    def nbytes_in_use(self) -> int:
        with self._lock:
            return self._nbytes

    def _effective_budget(self) -> int:
        eff = self.budget_bytes
        if self._arena_bytes is not None:
            try:
                eff -= max(0, int(self._arena_bytes()))
            except Exception:
                pass
        return max(0, eff)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"cache_tier_hits": self.hits,
                    "cache_tier_misses": self.misses,
                    "cache_tier_items": len(self._items),
                    "cache_tier_bytes": self._nbytes}

    # -- data path ---------------------------------------------------------
    def lookup(self, indices: Sequence[int]
               ) -> Tuple[Dict[int, np.ndarray], List[int]]:
        """Partition ``indices`` into served hits and missing indices."""
        hits: Dict[int, np.ndarray] = {}
        missing: List[int] = []
        with self._lock:
            for i in indices:
                item = self._items.get(int(i))
                if item is None:
                    missing.append(int(i))
                    self.misses += 1
                else:
                    hits[int(i)] = item
                    self.hits += 1
        return hits, missing

    def admit(self, index: int, item: np.ndarray) -> bool:
        """Insert ``item`` if its chunk is hot and the budget allows."""
        cid = int(index) // self.chunk
        if cid >= self.hot_chunks:
            return False
        nbytes = int(getattr(item, "nbytes", 0) or 0)
        with self._lock:
            if int(index) in self._items:
                return True
            if self._nbytes + nbytes > self._effective_budget():
                return False
            self._items[int(index)] = item
            self._chunk_bytes[cid] = self._chunk_bytes.get(cid, 0) + nbytes
            self._nbytes += nbytes
            assert self._nbytes <= self.budget_bytes, \
                (self._nbytes, self.budget_bytes)
            return True

    def _evict_over_budget(self) -> None:
        # caller holds the lock; drop highest chunk ids until both the
        # hot-set filter and the budget are satisfied again
        while self._chunk_bytes:
            top = max(self._chunk_bytes)
            if top < self.hot_chunks and self._nbytes <= self.budget_bytes:
                break
            lo, hi = top * self.chunk, (top + 1) * self.chunk
            for i in range(lo, hi):
                item = self._items.pop(i, None)
                if item is not None:
                    self.evictions += 1
            self._nbytes -= self._chunk_bytes.pop(top)
        if not self._chunk_bytes:
            self._nbytes = 0

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._chunk_bytes.clear()
            self._nbytes = 0


class CachedStorage(Storage):
    """Storage view that serves reads through a ``CacheTier``.

    Deliberately does *not* forward the inner storage's io-counter fields:
    ``DataLoader.io_counters()`` keeps reading the unwrapped storage for
    IO truth, and tier hit/miss counters are reported separately — hits
    never reach the inner storage at all, which is the point.
    """

    def __init__(self, inner: Storage, tier: CacheTier, *,
                 admit: bool = True):
        self.inner = inner
        self.tier = tier
        self.admit = admit

    def __len__(self) -> int:
        return len(self.inner)

    def item_nbytes(self, index: int) -> int:
        return self.inner.item_nbytes(index)

    def profile(self, **kw):
        return self.inner.profile(**kw)

    def read(self, index: int) -> np.ndarray:
        hits, missing = self.tier.lookup([index])
        if not missing:
            return hits[int(index)]
        item = self.inner.read(index)
        if self.admit and not self.tier.read_only:
            self.tier.admit(index, item)
        return item

    def read_batch(self, indices: Sequence[int]) -> List[np.ndarray]:
        idx = [int(i) for i in indices]
        hits, missing = self.tier.lookup(idx)
        if missing:
            fetched = self.inner.read_batch(missing)
            admit = self.admit and not self.tier.read_only
            for i, item in zip(missing, fetched):
                hits[i] = item
                if admit:
                    self.tier.admit(i, item)
        return [hits[i] for i in idx]
