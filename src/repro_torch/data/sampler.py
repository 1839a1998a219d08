"""Deterministic, checkpointable, host-sharded batch sampler.

Multi-pod semantics: every host sees the same global permutation (seeded by
(seed, epoch)) and takes a strided shard of each global batch, so the fleet
consumes a consistent global batch without coordination.  The sampler state
(epoch, offset) is part of the training checkpoint — restart resumes the
data stream exactly (fault-tolerance requirement).

IO locality (DESIGN.md §5): ``locality_chunk = C > 1`` switches the epoch
permutation from fully random to *chunked* — fixed-size contiguous chunks
of the index space are shuffled as units, and items are shuffled within
each chunk.  A batch then covers a few whole chunks instead of B scattered
items, so ``Storage.read_batch``'s sorted-miss coalescing sees contiguous
runs of ~C items (one storage request per run instead of one per item) on
cold epochs.  Coverage is untouched: a chunked order is still exactly a
permutation of [0, N), so once-per-epoch delivery — including under
mid-epoch ``reshard`` — holds unconditionally.  Locality changes are
epoch-latched (``set_locality``): an in-progress epoch keeps its order, so
a live hot swap can never split one epoch across two permutations.  A
coordinated fleet pins the latch epoch explicitly (``set_locality(chunk,
epoch=E)``) so every host adopts the new chunk for the SAME epoch even
when their producers straddle an epoch boundary.

Host layout (DESIGN.md §6): hosts take *contiguous* slices of each global
batch (``host_major``, the default) rather than strided ones.  Any
deterministic partition of the global batch preserves the coverage
invariant (the union over hosts is the batch either way), but striding
dilutes locality — each host gets every H-th element, shrinking per-host
coalesced runs toward C/H — while host-major slices keep whole chunks on
one host at any host count.  ``layout="strided"`` keeps the legacy
behavior for A/B measurement (bench_locality's multi-host gate).

Elastic geometry (DESIGN.md §11): the global batch itself is an
epoch-latched schedule (``set_geometry``), exactly like the locality and
cache-plan schedules — an in-progress epoch keeps its batch boundaries
(the stream position is counted in global batches, so moving a boundary
mid-epoch would re-partition batches that were already delivered), and
the new geometry applies from a pinned future epoch on every host at
once.  Within an epoch, hosts may take *non-uniform* contiguous slices
(``shard_sizes``): per-host sizes summing to the global batch, so a
reshard to a survivor count that does not divide the global batch can
finish the epoch with a ragged split instead of raising, and a per-host
consensus can hand fast hosts proportionally larger slices.  Sizes only
change the partition of each global batch — never the permutation or the
batch boundaries — so they may switch at any common batch barrier, while
geometry (which moves boundaries) must latch at an epoch boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SamplerState:
    epoch: int = 0
    batch_offset: int = 0

    def to_dict(self):
        return {"epoch": self.epoch, "batch_offset": self.batch_offset}

    @classmethod
    def from_dict(cls, d):
        return cls(epoch=int(d["epoch"]), batch_offset=int(d["batch_offset"]))

    def advanced(self, n: int, batches_per_epoch: int) -> "SamplerState":
        """State after consuming n more batches.  Checkpoints must record
        the CONSUMER's position, not the producer's (workers + prefetch run
        ahead of the train loop)."""
        total = self.epoch * batches_per_epoch + self.batch_offset + n
        return SamplerState(total // batches_per_epoch,
                            total % batches_per_epoch)

    def absolute(self, batches_per_epoch: int) -> int:
        """Position as a single global batch count since step 0."""
        return self.epoch * batches_per_epoch + self.batch_offset

    @classmethod
    def from_absolute(cls, position: int,
                      batches_per_epoch: int) -> "SamplerState":
        return cls(position // batches_per_epoch,
                   position % batches_per_epoch)


class ShardedSampler:
    def __init__(self, num_items: int, global_batch: int, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 host_index: int = 0, host_count: int = 1,
                 state: Optional[SamplerState] = None,
                 locality_chunk: int = 0, layout: str = "host_major",
                 shard_sizes: Optional[Sequence[int]] = None):
        if layout not in ("host_major", "strided"):
            raise ValueError(f"unknown shard layout {layout!r}")
        if shard_sizes is not None:
            shard_sizes = tuple(int(s) for s in shard_sizes)
            if (len(shard_sizes) != host_count
                    or sum(shard_sizes) != global_batch
                    or min(shard_sizes) < 0):
                raise ValueError(
                    f"shard_sizes {shard_sizes} must be {host_count} "
                    f"non-negative sizes summing to {global_batch}")
        elif global_batch % host_count:
            raise ValueError(
                f"global_batch {global_batch} not divisible by host_count "
                f"{host_count} (pass shard_sizes= for a ragged split)")
        self.num_items = num_items
        # (first_epoch, global_batch) steps — same latch semantics as the
        # locality schedule.  ``global_batch`` / ``local_batch`` are
        # properties over this schedule at the current epoch.
        self._geometry_schedule: List[Tuple[int, int]] = [
            (0, int(global_batch))]
        self._shard_sizes: Optional[Tuple[int, ...]] = shard_sizes
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.host_index = host_index
        self.host_count = host_count
        self.state = state or SamplerState()
        self.layout = layout
        self.locality_chunk = max(0, int(locality_chunk))
        # (first_epoch, chunk) steps; the chunk for epoch e is the last
        # entry with first_epoch <= e — how set_locality defers a change
        # to the next epoch boundary without forgetting the old order
        self._locality_schedule: List[Tuple[int, int]] = [
            (0, self.locality_chunk)]
        # (first_epoch, hot_k) steps for the cache-aware order (DESIGN.md
        # §7): hot_k > 0 interleaves the first hot_k index-space chunks
        # (the cache tier's deterministic hot set) evenly among the cold
        # ones, so cached hits are consumed while the prefetcher fills
        # misses.  Same latch semantics as the locality schedule.
        self._cache_schedule: List[Tuple[int, int]] = [(0, 0)]
        self._perm_cache: dict = {}

    def batches_per_epoch(self, epoch: Optional[int] = None) -> int:
        return self._bpe_for(self.gb_for_epoch(
            self.state.epoch if epoch is None else epoch))

    def _bpe_for(self, global_batch: int) -> int:
        if self.drop_last:
            return self.num_items // global_batch
        return -(-self.num_items // global_batch)

    # ---- geometry schedule --------------------------------------------------
    @property
    def global_batch(self) -> int:
        return self.gb_for_epoch(self.state.epoch)

    @property
    def local_batch(self) -> int:
        return self.sizes_for_epoch(self.state.epoch)[self.host_index]

    @property
    def shard_sizes(self) -> Optional[Tuple[int, ...]]:
        return self._shard_sizes

    @staticmethod
    def even_split(total: int, parts: int) -> Tuple[int, ...]:
        """Largest-remainder split of ``total`` over ``parts`` hosts: the
        first ``total % parts`` hosts take one extra item, so sizes always
        sum to ``total`` — the ragged fallback when divisibility fails."""
        base, rem = divmod(int(total), int(parts))
        return tuple(base + (1 if i < rem else 0) for i in range(parts))

    def gb_for_epoch(self, epoch: int) -> int:
        """The global batch in effect for ``epoch``."""
        gb = self._geometry_schedule[0][1]
        for e, g in self._geometry_schedule:
            if e > epoch:
                break
            gb = g
        return gb

    def sizes_for_epoch(self, epoch: int) -> Tuple[int, ...]:
        """Per-host slice sizes of each global batch in ``epoch``.

        Explicit ``shard_sizes`` apply while they still sum to the epoch's
        global batch; once a geometry change makes them stale the split
        reverts to even (the coordinator re-pushes weighted sizes after a
        geometry latch if it still wants them)."""
        gb = self.gb_for_epoch(epoch)
        if (self._shard_sizes is not None
                and len(self._shard_sizes) == self.host_count
                and sum(self._shard_sizes) == gb):
            return self._shard_sizes
        return self.even_split(gb, self.host_count)

    def set_geometry(self, global_batch: int, *,
                     epoch: Optional[int] = None) -> int:
        """Change the global batch.  Epoch-latched exactly like
        ``set_locality`` — batch boundaries are position arithmetic, so an
        in-progress epoch must keep its geometry and a fleet pins one
        common latch epoch for every host.  Returns the effective first
        epoch of the new geometry."""
        global_batch = int(global_batch)
        if global_batch <= 0:
            raise ValueError(f"global_batch must be positive, "
                             f"got {global_batch}")
        eff = self.natural_latch_epoch()
        if epoch is not None:
            eff = max(eff, int(epoch))
        elif global_batch == self._geometry_schedule[-1][1]:
            return eff
        self._geometry_schedule = [
            (e, g) for e, g in self._geometry_schedule if e < eff]
        self._geometry_schedule.append((eff, global_batch))
        return eff

    def force_geometry(self, global_batch: int) -> None:
        """Reset the schedule to ``global_batch`` for every epoch
        (restore path)."""
        self._geometry_schedule = [(0, int(global_batch))]

    def geometry_state(self) -> List[List[int]]:
        return [[int(e), int(g)] for e, g in self._geometry_schedule]

    def load_geometry(self, schedule: Sequence[Sequence[int]]) -> None:
        self._geometry_schedule = [(int(e), int(g)) for e, g in schedule]

    # ---- schedule-aware absolute position ----------------------------------
    def epoch_start(self, epoch: int) -> int:
        """Absolute batch position where ``epoch`` starts.  With an
        elastic geometry schedule epochs have different lengths, so this
        walks the schedule instead of multiplying by a constant."""
        total = 0
        sched = self._geometry_schedule
        for i, (e0, gb) in enumerate(sched):
            if e0 >= epoch:
                break
            e1 = min(epoch,
                     sched[i + 1][0] if i + 1 < len(sched) else epoch)
            total += (e1 - e0) * self._bpe_for(gb)
        return total

    def absolute(self) -> int:
        """The current state's position as a single global batch count
        since step 0 (schedule-aware replacement for
        ``SamplerState.absolute``)."""
        return self.epoch_start(self.state.epoch) + self.state.batch_offset

    def state_at(self, position: int) -> SamplerState:
        """(epoch, batch_offset) for an absolute position under the
        geometry schedule (schedule-aware ``SamplerState.from_absolute``)."""
        pos = int(position)
        sched = self._geometry_schedule
        for i, (e0, gb) in enumerate(sched):
            bpe = self._bpe_for(gb)
            if i + 1 < len(sched):
                span = (sched[i + 1][0] - e0) * bpe
                if pos < span:
                    return SamplerState(e0 + pos // bpe, pos % bpe)
                pos -= span
            else:
                return SamplerState(e0 + pos // bpe, pos % bpe)
        raise AssertionError("unreachable: schedule is never empty")

    def latch_epoch_for(self, position: int) -> int:
        """First epoch whose start is at or after ``position`` — where a
        producer that has run ahead to ``position`` could first adopt a
        new permutation or geometry."""
        st = self.state_at(position)
        return st.epoch + (1 if st.batch_offset else 0)

    # ---- locality schedule ------------------------------------------------
    def chunk_for_epoch(self, epoch: int) -> int:
        """The locality_chunk in effect for ``epoch``."""
        chunk = self._locality_schedule[0][1]
        for e, c in self._locality_schedule:
            if e > epoch:
                break
            chunk = c
        return chunk

    def natural_latch_epoch(self) -> int:
        """The first epoch a locality change could take effect for: the
        current epoch if it has not produced a batch yet, else the next."""
        return self.state.epoch + (1 if self.state.batch_offset else 0)

    def set_locality(self, chunk: int, *, epoch: Optional[int] = None) -> int:
        """Change the chunked-shuffle granularity (0/1 = fully random).

        Epoch-latched: takes effect for the current epoch only if it has
        not delivered a batch yet, otherwise from the next epoch — an
        in-progress epoch keeps its permutation, so coverage stays exact
        across a live hot swap.  ``epoch`` pins the latch explicitly (a
        fleet coordinator pushes one common epoch to every host so the
        whole fleet adopts the new chunk for the SAME epoch); it is
        clamped up to this sampler's natural latch epoch, never down —
        an epoch that already produced batches keeps its order.  Returns
        the effective first epoch of the new chunk.
        """
        chunk = max(0, int(chunk))
        eff = self.natural_latch_epoch()
        if epoch is not None:
            eff = max(eff, int(epoch))
        elif chunk == self.locality_chunk:
            return eff
        self.locality_chunk = chunk
        # epochs >= eff follow the new chunk; earlier epochs keep whatever
        # was scheduled (they may already have produced batches)
        self._locality_schedule = [
            (e, c) for e, c in self._locality_schedule if e < eff]
        self._locality_schedule.append((eff, chunk))
        return eff

    def force_locality(self, chunk: int) -> None:
        """Reset the schedule to ``chunk`` for every epoch (restore path)."""
        self.locality_chunk = max(0, int(chunk))
        self._locality_schedule = [(0, self.locality_chunk)]

    def locality_state(self) -> List[List[int]]:
        return [[int(e), int(c)] for e, c in self._locality_schedule]

    def load_locality(self, schedule: Sequence[Sequence[int]]) -> None:
        self._locality_schedule = [(int(e), int(c)) for e, c in schedule]
        self.locality_chunk = self._locality_schedule[-1][1]

    # ---- cache plan --------------------------------------------------------
    @property
    def cache_hot_chunks(self) -> int:
        return self._cache_schedule[-1][1]

    def hot_k_for_epoch(self, epoch: int) -> int:
        """The cache hot-chunk count in effect for ``epoch``."""
        hot_k = self._cache_schedule[0][1]
        for e, k in self._cache_schedule:
            if e > epoch:
                break
            hot_k = k
        return hot_k

    def set_cache_plan(self, hot_k: int, *,
                       epoch: Optional[int] = None) -> int:
        """Change the cache-aware interleave (0 = plan-blind order).

        Epoch-latched exactly like ``set_locality`` — the plan changes the
        epoch permutation, so an in-progress epoch must keep its order and
        a fleet pins one common latch epoch for every host.  Returns the
        effective first epoch of the new plan."""
        hot_k = max(0, int(hot_k))
        eff = self.natural_latch_epoch()
        if epoch is not None:
            eff = max(eff, int(epoch))
        elif hot_k == self.cache_hot_chunks:
            return eff
        self._cache_schedule = [
            (e, k) for e, k in self._cache_schedule if e < eff]
        self._cache_schedule.append((eff, hot_k))
        return eff

    def force_cache_plan(self, hot_k: int) -> None:
        """Reset the plan to ``hot_k`` for every epoch (restore path)."""
        self._cache_schedule = [(0, max(0, int(hot_k)))]

    def cache_state(self) -> List[List[int]]:
        return [[int(e), int(k)] for e, k in self._cache_schedule]

    def load_cache_plan(self, schedule: Sequence[Sequence[int]]) -> None:
        self._cache_schedule = [(int(e), int(k)) for e, k in schedule]

    # ---- epoch orders -----------------------------------------------------
    @staticmethod
    def _chunked_perm(rng: np.random.Generator, n: int,
                      chunk: int) -> np.ndarray:
        """Shuffle contiguous ``chunk``-sized blocks of [0, n) as units,
        and shuffle within each block.  Still exactly a permutation of
        [0, n), so coverage never depends on the chunk size."""
        n_chunks = -(-n // chunk)
        order = rng.permutation(n_chunks)
        keys = rng.random((n_chunks, chunk))
        base = np.arange(n_chunks * chunk).reshape(n_chunks, chunk)
        within = np.take_along_axis(base, np.argsort(keys, axis=1), axis=1)
        perm = within[order].reshape(-1)
        # the padded tail chunk carries out-of-range slots: drop them
        return perm[perm < n] if n_chunks * chunk != n else perm

    @staticmethod
    def _interleaved_perm(rng: np.random.Generator, n: int, chunk: int,
                          hot_k: int) -> np.ndarray:
        """Chunked permutation whose first ``hot_k`` index-space chunks
        (the cache tier's hot set) land at evenly spaced positions among
        the cold chunks: cached hits are consumed throughout the epoch
        while the prefetcher fills the cold misses between them.  Hot and
        cold chunks are each shuffled, so this is still exactly a
        permutation of [0, n) — coverage is untouched."""
        n_chunks = -(-n // chunk)
        hot_k = min(hot_k, n_chunks)
        hot = rng.permutation(hot_k)
        cold = hot_k + rng.permutation(n_chunks - hot_k)
        order = np.empty(n_chunks, dtype=np.int64)
        pos = (np.arange(hot_k) * n_chunks) // hot_k
        mask = np.zeros(n_chunks, dtype=bool)
        mask[pos] = True
        order[pos] = hot
        order[~mask] = cold
        keys = rng.random((n_chunks, chunk))
        base = np.arange(n_chunks * chunk).reshape(n_chunks, chunk)
        within = np.take_along_axis(base, np.argsort(keys, axis=1), axis=1)
        perm = within[order].reshape(-1)
        return perm[perm < n] if n_chunks * chunk != n else perm

    def _epoch_perm(self, epoch: int,
                    chunk: Optional[int] = None) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_items)
        if chunk is None:
            chunk = self.chunk_for_epoch(epoch)
            hot_k = self.hot_k_for_epoch(epoch)
        else:
            # explicit override = a DPT trial measuring a candidate chunk:
            # plan-blind, so trials never depend on the live cache plan
            hot_k = 0
        chunk = max(0, int(chunk))
        if chunk <= 1:
            hot_k = 0   # a fully random order already interleaves hot/cold
        key = (epoch, chunk, hot_k, self.seed, self.num_items)
        perm = self._perm_cache.get(key)
        if perm is None:
            rng = np.random.default_rng((self.seed, epoch))
            if chunk <= 1:
                perm = rng.permutation(self.num_items)
            elif hot_k > 0:
                perm = self._interleaved_perm(rng, self.num_items, chunk,
                                              hot_k)
            else:
                perm = self._chunked_perm(rng, self.num_items, chunk)
            if len(self._perm_cache) >= 4:   # tiny memo: streams touch at
                self._perm_cache.clear()     # most a couple of epochs at once
            self._perm_cache[key] = perm
        return perm

    def local_indices(self, epoch: int, batch: int,
                      chunk: Optional[int] = None) -> np.ndarray:
        """This host's slice of global batch ``batch`` in ``epoch``.

        ``chunk`` overrides the scheduled locality for this lookup only
        (DPT trials measure candidate chunk sizes without touching the
        live schedule).
        """
        perm = self._epoch_perm(epoch, chunk)
        gb = self.gb_for_epoch(epoch)
        start = batch * gb
        glob = perm[start:start + gb]
        if len(glob) < gb and not self.drop_last:
            glob = np.concatenate([glob, perm[:gb - len(glob)]])
        if self.layout == "strided":
            return glob[self.host_index::self.host_count]
        # host-major: contiguous slice — whole chunks of a chunked perm
        # stay on one host (strided slices dilute runs toward C/H).  Both
        # layouts partition the global batch, so coverage is identical —
        # including under non-uniform sizes, whose prefix-sum offsets
        # still tile the batch exactly.
        sizes = self.sizes_for_epoch(epoch)
        off = sum(sizes[:self.host_index])
        return glob[off:off + sizes[self.host_index]]

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            n = self.batches_per_epoch(self.state.epoch)
            while self.state.batch_offset < n:
                b = self.state.batch_offset
                self.state.batch_offset += 1
                yield self.local_indices(self.state.epoch, b)
            self.state.epoch += 1
            self.state.batch_offset = 0

    def epoch_iter(self, epoch: Optional[int] = None,
                   chunk: Optional[int] = None) -> Iterator[np.ndarray]:
        """One epoch, non-stateful (used by DPT trials).  ``chunk``
        overrides the scheduled locality for this iteration only."""
        e = self.state.epoch if epoch is None else epoch
        for b in range(self.batches_per_epoch(e)):
            yield self.local_indices(e, b, chunk)

    # ---- elastic resharding -------------------------------------------------
    def reshard(self, num_shards: int, shard: int, *,
                sizes: Optional[Sequence[int]] = None) -> None:
        """Remap this sampler's shard of the live stream (elastic fleet
        transition: a host died or joined, or the coordinator re-weighted
        the per-host split).

        The global permutation and the global-batch boundaries depend only
        on (seed, epoch, global_batch) — never on the shard topology — so
        changing (shard, num_shards) at a global batch boundary re-slices
        every NOT-YET-DELIVERED global batch while leaving delivered ones
        untouched.  The union over the new shard set of any global batch is
        exactly that batch's indices, which is the zero-lost/zero-duplicated
        coverage invariant the fleet coordinator relies on.  The position
        (epoch, batch_offset) is in global batches and survives unchanged.

        ``sizes`` gives an explicit per-shard split of the current epoch's
        global batch (ragged survivor counts, per-host consensus weights).
        Without it the split must be uniform, and a non-divisible count
        raises rather than silently truncating.
        """
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range for "
                             f"{num_shards} shards")
        if sizes is not None:
            sizes = tuple(int(s) for s in sizes)
            if (len(sizes) != num_shards or sum(sizes) != self.global_batch
                    or min(sizes) < 0):
                raise ValueError(
                    f"sizes {sizes} must be {num_shards} non-negative "
                    f"sizes summing to {self.global_batch}")
        elif self.global_batch % num_shards:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"num_shards {num_shards} (pass sizes= for a ragged split)")
        self.host_count = num_shards
        self.host_index = shard
        self._shard_sizes = sizes
