"""The online locality loop (DESIGN.md §6).

``locality_chunk`` is the startup grid's third axis; this module makes
it a first-class *online* knob, closed at two speeds:

* **Retune-time sweep** (:func:`sweep_locality` + :func:`locality_win`):
  when an online re-search runs anyway, candidate chunk sizes are priced
  at the winning (nWorker, nPrefetch) cell through the measurement-only
  evaluator override (trials never touch the live epoch schedule), and a
  significant winner rides the same hot swap — latched at the next epoch
  boundary by ``ShardedSampler.set_locality``.

* **Counter-driven resize** (:class:`AdaptiveLocalityController`): the
  live pipeline already surfaces its achieved coalesced run length
  (``DataLoader.io_counters``).  When the observed run length falls well
  below the active chunk — the cache warmed up, the storage topology
  changed, a reshard shrank per-host slices — chunking is buying nothing
  at its current size, and the controller proposes a resize *without* a
  search: shrink toward what the storage actually achieves.  Proposals
  apply through ``apply_params`` (single host) or route to the fleet
  coordinator (``on_propose``), because a sharded fleet may only change
  locality uniformly.

Who owns the knob when: the startup grid owns the *initial* chunk (it
can afford to measure the full axis cold); the retune sweep owns drift
that a measurement can resolve (storage got slower/faster); the adaptive
controller owns the fast path down (observed runs collapsed) — it only
ever shrinks, so a wrong proposal costs locality, never correctness, and
the next retune sweep can climb back up.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dpt import Trial
from repro_torch.core.monitor import MemoryOverflow
from repro_torch.tuning.base import steady_samples, welch_wins


def sweep_locality(evaluator, *, nworker: int, nprefetch: int,
                   chunks: Sequence[int], current_chunk: int,
                   num_batches: int, epoch: int = 0) -> Dict[int, Trial]:
    """Price candidate ``locality_chunk`` values at one (worker, prefetch)
    cell through the evaluator's measurement-only override.

    The current chunk is always measured too (it is the reference the win
    test defends), every candidate at the SAME cell — so the comparison
    isolates the locality axis.  Overflowed cells score ``inf``.
    """
    trials: Dict[int, Trial] = {}
    for chunk in dict.fromkeys([max(0, int(current_chunk)),
                                *(max(0, int(c)) for c in chunks)]):
        try:
            stats = evaluator(nworker, nprefetch, num_batches=num_batches,
                              epoch=epoch, locality_chunk=chunk)
            if stats.overflowed:
                raise MemoryOverflow("overflowed")
            trials[chunk] = Trial(
                nworker, nprefetch, stats.seconds,
                peak_bytes=stats.peak_loader_bytes,
                batch_seconds=getattr(stats, "batch_seconds", None),
                locality_chunk=chunk)
        except MemoryOverflow:
            trials[chunk] = Trial(nworker, nprefetch, math.inf,
                                  overflowed=True, locality_chunk=chunk)
    return trials


def locality_win(trials: Dict[int, Trial], current_chunk: int, *,
                 min_improvement: float = 0.05) -> Optional[int]:
    """The locality analogue of ``RetunePolicy.is_win``: the argmin chunk
    must beat the CURRENT chunk's own measured trial — by a Welch test
    over per-batch times when both sides carry samples, else by the
    relative ``min_improvement`` threshold.  Returns the winning chunk,
    or None (keep the current one)."""
    current_chunk = max(0, int(current_chunk))
    finite = {c: t for c, t in trials.items() if math.isfinite(t.seconds)}
    if not finite:
        return None
    best = min(finite, key=lambda c: finite[c].seconds)
    ref = trials.get(current_chunk)
    if best == current_chunk:
        return None
    if ref is None or not math.isfinite(ref.seconds):
        return best                       # nothing measured to defend
    ref_s = steady_samples(ref.batch_seconds)
    win_s = steady_samples(finite[best].batch_seconds)
    if len(ref_s) >= 2 and len(win_s) >= 2:
        return best if welch_wins(ref_s, win_s) else None
    if finite[best].seconds <= (1.0 - min_improvement) * ref.seconds:
        return best
    return None


def sweep_cache(evaluator, *, nworker: int, nprefetch: int,
                budgets: Sequence[int], current_budget: int,
                num_batches: int, epoch: int = 1) -> Dict[int, Trial]:
    """Price candidate ``cache_budget_bytes`` values at one (worker,
    prefetch) cell — the cache analogue of :func:`sweep_locality`.

    Measured at a WARM epoch by default: a cross-epoch cache only pays off
    from epoch 1 on, so pricing it cold would always pick 0.  Candidates
    go through the evaluator's measurement-only override (throwaway tiers;
    the live tier is never polluted).
    """
    trials: Dict[int, Trial] = {}
    for budget in dict.fromkeys([max(0, int(current_budget)),
                                 *(max(0, int(b)) for b in budgets)]):
        try:
            stats = evaluator(nworker, nprefetch, num_batches=num_batches,
                              epoch=epoch, cache_budget_bytes=budget)
            if stats.overflowed:
                raise MemoryOverflow("overflowed")
            trials[budget] = Trial(
                nworker, nprefetch, stats.seconds,
                peak_bytes=stats.peak_loader_bytes,
                batch_seconds=getattr(stats, "batch_seconds", None),
                cache_budget_bytes=budget)
        except MemoryOverflow:
            trials[budget] = Trial(nworker, nprefetch, math.inf,
                                   overflowed=True,
                                   cache_budget_bytes=budget)
    return trials


def cache_win(trials: Dict[int, Trial], current_budget: int, *,
              min_improvement: float = 0.05) -> Optional[int]:
    """The cache-axis win test — same contract as :func:`locality_win`:
    the argmin budget must beat the CURRENT budget's own measured trial
    (Welch over per-batch samples when available, else the relative
    threshold).  Returns the winning budget, or None."""
    current_budget = max(0, int(current_budget))
    finite = {b: t for b, t in trials.items() if math.isfinite(t.seconds)}
    if not finite:
        return None
    best = min(finite, key=lambda b: finite[b].seconds)
    ref = trials.get(current_budget)
    if best == current_budget:
        return None
    if ref is None or not math.isfinite(ref.seconds):
        return best                       # nothing measured to defend
    ref_s = steady_samples(ref.batch_seconds)
    win_s = steady_samples(finite[best].batch_seconds)
    if len(ref_s) >= 2 and len(win_s) >= 2:
        return best if welch_wins(ref_s, win_s) else None
    if finite[best].seconds <= (1.0 - min_improvement) * ref.seconds:
        return best
    return None


def sweep_slow_lanes(evaluator, *, nworker: int, nprefetch: int,
                     lanes: Sequence[int], current_lanes: int,
                     num_batches: int, epoch: int = 0) -> Dict[int, Trial]:
    """Price candidate ``slow_lane_workers`` values at one (worker,
    prefetch) cell — the dual-lane analogue of :func:`sweep_locality`
    (DESIGN.md §9).

    Candidates go through the evaluator's measurement-only override, so
    the live pool's lane split is untouched; the live cost tracker keeps
    learning through the trials (trial batches are real decodes), which
    is exactly what makes a warm sweep honest — a cold tracker routes
    nothing to the slow lane and the candidate measures as pure overhead.
    """
    trials: Dict[int, Trial] = {}
    for k in dict.fromkeys([max(0, int(current_lanes)),
                            *(max(0, int(s)) for s in lanes)]):
        try:
            stats = evaluator(nworker, nprefetch, num_batches=num_batches,
                              epoch=epoch, slow_lane_workers=k)
            if stats.overflowed:
                raise MemoryOverflow("overflowed")
            trials[k] = Trial(
                nworker, nprefetch, stats.seconds,
                peak_bytes=stats.peak_loader_bytes,
                batch_seconds=getattr(stats, "batch_seconds", None),
                slow_lane_workers=k)
        except MemoryOverflow:
            trials[k] = Trial(nworker, nprefetch, math.inf,
                              overflowed=True, slow_lane_workers=k)
    return trials


def slow_lane_win(trials: Dict[int, Trial], current_lanes: int, *,
                  min_improvement: float = 0.05) -> Optional[int]:
    """The slow-lane win test — same contract as :func:`locality_win`:
    the argmin lane width must beat the CURRENT width's own measured
    trial (Welch over per-batch samples when available, else the
    relative threshold).  Returns the winning width, or None."""
    current_lanes = max(0, int(current_lanes))
    finite = {k: t for k, t in trials.items() if math.isfinite(t.seconds)}
    if not finite:
        return None
    best = min(finite, key=lambda k: finite[k].seconds)
    ref = trials.get(current_lanes)
    if best == current_lanes:
        return None
    if ref is None or not math.isfinite(ref.seconds):
        return best                       # nothing measured to defend
    ref_s = steady_samples(ref.batch_seconds)
    win_s = steady_samples(finite[best].batch_seconds)
    if len(ref_s) >= 2 and len(win_s) >= 2:
        return best if welch_wins(ref_s, win_s) else None
    if finite[best].seconds <= (1.0 - min_improvement) * ref.seconds:
        return best
    return None


# --------------------------------------------------------------------------
# counter-driven adaptive chunk sizing
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AdaptiveLocalityConfig:
    # trigger: observed run length < low_watermark * active chunk
    low_watermark: float = 0.5
    # a window must contain this many storage requests before the run
    # length estimate is trusted (tiny windows are all noise)
    min_requests: int = 8
    # consecutive low windows required before proposing (one cold spike
    # must not shrink a good chunk)
    patience: int = 2
    # steps between io_counters() polls (counters are cheap but not free)
    check_every: int = 8
    # min steps between proposals (a resize latches at an epoch boundary;
    # re-proposing before the latch takes effect would thrash)
    cooldown_steps: int = 64
    # proposals snap DOWN to the largest power of two <= the observed
    # run length; below min_chunk the proposal is 0 (chunking is buying
    # nothing — fall back to the fully random order)
    min_chunk: int = 4


class AdaptiveLocalityController:
    """Closes the loop on live IO counters: shrink ``locality_chunk`` when
    the storage stops achieving it.

    Feed it either way:

    * ``step()`` — pull mode: polls ``loader.io_counters()`` every
      ``check_every`` calls (one call per train/serve step);
    * ``observe(io)`` — push mode: hand it a counters snapshot directly
      (tests, or a monitor that already polls).

    Counters are cumulative, so the controller differences consecutive
    snapshots and evaluates the *window's* achieved run length.  When the
    active chunk is C > 1 and the window's run length sits below
    ``low_watermark * C`` for ``patience`` consecutive windows, it
    proposes the largest power of two <= the observed run length (or 0
    below ``min_chunk``) — applied through ``apply_params`` so a live
    stream latches it at the next epoch boundary, or routed to
    ``on_propose`` (the fleet path: locality must change uniformly, so a
    sharded host never applies locally).
    """

    def __init__(self, loader,
                 config: Optional[AdaptiveLocalityConfig] = None, *,
                 on_propose: Optional[Callable[[int], None]] = None):
        self.loader = loader
        self.cfg = config or AdaptiveLocalityConfig()
        self.on_propose = on_propose
        self.steps = 0
        self.proposals = 0
        self.history: List[Dict[str, float]] = []
        self._last: Optional[Tuple[float, float]] = None  # (requests, misses)
        self._low_windows = 0
        self._last_proposal_step = -self.cfg.cooldown_steps

    @property
    def active_chunk(self) -> int:
        return self.loader.params.locality_chunk

    def step(self) -> Optional[int]:
        """One call per train/serve step; polls counters on schedule.
        Returns the proposed chunk when this step fired a resize."""
        self.steps += 1
        if self.steps % self.cfg.check_every:
            return None
        io = self.loader.io_counters()
        return self.observe(io) if io else None

    def observe(self, io: Dict[str, float]) -> Optional[int]:
        """Evaluate one counters snapshot; returns the proposal if fired."""
        if "coalesced_requests" not in io or "reads" not in io:
            return None
        req = float(io["coalesced_requests"])
        misses = float(io["reads"]) - float(io.get("cache_hits", 0.0))
        if self._last is None:
            self._last = (req, misses)
            return None
        d_req, d_miss = req - self._last[0], misses - self._last[1]
        self._last = (req, misses)
        chunk = self.active_chunk
        if chunk <= 1 or d_req < self.cfg.min_requests:
            self._low_windows = 0
            return None
        run_len = d_miss / d_req
        if run_len >= self.cfg.low_watermark * chunk:
            self._low_windows = 0
            return None
        self._low_windows += 1
        if self._low_windows < self.cfg.patience:
            return None
        if self.steps - self._last_proposal_step < self.cfg.cooldown_steps:
            return None
        return self._propose(run_len, chunk)

    def _propose(self, run_len: float, chunk: int) -> Optional[int]:
        if self.on_propose is None \
                and getattr(self.loader.sampler, "host_count", 1) > 1:
            # a sharded host must never change locality locally (every
            # host has to slice the SAME epoch permutation); without a
            # coordinator route there is nothing safe to do
            self._low_windows = 0
            return None
        proposal = self._snap(run_len)
        if proposal >= chunk:              # nothing smaller to propose
            self._low_windows = 0
            return None
        self._low_windows = 0
        self._last_proposal_step = self.steps
        self.proposals += 1
        self.history.append({"step": self.steps, "observed_run_len": run_len,
                             "active_chunk": chunk, "proposed": proposal})
        if self.on_propose is not None:
            # fleet path: a sharded host must not change locality locally
            self.on_propose(proposal)
        else:
            self.loader.apply_params(
                self.loader.params.replace(locality_chunk=proposal))
        return proposal

    def _snap(self, run_len: float) -> int:
        """Largest power of two <= run_len, or 0 below min_chunk (the
        storage achieves so little contiguity that random order is the
        honest setting).  The floor never drops below 2: a chunk of 0/1
        already means random order, so run lengths under 2 snap to 0
        regardless of ``min_chunk``."""
        if run_len < max(2.0, float(self.cfg.min_chunk)):
            return 0
        return 1 << (int(run_len).bit_length() - 1)
