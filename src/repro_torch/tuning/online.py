"""Online retuning: tuning as a continuous background activity.

The paper tunes once, offline, before training starts.  Production hosts
drift: storage throughput sags under co-tenant load, CPU gets stolen, the
batch mix changes.  The loop is split into three separable components so
the same machinery serves a single host (:class:`OnlineTuner`) and a
coordinated fleet (:mod:`repro_torch.tuning.fleet`, where observe stays on the
host and decide moves to the coordinator):

  observe   — :class:`GoodputMonitor`: the trainer (or serving engine)
              feeds it one (data-wait, step-time) pair per step.  The
              loader is healthy while its transfer time hides behind the
              model step; it is hurting goodput when the step stalls
              waiting for data.
  decide    — :class:`RetunePolicy`: warmup/cooldown/backoff bookkeeping
              plus the win test.  Drift is declared when the mean
              data-wait over the window exceeds ``stall_fraction`` of the
              mean compute time; a search winner is accepted only when it
              beats the current config by a variance-aware Welch test
              over per-batch times (falling back to the relative
              ``min_improvement`` threshold when the evaluator measured
              no per-batch samples).
  act       — :class:`RetuneExecutor`: runs a bounded strategy from the
              unified ``tune(...)`` layer against the live loader (trial
              cells measure on short side-channel epochs; the live stream
              keeps flowing), hot-swaps the winner in via
              ``apply_params`` (pool drained at a batch boundary, sampler
              state preserved, zero batches lost) and persists it in
              :class:`DPTCache` under the machine/dataset fingerprint so
              the next process on this host starts warm.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.cache import DPTCache
from repro_torch.core.dpt import DPTConfig, DPTResult, Trial
from repro_torch.core.monitor import MemoryOverflow
from repro_torch.data.loader import DataLoader, LoaderParams
from repro_torch.tuning.base import (adaptive_budget, steady_samples, tune,
                                     welch_wins)
from repro_torch.utils.fingerprint import machine_fingerprint


@dataclasses.dataclass
class OnlineTunerConfig:
    stall_fraction: float = 0.35     # data-wait / compute-time drift trigger
    window: int = 8                  # steps in the drift window
    warmup_steps: int = 4            # observations before drift can fire
    cooldown_steps: int = 16         # min steps between retunes
    # Measurement budget per trial cell.  None derives it adaptively as
    # >= 3x the deepest worker rung in the search space (see
    # tuning.base.adaptive_budget): with budget <= nWorker every config
    # finishes in one parallel wave and all cells measure identically
    # (pipeline fill, not steady-state rate).
    retune_budget_batches: Optional[int] = None
    max_prefetch: int = 4
    strategy: str = "hillclimb"      # bounded re-search policy
    max_search_steps: int = 12       # hillclimb step bound
    min_improvement: float = 0.05    # fallback win threshold (no samples)
    max_backoff: int = 8             # cooldown multiplier cap on no-win
    num_cpu_cores: Optional[int] = None   # override DPTConfig.resolve()
    num_devices: Optional[int] = None
    # online locality axis (DESIGN.md §6): candidate sampler chunk sizes a
    # retune may propose.  None keeps retunes on (workers, prefetch) — the
    # startup grid owns the knob.  When set, each retune prices the
    # candidates at the winning cell through the measurement-only override
    # and a significant winner rides the same hot swap (epoch-latched).
    locality_chunks: Optional[Tuple[int, ...]] = None
    # online cache axis (DESIGN.md §7): candidate cross-epoch cache budgets
    # a retune may propose.  Same ownership split as locality: None leaves
    # the knob to the startup grid.  Candidates are priced at a WARM epoch
    # through throwaway measurement tiers (the live tier is never polluted)
    # and a winner resizes the live tier in place via apply_params.
    cache_budgets: Optional[Tuple[int, ...]] = None
    # online dual-lane axis (DESIGN.md §9): candidate slow-lane widths a
    # retune may propose.  Same ownership split; candidates are priced
    # through the measurement-only override while the live cost tracker
    # keeps learning through the trials.
    slow_lanes: Optional[Tuple[int, ...]] = None
    # retune trigger on the per-item cost tail (io_counters'
    # ``sample_cost_tail_ratio``: p99 over median of the tracked per-item
    # cost estimates, ~1 uniform, large under a heavy tail).  0 disables;
    # only armed when ``slow_lanes`` is set — the tail signal exists to
    # resolve the lane axis, stalls still fire the goodput trigger.
    tail_ratio_trigger: float = 0.0
    # retune trigger on the fault plane (DESIGN.md §10): io_counters'
    # windowed ``fault_rate``.  0 disables.  Fires on the way IN (the
    # storage is browning out — a shallower config wastes less work on
    # reads that will be retried) and once on the way OUT (degraded mode
    # healed — re-search for the healthy optimum the degraded window
    # may have walked away from).
    fault_rate_trigger: float = 0.0


class GoodputMonitor:
    """Observe: the per-step goodput signal, windowed.

    One ``observe(data_s, step_s)`` call per training/serving step.  The
    stall ratio (mean data-wait over mean compute) is the drift signal;
    ``batch_seconds`` exposes the raw window for fleet reports.
    """

    def __init__(self, window: int = 8):
        self._data_s: deque = deque(maxlen=window)
        self._compute_s: deque = deque(maxlen=window)
        self.steps = 0
        # latest per-item cost tail ratio (p99/median) pushed from the
        # loader's cost tracker via note_tail(); 0 = no signal yet
        self.tail_ratio = 0.0
        # fault-plane signal (DESIGN.md §10), pushed via note_faults()
        self.fault_rate = 0.0
        self.degraded = False
        self.fault_healed = False   # one-shot: degraded -> healthy edge

    def observe(self, *, data_s: float, step_s: float) -> None:
        self.steps += 1
        self._data_s.append(max(0.0, data_s))
        self._compute_s.append(max(1e-9, step_s - data_s))

    def note_tail(self, ratio: float) -> None:
        """Push the loader's per-item cost tail ratio (DESIGN.md §9)."""
        self.tail_ratio = max(0.0, ratio)

    def note_faults(self, rate: float, degraded: bool) -> None:
        """Push the loader's windowed fault rate + degraded flag
        (DESIGN.md §10).  The degraded→healthy transition latches
        ``fault_healed`` so the heal fires one retune even though the
        rate is back under the trigger by then."""
        if self.degraded and not degraded:
            self.fault_healed = True
        self.fault_rate = max(0.0, rate)
        self.degraded = bool(degraded)

    @property
    def full(self) -> bool:
        return len(self._data_s) == self._data_s.maxlen

    @property
    def stall_ratio(self) -> float:
        """Mean data-wait over mean compute time in the current window."""
        if not self._compute_s:
            return 0.0
        return (sum(self._data_s) / len(self._data_s)) \
            / (sum(self._compute_s) / len(self._compute_s))

    @property
    def steps_per_s(self) -> float:
        """Goodput over the window (steps per wall second)."""
        total = sum(self._data_s) + sum(self._compute_s)
        return len(self._data_s) / total if total > 0 else 0.0

    @property
    def batch_seconds(self) -> List[float]:
        """Per-step wall times in the window (data wait + compute)."""
        return [d + c for d, c in zip(self._data_s, self._compute_s)]

    def reset(self) -> None:
        self._data_s.clear()
        self._compute_s.clear()
        self.fault_healed = False


class RetunePolicy:
    """Decide: when a re-search may run and whether its winner is real.

    Owns the warmup/cooldown/backoff bookkeeping and the win test; holds
    no reference to the loader or evaluator, so a coordinator can run the
    same policy over aggregated fleet signals.
    """

    def __init__(self, cfg: OnlineTunerConfig):
        self.cfg = cfg
        self._last_retune_step = -cfg.cooldown_steps
        self._backoff = 1            # doubles when a re-search finds no win

    def drifted(self, monitor: GoodputMonitor) -> bool:
        if monitor.stall_ratio > self.cfg.stall_fraction:
            return True
        # fault drift (DESIGN.md §10): the storage is failing hot (rate
        # over trigger) or just healed from degraded mode (one-shot edge)
        if self.cfg.fault_rate_trigger > 0.0 and (
                monitor.fault_rate > self.cfg.fault_rate_trigger
                or monitor.fault_healed):
            return True
        # tail drift: a heavy per-item cost tail is drift even before it
        # shows as a mean stall — only armed when the lane axis exists
        return bool(self.cfg.slow_lanes
                    and self.cfg.tail_ratio_trigger > 0.0
                    and monitor.tail_ratio > self.cfg.tail_ratio_trigger)

    def should_retune(self, monitor: GoodputMonitor) -> bool:
        if monitor.steps < self.cfg.warmup_steps:
            return False
        cooldown = self.cfg.cooldown_steps * self._backoff
        if monitor.steps - self._last_retune_step < cooldown:
            return False
        if not monitor.full:
            return False
        return self.drifted(monitor)

    def note_searched(self, step: int) -> None:
        self._last_retune_step = step

    def record_outcome(self, won: bool) -> None:
        """A no-win search doubles the cooldown — if the loader is simply
        the bottleneck at its optimum, re-search cannot help and should
        get rarer.  A win resets the backoff."""
        self._backoff = 1 if won else min(self.cfg.max_backoff,
                                          self._backoff * 2)

    # ---- the win test ------------------------------------------------------
    @staticmethod
    def _find_trial(result: DPTResult, cell: Tuple[int, int],
                    strategy: str) -> Optional[Trial]:
        if strategy == "hillclimb" and result.trials:
            # the hillclimb's first trial is its start: the current config
            # snapped onto the search lattice — the improvement reference
            # even when the exact current cell is off-lattice
            return result.trials[0]
        return next((t for t in result.trials
                     if (t.nworker, t.nprefetch) == cell), None)

    def is_win(self, result: DPTResult, current: LoaderParams) -> bool:
        """Anti-churn: only swap when the winner beats the CURRENT config's
        own measured cell.

        With per-batch samples on both cells the comparison is a Welch
        test (variance-aware: noisy measurements need a bigger gap);
        without samples it falls back to the relative ``min_improvement``
        threshold on the cell means.
        """
        cur_cell = (current.num_workers, current.prefetch_factor)
        ref = self._find_trial(result, cur_cell, self.cfg.strategy)
        win_cell = (result.nworker, result.nprefetch)
        if win_cell == cur_cell:
            return False
        if ref is not None and win_cell == (ref.nworker, ref.nprefetch):
            return False
        if ref is None:
            return True                      # nothing measured to defend
        winner = next((t for t in result.trials
                       if (t.nworker, t.nprefetch) == win_cell), None)
        # drop each cell's pipeline-fill prefix before the Welch test
        # (see tuning.base.steady_samples)
        ref_samples = steady_samples(ref.batch_seconds)
        win_samples = steady_samples(winner.batch_seconds) if winner else []
        if len(ref_samples) >= 2 and len(win_samples) >= 2:
            return welch_wins(ref_samples, win_samples)
        return result.optimal_time \
            <= (1.0 - self.cfg.min_improvement) * ref.seconds


class RetuneExecutor:
    """Act: bounded re-search against the live loader + hot swap + cache."""

    def __init__(self, loader: DataLoader, evaluator,
                 cfg: OnlineTunerConfig, *, cache: Optional[DPTCache] = None,
                 machine_fp: Optional[str] = None,
                 dataset_fp: Optional[str] = None):
        self.loader = loader
        self.evaluator = evaluator
        self.cfg = cfg
        self.cache = cache
        self.machine_fp = machine_fp or machine_fingerprint()
        self.dataset_fp = dataset_fp or loader.dataset.fingerprint()

    def search_config(self) -> DPTConfig:
        cfg = DPTConfig(num_cpu_cores=self.cfg.num_cpu_cores,
                        num_devices=self.cfg.num_devices,
                        max_prefetch=self.cfg.max_prefetch)
        return dataclasses.replace(cfg, num_batches=adaptive_budget(
            cfg, self.cfg.retune_budget_batches))

    def search(self) -> Optional[DPTResult]:
        """Run the bounded strategy; the loader's params are restored even
        on unexpected evaluator errors so a live stream never rebuilds on
        trial params (trial measurements mutate loader.params via
        with_params)."""
        orig = self.loader.params
        cfg = self.search_config()
        kwargs: Dict[str, Any] = {}
        if self.cfg.strategy == "hillclimb":
            _, G = cfg.resolve()
            kwargs = {"start": (max(G, orig.num_workers),
                                orig.prefetch_factor),
                      "max_steps": self.cfg.max_search_steps}
        elif self.cfg.strategy == "grid":
            kwargs = {"measure_default": False}
        try:
            return tune(evaluator=self.evaluator, strategy=self.cfg.strategy,
                        config=cfg, **kwargs)
        except MemoryOverflow:
            return None
        finally:
            self.loader.with_params(orig)

    def sweep_locality(self, nworker: int, nprefetch: int
                       ) -> Tuple[Optional[int], List[Trial]]:
        """Price the configured chunk candidates at one cell.

        Returns ``(winner, trials)``: the significant winning chunk (None
        = keep the current one) plus the sweep's trials, so the caller
        can fold them into the retune's DPTResult (the cache reads them
        to tell a searched axis from a blind one).  Trials run through
        the measurement-only override, so the live epoch schedule is
        never perturbed; loader params are restored afterwards.
        """
        if not self.cfg.locality_chunks:
            return None, []
        from repro_torch.tuning.locality import locality_win, sweep_locality
        orig = self.loader.params
        cfg = self.search_config()
        try:
            trials = sweep_locality(
                self.evaluator, nworker=nworker, nprefetch=nprefetch,
                chunks=self.cfg.locality_chunks,
                current_chunk=orig.locality_chunk,
                num_batches=cfg.num_batches, epoch=cfg.epoch)
        finally:
            self.loader.with_params(orig)
        win = locality_win(trials, orig.locality_chunk,
                           min_improvement=self.cfg.min_improvement)
        return win, list(trials.values())

    def sweep_cache(self, nworker: int, nprefetch: int
                    ) -> Tuple[Optional[int], List[Trial]]:
        """Price the configured cache budgets at one cell (DESIGN.md §7).

        Same contract as :meth:`sweep_locality`, one difference: budgets
        are measured at a WARM epoch (max(1, cfg.epoch)) because a
        cross-epoch cache only pays off once it has something to serve —
        cold pricing would always pick 0.  Trials run on throwaway tiers
        (the evaluator's measurement-only override), so the live tier's
        contents are never perturbed; loader params are restored.
        """
        if not self.cfg.cache_budgets:
            return None, []
        from repro_torch.tuning.locality import cache_win, sweep_cache
        orig = self.loader.params
        cfg = self.search_config()
        try:
            trials = sweep_cache(
                self.evaluator, nworker=nworker, nprefetch=nprefetch,
                budgets=self.cfg.cache_budgets,
                current_budget=orig.cache_budget_bytes,
                num_batches=cfg.num_batches, epoch=max(1, cfg.epoch))
        finally:
            self.loader.with_params(orig)
        win = cache_win(trials, orig.cache_budget_bytes,
                        min_improvement=self.cfg.min_improvement)
        return win, list(trials.values())

    def sweep_slow_lane(self, nworker: int, nprefetch: int
                        ) -> Tuple[Optional[int], List[Trial]]:
        """Price the configured slow-lane widths at one cell (DESIGN.md
        §9).  Same contract as :meth:`sweep_locality`; candidates go
        through the measurement-only override (the live pool's lane split
        is untouched) and the live cost tracker keeps learning through
        the trial decodes, so the sweep prices routing, not a cold lane.
        """
        if not self.cfg.slow_lanes:
            return None, []
        from repro_torch.tuning.locality import slow_lane_win, sweep_slow_lanes
        orig = self.loader.params
        cfg = self.search_config()
        try:
            trials = sweep_slow_lanes(
                self.evaluator, nworker=nworker, nprefetch=nprefetch,
                lanes=self.cfg.slow_lanes,
                current_lanes=orig.slow_lane_workers,
                num_batches=cfg.num_batches, epoch=cfg.epoch)
        finally:
            self.loader.with_params(orig)
        win = slow_lane_win(trials, orig.slow_lane_workers,
                            min_improvement=self.cfg.min_improvement)
        return win, list(trials.values())

    def apply(self, result: DPTResult,
              params: Optional[LoaderParams] = None) -> LoaderParams:
        """Hot-swap the winner into the live stream and persist it.

        ``params`` is the full target (a locality-aware retune may keep
        the current cell and change only the chunk); None applies the
        result's (nworker, nprefetch) over the current params.
        """
        if params is None:
            params = self.loader.params.replace(
                num_workers=result.nworker,
                prefetch_factor=result.nprefetch)
        self.loader.apply_params(params)
        if self.cache is not None:
            # cache what was APPLIED, not the raw argmin (the policy may
            # have kept the current cell and taken only the chunk) — and
            # pair the cell with ITS OWN measured time, not the rejected
            # argmin cell's (the locality sweep measured the applied
            # combination when the cell was kept)
            opt = result.optimal_time
            applied_cell = (params.num_workers, params.prefetch_factor)
            # an exact (cell, chunk) trial exists whenever the locality
            # sweep changed the chunk (it measured every candidate at
            # the applied cell) or the policy kept the current cell
            t = next((t for t in result.trials
                      if (t.nworker, t.nprefetch) == applied_cell
                      and t.locality_chunk == params.locality_chunk
                      and math.isfinite(t.seconds)), None)
            if t is not None and (
                    applied_cell != (result.nworker, result.nprefetch)
                    or params.locality_chunk != result.locality_chunk):
                opt = t.seconds
            cached = dataclasses.replace(
                result, nworker=params.num_workers,
                nprefetch=params.prefetch_factor,
                locality_chunk=params.locality_chunk,
                cache_budget_bytes=params.cache_budget_bytes,
                slow_lane_workers=params.slow_lane_workers,
                optimal_time=opt)
            self.cache.put(self.machine_fp, self.dataset_fp,
                           self.loader.global_batch, cached)
        return params


class OnlineTuner:
    """Watches goodput and retunes a live DataLoader when it drifts.

    A thin composition of the observe/decide/act components above; the
    fleet control plane recomposes the same parts with decide living in
    the coordinator.
    """

    def __init__(self, loader: DataLoader, *,
                 config: OnlineTunerConfig = OnlineTunerConfig(),
                 evaluator=None, cache: Optional[DPTCache] = None,
                 machine_fp: Optional[str] = None,
                 dataset_fp: Optional[str] = None):
        self.loader = loader
        self.cfg = config
        if evaluator is None:
            from repro_torch.core.evaluators import LoaderEvaluator
            evaluator = LoaderEvaluator(loader, to_device=True)
        self.evaluator = evaluator
        self.monitor = GoodputMonitor(window=config.window)
        self.policy = RetunePolicy(config)
        self.executor = RetuneExecutor(loader, evaluator, config,
                                       cache=cache, machine_fp=machine_fp,
                                       dataset_fp=dataset_fp)
        self.retunes = 0
        self.history: List[Dict[str, Any]] = []

    # back-compat accessors (pre-split callers and tests use these)
    @property
    def cache(self):
        return self.executor.cache

    @property
    def machine_fp(self):
        return self.executor.machine_fp

    @property
    def dataset_fp(self):
        return self.executor.dataset_fp

    @property
    def stall_ratio(self) -> float:
        return self.monitor.stall_ratio

    @property
    def drifted(self) -> bool:
        return self.policy.drifted(self.monitor)

    # ---- the per-step goodput signal ---------------------------------------
    def observe(self, *, data_s: float, step_s: float
                ) -> Optional[LoaderParams]:
        """Feed one step's data-wait and total step wall time.

        Returns the newly applied LoaderParams when this observation
        triggered a retune + hot-swap, else None.
        """
        self.monitor.observe(data_s=data_s, step_s=step_s)
        # feed the loader-side signals once per window (io_counters takes
        # locks; no need to pay them every step)
        want_tail = self.cfg.slow_lanes and self.cfg.tail_ratio_trigger > 0.0
        want_fault = self.cfg.fault_rate_trigger > 0.0
        if (want_tail or want_fault) \
                and self.monitor.steps % self.cfg.window == 0:
            io = self.loader.io_counters()
            if want_tail and io and "sample_cost_tail_ratio" in io:
                self.monitor.note_tail(io["sample_cost_tail_ratio"])
            if want_fault:
                # absent keys mean a quiet fault plane — feed zeros so a
                # healed loader's monitor sees the edge
                self.monitor.note_faults(
                    (io or {}).get("fault_rate", 0.0),
                    bool((io or {}).get("degraded", 0.0)))
        if not self.policy.should_retune(self.monitor):
            return None
        if self.monitor.stall_ratio > self.cfg.stall_fraction:
            reason = "goodput-drift"
        elif want_fault and self.monitor.fault_healed:
            reason = "fault-heal"
        elif want_fault and self.monitor.fault_rate \
                > self.cfg.fault_rate_trigger:
            reason = "fault-drift"
        else:
            reason = "cost-tail-drift"
        return self.force_retune(reason=reason)

    # ---- bounded re-search + hot swap --------------------------------------
    def force_retune(self, *, reason: str = "forced"
                     ) -> Optional[LoaderParams]:
        """Run the bounded re-search now and hot-swap the winner in.

        Also the entry point for external drift signals (e.g. the serving
        frontend's batch-mix monitor).
        """
        orig = self.loader.params
        t0 = time.perf_counter()
        result = self.executor.search()
        self.policy.note_searched(self.monitor.steps)
        self.monitor.reset()
        if result is None or not math.isfinite(result.optimal_time):
            self.policy.record_outcome(won=False)
            return None
        won = self.policy.is_win(result, orig)
        # the online locality axis (DESIGN.md §6): price chunk candidates
        # at the cell the fleet will actually run — the search winner if
        # it won, else the current cell — and let a significant chunk win
        # ride the same hot swap (epoch-latched by the sampler)
        cell = (result.nworker, result.nprefetch) if won \
            else (orig.num_workers, orig.prefetch_factor)
        chunk_win, chunk_trials = self.executor.sweep_locality(*cell)
        result.trials.extend(chunk_trials)
        # the online cache axis (DESIGN.md §7): price budget candidates at
        # the same cell — a winner resizes the live tier in place via the
        # same hot swap (the tier survives apply_params)
        budget_win, budget_trials = self.executor.sweep_cache(*cell)
        result.trials.extend(budget_trials)
        # the online dual-lane axis (DESIGN.md §9): price lane widths at
        # the same cell — a winner re-splits the pool via the same hot
        # swap (the cost tracker is loader-owned and survives the swap)
        lane_win, lane_trials = self.executor.sweep_slow_lane(*cell)
        result.trials.extend(lane_trials)
        self.policy.record_outcome(won=won or chunk_win is not None
                                   or budget_win is not None
                                   or lane_win is not None)
        if not won and chunk_win is None and budget_win is None \
                and lane_win is None:
            self.history.append({
                "step": self.monitor.steps, "reason": reason,
                "outcome": "kept",
                "params": (orig.num_workers, orig.prefetch_factor),
                "locality_chunk": orig.locality_chunk,
                "cache_budget_bytes": orig.cache_budget_bytes,
                "slow_lane_workers": orig.slow_lane_workers,
                "optimal_time": result.optimal_time,
                "measurements": len(result.trials),
                "search_s": time.perf_counter() - t0,
            })
            return None
        params = orig if not won else orig.replace(
            num_workers=result.nworker, prefetch_factor=result.nprefetch)
        if chunk_win is not None:
            params = params.replace(locality_chunk=chunk_win)
        if budget_win is not None:
            params = params.replace(cache_budget_bytes=budget_win)
        if lane_win is not None:
            params = params.replace(slow_lane_workers=lane_win)
        params = self.executor.apply(result, params)
        self.retunes += 1
        self.history.append({
            "step": self.monitor.steps, "reason": reason,
            "outcome": "applied",
            "params": (params.num_workers, params.prefetch_factor),
            "locality_chunk": params.locality_chunk,
            "cache_budget_bytes": params.cache_budget_bytes,
            "slow_lane_workers": params.slow_lane_workers,
            "optimal_time": result.optimal_time,
            "measurements": len(result.trials),
            "search_s": time.perf_counter() - t0,
        })
        return params
