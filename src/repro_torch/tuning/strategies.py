"""The built-in tuning strategies, ported onto the TuningStrategy protocol.

* ``grid``                 — the paper's Algorithm 1, kept faithful (worker
  rungs of G up to N, prefetch 1..P, overflow breaks the inner loop), with
  the final worker rung clamped to N when N is not divisible by G.
* ``successive_halving``   — Hyperband-style rung schedule: measure every
  cell with a tiny batch budget, keep the best 1/eta, grow the budget.
* ``hillclimb``            — coordinate descent (±G workers, ±1 prefetch)
  from a caller-supplied start cell.
* ``warmstart_hillclimb``  — seed the hillclimb with the simulator cost
  model's analytic optimum (zero measurements), then refine for real.
* ``goodput``              — smallest (nWorker, nPrefetch) whose transfer
  time merely outpaces the model step; frees cores where the model, not
  the loader, is the bottleneck.

All of these used to live as separately-shaped functions in ``core/dpt.py``
and ``core/search.py``; those modules now delegate here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.dpt import DPTConfig, DPTResult, default_params
from repro_torch.core.monitor import MemoryOverflow
from repro_torch.core.simulator import LoaderSimulator, MachineProfile
from repro_torch.data.storage import StorageProfile
from repro_torch.tuning.base import TrialRecorder, register_strategy, worker_rungs


@register_strategy("grid")
class GridSearch:
    """Paper Algorithm 1.

    Line mapping: the outer ``for i in worker_rungs`` is lines 4-5 (with
    the overshoot fix: the last rung is clamped to N), the inner prefetch
    sweep is lines 6-7, overflow-breaks are lines 9-10, the running argmin
    is lines 14-17.  The optional default-parameter reference run
    reproduces the paper's comparison against PyTorch defaults and is not
    recorded as a sweep trial.

    Beyond paper: when ``config.locality_chunks`` is set, the same sweep
    repeats per candidate sampler chunk size — a third, outermost axis
    (DESIGN.md §5).  ``config.cache_budgets`` adds the fourth axis the
    same way (DESIGN.md §7), ``config.slow_lanes`` a fifth (DESIGN.md §9)
    and ``config.geometries`` (candidate global batches, DESIGN.md §11) a
    sixth, outermost of all.  Left unset (the default), the loop is
    exactly Algorithm 1 and the evaluator never sees a locality, cache,
    slow-lane or geometry kwarg.
    """

    def tune(self, rec: TrialRecorder, *,
             measure_default: bool = True) -> DPTResult:
        cfg = rec.config
        N, G = cfg.resolve()
        chunks = cfg.locality_chunks if cfg.locality_chunks else (None,)
        budgets = cfg.cache_budgets if cfg.cache_budgets else (None,)
        lanes = cfg.slow_lanes if cfg.slow_lanes else (None,)
        geoms = cfg.geometries if cfg.geometries else (None,)
        n_worker, n_prefetch = 0, 0
        n_chunk, n_budget, n_lane, n_geom = 0, 0, 0, 0
        optimal_time = math.inf
        for g in geoms:                            # beyond-paper axis 6
            for s in lanes:                        # beyond-paper axis 5
                for b in budgets:                  # beyond-paper axis 4
                    for c in chunks:               # beyond-paper axis 3
                        for i in worker_rungs(N, G):       # lines 4-5
                            j = cfg.min_prefetch           # line 6
                            while j <= cfg.max_prefetch:   # line 7
                                t = rec.seconds(i, j,      # lines 8, 12
                                                locality_chunk=c,
                                                cache_budget_bytes=b,
                                                slow_lane_workers=s,
                                                global_batch=g)
                                if not math.isfinite(t):   # lines 9-10
                                    break
                                if t < optimal_time:       # lines 14-17
                                    optimal_time = t
                                    n_worker, n_prefetch = i, j
                                    n_chunk = c or 0
                                    n_budget = b or 0
                                    n_lane = s or 0
                                    n_geom = g or 0
                                j += 1                     # line 19
        default_time = None
        if measure_default:
            dw, dp = default_params(N)
            default_time = rec.seconds(dw, dp, record=False)
        return rec.result(n_worker, n_prefetch, optimal_time,
                          default_time=default_time,
                          locality_chunk=n_chunk,
                          cache_budget_bytes=n_budget,
                          slow_lane_workers=n_lane,
                          global_batch=n_geom)


@register_strategy("successive_halving")
class SuccessiveHalving:
    """Measure all cells cheaply, keep the best 1/eta, multiply the budget."""

    def tune(self, rec: TrialRecorder, *, eta: int = 3,
             min_batches: int = 4) -> DPTResult:
        cfg = rec.config
        N, G = cfg.resolve()
        cells: List[Tuple[int, int]] = [
            (i, j) for i in worker_rungs(N, G)
            for j in range(cfg.min_prefetch, cfg.max_prefetch + 1)]
        budget = min_batches
        while True:
            scores = {c: rec.seconds(c[0], c[1], num_batches=budget)
                      for c in cells}
            alive = [c for c in cells if math.isfinite(scores[c])]
            if not alive:
                raise MemoryOverflow("all cells overflow")
            alive.sort(key=lambda c: scores[c])
            if len(alive) <= 2 or budget >= cfg.num_batches:
                best = alive[0]
                return rec.result(best[0], best[1], scores[best])
            cells = alive[:max(2, len(alive) // eta)]
            budget = min(budget * eta, cfg.num_batches)


@register_strategy("hillclimb")
class HillClimb:
    """Coordinate descent on the (worker, prefetch) grid from ``start``."""

    def tune(self, rec: TrialRecorder, *, start: Tuple[int, int],
             max_steps: int = 24) -> DPTResult:
        cfg = rec.config
        N, G = cfg.resolve()
        lo_j, hi_j = cfg.min_prefetch, cfg.max_prefetch

        def clamp(i, j):
            # snap onto Algorithm 1's rung set {G, 2G, ..., N}: N itself is
            # a rung even when not a multiple of G (the clamped final rung)
            if i >= N:
                i = N
            else:
                i = max(G, (i // G) * G if i % G else i)
            return i, max(lo_j, min(hi_j, j))

        seen: Dict[Tuple[int, int], float] = {}

        def score(cell):
            if cell not in seen:
                seen[cell] = rec.seconds(cell[0], cell[1])
            return seen[cell]

        cur = clamp(*start)
        best_t = score(cur)
        if not math.isfinite(best_t):
            # Infeasible start (e.g. the host lost RAM mid-run and the
            # stale optimum now overflows): walk down the worker axis —
            # the dominant footprint term — then down prefetch, until a
            # feasible cell is found, and refine from there.
            i, j = cur
            escape = [clamp(k, j) for k in range(i - G, 0, -G)]
            escape += [clamp(G, q) for q in range(j - 1, lo_j - 1, -1)]
            for cell in escape:
                if math.isfinite(score(cell)):
                    cur, best_t = cell, score(cell)
                    break
        for _ in range(max_steps):
            i, j = cur
            neighbors = [clamp(i + G, j), clamp(i - G, j),
                         clamp(i, j + 1), clamp(i, j - 1)]
            cand = min(neighbors, key=score)
            if score(cand) + 1e-12 < best_t:
                cur, best_t = cand, score(cand)
            else:
                break
        if not math.isfinite(best_t):
            raise MemoryOverflow("hillclimb found no feasible cell")
        return rec.result(cur[0], cur[1], best_t)


@dataclasses.dataclass
class CostModelPrediction:
    nworker: int
    nprefetch: int
    predicted_seconds: float


def cost_model_warmstart(storage: StorageProfile, machine: MachineProfile,
                         *, batch_size: int, config: DPTConfig = DPTConfig(),
                         ) -> CostModelPrediction:
    """Zero-measurement analytic optimum from the simulator's own cost model
    (the napkin math, mechanized).  Used to seed the hillclimb on a new
    machine/dataset pair before any wall-clock run."""
    sim = LoaderSimulator(storage, machine)
    N, G = config.resolve()
    best = None
    for i in worker_rungs(N, G):
        for j in range(config.min_prefetch, config.max_prefetch + 1):
            try:
                r = sim.simulate(batch_size=batch_size, num_batches=32,
                                 nworker=i, nprefetch=j, epoch=config.epoch)
            except MemoryOverflow:
                break
            if best is None or r.seconds < best[2]:
                best = (i, j, r.seconds)
    if best is None:
        raise MemoryOverflow("cost model: every cell overflows")
    return CostModelPrediction(*best)


@register_strategy("warmstart_hillclimb")
class WarmstartHillClimb:
    """Cost-model warmstart (free) + measured hillclimb (cheap)."""

    def tune(self, rec: TrialRecorder, *, storage: StorageProfile,
             machine: MachineProfile, batch_size: int,
             max_steps: int = 24) -> DPTResult:
        pred = cost_model_warmstart(storage, machine, batch_size=batch_size,
                                    config=rec.config)
        return HillClimb().tune(rec, start=(pred.nworker, pred.nprefetch),
                                max_steps=max_steps)


@register_strategy("goodput")
class GoodputTune:
    """Minimal-resource tuning: the loader only needs to outpace the model.

    Finds the smallest (nworker, nprefetch) whose transfer time for
    ``num_batches`` is <= step_time * (1 - margin) * num_batches; falls
    back to the global optimum if no cell meets the target.
    """

    def tune(self, rec: TrialRecorder, *, step_time_s: float,
             num_batches: int, margin: float = 0.1) -> DPTResult:
        cfg = rec.config
        N, G = cfg.resolve()
        target = step_time_s * (1.0 - margin) * num_batches
        best_any: Optional[Tuple[int, int, float]] = None
        for i in worker_rungs(N, G):
            for j in range(cfg.min_prefetch, cfg.max_prefetch + 1):
                t = rec.seconds(i, j, num_batches=num_batches)
                if not math.isfinite(t):
                    break
                if best_any is None or t < best_any[2]:
                    best_any = (i, j, t)
                if t <= target:
                    return rec.result(i, j, t)
        if best_any is None:
            raise MemoryOverflow("goodput: every cell overflows")
        return rec.result(*best_any)
