"""Dataloader Parameter Tuner (DPT) — the paper's Algorithm 1, faithfully,
as ported to PyTorch.

Faithful part (``DPT.run``):
    nWorker starts at G (accelerator count) and increases by G up to N
    (CPU cores, final rung clamped to N); for each, nPrefetch sweeps 1..P;
    each cell measures the dataloader transfer time; memory overflow breaks
    the inner loop and moves to the next worker count; the argmin is
    returned.

The tuner is decoupled from *how* a cell is measured: an ``Evaluator``
returns ``TransferStats`` (real wall-clock loader, or the virtual-time
simulator — see core/evaluators.py).  That is what lets the same algorithm
drive unit tests, paper-table benchmarks and the multi-host simulation.

The search loop itself now lives in the unified strategy layer
(``repro_torch.tuning``): ``DPT.run`` delegates to the registered ``"grid"``
strategy, and this module keeps the shared dataclasses (DPTConfig,
Trial, DPTResult) plus the fleet tuner built on top.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.monitor import MemoryOverflow
from repro_torch.data.loader import TransferStats

Evaluator = Callable[..., TransferStats]  # (nworker, nprefetch, **kw)


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    num_cpu_cores: Optional[int] = None      # N  (default: os.cpu_count())
    num_devices: Optional[int] = None        # G  (default: local devices)
    max_prefetch: int = 8                    # P
    min_prefetch: int = 1
    num_batches: int = 32                    # measurement budget per cell
    epoch: int = 0                           # 0 = cold (1st), >=1 = warm
    # beyond-paper third grid axis (DESIGN.md §5): candidate sampler
    # locality_chunk values (0 = fully random).  None keeps the search on
    # the paper's (nWorker, nPrefetch) plane and never passes the kwarg to
    # the evaluator — existing two-argument evaluators are untouched.
    locality_chunks: Optional[Tuple[int, ...]] = None
    # beyond-paper fourth grid axis (DESIGN.md §7): candidate cross-epoch
    # cache budgets in bytes (0 = cache off).  Same contract: None keeps
    # the kwarg away from the evaluator entirely.
    cache_budgets: Optional[Tuple[int, ...]] = None
    # beyond-paper fifth grid axis (DESIGN.md §9): candidate slow-lane
    # worker counts (0 = dual-lane off).  Same contract: None keeps the
    # kwarg away from the evaluator entirely.
    slow_lanes: Optional[Tuple[int, ...]] = None
    # beyond-paper sixth grid axis (DESIGN.md §11): candidate GLOBAL batch
    # geometries (0 = keep the loader's current global batch).  Outermost
    # of all — geometry changes re-shape every inner measurement.  Same
    # contract: None never passes the kwarg to the evaluator.
    geometries: Optional[Tuple[int, ...]] = None

    def resolve(self) -> Tuple[int, int]:
        n = self.num_cpu_cores
        if n is None:
            n = os.cpu_count() or 1
        g = self.num_devices
        if g is None:
            import torch
            g = torch.cuda.device_count()
        return n, max(1, g)


@dataclasses.dataclass
class Trial:
    nworker: int
    nprefetch: int
    seconds: float
    overflowed: bool = False
    peak_bytes: float = 0.0
    # per-batch samples when the evaluator measured wall clock (None for
    # aggregate-only evaluators like the simulator)
    batch_seconds: Optional[List[float]] = None
    # sampler locality the cell was measured with (0 = random order / the
    # locality axis was not searched)
    locality_chunk: int = 0
    # cross-epoch cache budget the cell was measured with (0 = cache off /
    # the cache axis was not searched)
    cache_budget_bytes: int = 0
    # slow-lane workers the cell was measured with (0 = dual-lane off /
    # the lane axis was not searched)
    slow_lane_workers: int = 0
    # global batch the cell was measured with (0 = the loader's own / the
    # geometry axis was not searched)
    global_batch: int = 0


@dataclasses.dataclass
class DPTResult:
    nworker: int
    nprefetch: int
    optimal_time: float
    trials: List[Trial]
    default_time: Optional[float] = None
    locality_chunk: int = 0
    cache_budget_bytes: int = 0
    slow_lane_workers: int = 0
    global_batch: int = 0

    @property
    def speedup_vs_default(self) -> Optional[float]:
        if self.default_time is None or self.optimal_time == 0:
            return None
        return self.default_time / self.optimal_time

    @property
    def time_reduction_pct(self) -> Optional[float]:
        """Percent of the default-parameter time saved by the optimum
        (positive = improvement)."""
        if self.default_time is None or self.default_time == 0:
            return None
        return 100.0 * (self.default_time - self.optimal_time) / self.default_time


def default_params(num_cpu_cores: Optional[int] = None) -> Tuple[int, int]:
    """PyTorch's defaults the paper compares against: workers = cores/2,
    prefetch_factor = 2."""
    n = num_cpu_cores if num_cpu_cores is not None else (os.cpu_count() or 1)
    return max(1, n // 2), 2


class DPT:
    def __init__(self, evaluator: Evaluator,
                 config: DPTConfig = DPTConfig()):
        self.evaluator = evaluator
        self.config = config

    def _measure(self, i: int, j: int) -> TransferStats:
        return self.evaluator(i, j, num_batches=self.config.num_batches,
                              epoch=self.config.epoch)

    def run(self, *, measure_default: bool = True) -> DPTResult:
        """Algorithm 1 (served by the unified ``"grid"`` strategy; see
        ``repro_torch.tuning.strategies.GridSearch`` for the line mapping)."""
        from repro_torch.tuning import tune
        return tune(evaluator=self.evaluator, strategy="grid",
                    config=self.config, measure_default=measure_default)

    # ---- full grid (figures 2-4) --------------------------------------------
    def grid(self, workers: Sequence[int],
             prefetches: Sequence[int]) -> Dict[Tuple[int, int], float]:
        out: Dict[Tuple[int, int], float] = {}
        for i in workers:
            for j in prefetches:
                try:
                    out[(i, j)] = self._measure(i, j).seconds
                except MemoryOverflow:
                    out[(i, j)] = math.inf
        return out


# --------------------------------------------------------------------------
# multi-host fleet tuning (beyond paper; DESIGN.md §2 "Multi-pod semantics")
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FleetResult:
    mode: str                             # "uniform" | "per_host"
    per_host: List[DPTResult]
    fleet_params: List[Tuple[int, int]]   # chosen (nworker, nprefetch)/host
    fleet_time: float                     # max over hosts (lockstep step time)
    uniform_params: Optional[Tuple[int, int]] = None


class MultiHostDPT:
    """Tunes a fleet where hosts may be heterogeneous (stragglers).

    The fleet steps in lockstep, so the effective transfer time is the MAX
    over hosts.  Two modes:

    * ``per_host``: each host tunes independently (optimal when per-host
      configs are allowed — independent minimization minimizes the max);
    * ``uniform``: one (nWorker, nPrefetch) for every host (common fleet
      constraint) chosen to minimize the max over hosts — a straggler-aware
      consensus the single-machine paper has no analogue of.
    """

    def __init__(self, evaluators: Sequence[Evaluator],
                 config: DPTConfig = DPTConfig()):
        self.evaluators = list(evaluators)
        self.config = config

    def run_per_host(self) -> FleetResult:
        results = [DPT(ev, self.config).run(measure_default=False)
                   for ev in self.evaluators]
        params = [(r.nworker, r.nprefetch) for r in results]
        fleet_time = max(r.optimal_time for r in results)
        return FleetResult("per_host", results, params, fleet_time)

    def run_uniform(self) -> FleetResult:
        """Per-host sweeps + straggler-aware consensus.  The consensus math
        lives in the fleet control plane (``repro_torch.tuning.fleet``),
        which the FleetCoordinator also uses for online re-consensus."""
        from repro_torch.tuning.fleet import uniform_consensus
        results = [DPT(ev, self.config).run(measure_default=False)
                   for ev in self.evaluators]
        best, fleet_time = uniform_consensus(results)
        return FleetResult("uniform", results, [best] * len(results),
                           fleet_time, uniform_params=best)
