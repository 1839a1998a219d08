"""Evaluators: the measurement side of DPT's hypothesis loop.

Both expose ``(nworker, nprefetch, *, num_batches, epoch) -> TransferStats``
so Algorithm 1, the beyond-paper search strategies and the fleet tuner are
indifferent to whether a cell is a real wall-clock run or a virtual-time
simulation.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.monitor import MemoryOverflow
from repro_torch.core.simulator import LoaderSimulator
from repro_torch.data.loader import DataLoader, LoaderParams, TransferStats


class LoaderEvaluator:
    """Measures the real loader (threads, queues, device copies) in wall clock."""

    def __init__(self, loader: DataLoader, *, to_device: bool = True,
                 device_prefetch: int = 2):
        self.loader = loader
        self.to_device = to_device
        self.device_prefetch = device_prefetch
        self.calls = 0

    def __call__(self, nworker: int, nprefetch: int, *, num_batches: int = 16,
                 epoch: int = 0,
                 locality_chunk: Optional[int] = None,
                 cache_budget_bytes: Optional[int] = None,
                 slow_lane_workers: Optional[int] = None,
                 global_batch: Optional[int] = None) -> TransferStats:
        self.calls += 1
        # replace() keeps the loader's delivery knobs (fast_path, zero_copy,
        # ordered, use_processes, ...) so trials measure the same machinery
        # the live stream runs.  The locality, cache, slow-lane and
        # geometry axes are passed as measurement-only overrides —
        # candidate chunk sizes / budgets / lane widths / global batches
        # must not touch the shared sampler's live schedule, the live
        # tier, or the live pool's lane split.
        self.loader.with_params(self.loader.params.replace(
            num_workers=nworker, prefetch_factor=nprefetch,
            device_prefetch=self.device_prefetch))
        kw = {} if cache_budget_bytes is None \
            else {"cache_budget_bytes": cache_budget_bytes}
        if slow_lane_workers is not None:
            kw["slow_lane_workers"] = slow_lane_workers
        if global_batch is not None:
            kw["global_batch"] = global_batch
        return self.loader.measure_transfer_time(
            num_batches, epoch=epoch, to_device=self.to_device,
            locality_chunk=locality_chunk, **kw)


class SimulatorEvaluator:
    """Queries the virtual-time model (paper-table benchmarks, fleet sim)."""

    def __init__(self, sim: LoaderSimulator, *, batch_size: int,
                 device_prefetch: int = 2, device_ram: Optional[float] = None,
                 num_batches_cap: Optional[int] = None, host_count: int = 1):
        self.sim = sim
        self.batch_size = batch_size
        self.device_prefetch = device_prefetch
        self.device_ram = device_ram
        self.num_batches_cap = num_batches_cap
        # geometry-axis pricing: a candidate GLOBAL batch divides over
        # this many lockstep hosts before it hits one host's loader
        self.host_count = max(1, host_count)
        self.calls = 0

    def __call__(self, nworker: int, nprefetch: int, *, num_batches: int = 16,
                 epoch: int = 0,
                 locality_chunk: Optional[int] = None,
                 cache_budget_bytes: Optional[int] = None,
                 slow_lane_workers: Optional[int] = None,
                 global_batch: Optional[int] = None) -> TransferStats:
        self.calls += 1
        if self.num_batches_cap is not None:
            num_batches = min(num_batches, self.num_batches_cap)
        local = self.batch_size if not global_batch \
            else max(1, int(round(global_batch / self.host_count)))
        r = self.sim.simulate(
            batch_size=local, num_batches=num_batches,
            nworker=nworker, nprefetch=nprefetch, epoch=epoch,
            device_prefetch=self.device_prefetch, device_ram=self.device_ram,
            locality_chunk=locality_chunk or 0,
            cache_budget_bytes=cache_budget_bytes or 0,
            slow_lane_workers=slow_lane_workers or 0)
        return TransferStats(r.seconds, num_batches,
                             int(num_batches * self.sim.batch_bytes(local)),
                             peak_loader_bytes=int(r.peak_bytes))

    def epoch_seconds(self, nworker: int, nprefetch: int, *,
                      epoch: int = 0) -> float:
        """Full-epoch transfer time (paper Table 1b reports whole epochs)."""
        n = self.sim.sp.num_items // self.batch_size
        try:
            return self(nworker, nprefetch, num_batches=n,
                        epoch=epoch).seconds
        except MemoryOverflow:
            return math.inf
