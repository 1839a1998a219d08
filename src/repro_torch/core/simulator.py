"""Virtual-time loader simulator.

This container has ONE physical core, so multi-core worker-scaling curves
cannot be measured in wall clock.  The paper-table benchmarks therefore run
DPT against this discrete(-ish) event model, which captures every mechanism
the paper attributes its results to:

* worker parallelism with CPU contention: decode throughput scales with
  min(nWorker, available_logical_cores); the paper's "optimal = 10 of 12
  logical cores because main + loader processes occupy two" is the
  ``reserved_cores`` term;
* shared storage bandwidth with per-stream limits and congestion beyond
  ``io_streams`` concurrent readers (why large-item / cold-epoch optima sit
  at moderate worker counts);
* an OS page cache: epoch >= 2 reads hit RAM for the cached fraction; the
  cache competes with loader memory (worker overhead + prefetch buffers),
  which is why second-epoch optima drop for datasets larger than RAM;
* prefetch-factor pipelining: overlap of a worker's IO and CPU phases
  improves sharply from j=1 and saturates, with a small deterministic
  jitter making the exact optimum unpredictable (paper Fig. 2b);
* memory overflow: footprint beyond host RAM raises the same
  ``MemoryOverflow`` the real loader raises (paper's N/A cells).

The SAME DPT code drives this simulator and the real wall-clock loader
(see core/evaluators.py); only the objective callback differs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

from repro_torch.core.monitor import MemoryOverflow, estimate_loader_footprint
from repro_torch.data.storage import StorageProfile


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Host resources (the paper's testbed by default: i7-8700K, 64 GB)."""
    physical_cores: int = 6
    logical_cores: int = 12
    reserved_cores: int = 2          # main process + loader main process
    num_devices: int = 1             # G in Algorithm 1
    host_ram: float = 64e9
    os_reserved: float = 4e9
    io_streams: int = 6              # concurrent reads before bw congestion
    worker_overhead_bytes: float = 1.2e9   # per-worker process footprint
    hyperthread_eff: float = 0.5     # logical cores beyond physical scale
    amdahl_serial: float = 0.06      # serial fraction of decode parallelism
    thrash_exp: float = 1.35         # oversubscription (ctx-switch) penalty
    io_congestion: float = 0.08      # bw loss per reader beyond io_streams
    device_bw: float = 12e9          # host->device interconnect
    # fraction of the free-RAM page cache that actually serves warm-epoch
    # reads (1.0 = the neutral legacy model: every free byte caches
    # perfectly).  Real hosts evict under competing pressure; a value < 1
    # is what makes an EXPLICITLY pinned cache tier (cache_budget_bytes)
    # worth its footprint on the warm-epoch grid (DESIGN.md §7).
    page_cache_eff: float = 1.0

    @property
    def effective_cores(self) -> float:
        phys = self.physical_cores
        extra = max(0, self.logical_cores - phys)
        return phys + self.hyperthread_eff * extra

    def _over_penalty(self, k: int) -> float:
        """Context-switch thrash once (workers + reserved) exceed logical
        cores — the paper's 'optimal = logical cores - 2' observation."""
        over = (k + self.reserved_cores) / self.logical_cores
        return 1.0 if over <= 1.0 else over ** self.thrash_exp

    def cpu_speedup(self, k: int) -> float:
        """Parallel decode speedup of k workers: Amdahl-damped linear gain,
        thrash-penalized beyond the free logical cores."""
        k = max(1, k)
        amdahl = k / (1.0 + self.amdahl_serial * (k - 1))
        return amdahl / self._over_penalty(k)

    def io_worker_eff(self, k: int) -> float:
        """Effective concurrent IO requesters (same thrash shape: an
        oversubscribed host also issues requests late)."""
        return max(1, k) / self._over_penalty(k)


@dataclasses.dataclass(frozen=True)
class SimResult:
    seconds: float
    peak_bytes: float
    warm_fraction: float
    io_seconds: float
    cpu_seconds: float
    overflowed: bool = False


def _jitter(*keys, amp: float = 0.03) -> float:
    """Deterministic pseudo-noise in [1-amp, 1+amp]."""
    blob = "|".join(str(k) for k in keys).encode()
    h = int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")
    return 1.0 + amp * (2.0 * (h / 2**64) - 1.0)


class LoaderSimulator:
    def __init__(self, storage: StorageProfile, machine: MachineProfile,
                 *, model_host_bytes: float = 2e9):
        self.sp = storage
        self.mp = machine
        self.model_host_bytes = model_host_bytes

    # ---- memory model -------------------------------------------------------
    def batch_bytes(self, batch_size: int) -> float:
        return batch_size * self.sp.decoded

    def footprint(self, batch_size: int, nworker: int, nprefetch: int,
                  device_prefetch: int = 2) -> float:
        base = estimate_loader_footprint(
            self.batch_bytes(batch_size), nworker, nprefetch, device_prefetch)
        return base + max(1, nworker) * self.mp.worker_overhead_bytes

    def device_bytes(self, batch_size: int, device_prefetch: int = 2) -> float:
        return (1 + device_prefetch) * self.batch_bytes(batch_size)

    # ---- timing model -------------------------------------------------------
    def simulate(self, *, batch_size: int, num_batches: int, nworker: int,
                 nprefetch: int, epoch: int = 0, device_prefetch: int = 2,
                 device_ram: Optional[float] = None,
                 check_overflow: bool = True,
                 locality_chunk: int = 0, host_count: int = 1,
                 layout: str = "host_major",
                 cache_budget_bytes: float = 0.0,
                 slow_lane_workers: int = 0) -> SimResult:
        sp, mp = self.sp, self.mp
        K = max(1, nworker)
        j = max(1, nprefetch)
        budget = max(0.0, float(cache_budget_bytes))
        k_lane = max(0, slow_lane_workers)
        # heavy-tailed per-item cost (DESIGN.md §9): tail_fraction of items
        # cost tail_mult x.  Neutral defaults (0 / 1) change nothing below.
        heavy = sp.tail_fraction > 0.0 and sp.tail_mult > 1.0

        foot = self.footprint(batch_size, nworker, nprefetch, device_prefetch)
        foot += budget                 # the pinned tier is loader memory
        foot += k_lane * mp.worker_overhead_bytes   # lane workers are real
        avail_ram = mp.host_ram - mp.os_reserved - self.model_host_bytes
        if check_overflow and foot > avail_ram:
            raise MemoryOverflow(
                f"simulated loader footprint {foot/1e9:.1f}GB > "
                f"available {avail_ram/1e9:.1f}GB")
        if check_overflow and device_ram is not None:
            if self.device_bytes(batch_size, device_prefetch) > device_ram:
                raise MemoryOverflow("simulated device memory overflow")

        # page cache: what's left after the loader's own memory (which now
        # includes the pinned cache tier).  The tier serves its hot set
        # with certainty on epochs >= 1; the page cache serves a
        # page_cache_eff fraction of what fits in the REMAINING free RAM —
        # the two are disjoint (hit-ratio x latency-delta pricing of the
        # cache axis: warm-fraction gain vs the footprint it pins).
        cache_cap = max(0.0, avail_ram - foot)
        if epoch == 0:
            warm = 0.0
        else:
            tier_warm = min(1.0, budget / sp.dataset_bytes)
            warm = min(1.0, tier_warm + mp.page_cache_eff
                       * cache_cap / sp.dataset_bytes)

        items = num_batches * batch_size

        # --- IO stage throughput (items/s) ---
        # Seek-queueing latency grows with concurrent readers (fitted from
        # paper Table 1b, see StorageProfile); aggregate bandwidth congests
        # beyond io_streams readers; the bw ceiling always applies.  Batched
        # reads coalesce contiguous items into runs (StorageProfile
        # .coalesced_run_len, 1.0 = legacy per-item requests), amortizing
        # the base latency over the run — bandwidth is charged in full.
        # Chunked sampling (locality_chunk > 1, DESIGN.md §5): a batch's
        # sorted misses coalesce into runs of about min(chunk, batch) items
        # — the measured effect of ShardedSampler's chunked orders, priced
        # here so DPT grids resolve the locality axis in virtual time.
        # 0/1 leaves the profile's own run length (neutral default).
        # ``batch_size`` is this HOST's batch: under the host-major shard
        # layout (DESIGN.md §6) per-host runs stay ~min(chunk, batch) at
        # any host count.  The legacy strided layout gets NO chunking
        # benefit at H > 1: every H-th element of a within-chunk-shuffled
        # run is a near-random value, so strict-contiguity coalescing
        # (coalesce_runs / achieved_run_len) collapses to ~1 — measured
        # 1.2-1.7 at C=16, H in {2,4}, which the profile's own run
        # length already bounds.
        run = max(1.0, sp.coalesced_run_len)
        if locality_chunk and locality_chunk > 1:
            if layout != "strided" or max(1, host_count) == 1:
                run = max(run, float(min(locality_chunk, batch_size)))
        lat_k = sp.io_latency_s * (1.0 + sp.seek_congestion * K)
        agg_bw = sp.storage_bw / (1.0 + mp.io_congestion
                                  * max(0, K - mp.io_streams))
        per_request = lat_k / run + sp.item_bytes * K / agg_bw
        rate_cold = min(mp.io_worker_eff(K) / per_request,
                        agg_bw / sp.item_bytes)
        rate_warm = sp.ram_bw / sp.item_bytes
        rate_io = 1.0 / ((1.0 - warm) / rate_cold + warm / rate_warm)

        # --- CPU stage throughput (items/s) ---
        # The vectorized batch transform amortizes the per-item fixed decode
        # cost (StorageProfile.vectorized_decode_fixed_s; None = per-sample)
        cpu_item_s = (sp.effective_decode_fixed_s
                      + sp.decode_cpu_s_per_byte * sp.decoded)
        base_cpu_item_s = cpu_item_s
        if heavy:
            # tail items inflate the MEAN decode cost regardless of lanes:
            # the work still has to happen somewhere.
            cpu_item_s *= 1.0 + sp.tail_fraction * (sp.tail_mult - 1.0)
        rate_cpu = mp.cpu_speedup(K) / cpu_item_s
        if k_lane:
            # lane workers contend for the same cores as the fast lane
            rate_cpu *= mp._over_penalty(K) / mp._over_penalty(K + k_lane)

        # --- pipeline composition: prefetch_factor controls IO/CPU overlap
        # within each worker (j=1: serialized; j>=2: stages overlap, gains
        # saturating) ---
        t_io = 1.0 / rate_io
        t_cpu = 1.0 / rate_cpu
        overlap = 1.0 - 1.0 / (1.0 + 1.2 * (j - 0.5))
        per_item = max(t_io, t_cpu) + (1.0 - overlap) * min(t_io, t_cpu)
        per_item *= _jitter("cell", K, j, sp.item_bytes, batch_size)
        if k_lane:
            # dispatch-side overhead of classification + lane bookkeeping;
            # keeps the grid honest on uniform profiles (k=0 must win there)
            per_item *= (1.0 + 0.02 * k_lane) * _jitter("lane", K, j, k_lane)

        # --- makespan + pipeline fill (first batch must fully arrive) ---
        fill_item = per_request if (epoch == 0 or warm < 1.0) else cpu_item_s
        total = items * per_item + batch_size * fill_item / max(1, min(K, j + 1))

        # --- ordered-pipe straggler stalls (DESIGN.md §9) ---
        # A batch containing a tail item takes excess_s longer than its
        # neighbours.  With ordered delivery the reorder window can absorb
        # (window x t_batch) of that before the whole pipe stalls; a slow
        # lane both widens the window and starts predicted-slow batches
        # ``lookahead`` batches ahead of schedule, so each lane worker
        # hides another LOOK x t_batch of excess.
        if heavy:
            t_batch = batch_size * per_item
            excess_s = (sp.tail_mult - 1.0) * base_cpu_item_s \
                / mp.cpu_speedup(K) * K   # one straggler decodes serially
            p_slow = 1.0 - (1.0 - sp.tail_fraction) ** batch_size
            look = 8          # LoaderParams.slow_lane_lookahead default
            absorb = (K * j + K + k_lane + look * k_lane) * t_batch
            stall = max(0.0, excess_s - absorb)
            total += num_batches * p_slow * stall

        # --- host->device transfer; hidden when device_prefetch >= 2 ---
        xfer = num_batches * self.batch_bytes(batch_size) / mp.device_bw
        hidden = min(1.0, 0.55 * device_prefetch)
        total += xfer * (1.0 - hidden)

        return SimResult(seconds=total, peak_bytes=foot, warm_fraction=warm,
                         io_seconds=items * t_io, cpu_seconds=items * t_cpu)
