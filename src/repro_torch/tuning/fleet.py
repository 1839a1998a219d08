"""Fleet control plane: coordinated per-host online tuning + elastic
resharding of the live data pipeline.

The single-host :class:`~repro_torch.tuning.online.OnlineTuner` observes,
decides and acts on one machine.  A fleet serving heavy traffic needs the
same loop split across the wire: per-host optima diverge with hardware,
hosts drift, straggle and die, and a lockstep SPMD fleet's effective
transfer time is the MAX over hosts — so per-host decisions must be
coordinated to protect global goodput.

  observe — a :class:`HostAgent` on every host feeds its
            :class:`GoodputMonitor` one (data-wait, step-time) pair per
            step and streams :class:`HostReport`\\ s (goodput, stall
            ratio, per-batch seconds, stream position) to the
            coordinator.  Each ingested report is also the host's
            heartbeat.
  decide  — the :class:`FleetCoordinator` aggregates: fleet-level stall
            drift or straggler divergence declares a re-consensus;
            heartbeat timeouts declare a death; ``join`` admits a new
            host.  Warmup/cooldown/backoff bookkeeping lives here, not on
            the hosts.
  act     — re-consensus runs the existing ``tune()``/:class:`MultiHostDPT`
            machinery over every live host's evaluator and hot-swaps the
            winning uniform params into each host through
            ``apply_params``.  A death (or join) emits an elastic
            reshard: every surviving loader remaps its
            ``ShardedSampler`` shard at a common global-batch barrier,
            and the dead host's undelivered slices are redistributed as
            makeup chunks — zero samples lost, zero duplicated across
            the transition (see ``LoaderStream.apply_reshard``).

Reshard invariants (DESIGN.md §4):

* the global permutation and global-batch boundaries depend only on
  (seed, epoch, global_batch) — never on the shard topology;
* all hosts remap at the SAME absolute barrier ``B``, chosen as the max
  stream position over survivors (no host has yielded past it);
* batches before ``B`` were delivered under the old shard map (the dead
  host's own deliveries up to its last reported position included),
  batches from ``B`` on are delivered under the new map, and the dead
  host's undelivered window ``[dead_position, B)`` arrives as makeup —
  the union is every index exactly once per epoch.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dpt import DPTConfig, DPTResult, MultiHostDPT
from repro_torch.core.monitor import MemoryOverflow
from repro_torch.data.loader import DataLoader, LoaderParams, TransferStats
from repro_torch.data.sampler import ShardedSampler
from repro_torch.distributed.fault_tolerance import (HeartbeatRegistry,
                                                     StragglerDetector,
                                                     plan_remesh)
from repro_torch.tuning.base import adaptive_budget
from repro_torch.tuning.online import GoodputMonitor
from repro_torch.tuning.transport import (AgentLink, LeaderLease,
                                          LocalTransport, SnapshotStore,
                                          StaleLeaderError, TransportError,
                                          to_wire)


# --------------------------------------------------------------------------
# consensus math (MultiHostDPT.run_uniform delegates here)
# --------------------------------------------------------------------------
def uniform_consensus(results: Sequence[DPTResult]
                      ) -> Tuple[Tuple[int, int], float]:
    """Straggler-aware minimax over per-host sweeps.

    Candidate cells are every host's trials, scored by the fleet max (the
    lockstep step time); a cell is feasible only if every host measured it
    un-overflowed.  Returns the argmin cell and its fleet time; raises
    MemoryOverflow when no cell is feasible everywhere.
    """
    per_cell: Dict[Tuple[int, int], float] = {}
    counts: Dict[Tuple[int, int], int] = {}
    for r in results:
        for t in r.trials:
            key = (t.nworker, t.nprefetch)
            per_cell[key] = max(per_cell.get(key, 0.0), t.seconds)
            if not t.overflowed and math.isfinite(t.seconds):
                counts[key] = counts.get(key, 0) + 1
    feasible = {k: v for k, v in per_cell.items()
                if counts.get(k, 0) == len(results)}
    if not feasible:
        raise MemoryOverflow("no uniform cell feasible on all hosts")
    best = min(feasible, key=feasible.get)
    return best, feasible[best]


# --------------------------------------------------------------------------
# the wire format
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HostReport:
    """One observation snapshot from a host (also its heartbeat)."""
    host: str
    steps: int                       # observations since the agent started
    consumed: int                    # absolute global-batch position trained
    position: int                    # stream yield cursor (>= consumed)
    stall_ratio: float
    steps_per_s: float
    batch_seconds: List[float]
    params: Tuple[int, int]          # current (num_workers, prefetch_factor)
    # IO-efficiency snapshot (DataLoader.io_counters: storage request
    # counters, achieved coalesced run length, staging/arena hit rates) —
    # lets retune decisions and dashboards see *locality*, not just rates.
    # None when nothing in the host's pipeline keeps counters.
    io: Optional[Dict[str, float]] = None
    # makeup chunks this host has fully CONSUMED (of all it was ever
    # dealt).  Lets a coordinator that only ever saw the host through
    # the wire reconstruct the host's undelivered-makeup backlog from
    # its own dealt log when the host dies without answering queries.
    makeup_done: int = 0


def report_to_wire(r: HostReport) -> Dict[str, Any]:
    return to_wire(dataclasses.asdict(r))


def report_from_wire(d: Dict[str, Any]) -> HostReport:
    return HostReport(
        host=str(d["host"]), steps=int(d["steps"]),
        consumed=int(d["consumed"]), position=int(d["position"]),
        stall_ratio=float(d["stall_ratio"]),
        steps_per_s=float(d["steps_per_s"]),
        batch_seconds=[float(x) for x in d.get("batch_seconds") or []],
        params=tuple(int(x) for x in d["params"]),
        io=dict(d["io"]) if d.get("io") else None,
        makeup_done=int(d.get("makeup_done", 0)))


@dataclasses.dataclass
class FleetConfig:
    heartbeat_timeout_s: float = 30.0
    # decide: aggregate drift + straggler divergence
    stall_fraction: float = 0.35     # mean stall ratio over alive hosts
    straggler_threshold: float = 1.5
    straggler_window: int = 16
    warmup_steps: int = 4            # min fleet steps before deciding
    cooldown_steps: int = 16         # fleet steps between consensus runs
    max_backoff: int = 8
    min_improvement: float = 0.05    # uniform winner must beat current cell
    # act: the consensus search (None budget derives adaptively)
    retune_budget_batches: Optional[int] = None
    max_prefetch: int = 4
    num_cpu_cores: Optional[int] = None
    num_devices: Optional[int] = None
    # online locality axis (DESIGN.md §6): candidate sampler chunk sizes a
    # re-consensus may propose.  Locality can only change UNIFORMLY on a
    # sharded fleet (every host must slice the same epoch permutation), so
    # the sweep scores candidates by the fleet max and the push pins one
    # common latch epoch on every host.  None keeps re-consensus on
    # (workers, prefetch).
    locality_chunks: Optional[Tuple[int, ...]] = None
    # online cache axis (DESIGN.md §7): candidate cross-epoch cache budgets
    # a re-consensus may propose.  The budget changes UNIFORMLY too — not
    # for correctness (each host's tier only serves its own shard) but for
    # goodput: a lockstep fleet runs at the max host time, so a budget only
    # helps when every host carries it.  Scored by the fleet max at a warm
    # epoch; None keeps re-consensus off the axis.
    cache_budgets: Optional[Tuple[int, ...]] = None
    # fault-plane consensus trigger (DESIGN.md §10): re-consensus fires
    # when any alive host's reported windowed ``fault_rate`` crosses this
    # (edge-triggered: once per excursion, plus once when the last
    # degraded host heals).  0 disables.
    fault_rate_trigger: float = 0.0
    # elastic re-mesh bookkeeping (plan_remesh)
    devices_per_host: int = 1
    model_axis: int = 1
    # elastic geometry (DESIGN.md §11): when True, a death/leave reshard
    # APPLIES plan_remesh's new_global_batch — pushed to every survivor
    # at one common epoch latch (batch boundaries are position arithmetic,
    # so the in-progress epoch finishes under the old geometry, with a
    # ragged per-host split when the old batch does not divide by the
    # survivor count).  False keeps the plan as a recorded recommendation.
    elastic_geometry: bool = True
    # consensus mode: "uniform" pushes one winning (workers, prefetch)
    # cell fleet-wide; "per_host" gives each host its own winning cell
    # AND a contiguous slice of the global batch proportional to its
    # measured delivery speed (MultiHostDPT.run_per_host), so a lockstep
    # fleet is no longer pinned to its slowest host's uniform share.
    consensus: str = "uniform"
    # survivability knobs (DESIGN.md §8)
    max_events: int = 4096           # event-log ring size (HA snapshot keeps
                                     # the monotonic seq even after eviction)
    max_barrier_rounds: int = 16     # reshard re-issue cap: a fault-injected
                                     # agent that keeps raising its effective
                                     # barrier errors out instead of spinning


class EventLog:
    """Bounded coordinator event log with a monotonic sequence number.

    An unbounded ``FleetCoordinator.events`` list would be, on a
    long-running fleet, a slow memory leak and an unbounded HA
    snapshot.  This keeps the newest ``max_events`` entries, stamps each
    with a fleet-lifetime ``seq`` (stable across ring eviction AND
    coordinator failover), and still behaves like the list the tests and
    benches index/slice/iterate.
    """

    def __init__(self, max_events: int = 4096, *, start_seq: int = 0):
        self.max_events = max(1, int(max_events))
        self._items: List[Dict[str, Any]] = []
        self.next_seq = int(start_seq)

    def append(self, event: Dict[str, Any]) -> Dict[str, Any]:
        event.setdefault("seq", self.next_seq)
        self.next_seq = max(self.next_seq, int(event["seq"])) + 1
        self._items.append(event)
        if len(self._items) > self.max_events:
            del self._items[:len(self._items) - self.max_events]
        return event

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __bool__(self) -> bool:
        return bool(self._items)

    def state_dict(self) -> Dict[str, Any]:
        return {"next_seq": self.next_seq, "max_events": self.max_events,
                "items": to_wire(self._items)}

    @classmethod
    def restore(cls, d: Dict[str, Any]) -> "EventLog":
        log = cls(int(d.get("max_events", 4096)))
        log._items = list(d.get("items") or [])
        log.next_seq = int(d.get("next_seq", len(log._items)))
        return log


# --------------------------------------------------------------------------
# per-host agent: observe + act, no decisions
# --------------------------------------------------------------------------
class HostAgent:
    """The fleet's presence on one host.

    Observe: ``observe(data_s, step_s)`` once per training/serving step —
    it feeds the goodput window and streams a report (the heartbeat) to
    the coordinator.  Act: ``apply_params`` / ``reshard`` are invoked BY
    the coordinator; the agent never decides anything itself.
    """

    def __init__(self, host: str, loader: DataLoader, *, evaluator=None,
                 window: int = 8, report_every: int = 1,
                 consumes_stream: bool = True,
                 link: Optional[AgentLink] = None):
        self.host = host
        self.loader = loader
        if evaluator is None:
            from repro_torch.core.evaluators import LoaderEvaluator
            evaluator = LoaderEvaluator(loader, to_device=True)
        self.evaluator = evaluator
        self.monitor = GoodputMonitor(window=window)
        self.report_every = max(1, report_every)
        # training loops consume exactly one loader batch per observe();
        # serving frontends observe per served request-group instead, so
        # their step count says nothing about loader consumption — they
        # pass consumes_stream=False and the stream cursor is used
        self.consumes_stream = consumes_stream
        self.coordinator: Optional["FleetCoordinator"] = None
        # transport mode: reports/commands cross a message link instead of
        # direct method calls.  Exactly one of (coordinator, link) is set.
        self.link: Optional[AgentLink] = None
        if link is not None:
            self.link = link.bind(self)
        self._base = loader.sampler.absolute()
        self.steps = 0
        # which live stream the consumed-step count refers to: makeup
        # yields do not advance the regular-batch position, so the count
        # must be mapped through the stream's per-yield position log
        # rather than added to a base (see LoaderStream.position_after)
        self._consume_stream = None
        self._bind_steps = 0
        # makeup chunks ever dealt to this host (reported as makeup_done
        # minus the undelivered backlog — see HostReport.makeup_done)
        self._makeup_added = 0

    @property
    def attached(self) -> bool:
        """True when this agent reports to a control plane (in-process
        coordinator or message link)."""
        return self.coordinator is not None or self.link is not None

    # ---- observe -----------------------------------------------------------
    def observe(self, *, data_s: float, step_s: float) -> None:
        self.monitor.observe(data_s=data_s, step_s=step_s)
        self.steps += 1
        if self.consumes_stream:
            stream = self.loader._live_stream
            if stream is not None and stream is not self._consume_stream:
                # first observe against a (re)built stream: the batch just
                # consumed was that stream's first consumed yield
                self._consume_stream = stream
                self._bind_steps = self.steps - 1
        if self.steps % self.report_every == 0:
            if self.coordinator is not None:
                self.coordinator.ingest(self.report())
            elif self.link is not None:
                # never blocks: an unreachable coordinator parks the
                # report in the link's bounded queue and training
                # continues on the last latched params
                self.link.send_report(self.report_wire())

    def consumed_position(self) -> int:
        """Absolute global-batch position the CONSUMER reached (one stream
        yield per observed step for a training loop — mapped through the
        stream's position log because makeup yields do not advance the
        position; the stream cursor when the observer does not consume
        the stream batch-per-step)."""
        if not self.consumes_stream:
            return self.stream_position()
        stream = self._consume_stream
        if stream is not None and stream is self.loader._live_stream:
            return stream.position_after(self.steps - self._bind_steps)
        return self._base + self.steps

    def stream_position(self) -> int:
        """The live stream's yield cursor (>= consumed: the device
        prefetcher may hold yielded-but-unconsumed batches, which are
        guaranteed to be delivered)."""
        stream = self.loader._live_stream
        if stream is not None:
            return stream.position
        return self.loader.sampler.absolute()

    def report(self) -> HostReport:
        p = self.loader.params
        return HostReport(
            host=self.host, steps=self.steps,
            consumed=self.consumed_position(),
            position=self.stream_position(),
            stall_ratio=self.monitor.stall_ratio,
            steps_per_s=self.monitor.steps_per_s,
            batch_seconds=self.monitor.batch_seconds,
            params=(p.num_workers, p.prefetch_factor),
            io=self.loader.io_counters() or None,
            makeup_done=self._makeup_added - len(self.undelivered_makeup()))

    def report_wire(self) -> Dict[str, Any]:
        """Full report as a wire dict, carrying the host's live locality/
        cache schedules so the coordinator's shard mirror tracks plans the
        host computed locally (e.g. hot_k after a budget push).  Deltas
        drop the schedules automatically while they are unchanged."""
        d = report_to_wire(self.report())
        d["schedules"] = to_wire(self.schedule_state())
        return d

    def heartbeat(self) -> None:
        """Liveness without an observation (e.g. a serving frontend between
        batches)."""
        if self.coordinator is not None:
            self.coordinator.beat(self.host)
        elif self.link is not None:
            self.link.beat()

    def notify_drift(self, reason: str) -> None:
        """External drift signal (e.g. the serving batch-mix monitor):
        asks the coordinator for an out-of-band re-consensus."""
        if self.coordinator is not None:
            self.coordinator.request_consensus(reason=reason)
        elif self.link is not None:
            self.link.cast("drift", reason=reason)

    def notify_locality(self, chunk: int) -> None:
        """Adaptive-controller proposal (run-length collapse): locality
        may only change uniformly, so route it to the coordinator, which
        drops it when the fleet searches no locality axis."""
        if self.coordinator is not None:
            self.coordinator.request_locality(chunk, host=self.host)
        elif self.link is not None:
            self.link.cast("locality", chunk=int(chunk))

    # ---- act (coordinator-driven) ------------------------------------------
    def apply_params(self, nworker: int, nprefetch: int,
                     locality_chunk: Optional[int] = None, *,
                     locality_epoch: Optional[int] = None,
                     cache_budget_bytes: Optional[int] = None
                     ) -> LoaderParams:
        """Push tuned params into the live loader.  ``locality_chunk`` and
        ``cache_budget_bytes`` are only ever set by a fleet-uniform push,
        which also pins the common ``locality_epoch`` every host latches
        the new chunk (and cache plan) at.  A budget push resizes the
        host's live tier in place — warm entries survive the swap."""
        params = self.loader.params.replace(
            num_workers=nworker, prefetch_factor=nprefetch)
        if locality_chunk is not None:
            params = params.replace(locality_chunk=locality_chunk)
        if cache_budget_bytes is not None:
            params = params.replace(cache_budget_bytes=cache_budget_bytes)
        return self.loader.apply_params(params,
                                        locality_epoch=locality_epoch)

    def reshard(self, num_shards: int, shard: int, *,
                at_batch: Optional[int] = None,
                makeup: Optional[Sequence[np.ndarray]] = None,
                sizes: Optional[Sequence[int]] = None,
                op_id: Optional[str] = None) -> int:
        # op_id is the wire-level idempotency token; the in-process path
        # needs no dedup (calls are exactly-once on a stack)
        del op_id
        if makeup:
            self._makeup_added += len(makeup)
        return self.loader.reshard(num_shards, shard, at_batch=at_batch,
                                   makeup=makeup, sizes=sizes)

    def set_geometry(self, global_batch: int, *,
                     epoch: Optional[int] = None,
                     op_id: Optional[str] = None) -> int:
        """Adopt a new global batch from ``epoch`` on (elastic geometry
        push — see DataLoader.set_geometry)."""
        del op_id
        return self.loader.set_geometry(int(global_batch), epoch=epoch)

    def add_makeup(self, makeup: Sequence[np.ndarray], *,
                   op_id: Optional[str] = None) -> None:
        del op_id
        self._makeup_added += len(makeup)
        self.loader.add_makeup(makeup)

    def undelivered_makeup(self) -> List[np.ndarray]:
        """Makeup this host accepted but never CONSUMED — including
        batches its device prefetcher held at death (the stream's
        yield-side accounting alone would count those as delivered)."""
        stream = self._consume_stream
        if self.consumes_stream and stream is not None \
                and stream is self.loader._live_stream:
            return stream.undelivered_makeup(
                consumed_yields=self.steps - self._bind_steps)
        return self.loader.undelivered_makeup()

    def align_to(self, position: int) -> None:
        """Point a FRESH loader (no live stream yet) at an absolute
        global-batch position — how a joining host meets the fleet at the
        barrier."""
        sampler = self.loader.sampler
        sampler.state = sampler.state_at(position)
        self._base = position
        self.steps = 0
        self._consume_stream = None
        self._bind_steps = 0

    # ---- fleet-member surface ----------------------------------------------
    # The coordinator only ever speaks this narrow API — implemented
    # natively here (direct mode) and over the wire by RemoteAgent, so
    # the decide logic is transport-agnostic.
    def param_cell(self) -> Tuple[int, int]:
        p = self.loader.params
        return (p.num_workers, p.prefetch_factor)

    def knob_state(self) -> Dict[str, Any]:
        p = self.loader.params
        return {"locality_chunk": p.locality_chunk,
                "cache_budget_bytes": p.cache_budget_bytes}

    def locality_latch_epoch(self) -> int:
        return self.loader.locality_latch_epoch()

    def shard_index(self) -> int:
        return self.loader.sampler.host_index

    def global_batch(self) -> int:
        return self.loader.sampler.global_batch

    def shard_sizes(self) -> Optional[List[int]]:
        s = self.loader.sampler.shard_sizes
        return None if s is None else list(s)

    def batches_per_epoch(self, epoch: Optional[int] = None) -> int:
        return self.loader.sampler.batches_per_epoch(epoch)

    def local_indices(self, epoch: int, batch: int) -> np.ndarray:
        return self.loader.sampler.local_indices(epoch, batch)

    def local_indices_at(self, position: int) -> np.ndarray:
        """This host's slice at an absolute global-batch position —
        schedule-aware (epochs can have different lengths under an
        elastic geometry schedule)."""
        s = self.loader.sampler
        st = s.state_at(int(position))
        return s.local_indices(st.epoch, st.batch_offset)

    def schedule_state(self) -> Dict[str, Any]:
        """The uniform-permutation contract: the full (epoch -> chunk),
        (epoch -> hot_k) and (epoch -> global_batch) schedules plus the
        params they came from."""
        s = self.loader.sampler
        return {"locality": s.locality_state(), "cache": s.cache_state(),
                "geometry": s.geometry_state(), **self.knob_state()}

    def sync_schedules(self, sched: Dict[str, Any]) -> None:
        """Adopt a peer's full epoch schedules (join catch-up, partition
        re-sync) so this host slices the same permutation as the fleet."""
        loader = self.loader
        if sched.get("locality") is not None:
            loader.sampler.load_locality(sched["locality"])
        if sched.get("cache") is not None:
            loader.sampler.load_cache_plan(sched["cache"])
        if sched.get("geometry") is not None:
            loader.sampler.load_geometry(sched["geometry"])
        chunk = sched.get("locality_chunk")
        budget = sched.get("cache_budget_bytes")
        loader.params = loader.params.replace(
            locality_chunk=loader.params.locality_chunk if chunk is None
            else int(chunk),
            cache_budget_bytes=loader.params.cache_budget_bytes
            if budget is None else int(budget))
        loader._sync_cache_plan()

    def begin_trials(self) -> None:
        """Bracket a coordinator-driven measurement burst: trial cells
        mutate loader params via with_params; a live stream must never
        rebuild on trial params."""
        self._trial_params = self.loader.params

    def end_trials(self) -> None:
        saved = getattr(self, "_trial_params", None)
        if saved is not None:
            self.loader.with_params(saved)
            self._trial_params = None

    # ---- transport glue ----------------------------------------------------
    def member_spec(self) -> Dict[str, Any]:
        """Everything the coordinator needs to mirror this host's shard
        map without object access — crossed once at register/join."""
        s = self.loader.sampler
        p = self.loader.params
        return {"host": self.host,
                "position": self.stream_position(),
                "sampler": {"num_items": s.num_items,
                            "global_batch": s.global_batch,
                            "shuffle": s.shuffle, "seed": s.seed,
                            "drop_last": s.drop_last,
                            "host_index": s.host_index,
                            "host_count": s.host_count,
                            "layout": s.layout,
                            "locality": s.locality_state(),
                            "cache": s.cache_state(),
                            "geometry": s.geometry_state(),
                            "sizes": None if s.shard_sizes is None
                            else list(s.shard_sizes)},
                "params": {"num_workers": p.num_workers,
                           "prefetch_factor": p.prefetch_factor,
                           "locality_chunk": p.locality_chunk,
                           "cache_budget_bytes": p.cache_budget_bytes}}

    def ha_state(self) -> Dict[str, Any]:
        """Snapshot form of this member for the coordinator HA checkpoint
        (direct-mode agents serialize their spec; the dealt-makeup log is
        empty because direct mode never loses the object)."""
        return {"spec": self.member_spec(), "dealt": [],
                "report": report_to_wire(self.report())}

    def handle_command(self, op: str, args: Dict[str, Any]) -> Any:
        """Wire command dispatch (invoked by AgentLink AFTER its fence and
        dedup checks).  Every coordinator->agent verb crosses here."""
        if op == "apply_params":
            p = self.apply_params(
                int(args["nworker"]), int(args["nprefetch"]),
                None if args.get("locality_chunk") is None
                else int(args["locality_chunk"]),
                locality_epoch=None if args.get("locality_epoch") is None
                else int(args["locality_epoch"]),
                cache_budget_bytes=None
                if args.get("cache_budget_bytes") is None
                else int(args["cache_budget_bytes"]))
            return {"num_workers": p.num_workers,
                    "prefetch_factor": p.prefetch_factor}
        if op == "reshard":
            makeup = None
            if args.get("makeup") is not None:
                makeup = [np.asarray(c, dtype=np.int64)
                          for c in args["makeup"]]
            return self.reshard(
                int(args["num_shards"]), int(args["shard"]),
                at_batch=None if args.get("at_batch") is None
                else int(args["at_batch"]),
                makeup=makeup,
                sizes=None if args.get("sizes") is None
                else [int(s) for s in args["sizes"]])
        if op == "set_geometry":
            return self.set_geometry(
                int(args["global_batch"]),
                epoch=None if args.get("epoch") is None
                else int(args["epoch"]))
        if op == "add_makeup":
            self.add_makeup([np.asarray(c, dtype=np.int64)
                             for c in args["chunks"]])
            return len(args["chunks"])
        if op == "align_to":
            self.align_to(int(args["position"]))
            return int(args["position"])
        if op == "sync_schedules":
            self.sync_schedules(args["sched"])
            return True
        if op == "query":
            what = args.get("what")
            if what == "stream_position":
                return self.stream_position()
            if what == "consumed_position":
                return self.consumed_position()
            if what == "locality_latch_epoch":
                return self.locality_latch_epoch()
            if what == "schedule_state":
                return self.schedule_state()
            if what == "params":
                return {"cell": list(self.param_cell()),
                        **self.knob_state()}
            raise ValueError(f"unknown query {what!r}")
        if op == "measure":
            # trial measurement on behalf of a remote consensus: run the
            # local evaluator and ALWAYS restore live params (the remote
            # coordinator cannot reach in to clean up)
            saved = self.loader.params
            kw: Dict[str, Any] = {
                "num_batches": int(args.get("num_batches", 16)),
                "epoch": int(args.get("epoch", 0))}
            # forward the extra axes only when set: plain 2-axis
            # evaluators (and the sweep helpers) do not take them
            if args.get("locality_chunk") is not None:
                kw["locality_chunk"] = int(args["locality_chunk"])
            if args.get("cache_budget_bytes") is not None:
                kw["cache_budget_bytes"] = int(args["cache_budget_bytes"])
            if args.get("global_batch") is not None:
                kw["global_batch"] = int(args["global_batch"])
            try:
                stats = self.evaluator(
                    int(args["nworker"]), int(args["nprefetch"]), **kw)
                return to_wire(dataclasses.asdict(stats))
            except MemoryOverflow as e:
                return {"overflow": True, "error": str(e)}
            finally:
                self.loader.with_params(saved)
        if op == "ping":
            return True
        raise ValueError(f"unknown command {op!r}")


# --------------------------------------------------------------------------
# the coordinator-side proxy: a fleet member that lives across the wire
# --------------------------------------------------------------------------
class _RemoteEvaluator:
    """Evaluator facade over a RemoteAgent: a consensus trial becomes a
    ``measure`` command; the host runs its real evaluator and ships the
    TransferStats (or an overflow verdict) back as data."""

    def __init__(self, proxy: "RemoteAgent"):
        self.proxy = proxy
        self.calls = 0

    def __call__(self, nworker: int, nprefetch: int, *,
                 num_batches: int = 16, epoch: int = 0,
                 locality_chunk: Optional[int] = None,
                 cache_budget_bytes: Optional[int] = None,
                 global_batch: Optional[int] = None) -> TransferStats:
        self.calls += 1
        r = self.proxy._send("measure", {
            "nworker": nworker, "nprefetch": nprefetch,
            "num_batches": num_batches, "epoch": epoch,
            "locality_chunk": locality_chunk,
            "cache_budget_bytes": cache_budget_bytes,
            "global_batch": global_batch})
        if r.get("overflow"):
            raise MemoryOverflow(r.get("error", "remote overflow"))
        return TransferStats(
            seconds=float(r["seconds"]), batches=int(r["batches"]),
            bytes=int(r["bytes"]), overflowed=bool(r.get("overflowed")),
            peak_loader_bytes=int(r.get("peak_loader_bytes", 0)),
            batch_seconds=r.get("batch_seconds"))


class RemoteAgent:
    """The coordinator's view of a host it can only reach by message.

    Implements the same fleet-member surface as :class:`HostAgent`, but
    every act crosses the transport as a fenced, idempotent command —
    and the *observe* side keeps a local mirror (a ShardedSampler built
    from the registration spec, updated on acked reshards/pushes and on
    report schedules) so the coordinator can compute a DEAD host's
    undelivered slices without asking it anything.  The mirror plus the
    dealt-makeup log is exactly the state the direct-mode coordinator
    used to read out of the departed agent object.
    """

    def __init__(self, server: "CoordinatorServer", spec: Dict[str, Any], *,
                 dealt: Optional[List] = None,
                 report: Optional[Dict[str, Any]] = None):
        self.host = str(spec["host"])
        self._server = server
        self._base = int(spec.get("position", 0))
        sp = spec["sampler"]
        self._sampler = ShardedSampler(
            int(sp["num_items"]), int(sp["global_batch"]),
            shuffle=bool(sp["shuffle"]), seed=int(sp["seed"]),
            drop_last=bool(sp["drop_last"]),
            host_index=int(sp["host_index"]),
            host_count=int(sp["host_count"]),
            layout=sp.get("layout", "host_major"),
            shard_sizes=None if sp.get("sizes") is None
            else [int(s) for s in sp["sizes"]])
        if sp.get("locality"):
            self._sampler.load_locality(sp["locality"])
        if sp.get("cache"):
            self._sampler.load_cache_plan(sp["cache"])
        if sp.get("geometry"):
            self._sampler.load_geometry(sp["geometry"])
        self._params = dict(spec["params"])
        self._dealt: List[np.ndarray] = [
            np.asarray(c, dtype=np.int64) for c in (dealt or [])]
        self.last_report: Optional[HostReport] = \
            None if report is None else report_from_wire(report)
        self.coordinator: Optional["FleetCoordinator"] = None
        self.evaluator = _RemoteEvaluator(self)

    def _send(self, op: str, args: Dict[str, Any],
              op_id: Optional[str] = None) -> Any:
        return self._server.send(self.host, op, args, op_id=op_id)

    # ---- observe -----------------------------------------------------------
    def observe_report(self, report: HostReport,
                       schedules: Optional[Dict[str, Any]] = None) -> None:
        """Fold an ACCEPTED report into the mirror (the server calls this
        after the coordinator's stale-steps guard passed)."""
        self.last_report = report
        self._params["num_workers"], self._params["prefetch_factor"] = \
            (int(report.params[0]), int(report.params[1]))
        if schedules:
            if schedules.get("locality") is not None:
                self._sampler.load_locality(schedules["locality"])
            if schedules.get("cache") is not None:
                self._sampler.load_cache_plan(schedules["cache"])
            if schedules.get("geometry") is not None:
                self._sampler.load_geometry(schedules["geometry"])
            if schedules.get("locality_chunk") is not None:
                self._params["locality_chunk"] = \
                    int(schedules["locality_chunk"])
            if schedules.get("cache_budget_bytes") is not None:
                self._params["cache_budget_bytes"] = \
                    int(schedules["cache_budget_bytes"])

    # ---- member surface: reads ---------------------------------------------
    def stream_position(self) -> int:
        return int(self._send("query", {"what": "stream_position"}))

    def consumed_position(self) -> int:
        """From the last report — NEVER an RPC: this is only ever read for
        departed hosts, which by definition cannot answer."""
        if self.last_report is not None:
            return int(self.last_report.consumed)
        return self._base

    def undelivered_makeup(self) -> List[np.ndarray]:
        """The dealt-log tail the host never consumed (makeup parked on a
        corpse) — reconstructed coordinator-side from makeup_done."""
        done = 0 if self.last_report is None \
            else max(0, int(self.last_report.makeup_done))
        return [np.array(c, dtype=np.int64) for c in self._dealt[done:]]

    def param_cell(self) -> Tuple[int, int]:
        return (int(self._params["num_workers"]),
                int(self._params["prefetch_factor"]))

    def knob_state(self) -> Dict[str, Any]:
        return {"locality_chunk": int(self._params.get("locality_chunk", 0)),
                "cache_budget_bytes":
                    int(self._params.get("cache_budget_bytes", 0))}

    def locality_latch_epoch(self) -> int:
        return int(self._send("query", {"what": "locality_latch_epoch"}))

    def shard_index(self) -> int:
        return self._sampler.host_index

    def global_batch(self) -> int:
        return self._sampler.global_batch

    def shard_sizes(self) -> Optional[List[int]]:
        s = self._sampler.shard_sizes
        return None if s is None else list(s)

    def batches_per_epoch(self, epoch: Optional[int] = None) -> int:
        return self._sampler.batches_per_epoch(epoch)

    def local_indices(self, epoch: int, batch: int) -> np.ndarray:
        return self._sampler.local_indices(epoch, batch)

    def local_indices_at(self, position: int) -> np.ndarray:
        st = self._sampler.state_at(int(position))
        return self._sampler.local_indices(st.epoch, st.batch_offset)

    def schedule_state(self) -> Dict[str, Any]:
        return {"locality": self._sampler.locality_state(),
                "cache": self._sampler.cache_state(),
                "geometry": self._sampler.geometry_state(),
                **self.knob_state()}

    # ---- member surface: fenced acts ---------------------------------------
    def apply_params(self, nworker: int, nprefetch: int,
                     locality_chunk: Optional[int] = None, *,
                     locality_epoch: Optional[int] = None,
                     cache_budget_bytes: Optional[int] = None) -> None:
        self._send("apply_params", {
            "nworker": nworker, "nprefetch": nprefetch,
            "locality_chunk": locality_chunk,
            "locality_epoch": locality_epoch,
            "cache_budget_bytes": cache_budget_bytes})
        self._params["num_workers"] = int(nworker)
        self._params["prefetch_factor"] = int(nprefetch)
        if locality_chunk is not None:
            self._params["locality_chunk"] = int(locality_chunk)
            self._sampler.set_locality(int(locality_chunk),
                                       epoch=locality_epoch)
        if cache_budget_bytes is not None:
            self._params["cache_budget_bytes"] = int(cache_budget_bytes)

    def reshard(self, num_shards: int, shard: int, *,
                at_batch: Optional[int] = None,
                makeup: Optional[Sequence[np.ndarray]] = None,
                sizes: Optional[Sequence[int]] = None,
                op_id: Optional[str] = None) -> int:
        args: Dict[str, Any] = {"num_shards": num_shards, "shard": shard,
                                "at_batch": at_batch}
        if makeup:
            args["makeup"] = [np.asarray(c).tolist() for c in makeup]
        if sizes is not None:
            args["sizes"] = [int(s) for s in sizes]
        effective = int(self._send("reshard", args, op_id=op_id))
        # the ack means the host applied it: mirror follows
        self._sampler.reshard(num_shards, shard, sizes=sizes)
        if makeup:
            self._dealt.extend(np.asarray(c, dtype=np.int64) for c in makeup)
        return effective

    def set_geometry(self, global_batch: int, *,
                     epoch: Optional[int] = None,
                     op_id: Optional[str] = None) -> int:
        eff = int(self._send("set_geometry",
                             {"global_batch": int(global_batch),
                              "epoch": epoch}, op_id=op_id))
        # mirror at the host's EFFECTIVE epoch (its natural latch may
        # have clamped a stale pin upward)
        self._sampler.set_geometry(int(global_batch), epoch=eff)
        return eff

    def add_makeup(self, makeup: Sequence[np.ndarray], *,
                   op_id: Optional[str] = None) -> None:
        self._send("add_makeup",
                   {"chunks": [np.asarray(c).tolist() for c in makeup]},
                   op_id=op_id)
        self._dealt.extend(np.asarray(c, dtype=np.int64) for c in makeup)

    def align_to(self, position: int) -> None:
        self._send("align_to", {"position": int(position)})
        self._base = int(position)

    def sync_schedules(self, sched: Dict[str, Any]) -> None:
        self._send("sync_schedules", {"sched": to_wire(sched)})
        if sched.get("locality") is not None:
            self._sampler.load_locality(sched["locality"])
        if sched.get("cache") is not None:
            self._sampler.load_cache_plan(sched["cache"])
        if sched.get("geometry") is not None:
            self._sampler.load_geometry(sched["geometry"])
        if sched.get("locality_chunk") is not None:
            self._params["locality_chunk"] = int(sched["locality_chunk"])
        if sched.get("cache_budget_bytes") is not None:
            self._params["cache_budget_bytes"] = \
                int(sched["cache_budget_bytes"])

    def begin_trials(self) -> None:
        """No-op: the host-side ``measure`` handler restores its own live
        params around every trial."""

    def end_trials(self) -> None:
        pass

    # ---- HA snapshot -------------------------------------------------------
    def ha_state(self) -> Dict[str, Any]:
        s = self._sampler
        return {"spec": {"host": self.host, "position": self._base,
                         "sampler": {"num_items": s.num_items,
                                     "global_batch": s.global_batch,
                                     "shuffle": s.shuffle, "seed": s.seed,
                                     "drop_last": s.drop_last,
                                     "host_index": s.host_index,
                                     "host_count": s.host_count,
                                     "layout": s.layout,
                                     "locality": s.locality_state(),
                                     "cache": s.cache_state(),
                                     "geometry": s.geometry_state(),
                                     "sizes": None if s.shard_sizes is None
                                     else list(s.shard_sizes)},
                         "params": dict(self._params)},
                "dealt": [c.tolist() for c in self._dealt],
                "report": None if self.last_report is None
                else report_to_wire(self.last_report)}

    @classmethod
    def restore(cls, server: "CoordinatorServer",
                state: Dict[str, Any]) -> "RemoteAgent":
        return cls(server, state["spec"], dealt=state.get("dealt"),
                   report=state.get("report"))


# --------------------------------------------------------------------------
# the coordinator: decide
# --------------------------------------------------------------------------
class FleetCoordinator:
    """Aggregates host reports and drives fleet-wide tuning + resharding.

    Drive it with ``ingest``/``beat`` (or let registered agents do that
    through ``observe``) and call ``poll()`` from the control loop —
    every action taken is appended to ``events`` and returned.
    """

    def __init__(self, *, config: Optional[FleetConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        # default None, constructed per-instance: a module-level default
        # FleetConfig() would be one shared mutable object across every
        # coordinator ever constructed
        config = FleetConfig() if config is None else config
        self.cfg = config
        self.clock = clock
        self.registry = HeartbeatRegistry(
            timeout_s=config.heartbeat_timeout_s, clock=clock)
        self.straggler = StragglerDetector(
            window=config.straggler_window,
            threshold=config.straggler_threshold)
        self.agents: Dict[str, Any] = {}   # HostAgent | RemoteAgent
        self.reports: Dict[str, HostReport] = {}
        self.events = EventLog(config.max_events)
        self.consensus_runs = 0
        self.reshards = 0
        self._last_consensus_step = -config.cooldown_steps
        self._backoff = 1
        self._forced_reason: Optional[str] = None
        # stale/duplicate-report guard: highest steps counter accepted per
        # host — a replayed or reordered report must not rewind bookkeeping
        self._last_steps: Dict[str, int] = {}
        self.stale_reports = 0
        # fault-plane edge state (DESIGN.md §10): True while the fleet is
        # inside a fault excursion (rate over trigger or a host degraded)
        self._fleet_faulted = False
        # HA plumbing (set by CoordinatorServer / restore)
        self._server: Optional["CoordinatorServer"] = None
        self._store: Optional[SnapshotStore] = None
        self._member_state: Optional[Dict[str, Any]] = None
        self._pending_reshard: Optional[Dict[str, Any]] = None
        # last applied uniform push (re-sync source for reconnecting hosts)
        self._pushed: Optional[Dict[str, Any]] = None

    # ---- membership --------------------------------------------------------
    def register(self, agent) -> Any:
        agent.coordinator = self
        self.agents[agent.host] = agent
        self.registry.beat(agent.host)
        # a (re)joining host restarts its steps counter: reset the stale
        # guard or every report from its new life would be dropped
        self._last_steps.pop(agent.host, None)
        return agent

    def _negotiate_barrier(self, agents: Sequence[Any], num_shards: int,
                           floor: int, *, rid: Optional[int] = None,
                           sizes: Optional[Sequence[int]] = None) -> int:
        """Issue the reshard to every agent at a common barrier, re-issuing
        at the max EFFECTIVE barrier until it is common.

        A live stream whose prefetcher raced past the proposed barrier
        clamps its boundary up and reports it; since a pending request
        pins the stream at its boundary, each re-issue round can only
        raise the barrier and the loop converges (normally in one pass).
        ``max_barrier_rounds`` caps the loop: a faulty agent that keeps
        raising its effective barrier produces a clear diagnostic instead
        of an infinite spin.

        ``sizes`` (optional) is a per-shard split of the global batch —
        host-major contiguous slices — forwarded to every agent so a
        ragged or deliberately non-uniform partition lands fleet-wide at
        the same barrier.
        """
        barrier = max([a.stream_position() for a in agents] + [floor])
        history: List[int] = []
        for _ in range(max(1, self.cfg.max_barrier_rounds)):
            effective = max(
                a.reshard(num_shards, i, at_batch=barrier, sizes=sizes,
                          op_id=None if rid is None
                          else f"reshard-{rid}-map-{a.host}-{barrier}")
                for i, a in enumerate(agents))
            history.append(effective)
            if effective <= barrier:
                return barrier
            barrier = effective
        positions = {a.host: a.stream_position() for a in agents}
        raise RuntimeError(
            f"reshard barrier failed to settle after "
            f"{self.cfg.max_barrier_rounds} rounds: effective barriers "
            f"{history}, stream positions {positions} — some agent keeps "
            f"racing past every proposed barrier")

    def join(self, agent) -> int:
        """Admit a new host mid-run: every existing host reshards to
        H+1 shards at a common barrier, the newcomer is aligned to that
        barrier and takes the last shard.  Returns the barrier."""
        incumbents = [self.agents[h] for h in sorted(self.agents)]
        new_count = len(incumbents) + 1
        rid = self.reshards
        barrier = self._negotiate_barrier(incumbents, new_count, 0, rid=rid)
        if incumbents:
            # locality is runtime-mutable now: the joiner's construction-
            # time chunk can be stale, and a host slicing a different
            # epoch permutation than its peers silently loses/duplicates
            # samples.  Copy an incumbent's full (epoch -> chunk) AND
            # (epoch -> hot_k) AND (epoch -> global_batch) schedules —
            # including any pending latch — BEFORE aligning: align_to
            # converts the barrier to (epoch, offset) through the
            # geometry schedule, so the joiner must hold the fleet's
            # schedule first or it lands on the wrong epoch boundary.
            agent.sync_schedules(incumbents[0].schedule_state())
        agent.align_to(barrier)
        agent.reshard(new_count, new_count - 1,
                      op_id=f"reshard-{rid}-align-{agent.host}")
        self.register(agent)
        self.reshards += 1
        self.events.append({"kind": "join", "host": agent.host,
                            "barrier": barrier, "hosts": new_count})
        # the local batch shrank on every incumbent: re-tune for the new
        # topology at the next poll
        if self._forced_reason is None:
            self._forced_reason = "post-reshard"
        self._checkpoint()
        return barrier

    def leave(self, host: str) -> None:
        """Graceful departure: same reshard as a death, but the host's
        stream position needs no makeup beyond its own report."""
        self._reshard_around([host], reason="leave")

    # ---- observe ingestion -------------------------------------------------
    def beat(self, host: str) -> None:
        self.registry.beat(host)

    def ingest(self, report: HostReport) -> bool:
        """Fold one host report in.  Returns True when accepted.

        Stale/duplicate guard: a replayed, reordered or duplicated report
        whose ``steps`` counter is not beyond the last accepted one for
        that host still counts as a heartbeat (the bytes arrived NOW, so
        something over there is alive) but must not rewind consumed/
        position bookkeeping or re-feed the straggler windows.
        """
        self.registry.beat(report.host)
        last = self._last_steps.get(report.host)
        if last is not None and report.steps <= last:
            self.stale_reports += 1
            return False
        self._last_steps[report.host] = report.steps
        if report.batch_seconds:
            self.straggler.record(
                report.host,
                sum(report.batch_seconds) / len(report.batch_seconds))
        self.reports[report.host] = report
        return True

    def request_consensus(self, *, reason: str) -> None:
        """Out-of-band drift signal (serving batch-mix, operator): run a
        re-consensus at the next ``poll`` regardless of cooldown."""
        self._forced_reason = reason

    def request_locality(self, chunk: int, *, host: str = "?") -> None:
        """A host's adaptive locality controller observed a run-length
        collapse.  Locality can only change uniformly, so this requests a
        locality re-consensus — and is DROPPED when the fleet searches no
        locality axis (``FleetConfig.locality_chunks`` unset): a forced
        search that cannot touch the knob would just burn goodput on
        every repeated proposal."""
        if not self.cfg.locality_chunks:
            return
        self.request_consensus(
            reason=f"locality-run-len-collapse:{host}->{int(chunk)}")

    # ---- decide ------------------------------------------------------------
    @property
    def fleet_step(self) -> int:
        return max((r.steps for r in self.reports.values()), default=0)

    def fleet_stall_ratio(self) -> float:
        alive = set(self.registry.alive_hosts())
        ratios = [r.stall_ratio for h, r in self.reports.items()
                  if h in alive]
        return sum(ratios) / len(ratios) if ratios else 0.0

    def drifted(self) -> bool:
        return self.fleet_stall_ratio() > self.cfg.stall_fraction

    def fleet_fault_rate(self) -> float:
        """Worst windowed fault rate over alive hosts (DESIGN.md §10).
        A lockstep fleet runs at the max host time, so one browning-out
        host is a fleet problem — max, not mean."""
        alive = set(self.registry.alive_hosts())
        rates = [float((r.io or {}).get("fault_rate", 0.0))
                 for h, r in self.reports.items() if h in alive]
        return max(rates) if rates else 0.0

    def fleet_degraded(self) -> bool:
        alive = set(self.registry.alive_hosts())
        return any(float((r.io or {}).get("degraded", 0.0)) >= 1.0
                   for h, r in self.reports.items() if h in alive)

    def _fault_reason(self) -> Optional[str]:
        """Edge-triggered fault consensus: fire once entering an
        excursion (fault-drift) and once leaving it (fault-heal), never
        continuously — a browning-out backend must not make the control
        plane retune in a loop."""
        if self.cfg.fault_rate_trigger <= 0.0:
            return None
        faulted = (self.fleet_fault_rate() > self.cfg.fault_rate_trigger
                   or self.fleet_degraded())
        if faulted and not self._fleet_faulted:
            self._fleet_faulted = True
            return "fault-drift"
        if not faulted and self._fleet_faulted:
            self._fleet_faulted = False
            return "fault-heal"
        return None

    def poll(self) -> List[Dict[str, Any]]:
        """One decide step: finish any interrupted reshard, handle deaths,
        then drift/straggler consensus.  Returns the actions taken (also
        appended to ``events``)."""
        actions: List[Dict[str, Any]] = []
        # a reshard interrupted by a flaky wire (partitioned survivor mid-
        # deal) left its write-ahead intent checkpointed: resume it before
        # deciding anything else — the frozen shares re-deal under their
        # original op-ids, so a survivor that DID get its share applies it
        # exactly once.  Still unreachable -> stays pending for next poll.
        if self._pending_reshard is not None and self._server is not None:
            ev = self._absorb_transport(self._resume_reshard)
            if ev is not None:
                actions.append(ev)
        dead = [h for h in self.registry.dead_hosts() if h in self.agents]
        if dead:
            # one reshard around ALL currently-dead hosts: handling them
            # one at a time would hand a dead "survivor" a shard (and a
            # makeup share) it can never deliver
            ev = self._absorb_transport(
                lambda: self._reshard_around(dead, reason="dead"))
            if ev is not None:
                actions.append(ev)
        reason = self._consensus_reason()
        if reason is not None:
            act = self._absorb_transport(lambda: self._reconsensus(reason))
            if act is not None:
                actions.append(act)
        return actions

    def _absorb_transport(self, fn: Callable[[], Optional[Dict[str, Any]]]
                          ) -> Optional[Dict[str, Any]]:
        """Run one decide action, absorbing TRANSIENT wire failures: a
        host that cannot be reached right now fails the action, not the
        control plane (an interrupted reshard stays write-ahead-logged
        and resumes next poll).  Deposition is never absorbed — a stale
        fence means a newer leader owns the fleet and this one must stop.
        Direct in-process mode (no server) has no wire to absorb."""
        if self._server is None:
            return fn()
        try:
            return fn()
        except StaleLeaderError:
            raise
        except TransportError:
            return None

    def _consensus_reason(self) -> Optional[str]:
        if self._forced_reason is not None:
            reason, self._forced_reason = self._forced_reason, None
            return reason
        if self.fleet_step < self.cfg.warmup_steps:
            return None
        cooldown = self.cfg.cooldown_steps * self._backoff
        if self.fleet_step - self._last_consensus_step < cooldown:
            return None
        stragglers = self.straggler.stragglers()
        if stragglers:
            return f"straggler-divergence:{','.join(stragglers)}"
        if self.drifted():
            return "goodput-drift"
        return self._fault_reason()

    # ---- act: uniform re-consensus -----------------------------------------
    def _search_config(self) -> DPTConfig:
        cfg = DPTConfig(num_cpu_cores=self.cfg.num_cpu_cores,
                        num_devices=self.cfg.num_devices,
                        max_prefetch=self.cfg.max_prefetch)
        return dataclasses.replace(cfg, num_batches=adaptive_budget(
            cfg, self.cfg.retune_budget_batches))

    def _reconsensus(self, reason: str) -> Optional[Dict[str, Any]]:
        """Uniform re-consensus over every live host's evaluator, pushed
        to the whole fleet through apply_params.  With
        ``cfg.consensus == "per_host"`` the fleet instead tunes each host
        independently and re-balances the batch partition to match the
        measured per-host rates (see :meth:`_per_host_consensus`)."""
        if self.cfg.consensus == "per_host":
            return self._per_host_consensus(reason)
        hosts = sorted(h for h in self.agents
                       if h in set(self.registry.alive_hosts()))
        if not hosts:
            return None
        agents = [self.agents[h] for h in hosts]
        tuner = MultiHostDPT([a.evaluator for a in agents],
                             self._search_config())
        self._last_consensus_step = self.fleet_step
        for a in agents:
            a.begin_trials()
        try:
            fleet = tuner.run_uniform()
        except MemoryOverflow:
            self._backoff = min(self.cfg.max_backoff, self._backoff * 2)
            return None
        finally:
            # trial cells mutate loader params via with_params; a live
            # stream must never rebuild on trial params
            for a in agents:
                a.end_trials()
        self.consensus_runs += 1
        won = self._is_fleet_win(fleet, agents)
        # the online locality axis: sweep chunk candidates at the cell the
        # fleet will actually run (the winner if it won, else the current
        # majority cell), scored by the fleet max
        cell = fleet.uniform_params if won \
            else self._majority_cell(agents)
        chunk_win = self._locality_consensus(agents, cell)
        budget_win = self._cache_consensus(agents, cell)
        applied = won or chunk_win is not None or budget_win is not None
        self._backoff = 1 if applied else min(self.cfg.max_backoff,
                                              self._backoff * 2)
        event = {"kind": "consensus", "reason": reason,
                 "params": fleet.uniform_params,
                 "fleet_time": fleet.fleet_time, "hosts": hosts,
                 # "applied" = anything changed; "cell_applied" = the
                 # uniform (workers, prefetch) winner itself rolled out
                 # (False for a locality-only apply: hosts keep their
                 # current cells and only the chunk changes)
                 "cell_applied": won,
                 "locality_chunk": chunk_win,
                 "cache_budget_bytes": budget_win,
                 "applied": applied}
        self.events.append(event)
        if applied:
            # one common latch epoch: every host adopts the new chunk AND
            # the new cache plan for the SAME epoch even when producers
            # straddle a boundary (the interleaved order depends on both)
            latch = max(a.locality_latch_epoch() for a in agents) \
                if (chunk_win is not None or budget_win is not None) \
                else None
            for a in agents:
                nw, npf = fleet.uniform_params if won else a.param_cell()
                a.apply_params(nw, npf, locality_chunk=chunk_win,
                               locality_epoch=latch,
                               cache_budget_bytes=budget_win)
            # remember what went out: a host that was partitioned through
            # this push re-syncs from here on reconnect
            self._pushed = {
                "cell": list(fleet.uniform_params) if won else None,
                "schedule": to_wire(agents[0].schedule_state())}
        self._checkpoint()
        return event

    @staticmethod
    def _apportion(total: int, weights: Sequence[float]) -> List[int]:
        """Split ``total`` into ``len(weights)`` non-negative integer parts
        proportional to ``weights`` (largest-remainder), with every part
        clamped to >= 1 when ``total >= len(weights)`` — a host with a
        terrible measurement still needs a non-empty slice or it starves
        out of the lockstep.  Zero/degenerate weights fall back to an even
        split."""
        parts = len(weights)
        w = [max(0.0, float(x)) for x in weights]
        s = sum(w)
        if parts <= 0:
            return []
        if s <= 0 or not all(math.isfinite(x) for x in w):
            return ShardedSampler.even_split(total, parts)
        raw = [total * x / s for x in w]
        out = [int(math.floor(r)) for r in raw]
        if total >= parts:
            out = [max(1, v) for v in out]
        short = total - sum(out)
        if short > 0:
            order = sorted(range(parts), key=lambda i: raw[i] - out[i],
                           reverse=True)
            for i in range(short):
                out[order[i % parts]] += 1
        while short < 0:
            # min-1 clamping overshot: shave the largest parts back down
            j = max(range(parts), key=lambda i: out[i])
            if out[j] <= (1 if total >= parts else 0):
                break
            out[j] -= 1
            short += 1
        return out

    def _per_host_consensus(self, reason: str) -> Optional[Dict[str, Any]]:
        """Per-host (non-uniform) consensus: every host runs its own DPT
        sweep, adopts its own optimal (nWorker, nPrefetch), and the batch
        partition is re-apportioned so faster hosts take proportionally
        larger contiguous host-major slices (weights = measured samples/s
        at each host's optimum).  The partition lands fleet-wide through
        the same barrier protocol as a membership reshard — a partition-
        only change is safe at any common batch boundary."""
        hosts = sorted(h for h in self.agents
                       if h in set(self.registry.alive_hosts()))
        if not hosts:
            return None
        agents = [self.agents[h] for h in hosts]
        tuner = MultiHostDPT([a.evaluator for a in agents],
                             self._search_config())
        self._last_consensus_step = self.fleet_step
        for a in agents:
            a.begin_trials()
        try:
            fleet = tuner.run_per_host()
        except MemoryOverflow:
            self._backoff = min(self.cfg.max_backoff, self._backoff * 2)
            return None
        finally:
            for a in agents:
                a.end_trials()
        self.consensus_runs += 1
        by_shard = sorted(agents, key=lambda a: a.shard_index())
        order = {a.host: i for i, a in enumerate(by_shard)}
        gb = by_shard[0].global_batch()
        cur_sizes = by_shard[0].shard_sizes() \
            or ShardedSampler.even_split(gb, len(by_shard))
        # rate_i = local_i / optimal_time_i — what host i demonstrably
        # moves per second at its own optimum under its CURRENT slice
        rates = [0.0] * len(by_shard)
        for a, r in zip(agents, fleet.per_host):
            rates[order[a.host]] = (
                cur_sizes[order[a.host]] / r.optimal_time
                if r.optimal_time > 0 and math.isfinite(r.optimal_time)
                else 0.0)
        sizes = self._apportion(gb, rates)
        sizes_changed = sizes != cur_sizes
        cells_changed = any(
            (r.nworker, r.nprefetch) != a.param_cell()
            for a, r in zip(agents, fleet.per_host))
        applied = cells_changed or sizes_changed
        self._backoff = 1 if applied else min(self.cfg.max_backoff,
                                              self._backoff * 2)
        params_by_host = {a.host: (r.nworker, r.nprefetch)
                          for a, r in zip(agents, fleet.per_host)}
        event = {"kind": "consensus", "mode": "per_host", "reason": reason,
                 "params": [params_by_host[a.host] for a in by_shard],
                 "fleet_time": fleet.fleet_time, "hosts": hosts,
                 "sizes": sizes if sizes_changed else None,
                 "cell_applied": cells_changed, "applied": applied}
        if cells_changed:
            for a in agents:
                nw, npf = params_by_host[a.host]
                a.apply_params(nw, npf)
        if sizes_changed:
            rid = self.reshards
            event["barrier"] = self._negotiate_barrier(
                by_shard, len(by_shard), 0, rid=rid, sizes=sizes)
            self.reshards += 1
        self.events.append(event)
        if applied:
            self._pushed = {"cell": None,
                            "schedule": to_wire(agents[0].schedule_state())}
        self._checkpoint()
        return event

    @staticmethod
    def _current_cells(agents: Sequence[Any]) -> Dict[Tuple[int, int], int]:
        counts: Dict[Tuple[int, int], int] = {}
        for a in agents:
            key = a.param_cell()
            counts[key] = counts.get(key, 0) + 1
        return counts

    @classmethod
    def _majority_cell(cls, agents: Sequence[Any]) -> Tuple[int, int]:
        counts = cls._current_cells(agents)
        return max(counts, key=counts.get)

    def _locality_consensus(self, agents: Sequence[HostAgent],
                            cell: Tuple[int, int]) -> Optional[int]:
        """Uniform locality decision: per-host chunk sweeps at ``cell``,
        aggregated by the fleet max; the winner must beat the current
        chunk's own fleet time by ``min_improvement`` and be feasible on
        every host.  Returns the winning chunk or None (keep)."""
        if not self.cfg.locality_chunks:
            return None
        from repro_torch.tuning.locality import sweep_locality
        cfg = self._search_config()
        cur = agents[0].knob_state()["locality_chunk"]
        for a in agents:
            a.begin_trials()
        try:
            per_host = [sweep_locality(
                a.evaluator, nworker=cell[0], nprefetch=cell[1],
                chunks=self.cfg.locality_chunks, current_chunk=cur,
                num_batches=cfg.num_batches) for a in agents]
        finally:
            for a in agents:
                a.end_trials()
        fleet_time: Dict[int, float] = {}
        for trials in per_host:
            for chunk, t in trials.items():
                fleet_time[chunk] = max(fleet_time.get(chunk, 0.0),
                                        t.seconds)
        feasible = {c: s for c, s in fleet_time.items()
                    if math.isfinite(s)}
        if not feasible:
            return None
        best = min(feasible, key=feasible.get)
        if best == cur:
            return None
        if cur not in feasible:
            return best                   # current chunk infeasible somewhere
        if feasible[best] <= (1.0 - self.cfg.min_improvement) * feasible[cur]:
            return best
        return None

    def _cache_consensus(self, agents: Sequence[HostAgent],
                         cell: Tuple[int, int]) -> Optional[int]:
        """Uniform cache-budget decision (DESIGN.md §7): per-host budget
        sweeps at ``cell`` measured at a WARM epoch (a cross-epoch cache
        prices at 0 cold), aggregated by the fleet max; the winner must
        beat the current budget's own fleet time by ``min_improvement``
        and be feasible on every host.  Returns the winning budget or
        None (keep)."""
        if not self.cfg.cache_budgets:
            return None
        from repro_torch.tuning.locality import sweep_cache
        cfg = self._search_config()
        cur = agents[0].knob_state()["cache_budget_bytes"]
        for a in agents:
            a.begin_trials()
        try:
            per_host = [sweep_cache(
                a.evaluator, nworker=cell[0], nprefetch=cell[1],
                budgets=self.cfg.cache_budgets, current_budget=cur,
                num_batches=cfg.num_batches,
                epoch=max(1, cfg.epoch)) for a in agents]
        finally:
            for a in agents:
                a.end_trials()
        fleet_time: Dict[int, float] = {}
        for trials in per_host:
            for budget, t in trials.items():
                fleet_time[budget] = max(fleet_time.get(budget, 0.0),
                                         t.seconds)
        feasible = {b: s for b, s in fleet_time.items()
                    if math.isfinite(s)}
        if not feasible:
            return None
        best = min(feasible, key=feasible.get)
        if best == cur:
            return None
        if cur not in feasible:
            return best                  # current budget infeasible somewhere
        if feasible[best] <= (1.0 - self.cfg.min_improvement) * feasible[cur]:
            return best
        return None

    def _is_fleet_win(self, fleet, agents: Sequence[HostAgent]) -> bool:
        """Anti-churn at fleet scope: the uniform winner must differ from
        the current (majority) config and beat that config's own measured
        fleet time by ``min_improvement``."""
        current = self._current_cells(agents)
        cur_cell = max(current, key=current.get)
        if fleet.uniform_params == cur_cell and len(current) == 1:
            return False
        cur_times = []
        for r in fleet.per_host:
            t = next((t for t in r.trials
                      if (t.nworker, t.nprefetch) == cur_cell
                      and math.isfinite(t.seconds)), None)
            if t is None:
                return True          # current cell infeasible somewhere
            cur_times.append(t.seconds)
        cur_fleet = max(cur_times)
        return fleet.fleet_time \
            <= (1.0 - self.cfg.min_improvement) * cur_fleet

    # ---- act: elastic reshard ----------------------------------------------
    def _reshard_around(self, hosts: Sequence[str], *,
                        reason: str) -> Dict[str, Any]:
        """One or more hosts left the fleet (a rack failure is one event,
        not a cascade): remap every survivor at one common barrier and
        redistribute every departed host's undelivered slices.

        Crash-safe in HA mode: a write-ahead intent (lost hosts, their
        frozen consumed positions + member mirrors) is checkpointed
        BEFORE any command goes out, and again with the settled barrier +
        computed makeup shares before any share is dealt — a promoted
        standby replays the remainder with the SAME stable op-ids, which
        the agents' dedup turns into exactly-once application.
        """
        departed = [self.agents.pop(h) for h in hosts]
        for h in hosts:
            self.registry.remove(h)
            self.straggler.forget(h)
            self.reports.pop(h, None)
        rid = self.reshards
        consumed = {d.host: d.consumed_position() for d in departed}
        self._pending_reshard = {
            "rid": rid, "reason": reason, "stage": "begin",
            "lost": list(hosts), "consumed": dict(consumed),
            "departed": {d.host: d.ha_state() for d in departed}}
        self._checkpoint()
        return self._execute_reshard(departed, consumed,
                                     reason=reason, rid=rid)

    def _execute_reshard(self, departed: Sequence[Any],
                         consumed: Dict[str, int], *, reason: str,
                         rid: int) -> Dict[str, Any]:
        hosts = [d.host for d in departed]
        # survivors keep their relative order; shard indices compact
        survivors = sorted(self.agents.values(),
                           key=lambda a: a.shard_index())
        new_count = len(survivors)
        old_count = new_count + len(departed)
        event: Dict[str, Any] = {"kind": "reshard", "reason": reason,
                                 "lost": list(hosts), "host": hosts[0],
                                 "dead_consumed": consumed,
                                 "hosts": new_count}
        if not survivors:
            event.update(barrier=None, makeup_batches=0, plan=None)
            self.events.append(event)
            self._pending_reshard = None
            self._checkpoint()
            return event
        # the surviving hosts keep the OLD global batch until the geometry
        # latch below; when it does not divide the survivor count the
        # partition must go ragged (even_split) or the reshard would have
        # silently truncated samples (old bug: floor division dropped
        # global_batch % new_count samples from every batch)
        old_gb = survivors[0].global_batch()
        sizes: Optional[List[int]] = None
        if old_gb % new_count:
            sizes = ShardedSampler.even_split(old_gb, new_count)
        barrier = self._negotiate_barrier(
            survivors, new_count, max(consumed.values(), default=0),
            rid=rid, sizes=sizes)
        plan = plan_remesh(
            alive_hosts=new_count,
            devices_per_host=self.cfg.devices_per_host,
            model_axis=self.cfg.model_axis,
            old_hosts=old_count,
            old_global_batch=departed[0].global_batch(),
            restore_step=barrier)
        # elastic geometry: the plan's new_global_batch latches at the
        # next epoch boundary no survivor has entered yet (geometry moves
        # shard boundaries, so mid-epoch application would break exact
        # coverage; the ragged sizes above bridge the mid-epoch tail).
        # The latch epoch is FROZEN into the WAL before any host is
        # pushed: a replay after a partial push must re-issue the same
        # epoch everywhere or hosts would latch on divergent boundaries.
        geometry: Optional[Dict[str, int]] = None
        if (self.cfg.elastic_geometry and plan.feasible
                and plan.new_global_batch != old_gb):
            geometry = {
                "global_batch": int(plan.new_global_batch),
                "epoch": max(a.locality_latch_epoch() for a in survivors)}
        # makeup: every departed host's undelivered slices up to the
        # settled barrier, PLUS any makeup chunks a previous reshard dealt
        # to it that it never delivered (makeup parked on a corpse is
        # otherwise lost), re-chunked to each recipient's NEW local batch
        # size (so the chunks share the regular batch shape and can use
        # the re-specced arena; at most one ragged tail chunk bypasses
        # it) and dealt round-robin over survivors
        missing: List[np.ndarray] = []
        makeup_batches = 0
        for d in departed:
            for b in range(consumed[d.host], barrier):
                missing.append(d.local_indices_at(b))
                makeup_batches += 1
            inherited = d.undelivered_makeup()
            missing.extend(inherited)
            makeup_batches += len(inherited)
        shares: List[List[np.ndarray]] = [[] for _ in survivors]
        if missing:
            flat = np.concatenate(missing)
            local = (sizes if sizes is not None
                     else [old_gb // new_count] * new_count)
            pos, k = 0, 0
            while pos < len(flat):
                take = local[k % new_count]
                if take > 0:
                    shares[k % new_count].append(flat[pos:pos + take])
                    pos += take
                k += 1
        event.update(barrier=barrier, makeup_batches=makeup_batches,
                     plan=plan, sizes=sizes,
                     geometry_epoch=None if geometry is None
                     else geometry["epoch"])
        if self._pending_reshard is not None:
            self._pending_reshard.update(
                stage="deal", barrier=barrier, geometry=geometry,
                shares={a.host: [c.tolist() for c in share]
                        for a, share in zip(survivors, shares) if share},
                dealt=[],
                event=to_wire({**event, "plan": dataclasses.asdict(plan)}))
            self._checkpoint()
        if geometry is not None:
            for a in survivors:
                a.set_geometry(geometry["global_batch"],
                               epoch=geometry["epoch"],
                               op_id=f"reshard-{rid}-geom-{a.host}")
        self._deal_makeup(
            {a.host: share for a, share in zip(survivors, shares) if share},
            rid=rid)
        self.reshards += 1
        # the per-host optimum moved with the local batch size: follow the
        # reshard with a re-consensus for the new topology at next poll
        if self._forced_reason is None:
            self._forced_reason = "post-reshard"
        self.events.append(event)
        self._pending_reshard = None
        self._checkpoint()
        return event

    def _deal_makeup(self, shares: Dict[str, List[np.ndarray]], *,
                     rid: int) -> None:
        for host, share in shares.items():
            agent = self.agents.get(host)
            if agent is None:
                continue
            agent.add_makeup(share, op_id=f"reshard-{rid}-makeup-{host}")
            if self._pending_reshard is not None:
                self._pending_reshard["dealt"].append(host)
                self._checkpoint()

    # ---- survivability: snapshot / restore / replay ------------------------
    def _checkpoint(self) -> None:
        """Publish the full decide-state to the snapshot store (no-op in
        direct mode) — called on every state transition so a standby can
        resume from the last completed step."""
        if self._store is not None:
            self._store.put(self.state_dict())

    def state_dict(self) -> Dict[str, Any]:
        """Everything a standby needs to BE this coordinator: consensus
        history + backoff, heartbeat registry, straggler windows, the
        stale-report guard, member mirrors + dealt-makeup logs, the
        bounded event log (with its fleet-lifetime seq), the last uniform
        push, and any pending (write-ahead) reshard intent."""
        return to_wire({
            "config": dataclasses.asdict(self.cfg),
            "members": {h: a.ha_state() for h, a in self.agents.items()},
            "reports": {h: report_to_wire(r)
                        for h, r in self.reports.items()},
            "last_steps": dict(self._last_steps),
            "heartbeats": self.registry.state_dict(),
            "straggler": self.straggler.state_dict(),
            "events": self.events.state_dict(),
            "counters": {"consensus_runs": self.consensus_runs,
                         "reshards": self.reshards,
                         "last_consensus_step": self._last_consensus_step,
                         "backoff": self._backoff,
                         "forced_reason": self._forced_reason,
                         "stale_reports": self.stale_reports,
                         "fleet_faulted": self._fleet_faulted},
            "pushed": self._pushed,
            "pending_reshard": self._pending_reshard})

    @classmethod
    def restore(cls, state: Dict[str, Any], *,
                clock: Callable[[], float] = time.monotonic
                ) -> "FleetCoordinator":
        """Rebuild a coordinator from a snapshot.  Member proxies are
        materialized when a CoordinatorServer binds (they need a wire to
        speak through); until then membership lives in ``_member_state``.
        Historical events restore as plain dicts (ElasticPlan values
        become dicts — they are records, not live objects)."""
        cfgd = dict(state["config"])
        for k in ("locality_chunks", "cache_budgets"):
            if cfgd.get(k) is not None:
                cfgd[k] = tuple(cfgd[k])
        c = cls(config=FleetConfig(**cfgd), clock=clock)
        c._member_state = dict(state.get("members") or {})
        c.reports = {h: report_from_wire(r)
                     for h, r in (state.get("reports") or {}).items()}
        c._last_steps = {h: int(v)
                         for h, v in (state.get("last_steps") or {}).items()}
        c.registry.load_state(state.get("heartbeats") or {})
        c.straggler.load_state(state.get("straggler") or {})
        c.events = EventLog.restore(state.get("events") or {})
        counters = state.get("counters") or {}
        c.consensus_runs = int(counters.get("consensus_runs", 0))
        c.reshards = int(counters.get("reshards", 0))
        c._last_consensus_step = int(counters.get("last_consensus_step", 0))
        c._backoff = int(counters.get("backoff", 1))
        c._forced_reason = counters.get("forced_reason")
        c.stale_reports = int(counters.get("stale_reports", 0))
        c._fleet_faulted = bool(counters.get("fleet_faulted", False))
        c._pushed = state.get("pushed")
        c._pending_reshard = state.get("pending_reshard")
        return c

    def _bind_server(self, server: "CoordinatorServer") -> None:
        """Attach the message server: restore-time members materialize as
        RemoteAgent proxies, and heartbeats are re-armed at NOW so a
        failover gap longer than the timeout does not insta-kill every
        host (a truly dead host simply times out once more)."""
        self._server = server
        self._store = server.store
        if self._member_state is not None:
            for host, ms in self._member_state.items():
                proxy = RemoteAgent.restore(server, ms)
                proxy.coordinator = self
                self.agents[host] = proxy
            self._member_state = None
        self.registry.rearm(list(self.agents))

    def _resume_reshard(self) -> Optional[Dict[str, Any]]:
        """Replay a reshard the previous leader died inside (promotion
        path).  stage="begin": nothing was dealt — run it from the frozen
        intent.  stage="deal": the barrier settled and shares froze —
        re-deal only the un-acked shares under their original op-ids."""
        pr = self._pending_reshard
        if not pr or self._server is None:
            return None
        rid = int(pr["rid"])
        consumed = {h: int(v) for h, v in pr["consumed"].items()}
        departed = [RemoteAgent.restore(self._server, ms)
                    for ms in pr["departed"].values()]
        if pr.get("stage") == "begin":
            return self._execute_reshard(
                departed, consumed,
                reason=str(pr["reason"]) + "+replay", rid=rid)
        # stage == "deal"
        geometry = pr.get("geometry")
        if geometry is not None:
            # re-issue under the ORIGINAL frozen latch epoch and op-ids:
            # hosts already pushed dedupe on the op-id, the rest latch at
            # the same boundary the dead leader chose
            for a in sorted(self.agents.values(), key=lambda x: x.host):
                a.set_geometry(int(geometry["global_batch"]),
                               epoch=int(geometry["epoch"]),
                               op_id=f"reshard-{rid}-geom-{a.host}")
        dealt = set(pr.get("dealt") or [])
        shares = {h: [np.asarray(c, dtype=np.int64) for c in share]
                  for h, share in (pr.get("shares") or {}).items()
                  if h not in dealt}
        self._deal_makeup(shares, rid=rid)
        self.reshards += 1
        if self._forced_reason is None:
            self._forced_reason = "post-reshard"
        event = dict(pr.get("event") or {})
        event["reason"] = str(event.get("reason", "")) + "+replay"
        self.events.append(event)
        self._pending_reshard = None
        self._checkpoint()
        return event


# --------------------------------------------------------------------------
# the coordinator's message server + the standby replica
# --------------------------------------------------------------------------
class CoordinatorServer:
    """Binds a FleetCoordinator to a transport endpoint.

    Inbound: registration/join, (delta-encoded) reports, beats, drift and
    locality casts.  Outbound: every command the decide loop issues goes
    through :meth:`send`, stamped with the leader's fence token and a
    unique op-id — an agent that has seen a newer fence rejects the
    command (:class:`StaleLeaderError` marks this server deposed).

    Report handling keeps the per-host delta base server-side only: after
    a failover the new server simply answers ``need_full`` once and the
    protocol self-heals.  Reconnecting hosts are caught up from the
    coordinator's ``_pushed`` record (cell re-push + schedule sync).
    """

    def __init__(self, coord: FleetCoordinator, transport: LocalTransport, *,
                 name: str = "coord", owner: str = "coord-0",
                 lease: Optional[LeaderLease] = None,
                 store: Optional[SnapshotStore] = None,
                 retries: int = 6):
        self.coord = coord
        self.transport = transport
        self.name = name
        self.owner = owner
        self.lease = lease
        self.store = store
        self.retries = max(1, retries)
        self.fence = 0 if lease is None else (lease.acquire(owner) or 0)
        self.deposed = False
        self.crashed = False
        self._cmd_seq = 0
        self._last_full: Dict[str, Dict[str, Any]] = {}
        # traffic accounting for the O(hosts) heartbeat assertion
        self.report_full_msgs = 0
        self.report_full_bytes = 0
        self.report_delta_msgs = 0
        self.report_delta_bytes = 0
        transport.register(name, self.handle, replace=True)
        coord._bind_server(self)
        coord._checkpoint()

    # ---- leadership --------------------------------------------------------
    def tick(self) -> None:
        """Refresh the lease + checkpoint — the leader's heartbeat."""
        if self.crashed or self.deposed:
            return
        if self.lease is not None and not self.lease.refresh(self.owner):
            self.deposed = True
            return
        self.coord._checkpoint()

    def crash(self) -> None:
        """Simulated leader death: endpoint gone, lease left to expire."""
        self.crashed = True
        self.transport.unregister(self.name)

    def poll(self) -> List[Dict[str, Any]]:
        """Drive the decide loop, absorbing deposition: a stale-fence
        rejection anywhere inside means a newer leader owns the fleet —
        this one stops acting instead of fighting."""
        if self.crashed or self.deposed:
            return []
        try:
            actions = self.coord.poll()
        except StaleLeaderError:
            self.deposed = True
            return []
        self.coord._checkpoint()
        return actions

    # ---- outbound ----------------------------------------------------------
    def send(self, host: str, op: str, args: Dict[str, Any], *,
             op_id: Optional[str] = None) -> Any:
        self._cmd_seq += 1
        msg = {"kind": "cmd", "op": op, "args": to_wire(args),
               "fence": self.fence,
               "id": op_id or f"f{self.fence}-c{self._cmd_seq}"}
        last_err: Optional[str] = None
        for _ in range(self.retries):
            try:
                reply = self.transport.call(self.name, host, msg)
            except TransportError as e:
                last_err = str(e)
                continue
            if reply.get("ok"):
                return reply.get("result")
            err = str(reply.get("error", ""))
            if err == "stale-fence":
                self.deposed = True
                raise StaleLeaderError(
                    f"{self.name}(fence={self.fence}) deposed: {host} has "
                    f"seen fence {reply.get('fence')}")
            last_err = err
        raise TransportError(
            f"{self.name} -> {host}: {op} failed after "
            f"{self.retries} attempts ({last_err})")

    # ---- inbound -----------------------------------------------------------
    def handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        kind = msg.get("kind")
        host = str(msg.get("host", "?"))
        if kind == "report":
            return self._handle_report(host, msg)
        if kind == "beat":
            if host in self.coord.agents:
                self.coord.beat(host)
                return {"ok": True, "fence": self.fence}
            return {"ok": False, "evicted": True, "fence": self.fence}
        if kind == "register":
            proxy = RemoteAgent(self, msg["spec"])
            self.coord.register(proxy)
            self._last_full.pop(host, None)
            self.coord._checkpoint()
            return {"ok": True, "fence": self.fence}
        if kind == "join":
            proxy = RemoteAgent(self, msg["spec"])
            barrier = self.coord.join(proxy)
            self._last_full.pop(host, None)
            return {"ok": True, "fence": self.fence, "barrier": barrier}
        if kind == "leave":
            if host in self.coord.agents:
                self.coord.leave(host)
            return {"ok": True, "fence": self.fence}
        if kind == "drift":
            self.coord.request_consensus(
                reason=str(msg.get("reason", "drift")))
            return {"ok": True, "fence": self.fence}
        if kind == "locality":
            self.coord.request_locality(int(msg.get("chunk", 0)), host=host)
            return {"ok": True, "fence": self.fence}
        if kind == "ping":
            return {"ok": True, "fence": self.fence}
        return {"ok": False, "error": f"unknown kind {kind!r}",
                "fence": self.fence}

    def _handle_report(self, host: str,
                       msg: Dict[str, Any]) -> Dict[str, Any]:
        from repro_torch.tuning.transport import (merge_report_delta,
                                                  payload_bytes)
        proxy = self.coord.agents.get(host)
        if proxy is None:
            # resharded around during a partition: the host's shard no
            # longer exists — tell it so it can stop and (re)join
            return {"ok": False, "evicted": True, "fence": self.fence}
        if msg.get("delta"):
            base = self._last_full.get(host)
            if base is None or int(base.get("steps", -1)) \
                    != int(msg.get("base", -2)):
                return {"ok": False, "need_full": True, "fence": self.fence}
            fulls = [merge_report_delta(base, msg.get("patch") or {})]
            self.report_delta_msgs += 1
            self.report_delta_bytes += payload_bytes(msg)
        else:
            fulls = list(msg.get("reports") or [])
            self.report_full_msgs += 1
            self.report_full_bytes += payload_bytes(msg)
        accepted_any = False
        last_steps = -1
        for f in fulls:
            r = report_from_wire(f)
            if self.coord.ingest(r):
                accepted_any = True
                self._last_full[host] = {k: v for k, v in f.items()}
                if hasattr(proxy, "observe_report"):
                    proxy.observe_report(r, f.get("schedules"))
            last_steps = max(last_steps, r.steps)
        reply = {"ok": True, "fence": self.fence, "steps": last_steps}
        if accepted_any:
            self._catch_up(proxy)
        return reply

    def _catch_up(self, proxy: Any) -> None:
        """Schedule catch-up for a host that missed pushes while
        partitioned: re-issue the last uniform cell and/or schedules when
        the host's reported state disagrees with what the fleet runs."""
        pushed = self.coord._pushed
        if not pushed or not hasattr(proxy, "param_cell"):
            return
        try:
            cell = pushed.get("cell")
            if cell is not None and tuple(cell) != proxy.param_cell():
                proxy.apply_params(int(cell[0]), int(cell[1]))
            sched = pushed.get("schedule")
            if sched is not None:
                mine = to_wire(proxy.schedule_state())
                if (mine.get("locality"), mine.get("cache")) != \
                        (sched.get("locality"), sched.get("cache")):
                    proxy.sync_schedules(sched)
        except TransportError:
            pass        # still flaky — the next accepted report retries


class CoordinatorReplica:
    """A standby coordinator: watches the lease, and when the primary's
    lease expires, acquires it (fence bump), restores the last snapshot,
    takes over the transport endpoint and replays any pending reshard.
    The promotion is the failover state machine's only transition:
    standby -> leader; a deposed old leader discovers its fate through
    stale-fence rejections."""

    def __init__(self, transport: LocalTransport, lease: LeaderLease,
                 store: SnapshotStore, *, owner: str = "coord-standby",
                 name: str = "coord",
                 clock: Callable[[], float] = time.monotonic):
        self.transport = transport
        self.lease = lease
        self.store = store
        self.owner = owner
        self.name = name
        self.clock = clock
        self.server: Optional[CoordinatorServer] = None
        self.promoted = False

    def tick(self) -> Optional[CoordinatorServer]:
        """Returns the new server on the tick that promotes, else None."""
        if self.promoted:
            return None
        if self.lease.holder() is not None:
            return None                       # primary still refreshing
        state = self.store.get()
        if state is None:
            return None
        fence = self.lease.acquire(self.owner)
        if fence is None:
            return None
        coord = FleetCoordinator.restore(state, clock=self.clock)
        server = CoordinatorServer(coord, self.transport, name=self.name,
                                   owner=self.owner, lease=self.lease,
                                   store=self.store)
        server.fence = fence
        coord.events.append({"kind": "promote", "owner": self.owner,
                             "fence": fence})
        # replay any reshard the old leader died inside; a host that is
        # unreachable RIGHT NOW must not fail the promotion — the intent
        # stays write-ahead-logged and the new leader's poll resumes it
        coord._absorb_transport(coord._resume_reshard)
        coord._checkpoint()
        self.server = server
        self.promoted = True
        return server


def connect_host(transport: LocalTransport, host: str, loader: DataLoader, *,
                 evaluator=None, coord: str = "coord",
                 link_config: Optional["LinkConfig"] = None,
                 clock: Callable[[], float] = time.monotonic,
                 join: bool = False, consumes_stream: bool = True,
                 **agent_kw: Any) -> HostAgent:
    """Construct a transport-attached :class:`HostAgent` and announce it.

    The one-call fleet entry point for Trainer/serving hosts:
    ``register`` (fleet start) or ``join=True`` (mid-run admission —
    incumbents reshard and this host aligns at the returned barrier).
    Raises :class:`TransportError` when the coordinator is unreachable
    after retries — admission is the only send that may block/raise; all
    steady-state traffic after this is fire-and-forget."""
    from repro_torch.tuning.transport import LinkConfig as _LinkConfig
    link = AgentLink(transport, host, coord=coord,
                     config=link_config or _LinkConfig(), clock=clock)
    agent = HostAgent(host, loader, evaluator=evaluator, link=link,
                      consumes_stream=consumes_stream, **agent_kw)
    (link.join if join else link.register)()
    return agent
