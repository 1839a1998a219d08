"""The port's survivable control plane on the CPU: the cases of
tests/test_transport.py on ``repro_torch.tuning.transport`` /
``repro_torch.tuning.fleet`` with the port's loaders (transport
primitives, the host link's partition tolerance, coordinator fencing,
snapshot/restore, the standby failover state machine), and parity with
``repro``: the wire encodings, a seeded ``FaultyTransport``'s faults and a
``WireFleet`` failover's fences, stale-leader rejections and makeup deal
are the same in both packages.

Everything runs over the in-process LocalTransport/FaultyTransport with
fake clocks, so every partition, crash, and promotion is deterministic.
"""
import dataclasses

import numpy as np
import pytest

from _torch_support import (WireFleet, fleet_factory,  # noqa: F401
                            fleet_loader, fleet_modules, flat_indices,
                            make_index_dataset, make_table_evaluator,
                            wire_fleet)

from repro_torch.data import LoaderParams
from repro_torch.tuning import (FaultSpec, FaultyTransport, FleetConfig,
                                FleetCoordinator, LeaderLease, LinkConfig,
                                LocalTransport, SnapshotStore,
                                StaleLeaderError, TransportError,
                                connect_host)
from repro_torch.tuning.fleet import CoordinatorServer, EventLog, HostReport
from repro_torch.tuning.transport import (AgentLink, encode_report_delta,
                                          merge_report_delta, payload_bytes,
                                          to_wire)


# --------------------------------------------------------------------------
# wire encoding
# --------------------------------------------------------------------------
def test_torch_to_wire_normalizes_everything():
    @dataclasses.dataclass
    class Rec:
        xs: tuple
        arr: np.ndarray

    wire = to_wire({"rec": Rec((1, 2), np.arange(3, dtype=np.int64)),
                    "scalar": np.float64(1.5),
                    3: "int-key"})
    assert wire == {"rec": {"xs": [1, 2], "arr": [0, 1, 2]},
                    "scalar": 1.5, "3": "int-key"}
    # JSON-able end to end — what a real wire requires
    assert payload_bytes(wire) > 0


def _report_dict(steps, *, consumed=None, io=None):
    return to_wire({
        "host": "h0", "steps": steps,
        "consumed": consumed if consumed is not None else steps,
        "position": steps + 2, "stall_ratio": 0.1, "steps_per_s": 20.0,
        # rolling window: one append per step, newest 8 retained
        "batch_seconds": [0.05 * (i + 1) for i in range(steps)][-8:],
        "params": [2, 2], "io": io, "makeup_done": 0})


def test_torch_report_delta_roundtrip_and_smaller():
    base = _report_dict(8, io={"storage_requests": 64.0, "run_len": 8.0})
    cur = _report_dict(9, io={"storage_requests": 72.0, "run_len": 8.0})
    delta = encode_report_delta(base, cur)
    assert merge_report_delta(base, delta) == cur
    # only the changed io key crosses; the rolling window sends its tail
    assert delta["io"] == {"storage_requests": 72.0}
    assert len(delta["bs_tail"]) == 1
    wire = {"kind": "report", "host": "h0", "delta": True,
            "base": 8, "patch": delta}
    full = {"kind": "report", "host": "h0", "reports": [cur]}
    assert payload_bytes(wire) < payload_bytes(full)


def test_torch_report_delta_identical_report_is_empty():
    base = _report_dict(8)
    assert encode_report_delta(base, dict(base)) == {}


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------
def _echo_transport(faults=None):
    t = FaultyTransport(faults or FaultSpec())
    calls = []
    t.register("dst", lambda m: calls.append(m) or {"ok": True})
    return t, calls


def test_torch_faulty_transport_deterministic_by_seed():
    def outcomes(seed):
        t, _ = _echo_transport(FaultSpec(drop=0.3, delay=0.2, duplicate=0.2,
                                         reply_drop=0.2, seed=seed))
        out = []
        for i in range(40):
            try:
                t.call("src", "dst", {"kind": "m", "i": i})
                out.append("ok")
            except TransportError as e:
                out.append(str(e).split(": ")[-1])
        return out

    assert outcomes(7) == outcomes(7)
    assert outcomes(7) != outcomes(8)


def test_torch_partition_cuts_both_ways_and_heals():
    t, calls = _echo_transport()
    t.register("src", lambda m: {"ok": True})
    t.partition("src", "dst")
    for a, b in (("src", "dst"), ("dst", "src")):
        with pytest.raises(TransportError, match="partition"):
            t.call(a, b, {"kind": "m"})
    t.heal("src")
    assert t.call("src", "dst", {"kind": "m"})["ok"]
    assert len(calls) == 1


def test_torch_delayed_message_arrives_stale_at_pump():
    t, calls = _echo_transport(FaultSpec(delay=1.0))
    with pytest.raises(TransportError, match="delayed"):
        t.call("src", "dst", {"kind": "m", "i": 0})
    assert calls == []                     # parked, not delivered
    assert t.pump() == 1                   # ... until pumped
    assert calls == [{"kind": "m", "i": 0}]
    assert t.pump() == 0                   # delivered once, not forever


# --------------------------------------------------------------------------
# lease + snapshot store
# --------------------------------------------------------------------------
def test_torch_lease_fence_monotonic_across_acquisitions():
    clock = [0.0]
    lease = LeaderLease(ttl_s=5.0, clock=lambda: clock[0])
    assert lease.acquire("a") == 1
    assert lease.acquire("b") is None      # held
    assert lease.acquire("a") == 1         # holder re-acquire = refresh
    clock[0] += 6.0                        # expire
    assert lease.holder() is None
    assert lease.acquire("b") == 2         # fence strictly increases
    assert not lease.refresh("a")          # deposed holder cannot refresh
    assert lease.refresh("b")


def test_torch_snapshot_store_never_aliases_live_state():
    store = SnapshotStore()
    state = {"xs": [1, 2]}
    seq = store.put(state)
    state["xs"].append(3)                  # live mutation after the put
    assert store.get() == {"xs": [1, 2]}
    got = store.get()
    got["xs"].append(9)                    # reader mutation
    assert store.get() == {"xs": [1, 2]}
    assert store.put(state) == seq + 1


# --------------------------------------------------------------------------
# the host link
# --------------------------------------------------------------------------
class _Sink:
    """Minimal coordinator endpoint: acks reports, records them."""

    def __init__(self, transport, *, fence=0):
        self.fence = fence
        self.reports = []
        self.need_full_once = False
        transport.register("coord", self.handle, replace=True)

    def handle(self, msg):
        if msg.get("kind") == "report":
            if msg.get("delta") and self.need_full_once:
                self.need_full_once = False
                return {"ok": False, "need_full": True, "fence": self.fence}
            self.reports.append(msg)
            return {"ok": True, "fence": self.fence}
        return {"ok": True, "fence": self.fence}


class _CmdAgent:
    """Records handle_command invocations (the link dispatches to this)."""

    def __init__(self):
        self.calls = []

    def handle_command(self, op, args):
        self.calls.append((op, dict(args)))
        return {"seen": len(self.calls)}


def test_torch_link_bounded_queue_backoff_never_blocks():
    clock = [0.0]
    t = LocalTransport()
    _Sink(t)
    link = AgentLink(t, "h0", config=LinkConfig(max_queue=4, retries=2,
                                                backoff_s=1.0, jitter=0.0),
                     clock=lambda: clock[0])
    link.agent = _CmdAgent()
    t.unregister("coord")                  # the coordinator goes away
    sent_calls_before = t.sent_msgs
    for i in range(10):
        assert not link.send_report(_report_dict(i))
        clock[0] += 0.01                   # backoff window: most sends park
    # bounded: the queue holds the newest 4, the overflow was counted
    assert len(link._pending) == 4
    assert link.dropped_reports == 6
    assert not link.connected
    # backoff: only the first send actually attempted delivery; the rest
    # parked without a flush.  Nothing was accounted as wire traffic —
    # connection-refused fails fast, pre-serialization, so a dead
    # coordinator costs the training loop ~nothing
    assert link.send_failures == 1
    assert t.sent_msgs == sent_calls_before
    # exponential growth capped
    assert link._backoff == min(link.cfg.max_backoff_s,
                                1.0 * link.cfg.backoff_mult)


def test_torch_link_replays_backlog_in_order_on_reconnect():
    clock = [0.0]
    t = FaultyTransport()
    sink = _Sink(t)
    link = AgentLink(t, "h0", config=LinkConfig(max_queue=8, retries=1,
                                                backoff_s=0.1, jitter=0.0),
                     clock=lambda: clock[0])
    link.agent = _CmdAgent()
    assert link.send_report(_report_dict(1))
    t.partition("h0", "coord")
    for i in range(2, 5):
        clock[0] += 1.0
        link.send_report(_report_dict(i))
    t.heal("h0", "coord")
    clock[0] += 1.0
    assert link.send_report(_report_dict(5))
    # the reconnect message carried the whole parked backlog, in order
    replay = sink.reports[-1]["reports"]
    assert [r["steps"] for r in replay] == [2, 3, 4, 5]
    assert link.connected


def test_torch_link_delta_protocol_self_heals_on_need_full():
    clock = [0.0]
    t = LocalTransport()
    sink = _Sink(t)
    link = AgentLink(t, "h0", config=LinkConfig(jitter=0.0),
                     clock=lambda: clock[0])
    link.agent = _CmdAgent()
    link.send_report(_report_dict(1))      # first is always full
    link.send_report(_report_dict(2))      # then deltas
    assert link.full_sent == 1 and link.delta_sent == 1
    sink.need_full_once = True             # a failed-over server lost the base
    link.send_report(_report_dict(3))
    assert link.full_sent == 2             # one full resend, no operator help
    link.send_report(_report_dict(4))
    assert link.delta_sent == 2            # ... and deltas resume


def test_torch_link_rejects_stale_fence_and_dedups_commands():
    t = LocalTransport()
    _Sink(t, fence=3)
    agent = _CmdAgent()
    link = AgentLink(t, "h0").bind(agent)
    link.fence = 3
    cmd = {"kind": "cmd", "op": "apply_params", "args": {"nworker": 4},
           "fence": 3, "id": "op-1"}
    r1 = t.call("coord", "h0", cmd)
    r2 = t.call("coord", "h0", dict(cmd))          # duplicate delivery
    assert r1["ok"] and r2 == r1
    assert len(agent.calls) == 1                   # executed exactly once
    stale = t.call("coord", "h0", {"kind": "cmd", "op": "apply_params",
                                   "args": {}, "fence": 2, "id": "op-0"})
    assert not stale["ok"] and stale["error"] == "stale-fence"
    assert len(agent.calls) == 1                   # never reached the agent
    assert link.rejected[-1]["fence"] == 2
    # a NEWER fence is adopted: the link follows the new leader
    t.call("coord", "h0", {"kind": "cmd", "op": "ping", "args": {},
                           "fence": 5, "id": "op-2"})
    assert link.fence == 5


# --------------------------------------------------------------------------
# coordinator satellites: per-instance config, ingest guard, event ring,
# barrier cap
# --------------------------------------------------------------------------
def test_torch_fleet_config_not_shared_between_coordinators():
    a, b = FleetCoordinator(), FleetCoordinator()
    assert a.cfg is not b.cfg
    a.cfg.heartbeat_timeout_s = 1.0
    assert b.cfg.heartbeat_timeout_s == 30.0


def _mk_report(steps, *, consumed=None, batch_s=0.05):
    return HostReport(host="h0", steps=steps,
                      consumed=consumed if consumed is not None else steps,
                      position=steps + 2, stall_ratio=0.0, steps_per_s=20.0,
                      batch_seconds=[batch_s], params=(2, 2))


def test_torch_ingest_rejects_stale_and_duplicate_reports():
    clock = [0.0]
    coord = FleetCoordinator(config=FleetConfig(heartbeat_timeout_s=5.0),
                             clock=lambda: clock[0])
    assert coord.ingest(_mk_report(5))
    straggler_windows = len(coord.straggler.state_dict().get("h0", []))
    # a duplicate and a reordered replay: rejected, bookkeeping frozen
    assert not coord.ingest(_mk_report(5, batch_s=9.0))
    assert not coord.ingest(_mk_report(3, consumed=1, batch_s=9.0))
    assert coord.stale_reports == 2
    assert coord.reports["h0"].consumed == 5       # never rewound
    assert len(coord.straggler.state_dict()["h0"]) == straggler_windows
    # ... but stale bytes still arrived NOW: they count as liveness
    clock[0] += 4.0
    assert not coord.ingest(_mk_report(5))
    assert "h0" in coord.registry.alive_hosts()
    # fresh progress is accepted again
    assert coord.ingest(_mk_report(6))
    assert coord.reports["h0"].steps == 6


def test_torch_ingest_guard_resets_for_a_reregistered_host(fleet_factory):
    fleet = fleet_factory(hosts=2)
    agent = fleet.agents[0]
    for _ in range(3):
        next(fleet.streams[0])
        agent.observe(data_s=0.001, step_s=0.05)
    assert fleet.coord._last_steps[agent.host] == 3
    # the host restarts: steps counter rewinds to 1 — re-registration must
    # not leave its new life permanently muted
    agent.steps = 0
    fleet.coord.register(agent)
    next(fleet.streams[0])
    agent.observe(data_s=0.001, step_s=0.05)
    assert fleet.coord.reports[agent.host].steps == 1


def test_torch_event_log_ring_bounded_with_stable_seq():
    log = EventLog(max_events=4)
    for i in range(10):
        log.append({"kind": "e", "i": i})
    assert len(log) == 4
    assert [e["i"] for e in log] == [6, 7, 8, 9]
    assert [e["seq"] for e in log] == [6, 7, 8, 9]  # fleet-lifetime numbering
    assert log.next_seq == 10
    # list-ish surface the benches/tests rely on
    assert log[-1]["i"] == 9 and log[1:3][0]["i"] == 7 and bool(log)
    # the HA snapshot carries the ring AND the monotonic counter
    back = EventLog.restore(log.state_dict())
    assert [e["i"] for e in back] == [6, 7, 8, 9]
    back.append({"kind": "e", "i": 10})
    assert back[-1]["seq"] == 10


def test_torch_coordinator_event_log_is_bounded():
    coord = FleetCoordinator(config=FleetConfig(max_events=8))
    for i in range(100):
        coord.events.append({"kind": "noise", "i": i})
    assert len(coord.events) == 8
    assert coord.events[-1]["seq"] == 99


class _BarrierRacer:
    """A misbehaving agent that raises its effective barrier forever."""

    def __init__(self, host):
        self.host = host
        self.calls = 0

    def stream_position(self):
        return 0

    def reshard(self, num_shards, shard, *, at_batch=None, makeup=None,
                sizes=None, op_id=None):
        self.calls += 1
        return (at_batch or 0) + 1


def test_torch_barrier_negotiation_caps_reissue_loop():
    coord = FleetCoordinator(config=FleetConfig(max_barrier_rounds=5))
    racer = _BarrierRacer("evil")
    with pytest.raises(RuntimeError, match="5 rounds"):
        coord._negotiate_barrier([racer], 1, 0)
    assert racer.calls == 5


# The transport-mode fleet harness (``WireFleet`` / ``wire_fleet``) lives
# in _torch_support.py — test_torch_fleet_properties.py's matrix drives
# the same machinery.

# --------------------------------------------------------------------------
# HA: snapshot/restore, partition tolerance, failover, fencing
# --------------------------------------------------------------------------
def test_torch_coordinator_state_dict_restore_roundtrip(wire_fleet):
    fleet = wire_fleet()
    fleet.rounds(5)
    state = fleet.coord.state_dict()
    back = FleetCoordinator.restore(state, clock=lambda: fleet.clock[0])
    assert back.cfg == fleet.coord.cfg
    assert sorted(back.reports) == sorted(fleet.coord.reports)
    assert back._last_steps == fleet.coord._last_steps
    assert back.events.next_seq == fleet.coord.events.next_seq
    assert back.reshards == fleet.coord.reshards
    # members materialize as proxies when a server binds
    server2 = CoordinatorServer(back, LocalTransport(), name="coord2",
                                owner="coord-1")
    assert sorted(back.agents) == sorted(fleet.coord.agents)
    for h, proxy in back.agents.items():
        live = fleet.coord.agents[h]
        assert proxy.param_cell() == live.param_cell()
        assert proxy.shard_index() == live.shard_index()
        assert proxy.batches_per_epoch() == live.batches_per_epoch()
    assert server2.fence == 0
    # restore normalized through the wire: a snapshot is JSON, not objects
    assert payload_bytes(state) > 0


def test_torch_partitioned_host_keeps_streaming_and_resyncs(wire_fleet):
    fleet = wire_fleet()
    fleet.rounds(3)
    link = fleet.agents[2].link
    fleet.transport.partition("host2", "coord")
    # the host never blocks: it keeps pulling batches on latched params
    # while every report parks in the bounded queue
    fleet.rounds(3)
    assert not link.connected
    assert len(link._pending) > 0
    pos_during = fleet.streams[2].position
    assert pos_during >= 6                  # streamed right through the cut
    # while it was gone, the fleet pushed new uniform params
    for i in (0, 1):
        fleet.agents[i].apply_params(4, 1)
    fleet.coord._pushed = {"cell": [4, 1], "schedule": None}
    fleet.transport.heal("host2", "coord")
    fleet.rounds(2)
    # reconnect: backlog replayed, report accepted, catch-up re-pushed the
    # cell the host missed
    assert link.connected
    assert fleet.agents[2].param_cell() == (4, 1)
    assert "host2" in fleet.coord.reports


def test_torch_failover_promotes_standby_with_fresh_fence(wire_fleet):
    fleet = wire_fleet()
    fleet.rounds(4)
    old_server = fleet.server
    old_fence = old_server.fence
    old_server.crash()
    # outage: hosts keep streaming; lease expires; standby promotes
    fleet.rounds(6)
    assert fleet.replica.promoted
    assert fleet.server is not old_server
    assert fleet.server.fence > old_fence
    assert sorted(fleet.coord.agents) == ["host0", "host1", "host2"]
    # every host followed the new leader...
    fleet.rounds(2)
    assert all(a.link.fence == fleet.server.fence for a in fleet.agents)
    # ... and the deposed leader's commands are rejected everywhere
    with pytest.raises(StaleLeaderError):
        old_server.send("host0", "ping", {})
    assert old_server.deposed
    assert fleet.agents[0].link.rejected[-1]["fence"] == old_fence
    # the promotion is on the record with the fleet-lifetime seq intact
    kinds = [e["kind"] for e in fleet.coord.events]
    assert "promote" in kinds
    # no host was declared dead by the outage itself (registry re-armed)
    assert not fleet.coord.registry.dead_hosts()
    fleet.drain(range(3))
    assert flat_indices(fleet.delivered) == list(range(fleet.n))


def test_torch_failover_completes_epoch_after_host_death(wire_fleet):
    """Primary crashes BEFORE it can react to a dead host: the promoted
    standby detects the death from restored state, reshards the survivors
    over the wire, and the epoch still covers every index exactly once."""
    fleet = wire_fleet(heartbeat_timeout=4.0)
    fleet.rounds(3)
    fleet.server.crash()
    # host2 dies during the outage
    fleet.rounds(2, alive=[0, 1])
    fleet.rounds(8, alive=[0, 1])          # promote + detect + reshard
    assert fleet.replica.promoted
    reshards = [e for e in fleet.coord.events if e["kind"] == "reshard"]
    assert len(reshards) == 1 and reshards[0]["lost"] == ["host2"]
    fleet.drain([0, 1])
    assert flat_indices(fleet.delivered) == list(range(fleet.n))


def test_torch_leader_crash_mid_makeup_deal_is_exactly_once(wire_fleet):
    """The WAL + op-id dedup contract: the leader dies after dealing SOME
    makeup shares; the promoted standby re-deals only the rest, and a
    share that was already applied is never applied twice."""
    fleet = wire_fleet(heartbeat_timeout=4.0)
    fleet.rounds(3)

    # make host1 execute-but-drop-reply on add_makeup: the deal applies,
    # the leader sees a timeout (the two-generals corner the op-ids exist
    # for), and _reshard_around raises out of the deal loop
    real = fleet.transport._endpoints["host1"]
    state = {"fail": True}

    def flaky(msg):
        reply = real(msg)
        if state["fail"] and msg.get("kind") == "cmd" \
                and msg.get("op") == "add_makeup":
            raise TransportError("host1: reply dropped")
        return reply

    fleet.transport.register("host1", flaky, replace=True)

    # host2 dies; the leader's next polls detect it and start the reshard
    for _ in range(10):
        fleet.rounds(1, alive=[0, 1])
        if fleet.coord._pending_reshard is not None \
                or any(e["kind"] == "reshard" for e in fleet.coord.events):
            break
    # the deal was interrupted: the write-ahead intent survived
    pending = fleet.coord._pending_reshard
    assert pending is not None and pending["stage"] == "deal"
    applied_before = {h: fleet.agents[i]._makeup_added
                      for i, h in ((0, "host0"), (1, "host1"))}
    assert any(v > 0 for v in applied_before.values())

    fleet.server.crash()
    state["fail"] = False                   # the wire heals with the old
    fleet.transport.register("host1", real, replace=True)  # leader dead
    fleet.rounds(8, alive=[0, 1])           # standby promotes + replays
    assert fleet.replica.promoted
    assert fleet.coord._pending_reshard is None
    replayed = [e for e in fleet.coord.events if e["kind"] == "reshard"]
    assert len(replayed) == 1 and replayed[0]["reason"].endswith("+replay")

    # exactly-once: host1's flaky share was NOT re-applied (op-id dedup
    # returned the cached ack), host0 kept its single application
    shares = {h: len(s) for h, s in (pending.get("shares") or {}).items()}
    for i, h in ((0, "host0"), (1, "host1")):
        assert fleet.agents[i]._makeup_added == shares.get(h, 0)
    fleet.drain([0, 1])
    assert flat_indices(fleet.delivered) == list(range(fleet.n))


def test_torch_live_leader_resumes_interrupted_deal(wire_fleet):
    """Same interrupted reshard, but the leader SURVIVES: its own next
    poll resumes the write-ahead intent once the wire heals — failover is
    not required for the fleet to finish a reshard.  The cut is inbound-
    only (host1 still reports, its commands bounce) so the host stays
    alive while the reshard around dead host2 cannot reach it."""
    fleet = wire_fleet(heartbeat_timeout=4.0)
    fleet.rounds(3)
    real = fleet.transport._endpoints["host1"]
    state = {"cut": True}

    def inbound_cut(msg):
        if state["cut"] and msg.get("kind") == "cmd":
            raise TransportError("host1: unreachable for commands")
        return real(msg)

    fleet.transport.register("host1", inbound_cut, replace=True)
    for _ in range(10):
        fleet.rounds(1, alive=[0, 1])      # host2 goes silent and dies
        if fleet.coord._pending_reshard is not None:
            break
    assert fleet.coord._pending_reshard is not None
    assert not any(e["kind"] == "reshard" for e in fleet.coord.events)
    state["cut"] = False
    fleet.rounds(2, alive=[0, 1])
    assert fleet.coord._pending_reshard is None
    assert any(e["kind"] == "reshard" for e in fleet.coord.events)
    fleet.drain([0, 1])
    assert flat_indices(fleet.delivered) == list(range(fleet.n))


def test_torch_wire_fleet_consensus_and_heartbeat_traffic_is_delta(wire_fleet):
    """Steady-state heartbeat traffic is O(hosts): after the first beat
    every report crosses as a delta, measurably smaller than the fulls,
    and a consensus runs end-to-end over the wire (remote evaluators)."""
    fleet = wire_fleet()
    fleet.coord.request_consensus(reason="startup")
    fleet.rounds(8)
    assert fleet.coord.consensus_runs >= 1
    cell = {a.param_cell() for a in fleet.agents}
    assert len(cell) == 1                   # uniform push landed everywhere
    srv = fleet.server
    assert srv.report_delta_msgs > srv.report_full_msgs
    assert (srv.report_delta_bytes / max(1, srv.report_delta_msgs)) < \
        (srv.report_full_bytes / max(1, srv.report_full_msgs))
    fleet.drain(range(3))
    assert flat_indices(fleet.delivered) == list(range(fleet.n))


def test_torch_evicted_host_stops_and_rejoins_cleanly(wire_fleet):
    """A partition OUTLASTING the heartbeat timeout gets the host
    resharded around; on heal the host learns it was evicted (stops
    reporting) and can rejoin as a fresh member."""
    fleet = wire_fleet(heartbeat_timeout=3.0)
    fleet.rounds(3)
    fleet.transport.partition("host2", "coord")
    for _ in range(12):
        fleet.rounds(1, alive=[0, 1])      # host2's old batches are void:
        if any(e["kind"] == "reshard" for e in fleet.coord.events):
            break
    assert any(e["kind"] == "reshard" for e in fleet.coord.events)
    fleet.transport.heal("host2", "coord")
    link2 = fleet.agents[2].link
    link2.send_report(fleet.agents[2].report_wire())
    assert link2.evicted and not link2.connected
    assert "host2" not in fleet.coord.agents
    # rejoin with a FRESH stream (the old shard map is void)
    fleet.streams[2].close()
    dl = fleet_loader(make_index_dataset(fleet.n), fleet.gb, shuffle=True,
                      seed=5, params=LoaderParams(num_workers=2,
                                                  prefetch_factor=2),
                      host_index=2, host_count=3)
    fleet.agents[2] = connect_host(
        fleet.transport, "host2", dl,
        evaluator=make_table_evaluator(lambda i, j: 4.0 / i + 0.1 * j),
        clock=lambda: fleet.clock[0], join=True,
        link_config=LinkConfig(seed=2, jitter=0.0))
    fleet.streams[2] = dl.stream(to_device=False)
    assert "host2" in fleet.coord.agents
    fleet.rounds(2)
    assert fleet.agents[2].link.connected


# --------------------------------------------------------------------------
# parity with repro: encodings, seeded faults, a failover scenario
# --------------------------------------------------------------------------
def _both_transports():
    import repro.tuning.transport as jt
    import repro_torch.tuning.transport as tt
    return jt, tt


@pytest.mark.parametrize("steps", [1, 8, 9, 20])
def test_torch_wire_encodings_match_repro(steps):
    """``to_wire``, ``encode_report_delta`` / ``merge_report_delta`` and
    ``payload_bytes`` give identical values for identical inputs."""
    @dataclasses.dataclass
    class Rec:
        xs: tuple
        arr: np.ndarray

    obj = {"rec": Rec((1, steps), np.arange(steps, dtype=np.int64)),
           "f": np.float32(0.25 * steps), "i": np.int64(steps), 7: "key",
           "nested": [(np.int32(1), {"a": np.ones(2)})]}
    base = _report_dict(steps, io={"storage_requests": 8.0 * steps,
                                   "run_len": 8.0})
    cur = _report_dict(steps + 1, io={"storage_requests": 8.0 * steps + 8,
                                      "run_len": 8.0, "fault_rate": 0.0})
    out = []
    for mod in _both_transports():
        delta = mod.encode_report_delta(base, cur)
        out.append((mod.to_wire(obj), delta, mod.merge_report_delta(
            base, delta), mod.payload_bytes({"patch": delta}),
            mod.payload_bytes(mod.to_wire(obj))))
    assert out[0] == out[1]
    assert out[1][2] == cur


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_torch_faulty_transport_faults_match_repro(seed):
    """A seeded ``FaultyTransport`` drops, delays, duplicates and drops
    the replies of the same messages in both packages: the per-message
    outcomes, the deliveries (duplicates included), what a pump releases
    and the traffic counters are equal."""
    runs = []
    for mod in _both_transports():
        t = mod.FaultyTransport(mod.FaultSpec(drop=0.2, delay=0.15,
                                              duplicate=0.2, reply_drop=0.1,
                                              seed=seed))
        got = []
        t.register("dst", lambda m, got=got: got.append(m["i"])
                   or {"ok": True})
        t.register("src", lambda m: {"ok": True})
        outcomes = []
        for i in range(60):
            if i == 30:
                t.partition("src", "dst")
            if i == 36:
                t.heal("src")
            try:
                t.call("src", "dst", {"kind": "m", "i": i})
                outcomes.append("ok")
            except mod.TransportError as e:
                outcomes.append(str(e).split(": ")[-1])
        pumped = t.pump()
        runs.append((outcomes, got, pumped, dict(t.kind_msgs)))
    assert runs[0] == runs[1]
    outcomes = runs[1][0]
    for fault in ("ok", "partition"):
        assert any(fault in o for o in outcomes), outcomes
    assert len(set(outcomes)) >= 4           # several kinds of fault fired
    assert len(runs[1][1]) > len(set(runs[1][1]))   # duplicates delivered


def _failover_run(port):
    """``WireFleet`` over a faulty wire: the leader crashes, the standby
    promotes, host2 dies after the failover and is resharded around.
    Returns the fences, the stale-leader rejections, the reshard's makeup
    deal and each host's delivered indices."""
    _, tuning, fleet_mod, _ = fleet_modules(port)
    fleet = WireFleet(port=port, heartbeat_timeout=4.0,
                      faults=tuning.FaultSpec(drop=0.03, delay=0.02,
                                              duplicate=0.03, seed=11))
    deal = {}
    for a in fleet.agents:
        def add_makeup(makeup, *, op_id=None, a=a, real=a.add_makeup):
            deal.setdefault(a.host, []).extend(
                np.asarray(c).tolist() for c in makeup)
            return real(makeup, op_id=op_id)
        a.add_makeup = add_makeup
    try:
        fleet.rounds(4)
        old = fleet.server
        old_fence = old.fence
        old.crash()
        fleet.rounds(7)
        assert fleet.replica.promoted
        rejected = []
        try:
            old.send("host0", "ping", {})
        except tuning.StaleLeaderError as e:
            rejected.append(str(e))
        fleet.rounds(2)
        # land host2's last report, then it falls silent
        for _ in range(30):
            fleet.clock[0] += 0.01
            fleet.transport.pump()
            if fleet.agents[2].link.send_report(
                    fleet.agents[2].report_wire()):
                break
        for _ in range(10):
            fleet.rounds(1, alive=[0, 1])
            if any(e["kind"] == "reshard" for e in fleet.coord.events):
                break
        fleet.rounds(2, alive=[0, 1])
        fleet.drain([0, 1])
        reshard = [fleet_mod.to_wire(dict(e)) for e in fleet.coord.events
                   if e["kind"] in ("reshard", "promote")]
        return dict(
            fences=[old_fence, fleet.server.fence,
                    [a.link.fence for a in fleet.agents]],
            rejected=rejected,
            link_rejected=[[r["fence"] for r in a.link.rejected]
                           for a in fleet.agents],
            events=reshard,
            makeup_added=[a._makeup_added for a in fleet.agents],
            deal=deal,
            delivered=[np.asarray(b["x"])[:, 0].tolist()
                       for b in fleet.delivered])
    finally:
        fleet.close()


def test_torch_failover_scenario_matches_repro():
    """One ``WireFleet`` failover scenario gives the same fences, the same
    stale-leader rejections and the same makeup deal in both packages,
    and covers the epoch exactly once."""
    ref = _failover_run(port=False)
    got = _failover_run(port=True)
    assert got["fences"][1] == got["fences"][0] + 1
    assert got["fences"][2][:2] == [got["fences"][1]] * 2
    assert got["rejected"], "the deposed leader's command went through"
    assert [e["kind"] for e in got["events"]] == ["promote", "reshard"]
    assert sum(got["makeup_added"]) > 0 and got["deal"]
    assert got == ref
    assert sorted(i for b in got["delivered"] for i in b) == \
        list(range(480))
