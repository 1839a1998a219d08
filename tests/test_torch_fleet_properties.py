"""The fleet cases of tests/test_properties.py on the port's control
plane and loaders (on the CPU): the seeded fault-injection matrix
(randomized join/leave/degrade/correlated-death timelines lose and
duplicate zero batches, one reshard per correlated-death group), the
network-fault matrix over a faulty transport with a coordinator crash and
standby failover, the elastic geometry latch, the ragged reshard and the
per-host consensus rebalance.

The two hypothesis-drawn properties keep the reference's names: the
fallback engine in ``_hypothesis_shim`` seeds each test by its qualified
name, so they draw the same cases, as many, as the reference does.
"""
import numpy as np
import pytest

from _hypothesis_shim import given, settings, st
from _torch_support import (fleet_loader, flat_indices,  # noqa: F401
                            make_index_dataset, make_table_evaluator,
                            wire_fleet)

from repro_torch.core.cluster import FleetEvent, FleetSchedule
from repro_torch.data import LoaderParams
from repro_torch.data.sampler import ShardedSampler


def _shards(n, gb, hosts, *, chunk, layout, seed):
    return [ShardedSampler(n, gb, seed=seed, host_index=h, host_count=hosts,
                           locality_chunk=chunk, layout=layout)
            for h in range(hosts)]


# --------------------------------------------------------------------------
# seeded fault-injection matrix: the fleet under randomized timelines
# --------------------------------------------------------------------------
def _build_timeline(rng, *, max_step, timeout_rounds):
    """Random join/leave/degrade events, spaced > heartbeat timeout so
    correlated-death groups resolve to distinct detection windows.  Every
    timeline contains at least one death group (the matrix must exercise
    the reshard path on every seed)."""
    events, step = [], 2
    hosts_alive, next_host = 3, 3
    groups = []                          # correlated-death groups emitted
    while step < max_step:
        kind = rng.choice(["death", "join", "degrade", "none"],
                          p=[0.45, 0.25, 0.2, 0.1])
        if not groups and step + timeout_rounds + 3 >= max_step:
            kind = "death"               # last slot: force the guarantee
        if kind == "death" and hosts_alive >= 2:
            size = int(rng.integers(1, min(2, hosts_alive - 1) + 1))
            events.append(("death", step, size))
            groups.append(size)
            hosts_alive -= size
        elif kind == "join" and hosts_alive < 4:
            events.append(("join", step, next_host))
            next_host += 1
            hosts_alive += 1
        elif kind == "degrade":
            events.append(("degrade", step, None))
        step += timeout_rounds + 3
    return events, groups


@pytest.mark.parametrize("seed", range(8))
def test_torch_fleet_fault_injection_matrix(seed):
    """Randomized fleet timelines (correlated deaths, joins, degrades at
    seeded random steps): zero lost/duplicated batches over the epoch and
    exactly one reshard emitted per correlated-death group."""
    from repro_torch.tuning import FleetConfig, FleetCoordinator, HostAgent

    rng = np.random.default_rng(seed)
    gb, bpe = 12, 48
    n = gb * bpe
    timeout, rounds = 4.0, 40
    events, groups = _build_timeline(rng, max_step=rounds - 12,
                                     timeout_rounds=int(timeout))
    sched = FleetSchedule()
    for kind, step, arg in events:
        if kind == "death":
            sched.add(FleetEvent(step=step, kind="leave", host=f"g{arg}"))
        elif kind == "join":
            sched.add(FleetEvent(step=step, kind="join", host=f"host{arg}"))
        else:
            sched.add(FleetEvent(step=step, kind="degrade", host="host0",
                                 io_scale=4.0))

    clock = [0.0]
    coord = FleetCoordinator(
        config=FleetConfig(heartbeat_timeout_s=timeout, warmup_steps=2,
                           cooldown_steps=8, num_cpu_cores=4, num_devices=1,
                           max_prefetch=2, retune_budget_batches=2),
        clock=lambda: clock[0])

    def spawn(h, host_count):
        dl = fleet_loader(make_index_dataset(n), gb, shuffle=True, seed=7,
                          params=LoaderParams(num_workers=2,
                                              prefetch_factor=2),
                          host_index=h, host_count=host_count)
        return HostAgent(f"host{h}", dl,
                         evaluator=make_table_evaluator(
                             lambda i, j: 4.0 / i + 0.1 * j))

    agents = {f"host{h}": coord.register(spawn(h, 3)) for h in range(3)}
    streams = {name: a.loader.stream(to_device=False)
               for name, a in agents.items()}
    alive = set(agents)
    degraded = set()
    delivered = []
    death_steps = []

    try:
        for step in range(rounds):
            for ev in sched.at(step):
                if ev.kind == "leave":       # a correlated-death group
                    size = int(ev.host[1:])
                    victims = sorted(alive)[:size]
                    for v in victims:
                        alive.discard(v)
                    death_steps.append(step)
                elif ev.kind == "join":
                    h = int(ev.host[4:])
                    agent = spawn(h, 1)      # coord.join reshards it in
                    coord.join(agent)
                    agents[ev.host] = agent
                    streams[ev.host] = agent.loader.stream(to_device=False)
                    alive.add(ev.host)
                else:
                    degraded.add(ev.host)
            clock[0] += 1.0
            for name in sorted(alive):
                delivered.append(next(streams[name]))
                scale = 4.0 if name in degraded else 1.0
                agents[name].observe(data_s=0.001, step_s=0.05 * scale)
            coord.poll()

        for name in sorted(alive):
            s = streams[name]
            while s.position < bpe:
                delivered.append(next(s))
    finally:
        for s in streams.values():
            s.close()

    # zero lost, zero duplicated — the epoch's exact multiset
    assert flat_indices(delivered) == list(range(n))
    # exactly ONE reshard per correlated-death group
    death_reshards = [e for e in coord.events
                      if e["kind"] == "reshard" and e["reason"] == "dead"]
    assert len(death_reshards) == len(groups), coord.events
    for event, size in zip(death_reshards, groups):
        assert len(event["lost"]) == size
    # joins each emitted their own reshard
    joins = [e for e in coord.events if e["kind"] == "join"]
    assert len(joins) == sum(1 for k, _, _ in events if k == "join")


# --------------------------------------------------------------------------
# network-fault matrix: the same guarantees over a faulty wire, with a
# coordinator crash + standby failover mid-reshard (DESIGN.md §8)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_torch_fleet_network_fault_matrix(seed, wire_fleet):
    """Seeded network-fault timelines over the message transport: random
    drop/delay/duplicate/reply-drop rates, partition windows shorter than
    the heartbeat timeout on the surviving hosts, one coordinator crash
    (standby promotes via the lease) and one host death after failover.
    The epoch must still be the exact multiset — zero lost, zero
    duplicated batches — with exactly one reshard applied for the death
    (idempotent replay under fencing, never a double application) and
    every post-failover command carrying the promoted leader's fence.

    Partition windows are capped below the heartbeat timeout on purpose:
    a longer partition is indistinguishable from death, so the fleet
    legitimately evicts and reshards around the host (covered by
    test_transport.py's eviction test).  The dying host's final report is
    flushed before it is killed — a host that consumed batches but never
    reported them trades a duplicate for a loss by design (two generals;
    see DESIGN.md §8)."""
    from repro_torch.tuning import FaultSpec

    rng = np.random.default_rng(100 + seed)
    faults = FaultSpec(drop=float(rng.uniform(0, 0.05)),
                       delay=float(rng.uniform(0, 0.04)),
                       duplicate=float(rng.uniform(0, 0.05)),
                       reply_drop=float(rng.uniform(0, 0.05)),
                       seed=seed)
    fleet = wire_fleet(faults=faults)

    crash_at = int(rng.integers(6, 13))
    death_at = crash_at + int(rng.integers(9, 13))
    # two partition windows on the SURVIVORS (host0/host1), each shorter
    # than the heartbeat timeout (6.0): tolerated, never an eviction
    cuts = {}
    for host, lo, hi in ((0, 3, crash_at),
                        (1, crash_at + 1, death_at + 2)):
        start = int(rng.integers(lo, hi))
        dur = int(rng.integers(1, 4))
        cuts.setdefault(start, []).append((host, "cut"))
        cuts.setdefault(start + dur, []).append((host, "heal"))

    def apply_cuts(step):
        for host, action in cuts.get(step, ()):
            if action == "cut":
                fleet.transport.partition(f"host{host}", "coord")
            else:
                fleet.transport.heal(f"host{host}", "coord")

    step = 0
    while step < death_at:
        apply_cuts(step)
        if step == crash_at:
            fleet.server.crash()
        fleet.rounds(1)
        step += 1

    assert fleet.replica.promoted, "standby never promoted after crash"
    new_fence = fleet.server.fence
    assert new_fence > 1, "promotion must mint a fresh fencing epoch"

    # land host2's final report, then kill it: the coordinator's makeup
    # math works from the last *reported* consumed position
    for _ in range(30):
        fleet.clock[0] += 0.01
        fleet.transport.pump()
        if fleet.agents[2].link.send_report(fleet.agents[2].report_wire()):
            break
    else:
        pytest.fail("host2 could not land its final report")

    def death_reshards():
        return [e for e in fleet.coord.events if e["kind"] == "reshard"
                and str(e["reason"]).startswith("dead")]

    for _ in range(25):
        if death_reshards():
            break
        apply_cuts(step)
        fleet.rounds(1, alive=[0, 1])
        step += 1
    # settle: heal any still-open window, replay anything pending
    for s in range(step, max(cuts, default=0) + 1):
        apply_cuts(s)
    fleet.rounds(3, alive=[0, 1])
    fleet.drain([0, 1])
    fleet.close()

    # zero lost, zero duplicated over the whole faulty timeline
    assert flat_indices(fleet.delivered) == list(range(fleet.n))
    # the death was resharded exactly once (a fenced replay appends
    # "+replay" to the same event; an interrupted attempt appends none)
    assert len(death_reshards()) == 1, fleet.coord.events
    # survivors follow the promoted leader: every post-failover command
    # carried the new fence, and the old leader can no longer act
    for h in (0, 1):
        assert fleet.agents[h].link.fence == new_fence
    assert fleet.server.fence == new_fence and not fleet.server.deposed


# --------------------------------------------------------------------------
# elastic geometry (DESIGN.md §11): the epoch-latched global-batch schedule
# + the two divisibility regressions it fixes
# --------------------------------------------------------------------------
def test_torch_plan_remesh_snaps_nondivisible_global_batch_regression():
    """Regression: a 4->3 shrink of global batch 14 rounds to a per-plan
    batch (10 or 11) that 3 hosts cannot shard uniformly.  plan_remesh
    must snap to the nearest positive multiple of the survivor count and
    say so in ``reason`` — the old code returned the raw rounded value
    and the reshard blew up (or silently truncated) downstream."""
    from repro_torch.distributed.fault_tolerance import plan_remesh
    plan = plan_remesh(alive_hosts=3, devices_per_host=1, model_axis=1,
                       old_hosts=4, old_global_batch=14, restore_step=None)
    assert plan.feasible
    assert plan.new_global_batch % 3 == 0, plan
    assert plan.new_global_batch in (9, 12)
    assert "snapped" in plan.reason


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 6), st.integers(1, 4), st.integers(1, 3),
       st.integers(1, 8), st.integers(1, 64))
def test_plan_remesh_feasible_plans_always_shardable_property(
        alive, dph, model_axis, old_hosts, old_gb):
    """For ANY remesh input: a feasible plan's new_global_batch is
    positive and divisible by the surviving host count (directly
    applicable to a uniform ShardedSampler split)."""
    from repro_torch.distributed.fault_tolerance import plan_remesh
    plan = plan_remesh(alive_hosts=alive, devices_per_host=dph,
                       model_axis=model_axis, old_hosts=old_hosts,
                       old_global_batch=old_gb, restore_step=None)
    if plan.feasible:
        assert plan.new_global_batch > 0
        assert plan.new_global_batch % alive == 0


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 4), st.integers(2, 5), st.integers(1, 3),
       st.sampled_from(["host_major", "strided"]), st.integers(0, 10**6))
def test_geometry_latch_exact_coverage_property(hosts, bpe, gb_scale,
                                                layout, seed):
    """For ANY randomized (hosts, epoch shape, layout): latching a new
    global batch at an epoch boundary keeps exact once-per-epoch coverage
    in BOTH epochs, batches_per_epoch follows the schedule, and the
    schedule-aware absolute math round-trips."""
    gb0 = 12 * gb_scale                 # divisible by every host count <= 4
    n = gb0 * bpe
    gb1 = max(hosts, (gb0 * 3 // 4) // hosts * hosts)  # a smaller latch
    shards = _shards(n, gb0, hosts, chunk=0, layout=layout, seed=seed)
    for s in shards:
        eff = s.set_geometry(gb1, epoch=1)
        assert eff == 1
        assert s.gb_for_epoch(0) == gb0 and s.gb_for_epoch(1) == gb1
        assert s.batches_per_epoch(0) == bpe
        assert s.batches_per_epoch(1) == n // gb1
    for epoch, gb in ((0, gb0), (1, gb1)):
        seen = []
        for b in range(n // gb):
            for s in shards:
                seen.extend(s.local_indices(epoch, b).tolist())
        covered = n - (n % gb)          # drop_last tail at the new gb
        assert len(seen) == covered
        assert len(set(seen)) == covered
    # schedule-aware absolute position round-trips through state_at
    probe = shards[0]
    for pos in (0, bpe - 1, bpe, bpe + 1, bpe + n // gb1 - 1):
        st_ = probe.state_at(pos)
        assert probe.epoch_start(st_.epoch) + st_.batch_offset == pos


def _run_fleet_death(n, gb, hosts, *, kill, rounds_before=3, seed=7):
    """Drive a direct-mode fleet, starve ``kill`` of heartbeats, poll
    past the timeout, and return (coord, streams, delivered, agents)."""
    from repro_torch.tuning import FleetConfig, FleetCoordinator, HostAgent

    timeout = 4.0
    clock = [0.0]
    coord = FleetCoordinator(
        config=FleetConfig(heartbeat_timeout_s=timeout, warmup_steps=2,
                           cooldown_steps=8, num_cpu_cores=4, num_devices=1,
                           max_prefetch=2, retune_budget_batches=2),
        clock=lambda: clock[0])
    agents, streams = {}, {}
    for h in range(hosts):
        dl = fleet_loader(make_index_dataset(n), gb, shuffle=True, seed=seed,
                        params=LoaderParams(num_workers=2,
                                            prefetch_factor=2),
                        host_index=h, host_count=hosts)
        name = f"host{h}"
        agents[name] = coord.register(HostAgent(
            name, dl, evaluator=make_table_evaluator(
                lambda i, j: 4.0 / i + 0.1 * j)))
        streams[name] = dl.stream(to_device=False)
    delivered = []
    alive = set(agents)
    for _ in range(rounds_before):
        clock[0] += 1.0
        for name in sorted(alive):
            delivered.append(next(streams[name]))
            agents[name].observe(data_s=0.001, step_s=0.05)
        coord.poll()
    alive.discard(kill)
    for _ in range(int(timeout) + 2):
        clock[0] += 1.0
        for name in sorted(alive):
            agents[name].observe(data_s=0.001, step_s=0.05)
        coord.poll()
    return coord, streams, delivered, agents, alive


def test_torch_elastic_reshard_applies_new_global_batch_with_exact_coverage():
    """The tentpole: a 4->3 host death rescales the global batch 12->9 at
    the NEXT epoch boundary (plan_remesh keeps per-replica batch at 3).
    Epoch 0 finishes at the old geometry with exact coverage (makeup for
    the corpse's unconsumed slices), epoch 1 runs at the new geometry
    with exact coverage — and the new batch is observable in the event
    log, the sampler schedules, and the HA member mirrors."""
    gb, bpe = 12, 6
    n = gb * bpe
    coord, streams, delivered, agents, alive = _run_fleet_death(
        n, gb, 4, kill="host3")
    try:
        event = next(e for e in coord.events if e["kind"] == "reshard")
        assert event["plan"].new_global_batch == 9
        # the latch epoch is the first boundary no producer (including its
        # prefetch pipeline) has crossed yet — always in the future
        ge = event["geometry_epoch"]
        assert ge is not None and ge >= 1
        assert event["sizes"] is None            # 12 % 3 == 0: no ragged
        bpe1 = n // 9
        for name in sorted(alive):
            s = agents[name].loader.sampler
            assert s.gb_for_epoch(ge - 1) == 12 and s.gb_for_epoch(ge) == 9
        # the HA snapshot carries the schedule for a promoted standby
        members = coord.state_dict()["members"]
        for name in sorted(alive):
            sched = members[name]["spec"]["sampler"]["geometry"]
            assert [list(map(int, e)) for e in sched] == [[0, 12], [ge, 9]]
        # drain the pre-latch epochs (old geometry + makeup) plus one full
        # epoch at the NEW geometry
        for name in sorted(alive):
            s = streams[name]
            while s.position < ge * bpe + bpe1:
                delivered.append(next(s))
        flat = flat_indices(delivered)
        assert flat == sorted(list(range(n)) * (ge + 1))   # every epoch exact
        for name in sorted(alive):
            assert agents[name].loader.global_batch == 9
            assert agents[name].loader.sampler.local_batch == 3
            assert list(
                agents[name].loader.sampler.sizes_for_epoch(ge)) == [3, 3, 3]
    finally:
        for s in streams.values():
            s.close()


def test_torch_elastic_reshard_ragged_split_regression():
    """Regression for the floor-division deal bug: global batch 8 over 3
    survivors is non-divisible — the old code computed new_local = 8//3
    and silently truncated (and the uniform reshard itself raised in the
    stream thread).  The fix deals a ragged largest-remainder split
    [3, 3, 2] with exact coverage, then latches the plan's snapped batch
    (6) at the epoch boundary."""
    gb, bpe = 8, 6
    n = gb * bpe
    coord, streams, delivered, agents, alive = _run_fleet_death(
        n, gb, 4, kill="host3")
    try:
        event = next(e for e in coord.events if e["kind"] == "reshard")
        assert list(event["sizes"]) == [3, 3, 2]
        assert event["plan"].new_global_batch == 6   # 4->3 at 2/replica
        ge = event["geometry_epoch"]
        assert ge is not None and ge >= 1
        by_shard = sorted((agents[name] for name in alive),
                          key=lambda a: a.shard_index())
        bpe1 = n // 6
        for name in sorted(alive):
            s = streams[name]
            while s.position < ge * bpe + bpe1:
                delivered.append(next(s))
        assert flat_indices(delivered) == sorted(list(range(n)) * (ge + 1))
        assert [a.loader.sampler.local_batch for a in by_shard] == [2, 2, 2]
    finally:
        for s in streams.values():
            s.close()


def test_torch_geometry_checkpoint_roundtrip():
    """DataLoader.state_dict carries the geometry schedule AND the ragged
    shard sizes; a restored loader continues at the right epoch shape."""
    n, gb = 96, 12
    dl = fleet_loader(make_index_dataset(n), gb, shuffle=True, seed=3,
                    host_index=0, host_count=3)
    assert dl.set_geometry(9, epoch=2) == 2
    dl.sampler.reshard(3, 0, sizes=[5, 4, 3])
    sd = dl.state_dict()
    dl2 = fleet_loader(make_index_dataset(n), gb, shuffle=True, seed=3,
                     host_index=0, host_count=3)
    dl2.load_state_dict(sd)
    assert dl2.sampler.geometry_state() == dl.sampler.geometry_state()
    assert list(dl2.sampler.shard_sizes) == [5, 4, 3]
    assert dl2.sampler.gb_for_epoch(2) == 9
    # stale explicit sizes (sum != the latched gb) revert to even_split
    assert list(dl2.sampler.sizes_for_epoch(2)) == [3, 3, 3]


def test_torch_nondivisible_uniform_reshard_raises_without_sizes():
    """Regression guard: the silent-truncation path is now an explicit
    error — resharding to a count that does not divide the global batch
    demands an explicit ragged split."""
    s = ShardedSampler(48, 8, host_index=0, host_count=4)
    with pytest.raises(ValueError, match="ragged"):
        s.reshard(3, 0)
    s.reshard(3, 0, sizes=[3, 3, 2])    # the explicit split is accepted
    assert s.local_batch == 3


def test_torch_per_host_consensus_rebalances_shard_sizes():
    """consensus="per_host": heterogeneous hosts tune independently and
    the batch partition re-apportions toward the fast host — contiguous
    host-major slices, exact coverage preserved mid-epoch."""
    from repro_torch.tuning import FleetConfig, FleetCoordinator, HostAgent

    n, gb, hosts = 240, 12, 3
    clock = [0.0]
    coord = FleetCoordinator(
        config=FleetConfig(heartbeat_timeout_s=10.0, warmup_steps=2,
                           cooldown_steps=4, num_cpu_cores=4, num_devices=1,
                           max_prefetch=2, retune_budget_batches=2,
                           consensus="per_host"),
        clock=lambda: clock[0])
    agents, streams = [], []
    # host0 is 2x faster than its peers at every cell
    tables = [lambda i, j: 2.0 / i + 0.05 * j,
              lambda i, j: 4.0 / i + 0.1 * j,
              lambda i, j: 4.0 / i + 0.1 * j]
    for h in range(hosts):
        dl = fleet_loader(make_index_dataset(n), gb, shuffle=True, seed=11,
                        params=LoaderParams(num_workers=2,
                                            prefetch_factor=2),
                        host_index=h, host_count=hosts)
        agents.append(coord.register(HostAgent(
            f"host{h}", dl, evaluator=make_table_evaluator(tables[h]))))
        streams.append(dl.stream(to_device=False))
    delivered = []
    try:
        for _ in range(6):
            clock[0] += 1.0
            for a, s in zip(agents, streams):
                delivered.append(next(s))
                a.observe(data_s=0.09, step_s=0.1)   # stalled: force retune
        actions = coord.poll()
        consensus = next(a for a in actions if a["kind"] == "consensus")
        assert consensus["mode"] == "per_host"
        assert consensus["applied"]
        sizes = consensus["sizes"]
        assert sizes is not None and sum(sizes) == gb
        assert sizes[0] > sizes[1]           # fast host takes the bigger slice
        # per-host cells: each host adopted its own optimum
        assert [tuple(p) for p in consensus["params"]] == \
            [a.param_cell() for a in agents]
        # the partition applies at the negotiated barrier — drain the epoch
        # (exact coverage must survive the mid-epoch repartition), then the
        # live samplers hold the new contiguous host-major slices
        for s in streams:
            while s.position < n // gb:
                delivered.append(next(s))
        assert flat_indices(delivered) == list(range(n))
        assert [a.loader.sampler.local_batch for a in agents] == sizes
    finally:
        for s in streams:
            s.close()
