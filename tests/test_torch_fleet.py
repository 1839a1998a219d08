"""The port's fleet control plane on the CPU: every case of
tests/test_fleet.py on ``repro_torch.tuning.fleet`` with the port's
loaders (elastic resharding, coordinator decisions, the adaptive-budget /
variance-aware-win satellites), the ``MultiHostDPT`` cases of
tests/test_dpt.py over ``repro_torch.core.cluster``, and parity with
``repro``: one seeded ``FleetSchedule`` scenario on one fake clock gives
the same coordinator event log and the same per-host delivered indices in
both packages, and ``MultiHostDPT`` the same ``FleetResult``.

The coverage tests assert the reshard invariant EXACTLY (every index once,
as a multiset over everything every host delivered).
"""
import math

import numpy as np
import pytest

from _torch_support import (fleet_factory,  # noqa: F401
                            fleet_loader, fleet_modules,
                            flat_indices as _flat_indices,
                            make_index_dataset as _index_dataset,
                            make_table_evaluator as _table_evaluator)

from repro_torch.core.cluster import FleetEvent, FleetSchedule
from repro_torch.core.dpt import DPTConfig, DPTResult, Trial
from repro_torch.data import LoaderParams
from repro_torch.data.sampler import SamplerState, ShardedSampler
from repro_torch.tuning import (FleetConfig, FleetCoordinator, HostAgent,
                                OnlineTuner, OnlineTunerConfig, RetunePolicy,
                                adaptive_budget, uniform_consensus,
                                welch_wins)


def test_torch_sampler_reshard_validates():
    s = ShardedSampler(120, 12, host_index=0, host_count=3)
    with pytest.raises(ValueError, match="not divisible"):
        s.reshard(5, 0)
    with pytest.raises(ValueError, match="out of range"):
        s.reshard(3, 3)
    s.reshard(4, 2)
    assert (s.host_count, s.host_index, s.local_batch) == (4, 2, 3)


def test_torch_sampler_checkpoint_round_trip_across_reshard():
    """Checkpoint at the barrier, reshard, keep going — a fresh sampler
    restored from the checkpoint with the NEW topology must produce the
    identical sequence (reshard state is topology, position is state)."""
    n, gb = 240, 12
    s = ShardedSampler(n, gb, shuffle=True, seed=4, host_index=1,
                       host_count=4)
    it = iter(s)
    for _ in range(7):
        next(it)
    saved = s.state.to_dict()
    s.reshard(3, 1)
    live = [next(it).tolist() for _ in range(6)]

    restored = ShardedSampler(n, gb, shuffle=True, seed=4, host_index=1,
                              host_count=3,
                              state=SamplerState.from_dict(saved))
    again = [next(iter(restored)) for _ in range(6)]
    assert live == [a.tolist() for a in again]


def test_torch_sampler_state_absolute_round_trip():
    st = SamplerState(epoch=3, batch_offset=7)
    assert SamplerState.from_absolute(st.absolute(20), 20) == st


# --------------------------------------------------------------------------
# live-loader reshard: barrier + makeup, exact coverage
# --------------------------------------------------------------------------
def test_torch_live_reshard_with_makeup_exact_coverage():
    """2-host fleet, host1 dies after 5 batches while host0 is at 8: host0
    takes over at the barrier, host1's undelivered slices [5, 8) arrive as
    makeup — and the epoch's index multiset is exactly covered."""
    n, gb = 240, 12
    mk = lambda h: fleet_loader(
        _index_dataset(n), gb, shuffle=True, seed=3,
        params=LoaderParams(num_workers=2, prefetch_factor=2),
        host_index=h, host_count=2)
    h0, h1 = mk(0), mk(1)
    s0, s1 = h0.stream(to_device=False), h1.stream(to_device=False)
    delivered = []
    delivered += [next(s1) for _ in range(5)]        # host1 then dies
    delivered += [next(s0) for _ in range(8)]
    barrier = max(s0.position, s1.position)
    assert (s0.position, s1.position) == (8, 5)

    ref = ShardedSampler(n, gb, shuffle=True, seed=3, host_index=1,
                         host_count=2)
    makeup = [ref.local_indices(0, b) for b in range(5, barrier)]
    h0.reshard(1, 0, at_batch=barrier, makeup=makeup)
    while s0.position < n // gb:
        delivered.append(next(s0))
    s0.close()
    s1.close()
    assert _flat_indices(delivered) == list(range(n))
    assert s0.reshards == 1


def test_torch_live_reshard_without_stream_remaps_sampler():
    dl = fleet_loader(_index_dataset(48), 12, host_index=0, host_count=2)
    dl.reshard(3, 2)
    assert (dl.sampler.host_count, dl.sampler.host_index) == (3, 2)
    with pytest.raises(ValueError, match="live stream"):
        dl.reshard(2, 0, makeup=[np.array([1, 2])])


def test_torch_device_prefetch_depth_hot_swap():
    """The device-side buffer depth retunes at the swap boundary (it used
    to be fixed at stream creation)."""
    dl = fleet_loader(_index_dataset(512), 8, shuffle=False, seed=0,
                      params=LoaderParams(num_workers=2, prefetch_factor=2,
                                          device_prefetch=2))
    stream = dl.stream(to_device=True)
    got = [next(stream) for _ in range(3)]
    dl.apply_params(dl.params.replace(num_workers=1, device_prefetch=4))
    while stream.swaps == 0:
        got.append(next(stream))
    assert stream._prefetcher.depth == 4
    dl.apply_params(dl.params.replace(device_prefetch=1))
    while stream.swaps == 1:
        got.append(next(stream))
    assert stream._prefetcher.depth == 1
    # delivery stayed exact through both swaps
    assert _flat_indices(got) == list(range(len(got) * 8))
    stream.close()


# --------------------------------------------------------------------------
# FleetCoordinator: death, drift, join  (fleet_factory: _torch_support)
# --------------------------------------------------------------------------
def test_torch_coordinator_death_reshards_with_exact_coverage(fleet_factory):
    n, gb = 480, 12
    fleet = fleet_factory(n, gb)
    clock, coord = fleet.clock, fleet.coord
    agents, streams = fleet.agents, fleet.streams
    delivered = {h: [] for h in range(3)}
    for rnd in range(12):
        clock[0] += 1.0
        for h in range(3):
            if h == 2 and rnd >= 7:
                continue             # host2 goes silent mid-run
            delivered[h].append(next(streams[h]))
            agents[h].observe(data_s=0.001, step_s=0.1)
        coord.poll()
    clock[0] += 10.0                 # silence outlives the timeout
    for h in (0, 1):
        agents[h].heartbeat()
    actions = coord.poll()
    reshard = next(a for a in actions if a["kind"] == "reshard")
    assert reshard["host"] == "host2"
    assert reshard["makeup_batches"] == reshard["barrier"] - 7
    assert reshard["plan"].feasible

    for h in (0, 1):
        while streams[h].position < n // gb:
            delivered[h].append(next(streams[h]))
        streams[h].close()
    streams[2].close()
    everything = [b for blist in delivered.values() for b in blist]
    assert _flat_indices(everything) == list(range(n))
    assert coord.reshards == 1
    assert "host2" not in coord.agents


def test_torch_coordinator_correlated_deaths_one_reshard_exact_coverage(
        fleet_factory):
    """Two hosts dying in the same detection window (a rack failure) are
    handled as ONE reshard: neither dead host is treated as a survivor of
    the other's reshard, and no makeup share is parked on a corpse."""
    n, gb = 480, 12
    fleet = fleet_factory(n, gb, hosts=4, cooldown_steps=1000,
                          evaluator_fn=lambda i, j: 1.0)
    clock, coord = fleet.clock, fleet.coord
    agents, streams = fleet.agents, fleet.streams
    delivered = {h: [] for h in range(4)}
    for rnd in range(10):
        clock[0] += 1.0
        for h in range(4):
            if h >= 2 and rnd >= 6:
                continue             # hosts 2 AND 3 go silent together
            delivered[h].append(next(streams[h]))
            agents[h].observe(data_s=0.001, step_s=0.1)
        coord.poll()
    clock[0] += 10.0
    for h in (0, 1):
        agents[h].heartbeat()
    actions = coord.poll()
    reshards = [a for a in actions if a["kind"] == "reshard"]
    assert len(reshards) == 1
    assert sorted(reshards[0]["lost"]) == ["host2", "host3"]
    assert reshards[0]["hosts"] == 2
    assert reshards[0]["makeup_batches"] == 2 * (reshards[0]["barrier"] - 6)

    for h in (0, 1):
        while streams[h].position < n // gb:
            delivered[h].append(next(streams[h]))
    for s in streams:
        s.close()
    everything = [b for blist in delivered.values() for b in blist]
    assert _flat_indices(everything) == list(range(n))


def test_torch_arena_respec_expected_leading_rejects_ragged_first_batch():
    """A ragged makeup chunk arriving first after a reshard must not pin
    the arena spec to the wrong local batch shape."""
    from repro_torch.data.arena import SlabArena
    arena = SlabArena(4)
    assert arena.adopt({"x": np.zeros((4, 3))}) is not None   # spec @ 4
    arena.respec(expected_leading=6)
    assert arena.adopt({"x": np.zeros((4, 3))}) is None       # stale shape
    assert arena.adopt({"x": np.zeros((2, 3))}) is None       # ragged tail
    slot = arena.adopt({"x": np.zeros((6, 3))})               # the new spec
    assert slot is not None
    slot.release()
    assert arena.acquire() is not None


def test_torch_coordinator_drift_pushes_uniform_params_to_all_hosts(
        fleet_factory):
    fleet = fleet_factory()
    clock, coord = fleet.clock, fleet.coord
    agents, streams = fleet.agents, fleet.streams
    # stalled fleet: data-wait dominates compute on every host
    for _ in range(6):
        clock[0] += 1.0
        for a in agents:
            a.observe(data_s=0.09, step_s=0.1)
    actions = coord.poll()
    consensus = next(a for a in actions if a["kind"] == "consensus")
    assert consensus["reason"] == "goodput-drift"
    assert consensus["applied"]
    assert consensus["params"] == (4, 1)     # argmin of 4/i + 0.1j
    for a in agents:
        assert a.loader.params.num_workers == 4
        assert a.loader.params.prefetch_factor == 1
    for s in streams:
        s.close()


def test_torch_coordinator_straggler_triggers_consensus(fleet_factory):
    fleet = fleet_factory()
    clock, coord = fleet.clock, fleet.coord
    agents, streams = fleet.agents, fleet.streams
    for _ in range(6):
        clock[0] += 1.0
        for i, a in enumerate(agents):
            # host2 is 4x slower per step but data stays hidden: only the
            # straggler signal can catch this
            step = 0.4 if i == 2 else 0.1
            a.observe(data_s=0.001, step_s=step)
    actions = coord.poll()
    consensus = next(a for a in actions if a["kind"] == "consensus")
    assert consensus["reason"].startswith("straggler-divergence:host2")
    for s in streams:
        s.close()


def test_torch_coordinator_join_expands_fleet_with_exact_coverage(
        fleet_factory):
    """3 -> 4 hosts mid-epoch: incumbents reshard at the barrier, the
    newcomer aligns to it and takes the last shard."""
    n, gb = 480, 12
    fleet = fleet_factory(n, gb)
    clock, coord = fleet.clock, fleet.coord
    agents, streams = fleet.agents, fleet.streams
    delivered = []
    for rnd in range(6):
        clock[0] += 1.0
        for h in range(3):
            delivered.append(next(streams[h]))
            agents[h].observe(data_s=0.001, step_s=0.1)

    dl_new = fleet_loader(_index_dataset(n), gb, shuffle=True, seed=5,
                          params=LoaderParams(num_workers=1,
                                              prefetch_factor=2))
    newcomer = HostAgent("host3", dl_new,
                         evaluator=_table_evaluator(lambda i, j: 1.0))
    barrier = coord.join(newcomer)
    assert barrier >= 6
    assert dl_new.sampler.state.batch_offset == barrier
    assert (dl_new.sampler.host_count, dl_new.sampler.host_index) == (4, 3)

    streams.append(dl_new.stream(to_device=False))
    for s in streams:
        while s.position < n // gb:
            delivered.append(next(s))
        s.close()
    assert _flat_indices(delivered) == list(range(n))
    assert len(coord.agents) == 4


def test_torch_coordinator_no_win_consensus_backs_off(fleet_factory):
    fleet = fleet_factory()
    coord, agents, streams = fleet.coord, fleet.agents, fleet.streams
    for a in agents:                 # flat objective: nothing to win
        a.evaluator = _table_evaluator(lambda i, j: 1.0)
    before = [a.loader.params for a in agents]
    coord.request_consensus(reason="forced")
    actions = coord.poll()
    consensus = next(a for a in actions if a["kind"] == "consensus")
    assert not consensus["applied"]
    assert [a.loader.params for a in agents] == before
    assert coord._backoff == 2
    for s in streams:
        s.close()


def test_torch_fleet_schedule_fires_once_in_order():
    sched = FleetSchedule([FleetEvent(step=3, kind="degrade", host="h1",
                                      io_scale=4.0),
                           FleetEvent(step=3, kind="leave", host="h2")])
    sched.add(FleetEvent(step=5, kind="join", host="h3"))
    assert sched.at(0) == []
    fired = sched.at(3)
    assert [e.kind for e in fired] == ["degrade", "leave"]
    assert sched.at(3) == []         # events fire exactly once
    assert sched.pending == 1
    assert [e.kind for e in sched.at(5)] == ["join"]
    with pytest.raises(ValueError, match="unknown fleet event"):
        FleetEvent(step=0, kind="explode", host="h0")


def test_torch_uniform_consensus_requires_universal_feasibility():
    ok = Trial(2, 1, 1.0)
    res_a = DPTResult(2, 1, 1.0, [ok, Trial(4, 1, 0.5)])
    res_b = DPTResult(2, 1, 2.0, [Trial(2, 1, 2.0),
                                  Trial(4, 1, math.inf, overflowed=True)])
    best, fleet_time = uniform_consensus([res_a, res_b])
    assert best == (2, 1)            # (4,1) is faster but overflows on b
    assert fleet_time == 2.0


# --------------------------------------------------------------------------
# makeup accounting regressions (found by the fault-injection matrix in
# test_properties.py): consumed-position vs makeup yields, and makeup
# surviving a later reshard / a recipient's death
# --------------------------------------------------------------------------
def test_torch_consumed_position_not_inflated_by_makeup_yields():
    """A host that consumed makeup batches must not over-report its
    regular-batch position — one-observe-per-step counting loses samples
    the moment that host dies (its makeup window starts too late)."""
    n, gb = 240, 12
    dl = fleet_loader(_index_dataset(n), gb, shuffle=True, seed=3,
                      params=LoaderParams(num_workers=1, prefetch_factor=1))
    agent = HostAgent("h0", dl, evaluator=_table_evaluator(lambda i, j: 1.0))
    stream = dl.stream(to_device=False)
    for _ in range(3):
        next(stream)
        agent.observe(data_s=0.0, step_s=0.1)
    assert agent.consumed_position() == 3
    # two makeup chunks arrive (another host died elsewhere)
    dl.add_makeup([np.array([7, 8]), np.array([9, 10])])
    for _ in range(4):                   # 2 makeup + 2 regular, any order
        next(stream)
        agent.observe(data_s=0.0, step_s=0.1)
    assert agent.consumed_position() == 5    # NOT 7: makeup doesn't count
    assert stream.position == 5
    stream.close()


def test_torch_reshard_recovers_pulled_but_undelivered_makeup():
    """A reshard's discard boundary regenerates regular batches by
    rewinding the sampler — makeup the pool had pulled but not delivered
    must go back on the queue, not die with the pool."""
    n, gb = 240, 12
    dl = fleet_loader(_index_dataset(n), gb, shuffle=True, seed=3,
                      params=LoaderParams(num_workers=2, prefetch_factor=2))
    stream = dl.stream(to_device=False)
    delivered = [next(stream) for _ in range(4)]
    makeup = [np.arange(12), np.arange(12, 24)]
    dl.add_makeup(makeup)
    # reshard lands immediately: the pool likely pulled the makeup already
    dl.reshard(2, 0, at_batch=stream.position)
    while stream.position < n // gb:
        delivered.append(next(stream))
    got = [x for b in delivered for x in np.asarray(b["x"])[:, 0].tolist()]
    # both makeup chunks arrived exactly once despite the discard
    for idx in range(24):
        assert got.count(idx) >= 1
    assert stream.reshards == 1
    stream.close()


def test_torch_undelivered_makeup_counts_unconsumed_yields():
    """Makeup yielded into a device prefetcher is not CONSUMED: querying
    with the consumer's yield count must recover it (a dead host's
    prefetcher-held makeup is otherwise lost)."""
    n, gb = 120, 12
    dl = fleet_loader(_index_dataset(n), gb, shuffle=True, seed=3,
                      params=LoaderParams(num_workers=1, prefetch_factor=1))
    stream = dl.stream(to_device=False)
    next(stream)
    chunks = [np.array([1, 2, 3]), np.array([4, 5])]
    dl.add_makeup(chunks)
    # drain until both makeup chunks have been YIELDED
    while stream.position < 4:
        next(stream)
    consumed_all = stream.yields
    # consumer kept up: nothing undelivered
    assert dl.undelivered_makeup(consumed_yields=consumed_all) == []
    # consumer died one yield behind (prefetcher held the last batch):
    # any makeup among the unconsumed suffix is recovered
    recovered = stream.undelivered_makeup(consumed_yields=1)
    assert sorted(np.concatenate(recovered).tolist()) == [1, 2, 3, 4, 5]
    stream.close()


def test_torch_dead_hosts_undelivered_makeup_redistributed(fleet_factory):
    """Makeup dealt to a host that later dies is re-redistributed by the
    next reshard (no makeup parked on a corpse)."""
    n, gb = 480, 12
    fleet = fleet_factory(n, gb, hosts=3, cooldown_steps=1000)
    clock, coord = fleet.clock, fleet.coord
    agents, streams = fleet.agents, fleet.streams
    delivered = []
    # host2 dies first; its window becomes makeup on host0/host1
    for rnd in range(6):
        clock[0] += 1.0
        for h in range(3):
            if h == 2 and rnd >= 3:
                continue
            delivered.append(next(streams[h]))
            agents[h].observe(data_s=0.001, step_s=0.1)
        coord.poll()
    clock[0] += 10.0
    for h in (0, 1):
        agents[h].heartbeat()
    assert any(a["kind"] == "reshard" for a in coord.poll())
    # host1 dies immediately after — likely still holding makeup
    clock[0] += 1.0
    delivered.append(next(streams[0]))
    agents[0].observe(data_s=0.001, step_s=0.1)
    clock[0] += 10.0
    agents[0].heartbeat()
    assert any(a["kind"] == "reshard" for a in coord.poll())
    while streams[0].position < n // gb:
        delivered.append(next(streams[0]))
    assert _flat_indices(delivered) == list(range(n))


# --------------------------------------------------------------------------
# satellites: adaptive budget + Welch win test
# --------------------------------------------------------------------------
def test_torch_adaptive_budget_derives_from_search_space():
    cfg = DPTConfig(num_cpu_cores=12, num_devices=4)
    assert adaptive_budget(cfg) == 36          # 3x the deepest rung (12)
    assert adaptive_budget(cfg, explicit=5) == 5
    assert adaptive_budget(DPTConfig(num_cpu_cores=2, num_devices=1)) == 8


def test_torch_online_tuner_uses_adaptive_budget_when_unset():
    ev = _table_evaluator(lambda i, j: 4.0 / i + 0.1 * j)
    dl = fleet_loader(_index_dataset(64), 8, shuffle=False, seed=0,
                      params=LoaderParams(num_workers=1, prefetch_factor=1))
    tuner = OnlineTuner(dl, evaluator=ev,
                        config=OnlineTunerConfig(num_cpu_cores=4,
                                                 num_devices=1,
                                                 max_prefetch=2),
                        machine_fp="m", dataset_fp="d")
    tuner.force_retune()
    assert ev.budgets and all(b == 12 for b in ev.budgets)   # 3 * 4 cores


def test_torch_welch_wins_separates_signal_from_noise():
    slow = [1.00, 1.02, 0.98, 1.01, 0.99, 1.00]
    fast = [0.50, 0.52, 0.49, 0.51, 0.50, 0.48]
    assert welch_wins(slow, fast)
    assert not welch_wins(fast, slow)          # one-sided
    noisy_a = [1.0, 0.2, 1.8, 0.6, 1.4]
    noisy_b = [0.9, 0.3, 1.7, 0.5, 1.5]        # same spread, tiny shift
    assert not welch_wins(noisy_a, noisy_b)
    assert not welch_wins([1.0], [0.5])        # too few samples


def test_torch_retune_policy_welch_blocks_noisy_win():
    """A 'winner' whose mean is lower only within noise is not applied;
    a clearly separated one is."""
    cfg = OnlineTunerConfig(strategy="hillclimb", min_improvement=0.05)
    policy = RetunePolicy(cfg)
    current = LoaderParams(num_workers=1, prefetch_factor=1)

    def result(win_samples):
        ref = Trial(1, 1, 1.0, batch_seconds=[1.0, 0.6, 1.4, 0.8, 1.2])
        win = Trial(4, 1, 0.9, batch_seconds=win_samples)
        return DPTResult(4, 1, 0.9, [ref, win])

    noisy = result([0.9, 0.5, 1.5, 0.7, 1.3])       # -10% mean, huge var
    assert not policy.is_win(noisy, current)
    clear = result([0.30, 0.32, 0.28, 0.31, 0.29])  # unambiguous
    assert policy.is_win(clear, current)


def test_torch_retune_policy_falls_back_without_samples():
    cfg = OnlineTunerConfig(strategy="hillclimb", min_improvement=0.05)
    policy = RetunePolicy(cfg)
    current = LoaderParams(num_workers=1, prefetch_factor=1)
    res = DPTResult(4, 1, 0.5, [Trial(1, 1, 1.0), Trial(4, 1, 0.5)])
    assert policy.is_win(res, current)
    res_small = DPTResult(4, 1, 0.97, [Trial(1, 1, 1.0), Trial(4, 1, 0.97)])
    assert not policy.is_win(res_small, current)


def test_torch_loader_evaluator_records_batch_seconds():
    """Wall-clock trials carry per-batch samples for the Welch test."""
    from repro_torch.tuning import TrialRecorder
    from repro_torch.core.evaluators import LoaderEvaluator
    dl = fleet_loader(_index_dataset(64), 8, shuffle=False, seed=0,
                      params=LoaderParams(num_workers=0))
    rec = TrialRecorder(LoaderEvaluator(dl, to_device=False),
                        DPTConfig(num_batches=4))
    rec.seconds(0, 1)
    assert len(rec.trials) == 1
    assert len(rec.trials[0].batch_seconds) == 4


# --------------------------------------------------------------------------
# parity with repro: one seeded FleetSchedule scenario in both packages
# --------------------------------------------------------------------------
def _schedule_run(port: bool):
    """A three-host direct-mode fleet through a ``FleetSchedule`` on a
    fake clock: host1 degrades (4x its step time) at round 4, host2 dies
    at round 10, host3 joins at round 22; the survivors run the epoch
    out.  Returns (the event log with the round each event appeared in,
    as wire data; each host's delivered index batches; latched
    geometry)."""
    data, tuning, fleet, cluster = fleet_modules(port)
    n, gb, timeout = 480, 12, 4.0
    bpe = n // gb
    clock = [0.0]
    coord = tuning.FleetCoordinator(
        config=tuning.FleetConfig(heartbeat_timeout_s=timeout,
                                  warmup_steps=2, cooldown_steps=6,
                                  num_cpu_cores=4, num_devices=1,
                                  max_prefetch=2, retune_budget_batches=2),
        clock=lambda: clock[0])
    table = {"host1": lambda i, j: 6.0 / i + 0.2 * j}

    def spawn(h, host_count):
        dl = fleet_loader(_index_dataset(n, port=port), gb, shuffle=True,
                          seed=7, params=data.LoaderParams(
                              num_workers=2, prefetch_factor=2),
                          host_index=h, host_count=host_count, port=port)
        return tuning.HostAgent(
            f"host{h}", dl, evaluator=_table_evaluator(
                table.get(f"host{h}", lambda i, j: 4.0 / i + 0.1 * j),
                port=port))

    sched = cluster.FleetSchedule([
        cluster.FleetEvent(step=4, kind="degrade", host="host1",
                           io_scale=4.0),
        cluster.FleetEvent(step=10, kind="leave", host="host2"),
        cluster.FleetEvent(step=22, kind="join", host="host3")])
    agents = {f"host{h}": coord.register(spawn(h, 3)) for h in range(3)}
    streams = {k: a.loader.stream(to_device=False)
               for k, a in agents.items()}
    alive, degraded = set(agents), set()
    delivered = {k: [] for k in ("host0", "host1", "host2", "host3")}
    rounds_of = []
    try:
        for rnd in range(30):
            for ev in sched.at(rnd):
                if ev.kind == "leave":
                    alive.discard(ev.host)
                elif ev.kind == "join":
                    agent = spawn(3, 1)
                    coord.join(agent)
                    agents[ev.host] = agent
                    streams[ev.host] = agent.loader.stream(to_device=False)
                    alive.add(ev.host)
                else:
                    degraded.add(ev.host)
            clock[0] += 1.0
            for name in sorted(alive):
                batch = next(streams[name])
                delivered[name].append(np.asarray(batch["x"])[:, 0].tolist())
                scale = 4.0 if name in degraded else 1.0
                agents[name].observe(data_s=0.001, step_s=0.05 * scale)
            coord.poll()
            rounds_of += [rnd] * (len(coord.events) - len(rounds_of))
        for name in sorted(alive):
            s = streams[name]
            while s.position < bpe:
                delivered[name].append(
                    np.asarray(next(s)["x"])[:, 0].tolist())
    finally:
        for s in streams.values():
            s.close()
    events = [dict(fleet.to_wire(dict(e)), round=r)
              for e, r in zip(coord.events, rounds_of)]
    geometry = {k: a.loader.sampler.geometry_state()
                for k, a in agents.items() if k in alive}
    return events, delivered, fleet.to_wire(geometry)


def test_torch_fleet_schedule_scenario_matches_repro():
    """The same scenario through both packages: the coordinators' event
    logs (kinds, rounds, barriers, shard maps, makeup chunks, pushed
    cells, latched geometry) and every host's delivered index sequence
    are equal exactly, and the epoch is covered exactly once."""
    jev, jdel, jgeo = _schedule_run(port=False)
    tev, tdel, tgeo = _schedule_run(port=True)
    kinds = [e["kind"] for e in tev]
    # the scenario reaches every decision it is built to exercise
    assert "consensus" in kinds and "reshard" in kinds and "join" in kinds
    reshard = next(e for e in tev if e["kind"] == "reshard")
    assert reshard["lost"] == ["host2"] and reshard["geometry_epoch"]
    assert any(e["kind"] == "consensus"
               and e["reason"].startswith("straggler") for e in tev)
    assert tev == jev
    assert tdel == jdel
    assert tgeo == jgeo
    flat = sorted(i for batches in tdel.values() for b in batches for i in b)
    assert flat == list(range(480))


# --------------------------------------------------------------------------
# MultiHostDPT over core/cluster.py (tests/test_dpt.py's multi-host cases)
# --------------------------------------------------------------------------
class TableEvaluator:
    """Deterministic synthetic objective with optional overflow cells."""

    def __init__(self, fn, overflow=None):
        self.fn = fn
        self.overflow = overflow or (lambda i, j: False)
        self.calls = []

    def __call__(self, i, j, *, num_batches=16, epoch=0):
        from repro_torch.core import MemoryOverflow
        from repro_torch.data import TransferStats
        self.calls.append((i, j))
        if self.overflow(i, j):
            raise MemoryOverflow(f"cell ({i},{j})")
        return TransferStats(self.fn(i, j), num_batches, 0)


_CFG = DPTConfig(num_cpu_cores=12, num_devices=1, max_prefetch=8,
                 num_batches=64)
_EDGE_CFG = DPTConfig(num_cpu_cores=2, num_devices=1, max_prefetch=2,
                      num_batches=2)


def test_torch_multihost_uniform_handles_straggler():
    from repro_torch.core import MachineProfile, MultiHostDPT
    from repro_torch.core.cluster import fleet_evaluators, make_fleet
    from repro_torch.data.storage import cifar10_profile
    fleet = make_fleet(MachineProfile(), cifar10_profile(), num_hosts=4,
                       slow_hosts=[1])
    evs = fleet_evaluators(fleet, batch_size=32)
    mh = MultiHostDPT(evs, _CFG)
    per_host = mh.run_per_host()
    uniform = mh.run_uniform()
    # fleet time is dictated by the straggler either way
    assert uniform.fleet_time >= per_host.per_host[0].optimal_time
    # uniform must be feasible on every host and not much worse than per-host
    assert uniform.fleet_time <= per_host.fleet_time * 1.05


def test_torch_multihost_per_host_matches_independent_tuning():
    from repro_torch.core import MachineProfile, MultiHostDPT
    from repro_torch.core.cluster import fleet_evaluators, make_fleet
    from repro_torch.data.storage import cifar10_profile
    fleet = make_fleet(MachineProfile(), cifar10_profile(), num_hosts=3)
    evs = fleet_evaluators(fleet, batch_size=32)
    res = MultiHostDPT(evs, _CFG).run_per_host()
    assert len(set(res.fleet_params)) == 1   # homogeneous hosts agree


def test_torch_multihost_uniform_single_feasible_cell():
    """When only one cell survives on every host, uniform must pick it."""
    from repro_torch.core import MultiHostDPT
    only = (1, 1)
    evs = [TableEvaluator(lambda i, j: float(i + j),
                          overflow=lambda i, j: (i, j) != only)
           for _ in range(3)]
    res = MultiHostDPT(evs, _EDGE_CFG).run_uniform()
    assert res.uniform_params == only
    assert res.fleet_params == [only] * 3


def test_torch_multihost_uniform_no_common_feasible_cell_raises():
    """Host A only feasible at i=1, host B only at i=2 -> no uniform cell."""
    from repro_torch.core import MemoryOverflow, MultiHostDPT
    ev_a = TableEvaluator(lambda i, j: 1.0, overflow=lambda i, j: i > 1)
    ev_b = TableEvaluator(lambda i, j: 1.0, overflow=lambda i, j: i == 1)
    with pytest.raises(MemoryOverflow):
        MultiHostDPT([ev_a, ev_b], _EDGE_CFG).run_uniform()


def test_torch_multihost_uniform_straggler_picks_max_minimizing_cell():
    """The uniform choice minimizes the fleet MAX, not any host's own
    optimum: host A loves (1,1) but the straggler B is terrible there."""
    from repro_torch.core import MultiHostDPT
    ev_a = TableEvaluator(lambda i, j: 1.0 if (i, j) == (1, 1) else 2.0)
    ev_b = TableEvaluator(lambda i, j: 10.0 if (i, j) == (1, 1) else 2.0)
    res = MultiHostDPT([ev_a, ev_b], _EDGE_CFG).run_uniform()
    assert res.uniform_params != (1, 1)
    assert res.fleet_time == 2.0


@pytest.mark.parametrize("slow_hosts", [(), (1,), (0, 2)])
def test_torch_multihost_dpt_matches_repro(slow_hosts):
    """``run_per_host`` and ``run_uniform`` over ``make_fleet`` /
    ``fleet_evaluators`` give the same ``FleetResult`` in both packages,
    exactly, on the simulator: cells, fleet time and every host's
    trials."""
    import dataclasses

    import repro.core as jcore
    import repro.core.cluster as jcluster
    import repro.data.storage as jstorage
    import repro_torch.core as tcore
    import repro_torch.core.cluster as tcluster
    import repro_torch.data.storage as tstorage

    out = []
    for core, cluster, storage in ((jcore, jcluster, jstorage),
                                   (tcore, tcluster, tstorage)):
        fleet = cluster.make_fleet(core.MachineProfile(),
                                   storage.cifar10_profile(), num_hosts=4,
                                   slow_hosts=list(slow_hosts))
        cfg = core.DPTConfig(num_cpu_cores=12, num_devices=1,
                             max_prefetch=8, num_batches=64)
        mh = core.MultiHostDPT(cluster.fleet_evaluators(fleet,
                                                        batch_size=32), cfg)
        out.append([dataclasses.asdict(r) for r in (mh.run_per_host(),
                                                    mh.run_uniform())])
    assert out[1] == out[0]
    per_host, uniform = out[1]
    assert per_host["mode"] == "per_host" and uniform["mode"] == "uniform"
    assert uniform["fleet_params"] == [uniform["uniform_params"]] * 4
