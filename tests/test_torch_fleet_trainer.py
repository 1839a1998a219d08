"""The slice as a whole on the CPU: a fleet-attached Trainer and a
fleet-attached BatchingFrontend in both packages.

Each package runs its own fleet on one fake clock: a ``CoordinatorServer``
over a ``LocalTransport``, host0 a ``Trainer`` attached with
``connect_fleet`` and two host-side peers attached with ``connect_host``.
The peers step in lockstep with the Trainer (its agent's ``observe`` is
wrapped so that each step ends with the peers' round, the pump, the
server's tick and poll).  host2 falls silent after two rounds; the
survivors reshard at a common barrier, host2's undelivered slices arrive
as makeup, and the next epoch latches a global batch of 8 at which the
Trainer rescales its LR by 8/12.  Both Trainers start from the same
JAX-initialised checkpoint (the port restores it through
``repro_torch.models.convert``), and every step's batch indices, the losses,
the final parameters and the rescaled LR are held against ``repro``'s.

The frontend case serves greedy requests through a reduced qwen2 attached
with ``BatchingFrontend.connect_fleet``: one report per served batch,
heartbeats while idle, a drift-forced re-consensus that pushes a cell into
the serving host's loader, and greedy tokens equal to ``repro``'s.
"""
import time

import jax
import numpy as np
import pytest

from _torch_support import fleet_modules, make_table_evaluator

GB, BPE, SEQ = 12, 12, 16
N_ITEMS = GB * BPE
DEATH_ROUND = 2          # host2's last round
TIMEOUT = 2.0            # heartbeat timeout, in fake-clock rounds
STEPS = 17               # epoch 0 (old shard, makeup, new shard) + epoch 1
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=40, eps=1e-4)


class _Tap:
    """Iterator over a live stream that keeps a host copy of every batch
    the consumer takes (the stream itself stays the loader's live one)."""

    def __init__(self, stream, sink):
        self.stream, self.sink = stream, sink

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.stream)
        self.sink.append({k: np.array(v) for k, v in batch.items()})
        return batch

    def close(self):
        self.stream.close()


def _tap_loader(loader, sink):
    """Route every stream the Trainer opens through a ``_Tap``."""
    real = loader.stream

    def stream(**kw):
        return _Tap(real(**kw), sink)
    loader.stream = stream


def _settle(loader, consumed, timeout=5.0):
    """Wait until host0's producer has run as far ahead as it can: the
    prefetcher holds ``depth`` batches and its thread one more.  The
    reports, the reshard's barrier and the Trainer's LR check all read
    the producer's position, so a fleet decision is taken at the same
    position in every run and in both packages."""
    stream = loader._live_stream
    want = consumed + stream._prefetcher.depth + 1
    end = time.monotonic() + timeout
    while stream.yields < want and time.monotonic() < end:
        time.sleep(1e-3)


def _row_index(dataset):
    """Each token row's dataset index (the rows are random, so distinct)."""
    return {dataset.storage.read(i).tobytes(): i
            for i in range(len(dataset.storage))}


def _indices(batch, rows):
    raw = np.concatenate([batch["tokens"], batch["targets"][:, -1:]], 1)
    return [rows[r.astype(np.int32).tobytes()] for r in raw]


class _Fleet:
    """One package's fleet around an attached host0 (see the module
    docstring).  ``attach`` wraps host0's ``observe``."""

    def __init__(self, port, dataset):
        data, tuning, fleet, _ = fleet_modules(port)
        self.clock = [0.0]
        ck = lambda: self.clock[0]  # noqa: E731
        self.transport = tuning.LocalTransport()
        self.coord = tuning.FleetCoordinator(
            config=tuning.FleetConfig(
                heartbeat_timeout_s=TIMEOUT, warmup_steps=10_000,
                num_cpu_cores=2, num_devices=1, max_prefetch=1,
                retune_budget_batches=2),
            clock=ck)
        self.server = fleet.CoordinatorServer(self.coord, self.transport,
                                              owner="coord-0")
        self.ck = ck
        self.peers, self.streams = [], []
        self.delivered = {"host1": [], "host2": []}
        for h in (1, 2):
            dl = _loader(data, dataset, h, port)
            self.peers.append(tuning.connect_host(
                self.transport, f"host{h}", dl,
                evaluator=make_table_evaluator(
                    lambda i, j: 4.0 / i + 0.1 * j, port=port),
                clock=ck, link_config=tuning.LinkConfig(seed=h,
                                                        jitter=0.0)))
        self.rounds = 0

    def attach(self, agent, taken):
        agent.evaluator = make_table_evaluator(
            lambda i, j: 4.0 / i + 0.1 * j,
            port=type(agent).__module__.startswith("repro_torch"))
        real = agent.observe

        def observe(*, data_s, step_s):
            _settle(agent.loader, len(taken))
            real(data_s=data_s, step_s=step_s)
            self.round(step_s)
        agent.observe = observe
        for p in self.peers:
            self.streams.append(p.loader.stream(to_device=False))

    def round(self, step_s):
        self.rounds += 1
        self.clock[0] += 1.0
        for h, (agent, stream) in enumerate(zip(self.peers, self.streams)):
            if h == 1 and self.rounds > DEATH_ROUND:
                continue                       # host2 fell silent
            batch = next(stream)
            self.delivered[agent.host].append(
                np.asarray(batch["tokens"]).copy())
            agent.observe(data_s=0.001, step_s=step_s)
        self.transport.pump()
        self.server.tick()
        self.server.poll()

    def close(self):
        for s in self.streams:
            s.close()


def _loader(data, dataset, host, port):
    kw = dict(device="cpu") if port else {}
    return data.DataLoader(
        dataset, GB, shuffle=True, seed=3, host_index=host, host_count=3,
        params=data.LoaderParams(num_workers=0, device_prefetch=1), **kw)


def _run(port, arch, ckpt_dir):
    """One package's fleet-attached Trainer; returns what the test holds."""
    data, _, _, _ = fleet_modules(port)
    if port:
        from repro_torch.configs import get_config, reduced
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.train_step import TrainStepConfig
        from repro_torch.train.trainer import Trainer, TrainerConfig
    else:
        from repro.configs import get_config, reduced
        from repro.train.optimizer import AdamWConfig
        from repro.train.train_step import TrainStepConfig
        from repro.train.trainer import Trainer, TrainerConfig
    cfg = reduced(get_config(arch))
    dataset = data.token_dataset(N_ITEMS, SEQ, cfg.vocab_size, seed=2)
    loader = _loader(data, dataset, 0, port)
    fleet = _Fleet(port, dataset)
    tc = TrainerConfig(total_steps=STEPS, log_every=1, autotune=False,
                       checkpoint_dir=ckpt_dir, checkpoint_every=10_000,
                       step_config=TrainStepConfig(
                           remat_policy="none",
                           optimizer=AdamWConfig(**OPT)))
    if port:
        tr = Trainer(cfg, loader, tc, host_name="host0", device="cpu")
    else:
        from repro.models import build_model
        tr = Trainer(build_model(cfg), loader, tc, host_name="host0")
    agent = tr.connect_fleet(fleet.transport, clock=fleet.ck)
    taken = []
    fleet.attach(agent, taken)
    _tap_loader(loader, taken)
    try:
        tr.run()
    finally:
        fleet.close()
    rows = _row_index(dataset)
    events = [e for e in fleet.coord.events
              if e["kind"] in ("reshard", "consensus")]
    return dict(
        indices=[_indices(b, rows) for b in taken],
        losses=[r["loss"] for r in tr.history if "loss" in r],
        lrs=[r["lr"] for r in tr.history if "loss" in r],
        rescale=[{k: r[k] for k in ("scale", "global_batch", "peak_lr")}
                 for r in tr.history if r.get("event") == "lr_rescale"],
        events=[(e["kind"], e["reason"], e.get("barrier"),
                 e.get("geometry_epoch")) for e in events],
        peer_rows={h: [t.tobytes() for t in ts]
                   for h, ts in fleet.delivered.items()},
        steps=agent.steps, rounds=fleet.rounds, trainer=tr)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m"])
def test_torch_fleet_trainer_matches_repro(arch, tmp_path):
    """Three hosts, host2's death mid-epoch, the reshard with makeup and
    the geometry latch at the next epoch, through both packages'
    fleet-attached Trainers from one checkpoint: every step's batch
    indices are equal exactly, the losses to rtol 1e-4, the final
    parameters to atol 1e-5 / rtol 1e-4, and the rescaled LR is equal."""
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import build_model
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import named_from_tree

    jstep = jts.TrainStepConfig(remat_policy="none",
                                optimizer=jopt.AdamWConfig(**OPT))
    init = jts.init_train_state(build_model(jax_reduced(jax_get_config(
        arch))), jax.random.PRNGKey(3), jstep)
    for d in ("jax", "port"):
        JaxCheckpointer(str(tmp_path / d)).save(0, init, block=True)

    ref = _run(False, arch, str(tmp_path / "jax"))
    got = _run(True, arch, str(tmp_path / "port"))

    # the scenario: one death reshard mid-epoch with a geometry latch
    reshard = [e for e in got["events"] if e[0] == "reshard"]
    assert len(reshard) == 1 and reshard[0][1] == "dead"
    barrier, latch = reshard[0][2], reshard[0][3]
    assert DEATH_ROUND < barrier < BPE and latch == 1
    sizes = [len(i) for i in got["indices"]]
    # 4-row old-shard slices up to the barrier, 6-row makeup and new-shard
    # slices to the epoch's end, 4 rows again at global batch 8
    assert sizes[:barrier] == [4] * barrier
    assert 6 in sizes and sizes[-1] == 4
    assert got["steps"] == got["rounds"] == STEPS
    assert got["rescale"] == [{"scale": 8 / 12, "global_batch": 8,
                               "peak_lr": OPT["peak_lr"] * 8 / 12}]

    assert got["indices"] == ref["indices"]
    assert got["peer_rows"] == ref["peer_rows"]
    assert got["events"] == ref["events"]
    assert got["rescale"] == ref["rescale"]
    np.testing.assert_allclose(got["lrs"], ref["lrs"], rtol=1e-6)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    cfg = reduced(get_config(arch))
    expect = named_from_tree(jax.tree_util.tree_map(
        np.asarray, ref["trainer"].state.params), cfg.num_layers)
    params = got["trainer"].state.params
    assert params.keys() == expect.keys()
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), expect[k],
                                   atol=1e-5, rtol=1e-4, err_msg=k)


# --------------------------------------------------------------------------
# the serving host: BatchingFrontend.connect_fleet
# --------------------------------------------------------------------------
SERVE_GROUPS = ((14, 5), (14, 5), (9, 4), (9, 4), (14, 5))  # (prompt, new)
MAX_BATCH = 4


def _serve_run(port, jmodel, params, tmodel, vocab):
    """Serve ``SERVE_GROUPS`` (one batch of ``MAX_BATCH`` requests each)
    through one package's fleet-attached frontend.  A ``BatchMixMonitor``
    asks the fleet for a re-consensus when the served shapes change."""
    from _torch_support import fleet_loader, make_index_dataset
    data, tuning, fleet, _ = fleet_modules(port)
    if port:
        from repro_torch.serve.engine import (BatchingFrontend,
                                              BatchMixMonitor, ServeEngine)
        engine = ServeEngine(tmodel, max_batch=MAX_BATCH, max_len=64,
                             device="cpu")
    else:
        from repro.serve.engine import (BatchingFrontend, BatchMixMonitor,
                                        ServeEngine)
        engine = ServeEngine(jmodel, params, max_batch=MAX_BATCH,
                             max_len=64)
    clock = [0.0]
    ck = lambda: clock[0]  # noqa: E731
    transport = tuning.LocalTransport()
    coord = tuning.FleetCoordinator(
        config=tuning.FleetConfig(heartbeat_timeout_s=30.0,
                                  warmup_steps=10_000, num_cpu_cores=4,
                                  num_devices=1, max_prefetch=2,
                                  retune_budget_batches=2),
        clock=ck)
    server = fleet.CoordinatorServer(coord, transport, owner="coord-0")
    ingested = []
    real_ingest = coord.ingest

    def ingest(report):
        ingested.append(report.host)
        return real_ingest(report)
    coord.ingest = ingest
    table = lambda i, j: 4.0 / i + 0.1 * j  # noqa: E731

    def loader(h):
        return fleet_loader(make_index_dataset(64, port=port), 8,
                            shuffle=True, seed=1, host_index=h, host_count=2,
                            params=data.LoaderParams(num_workers=1,
                                                     prefetch_factor=1),
                            port=port)
    peer = tuning.connect_host(transport, "host1", loader(1),
                               evaluator=make_table_evaluator(table,
                                                              port=port),
                               clock=ck)
    peer_stream = peer.loader.stream(to_device=False)
    features = loader(0)
    frontend = BatchingFrontend(engine, max_wait_s=0.5)
    agent = frontend.connect_fleet(transport, features, host="serve0",
                                   clock=ck)
    agent.evaluator = make_table_evaluator(table, port=port)
    frontend.mix_monitor = BatchMixMonitor(
        window=2, threshold=0.3, cooldown=2,
        on_drift=lambda mix: agent.notify_drift("batch-mix"))
    stream = features.stream(to_device=True)
    served, beats = [], [0]
    real_observe, real_beat = agent.observe, agent.heartbeat

    def observe(*, data_s, step_s):
        # one fleet round per served group, on the serving thread
        real_observe(data_s=data_s, step_s=step_s)
        batch = next(stream)
        served.append({"x": np.asarray(batch["x"]).copy(),
                       "cell": agent.param_cell()})
        clock[0] += 1.0
        next(peer_stream)
        peer.observe(data_s=0.001, step_s=step_s)
        transport.pump()
        server.tick()
        server.poll()

    def heartbeat():
        beats[0] += 1
        real_beat()
    agent.observe, agent.heartbeat = observe, heartbeat
    rng = np.random.default_rng(9)
    groups = []
    try:
        for plen, new in SERVE_GROUPS:
            prompts = rng.integers(0, vocab, (MAX_BATCH, plen)).astype(
                np.int32)
            reqs = [frontend.submit(p, new) for p in prompts]
            groups.append((prompts, np.stack(
                [r.result.get(timeout=300) for r in reqs])))
            time.sleep(0.25)                 # idle: the frontend beats
    finally:
        frontend.shutdown()
        frontend._thread.join(timeout=10)
        stream.close()
        peer_stream.close()
    consensus = [e for e in coord.events if e["kind"] == "consensus"]
    return dict(groups=groups, served=served, beats=beats[0],
                reports=ingested.count("serve0"),
                batches=frontend.batches_served,
                consensus=[(e["reason"], tuple(e["params"]),
                            e["cell_applied"]) for e in consensus],
                cell=agent.param_cell(),
                loader_cell=(features.params.num_workers,
                             features.params.prefetch_factor),
                alive="serve0" in coord.registry.alive_hosts(),
                engine=engine)


def test_torch_fleet_frontend_matches_repro():
    """A reduced qwen2 frontend attached with ``connect_fleet``: one
    report per served batch, heartbeats while idle, a batch-mix drift that
    makes the fleet push a cell into the serving host's loader, feature
    batches from that loader once per served group, and greedy tokens
    equal to ``repro``'s frontend and to the port's engine without a
    fleet."""
    from _torch_support import jax_and_port
    jmodel, params, tmodel, cfg = jax_and_port("qwen2-0.5b")
    ref = _serve_run(False, jmodel, params, tmodel, cfg.vocab_size)
    got = _serve_run(True, jmodel, params, tmodel, cfg.vocab_size)

    assert got["batches"] == len(SERVE_GROUPS)
    assert got["reports"] == got["batches"]       # one report a batch
    assert got["beats"] > 0 and got["alive"]
    reasons = [c[0] for c in got["consensus"]]
    assert reasons == ["batch-mix"]
    _, cell, applied = got["consensus"][0]
    assert applied and cell == got["cell"] == got["loader_cell"]
    # the push landed while serving: later groups ran on the new cell
    assert got["served"][0]["cell"] != cell
    assert got["served"][-1]["cell"] == cell
    for (prompts, toks), (rprompts, rtoks) in zip(got["groups"],
                                                  ref["groups"]):
        np.testing.assert_array_equal(prompts, rprompts)
        np.testing.assert_array_equal(toks, rtoks)
        np.testing.assert_array_equal(
            toks, got["engine"].generate(prompts, toks.shape[1]).tokens)
    assert [s["x"].tolist() for s in got["served"]] == \
        [s["x"].tolist() for s in ref["served"]]
    assert got["consensus"] == ref["consensus"]
    assert got["reports"] == ref["reports"]
