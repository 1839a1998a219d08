"""Shared helpers for the PyTorch port's tests (``test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both packages; model
parameters are drawn by the JAX package and carried into the port with
``repro_torch.models.convert.from_jax_params``.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# The tensors here are tiny; one intra-op thread keeps these tests from
# competing for cores with the wall-clock tests running beside them.
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rand(seed: int, shape, dtype: str = "float32"):
    """The same standard-normal array for both frameworks:
    returns (jax array, torch tensor) in ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def as_f32(x) -> np.ndarray:
    """A JAX array or torch tensor of any float type as a float32 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def jax_and_port(arch: str, seed: int = 0):
    """Reduced ``arch`` in both packages with the same parameters:
    (jax model, jax params, port model on the CPU, reduced config)."""
    from repro.configs import get_config, reduced
    from repro.models import build_model
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.configs import reduced as port_reduced
    from repro_torch.models.convert import from_jax_params

    cfg = reduced(get_config(arch))
    jmodel = build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = from_jax_params(port_reduced(port_get_config(arch)), tree,
                           device="cpu")
    return jmodel, params, port, cfg


def long_tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


# ---- the data plane: one dataset and loader in each package ---------------

def image_loaders(params=None, *, n: int = 96, res: int = 8, gb: int = 8,
                  seed: int = 0, latency_s: float = 0.0, fault_spec=None,
                  shuffle: bool = True):
    """The same seeded ``synthetic_image_dataset`` and ``LoaderParams`` in
    both packages: (repro loader, port loader on the CPU).  With
    ``latency_s`` the items sit behind a ``LatencyStorage``; with
    ``fault_spec`` (``StorageFaultSpec`` fields) each package wraps them in
    its own ``FaultyStorage``."""
    import repro.data as jdata
    import repro_torch.data as tdata

    out = []
    for pkg in (jdata, tdata):
        ds = pkg.synthetic_image_dataset(n, res, seed=seed)
        storage = ds.storage
        if latency_s:
            storage = pkg.LatencyStorage(storage, latency_s=latency_s,
                                         bandwidth=1e9)
        if fault_spec is not None:
            storage = pkg.FaultyStorage(
                storage, pkg.StorageFaultSpec(**fault_spec))
        ds = ds.with_storage(storage)
        kw = {} if pkg is jdata else {"device": "cpu"}
        out.append(pkg.DataLoader(ds, gb, params=pkg.LoaderParams(
            **(params or {})), seed=seed, shuffle=shuffle, **kw))
    return tuple(out)


def host_copy(batch) -> dict:
    """A delivered batch (numpy, JAX or torch fields) as private numpy
    arrays, taken at once (a zero-copy slab is recycled later)."""
    return {k: (v.numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy() for k, v in batch.items()}


def same_bytes(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def batch_key(batch: dict) -> bytes:
    """One batch's bytes, field by field in name order (for multisets)."""
    return b"".join(k.encode() + batch[k].tobytes() for k in sorted(batch))


# ---- the fleet control plane: the reference tests' harness, in either
# package (``port=False`` builds ``repro``'s, for parity runs) ------------

def fleet_modules(port: bool = True):
    """(data, tuning, tuning.fleet, core.cluster) of one package."""
    if port:
        import repro_torch.core.cluster as cluster
        import repro_torch.data as data
        import repro_torch.tuning as tuning
        import repro_torch.tuning.fleet as fleet
    else:
        import repro.core.cluster as cluster
        import repro.data as data
        import repro.tuning as tuning
        import repro.tuning.fleet as fleet
    return data, tuning, fleet, cluster


def make_index_dataset(n, *, width=4, transform=None, port=True):
    """Dataset whose sample VALUES are their indices (see
    ``flat_indices``); ``transform`` receives the raw ``(width,)`` array."""
    data = fleet_modules(port)[0]
    items = [np.full((width,), i, np.int32) for i in range(n)]
    return data.Dataset(data.ArrayStorage(items),
                        transform=transform or (lambda a: {"x": a}))


def fleet_loader(dataset, global_batch, *, port=True, **kw):
    """A DataLoader of either package; the port's delivers to the CPU."""
    data = fleet_modules(port)[0]
    if port:
        kw.setdefault("device", "cpu")
    return data.DataLoader(dataset, global_batch, **kw)


def flat_indices(batches):
    """Sorted sample indices recovered from index-dataset batches."""
    return sorted(np.concatenate(
        [np.asarray(b["x"])[:, 0] for b in batches]).tolist())


def make_table_evaluator(fn, *, locality=False, cache=False, port=True):
    """Synthetic evaluator over a (nworker, nprefetch[, chunk]) table that
    records its calls and budgets (``tests/conftest.py``'s, in either
    package)."""
    TransferStats = fleet_modules(port)[0].TransferStats

    if cache:
        def ev(i, j, *, num_batches=16, epoch=0, locality_chunk=None,
               cache_budget_bytes=None):
            ev.calls += 1
            ev.budgets.append(num_batches)
            ev.epochs.append(epoch)
            return TransferStats(fn(i, j, locality_chunk or 0,
                                    cache_budget_bytes or 0, epoch),
                                 num_batches, 0)
    elif locality:
        def ev(i, j, *, num_batches=16, epoch=0, locality_chunk=None):
            ev.calls += 1
            ev.budgets.append(num_batches)
            return TransferStats(fn(i, j, locality_chunk or 0),
                                 num_batches, 0)
    else:
        def ev(i, j, *, num_batches=16, epoch=0):
            ev.calls += 1
            ev.budgets.append(num_batches)
            return TransferStats(fn(i, j), num_batches, 0)
    ev.calls = 0
    ev.budgets = []
    ev.epochs = []
    return ev


class FleetHarness:
    """A live in-process fleet: coordinator + one HostAgent/loader/stream
    per host, driven by a fake clock."""

    def __init__(self, n=480, gb=12, hosts=3, *, timeout=5.0, seed=5,
                 evaluator_fn=lambda i, j: 4.0 / i + 0.1 * j,
                 config=None, port=True, **cfg_kw):
        _, tuning, _, _ = fleet_modules(port)
        self.clock = [0.0]
        defaults = dict(heartbeat_timeout_s=timeout, warmup_steps=2,
                        cooldown_steps=4, num_cpu_cores=4, num_devices=1,
                        max_prefetch=2, retune_budget_batches=2)
        defaults.update(cfg_kw)
        cfg = config or tuning.FleetConfig(**defaults)
        self.coord = tuning.FleetCoordinator(config=cfg,
                                             clock=lambda: self.clock[0])
        LoaderParams = fleet_modules(port)[0].LoaderParams
        self.agents, self.streams = [], []
        for h in range(hosts):
            dl = fleet_loader(make_index_dataset(n, port=port), gb,
                              shuffle=True, seed=seed,
                              params=LoaderParams(num_workers=2,
                                                  prefetch_factor=2),
                              host_index=h, host_count=hosts, port=port)
            self.agents.append(self.coord.register(tuning.HostAgent(
                f"host{h}", dl,
                evaluator=make_table_evaluator(evaluator_fn, port=port))))
            self.streams.append(dl.stream(to_device=False))

    def tick(self, dt=1.0):
        self.clock[0] += dt

    def close(self):
        for s in self.streams:
            try:
                s.close()
            except Exception:
                pass


class WireFleet:
    """A transport-mode fleet (``tests/conftest.py``'s, in either
    package): hosts talk to a ``CoordinatorServer`` over a fault-injectable
    transport, a lease + snapshot store back a standby replica, and a fake
    clock drives heartbeats, lease expiry and failover.  ``rounds`` is one
    lockstep step of every alive host, then pump, tick, poll and the
    standby's watch (a promotion swaps ``server`` / ``coord``)."""

    def __init__(self, *, hosts=3, n=480, gb=12, faults=None, ttl=4.0,
                 heartbeat_timeout=6.0, link_config=None, port=True,
                 **cfg_kw):
        data, tuning, fleet, _ = fleet_modules(port)
        self.n, self.gb = n, gb
        self.bpe = n // gb
        self.clock = [0.0]
        ck = lambda: self.clock[0]  # noqa: E731
        self.transport = tuning.FaultyTransport(faults or tuning.FaultSpec())
        self.lease = tuning.LeaderLease(ttl_s=ttl, clock=ck)
        self.store = tuning.SnapshotStore()
        defaults = dict(heartbeat_timeout_s=heartbeat_timeout,
                        warmup_steps=2, cooldown_steps=4, num_cpu_cores=4,
                        num_devices=1, max_prefetch=2,
                        retune_budget_batches=2)
        defaults.update(cfg_kw)
        self.coord = tuning.FleetCoordinator(
            config=tuning.FleetConfig(**defaults), clock=ck)
        self.server = fleet.CoordinatorServer(
            self.coord, self.transport, owner="coord-0", lease=self.lease,
            store=self.store)
        self.replica = fleet.CoordinatorReplica(
            self.transport, self.lease, self.store, owner="coord-standby",
            clock=ck)
        self.agents, self.streams = [], []
        for h in range(hosts):
            dl = fleet_loader(make_index_dataset(n, port=port), gb,
                              shuffle=True, seed=5,
                              params=data.LoaderParams(num_workers=2,
                                                       prefetch_factor=2),
                              host_index=h, host_count=hosts, port=port)
            self.agents.append(tuning.connect_host(
                self.transport, f"host{h}", dl,
                evaluator=make_table_evaluator(
                    lambda i, j: 4.0 / i + 0.1 * j, port=port),
                clock=ck,
                link_config=link_config or tuning.LinkConfig(seed=h,
                                                             jitter=0.0)))
            self.streams.append(dl.stream(to_device=False))
        self.transport.pump()
        self.delivered = []

    def rounds(self, k, alive=None, *, poll=True):
        alive = list(alive if alive is not None else range(len(self.agents)))
        for _ in range(k):
            self.clock[0] += 1.0
            for h in alive:
                self.delivered.append(next(self.streams[h]))
                self.agents[h].observe(data_s=0.001, step_s=0.05)
            self.transport.pump()
            self.server.tick()
            if poll:
                self.server.poll()
            promoted = self.replica.tick()
            if promoted is not None:
                self.server = promoted
                self.coord = promoted.coord

    def drain(self, alive):
        for h in alive:
            s = self.streams[h]
            while s.position < self.bpe:
                self.delivered.append(next(s))

    def close(self):
        for s in self.streams:
            try:
                s.close()
            except Exception:
                pass


@pytest.fixture
def fleet_factory():
    """Factory for a live port fleet (see ``FleetHarness``); its streams
    close at teardown even when a test bails early."""
    built = []

    def build(*args, **kw):
        built.append(FleetHarness(*args, **kw))
        return built[-1]

    yield build
    for h in built:
        h.close()


@pytest.fixture
def wire_fleet():
    """Factory for a port :class:`WireFleet`; streams close at teardown."""
    built = []

    def build(**kw):
        built.append(WireFleet(**kw))
        return built[-1]

    yield build
    for f in built:
        f.close()


# ---- multi-rank tests: gloo ranks in processes of their own ----------------

RANK_TIMEOUT_S = 120


class RankFailure(AssertionError):
    """A spawned rank exited non-zero or outlived its timeout."""


def spawn_ranks(workdir, world, jobs, *, module: str = "_torch_dp_ranks"):
    """Start the ranks of a gloo group that joins through a ``FileStore``
    in ``workdir`` (no TCP port: the tests run under several xdist
    workers), each a process running ``tests/<module>.py``'s ``jobs`` in
    turn.  ``world`` is a rank count, or a mesh shape's tag such as
    ``"2x2"`` for a module that builds its mesh from it (one rank per
    device of the mesh).  Returns the processes; ``join_ranks`` waits for
    them."""
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [here, os.path.join(here, "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world_size(world)):
        log = open(os.path.join(workdir, f"log_{jobs[0]}_w{world}_r{rank}"),
                   "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import {module} as r; r.main()",
             str(workdir), str(world), str(rank), ",".join(jobs)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here), log))
    return procs


def world_size(world) -> int:
    """The rank count of ``world``: an int, or a mesh tag ``"2x2x2"``."""
    n = 1
    for d in str(world).split("x"):
        n *= int(d)
    return n


def join_ranks(procs, timeout: float = RANK_TIMEOUT_S) -> None:
    """Wait for every rank, at most ``timeout`` seconds in all; as soon as
    one exits non-zero or the time runs out, kill all of them and raise
    ``RankFailure`` with each log's tail, so a hung collective fails the
    test instead of holding the suite."""
    import time
    deadline = time.monotonic() + timeout
    why = None
    try:
        while why is None:
            rcs = [p.poll() for p, _ in procs]
            bad = [i for i, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                why = ", ".join(f"rank {i} rc {rcs[i]}" for i in bad)
            elif all(rc == 0 for rc in rcs):
                return
            elif time.monotonic() > deadline:
                why = f"timed out after {timeout} s"
            else:
                time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    tails = []
    for _, log in procs:
        with open(log.name) as f:
            tails.append(f"{log.name}:\n{f.read()[-2000:]}")
    raise RankFailure(why + "\n" + "\n".join(tails))


def rank_results(workdir, job: str, world: int):
    """Each rank's result of ``job`` at ``world``, in rank order."""
    import pickle
    out = []
    for rank in range(world_size(world)):
        with open(os.path.join(workdir, f"res_{job}_w{world}_r{rank}.pkl"),
                  "rb") as f:
            out.append(pickle.load(f))
    return out
