"""The port's online tuning and fault-tolerance helpers against the JAX
package: the OnlineTuner cases of tests/test_tuning.py and the online
locality cases of tests/test_locality.py.

Where the reference drives a table or simulator evaluator, each case runs
in both packages on the same evaluator (each package's own
``TransferStats`` / ``SimulatorEvaluator`` over the same numbers) and the
two runs must agree exactly: the applied params, ``retunes``, the history
outcomes and the DPTCache entries.  The wall-clock case keeps the
reference's own assertions.  ``StragglerDetector``, ``HeartbeatRegistry``,
``FailureInjector`` and ``plan_remesh`` are held against the reference on
scripted inputs.
"""
import importlib
import types

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _pkg(name):
    """One package's modules the cases use, under common names."""
    imp = lambda m: importlib.import_module(f"{name}.{m}")
    return types.SimpleNamespace(
        name=name, data=imp("data"), tuning=imp("tuning"),
        cache=imp("core.cache"), dpt=imp("core.dpt"),
        monitor=imp("core.monitor"), loader=imp("data.loader"),
        simulator=imp("core.simulator"), evaluators=imp("core.evaluators"),
        ft=imp("distributed.fault_tolerance"),
        dev={} if name == "repro" else {"device": "cpu"})


def _both(case):
    """Run ``case(pkg)`` in both packages; the summaries must be equal."""
    out = [case(_pkg(name)) for name in PACKAGES]
    assert out[0] == out[1], out
    return out[0]


def _index_dataset(p, n):
    items = [np.full((4,), i, np.int32) for i in range(n)]
    return p.data.Dataset(p.data.ArrayStorage(items),
                          transform=lambda a: {"x": a})


def _table(p, fn, overflow=None):
    overflow = overflow or (lambda i, j: False)

    def ev(i, j, *, num_batches=16, epoch=0):
        ev.calls += 1
        if overflow(i, j):
            raise p.monitor.MemoryOverflow(f"cell ({i},{j})")
        return p.loader.TransferStats(fn(i, j), num_batches, 0)

    ev.calls = 0
    return ev


def _online_loader(p):
    return p.data.DataLoader(_index_dataset(p, 64), 8, shuffle=False, seed=0,
                             params=p.data.LoaderParams(num_workers=1,
                                                        prefetch_factor=1),
                             **p.dev)


def _online_cfg(p, **kw):
    base = dict(stall_fraction=0.3, window=4, warmup_steps=2,
                cooldown_steps=6, retune_budget_batches=2, max_prefetch=3,
                num_cpu_cores=4, num_devices=1)
    base.update(kw)
    return p.tuning.OnlineTunerConfig(**base)


def _summary(tuner, dl, cache=None):
    """What must agree across the packages after a case."""
    keep = ("outcome", "reason", "params", "locality_chunk",
            "cache_budget_bytes", "slow_lane_workers", "optimal_time",
            "measurements", "step")
    return {"params": (dl.params.num_workers, dl.params.prefetch_factor,
                       dl.params.locality_chunk),
            "retunes": tuner.retunes,
            "history": [{k: h[k] for k in keep} for h in tuner.history],
            "cache": dict(cache._store) if cache is not None else None}


# --------------------------------------------------------------------------
# OnlineTuner: the cases of tests/test_tuning.py
# --------------------------------------------------------------------------
def test_torch_online_tuner_retunes_on_goodput_drift(tmp_path):
    def case(p):
        ev = _table(p, lambda i, j: 4.0 / i + 0.1 * j)  # optimum: many workers
        cache = p.cache.DPTCache(str(tmp_path / f"{p.name}.json"))
        dl = _online_loader(p)
        tuner = p.tuning.OnlineTuner(dl, evaluator=ev, cache=cache,
                                     config=_online_cfg(p),
                                     machine_fp="m", dataset_fp="d")
        # healthy phase: data fully hidden behind compute -> no retune
        for _ in range(8):
            assert tuner.observe(data_s=0.001, step_s=0.1) is None
        assert tuner.retunes == 0
        # drift: the step now stalls on data
        applied = None
        for _ in range(8):
            applied = applied or tuner.observe(data_s=0.09, step_s=0.1)
        assert applied is not None
        assert tuner.retunes == 1
        assert dl.params.num_workers == 4           # hillclimbed to the edge
        assert cache.get("m", "d", dl.global_batch) == (4, 1)
        return dict(_summary(tuner, dl, cache), calls=ev.calls)

    _both(case)


def test_torch_online_tuner_respects_cooldown():
    def case(p):
        ev = _table(p, lambda i, j: 1.0)
        dl = _online_loader(p)
        tuner = p.tuning.OnlineTuner(dl, evaluator=ev,
                                     config=_online_cfg(p, cooldown_steps=100),
                                     machine_fp="m", dataset_fp="d")
        retunes = sum(tuner.observe(data_s=0.09, step_s=0.1) is not None
                      for _ in range(40))
        assert retunes <= 1
        return dict(_summary(tuner, dl), calls=ev.calls)

    _both(case)


def test_torch_online_tuner_restores_params_when_search_overflows():
    def case(p):
        ev = _table(p, lambda i, j: 1.0, overflow=lambda i, j: True)
        dl = _online_loader(p)
        orig = dl.params
        tuner = p.tuning.OnlineTuner(dl, evaluator=ev, config=_online_cfg(p),
                                     machine_fp="m", dataset_fp="d")
        assert tuner.force_retune() is None
        assert dl.params == orig
        assert tuner.retunes == 0
        return _summary(tuner, dl)

    _both(case)


def test_torch_online_tuner_restores_params_on_unexpected_error():
    """A non-MemoryOverflow evaluator crash mid-search must not leave a
    trial cell's params installed on the loader."""
    def case(p):
        def ev(i, j, **kw):
            raise OSError("storage went away")

        dl = _online_loader(p)
        orig = dl.params
        tuner = p.tuning.OnlineTuner(dl, evaluator=ev, config=_online_cfg(p),
                                     machine_fp="m", dataset_fp="d")
        with pytest.raises(OSError):
            tuner.force_retune()
        assert dl.params == orig
        return _summary(tuner, dl)

    _both(case)


def test_torch_online_tuner_anti_churn_holds_off_lattice():
    """Current params not on the search lattice: the hillclimb's start
    trial is still the improvement reference, so a same-cost 'winner' is
    not applied."""
    def case(p):
        ev = _table(p, lambda i, j: 1.0)            # flat objective
        dl = p.data.DataLoader(_index_dataset(p, 64), 8, shuffle=False,
                               seed=0, params=p.data.LoaderParams(
                                   num_workers=3, prefetch_factor=2),
                               **p.dev)
        tuner = p.tuning.OnlineTuner(
            dl, evaluator=ev,
            config=_online_cfg(p, num_cpu_cores=8, num_devices=2),
            machine_fp="m", dataset_fp="d")
        assert tuner.force_retune() is None         # no >=5% win anywhere
        assert dl.params.num_workers == 3           # kept, not churned
        return dict(_summary(tuner, dl), calls=ev.calls)

    _both(case)


# --------------------------------------------------------------------------
# the online locality loop: the cases of tests/test_locality.py
# --------------------------------------------------------------------------
def test_torch_online_retune_converges_to_grid_optimal_chunk_simulator():
    """Through the virtual-time evaluator the online sweep resolves the
    locality axis exactly where the grid does."""
    def case(p):
        sim = p.simulator.LoaderSimulator(p.data.coco_profile(80),
                                          p.simulator.MachineProfile())
        ds = p.data.synthetic_image_dataset(64, 8, seed=0)
        dl = p.data.DataLoader(ds, 64, params=p.data.LoaderParams(
            num_workers=4, prefetch_factor=2), shuffle=True, seed=0, **p.dev)
        cfg = p.tuning.OnlineTunerConfig(
            num_cpu_cores=4, num_devices=2, max_prefetch=2,
            retune_budget_batches=8, strategy="grid",
            locality_chunks=(0, 64))
        tuner = p.tuning.OnlineTuner(
            dl, evaluator=p.evaluators.SimulatorEvaluator(sim, batch_size=64),
            config=cfg, machine_fp="m", dataset_fp="d")
        params = tuner.force_retune()
        assert params is not None and params.locality_chunk == 64

        grid = p.tuning.tune(
            evaluator=p.evaluators.SimulatorEvaluator(sim, batch_size=64),
            strategy="grid",
            config=p.dpt.DPTConfig(num_cpu_cores=4, num_devices=2,
                                   max_prefetch=2, num_batches=8,
                                   locality_chunks=(0, 64)),
            measure_default=False)
        assert grid.locality_chunk == 64 == params.locality_chunk
        return dict(_summary(tuner, dl),
                    grid=(grid.nworker, grid.nprefetch, grid.optimal_time))

    _both(case)


def _port_cold_dataset(n, latency_s):
    """tests/conftest.py's ``make_cold_dataset`` built from the port."""
    from repro_torch.data import ArrayStorage, Dataset, LatencyStorage
    from repro_torch.data.dataset import image_transform
    rng = np.random.default_rng(0)
    items = [rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
             for _ in range(n)]
    return Dataset(LatencyStorage(ArrayStorage(items), latency_s=latency_s,
                                  bandwidth=1e9),
                   transform=image_transform)


def test_torch_online_retune_keeps_good_chunk():
    """Anti-churn on the wall-clock loader: when the current chunk is
    already optimal, the sweep must not thrash it."""
    from repro_torch.core.evaluators import LoaderEvaluator
    from repro_torch.data import DataLoader, LoaderParams
    from repro_torch.tuning import OnlineTuner, OnlineTunerConfig
    ds = _port_cold_dataset(128, latency_s=5e-4)
    dl = DataLoader(ds, 32, params=LoaderParams(num_workers=1,
                                                prefetch_factor=1,
                                                locality_chunk=32),
                    shuffle=True, seed=0, device="cpu")
    cfg = OnlineTunerConfig(num_cpu_cores=2, num_devices=2, max_prefetch=1,
                            retune_budget_batches=4,
                            locality_chunks=(0, 32))
    tuner = OnlineTuner(dl, evaluator=LoaderEvaluator(dl, to_device=False),
                        config=cfg, machine_fp="m", dataset_fp="d")
    assert tuner.force_retune() is None
    assert dl.params.locality_chunk == 32


def test_torch_adaptive_controller_triggers_resize_on_run_len_collapse():
    """The controller proposes a resize when the live coalesced_run_len
    falls below half the active chunk — applied as an epoch-latched hot
    swap on the live stream."""
    def case(p):
        ds = p.data.synthetic_image_dataset(96, 8, seed=0)
        dl = p.data.DataLoader(ds, 16, params=p.data.LoaderParams(
            num_workers=1, locality_chunk=16), shuffle=True, seed=0, **p.dev)
        stream = dl.stream(to_device=False)
        try:
            next(stream)                                # live, mid-epoch
            ctl = p.tuning.AdaptiveLocalityController(
                dl, p.tuning.AdaptiveLocalityConfig(
                    patience=2, min_requests=4, cooldown_steps=0))
            snaps = [(10, 160, 0), (20, 320, 0), (30, 420, 50),
                     (40, 520, 100)]
            out = [ctl.observe({"coalesced_requests": r, "reads": n,
                                "cache_hits": h}) for r, n, h in snaps]
            assert out == [None, None, None, 4]         # 2^floor(log2(5))
            assert ctl.proposals == 1
            assert dl.params.locality_chunk == 4
            for _ in range(8):
                next(stream)
            assert stream.swaps == 1
            assert dl.sampler.chunk_for_epoch(0) == 16
            assert dl.sampler.locality_chunk == 4
        finally:
            stream.close()
        return {"out": out, "history": ctl.history,
                "schedule": dl.sampler.locality_state()}

    _both(case)


def test_torch_adaptive_controller_healthy_run_never_fires():
    def case(p):
        ds = p.data.synthetic_image_dataset(32, 8, seed=0)
        dl = p.data.DataLoader(ds, 8, params=p.data.LoaderParams(
            locality_chunk=8), shuffle=True, seed=0, **p.dev)
        ctl = p.tuning.AdaptiveLocalityController(
            dl, p.tuning.AdaptiveLocalityConfig(
                patience=1, min_requests=4, cooldown_steps=0))
        ctl.observe({"coalesced_requests": 10, "reads": 80, "cache_hits": 0})
        for k in range(2, 6):       # run length stays ~8 = the chunk
            assert ctl.observe({"coalesced_requests": 10 * k,
                                "reads": 80 * k, "cache_hits": 0}) is None
        assert ctl.proposals == 0
        assert dl.params.locality_chunk == 8
        return ctl.history

    _both(case)


def test_torch_adaptive_controller_routes_to_fleet_not_local():
    """On a sharded fleet the controller never changes locality locally —
    the proposal routes to on_propose (the coordinator)."""
    def case(p):
        ds = p.data.synthetic_image_dataset(64, 8, seed=0)
        dl = p.data.DataLoader(ds, 16, params=p.data.LoaderParams(
            locality_chunk=16), shuffle=True, seed=0, host_index=0,
            host_count=2, **p.dev)
        routed = []
        ctl = p.tuning.AdaptiveLocalityController(
            dl, p.tuning.AdaptiveLocalityConfig(
                patience=1, min_requests=4, cooldown_steps=0),
            on_propose=routed.append)
        ctl.observe({"coalesced_requests": 10, "reads": 160,
                     "cache_hits": 0})
        ctl.observe({"coalesced_requests": 20, "reads": 260,
                     "cache_hits": 50})
        assert routed == [4]                        # run 50/10 -> snap 4
        assert dl.params.locality_chunk == 16       # untouched locally
        return routed, ctl.history

    _both(case)


def test_torch_adaptive_controller_never_applies_locally_on_sharded_loader():
    def case(p):
        ds = p.data.synthetic_image_dataset(64, 8, seed=0)
        dl = p.data.DataLoader(ds, 16, params=p.data.LoaderParams(
            locality_chunk=16), shuffle=True, seed=0, host_index=0,
            host_count=2, **p.dev)
        ctl = p.tuning.AdaptiveLocalityController(
            dl, p.tuning.AdaptiveLocalityConfig(
                patience=1, min_requests=4, cooldown_steps=0))
        ctl.observe({"coalesced_requests": 10, "reads": 160,
                     "cache_hits": 0})
        assert ctl.observe({"coalesced_requests": 20, "reads": 180,
                            "cache_hits": 0}) is None
        assert ctl.proposals == 0
        assert dl.params.locality_chunk == 16
        return ctl.proposals

    _both(case)


# --------------------------------------------------------------------------
# fault tolerance: scripted inputs through both packages
# --------------------------------------------------------------------------
def test_torch_straggler_detector_matches_jax():
    rng = np.random.default_rng(0)
    script = [(h, float(rng.uniform(0.9, 1.1)) * (2.0 if h == "c" else 1.0))
              for _ in range(20) for h in ("a", "b", "c", "d")]

    def case(p):
        det = p.ft.StragglerDetector(window=8, threshold=1.5)
        seen = []
        for h, s in script:
            det.record(h, s)
            seen.append(det.stragglers())
        det.forget("d")
        assert det.stragglers() == ["c"]
        one = p.ft.StragglerDetector()
        one.record("a", 1.0)
        assert one.stragglers() == []
        return seen, det.medians(), det.state_dict()

    _both(case)


def test_torch_heartbeat_and_failure_injector_match_jax():
    def case(p):
        t = [0.0]
        reg = p.ft.HeartbeatRegistry(timeout_s=10, clock=lambda: t[0])
        reg.beat("a")
        reg.beat("b")
        t[0] = 5.0
        reg.beat("a")
        t[0] = 12.0
        assert reg.dead_hosts() == ["b"]
        assert reg.alive_hosts() == ["a"]
        inj = p.ft.FailureInjector({3: ["h1"], 7: ["h2", "h3"]})
        steps = [inj.advance(s) for s in range(9)]
        assert inj.dead == {"h1", "h2", "h3"}
        return reg.state_dict(), steps

    _both(case)


@pytest.mark.parametrize("alive,dph,model_axis,old,gb", [
    (30, 8, 16, 32, 256), (3, 8, 16, 32, 256), (7, 4, 4, 8, 96),
    (5, 2, 4, 6, 30), (1, 1, 1, 4, 8), (9, 8, 8, 16, 1000)])
def test_torch_plan_remesh_matches_jax(alive, dph, model_axis, old, gb):
    def case(p):
        return p.ft.plan_remesh(alive_hosts=alive, devices_per_host=dph,
                                model_axis=model_axis, old_hosts=old,
                                old_global_batch=gb, restore_step=100
                                ).__dict__

    plan = _both(case)
    if (alive, old) == (30, 32):
        assert plan["feasible"] and plan["new_data_axis"] == 15
        assert plan["new_global_batch"] == 240
    if (alive, old) == (3, 32):
        assert not plan["feasible"]
