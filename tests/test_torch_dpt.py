"""The port's DPT core against ``repro``'s.

The paper-table checks of ``tests/test_dpt_reproduction.py`` re-run on the
port's ``SimulatorEvaluator``, and every registered tuning strategy gives
the same ``DPTResult`` (pick, trials, times) in both packages on the same
storage and machine profiles.  The simulator is deterministic, so the
comparison is exact.
"""
import dataclasses
import math

import pytest

import repro.core as jcore
import repro.data.storage as jstorage
import repro.tuning as jtuning
import repro_torch.core as tcore
import repro_torch.data.storage as tstorage
import repro_torch.tuning as ttuning


def run_dpt(profile, batch, epoch, max_prefetch=8, num_batches=64,
            device_ram=None):
    sim = tcore.LoaderSimulator(profile, tcore.MachineProfile())
    ev = tcore.SimulatorEvaluator(sim, batch_size=batch,
                                  device_ram=device_ram)
    cfg = tcore.DPTConfig(num_cpu_cores=12, num_devices=1,
                          max_prefetch=max_prefetch, num_batches=num_batches,
                          epoch=epoch)
    return tcore.DPT(ev, cfg).run(), ev


# ---- the paper-table checks, on the port ----------------------------------

def test_torch_cifar_optimal_workers_is_ten_ish():
    res, _ = run_dpt(tstorage.cifar10_profile(), 32, epoch=1)
    assert 9 <= res.nworker <= 11
    assert res.nworker != 6


def test_torch_cifar_speedup_over_default():
    res, _ = run_dpt(tstorage.cifar10_profile(), 32, epoch=1)
    assert 1.15 <= res.speedup_vs_default <= 1.6


@pytest.mark.parametrize("epoch", [0, 1])
def test_torch_small_resolution_speedups_match_table1d(epoch):
    res, _ = run_dpt(tstorage.coco_profile(80), 32, epoch=epoch)
    assert res.speedup_vs_default >= 1.10, (epoch, res.speedup_vs_default)


def test_torch_large_resolution_is_flat():
    res, _ = run_dpt(tstorage.coco_profile(640), 16, epoch=0)
    assert res.speedup_vs_default <= 1.20


def test_torch_cold_epoch_optimum_shifts_down_for_large_items():
    res_small, _ = run_dpt(tstorage.coco_profile(80), 16, epoch=0)
    res_large, _ = run_dpt(tstorage.coco_profile(640), 16, epoch=0)
    assert res_large.nworker < res_small.nworker


def test_torch_warm_epoch_much_faster_than_cold():
    _, ev = run_dpt(tstorage.coco_profile(80), 32, epoch=0)
    assert ev.epoch_seconds(10, 2, epoch=0) / \
        ev.epoch_seconds(10, 2, epoch=1) > 10


def test_torch_epoch_magnitudes_match_paper_order():
    _, ev80 = run_dpt(tstorage.coco_profile(80), 16, epoch=0)
    _, ev640 = run_dpt(tstorage.coco_profile(640), 16, epoch=0)
    assert 200 < ev80.epoch_seconds(10, 3, epoch=0) < 800
    assert 4 < ev80.epoch_seconds(10, 3, epoch=1) < 25
    assert 700 < ev640.epoch_seconds(6, 3, epoch=0) < 2600


def test_torch_memory_overflow_cell_matches_paper_na():
    sim = tcore.LoaderSimulator(tstorage.coco_profile(640),
                                tcore.MachineProfile())
    ev = tcore.SimulatorEvaluator(sim, batch_size=1024, device_ram=12e9)
    with pytest.raises(tcore.MemoryOverflow):
        ev(2, 1, num_batches=4)
    ev2 = tcore.SimulatorEvaluator(sim, batch_size=128, device_ram=12e9)
    assert math.isfinite(ev2(2, 1, num_batches=4).seconds)


def test_torch_prefetch_factor_matters_but_less_than_workers():
    sim = tcore.LoaderSimulator(tstorage.cifar10_profile(),
                                tcore.MachineProfile())
    ev = tcore.SimulatorEvaluator(sim, batch_size=32)
    t_workers = [ev(w, 2, num_batches=64, epoch=1).seconds for w in (2, 10)]
    t_prefetch = [ev(10, j, num_batches=64, epoch=1).seconds
                  for j in (1, 6)]
    prefetch_gain = max(t_prefetch) / min(t_prefetch)
    assert t_workers[0] / t_workers[1] > prefetch_gain > 1.0


def test_torch_dpt_resolve_reads_the_card_count():
    """``num_devices=None`` takes G from torch (no card here: G = 1)."""
    import torch
    n, g = tcore.DPTConfig(num_cpu_cores=8, num_devices=None).resolve()
    assert n == 8 and g == max(1, torch.cuda.device_count())


# ---- every strategy: the same DPTResult as repro's ------------------------

# (profile name, resolution, batch, epoch, device_ram): a compute-bound,
# a bandwidth-bound, and one whose large cells overflow the device
PROFILES = {
    "cifar_warm": ("cifar10_profile", None, 32, 1, None),
    "coco80_cold": ("coco_profile", 80, 16, 0, None),
    "coco640_overflow": ("coco_profile", 640, 256, 0, 12e9),
}


def _strategy_kwargs(name, pkg_storage, pkg_core, profile, batch):
    if name == "hillclimb":
        return {"start": (2, 1)}
    if name == "warmstart_hillclimb":
        return {"storage": profile, "machine": pkg_core.MachineProfile(),
                "batch_size": batch}
    if name == "goodput":
        return {"step_time_s": 0.05, "num_batches": 16}
    return {}


def _tune(pkg_core, pkg_storage, pkg_tuning, strategy, case):
    fn, res, batch, epoch, ram = PROFILES[case]
    profile = getattr(pkg_storage, fn)(*(() if res is None else (res,)))
    sim = pkg_core.LoaderSimulator(profile, pkg_core.MachineProfile())
    ev = pkg_core.SimulatorEvaluator(sim, batch_size=batch, device_ram=ram)
    cfg = pkg_core.DPTConfig(num_cpu_cores=12, num_devices=1,
                             max_prefetch=6, num_batches=32, epoch=epoch)
    return pkg_tuning.tune(
        evaluator=ev, strategy=strategy, config=cfg,
        **_strategy_kwargs(strategy, pkg_storage, pkg_core, profile, batch))


def test_torch_registry_matches_repro():
    assert ttuning.available_strategies() == jtuning.available_strategies()
    assert set(ttuning.available_strategies()) == {
        "grid", "successive_halving", "hillclimb", "warmstart_hillclimb",
        "goodput"}


@pytest.mark.parametrize("case", sorted(PROFILES))
@pytest.mark.parametrize("strategy", ["grid", "successive_halving",
                                      "hillclimb", "warmstart_hillclimb",
                                      "goodput"])
def test_torch_strategy_gives_repros_result(strategy, case):
    port = _tune(tcore, tstorage, ttuning, strategy, case)
    ref = _tune(jcore, jstorage, jtuning, strategy, case)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.trials and (port.nworker, port.nprefetch) == \
        (ref.nworker, ref.nprefetch)


def test_torch_dpt_run_goes_through_the_grid_strategy(monkeypatch):
    """``DPT.run`` is ``tune(strategy="grid")``, as in ``repro``."""
    seen = []
    real = ttuning.tune

    def spy(**kw):
        seen.append(kw["strategy"])
        return real(**kw)

    monkeypatch.setattr(ttuning, "tune", spy)
    res, _ = run_dpt(tstorage.cifar10_profile(), 32, epoch=1, max_prefetch=2,
                     num_batches=8)
    assert seen == ["grid"] and res.trials


@pytest.mark.parametrize("axes", [
    dict(locality_chunks=(0, 16)),
    dict(cache_budgets=(0, 1 << 26)),
    dict(slow_lanes=(0, 2)),
    dict(geometries=(0, 64)),
])
def test_torch_grid_extra_axes_match_repro(axes):
    """The beyond-paper grid axes pick and price as in ``repro``."""
    def run(core, storage):
        sim = core.LoaderSimulator(storage.coco_profile(80),
                                   core.MachineProfile())
        ev = core.SimulatorEvaluator(sim, batch_size=16)
        cfg = core.DPTConfig(num_cpu_cores=6, num_devices=1, max_prefetch=3,
                             num_batches=16, **axes)
        return core.DPT(ev, cfg).run()

    port, ref = run(tcore, tstorage), run(jcore, jstorage)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_torch_cost_model_warmstart_matches_repro():
    args = dict(batch_size=32)
    port = ttuning.cost_model_warmstart(
        tstorage.cifar10_profile(), tcore.MachineProfile(),
        config=tcore.DPTConfig(num_cpu_cores=12, num_devices=1), **args)
    ref = jtuning.cost_model_warmstart(
        jstorage.cifar10_profile(), jcore.MachineProfile(),
        config=jcore.DPTConfig(num_cpu_cores=12, num_devices=1), **args)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
