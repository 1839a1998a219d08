"""The paper's full workflow on the PyTorch port: the CIFAR-10 grid (Fig 2)
and a slice of the COCO resolution study (Table 1) on the calibrated
testbed model, the beyond-paper tuners finding the same optimum for a
fraction of the measurements, then the same shims on a real loader that
delivers to the device.

The study runs on the virtual-time simulator (``SimulatorEvaluator``), so
its numbers are the model's, not this machine's.  The last section
measures a live loader on ``--device`` (the card unless ``--device cpu``).

    PYTHONPATH=src python examples/torch_tune_dataloader.py
    PYTHONPATH=src python examples/torch_tune_dataloader.py --device cpu --items 64
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (DPT, DPTConfig, LoaderEvaluator,
                              LoaderSimulator, MachineProfile,
                              SimulatorEvaluator, default_params)
from repro_torch.core.search import successive_halving, tuned_with_warmstart
from repro_torch.data import DataLoader, LatencyStorage, synthetic_image_dataset
from repro_torch.data.storage import cifar10_profile, coco_profile

MACHINE = MachineProfile()    # the paper's i7-8700K / 64 GB / 1 GPU testbed


def tune(profile, batch, epoch, label):
    ev = SimulatorEvaluator(LoaderSimulator(profile, MACHINE),
                            batch_size=batch)
    cfg = DPTConfig(num_cpu_cores=12, num_devices=1, max_prefetch=8,
                    num_batches=48, epoch=epoch)
    res = DPT(ev, cfg).run()
    print(f"{label:24s} optimal=({res.nworker:2d},{res.nprefetch})  "
          f"default={default_params(12)}  "
          f"speedup={res.speedup_vs_default:.2f}x  "
          f"cells={len(res.trials)}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--items", type=int, default=256,
                    help="images behind the live loader of the last section")
    args = ap.parse_args()

    print("== CIFAR-10 (paper Fig 2: optimum ~10 workers, ~1.3x) ==")
    tune(cifar10_profile(), 32, epoch=1, label="cifar10 b32 warm")

    print("\n== COCO resolutions (paper Table 1 regimes) ==")
    for res_px in (80, 160, 320, 640):
        tune(coco_profile(res_px), 32, epoch=0,
             label=f"coco {res_px}px b32 cold")
    tune(coco_profile(80), 32, epoch=1, label="coco 80px b32 warm")

    print("\n== beyond-paper: same optimum, fewer measurements ==")
    storage = coco_profile(160)
    ev = SimulatorEvaluator(LoaderSimulator(storage, MACHINE), batch_size=32)
    cfg = DPTConfig(num_cpu_cores=12, num_devices=1, max_prefetch=8,
                    num_batches=48, epoch=0)
    grid = DPT(ev, cfg).run(measure_default=False)
    grid_cost = ev.calls

    ev2 = SimulatorEvaluator(LoaderSimulator(storage, MACHINE), batch_size=32)
    sh = successive_halving(ev2, config=cfg)
    ev3 = SimulatorEvaluator(LoaderSimulator(storage, MACHINE), batch_size=32)
    hc = tuned_with_warmstart(ev3, storage, MACHINE, batch_size=32,
                              config=cfg)
    print(f"grid search     : ({grid.nworker},{grid.nprefetch}) "
          f"in {grid_cost} measurements")
    print(f"succ. halving   : ({sh.nworker},{sh.nprefetch}) "
          f"in {ev2.calls} cheaper measurements")
    print(f"warm+hillclimb  : ({hc.nworker},{hc.nprefetch}) "
          f"in {ev3.calls} measurements")

    print(f"\n== successive halving on a live loader ({args.device}) ==")
    raw = synthetic_image_dataset(args.items, 32, seed=0)
    ds = raw.with_storage(LatencyStorage(raw.storage, latency_s=1e-3,
                                         bandwidth=400e6))
    loader = DataLoader(ds, 16, seed=0, device=args.device)
    live = successive_halving(
        LoaderEvaluator(loader, to_device=True),
        config=DPTConfig(num_cpu_cores=4, num_devices=1, max_prefetch=2,
                         num_batches=8))
    print(f"live loader     : ({live.nworker},{live.nprefetch}) "
          f"-> {live.optimal_time:.3f}s for 8 batches "
          f"in {len(live.trials)} trials")


if __name__ == "__main__":
    main()
