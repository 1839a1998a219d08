"""Quickstart on the PyTorch port: tune a real dataloader with DPT (paper
Algorithm 1) and deliver through the device edge.

Builds a synthetic image dataset behind a latency-injected storage layer,
runs the grid search over (num_workers, prefetch_factor) with the actual
thread-pool loader (wall clock, the copy to the device included), and
prints the tuned parameters against the framework default.  Runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --items 64
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import DPT, DPTConfig, LoaderEvaluator, default_params
from repro_torch.data.dataset import Dataset, image_transform
from repro_torch.data.loader import DataLoader, LoaderParams
from repro_torch.data.storage import ArrayStorage, LatencyStorage


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--cores", type=int, default=8,
                    help="worker counts the grid tries: 1 .. cores")
    ap.add_argument("--batches", type=int, default=8,
                    help="batches measured per grid cell")
    args = ap.parse_args()

    # synthetic images behind a 2 ms-latency storage layer
    rng = np.random.default_rng(0)
    r = args.resolution
    items = [rng.integers(0, 255, (r, r, 3), dtype=np.uint8)
             for _ in range(args.items)]
    storage = LatencyStorage(ArrayStorage(items), latency_s=2e-3,
                             bandwidth=400e6)
    dataset = Dataset(storage, transform=image_transform)
    loader = DataLoader(dataset, global_batch=32, shuffle=True,
                        device=args.device)

    print(f"== DPT (Algorithm 1) on {args.device}: grid search over "
          f"(nWorker, nPrefetch) ==")
    evaluator = LoaderEvaluator(loader, to_device=True)
    dpt = DPT(evaluator, DPTConfig(num_cpu_cores=args.cores, num_devices=1,
                                   max_prefetch=4, num_batches=args.batches))
    result = dpt.run()

    dw, dp = default_params(args.cores)
    print(f"cells measured : {len(result.trials)}")
    print(f"default params : workers={dw} prefetch={dp} "
          f"-> {result.default_time:.3f}s")
    print(f"tuned params   : workers={result.nworker} "
          f"prefetch={result.nprefetch} -> {result.optimal_time:.3f}s")
    print(f"speedup        : {result.speedup_vs_default:.2f}x")

    print("\n== tuned loader in use ==")
    loader.with_params(LoaderParams(num_workers=result.nworker,
                                    prefetch_factor=result.nprefetch))
    stats = loader.measure_transfer_time(2 * args.batches, to_device=True)
    print(f"delivered {stats.batches} batches to {args.device}, "
          f"{stats.bytes / 1e6:.1f} MB at "
          f"{stats.bytes_per_second / 1e6:.1f} MB/s")


if __name__ == "__main__":
    main()
