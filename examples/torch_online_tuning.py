"""Online retuning of a LIVE DataLoader on the PyTorch port — the paper's
tuner, made continuous, delivering through the device edge.

A real (wall-clock, thread-parallel) loader streams batches to ``--device``
while a stand-in training loop consumes them: each step reduces the
delivered image tensor on the device and then sleeps ``COMPUTE_S``, a step
cheaper than loading a batch once the storage degrades.  Mid-run the
storage degrades (latency x40, bandwidth /4: a noisy co-tenant stealing
the disk).  The OnlineTuner notices the goodput stall, runs a bounded
hillclimb against the live loader (its trials deliver to the device too),
and hot-swaps the winner in WITHOUT restarting the stream: the old worker
pool is drained at a batch boundary, the sampler position is kept, zero
batches are lost.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_online_tuning.py
    PYTHONPATH=src python examples/torch_online_tuning.py --device cpu --steps 80 --drift-at 20
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core.evaluators import LoaderEvaluator
from repro_torch.data import DataLoader, Dataset, LoaderParams
from repro_torch.data.dataset import image_transform
from repro_torch.data.storage import ArrayStorage, LatencyStorage
from repro_torch.tuning import OnlineTuner, OnlineTunerConfig

BATCH = 16
# The stand-in step is 20 ms, not examples/online_tuning.py's 6 ms: handing
# a batch across the CUDA edge takes a wait of its own even when the loader
# is ahead (``mean_data_ms`` of the healthy phase), and against 6 ms that
# wait alone sits near the tuner's stall fraction of 0.2, so the decide
# step could fire before the storage degrades.
COMPUTE_S = 0.020
# The loader starts at (2 workers, prefetch 1), narrower than
# examples/online_tuning.py's (8, 2): it keeps up with the healthy storage
# (16 reads of 0.2 ms a batch) but not with the degraded one (16 of 8 ms,
# ~70 ms a batch at 2 workers, ~17 ms at 8, which would still keep up with
# a 20 ms step), so the drift leaves the tuner a choice to make.
START = (2, 1)


def make_dataset(items: int = 4096):
    """``items`` seeded 16 x 16 x 3 images behind a healthy
    ``LatencyStorage`` (0.2 ms, 1 GB/s): (dataset, storage)."""
    rng = np.random.default_rng(0)
    raw = [rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
           for _ in range(items)]
    storage = LatencyStorage(ArrayStorage(raw), latency_s=0.2e-3,
                             bandwidth=1e9, concurrent_streams=32)
    return Dataset(storage, transform=image_transform), storage


def degrade(storage) -> None:
    """The mid-run degradation: latency x40, bandwidth /4."""
    storage.latency_s *= 40
    storage.bandwidth /= 4


def consume(batch) -> None:
    """The stand-in training step: a reduction on the device, then
    ``COMPUTE_S`` of sleep."""
    float(batch["image"].float().mean())
    time.sleep(COMPUTE_S)


def run(*, device="cuda", steps: int = 200, drift_at: int = 40,
        items: int = 4096, on_batch=None, verbose: bool = True) -> dict:
    """The online-tuning flow from ``START``; returns its summary.
    ``on_batch(k, batch)``, if given, sees the k-th delivered batch after
    the step's timing and the tuner's observation (a check's hook)."""
    ds, storage = make_dataset(items)
    dl = DataLoader(ds, BATCH, params=LoaderParams(num_workers=START[0],
                                                   prefetch_factor=START[1]),
                    seed=0, device=device)

    tuner = OnlineTuner(
        dl, evaluator=LoaderEvaluator(dl, to_device=True),
        config=OnlineTunerConfig(stall_fraction=0.2, window=8,
                                 warmup_steps=16, cooldown_steps=12,
                                 retune_budget_batches=32, max_prefetch=4,
                                 min_improvement=0.25,  # wall-clock noise
                                 num_cpu_cores=16, num_devices=2))

    say = print if verbose else (lambda *a, **k: None)
    stream = dl.stream(to_device=True)
    phase_times = {"healthy": [], "drifted": [], "recovered": []}
    phase_data = {p: [] for p in phase_times}
    params_before = (dl.params.num_workers, dl.params.prefetch_factor)
    retunes_before_drift = 0
    try:
        for step in range(steps):
            if step == drift_at:
                retunes_before_drift = tuner.retunes
                degrade(storage)
                say(f"-- step {step}: storage degraded (latency x40, bw /4)")
            t0 = time.perf_counter()
            batch = next(stream)
            data_s = time.perf_counter() - t0
            consume(batch)
            step_s = time.perf_counter() - t0
            applied = tuner.observe(data_s=data_s, step_s=step_s)
            if applied is not None:
                say(f"-- step {step}: retuned -> workers="
                    f"{applied.num_workers} prefetch="
                    f"{applied.prefetch_factor} (swap #{stream.swaps + 1} "
                    f"pending at batch boundary)")
            phase = ("healthy" if step < drift_at else
                     "drifted" if tuner.retunes == retunes_before_drift
                     else "recovered")
            phase_times[phase].append(step_s)
            phase_data[phase].append(data_s)
            if on_batch is not None:
                on_batch(step, batch)
    finally:
        stream.close()

    summary = {
        "device": str(dl.device), "steps": steps, "drift_at": drift_at,
        "compute_ms": COMPUTE_S * 1e3,
        "params_before": list(params_before),
        "params_after": [dl.params.num_workers, dl.params.prefetch_factor],
        "retunes": tuner.retunes, "swaps": stream.swaps,
        "phases": {p: {"steps": len(ts),
                       "mean_step_ms": 1e3 * float(np.mean(ts)) if ts
                       else None,
                       "mean_data_ms": 1e3 * float(np.mean(phase_data[p]))
                       if ts else None}
                   for p, ts in phase_times.items()},
        "searches": [{"step": ev["step"], "outcome": ev["outcome"],
                      "params": ev["params"],
                      "measurements": ev["measurements"],
                      "search_s": ev["search_s"]} for ev in tuner.history],
    }
    for phase, ts in phase_times.items():
        if ts:
            say(f"{phase:10s} steps={len(ts):3d}  "
                f"mean step={1e3 * np.mean(ts):6.2f} ms  "
                f"throughput={BATCH / np.mean(ts):8.1f} img/s")
    say(f"retunes={tuner.retunes}  completed hot swaps={stream.swaps}  "
        f"final params=({dl.params.num_workers},"
        f"{dl.params.prefetch_factor})")
    for ev in summary["searches"]:
        say(f"  search @step {ev['step']} [{ev['outcome']:7s}]: "
            f"{ev['params']} after {ev['measurements']} measurements "
            f"({ev['search_s']:.2f}s search)")
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--drift-at", type=int, default=40)
    ap.add_argument("--items", type=int, default=4096)
    args = ap.parse_args()
    run(device=args.device, steps=args.steps, drift_at=args.drift_at,
        items=args.items)


if __name__ == "__main__":
    main()
