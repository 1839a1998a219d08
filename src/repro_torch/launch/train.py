"""Training launcher: ``python -m repro_torch.launch.train --arch mamba2-780m``

Wires together the config registry (``--arch`` selects any of the
architectures, reduced or full), the DPT-autotuned data pipeline, the train
step, checkpoint/restart in ``repro``'s on-disk layout and the
straggler/retune hooks, and prints the run's summary as one JSON line.
Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.  The loader's host index and count are the rank and world size
of an initialised ``torch.distributed`` group, else 0 and 1 (the port's
train step does not synchronise gradients across processes yet).  The
modality stubs of the vlm and encdec families wait for the port of those
families.
"""
from __future__ import annotations

import argparse
import json


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--no-autotune", action="store_true")
    ap.add_argument("--dpt-cache", default=None)
    ap.add_argument("--num-items", type=int, default=2048)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "nothing", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataLoader, LoaderParams, token_dataset
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(
            f"{cfg.family} models (patch / frame frontends) are not ported "
            "yet")
    ds = token_dataset(args.num_items, args.seq_len, cfg.vocab_size,
                       seed=args.seed)
    distributed = dist.is_available() and dist.is_initialized()
    loader = DataLoader(ds, args.global_batch,
                        params=LoaderParams(num_workers=2),
                        seed=args.seed,
                        host_index=dist.get_rank() if distributed else 0,
                        host_count=dist.get_world_size() if distributed else 1,
                        device=args.device)

    tc = TrainerConfig(
        total_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        autotune=not args.no_autotune,
        dpt_cache_path=args.dpt_cache,
        seed=args.seed,
        step_config=TrainStepConfig(
            remat_policy=args.remat,
            microbatches=args.microbatches,
            compress_grads=args.compress_grads,
            optimizer=AdamWConfig(peak_lr=args.lr,
                                  total_steps=args.steps,
                                  warmup_steps=max(2, args.steps // 20))),
    )
    trainer = Trainer(cfg, loader, tc, device=args.device)
    result = trainer.run()
    print(json.dumps(result, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
