"""Training launcher: ``python -m repro_torch.launch.train --arch mamba2-780m``

Wires together the config registry (``--arch`` selects any of the
architectures, reduced or full), the DPT-autotuned data pipeline, the train
step, checkpoint/restart in ``repro``'s on-disk layout and the
straggler/retune hooks, and prints the run's summary as one JSON line.
Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.  The loader's host index and count are the rank and world size
of an initialised ``torch.distributed`` group, else 0 and 1.  The launcher
runs the plain step on each process; the step that synchronises gradients
across processes is ``make_train_step(model, TrainStepConfig(dp_manual=
True))`` under ``use_rules(launch.mesh.make_local_mesh(),
rules_for("train"))`` over a state on the storage plan
(``init_train_state(..., ctx=)`` or ``shard_train_state``,
``train/train_step.py``), as in ``repro``, whose launcher runs no mesh
either.  A vlm
and whisper (encdec) train on the stub frontends of ``repro``'s launcher:
token items with seeded patch embeddings or frame embeddings drawn in the
same order from one generator.  On the card every full-sequence
attention call, forward and backward, runs the hand-written flash kernels
(``kernels/flash_attention.py``); ``chip_smoke.py`` drives the dense path
there (``--arch qwen2-0.5b``, uncut).
"""
from __future__ import annotations

import argparse
import json


def stub_dataset(cfg, num_items: int, seq_len: int, seed: int):
    """The vlm and encdec stub frontends: ``num_items`` token sequences
    and, per item as it is transformed, patch embeddings (num_patches,
    patch_embed_dim) for a vlm and frame embeddings (max_source_positions,
    d_model) for whisper, of N(0, 1), all drawn from one
    ``np.random.default_rng(seed)`` in ``repro``'s launcher's order (so
    the items are equal; the embeddings are when the items are
    transformed in the same order)."""
    import numpy as np

    from repro_torch.data import ArrayStorage, Dataset
    rng = np.random.default_rng(seed)
    items = [rng.integers(0, cfg.vocab_size, (seq_len + 1,)).astype(np.int32)
             for _ in range(num_items)]

    def transform(arr):
        out = {"tokens": arr[:-1], "targets": arr[1:],
               "loss_mask": np.ones(seq_len, np.float32)}
        if cfg.num_patches:
            out["patch_embeds"] = rng.normal(
                0, 1, (cfg.num_patches, cfg.patch_embed_dim)
            ).astype(np.float32)
        if cfg.encoder_layers:
            out["frames"] = rng.normal(
                0, 1, (cfg.max_source_positions, cfg.d_model)
            ).astype(np.float32)
        return out

    return Dataset(ArrayStorage(items), transform=transform)


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
        ds = stub_dataset(cfg, args.num_items, args.seq_len, args.seed)
    else:
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
