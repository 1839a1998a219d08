"""End-to-end training on the PyTorch port: a dense decoder LM with the
DPT-tuned data pipeline, async checkpointing and restart.

    PYTHONPATH=src python examples/torch_train_lm.py                 # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m
    PYTHONPATH=src python examples/torch_train_lm.py --resume        # restart demo

The smoke preset (~3M params) is the same code at a size the CPU runs in
minutes; the 100m preset is a ~100M-param config for the card.  On the
card every attention call runs the hand-written flash-attention forward
and backward kernels (``repro_torch/kernels/csrc/flash_attention.cu``).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data import ArrayStorage, DataLoader, Dataset
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def lcg_dataset(num_items: int, seq_len: int, vocab: int, seed: int = 0):
    """Learnable synthetic LM data: next token = (a*t + c) mod V, random
    start, so the model can drive the loss toward 0 (uniform-random tokens
    sit at the ln(V) entropy floor and show no learning signal)."""
    rng = np.random.default_rng(seed)
    a, c = 5, 17
    items = []
    for _ in range(num_items):
        seq = np.empty(seq_len + 1, np.int64)
        seq[0] = rng.integers(0, vocab)
        for i in range(seq_len):
            seq[i + 1] = (a * seq[i] + c) % vocab
        items.append(seq.astype(np.int32))

    def transform(arr):
        return {"tokens": arr[:-1], "targets": arr[1:],
                "loss_mask": np.ones(seq_len, np.float32)}

    return Dataset(ArrayStorage(items), transform=transform)


PRESETS = {
    # ~3M params: a few hundred steps on one CPU core in minutes
    "smoke": dict(num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
                  head_dim=32, d_ff=512, vocab_size=2048, seq=128, batch=8,
                  steps=200),
    # ~100M params (GPT-2-medium-ish): the same code path, sized for the card
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768, seq=1024, batch=32,
                 steps=300),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]

    cfg = ModelConfig(
        name=f"example-{args.preset}", family="dense",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"], vocab_size=p["vocab_size"])
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M  "
          f"device={args.device}")

    dataset = lcg_dataset(1024, p["seq"], p["vocab_size"])
    loader = DataLoader(dataset, global_batch=p["batch"], seed=0,
                        device=args.device)

    if not args.resume and os.path.isdir(args.ckpt_dir):
        import shutil
        shutil.rmtree(args.ckpt_dir)

    tcfg = TrainerConfig(
        total_steps=steps,
        checkpoint_every=max(25, steps // 4),
        checkpoint_dir=args.ckpt_dir,
        log_every=10,
        autotune=True,                       # DPT tunes the loader first
        autotune_budget_batches=4,
        step_config=TrainStepConfig(
            remat_policy="none", microbatches=1,
            optimizer=AdamWConfig(peak_lr=3e-4, warmup_steps=20,
                                  total_steps=steps)),
    )
    trainer = Trainer(cfg, loader, tcfg, device=args.device)
    summary = trainer.run()

    print("\n== training summary ==")
    print(f"resumed from step {trainer.start_step}" if trainer.start_step
          else "started from scratch")
    print(f"tuned loader   : workers={loader.params.num_workers} "
          f"prefetch={loader.params.prefetch_factor}")
    for rec in trainer.history[:3] + trainer.history[-3:]:
        print(f"  step {rec['step']:4d}  loss {rec['loss']:.4f}  "
              f"gnorm {rec['grad_norm']:.3f}  {rec['step_s']*1e3:.0f} ms/step")
    first, last = trainer.history[0], trainer.history[-1]
    assert last["loss"] < first["loss"], "loss did not improve"
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f} over "
          f"{summary['final_step']} steps ({summary['wall_s']:.1f}s); "
          f"checkpoints in {args.ckpt_dir}")
    print("re-run with --resume to continue from the latest checkpoint.")


if __name__ == "__main__":
    main()
