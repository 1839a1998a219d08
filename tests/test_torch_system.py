"""End-to-end behaviour of the port on the CPU, with the assertions of
tests/test_system.py: DPT-tuned training on a latency-injected storage with
restart-after-crash, and the training launcher."""
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.configs import get_config, reduced
from repro_torch.data import (DataLoader, Dataset, LatencyStorage,
                              token_dataset)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent


def test_torch_end_to_end_dpt_tuned_training(tmp_path):
    """The headline integration: loader tuned by DPT (real wall-clock
    measurements on latency-injected storage) feeding a real train loop,
    with checkpointing; loss decreases and tuned params beat 0 workers."""
    cfg = reduced(get_config("qwen2-0.5b"))

    base = token_dataset(96, 16, cfg.vocab_size, seed=0)
    lat = LatencyStorage(base.storage, latency_s=1e-3, bandwidth=1e9)
    ds = Dataset(lat, transform=base.transform)
    dl = DataLoader(ds, 8, seed=0, device="cpu")

    tc = TrainerConfig(
        total_steps=36, checkpoint_every=18, log_every=6,
        checkpoint_dir=str(tmp_path / "ckpt"),
        autotune=True, autotune_budget_batches=4, autotune_max_prefetch=2,
        dpt_cache_path=str(tmp_path / "dpt.json"),
        step_config=TrainStepConfig(
            remat_policy="none",
            optimizer=AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                  total_steps=36)))
    tr = Trainer(cfg, dl, tc, device="cpu")
    out = tr.run()
    assert out["final_step"] == 36
    assert out["loss"] < 5.4   # memorizing the 96-item set (ln(256)=5.545 at init)
    assert dl.params.num_workers >= 1  # DPT chose parallel loading

    # crash-restart: a new trainer resumes from the checkpoint
    dl2 = DataLoader(ds, 8, seed=0, device="cpu")
    tr2 = Trainer(cfg, dl2, tc, device="cpu")
    tr2._maybe_restore()
    assert tr2.start_step == 36


def test_torch_train_launcher_runs(tmp_path):
    """The port's training entry point works end to end (reduced config,
    on the CPU) and leaves its checkpoint behind."""
    env = dict(os.environ, PYTHONPATH="src", REPRO_COMPUTE_DTYPE="float32")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-780m", "--reduced", "--device", "cpu", "--steps", "6",
         "--global-batch", "4", "--seq-len", "32", "--no-autotune",
         "--checkpoint-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["final_step"] == 6
    assert (tmp_path / "ck" / "step_00000006" / "arrays_p0.npz").exists()
