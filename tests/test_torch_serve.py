"""The port's serving path on the CPU: the cases of test_serve.py, greedy
parity with the JAX package's engine, the launcher, and the guards that
keep the port free of JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, jax_and_port, long_tensor
from repro_torch.serve.engine import (BatchingFrontend, BatchMixMonitor,
                                      ServeEngine)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    jmodel, params, port, cfg = jax_and_port("qwen2-0.5b")
    return jmodel, params, port, cfg


@pytest.fixture(scope="module")
def engine(pair):
    _, _, port, cfg = pair
    return ServeEngine(port, max_batch=4, max_len=64, device="cpu"), cfg


def test_torch_greedy_generate_is_deterministic(engine):
    eng, cfg = engine
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    a = eng.generate(prompts, 8)
    b = eng.generate(prompts, 8)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.tokens.shape == (2, 8)
    assert a.steps == 8 and a.prefill_s > 0 and a.decode_s > 0


def test_torch_generate_matches_manual_decode_loop(engine):
    """Engine output == hand-rolled prefill + decode_step loop."""
    eng, cfg = engine
    model = eng.model
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    res = eng.generate(prompts, 5)

    cache = model.init_cache(2, eng.max_len)
    logits, cache = model.prefill({"tokens": long_tensor(prompts)}, cache)
    tok = torch.argmax(logits[:, -1].float(), -1)
    out = [tok.numpy()]
    pos = torch.full((2,), 12, dtype=torch.long)
    for _ in range(4):
        logits, cache = model.decode_step(cache, tok[:, None], pos)
        tok = torch.argmax(logits[:, -1].float(), -1)
        pos = pos + 1
        out.append(tok.numpy())
    np.testing.assert_array_equal(res.tokens, np.stack(out, 1))


def test_torch_generated_continuation_consistency(engine):
    """Re-prefilling prompt + generated prefix reproduces the next
    generated token (KV cache == full recompute)."""
    eng, cfg = engine
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, (1, 10)).astype(np.int32)
    res = eng.generate(prompt, 6)
    k = 3
    extended = np.concatenate([prompt, res.tokens[:, :k]], axis=1)
    cache = eng.model.init_cache(1, eng.max_len)
    logits, _ = eng.model.prefill({"tokens": long_tensor(extended)}, cache)
    assert int(torch.argmax(logits[0, -1].float())) == int(res.tokens[0, k])


def test_torch_batching_frontend_serves_all_requests(engine):
    eng, cfg = engine
    frontend = BatchingFrontend(eng, max_wait_s=0.02)
    rng = np.random.default_rng(3)
    reqs = [frontend.submit(
        rng.integers(0, cfg.vocab_size, (16,)).astype(np.int32), 4)
        for _ in range(10)]
    outs = [r.result.get(timeout=300) for r in reqs]
    frontend.shutdown()
    assert len(outs) == 10
    assert all(o.shape == (4,) for o in outs)
    assert frontend.batches_served <= 10   # batching actually batched some
    assert frontend.assembly_wait_p99() >= 0.0


def test_torch_temperature_sampling_varies(pair):
    _, _, port, cfg = pair
    eng = ServeEngine(port, max_batch=2, max_len=64, temperature=1.5,
                      device="cpu")
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    a = eng.generate(prompts, 12, seed=0)
    b = eng.generate(prompts, 12, seed=1)
    assert not np.array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.tokens,
                                  eng.generate(prompts, 12, seed=0).tokens)


def test_torch_batch_mix_monitor_fires_on_mix_change():
    fired = []
    mon = BatchMixMonitor(window=8, threshold=0.4, cooldown=32,
                          on_drift=fired.append)
    for _ in range(16):
        mon.record((16, 4))         # steady short-prompt traffic
    assert not fired
    for _ in range(16):
        mon.record((512, 64))       # traffic shifts to long prompts
    assert mon.drifts == 1          # fired once, then cooldown holds
    assert fired and (512, 64) in fired[0]


def test_torch_batch_mix_monitor_stable_mix_never_fires():
    mon = BatchMixMonitor(window=8, threshold=0.4, cooldown=0)
    for i in range(64):
        mon.record((16, 4) if i % 2 else (32, 8))
    assert mon.drifts == 0


def test_torch_greedy_tokens_match_jax_engine(pair, engine):
    """Same params, same prompts: the port's greedy tokens are the JAX
    engine's.  Logits are also checked teacher-forced on JAX's tokens, so
    one near-tie could not cascade unnoticed."""
    from repro.serve.engine import ServeEngine as JaxEngine
    jmodel, params, port, cfg = pair
    eng, _ = engine
    jeng = JaxEngine(jmodel, params, max_batch=4, max_len=64)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (3, 14)).astype(np.int32)
    jtoks = jeng.generate(prompts, 6).tokens
    np.testing.assert_array_equal(eng.generate(prompts, 6).tokens, jtoks)

    jcache = jmodel.init_cache(3, 64)
    jl, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)},
                                jcache)
    tcache = port.init_cache(3, 64)
    tl, tcache = port.prefill({"tokens": long_tensor(prompts)}, tcache)
    for i in range(jtoks.shape[1]):
        np.testing.assert_allclose(as_f32(tl), as_f32(jl), atol=1e-4,
                                   rtol=1e-4)
        pos = np.full((3,), 14 + i, np.int32)
        jl, jcache = jmodel.decode_step(params, jcache,
                                        jnp.asarray(jtoks[:, i:i + 1]),
                                        jnp.asarray(pos))
        tl, tcache = port.decode_step(tcache, long_tensor(jtoks[:, i:i + 1]),
                                      long_tensor(pos))


def test_torch_engine_without_device_raises_when_cuda_absent(pair,
                                                             monkeypatch):
    _, _, port, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(port, max_batch=2, max_len=16)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    return env


def test_torch_launch_serve_prints_json():
    import json
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-0.5b", "--reduced", "--device", "cpu", "--requests", "5",
         "--prompt-len", "8", "--max-new", "3", "--max-batch", "4"],
        capture_output=True, text=True, env=_env(), timeout=120, check=True)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["requests"] == 5 and summary["tokens_generated"] == 15
    assert summary["device"] == "cpu" and 2 <= summary["batches_served"] <= 5


def test_torch_port_runs_with_jax_unimportable():
    """With ``jax`` blocked, the port and every module of the slice
    import, and a reduced generate runs."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
import repro_torch
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import (_build, flash_attention, ops, ref, rmsnorm,
                                 ssd_scan)
from repro_torch.models import (DecoderLM, build_model, convert, layers, ssm,
                                stack)
from repro_torch.models.module import init_params
from repro_torch.data import (arena, cache, costs, dataset, faults, loader,
                              prefetcher, sampler, storage, worker_pool)
from repro_torch.core import cache as dpt_cache
from repro_torch.core import dpt, evaluators, monitor, search, simulator
from repro_torch.tuning import base, locality, online, strategies
from repro_torch.utils import device, fingerprint
import repro_torch.core, repro_torch.data, repro_torch.tuning, repro_torch.utils
from repro_torch.core import DPTCache
from repro_torch.tuning import AdaptiveLocalityController, OnlineTuner
from repro_torch.distributed import fault_tolerance, grad_compress
from repro_torch.checkpoint import Checkpointer, checkpointer
from repro_torch.serve.engine import BatchingFrontend, ServeEngine
from repro_torch.train import optimizer, train_step, trainer
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
cfg = reduced(get_config("qwen2-0.5b"))
params = init_params(DecoderLM.param_specs(cfg), torch.Generator().manual_seed(0))
eng = ServeEngine(build_model(cfg, params, device="cpu"), max_batch=2,
                  max_len=16, device="cpu")
res = eng.generate(np.zeros((2, 5), np.int32), 3)
assert res.tokens.shape == (2, 3), res.tokens.shape
# one compressed, microbatched train step of reduced mamba2
mcfg = reduced(get_config("mamba2-780m"))
tcfg = train_step.TrainStepConfig(microbatches=2, compress_grads=True)
state = train_step.init_train_state(mcfg, torch.Generator().manual_seed(0),
                                    tcfg, device="cpu")
tokens = torch.zeros((2, 12), dtype=torch.long)
state, m = train_step.make_train_step(state.model, tcfg)(
    state, {"tokens": tokens, "targets": tokens})
assert state.opt.step == 1 and bool(torch.isfinite(m["loss"])), m
# Algorithm 1 on the simulator, and one real trial through the CPU edge
sim = simulator.LoaderSimulator(storage.cifar10_profile(),
                                simulator.MachineProfile())
res = dpt.DPT(evaluators.SimulatorEvaluator(sim, batch_size=32),
              dpt.DPTConfig(num_cpu_cores=4, num_devices=1, max_prefetch=2,
                            num_batches=8)).run()
assert len(res.trials) >= 8 and res.nworker >= 1, res
dl = loader.DataLoader(dataset.synthetic_image_dataset(32, 8), 8,
                       params=loader.LoaderParams(zero_copy=True),
                       device="cpu")
stats = dl.measure_transfer_time(3, to_device=True)
assert stats.batches == 3 and stats.staging_hit_rate is not None, stats
# the Trainer: two steps of reduced qwen2 with a checkpoint in repro's layout
import tempfile
ckdir = tempfile.mkdtemp()
qcfg = reduced(get_config("qwen2-0.5b"))
tr = trainer.Trainer(qcfg, loader.DataLoader(
    dataset.token_dataset(16, 8, qcfg.vocab_size), 4,
    params=loader.LoaderParams(num_workers=0), device="cpu"),
    trainer.TrainerConfig(total_steps=2, autotune=False, checkpoint_dir=ckdir),
    device="cpu")
assert tr.run()["final_step"] == 2
assert Checkpointer(ckdir).latest_step() == 2
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_torch_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    port = ROOT / "src" / "repro_torch"
    for module in ("models/ssm.py", "train/optimizer.py",
                   "train/train_step.py", "distributed/grad_compress.py",
                   "kernels/ssd_scan.py", "data/prefetcher.py",
                   "data/loader.py", "core/dpt.py", "tuning/base.py",
                   "utils/fingerprint.py", "core/cache.py",
                   "tuning/online.py", "tuning/locality.py",
                   "distributed/fault_tolerance.py",
                   "checkpoint/checkpointer.py", "train/trainer.py",
                   "launch/train.py", "core/search.py",
                   "core/cluster.py", "tuning/transport.py",
                   "tuning/fleet.py", "launch/mesh.py",
                   "distributed/sharding_rules.py",
                   "distributed/dp_shard.py"):
        assert port / module in files, module
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), f"{f}: {mod}"


def test_torch_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent, env=_env())
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
