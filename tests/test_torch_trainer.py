"""The port's Trainer on the CPU: the Trainer cases of tests/test_train.py,
tests/test_tuning.py and tests/test_locality.py on
``repro_torch.train.trainer``, and one trajectory across the packages —
``repro``'s Trainer and the port's, each resuming the same JAX-initialised
checkpoint, take the same ten steps.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import (DataLoader, LoaderParams,
                              synthetic_image_dataset, token_dataset)
from repro_torch.models.convert import named_from_tree
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def test_torch_checkpoint_restart_resumes_exactly(tmp_path):
    cfg = reduced(get_config("qwen3-1.7b"))
    ds = token_dataset(64, 16, cfg.vocab_size, seed=2)
    mk = lambda: DataLoader(ds, 8, params=LoaderParams(num_workers=0),
                            seed=2, device="cpu")
    tc = lambda steps: TrainerConfig(
        total_steps=steps, checkpoint_every=5, log_every=5,
        checkpoint_dir=str(tmp_path), autotune=False,
        step_config=TrainStepConfig(
            remat_policy="none",
            optimizer=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                  total_steps=20)))

    # run 1: 10 steps straight through
    t1 = Trainer(cfg, mk(), tc(10), device="cpu")
    t1.run()
    p_straight = t1.state.params

    # run 2: crash at 5 (simulated by stopping), restart to 10
    shutil.rmtree(tmp_path)
    os.makedirs(tmp_path)
    t2a = Trainer(cfg, mk(), tc(5), device="cpu")
    t2a.run()
    t2b = Trainer(cfg, mk(), tc(10), device="cpu")
    t2b.run()
    assert t2b.start_step == 5
    # the restart trained weights of its own, restored from disk
    assert t2b.state.model is not t2a.state.model

    p_restart = t2b.state.params
    assert p_straight.keys() == p_restart.keys()
    for k, a in p_straight.items():
        np.testing.assert_allclose(a.detach().numpy(),
                                   p_restart[k].detach().numpy(),
                                   atol=1e-5, rtol=1e-4)


def test_torch_trainer_autotune_sets_loader_params(tmp_path):
    cfg = reduced(get_config("qwen2-0.5b"))
    ds = token_dataset(64, 16, cfg.vocab_size, seed=0)
    dl = DataLoader(ds, 8, seed=0, device="cpu")
    tc = TrainerConfig(total_steps=4, autotune=True,
                       autotune_budget_batches=2, autotune_max_prefetch=2,
                       dpt_cache_path=str(tmp_path / "dpt.json"),
                       log_every=2,
                       step_config=TrainStepConfig(
                           remat_policy="none",
                           optimizer=AdamWConfig(total_steps=4)))
    tr = Trainer(cfg, dl, tc, device="cpu")
    tr.run()
    assert dl.params.num_workers >= 1
    assert tr.online_tuner is not None
    assert tr.straggler.medians()["host0"] > 0
    # second trainer reuses the cached result without re-measuring
    dl2 = DataLoader(ds, 8, seed=0, device="cpu")
    tr2 = Trainer(cfg, dl2, tc, device="cpu")
    params = tr2.tune_loader()
    assert (params.num_workers, params.prefetch_factor) == \
        (dl.params.num_workers, dl.params.prefetch_factor)


def test_torch_trainer_rejects_startup_incapable_strategy():
    cfg = reduced(get_config("qwen2-0.5b"))
    ds = token_dataset(64, 16, cfg.vocab_size, seed=1)
    dl = DataLoader(ds, 8, params=LoaderParams(num_workers=0), seed=1,
                    device="cpu")
    tr = Trainer(cfg, dl,
                 TrainerConfig(autotune=True, autotune_strategy="goodput"),
                 device="cpu")
    with pytest.raises(ValueError, match="cannot run at startup"):
        tr.tune_loader()


def test_torch_trainer_locality_axis_ignored_on_sharded_fleet():
    """Per-host tuned chunks would give hosts different permutations —
    the startup tune must drop the axis when the sampler is sharded."""
    ds = synthetic_image_dataset(64, 8, seed=0)
    dl = DataLoader(ds, 8, params=LoaderParams(), shuffle=True, seed=0,
                    host_index=0, host_count=2, device="cpu")
    cfg = TrainerConfig(autotune=True,
                        autotune_locality_chunks=(0, 16),
                        autotune_budget_batches=2, autotune_max_prefetch=1)
    tr = Trainer.__new__(Trainer)          # tune_loader only needs these
    tr.loader, tr.cfg = dl, cfg
    params = tr.tune_loader(force=True)
    assert params.locality_chunk == 0      # axis dropped, not searched


def test_torch_trainer_wires_adaptive_locality_by_mode():
    """TrainerConfig.adaptive_locality: single-host controllers apply
    locally; fleet-mode controllers route proposals to the agent and never
    touch params themselves."""
    ds = synthetic_image_dataset(32, 8, seed=0)
    dl = DataLoader(ds, 8, params=LoaderParams(locality_chunk=16),
                    shuffle=True, seed=0, device="cpu")
    tr = Trainer.__new__(Trainer)
    tr.loader, tr.cfg, tr.agent = dl, TrainerConfig(), None
    ctl = tr._make_locality_controller()
    assert ctl.on_propose is None and ctl.loader is dl

    class FakeAgent:
        def __init__(self):
            self.proposals = []

        def notify_locality(self, chunk):
            self.proposals.append(chunk)

    tr.agent = FakeAgent()
    ctl = tr._make_locality_controller()
    ctl.observe({"coalesced_requests": 10, "reads": 160, "cache_hits": 0})
    for _ in range(2):
        ctl.observe({"coalesced_requests": ctl._last[0] + 10,
                     "reads": 160, "cache_hits": 0})
    assert tr.agent.proposals == [0]
    assert dl.params.locality_chunk == 16       # untouched locally


def test_torch_trainer_no_controller_on_sharded_loader():
    ds = synthetic_image_dataset(64, 8, seed=0)
    dl = DataLoader(ds, 16, params=LoaderParams(locality_chunk=16),
                    shuffle=True, seed=0, host_index=0, host_count=2,
                    device="cpu")
    tr = Trainer.__new__(Trainer)
    tr.loader, tr.cfg, tr.agent = dl, TrainerConfig(), None
    assert tr._make_locality_controller() is None


def test_torch_trainer_runs_on_the_card_by_default():
    """The entry point defaults to the card: without one it raises, and it
    refuses a model given as anything but its config.  On the CPU it
    attaches to a fleet over a transport."""
    cfg = reduced(get_config("qwen2-0.5b"))
    dl = DataLoader(token_dataset(16, 8, cfg.vocab_size), 4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(cfg, dl, TrainerConfig())
    tr = Trainer(cfg, dl, TrainerConfig(), device="cpu")
    from repro_torch.tuning import (CoordinatorServer, FleetCoordinator,
                                    LocalTransport)
    transport = LocalTransport()
    coord = FleetCoordinator()
    CoordinatorServer(coord, transport, owner="coord-0")
    agent = tr.connect_fleet(transport)
    assert tr.agent is agent and agent.link is not None
    assert list(coord.agents) == ["host0"]      # registered over the wire
    with pytest.raises(TypeError):
        Trainer(object(), dl, TrainerConfig(), device="cpu")


# --------------------------------------------------------------------------
# one trajectory in both packages from the same checkpoint
# --------------------------------------------------------------------------
STEPS = 10


def test_torch_trainer_trajectory_matches_jax(tmp_path):
    """``repro``'s Checkpointer saves a JAX-initialised state as step 0 in
    two directories; ``repro``'s Trainer resumes one and the port's the
    other, and both take ten steps on the same batches.  AdamW's eps is
    1e-4 (see test_torch_train.py: with 1e-8, entries whose gradient is
    rounding noise move by +-lr at random in either framework)."""
    import repro.data as jdata
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import build_model
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro.train import trainer as jtr

    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20, eps=1e-4)
    jcfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    jmodel = build_model(jcfg)
    jstep = jts.TrainStepConfig(remat_policy="none",
                                optimizer=jopt.AdamWConfig(**opt))
    init = jts.init_train_state(jmodel, jax.random.PRNGKey(3), jstep)
    for d in ("jax", "port"):
        JaxCheckpointer(str(tmp_path / d)).save(0, init, block=True)

    jds = jdata.token_dataset(64, 16, jcfg.vocab_size, seed=2)
    jt = jtr.Trainer(jmodel, jdata.DataLoader(
        jds, 8, params=jdata.LoaderParams(num_workers=0), seed=2),
        jtr.TrainerConfig(total_steps=STEPS, log_every=1, autotune=False,
                          checkpoint_dir=str(tmp_path / "jax"),
                          step_config=jstep))
    jt.run()

    cfg = reduced(get_config("qwen2-0.5b"))
    ds = token_dataset(64, 16, cfg.vocab_size, seed=2)
    tt = Trainer(cfg, DataLoader(ds, 8, params=LoaderParams(num_workers=0),
                                 seed=2, device="cpu"),
                 TrainerConfig(total_steps=STEPS, log_every=1,
                               autotune=False,
                               checkpoint_dir=str(tmp_path / "port"),
                               step_config=TrainStepConfig(
                                   remat_policy="none",
                                   optimizer=AdamWConfig(**opt))),
                 device="cpu")
    tt.run()

    assert jt.start_step == tt.start_step == 0
    jl = [r["loss"] for r in jt.history if "loss" in r]
    tl = [r["loss"] for r in tt.history if "loss" in r]
    assert len(jl) == len(tl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    expect = named_from_tree(jax.tree_util.tree_map(np.asarray,
                                                    jt.state.params),
                             cfg.num_layers)
    got = tt.state.params
    assert got.keys() == expect.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), expect[k],
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    assert tt.state.opt.step == int(jt.state.opt.step) == STEPS
