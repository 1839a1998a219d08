"""The port's training side on the CPU against the JAX package: AdamW and
its schedule, int8 error-feedback compression, the loss and every gradient
of reduced mamba2-780m and qwen2-0.5b, and whole train steps.

Parameters and train states are drawn by the JAX package and carried
across (``from_jax_params`` / ``from_jax_train_state``); batches are made
with numpy.  fp32 compute (tests/conftest.py), so the loss and the
gradients agree to rtol 1e-4, with an absolute floor of 1e-5 of each
leaf's largest entry for the entries that sum to nearly zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, jax_and_port, long_tensor
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import grad_compress as gc
from repro_torch.models.convert import (from_jax_params,
                                        from_jax_train_state,
                                        named_from_tree)
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCHS = ["mamba2-780m", "qwen2-0.5b"]
B, S = 4, 16


def _close_leaf(got, expect, rtol=1e-4, atol=None):
    expect = as_f32(expect)
    if atol is None:
        atol = 1e-5 * float(np.abs(expect).max() or 1.0)
    np.testing.assert_allclose(as_f32(got), expect, rtol=rtol, atol=atol)


def _close_named(named, jtree, num_layers, rtol=1e-4, atol=None):
    """Port tensors by name against a JAX-layout tree, every leaf."""
    expect = named_from_tree(jax.tree_util.tree_map(np.asarray, jtree),
                             num_layers)
    assert set(named) == set(expect)
    for k, v in named.items():
        _close_leaf(v, expect[k], rtol, atol)


# AdamW's first step moves each entry by lr * g / (|g| + eps): with the
# default eps of 1e-8 an entry whose gradient is rounding noise (true value
# ~0, |g| ~ 1e-9) moves by +-lr at random in either framework, and a
# gradient near eps turns a difference dg into lr * dg / (4 eps).  The
# steps compared here use eps = 1e-4: the gradients agree to ~1e-7, which
# moves an entry by at most ~2.5e-6, while the gradients that matter
# (1e-3 and up) still move their entries by ~lr.
STEP_OPT = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10, eps=1e-4)
PARAM_ATOL = 2e-5


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jb = {"tokens": jnp.asarray(seq[:, :-1]), "targets": jnp.asarray(seq[:, 1:]),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": long_tensor(seq[:, :-1]), "targets": long_tensor(seq[:, 1:]),
          "loss_mask": torch.from_numpy(mask)}
    return jb, tb


# --------------------------------------------------------------------------
# optimizer and compression: the cases of tests/test_train.py
# --------------------------------------------------------------------------
def test_torch_adamw_matches_reference_implementation():
    cfg = topt.AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=100,
                           schedule="constant", weight_decay=0.0,
                           grad_clip_norm=1e9, min_lr_ratio=1.0)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = topt.init_adamw(params)
    new_p, state, _ = topt.adamw_update(cfg, params, grads, state)

    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.05 * np.array([0.1, 0.2, -0.3]) ** 2
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.95)
    expect = np.array([1.0, -2.0, 3.0]) - 1e-2 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)
    assert state.step == 1
    assert new_p["w"] is params["w"]           # updated in place


def test_torch_lr_schedule_shapes():
    cfg = topt.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=110,
                           min_lr_ratio=0.1, schedule="cosine")
    assert topt.lr_at(cfg, 0) == 0.0
    assert topt.lr_at(cfg, 10) == pytest.approx(1.0)
    assert topt.lr_at(cfg, 110) == pytest.approx(0.1, abs=1e-3)
    assert 0.1 < topt.lr_at(cfg, 60) < 1.0


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_torch_lr_schedule_matches_jax(schedule):
    cfg = dict(peak_lr=3e-3, warmup_steps=7, total_steps=50,
               min_lr_ratio=0.2, schedule=schedule)
    for step in (0, 3, 7, 20, 49, 50, 80):
        assert topt.lr_at(topt.AdamWConfig(**cfg), step) == pytest.approx(
            float(jopt.lr_at(jopt.AdamWConfig(**cfg), step)), rel=1e-6)


def test_torch_grad_clipping_bounds_update():
    cfg = topt.AdamWConfig(grad_clip_norm=1.0, warmup_steps=0,
                           schedule="constant")
    params = {"w": torch.zeros(4)}
    grads = {"w": torch.full((4,), 100.0)}
    _, _, metrics = topt.adamw_update(cfg, params, grads,
                                      topt.init_adamw(params))
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    clipped, norm = topt.clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


def test_torch_adamw_matches_jax_over_three_steps():
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
               weight_decay=0.1, grad_clip_norm=0.5)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in (("a", (3, 4)), ("b", (5,)))}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jopt.init_adamw(jp), topt.init_adamw(tp)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp,
                                       {k: jnp.asarray(v) for k, v in g.items()},
                                       js)
        tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**cfg), tp,
                                       {k: torch.tensor(v) for k, v in g.items()},
                                       ts)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-5)
    for k in p0:
        _close_leaf(tp[k], jp[k], 1e-5)
        _close_leaf(ts.mu[k], js.mu[k], 1e-5)
        _close_leaf(ts.nu[k], js.nu[k], 1e-5)


def test_torch_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    q, s = gc.quantize_int8(x)
    err = torch.abs(gc.dequantize_int8(q, s) - x)
    assert float(err.max()) <= float(s) * 0.5 + 1e-7
    assert q.dtype == torch.int8


def test_torch_error_feedback_reduces_bias():
    g = torch.tensor([1e-4, 5e-3, 1.0])
    err = torch.zeros(3)
    applied = torch.zeros(3)
    for _ in range(200):
        out, err = gc.compress_decompress(g, err)
        applied = applied + out
    np.testing.assert_allclose((applied / 200).numpy(), g.numpy(), rtol=0.05,
                               atol=1e-4)


def test_torch_compress_tree_matches_jax():
    from repro.distributed import grad_compress as jgc
    rng = np.random.default_rng(1)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in (("a", (6, 5)), ("b", (7,)))}
    e = {k: 0.01 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in g.items()}
    jg, je = jgc.compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                               {k: jnp.asarray(v) for k, v in e.items()})
    tg, te = gc.compress_tree({k: torch.tensor(v) for k, v in g.items()},
                              {k: torch.tensor(v) for k, v in e.items()})
    for k in g:
        _close_leaf(tg[k], jg[k], 1e-6)
        _close_leaf(te[k], je[k], 1e-6)
    assert set(gc.init_error_feedback({"a": torch.ones(2)})) == {"a"}


# --------------------------------------------------------------------------
# the model's loss and gradients
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jmodel, params, _, cfg = jax_and_port(request.param)
    tree = jax.tree_util.tree_map(np.asarray, params)
    port_cfg = reduced(get_config(request.param))
    return dict(arch=request.param, jmodel=jmodel, params=params, cfg=cfg,
                tree=tree, port_cfg=port_cfg, steps={})


def test_torch_loss_and_grads_match_jax(pair):
    jmodel, cfg = pair["jmodel"], pair["cfg"]
    jb, tb = _batch(cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat_policy="none"),
        has_aux=True))(pair["params"])
    model = from_jax_params(pair["port_cfg"], pair["tree"], trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    loss, metrics = model.loss(tb, remat_policy="none")
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    _close_named({k: p.grad for k, p in model.named_parameters()}, jgrads,
                 cfg.num_layers)


def test_torch_cross_entropy_matches_jax():
    from repro.models.lm import cross_entropy as jce
    from repro_torch.models.lm import cross_entropy as tce
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    expect = jce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    got = tce(torch.tensor(logits), long_tensor(targets), torch.tensor(mask))
    assert float(got) == pytest.approx(float(expect), rel=1e-6)


# --------------------------------------------------------------------------
# whole train steps
# --------------------------------------------------------------------------
def _jax_init(pair, tcfg_kw):
    jcfg = jts.TrainStepConfig(optimizer=jopt.AdamWConfig(**STEP_OPT),
                               **tcfg_kw)
    return jcfg, jts.init_train_state(pair["jmodel"], jax.random.PRNGKey(0),
                                      jcfg)


def _jax_step(pair, tcfg_kw):
    """One JAX train step from a fresh state, computed once per config.
    Returns (state before with numpy leaves, state after, metrics)."""
    key = tuple(sorted(tcfg_kw.items()))
    if key not in pair["steps"]:
        jcfg, state = _jax_init(pair, tcfg_kw)
        before = jax.tree_util.tree_map(np.asarray, state)
        jb, _ = _batch(pair["cfg"], seed=3)
        after, metrics = jax.jit(jts.make_train_step(pair["jmodel"], jcfg))(
            state, jb)
        pair["steps"][key] = (before, after, metrics)
    return pair["steps"][key]


def _port_step(pair, before, tcfg_kw):
    tcfg = tts.TrainStepConfig(optimizer=topt.AdamWConfig(**STEP_OPT),
                               **tcfg_kw)
    state = from_jax_train_state(pair["port_cfg"], before)
    _, tb = _batch(pair["cfg"], seed=3)
    step = tts.make_train_step(state.model, tcfg)
    return step(state, tb)


def _within_a_bin(state, after, n):
    """The compressed step: a gradient entry that sits on a rounding
    boundary of the int8 grid may land one bin (max|g| / 127 of its leaf)
    apart in the two frameworks, so the error feedback may differ by one
    bin, the first moment by 0.1 bin and a parameter by lr * bin / eps."""
    mu = named_from_tree(jax.tree_util.tree_map(np.asarray, after.opt.mu), n)
    err = named_from_tree(jax.tree_util.tree_map(np.asarray, after.err), n)
    par = named_from_tree(jax.tree_util.tree_map(np.asarray, after.params), n)
    lr_over_eps = STEP_OPT["peak_lr"] / STEP_OPT["eps"]
    for k, p in state.params.items():
        bin_ = 1.01 * 10 * float(np.abs(mu[k]).max()) / 127 + 1e-9
        _close_leaf(state.err[k], err[k], 0, bin_)
        _close_leaf(state.opt.mu[k], mu[k], 0, 0.1 * bin_)
        _close_leaf(p, par[k], 0, lr_over_eps * bin_ + PARAM_ATOL)


@pytest.mark.parametrize("kw", [
    dict(remat_policy="none"),
    dict(remat_policy="dots", microbatches=2),
    dict(remat_policy="none", compress_grads=True),
    dict(remat_policy="none", dp_manual=True),
], ids=["plain", "microbatches2", "compress", "dp_manual"])
def test_torch_train_step_matches_jax(pair, kw):
    """One step from the same state and batch: loss, gradient norm, the
    updated parameters and both AdamW moments (and the error feedback).
    ``dp_manual`` off a mesh takes the plain path in both frameworks."""
    before, after, jm = _jax_step(pair, kw)
    state, tm = _port_step(pair, before, kw)
    n = pair["cfg"].num_layers
    assert state.opt.step == int(after.opt.step) == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    if kw.get("compress_grads"):
        _within_a_bin(state, after, n)
        return
    assert state.err is None
    _close_named(state.params, after.params, n, atol=PARAM_ATOL)
    _close_named(state.opt.mu, after.opt.mu, n)
    _close_named(state.opt.nu, after.opt.nu, n, rtol=2e-4)


@pytest.mark.parametrize("policy", ["dots", "full", "nothing"])
def test_torch_remat_policies_give_the_same_step(pair, policy):
    """Recomputing layers in the backward changes no number: the step with
    each remat policy equals the step that keeps every activation, and
    microbatches=2 with it equals JAX's microbatches=2 step."""
    before, after, _ = _jax_step(pair, dict(microbatches=2))
    ref_state, ref_m = _port_step(pair, before, dict(remat_policy="none",
                                                     microbatches=2))
    state, m = _port_step(pair, before, dict(remat_policy=policy,
                                             microbatches=2))
    assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]), rel=1e-6)
    for k, v in state.params.items():
        torch.testing.assert_close(v, ref_state.params[k], rtol=1e-6,
                                   atol=1e-7)
    _close_named(state.params, after.params, pair["cfg"].num_layers,
                 atol=PARAM_ATOL)


def test_torch_run_stack_rejects_an_unknown_policy(pair):
    model = from_jax_params(pair["port_cfg"], pair["tree"], trainable=True)
    _, tb = _batch(pair["cfg"])
    with pytest.raises(ValueError, match="remat_policy"):
        model.loss(tb, remat_policy="everything")


# --------------------------------------------------------------------------
# train state plumbing
# --------------------------------------------------------------------------
def test_torch_init_train_state_draws_masters_on_the_cpu():
    cfg = reduced(get_config("mamba2-780m"))
    tcfg = tts.TrainStepConfig(compress_grads=True)
    state = tts.init_train_state(cfg, torch.Generator().manual_seed(0), tcfg,
                                 device="cpu")
    again = tts.init_train_state(cfg, torch.Generator().manual_seed(0), tcfg,
                                 device="cpu")
    names = set(state.params)
    assert names == set(state.opt.mu) == set(state.opt.nu) == set(state.err)
    assert "layers.1.ssm.A_log" in names and "embed.tokens" in names
    assert len(names) == 2 + 13 * cfg.num_layers
    for k, p in state.params.items():
        assert p.dtype == torch.float32 and p.requires_grad
        assert p.device.type == "cpu"
        torch.testing.assert_close(p, again.params[k], rtol=0, atol=0)
    assert state.opt.step == 0 and not state.opt.mu["embed.tokens"].any()
    # a trainable model is taken as it is
    same = tts.init_train_state(state.model, None, tts.TrainStepConfig(),
                                device="cpu")
    assert same.model is state.model and same.err is None
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.models.module import init_params
    serving = build_model(cfg, init_params(DecoderLM.param_specs(cfg),
                                           torch.Generator().manual_seed(0)),
                          device="cpu")
    with pytest.raises(ValueError, match="trainable"):
        tts.init_train_state(serving, None, tcfg, device="cpu")


def test_torch_init_train_state_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tts.init_train_state(reduced(get_config("mamba2-780m")),
                             torch.Generator().manual_seed(0),
                             tts.TrainStepConfig())


def test_torch_microbatches_must_divide_the_batch(pair):
    _, state = _jax_init(pair, {})
    before = jax.tree_util.tree_map(np.asarray, state)
    with pytest.raises(ValueError, match="microbatches"):
        _port_step(pair, before, dict(microbatches=3))
