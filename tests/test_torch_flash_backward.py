"""Flash attention's gradient on the CPU against the JAX package.

``repro`` has no custom_vjp: its gradient of attention is ``jax.grad`` of
the plain reference ``repro.kernels.ref.mha``.  The port's
``flash_attention_backward_plain`` (FlashAttention-2's equations from the
saved lse, the plain twin of the backward kernels) and ``_FlashAttention``'s
CPU path (the wiring the card drives) are held against it on the same
inputs, made with numpy: fp32, within 1e-5 of the largest entry of each of
dq, dk and dv.  Then the slice as a whole: reduced qwen2-0.5b with every
full-sequence attention call routed through ``_FlashAttention`` (inside the
test only), its loss and every gradient against ``jax.grad`` of ``repro``'s
under each remat policy, and one Trainer step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, jax_and_port, long_tensor
from repro.kernels import ref as jref
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataLoader, LoaderParams, token_dataset
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.convert import from_jax_params, named_from_tree
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

GRAD_ATOL_OF_MAX = 1e-5

# (B, S, T, H, K, D, kw): causal; a window of 5; q_offset with T > S; S
# not a multiple of 64; H = K; a group of 7; D 32 and 64; a window whose
# later rows see no key (queries at 18 .. 25 over 16 keys, window 5: rows
# 0 and 1 see keys 14 and 15, rows 2 .. 7 none)
CASES = {
    "causal": (2, 16, 16, 4, 2, 32, {}),
    "window5": (2, 24, 24, 4, 2, 32, dict(window=5)),
    "q_offset": (2, 8, 24, 4, 2, 32, dict(q_offset=16)),
    "ragged70": (1, 70, 70, 2, 1, 32, {}),
    "h_eq_k": (2, 16, 16, 4, 4, 32, {}),
    "group7": (1, 16, 16, 14, 2, 64, {}),
    "d64_window": (1, 20, 20, 2, 1, 64, dict(window=7)),
    "noncausal": (2, 12, 20, 4, 2, 32, dict(causal=False)),
    "no_key_rows": (2, 8, 16, 4, 2, 32, dict(window=5, q_offset=18)),
}


def _inputs(B, S, T, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, S, H, D), (B, T, K, D), (B, T, K, D), (B, S, H, D))]


def _q_pos(B, S, q_offset):
    return jnp.broadcast_to(q_offset + jnp.arange(S)[None], (B, S))


def _jax_grads(q, k, v, do, kw):
    """jax.grad of <ref.mha(q, k, v), do>: (out, dq, dk, dv)."""
    B, S = q.shape[:2]
    mha_kw = dict(causal=kw.get("causal", True), window=kw.get("window", 0),
                  q_pos=_q_pos(B, S, kw.get("q_offset", 0)))

    def f(q_, k_, v_):
        return jnp.sum(jref.mha(q_, k_, v_, **mha_kw) * do)

    out = jref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **mha_kw)
    return (out, *jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _close_grad(got, expect):
    expect = as_f32(expect)
    atol = GRAD_ATOL_OF_MAX * float(np.abs(expect).max() or 1.0)
    np.testing.assert_allclose(as_f32(got), expect, rtol=0, atol=atol)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    B, S, T, H, K, D, kw = CASES[request.param]
    arrays = _inputs(B, S, T, H, K, D)
    return dict(name=request.param, kw=kw, arrays=arrays,
                expect=_jax_grads(*arrays, kw))


def test_torch_flash_backward_plain_matches_jax_grad(case):
    q, k, v, do = (torch.from_numpy(a) for a in case["arrays"])
    o, lse = fa.flash_attention_plain_lse(q, k, v, **case["kw"])
    got = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                            **case["kw"])
    for g, e in zip(got, case["expect"][1:]):
        assert g.dtype == torch.float32
        _close_grad(g, e)


def test_torch_flash_function_cpu_path_matches_jax_grad(case):
    """``flash_attention`` on CPU tensors that need a gradient goes
    through ``_FlashAttention`` and counts no launch."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in case["arrays"][:3])
    do = torch.from_numpy(case["arrays"][3])
    fa.flash_attention.launches = fa.flash_attention.backward_launches = 0
    out = fa.flash_attention(q, k, v, **case["kw"])
    assert out.grad_fn is not None and "_FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(do)
    np.testing.assert_allclose(as_f32(out), as_f32(case["expect"][0]),
                               rtol=2e-5, atol=2e-5)
    for t, e in zip((q, k, v), case["expect"][1:]):
        _close_grad(t.grad, e)
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention.backward_launches == 0


def test_torch_flash_plain_lse_matches_repro(case):
    """o against ``repro``'s ``ref.mha``; lse against a logsumexp of the
    masked scaled scores, -inf where a row sees no key."""
    q, k, v, _ = case["arrays"]
    kw = case["kw"]
    o, lse = fa.flash_attention_plain_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(as_f32(o), as_f32(case["expect"][0]),
                               rtol=2e-5, atol=2e-5)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    s = jnp.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, H // K, D),
                   k) * D ** -0.5
    mask = jref.attention_mask(_q_pos(B, S, kw.get("q_offset", 0)),
                               jnp.broadcast_to(jnp.arange(T)[None], (B, T)),
                               causal=kw.get("causal", True),
                               window=kw.get("window", 0))
    s = jnp.where(mask[:, None, None], s, -jnp.inf)
    expect = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, S)
    got = lse.numpy()
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(expect))
    seen = np.isfinite(expect)
    np.testing.assert_allclose(got[seen], expect[seen], rtol=1e-5, atol=1e-5)


def test_torch_flash_rows_that_see_no_key_give_exact_zeros():
    """Queries at 18 .. 25 over 16 keys with a window of 5: rows 2 .. 7
    see no key; their output and dq are exactly 0 and their lse -inf, on
    the plain twins and through the Function."""
    B, S, T, H, K, D, kw = CASES["no_key_rows"]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    o, lse = fa.flash_attention_plain_lse(q, k, v, **kw)
    assert torch.isneginf(lse[:, :, 2:]).all()
    assert torch.isfinite(lse[:, :, :2]).all()
    dq, dk, dv = fa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    assert (o[:, 2:] == 0).all() and (dq[:, 2:] == 0).all()
    assert (o[:, :2] != 0).any() and (dq[:, :2] != 0).any()
    # keys no query sees (0 .. 13) get no gradient
    assert (dk[:, :14] == 0).all() and (dv[:, :14] == 0).all()
    qg = q.clone().requires_grad_()
    out = fa.flash_attention(qg, k, v, **kw)
    out.backward(do)
    assert (out[:, 2:] == 0).all() and (qg.grad[:, 2:] == 0).all()


def test_torch_flash_function_gradcheck_fp64():
    """``torch.autograd.gradcheck`` of the Function's CPU path in fp64, at
    a causal GQA shape and at a window over a q_offset."""
    gen = torch.Generator().manual_seed(0)
    for (B, S, T, H, K, D), kw in (((1, 5, 5, 4, 2, 4), {}),
                                   ((1, 4, 9, 2, 1, 4),
                                    dict(window=3, q_offset=5))):
        q = torch.randn((B, S, H, D), generator=gen, dtype=torch.float64,
                        requires_grad=True)
        k, v = (torch.randn((B, T, K, D), generator=gen, dtype=torch.float64,
                            requires_grad=True) for _ in range(2))
        assert torch.autograd.gradcheck(
            lambda a, b, c: fa._FlashAttention.apply(
                a, b, c, kw.get("causal", True), kw.get("window", 0),
                kw.get("q_offset", 0), None), (q, k, v))


def test_torch_flash_backward_refuses_what_its_kernels_do_not_take():
    """The checks the card's Function runs before launching: fp32, head
    dim 24 and rows that are not 16-byte aligned raise
    NotImplementedError (nothing falls back to the plain twin)."""
    kv = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16)
    fa._check_backward(torch.zeros((1, 8, 4, 32), dtype=torch.bfloat16),
                       kv, kv)
    with pytest.raises(NotImplementedError, match="float32"):
        fa._check_backward(torch.zeros((1, 8, 4, 32)), kv.float(),
                           kv.float())
    kv24 = torch.zeros((1, 8, 2, 24), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head dim 24"):
        fa._check_backward(torch.zeros((1, 8, 4, 24), dtype=torch.bfloat16),
                           kv24, kv24)
    wide = torch.zeros((1, 8, 4, 34), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="aligned"):
        fa._check_backward(wide[..., 1:33], kv, kv)


# --------------------------------------------------------------------------
# the slice as a whole: reduced qwen2-0.5b through _FlashAttention
# --------------------------------------------------------------------------
B, S = 4, 16


@pytest.fixture
def through_the_function(monkeypatch):
    """Route ``ops.attention``'s non-ragged calls to ``flash_attention``
    (and so, under a gradient, to ``_FlashAttention``) for the test, as
    the card routes them; count the calls and the plain backward's."""
    calls = {"forward": 0, "backward": 0}
    orig_attention = ops.attention
    orig_backward = fa.flash_attention_backward_plain

    def attention(q, k, v, *, causal=True, window=0, q_pos=None,
                  kv_pos=None, kv_valid=None, softcap=0.0, q_offset=0,
                  scale=None, num_sink=0):
        ragged = q_pos is not None or kv_pos is not None \
            or kv_valid is not None or softcap > 0.0 or num_sink > 0
        if ragged:
            return orig_attention(q, k, v, causal=causal, window=window,
                                  q_pos=q_pos, kv_pos=kv_pos,
                                  kv_valid=kv_valid, softcap=softcap,
                                  q_offset=q_offset, scale=scale,
                                  num_sink=num_sink)
        calls["forward"] += 1
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, scale=scale)

    def backward(*args, **kwargs):
        calls["backward"] += 1
        return orig_backward(*args, **kwargs)

    monkeypatch.setattr(ops, "attention", attention)
    monkeypatch.setattr(fa, "flash_attention_backward_plain", backward)
    return calls


@pytest.fixture(scope="module")
def qwen2():
    jmodel, params, _, cfg = jax_and_port("qwen2-0.5b")
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jb = {"tokens": jnp.asarray(seq[:, :-1]),
          "targets": jnp.asarray(seq[:, 1:]), "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": long_tensor(seq[:, :-1]),
          "targets": long_tensor(seq[:, 1:]),
          "loss_mask": torch.from_numpy(mask)}
    return dict(jmodel=jmodel, params=params, cfg=cfg, tree=tree, jb=jb,
                tb=tb, port_cfg=reduced(get_config("qwen2-0.5b")))


@pytest.mark.parametrize("policy", ["none", "dots", "full", "nothing"])
def test_torch_qwen2_grads_through_flash_function_match_jax(
        qwen2, through_the_function, policy):
    """Loss to rel 1e-5 and every gradient leaf to rtol 1e-4 with a floor
    of 1e-5 of its largest entry, as test_torch_loss_and_grads_match_jax
    holds them; each layer's attention ran through the Function (and, but
    under "none", again in the recompute)."""
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: qwen2["jmodel"].loss(p, qwen2["jb"], remat_policy=policy),
        has_aux=True))(qwen2["params"])
    model = from_jax_params(qwen2["port_cfg"], qwen2["tree"], device="cpu",
                            trainable=True)
    loss, _ = model.loss(qwen2["tb"], remat_policy=policy)
    loss.backward()
    L = qwen2["cfg"].num_layers
    assert through_the_function == {
        "forward": L if policy == "none" else 2 * L, "backward": L}
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    expect = named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads), L)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(expect)
    for k, g in got.items():
        e = as_f32(expect[k])
        np.testing.assert_allclose(
            as_f32(g), e, rtol=1e-4,
            atol=1e-5 * float(np.abs(e).max() or 1.0), err_msg=k)


def test_torch_trainer_step_through_flash_function(qwen2,
                                                   through_the_function):
    """One Trainer step of reduced qwen2-0.5b on the CPU (remat "dots", the
    Trainer's default) with attention through the Function: a finite loss
    near ln V, one backward a layer."""
    cfg = qwen2["port_cfg"]
    loader = DataLoader(token_dataset(32, S, cfg.vocab_size, seed=1), B,
                        params=LoaderParams(num_workers=0), seed=1,
                        device="cpu")
    tr = Trainer(cfg, loader, TrainerConfig(
        total_steps=1, log_every=1, autotune=False,
        step_config=TrainStepConfig(
            optimizer=AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                  total_steps=10))), device="cpu")
    summary = tr.run()
    assert summary["final_step"] == 1
    loss = tr.history[-1]["loss"]
    assert np.isfinite(loss)
    assert abs(loss - np.log(cfg.vocab_size)) < 0.2 * np.log(cfg.vocab_size)
    L = cfg.num_layers
    assert through_the_function == {"forward": 2 * L, "backward": L}
