"""The port's encdec family (whisper-large-v3) on the CPU against the JAX
package: the layernorm, the gelu MLP and the sinusoids, the encoder, the
loss and its gradients, prefill with its self and cross K/V caches,
decode, the engine with frames, the checkpoint manifest, the launchers,
and the flash path's non-causal T != S and one-query-row shapes.

Reduced whisper (2 encoder and 2 decoder layers, d_model 64, 4 / 2 heads
of 16, 16 source positions).  Inputs are made from a seed with numpy;
parameters are ``repro``'s, carried across by ``from_jax_params``.  fp32
compute (tests/conftest.py).  Tolerances: the layers and the sinusoids
atol / rtol 1e-5; logits atol / rtol 1e-4; the bf16 caches to one bf16
ulp (rtol 2^-7, atol 1e-6); gradients rtol 1e-4 with a floor of 1e-5 of
each leaf's largest entry; flash against the Pallas kernel in interpret
mode atol / rtol 2e-5, as tests/test_torch_port_faults.py holds it.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_support import as_f32, host_copy, long_tensor, rand, same_bytes

ARCH = "whisper-large-v3"
B, S, STEPS = 2, 12, 5
MAX_LEN = S + STEPS + 3
CACHE_LEAVES = {"k", "v", "cross_k", "cross_v"}


def _configs():
    from repro.configs import get_config, reduced
    from repro_torch.configs import get_config as port_config
    from repro_torch.configs import reduced as port_reduced
    return reduced(get_config(ARCH)), port_reduced(port_config(ARCH))


_PAIR = {}


def _models():
    """(jax model, jax params, numpy tree, port model, jax cfg, port cfg)."""
    from repro.models import build_model
    from repro_torch.models.convert import from_jax_params
    jcfg, tcfg = _configs()
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, tree, from_jax_params(tcfg, tree, device="cpu"), \
        jcfg, tcfg


@pytest.fixture
def pair():
    """The reduced model in both packages, made once."""
    if not _PAIR:
        jmodel, params, tree, port, jcfg, tcfg = _models()
        _PAIR.update(jmodel=jmodel, params=params, tree=tree, port=port,
                     cfg=jcfg, port_cfg=tcfg)
    return _PAIR


def _close(out, expect, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(as_f32(out), as_f32(expect), atol=atol,
                               rtol=rtol)


def _frames(cfg, batch, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.max_source_positions, cfg.d_model)).astype(np.float32)


def _batches(cfg, prompts, frames=None):
    """The prefill batch in both packages, with seeded frames."""
    frames = _frames(cfg, prompts.shape[0]) if frames is None else frames
    return ({"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)},
            {"tokens": long_tensor(prompts),
             "frames": torch.from_numpy(frames)})


# ---- the layers ------------------------------------------------------------

def _jax_and_port_params(specs_j, specs_t, seed):
    """Random values for a group of leaves, the same in both packages."""
    rng = np.random.default_rng(seed)
    vals = {k: rng.standard_normal(s.shape).astype(np.float32)
            for k, s in specs_j.items()}
    assert {k: s.shape for k, s in specs_t.items()} == \
        {k: s.shape for k, s in specs_j.items()}
    return ({k: jnp.asarray(v) for k, v in vals.items()},
            {k: torch.from_numpy(v) for k, v in vals.items()})


def test_torch_layernorm_matches_jax():
    """fp32 with the population variance, as ``jnp.var``; ``norm`` picks
    it for a parameter group with a bias."""
    from repro.models import layers as jll
    from repro_torch.models import layers as tll
    jcfg, tcfg = _configs()
    jp, tp = _jax_and_port_params(jll.norm_specs(jcfg), tll.norm_specs(tcfg),
                                  seed=1)
    assert set(tp) == {"scale", "bias"}
    jx, tx = rand(0, (B, 7, jcfg.d_model))
    jx, tx = jx * 3.0 + 0.5, tx * 3.0 + 0.5
    out = tll.norm(tp, tx, tcfg)
    _close(out, jll.layernorm(jp, jx, jcfg.norm_eps), atol=1e-5, rtol=1e-5)
    _close(out, tll.layernorm(tp, tx, tcfg.norm_eps), atol=0, rtol=0)


def test_torch_gelu_mlp_matches_jax_and_erf_gelu_does_not():
    """``jax.nn.gelu`` is the tanh approximation: the port's MLP matches
    it to 1e-5, and the same MLP through the exact erf gelu misses."""
    from repro.models import layers as jll
    from repro_torch.models import layers as tll
    jcfg, tcfg = _configs()
    jp, tp = _jax_and_port_params(jll.mlp_specs(jcfg), tll.mlp_specs(tcfg),
                                  seed=3)
    assert set(tp) == {"wi", "bi", "wo", "bo"}
    jx, tx = rand(4, (B, 7, jcfg.d_model))
    expect = jll.mlp(jp, jcfg, jx)
    _close(tll.mlp(tp, tcfg, tx), expect, atol=1e-5, rtol=1e-5)
    erf = F.gelu(tx @ tp["wi"] + tp["bi"]) @ tp["wo"] + tp["bo"]
    assert not np.allclose(as_f32(erf), as_f32(expect), atol=1e-5, rtol=1e-5)


def test_torch_sinusoids_match_jax():
    from repro.models.lm import _sinusoidal as jsin
    from repro_torch.models.lm import _sinusoidal as tsin
    pos = np.stack([np.arange(1500), np.arange(1500)[::-1]]).astype(np.int32)
    for d in (64, 1280, 7):
        _close(tsin(long_tensor(pos), d), jsin(jnp.asarray(pos), d),
               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("reduce", [False, True])
def test_torch_encdec_param_specs_match_jax(reduce):
    """The spec trees (full width and reduced): the same leaves, shapes,
    init kinds and scales, the encoder stacked on ``encoder_layers`` and
    the decoder's cross-attention without qk-norm."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.module import is_spec
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import EncDecLM, param_specs
    jcfg, tcfg = _configs() if reduce else \
        (get_config(ARCH), port_config(ARCH))
    jleaves = jax.tree_util.tree_flatten_with_path(
        build_model(jcfg).param_specs(), is_leaf=is_spec)[0]
    tspecs = param_specs(tcfg)
    assert tspecs.keys() == EncDecLM.param_specs(tcfg).keys()
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v

    walk(tspecs, ())
    assert len(flat) == len(jleaves)
    for path, js in jleaves:
        ts = flat[tuple(p.key for p in path)]
        assert (ts.shape, ts.init, ts.scale, ts.fan_in_dims) == \
            (js.shape, js.init, js.scale, js.fan_in_dims)
    assert flat[("encoder", "attn", "wq")].shape[0] == tcfg.encoder_layers
    assert flat[("layers", "cross", "wk")].shape[0] == tcfg.num_layers
    assert ("encoder", "cross", "wq") not in flat
    assert ("layers", "ln_cross", "bias") in flat


def test_torch_encdec_params_load_in_their_dtypes(pair):
    """A serving model keeps the layernorms' scale and bias in fp32, as
    JAX uses them, and the biases of attention and the MLP in the compute
    dtype."""
    from repro_torch.models import layers as ll
    port = pair["port"]
    assert len(port.encoder) == pair["port_cfg"].encoder_layers
    assert port.enc_norm["bias"].dtype == torch.float32
    assert port.layers[0]["ln_cross"]["bias"].dtype == torch.float32
    assert port.layers[0]["cross"]["bq"].dtype == ll.COMPUTE_DTYPE
    assert port.encoder[1]["mlp"]["bo"].dtype == ll.COMPUTE_DTYPE
    assert port.prefix_len == 0


def test_torch_encode_matches_jax(pair):
    cfg = pair["cfg"]
    frames = _frames(cfg, B)
    out = pair["port"].encode(torch.from_numpy(frames))
    assert out.shape == (B, cfg.max_source_positions, cfg.d_model)
    _close(out, pair["jmodel"].encode(pair["params"], jnp.asarray(frames)))


def test_torch_whisper_encoder_affects_decoder(pair):
    """The counterpart of tests/test_models.py's: frames * 2 + 1 move the
    logits, and equally in both packages."""
    cfg, port = pair["cfg"], pair["port"]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 8)).astype(np.int32)
    jb, tb = _batches(cfg, prompts)
    l1, _ = port.prefill(tb, port.init_cache(B, 16))
    tb2 = dict(tb, frames=tb["frames"] * 2.0 + 1.0)
    l2, _ = port.prefill(tb2, port.init_cache(B, 16))
    assert float((l1 - l2).abs().max()) > 1e-4
    jb2 = dict(jb, frames=jb["frames"] * 2.0 + 1.0)
    jl2, _ = pair["jmodel"].prefill(pair["params"], jb2,
                                    pair["jmodel"].init_cache(B, 16))
    _close(l2, jl2)


# ---- training -------------------------------------------------------------

def _train_batch(cfg, Bt=2, St=10, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, (Bt, St + 1)).astype(np.int32)
    mask = (rng.random((Bt, St)) > 0.2).astype(np.float32)
    frames = _frames(cfg, Bt, seed=seed + 1)
    jb = {"tokens": jnp.asarray(seq[:, :-1]),
          "targets": jnp.asarray(seq[:, 1:]), "loss_mask": jnp.asarray(mask),
          "frames": jnp.asarray(frames)}
    tb = {"tokens": long_tensor(seq[:, :-1]),
          "targets": long_tensor(seq[:, 1:]),
          "loss_mask": torch.from_numpy(mask),
          "frames": torch.from_numpy(frames)}
    return jb, tb


@pytest.mark.parametrize("policy", ["none", "full", "nothing", "dots"])
def test_torch_encdec_loss_and_grads_match_jax(policy):
    """The loss and every gradient leaf, each encoder and decoder leaf
    (cross-attention, layernorms, gelu MLPs) included, equal
    ``jax.grad``'s under each remat policy (the decoder's; the encoder
    runs without remat in both).  The key biases' gradients are 0 in
    exact arithmetic and are held as 0 in both packages."""
    from repro_torch.models.convert import from_jax_params, named_from_tree
    jmodel, params, tree, _, cfg, tcfg = _models()
    jb, tb = _train_batch(cfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat_policy=policy),
        has_aux=True))(params)
    model = from_jax_params(tcfg, tree, device="cpu", trainable=True)
    loss, m = model.loss(tb, remat_policy=policy)
    loss.backward()
    _close(loss.detach(), jloss)
    assert float(m["tokens"]) == float(tb["loss_mask"].sum())
    expect = named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads),
                             cfg.num_layers, cfg.encoder_layers)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(expect)
    assert {"encoder.1.mlp.bi", "layers.0.cross.wk", "enc_norm.bias",
            "layers.1.ln_cross.scale"} <= set(got)
    gmax = max(float(np.abs(as_f32(e)).max()) for e in expect.values())
    for k, g in got.items():
        e = as_f32(expect[k])
        if k.endswith(".bk"):
            # a key bias adds q . bk to every logit of a query row, which
            # the softmax cancels: its gradient is 0, rounding noise in
            # both packages (~1e-10 here), held as 0
            assert float(np.abs(e).max()) <= 1e-6 * gmax, k
            assert float(g.abs().max()) <= 1e-6 * gmax, k
            continue
        np.testing.assert_allclose(
            as_f32(g), e, rtol=1e-4,
            atol=1e-5 * float(np.abs(e).max() or 1.0), err_msg=k)


def test_torch_encdec_compression_scales_each_stacked_leaf():
    """Gradient compression quantises each stacked leaf of both groups
    (``encoder`` and ``layers``) with one scale, as JAX's ``compress_tree``
    does over the stacked tree.  Layer 0 of every leaf is drawn 8x larger
    than layer 1, so a scale per layer (or one group's count taken for the
    other's) would quantise layer 1 on a finer grid and miss."""
    from repro.distributed import grad_compress as jgc
    from repro_torch.distributed import grad_compress as tgc
    from repro_torch.models.convert import named_from_tree
    from repro_torch.train.train_step import stacked_name
    jmodel, _, tree, _, cfg, _ = _models()
    rng = np.random.default_rng(9)

    def draw(path, leaf):
        g = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[0].key in ("encoder", "layers"):
            g[0] *= 8.0
        return g

    grads = jax.tree_util.tree_map_with_path(draw, tree)
    jg, _ = jgc.compress_tree(jax.tree_util.tree_map(jnp.asarray, grads),
                              jgc.init_error_feedback(grads))
    named = {k: torch.from_numpy(v) for k, v in named_from_tree(
        grads, cfg.num_layers, cfg.encoder_layers).items()}
    tg, _ = tgc.compress_tree(named, tgc.init_error_feedback(named),
                              group=stacked_name)
    expect = named_from_tree(jax.tree_util.tree_map(np.asarray, jg),
                             cfg.num_layers, cfg.encoder_layers)
    assert stacked_name("encoder.1.attn.wq") == "encoder.attn.wq"
    assert set(tg) == set(expect)
    for k, g in tg.items():
        np.testing.assert_allclose(as_f32(g), expect[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# ---- serving ---------------------------------------------------------------

def _prefill_both(pair, prompts, kv_dtype=torch.bfloat16, frames=None):
    """Prefill in both packages over caches of ``kv_dtype``:
    (jax logits, jax cache, port logits, port cache)."""
    jmodel, params, port, cfg = (pair[k] for k in
                                 ("jmodel", "params", "port", "cfg"))
    jb, tb = _batches(cfg, prompts, frames)
    jcache = jmodel.init_cache(prompts.shape[0], MAX_LEN, kv_dtype=getattr(
        jnp, str(kv_dtype).removeprefix("torch.")))
    jl, jcache = jmodel.prefill(params, jb, jcache)
    tcache = port.init_cache(prompts.shape[0], MAX_LEN, kv_dtype=kv_dtype)
    tl, tcache = port.prefill(tb, tcache)
    return jl, jcache, tl, tcache


def test_torch_encdec_prefill_matches_jax(pair):
    """Prefill logits and all four cache leaves: self K/V written up to
    the prompt (zero past it), the cross K/V over every source position,
    each rounded to bf16 in both packages (to one ulp)."""
    cfg = pair["cfg"]
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jcache, tl, tcache = _prefill_both(pair, prompts)
    assert tl.shape == (B, 1, cfg.vocab_size)
    _close(tl, jl)
    assert set(tcache) == CACHE_LEAVES == set(jcache)
    assert tcache["cross_k"].shape == (cfg.num_layers, B,
                                       cfg.max_source_positions,
                                       cfg.num_kv_heads, cfg.head_dim)
    for name, tc in tcache.items():
        assert tc.dtype == torch.bfloat16 and tuple(tc.shape) == \
            jcache[name].shape, name
        np.testing.assert_allclose(as_f32(tc), as_f32(jcache[name]),
                                   rtol=2 ** -7, atol=1e-6, err_msg=name)
    assert not as_f32(tcache["k"])[:, :, S:].any()
    assert as_f32(tcache["cross_v"]).any(axis=(0, 1, 3, 4)).all()


def test_torch_encdec_decode_matches_jax(pair):
    """Teacher-forced decode steps over fp32 caches: each step's logits
    and then every cache leaf (the self K/V written at each step, the
    cross K/V untouched) to 1e-4."""
    jmodel, params, port, cfg = (pair[k] for k in
                                 ("jmodel", "params", "port", "cfg"))
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    jl, jcache, tl, tcache = _prefill_both(pair, prompts,
                                           kv_dtype=torch.float32)
    _close(tl, jl)
    cross = tcache["cross_k"].clone()
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        jl, jcache = jmodel.decode_step(params, jcache,
                                        jnp.asarray(forced[:, i:i + 1]),
                                        jnp.asarray(pos))
        tl, tcache = port.decode_step(tcache, long_tensor(forced[:, i:i + 1]),
                                      long_tensor(pos))
        _close(tl, jl)
    for name in CACHE_LEAVES:
        assert tcache[name].dtype == torch.float32
        _close(tcache[name], jcache[name])
    assert torch.equal(tcache["cross_k"], cross)
    assert as_f32(tcache["k"])[:, :, S + STEPS - 1].any()


def test_torch_encdec_decode_equals_a_longer_prefill(pair):
    """A prefill of S - 1 tokens and one decode step over fp32 caches
    equals a prefill of all S (the self-attention without rotary and the
    cross-attention over the cached cross K/V agree with the full pass);
    a slot handed its neighbour's cross K/V misses by far more."""
    port, cfg = pair["port"], pair["cfg"]
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    _, tb = _batches(cfg, prompts)
    full, _ = port.prefill(tb, port.init_cache(B, MAX_LEN))
    cache = port.init_cache(B, MAX_LEN, kv_dtype=torch.float32)
    _, cache = port.prefill(dict(tb, tokens=tb["tokens"][:, :-1]), cache)
    swapped = {k: v.clone() for k, v in cache.items()}
    for k in ("cross_k", "cross_v"):
        swapped[k].copy_(swapped[k].roll(1, dims=1))
    pos = torch.full((B,), S - 1, dtype=torch.long)
    step, _ = port.decode_step(cache, tb["tokens"][:, -1:], pos)
    _close(step, full)
    wrong, _ = port.decode_step(swapped, tb["tokens"][:, -1:], pos)
    assert float((wrong - full).abs().max()) > 1e-2


def test_torch_encdec_greedy_tokens_match_jax_engine(pair):
    """The engines' greedy tokens are equal, the frames passed as
    ``extra_inputs`` to both."""
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.serve.engine import ServeEngine
    cfg = pair["cfg"]
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    extra = {"frames": _frames(cfg, 3, seed=8)}
    jtoks = JaxEngine(pair["jmodel"], pair["params"], max_batch=4,
                      max_len=20).generate(prompts, 6,
                                           extra_inputs=extra).tokens
    ttoks = ServeEngine(pair["port"], max_batch=4, max_len=20,
                        device="cpu").generate(prompts, 6,
                                               extra_inputs=extra).tokens
    np.testing.assert_array_equal(ttoks, jtoks)


# ---- the flash path's new shapes ------------------------------------------

@pytest.mark.parametrize("S_,T,H,K,D", [
    (20, 48, 4, 2, 16),          # reduced whisper's cross prefill
    (1, 48, 4, 2, 16),           # its cross decode
    (24, 100, 4, 4, 64),         # whisper's head dim, T past a 64-key tile
    (1, 100, 4, 4, 64),
], ids=["cross_prefill", "cross_decode", "d64_cross", "d64_decode"])
def test_torch_flash_non_causal_cross_shapes_match_jax(monkeypatch, S_, T, H,
                                                       K, D):
    """``ops.attention`` non-causal with T != S and with one query row
    (flash's CPU path) against ``repro``'s ``ops.attention`` routed to
    the Pallas kernel in interpret mode; fp32."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "pallas_interpret")
    jq, tq = rand(10, (2, S_, H, D))
    jk, tk = rand(11, (2, T, K, D))
    jv, tv = rand(12, (2, T, K, D))
    out = tops.attention(tq, tk, tv, causal=False)
    ref = jops.attention(jq, jk, jv, causal=False)
    np.testing.assert_allclose(as_f32(out), as_f32(ref), atol=2e-5,
                               rtol=2e-5)


# ---- checkpoints and entry points -------------------------------------------

def test_torch_encdec_checkpoint_manifest_matches_jax(tmp_path):
    """A whisper train state saved by the port has ``repro``'s manifest
    byte for byte: the ``encoder`` group stacked on ``encoder_layers``
    beside the decoder's ``layers``, in JAX's flatten order."""
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.models import build_model
    from repro.train.train_step import TrainStepConfig, init_train_state
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.convert import from_jax_train_state
    jcfg, tcfg = _configs()
    jstate = init_train_state(build_model(jcfg), jax.random.PRNGKey(0),
                              TrainStepConfig())
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    port = from_jax_train_state(tcfg, jstate, device="cpu")
    JaxCheckpointer(str(tmp_path / "jax")).save(2, jstate, block=True)
    Checkpointer(str(tmp_path / "port")).save(2, port, block=True)
    texts = [(tmp_path / d / "step_00000002" / "manifest.json").read_text()
             for d in ("jax", "port")]
    assert texts[0] == texts[1]
    manifest = json.loads(texts[0])
    assert manifest["0/encoder/attn/wq"]["shape"][0] == jcfg.encoder_layers
    assert manifest["0/layers/cross/wk"]["shape"][0] == jcfg.num_layers
    assert "0/enc_norm/bias" in manifest


def test_torch_launch_serve_refuses_encdec(monkeypatch):
    """The serving launcher sends text-only requests: for whisper it
    raises at the start instead of serving requests it cannot answer
    (``repro``'s launcher hangs there)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced",
                                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="frames"):
        serve.main()


def test_torch_launch_train_reduced_whisper_on_the_cpu(tmp_path, monkeypatch,
                                                       capsys):
    """The Trainer trains reduced whisper on the CPU from the launcher's
    frame stub, and checkpoints it."""
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
        "3", "--global-batch", "4", "--seq-len", "12", "--no-autotune",
        "--num-items", "32", "--checkpoint-dir", str(tmp_path / "ck")])
    assert train.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 3 and np.isfinite(out["loss"])


def test_torch_launch_train_whisper_delivers_repro_s_first_batch(monkeypatch):
    """Both launchers build the encdec stub dataset from one seeded
    generator in the same order: the first batch the loader delivers
    (read with no worker threads, so the frames are drawn in the items'
    order) is ``repro``'s byte for byte, frames included.  The Trainer
    is replaced by a recorder of the loader it is given."""
    import repro.train.trainer as jtrainer
    import repro_torch.train.trainer as ttrainer
    from repro.data import LoaderParams as JParams
    from repro.launch import train as jlaunch
    from repro_torch.data import LoaderParams as TParams
    from repro_torch.launch import train as tlaunch
    loaders = {}

    def recorder(key):
        class Recorder:
            def __init__(self, model, loader, tc, **kw):
                loaders[key] = loader

            def run(self):
                return {"final_step": 0}
        return Recorder

    argv = ["train", "--arch", ARCH, "--reduced", "--steps", "1",
            "--global-batch", "4", "--seq-len", "16", "--num-items", "32",
            "--seed", "3"]
    monkeypatch.setattr(jtrainer, "Trainer", recorder("jax"))
    monkeypatch.setattr(ttrainer, "Trainer", recorder("port"))
    monkeypatch.setattr(sys, "argv", argv)
    assert jlaunch.main() == 0
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    assert tlaunch.main() == 0
    firsts = {}
    for key, params in (("jax", JParams(num_workers=0)),
                        ("port", TParams(num_workers=0))):
        batches = loaders[key].with_params(params).host_batches()
        firsts[key] = host_copy(next(iter(batches)))
    assert firsts["port"]["frames"].shape == (4, 16, 64)
    assert same_bytes(firsts["port"], firsts["jax"])
