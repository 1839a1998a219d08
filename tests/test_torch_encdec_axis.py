"""The encdec family (whisper) under the port's model axis, against
``repro``'s single-device results: cross-attention split by heads (kv
heads padded where the heads do not divide), the encoder stack on the
storage plan under ``seq_res``, the ``dp_manual`` step of reduced whisper
on (data, model) meshes with both stacks sequence-parallel, serving
through ``launch/dryrun._serve_wrap`` under the serving rules with the
self and cross K/V caches cut on ``kv_seq``, and a checkpoint restored
across model sizes.

The multi-rank cases run gloo ranks on the CPU, each a process of its own
(``tests/_torch_tp_ranks.py``, jobs ``ve_pieces``, ``ve_step``,
``ve_serve`` and ``ve_restore``, spawned by ``_torch_support``), joined
through a ``FileStore`` under the test's temporary directory; one module
fixture starts every rank of the first round at once and computes the JAX
references while they run.  ``repro``'s sharded paths fail while tracing
here (``tests/test_dp_manual.py``), so each piece is held against
``repro``'s unsharded function on the same numpy-seeded inputs.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import join_ranks, rank_results, spawn_ranks

ARCH = "whisper-large-v3"
# cross-attention: (overrides, model axes, decoder tokens split by
# seq_res).  Reduced whisper has 4 / 2 heads of 16; 6 / 6 pad to (8, 1)
# at model 4, two padded kv heads, rank 3 holding padding only
CROSS = {"whisper": ({}, (2, 4), False),
         "whisper_seq": ({}, (2, 4), True),
         "whisper6": ({"num_heads": 6, "num_kv_heads": 6}, (2, 4), False)}
CROSS_B, CROSS_S = 2, 16
PIECE_WORLDS = (2, 4)
ENC_B = 2
# the step: reduced whisper (16 source positions: the encoder splits at
# model 2 and 4) and with 18 (split at model 2, whole at 4)
STEP_ARCHS = {"whisper": {}, "whisper18": {"max_source_positions": 18}}
B, S = 8, 16
STEP_MESHES = ("1x2", "1x4", "2x2")
STEP_RUNS = {"1x2": [("whisper",), ("whisper18",), ("whisper", "control")],
             "1x4": [("whisper",), ("whisper18",)],
             "2x2": [("whisper",)],
             "1x1": [("whisper",), ("whisper18",)]}
RESTORE_FROM = {"1x1": "2x2", "2x2": "1x1"}
# serving: (rows, prompt length, steps, max_len).  16 self K/V slots cut
# into blocks at model 2 and 4; 15 stay whole (the guard), so the
# unweighted control there touches only the cross cache
SERVE = {"whisper": (4, 6, 5, 16), "whisper_guard": (4, 6, 5, 15)}
SERVE_MESHES = ("1x2", "1x4", "2x2")
SERVE_RUNS = [("whisper",), ("whisper_guard",),
              ("whisper_guard", "unweighted")]
# pieces against repro in fp32: sums over the ranks in another order
PIECE_RTOL = 2e-5
# against repro's single-device step: tests/test_torch_ssm_axis.py's
# bounds (the step gathers the FSDP leaves in bf16, as repro's dp_manual
# step does)
REF_PARAM_ATOL, REF_LOSS_REL, REF_NORM_REL = 5e-3, 0.02, 1e-2
REF_MU_COSINE = 0.995
# against the port's world-1 step (tests/test_torch_model_axis.py's)
TIGHT_LOSS_REL = 1e-6
TIGHT_NORM_REL = 2e-4
TIGHT_MU_OF_MAX = 2 ** -7
TIGHT_COSINE = 1 - 1e-5
# serving in fp32 against repro: logits within 1e-4 of the largest
SERVE_OF_MAX = 1e-4


def _jax_config(overrides):
    from repro.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(ARCH)), **overrides)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _normal(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=PIECE_RTOL, what=""):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= rtol * scale, (what, err, scale)


def _grads_close(got, want, rtol=PIECE_RTOL):
    """Every gradient of ``want`` against ``got``'s; a key bias's (``bk``),
    0 in exact arithmetic (softmax ignores a shift of every key by one
    bias, and whisper has no rotary to modulate it), is rounding noise on
    both sides and held within ``rtol`` of its layer's ``bv``'s largest
    gradient instead."""
    for k, v in want.items():
        if k.endswith("bk"):
            scale = rtol * float(np.max(np.abs(want[k[:-2] + "bv"])))
            assert float(np.max(np.abs(got[k]))) <= scale, k
            assert float(np.max(np.abs(v))) <= scale, k
        else:
            _close(got[k], v, rtol, k)


def _cosine(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _model_collectives(enc_split: bool) -> dict:
    """The collectives over "model" one step of reduced whisper (2 + 2
    layers, its table stored split, the decoder sequence-parallel)
    issues: per region (an encoder layer's attention and MLP, a decoder
    layer's self-attention, cross-attention and MLP) an all-gather in and
    a reduce-scatter out forward and their transposes backward, or where
    the encoder keeps its frames whole an all-reduce forward and one
    backward; the encoder's output entering the cross-attention once (a
    gather and its reduce-scatter, or the gradient's all-reduce); the
    lookup's reduce-scatter and its transpose; the cross-entropy's gather
    and transpose, its two sums and one max.  Under remat "dots" each
    decoder layer's recompute gathers its three regions' inputs again and
    reduce-scatters the two attentions' outputs again, stopping before
    the MLP's (the encoder is never rematerialised)."""
    enc_regions, dec_regions = 2 * 2, 3 * 2
    seq_regions = dec_regions + enc_regions * enc_split
    return {"all_gather": 2 * seq_regions + 2 + enc_split + 3 * 2,
            "reduce_scatter": 2 * seq_regions + 2 + enc_split + 2 * 2,
            "all_reduce": 2 + (2 * enc_regions + 1) * (not enc_split),
            "all_reduce_max": 1}


def _model_groups(tag):
    """Global ranks of each model group, rank = batch shard * n + model."""
    n = int(tag.split("x")[-1])
    total = int(np.prod([int(d) for d in tag.split("x")]))
    return [list(range(i, i + n)) for i in range(0, total, n)]


# ---- inputs -----------------------------------------------------------------

def _cross_inputs():
    from repro.models import layers as jl
    r = np.random.default_rng(41)
    out = {}
    for name, (ov, worlds, seq) in CROSS.items():
        cfg = _jax_config(ov)
        params = {k: _normal(r, s.shape, s.shape[0] ** -0.5)
                  for k, s in jl.attention_specs(cfg, cross=True).items()}
        out[name] = dict(arch=ARCH, overrides=ov, params=params,
                         worlds=worlds, seq=seq,
                         x=_normal(r, (CROSS_B, CROSS_S, cfg.d_model)),
                         enc=_normal(r, (CROSS_B, cfg.max_source_positions,
                                         cfg.d_model)),
                         dy=_normal(r, (CROSS_B, CROSS_S, cfg.d_model)))
    return out


def _encoder_inputs():
    from repro.models import build_model
    cfg = _jax_config({})
    params = build_model(cfg).init(jax.random.PRNGKey(2))
    r = np.random.default_rng(42)
    shape = (ENC_B, cfg.max_source_positions, cfg.d_model)
    return dict(arch=ARCH, overrides={},
                tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
                frames=_normal(r, shape), dy=_normal(r, shape))


def _step_inputs():
    from repro.models import build_model
    out = {}
    for name, ov in STEP_ARCHS.items():
        cfg = _jax_config(ov)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        r = np.random.default_rng(43)
        out[name] = dict(
            arch=ARCH, overrides=ov,
            tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
            batch={"tokens": r.integers(0, cfg.vocab_size, (B, S)),
                   "targets": r.integers(0, cfg.vocab_size, (B, S)),
                   "loss_mask": np.ones((B, S), np.float32),
                   "frames": _normal(r, (B, cfg.max_source_positions,
                                         cfg.d_model))})
    return out


def _serve_inputs():
    from repro.models import build_model
    cfg = _jax_config({})
    params = build_model(cfg).init(jax.random.PRNGKey(1))
    tree = _flat(jax.tree_util.tree_map(np.asarray, params))
    out = {}
    for name, (rows, prompt, steps, max_len) in SERVE.items():
        r = np.random.default_rng(44)
        out[name] = dict(
            arch=ARCH, overrides={}, steps=steps, max_len=max_len, tree=tree,
            prompts=r.integers(0, cfg.vocab_size, (rows, prompt)),
            extra={"frames": _normal(r, (rows, cfg.max_source_positions,
                                         cfg.d_model))})
    return out


# ---- references -------------------------------------------------------------

def _jax_cross(c):
    from repro.models import layers as jl
    cfg = _jax_config(c["overrides"])
    p = {k: jnp.asarray(v) for k, v in c["params"].items()}
    y, vjp = jax.vjp(lambda p, x, e: jl.attention(
        p, cfg, x, causal=False, kv_x=e, rope=False), p,
        jnp.asarray(c["x"]), jnp.asarray(c["enc"]))
    dp, dx, de = vjp(jnp.asarray(c["dy"]))
    return dict(y=np.asarray(y), dx=np.asarray(dx), denc=np.asarray(de),
                grads={k: np.asarray(v) for k, v in dp.items()})


def _jax_encoder(c):
    from repro.models import build_model
    from repro_torch.models.convert import named_from_tree
    cfg = _jax_config(c["overrides"])
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(2))
    y, vjp = jax.vjp(lambda p: model.encode(p, jnp.asarray(c["frames"])),
                     params)
    (dp,) = vjp(jnp.asarray(c["dy"]))
    named = named_from_tree(jax.tree_util.tree_map(np.asarray, dp),
                            cfg.num_layers, cfg.encoder_layers)
    return dict(y=np.asarray(y, np.float32),
                grads={k: v for k, v in named.items()
                       if k.startswith(("encoder.", "enc_norm."))})


def _jax_step(c):
    """``tests/test_dp_manual.py``'s single-device step, microbatches 1."""
    from repro.models import build_model
    from repro.train.optimizer import init_adamw
    from repro.train.train_step import (TrainState, TrainStepConfig,
                                        make_train_step)
    from repro_torch.models.convert import named_from_tree
    cfg = _jax_config(c["overrides"])
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(
        model, TrainStepConfig(remat_policy="dots", microbatches=1)))
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in c["batch"].items()}
    state, metrics = step(TrainState(params, init_adamw(params), None),
                          batch)
    named = lambda t: named_from_tree(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), cfg.num_layers,
        cfg.encoder_layers)
    return dict(params=named(state.params), mu=named(state.opt.mu),
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def _jax_greedy(c):
    """``repro``'s single-device prefill and greedy decode in fp32 over an
    fp32 K/V cache, with the frames: the logits of every step (the
    prefill's last position first), the greedy tokens and the cache."""
    from repro.models import build_model
    model = build_model(_jax_config(c["overrides"]))
    params = model.init(jax.random.PRNGKey(1))
    prompts = jnp.asarray(c["prompts"].astype(np.int32))
    Bp, Sp = prompts.shape
    cache = model.init_cache(Bp, c["max_len"], kv_dtype=jnp.float32)
    logits, cache = jax.jit(model.prefill)(
        params, {"tokens": prompts,
                 **{k: jnp.asarray(v) for k, v in c["extra"].items()}},
        cache)
    outs = [np.asarray(logits[:, -1], np.float32)]
    decode = jax.jit(model.decode_step)
    for i in range(c["steps"] - 1):
        tok = jnp.asarray(outs[-1].argmax(-1).astype(np.int32))[:, None]
        logits, cache = decode(params, cache, tok,
                               jnp.full((Bp,), Sp + i, jnp.int32))
        outs.append(np.asarray(logits[:, -1], np.float32))
    logits = np.stack(outs, 1)
    return dict(logits=logits, tokens=logits.argmax(-1),
                cache={k: np.asarray(v, np.float32)
                       for k, v in cache.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    workdir = tmp_path_factory.mktemp("encdec_ranks")
    inputs = dict(
        ve_cross=_cross_inputs(), ve_encoder=_encoder_inputs(),
        ve_archs=_step_inputs(), ve_step_runs=STEP_RUNS,
        ve_restore_from=RESTORE_FROM, ve_serve=_serve_inputs(),
        ve_serve_runs={t: SERVE_RUNS for t in SERVE_MESHES},
        step_config=TrainStepConfig(remat_policy="dots", dp_manual=True,
                                    optimizer=AdamWConfig()))
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jobs = {"1x2": ["ve_pieces", "ve_step", "ve_serve"],
            "1x4": ["ve_pieces", "ve_step", "ve_serve"],
            "2x2": ["ve_step", "ve_serve"], "1x1": ["ve_step"]}
    procs = {t: spawn_ranks(workdir, t, j, module="_torch_tp_ranks")
             for t, j in jobs.items()}
    try:
        refs = dict(
            cross={k: _jax_cross(c) for k, c in inputs["ve_cross"].items()},
            encoder=_jax_encoder(inputs["ve_encoder"]),
            step={k: _jax_step(inputs["ve_archs"][k]) for k in STEP_ARCHS},
            serve={k: _jax_greedy(c) for k, c in inputs["ve_serve"].items()})
    finally:
        for t in jobs:
            join_ranks(procs[t])
    second = {t: spawn_ranks(workdir, t, ["ve_restore"],
                             module="_torch_tp_ranks") for t in RESTORE_FROM}
    for t in second:
        join_ranks(second[t])
    return workdir, refs, inputs


# ---- no ranks ---------------------------------------------------------------

class _Stand:
    """A mesh-shaped stand-in: axis sizes, and rank 0 of every axis."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("rules", ("train", "serve", "serve_big"))
@pytest.mark.parametrize("mesh", ((1, 2), (1, 4), (2, 2)))
def test_torch_encdec_storage_spec_matches_jax(mesh, rules):
    """Every leaf of whisper-large-v3 (both stacks, cross-attention
    included) is stored as ``repro``'s ``ShardingCtx.partition_spec``
    places it on the (data, model) mesh under TRAIN_RULES, SERVE_RULES
    and SERVE_RULES_BIG: the port's storage plan, per layer, equals the
    spec of ``repro``'s stacked leaf past its layers dim.  The vocabulary
    of 51,866 stays whole at model 4 (the guard)."""
    from jax.sharding import AbstractMesh
    from repro.configs.base import get_config as jget
    from repro.distributed import sharding_rules as jsr
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding_rules as tsr
    from repro_torch.train.train_step import param_plan
    table = {"train": "TRAIN_RULES", "serve": "SERVE_RULES",
             "serve_big": "SERVE_RULES_BIG"}[rules]
    names = ("data", "model")
    jctx = jsr.ShardingCtx(AbstractMesh(mesh, names), getattr(jsr, table))
    ctx = tsr.ShardingCtx(_Stand(mesh, names), getattr(tsr, table))
    jmodel = jbuild(jget(ARCH))
    plan = param_plan(get_config(ARCH), ctx)
    axes = jax.tree_util.tree_flatten_with_path(
        jmodel.logical_axes(), is_leaf=lambda t: isinstance(t, tuple))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(
        jmodel.abstract_params())[0])
    checked = 0
    for path, ax in axes:
        parts = [k.key for k in path]
        want = tuple(jctx.partition_spec(ax, shapes[path].shape))
        stacked = parts[0] in ("layers", "encoder")
        name = ".".join(parts[:1] + ["0"] + parts[1:]) if stacked \
            else ".".join(parts)
        got = [None] * len(ax)
        for d, m in plan.dims.get(name, {}).items():
            got[d + stacked] = m[0] if len(m) == 1 else tuple(m)
        while got and got[-1] is None:
            got.pop()
        assert tuple(got) == want, (path, got, want)
        checked += 1
    assert checked == len(shapes) > 30
    vocab_split = any("model" in m for m in plan.dims.get(
        "embed.tokens", {}).values())
    assert vocab_split == (mesh[1] == 2)


@pytest.mark.parametrize("n", (2, 4))
def test_torch_model_axis_covers_encdec(n):
    """Under a model axis of ``n`` reduced whisper's loss outside the
    manual region (every rank computes whole) equals its loss off a mesh;
    ``stack.sp_split`` gives the encoder its own split of the frames and
    the decoder of the tokens, each only where the axis divides its
    length."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import stack as stk
    from repro_torch.models.lm import build_model, param_specs
    from repro_torch.models.module import init_params
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg, init_params(
        param_specs(cfg), torch.Generator().manual_seed(0)), device="cpu")
    r = np.random.default_rng(45)
    batch = {"tokens": torch.from_numpy(r.integers(0, 256, (2, 8))),
             "targets": torch.from_numpy(r.integers(0, 256, (2, 8))),
             "frames": torch.from_numpy(_normal(r, (2, 16, 64)))}
    one = float(model.loss(batch)[0])
    with use_rules(_Stand((1, n), ("data", "model")),
                   rules_for("train")) as ctx:
        assert abs(float(model.loss(batch)[0]) - one) <= PIECE_RTOL * one
        with ctx.manual_region(("data",)):
            assert stk.sp_split(cfg, 16).size == n
            assert (stk.sp_split(cfg, 18) is None) == (n == 4)
            assert (stk.sp_split(cfg, 6) is None) == (n == 4)


@pytest.mark.parametrize("rules,src,blocks", [
    ("serve", 16, 4), ("serve", 18, 1), ("serve_big", 16, 4),
    ("train", 16, 1)])
def test_torch_cross_cache_blocks(rules, src, blocks):
    """Under rules that map ``kv_seq`` to ``"model"`` (4 here) the cross
    K/V cache holds a block of the encoder positions a rank where the axis
    divides them, and stays whole where it does not (the guard), as under
    the training rules and off a mesh; ``kv_split(cache, cross=True)``
    refuses a cut cache outside the split, and a plain dict of the leaves
    or a ``Cache`` that lost ``cross_shards`` inside one."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding_rules as tsr
    from repro_torch.models import stack as stk
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              max_source_positions=src)
    rule_set = {"serve": tsr.SERVE_RULES, "serve_big": tsr.SERVE_RULES_BIG,
                "train": tsr.TRAIN_RULES}[rules]
    with tsr.use_rules(_Stand((1, 4), ("data", "model")), rule_set) as ctx:
        cache = stk.init_cache(cfg, 2, 12, device="cpu")
        assert cache.cross_shards == blocks
        assert cache["cross_k"].shape == (cfg.num_layers, 2, src // blocks,
                                          cfg.num_kv_heads, cfg.head_dim)
        if blocks > 1:
            with pytest.raises(ValueError, match="outside a kv_seq"):
                stk.kv_split(cache, cross=True)
            with ctx.manual_region(("data",)):
                assert stk.kv_split(cache, cross=True).size == 4
                with pytest.raises(ValueError, match="plain dict"):
                    stk.kv_split(dict(cache), cross=True)
                lost = stk.Cache(cache)
                lost.kv_shards = cache.kv_shards
                with pytest.raises(ValueError, match="kv_shards lost"):
                    stk.kv_split(lost, cross=True)
        else:
            assert stk.kv_split(cache, cross=True) is None
    assert stk.init_cache(cfg, 2, 12, device="cpu").cross_shards == 1


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("n,heads", [(2, (4, 4)), (4, (6, 2)), (3, (4, 1))])
def test_torch_cross_decode_partial_matches_jax(dtype, n, heads):
    """Decode over a cross K/V cache cut in n blocks of the encoder
    positions: each block through ``flash_attention_partial`` (on the CPU
    its plain twin), merged by ``ops.combine_partial``, gives ``repro``'s
    ``mha`` over the whole keys (non-causal, one query row); each block's
    lse is ``ref.mha_partial``'s.  A 16-position block is one tile and a
    ragged 20 is not.  In bf16 each block's out is rounded to bf16 (as the
    kernel stores it): held to that one rounding, 2^-8 of the largest
    entry; its lse is fp32 from the same inputs either way."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as tref
    H, K = heads
    T, D = 16 * n + 4, 16
    r = np.random.default_rng(7)
    q, k, v = (_normal(r, shape) for shape in
               ((2, 1, H, D), (2, T, K, D), (2, T, K, D)))
    dt = getattr(torch, dtype)
    tol = PIECE_RTOL if dtype == "float32" else 2 ** -8
    tq, tk, tv = (torch.from_numpy(x).to(dt) for x in (q, k, v))
    cuts = np.linspace(0, T, n + 1).astype(int)
    parts = [fa.flash_attention_partial(tq, tk[:, a:b], tv[:, a:b],
                                        causal=False)
             for a, b in zip(cuts[:-1], cuts[1:])]
    for (out, lse), a, b in zip(parts, cuts[:-1], cuts[1:]):
        want_out, want_lse = tref.mha_partial(tq, tk[:, a:b], tv[:, a:b],
                                              causal=False)
        assert out.dtype == lse.dtype == torch.float32
        assert lse.shape == (2, 1, H)
        torch.testing.assert_close(lse, want_lse, rtol=PIECE_RTOL,
                                   atol=PIECE_RTOL)
        torch.testing.assert_close(out, want_out, rtol=tol,
                                   atol=tol * float(want_out.abs().max()))
    got = ops.combine_partial(*parts[0], lambda _: torch.stack(
        [torch.cat([o, lse[..., None]], dim=-1) for o, lse in parts]))
    want = np.asarray(jref.mha(*(jnp.asarray(tx.float().numpy())
                                 for tx in (tq, tk, tv)), causal=False),
                      np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_torch_cross_decode_partial_routes_to_kernel(monkeypatch):
    """``ops.attention_partial`` sends a block that is not ragged (the
    cross K/V cache's) on a tensor off the CPU to the forward kernel's
    wrapper, ``flash_attention_partial``, and a ragged block (the self
    K/V cache's: positions, a valid length) to ``ref.mha_partial``; on
    the CPU both go to ``ref.mha_partial``."""
    import types

    from repro_torch.kernels import ops
    calls = []
    monkeypatch.setattr(ops, "_fa", types.SimpleNamespace(
        flash_attention_partial=lambda *a, **kw: calls.append(kw) or "k"))
    q = torch.empty((2, 1, 4, 16), device="meta")
    k = torch.empty((2, 8, 4, 16), device="meta")
    assert ops.attention_partial(q, k, k, causal=False) == "k"
    assert calls == [dict(causal=False, window=0, scale=None)]
    monkeypatch.setattr(ops._ref, "mha_partial",
                        lambda *a, **kw: calls.append("ref") or "r")
    pos = torch.zeros((2, 1), dtype=torch.long, device="meta")
    assert ops.attention_partial(q, k, k, q_pos=pos, kv_valid=pos[:, 0]) \
        == "r"
    cq, ck = torch.zeros((2, 1, 4, 16)), torch.zeros((2, 8, 4, 16))
    assert ops.attention_partial(cq, ck, ck, causal=False) == "r"
    assert calls[1:] == ["ref", "ref"]


# ---- the pieces -------------------------------------------------------------

@pytest.mark.parametrize("world", PIECE_WORLDS)
@pytest.mark.parametrize("case", list(CROSS))
def test_torch_cross_attention_split_matches_jax(ranks, case, world):
    """Cross-attention split by heads: each rank's queries over the
    encoder output projected with its kv heads' slice of ``wk`` / ``wv`` /
    ``bk`` / ``bv``, its rows of ``wo`` summed over the ranks.  The output
    on every rank, x's and the encoder output's gradients and every
    weight's (summed over the ranks) equal ``repro``'s unsharded
    ``attention(kv_x=)`` (``bk``'s, 0 in exact arithmetic, is held within
    2e-5 of ``bv``'s largest on both sides), with the decoder's tokens
    whole and as this rank's block (``seq_res``); 6 / 6 heads pad to (8,
    1) at model 4,
    rank 3 holding padding only and still issuing every collective."""
    workdir, refs, _ = ranks
    ref = refs["cross"][case]
    res = rank_results(workdir, "ve_pieces", f"1x{world}")
    for r in res:
        got = r["cross", case]
        _close(got["y"], ref["y"], what="y")
        _close(got["dx"], ref["dx"], what="dx")
        _close(got["denc"], ref["denc"], what="denc")
        _grads_close(got["grads"], ref["grads"])
        assert got["sp"] == (world if CROSS[case][2] else None)
        assert got["forward"] == res[0]["cross", case]["forward"]
    heads = [r["cross", case]["heads"] for r in res]
    if case == "whisper6" and world == 4:
        assert heads[0].plan == (8, 1) and heads[3].heads == ()
    else:
        assert all(len(h.heads) == h.count for h in heads)


@pytest.mark.parametrize("world", PIECE_WORLDS)
def test_torch_encoder_seq_split_matches_jax(ranks, world):
    """The encoder stack on the storage plan under ``seq_res``: every
    layer receives this rank's block of the 16 frames, the output gathered
    whole equals ``repro``'s ``encode``, and the gradient of every encoder
    leaf (gathered from the shards; the norms' scales and biases and the
    MLP's output bias, applied to the block, summed over the ranks)
    equals ``repro``'s."""
    workdir, refs, _ = ranks
    ref = refs["encoder"]
    for r in rank_results(workdir, "ve_pieces", f"1x{world}"):
        got = r["encoder"]
        assert got["sp"] == world
        assert got["residual"] == [(ENC_B, 16 // world, 64)]
        _close(got["y"], ref["y"], what="y")
        assert got["grads"].keys() == ref["grads"].keys()
        _grads_close(got["grads"], ref["grads"])
        assert set(got["partial"]) == {
            k for k in got["grads"] if ".ln" in k or k.endswith(".mlp.bo")
            or k.startswith("enc_norm.")}


# ---- the step ---------------------------------------------------------------

@pytest.mark.parametrize("tag,arch", [(t, r[0]) for t in STEP_MESHES
                                      for r in STEP_RUNS[t] if len(r) == 1])
def test_torch_encdec_axis_step_matches_jax(ranks, tag, arch):
    """One ``dp_manual`` step of reduced whisper on a state built on the
    storage plan, both stacks sequence-parallel where the model axis
    divides their length (the encoder's 18 frames stay whole at model 4):
    against ``repro``'s single-device step (parameters within 5e-3, loss
    within 2%, grad norm within 1%, every first moment's cosine), against
    the port's own world-1 step to the tight bounds, every leaf
    bit-equal across the model ranks, the bytes held equal to the
    shards', the collectives over "model" by kind as
    ``_model_collectives`` counts them and the gathers over "model" the
    unaligned kv leaves' at model 4; the model-axis sum covers exactly
    the leaves stored whole
    whose gradient differed across the model ranks before it (the
    layernorms' scales and biases on split token blocks, the MLP's output
    bias there)."""
    workdir, refs, _ = ranks
    run = (arch,)
    ref = refs["step"][arch]
    res = rank_results(workdir, "ve_step", tag)
    got = res[0][run]
    n = int(tag.split("x")[-1])
    R = int(tag.split("x")[0])
    src = 16 if arch == "whisper" else 18
    enc_sp = n if src % n == 0 else None
    assert got["path"] == "dp_manual" and got["sp"] == n
    assert got["enc_sp"] == enc_sp
    assert got["model_collectives"] == _model_collectives(bool(enc_sp))
    # at model 4 the 2 / 1 kv heads of 16 are unaligned over four ranks:
    # gathered at each attention call (2 encoder layers; 2 decoder layers'
    # self- and cross-attention, again in their recompute under "dots")
    assert got["model_gathers"] == ({} if n == 2 else {
        k: 2 + 2 * 2 * 2 for k in ("attn.wk", "attn.wv", "attn.bk",
                                   "attn.bv")})
    assert got["residual"] == {
        "encoder": [(B // R, src // (enc_sp or 1), 64)],
        "decoder": [(B // R, S // n, 64)]}
    worst = max(float(np.max(np.abs(got["params"][k] - v)))
                for k, v in ref["params"].items())
    assert worst < REF_PARAM_ATOL, worst
    assert abs(ref["loss"] - got["loss"]) < REF_LOSS_REL * ref["loss"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) < \
        REF_NORM_REL * ref["grad_norm"]
    # the key biases' first moments are rounding noise (their gradient is
    # 0 in exact arithmetic, _grads_close): held by size, the others by
    # cosine
    for k, v in ref["mu"].items():
        if k.endswith("bk"):
            bound = 1e-6 * float(np.max(np.abs(ref["mu"][k[:-2] + "bv"])))
            assert float(np.max(np.abs(got["mu"][k]))) <= bound, k
        elif np.any(v):
            assert _cosine(v, got["mu"][k]) >= REF_MU_COSINE, k
    one = rank_results(workdir, "ve_step", "1x1")[0][run]
    assert abs(got["loss"] - one["loss"]) <= \
        TIGHT_LOSS_REL * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= \
        TIGHT_NORM_REL * one["grad_norm"]
    for k, v in one["mu"].items():
        if k.endswith("bk"):
            continue
        assert float(np.max(np.abs(got["mu"][k] - v))) <= \
            TIGHT_MU_OF_MAX * float(np.max(np.abs(v))), k
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= TIGHT_COSINE, k
    assert one["partial"] == one["summed"] == one["differ"] == []
    for group in _model_groups(tag):
        for rank in group[1:]:
            other = res[rank][run]
            for k, v in res[group[0]][run]["params"].items():
                assert other["params"][k].tobytes() == v.tobytes(), (rank, k)
            assert other["loss"] == res[group[0]][run]["loss"]
    split = {k for k, dims in got["plan"].items()
             if any("model" in axes for axes in dims.values())}
    partial = set(got["partial"])
    residual = {k for k in got["params"]
                if k.split(".")[-2].startswith(("ln", "enc_norm",
                                                "final_norm"))
                or k.endswith(".mlp.bo")}
    if enc_sp is None:
        residual = {k for k in residual
                    if not k.startswith(("encoder.", "enc_norm."))}
    assert partial == residual
    for r in res:
        assert r[run]["held"] == r[run]["shards"]
        assert set(r[run]["summed"]) == partial
        assert set(r[run]["differ"]) - split == partial


def test_torch_encdec_axis_step_control_fails(ranks):
    """Cross-attention's per-rank outputs left unsummed (each rank's
    reduce-scatter a slice of its own partial output): the step moves
    away from the port's world-1 step past ten times the tight loss bound."""
    workdir, _, _ = ranks
    one = rank_results(workdir, "ve_step", "1x1")[0][("whisper",)]
    got = rank_results(workdir, "ve_step", "1x2")[0][("whisper",
                                                       "control")]
    assert abs(got["loss"] - one["loss"]) > 10 * TIGHT_LOSS_REL * \
        abs(one["loss"])
    assert min(_cosine(v, got["mu"][k]) for k, v in one["mu"].items()
               if np.any(v)) < TIGHT_COSINE


@pytest.mark.parametrize("src,dst", list(RESTORE_FROM.items()))
def test_torch_encdec_axis_checkpoint(ranks, src, dst):
    """A reduced whisper state saved on (data 2, model 2) writes the files
    and manifest a world-1 save writes; each restores on the other mesh,
    every leaf gathered back bit-equal to the bytes saved, the encoder's
    and the cross-attention's shards included."""
    workdir, _, _ = ranks
    step = workdir / f"ckve_{src}" / "step_00000001"
    assert sorted(os.listdir(step)) == ["arrays_p0.npz", "aux.json",
                                        "manifest.json"]
    other = workdir / f"ckve_{dst}" / "step_00000001"
    assert (step / "manifest.json").read_text() == \
        (other / "manifest.json").read_text()
    with np.load(step / "arrays_p0.npz") as saved:
        saved = {k: saved[k] for k in saved.files}
    assert any(k.startswith("0/encoder/") for k in saved)
    for r in rank_results(workdir, "ve_restore", dst):
        assert r["aux"]["mesh"] == src
        assert r["named"].keys() == saved.keys()
        for k, v in saved.items():
            assert r["named"][k].tobytes() == v.tobytes(), k
        if dst == "2x2":
            assert r["shapes"]["layers.0.cross.wq"] == (32, 32)


# ---- serving ----------------------------------------------------------------

@pytest.mark.parametrize("run", [r for r in SERVE_RUNS if len(r) == 1])
@pytest.mark.parametrize("tag", SERVE_MESHES)
def test_torch_encdec_axis_serve_matches_jax(ranks, tag, run):
    """Prefill and greedy decode through ``_serve_wrap`` under the serving
    rules with the frames cut with the rows, in fp32 against ``repro``'s
    single-device prefill and decode: every rank's logits within 1e-4 of
    the largest at every step and its greedy tokens equal; the cross K/V
    cache cut into blocks of 16 / n encoder positions, joined equal to
    ``repro``'s; the self K/V cut into blocks where n divides its slots
    (16) and whole where not (15)."""
    workdir, refs, inputs = ranks
    ref = refs["serve"][run[0]]
    c = inputs["ve_serve"][run[0]]
    n = int(tag.split("x")[-1])
    res = rank_results(workdir, "ve_serve", tag)
    groups = _model_groups(tag)
    rows = len(c["prompts"]) // len(groups)
    self_blocks = n if c["max_len"] % n == 0 else 1
    for i, group in enumerate(groups):
        sl = slice(i * rows, (i + 1) * rows)
        for rank in group:
            got = res[rank][run]
            assert np.isfinite(got["logits"]).all()
            _close(got["logits"], ref["logits"][sl], SERVE_OF_MAX, "logits")
            np.testing.assert_array_equal(got["logits"].argmax(-1),
                                          ref["tokens"][sl])
            assert got["cross_shards"] == n
            assert got["kv_shards"] == self_blocks
            assert got["cache"]["cross_k"].shape[2] == 16 // n
        for name, blocks in (("cross_k", n), ("cross_v", n),
                             ("k", self_blocks), ("v", self_blocks)):
            parts = [res[r][run]["cache"][name] for r in group]
            union = np.concatenate(parts, 2) if blocks > 1 else parts[0]
            w = ref["cache"][name][:, sl]
            assert union.shape == w.shape
            _close(union, w, SERVE_OF_MAX, name)


@pytest.mark.parametrize("tag", SERVE_MESHES)
def test_torch_encdec_axis_serve_unweighted_control(ranks, tag):
    """The cross cache's partial softmaxes combined with equal weights
    (``unweighted_combine``) over a self K/V cache the guard keeps whole:
    the logits leave ``repro``'s by more than 100x the bound."""
    workdir, refs, _ = ranks
    ref = refs["serve"]["whisper_guard"]
    res = rank_results(workdir, "ve_serve", tag)
    groups = _model_groups(tag)
    rows = len(ref["logits"]) // len(groups)
    got = res[0][("whisper_guard", "unweighted")]
    want = ref["logits"][:rows]
    err = float(np.max(np.abs(got["logits"] - want)))
    assert err > 100 * SERVE_OF_MAX * float(np.max(np.abs(want)))
