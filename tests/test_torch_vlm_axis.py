"""The vlm family (phi-3-vision) under the port's model axis, against
``repro``'s single-device results: the ``dp_manual`` step of reduced
phi-3-vision on (data, model) meshes with the storage plan (attention
split by heads, the MLP by d_ff, the vocabulary-parallel lookup before the
projected patches are prepended, the residual stream whole: no
``seq_res`` behind a prefix), and serving through
``launch/dryrun._serve_wrap`` under the serving rules, the patches cut
with the rows and the K/V cache cut on ``kv_seq``.

The multi-rank cases run gloo ranks on the CPU, each a process of its own
(``tests/_torch_tp_ranks.py``, jobs ``ve_step`` and ``ve_serve``, spawned
by ``_torch_support``), joined through a ``FileStore`` under the test's
temporary directory; one module fixture starts every rank at once and
computes the JAX references while they run.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import join_ranks, rank_results, spawn_ranks

ARCH = "phi-3-vision-4.2b"
# reduced phi-3-vision: 4 / 2 heads of 16, 4 patches of 32, vocab 256
B, S = 8, 16
STEP_MESHES = ("1x2", "1x4", "2x2")
STEP_RUNS = {"1x2": [("phi3v",), ("phi3v", "control")],
             "1x4": [("phi3v",)], "2x2": [("phi3v",)], "1x1": [("phi3v",)]}
# serving: (rows, prompt length, steps, max_len): 4 patches + 12 text
# positions, 16 slots cut into blocks at model 2 and 4
SERVE = {"phi3v": (4, 6, 5, 12)}
SERVE_MESHES = ("1x2", "1x4", "2x2")
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
PIECE_RTOL = 2e-5
# serving in fp32 against repro: logits within 1e-4 of the largest
SERVE_OF_MAX = 1e-4


def _jax_config():
    from repro.configs.base import get_config, reduced
    return reduced(get_config(ARCH))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _normal(r, shape):
    return r.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol, what=""):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= rtol * scale, (what, err, scale)


def _cosine(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _model_groups(tag):
    """Global ranks of each model group, rank = batch shard * n + model."""
    n = int(tag.split("x")[-1])
    total = int(np.prod([int(d) for d in tag.split("x")]))
    return [list(range(i, i + n)) for i in range(0, total, n)]


class _Stand:
    """A mesh-shaped stand-in: axis sizes, and rank 0 of every axis."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


# ---- inputs and references --------------------------------------------------

def _step_inputs():
    from repro.models import build_model
    cfg = _jax_config()
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    r = np.random.default_rng(51)
    return {"phi3v": dict(
        arch=ARCH, overrides={},
        tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
        batch={"tokens": r.integers(0, cfg.vocab_size, (B, S)),
               "targets": r.integers(0, cfg.vocab_size, (B, S)),
               "loss_mask": np.ones((B, S), np.float32),
               "patch_embeds": _normal(r, (B, cfg.num_patches,
                                           cfg.patch_embed_dim))})}


def _serve_inputs():
    from repro.models import build_model
    cfg = _jax_config()
    params = build_model(cfg).init(jax.random.PRNGKey(1))
    out = {}
    for name, (rows, prompt, steps, max_len) in SERVE.items():
        r = np.random.default_rng(52)
        out[name] = dict(
            arch=ARCH, overrides={}, steps=steps, max_len=max_len,
            tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
            prompts=r.integers(0, cfg.vocab_size, (rows, prompt)),
            extra={"patch_embeds": _normal(r, (rows, cfg.num_patches,
                                               cfg.patch_embed_dim))})
    return out


def _jax_step(c):
    """``tests/test_dp_manual.py``'s single-device step, microbatches 1."""
    from repro.models import build_model
    from repro.train.optimizer import init_adamw
    from repro.train.train_step import (TrainState, TrainStepConfig,
                                        make_train_step)
    from repro_torch.models.convert import named_from_tree
    cfg = _jax_config()
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(
        model, TrainStepConfig(remat_policy="dots", microbatches=1)))
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in c["batch"].items()}
    state, metrics = step(TrainState(params, init_adamw(params), None),
                          batch)
    named = lambda t: named_from_tree(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), cfg.num_layers)
    return dict(params=named(state.params), mu=named(state.opt.mu),
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def _jax_greedy(c):
    """``repro``'s single-device prefill (with the patches) and greedy
    decode in fp32 over an fp32 K/V cache: the logits of every step, the
    greedy tokens and the cache."""
    from repro.models import build_model
    model = build_model(_jax_config())
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
    workdir = tmp_path_factory.mktemp("vlm_ranks")
    inputs = dict(
        ve_archs=_step_inputs(), ve_step_runs=STEP_RUNS,
        ve_serve=_serve_inputs(),
        ve_serve_runs={t: [(k,) for k in SERVE] for t in SERVE_MESHES},
        step_config=TrainStepConfig(remat_policy="dots", dp_manual=True,
                                    optimizer=AdamWConfig()))
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jobs = {"1x2": ["ve_step", "ve_serve"], "1x4": ["ve_step", "ve_serve"],
            "2x2": ["ve_step", "ve_serve"], "1x1": ["ve_step"]}
    procs = {t: spawn_ranks(workdir, t, j, module="_torch_tp_ranks")
             for t, j in jobs.items()}
    try:
        refs = dict(step=_jax_step(inputs["ve_archs"]["phi3v"]),
                    serve={k: _jax_greedy(c)
                           for k, c in inputs["ve_serve"].items()})
    finally:
        for t in jobs:
            join_ranks(procs[t])
    return workdir, refs, inputs


# ---- no ranks ---------------------------------------------------------------

@pytest.mark.parametrize("rules", ("train", "serve", "serve_big"))
@pytest.mark.parametrize("mesh", ((1, 2), (1, 4), (2, 2)))
def test_torch_vlm_storage_spec_matches_jax(mesh, rules):
    """Every leaf of phi-3-vision-4.2b (the patch projection included) is
    stored as ``repro``'s ``ShardingCtx.partition_spec`` places it on the
    (data, model) mesh under TRAIN_RULES, SERVE_RULES and
    SERVE_RULES_BIG: the port's storage plan, per layer, equals the spec
    of ``repro``'s stacked leaf past its layers dim; ``patch_proj`` is
    never stored split over ``"model"``."""
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
    for path, ax in axes:
        parts = [k.key for k in path]
        want = tuple(jctx.partition_spec(ax, shapes[path].shape))
        stacked = parts[0] == "layers"
        name = ".".join(parts[:1] + ["0"] + parts[1:]) if stacked \
            else ".".join(parts)
        got = [None] * len(ax)
        for d, m in plan.dims.get(name, {}).items():
            got[d + stacked] = m[0] if len(m) == 1 else tuple(m)
        while got and got[-1] is None:
            got.pop()
        assert tuple(got) == want, (path, got, want)
    assert len(axes) == len(shapes) > 10
    for k in ("patch_proj.w", "patch_proj.b"):
        assert not any("model" in m for m in plan.dims.get(k, {}).values())


@pytest.mark.parametrize("n", (2, 4))
def test_torch_model_axis_covers_vlm(n):
    """Under a model axis of ``n`` reduced phi-3-vision's loss with its
    patches outside the manual region (every rank computes whole) equals
    its loss off a mesh, and inside it ``stack.sp_split`` keeps the
    residual stream whole (the patches in front of the text), as
    ``repro``'s ``run_stack`` does."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import stack as stk
    from repro_torch.models.lm import build_model, param_specs
    from repro_torch.models.module import init_params
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg, init_params(
        param_specs(cfg), torch.Generator().manual_seed(0)), device="cpu")
    r = np.random.default_rng(53)
    batch = {"tokens": torch.from_numpy(r.integers(0, 256, (2, 8))),
             "targets": torch.from_numpy(r.integers(0, 256, (2, 8))),
             "patch_embeds": torch.from_numpy(_normal(r, (2, 4, 32)))}
    one = float(model.loss(batch)[0])
    with use_rules(_Stand((1, n), ("data", "model")),
                   rules_for("train")) as ctx:
        assert abs(float(model.loss(batch)[0]) - one) <= PIECE_RTOL * one
        with ctx.manual_region(("data",)):
            assert stk.sp_split(cfg, 16) is None
            stk.check_model_axis(cfg)


# ---- the step ---------------------------------------------------------------

@pytest.mark.parametrize("tag", STEP_MESHES)
def test_torch_vlm_axis_step_matches_jax(ranks, tag):
    """One ``dp_manual`` step of reduced phi-3-vision with its patches on
    a state built on the storage plan: against ``repro``'s single-device
    step (parameters within 5e-3, loss within 2%, grad norm within 1%,
    every first moment's cosine), against the port's own world-1 step to
    the tight bounds, every layer fed the whole residual (patches and
    text: no ``seq_res``), every leaf bit-equal across the model ranks,
    the bytes held equal to the shards'.  No leaf is stored whole and
    used in part at these widths (every split leaf is stored split), so
    the model-axis sum covers none, and no leaf stored whole, the patch
    projection included (used whole on replicated inputs), has a
    gradient that differs across the model ranks."""
    workdir, refs, _ = ranks
    ref = refs["step"]
    res = rank_results(workdir, "ve_step", tag)
    run = ("phi3v",)
    got = res[0][run]
    R = int(tag.split("x")[0])
    assert got["path"] == "dp_manual" and got["sp"] is None
    # per layer attention and the MLP, an all-reduce of the input's
    # gradient and of the output each, and attention's output again in
    # the recompute under remat "dots" (which stops before the MLP's);
    # the lookup's sum; the cross-entropy's gradient sum, two sums and a
    # max
    assert got["model_collectives"] == {"all_reduce": 5 * 2 + 1 + 3,
                                        "all_reduce_max": 1}
    assert got["residual"] == {"decoder": [(B // R, S + 4, 64)]}
    worst = max(float(np.max(np.abs(got["params"][k] - v)))
                for k, v in ref["params"].items())
    assert worst < REF_PARAM_ATOL, worst
    assert abs(ref["loss"] - got["loss"]) < REF_LOSS_REL * ref["loss"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) < \
        REF_NORM_REL * ref["grad_norm"]
    for k, v in ref["mu"].items():
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= REF_MU_COSINE, k
    one = rank_results(workdir, "ve_step", "1x1")[0][run]
    assert abs(got["loss"] - one["loss"]) <= \
        TIGHT_LOSS_REL * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= \
        TIGHT_NORM_REL * one["grad_norm"]
    for k, v in one["mu"].items():
        assert float(np.max(np.abs(got["mu"][k] - v))) <= \
            TIGHT_MU_OF_MAX * float(np.max(np.abs(v))), k
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= TIGHT_COSINE, k
    for group in _model_groups(tag):
        for rank in group[1:]:
            other = res[rank][run]
            for k, v in res[group[0]][run]["params"].items():
                assert other["params"][k].tobytes() == v.tobytes(), (rank, k)
            assert other["loss"] == res[group[0]][run]["loss"]
    split = {k for k, dims in got["plan"].items()
             if any("model" in axes for axes in dims.values())}
    assert "patch_proj.w" not in split and "embed.tokens" in split
    for r in res:
        assert r[run]["held"] == r[run]["shards"]
        assert r[run]["partial"] == r[run]["summed"] == []
        assert set(r[run]["differ"]) <= split


def test_torch_vlm_axis_step_control_fails(ranks):
    """The vocabulary-parallel lookup without its sum (each rank's
    embeddings zero outside its rows): the step moves away from the
    port's world-1 step past ten times the tight loss bound."""
    workdir, _, _ = ranks
    one = rank_results(workdir, "ve_step", "1x1")[0][("phi3v",)]
    got = rank_results(workdir, "ve_step", "1x2")[0][("phi3v", "control")]
    assert abs(got["loss"] - one["loss"]) > 10 * TIGHT_LOSS_REL * \
        abs(one["loss"])
    assert min(_cosine(v, got["mu"][k]) for k, v in one["mu"].items()
               if np.any(v)) < TIGHT_COSINE


# ---- serving ----------------------------------------------------------------

@pytest.mark.parametrize("tag", SERVE_MESHES)
def test_torch_vlm_axis_serve_matches_jax(ranks, tag):
    """Prefill with the patches (cut with the rows) and greedy decode
    through ``_serve_wrap`` under the serving rules, in fp32 against
    ``repro``'s single-device prefill and decode: every rank's logits
    within 1e-4 of the largest at every step and its greedy tokens equal;
    the K/V cache of 4 patches + 12 text positions cut into blocks of
    16 / n slots, joined equal to ``repro``'s."""
    workdir, refs, inputs = ranks
    ref = refs["serve"]["phi3v"]
    c = inputs["ve_serve"]["phi3v"]
    n = int(tag.split("x")[-1])
    res = rank_results(workdir, "ve_serve", tag)
    groups = _model_groups(tag)
    rows = len(c["prompts"]) // len(groups)
    for i, group in enumerate(groups):
        sl = slice(i * rows, (i + 1) * rows)
        for rank in group:
            got = res[rank][("phi3v",)]
            assert np.isfinite(got["logits"]).all()
            _close(got["logits"], ref["logits"][sl], SERVE_OF_MAX, "logits")
            np.testing.assert_array_equal(got["logits"].argmax(-1),
                                          ref["tokens"][sl])
            assert got["kv_shards"] == n
        for name in ("k", "v"):
            union = np.concatenate([res[r][("phi3v",)]["cache"][name]
                                    for r in group], 2)
            w = ref["cache"][name][:, sl]
            assert union.shape == w.shape
            _close(union, w, SERVE_OF_MAX, name)
