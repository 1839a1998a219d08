"""Model-axis storage in the port: each model rank holds only its shard of
every leaf the rules map to ``"model"`` (``sharding_rules.storage_dims``,
``dp_shard.ShardPlan.for_storage``, ``distributed/model_storage.py``),
with its AdamW moments, gradients and error feedback, against ``repro``.

The placement is held against ``repro``'s ``ShardingCtx.partition_spec``
on mesh-shaped stand-ins (``jax.sharding.AbstractMesh``) for every config
and rule set; the aligned / unaligned / whole rule as a pure function of
the config.  The multi-rank cases run gloo ranks on the CPU, each a
process of its own (``tests/_torch_tp_ranks.py``, spawned by
``_torch_support``), while the parent computes ``repro``'s single-device
references: the ``dp_manual`` step on a state built on the storage plan,
the vocabulary-parallel lookup, a checkpoint restored across model sizes
and ``_serve_wrap`` under ``SERVE_RULES_BIG``.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from _torch_support import join_ranks, rank_results, spawn_ranks

B, S = 8, 16
# reduced configs: qwen2 with 14 / 2 heads (plan (2, 8) at model 4: its
# attention leaves unaligned), qwen3 with 8 / 4 heads (qk-norm; every leaf
# aligned at model 2 and 4), granite with an odd vocabulary (its table
# whole under the guard) and the expert-parallel MoE
STORAGE_ARCHS = {"qwen2_h14": ("qwen2-0.5b", {"num_heads": 14}),
                 "qwen3": ("qwen3-1.7b", {"num_heads": 8, "num_kv_heads": 4}),
                 "granite_v257": ("granite-moe-3b-a800m",
                                  {"vocab_size": 257})}
# mesh tag -> batch shards R (pod x data)
STEP_MESHES = {"1x2": 1, "1x4": 1, "2x2": 2, "2x2x2": 4}
# (remat, compress) of each mesh's runs: each arch sees every pair
COMBOS = {"1x2": ("none", False), "1x4": ("dots", False),
          "2x2": ("none", True), "2x2x2": ("dots", True)}
STORAGE_RUNS = {
    **{t: [(a, *COMBOS[t], 1) for a in STORAGE_ARCHS] for t in STEP_MESHES},
    # the port's world-1 step over the same microbatches (whole storage);
    # its first run matches the (1, 4) run whose checkpoint is restored
    "1x1": [(a, *COMBOS["1x4"], 1) for a in STORAGE_ARCHS]
    + [(a, *COMBOS[t], r) for t, r in STEP_MESHES.items() if t != "1x4"
       for a in STORAGE_ARCHS]}
RESTORE_AT = ("1x1", "1x2", "2x2")
SERVE_MESHES = ("2x2", "2x2x2")
LOOKUP_WORLDS = (2, 4)
# against repro's single-device step: tests/test_dp_manual.py's bounds
REF_PARAM_ATOL, REF_LOSS_REL, REF_NORM_ATOL = 5e-3, 0.02, 5e-3
# against the port's world-1 step over the same microbatches, stored whole
# (the unaligned leaves' gradients are summed in bf16 by the reduce-scatter
# where the whole-storage step summed the bf16 gradient cast to fp32)
TIGHT_LOSS_REL = 1e-6
TIGHT_NORM_REL = 2e-4
TIGHT_MU_OF_MAX = 2 ** -7
TIGHT_COSINE = 1 - 1e-5
# with compression a gradient element within that rounding of an int8
# boundary lands one quantum (the stacked leaf's scale) apart: the first
# moment then differs by (1 - b1) quanta more
B1 = 0.9                        # AdamW's b1
# and the scale, the largest magnitude of the stacked leaf, carries that
# element's bf16 rounding (half an ulp, 2^-8 relative) into every
# dequantised value and so into the grad norm
COMPRESS_NORM_REL = TIGHT_NORM_REL + 2 ** -8
SERVE_ATOL = 0.05               # tests/test_dp_manual.py's serve bound
RULE_SETS = ("train", "serve", "serve_big")
SPEC_MESHES = {"1x2": ((1, 2), ("data", "model")),
               "1x4": ((1, 4), ("data", "model")),
               "1x8": ((1, 8), ("data", "model")),
               "2x2": ((2, 2), ("data", "model"))}


def _rules(which, package):
    mod = __import__(f"{package}.distributed.sharding_rules",
                     fromlist=["x"])
    return {"train": mod.TRAIN_RULES, "serve": mod.SERVE_RULES,
            "serve_big": mod.SERVE_RULES_BIG}[which]


def _jax_config(arch, overrides):
    from repro.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _cosine(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _model_groups(tag):
    """Global ranks of each model group, rank = batch shard * n + model."""
    n = int(tag.split("x")[-1])
    total = int(np.prod([int(d) for d in tag.split("x")]))
    return [list(range(i, i + n)) for i in range(0, total, n)]


class _Stand:
    """A mesh-shaped stand-in for the port's plan: axis sizes only."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


# ---- placement: no ranks ----------------------------------------------------

@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
def test_torch_storage_spec_matches_jax(mesh, rules):
    """Every leaf of every config is stored as ``repro``'s
    ``ShardingCtx.partition_spec`` (with the guard) places it on the mesh:
    the port's storage plan, per layer, equals the spec of ``repro``'s
    stacked leaf past its layers dim; the dims ``"model"`` shards are
    exactly ``sharding_rules.model_dims``."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import list_configs
    from repro.distributed.sharding_rules import ShardingCtx as JCtx
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding_rules import ShardingCtx, model_dims
    from repro_torch.train.train_step import param_plan
    shape, names = SPEC_MESHES[mesh]
    jctx = JCtx(AbstractMesh(shape, names), _rules(rules, "repro"))
    ctx = ShardingCtx(_Stand(shape, names), _rules(rules, "repro_torch"))
    checked = 0
    for arch in list_configs():
        cfg = get_config(arch)
        jmodel = jbuild(jget(arch))
        axes = _flat_axes(jmodel.logical_axes())
        shapes = {k: tuple(v.shape) for k, v in _flat_shapes(
            jmodel.abstract_params()).items()}
        plan = param_plan(cfg, ctx)
        for path, ax in axes.items():
            want = tuple(jctx.partition_spec(ax, shapes[path]))
            parts = path.split("/")
            stacked = parts[0] in ("layers", "encoder")
            name = ".".join(parts[:1] + ["0"] + parts[1:]) if stacked \
                else ".".join(parts)
            dims = plan.dims.get(name, {})
            got = [None] * len(ax)
            for d, m in dims.items():
                got[d + stacked] = m[0] if len(m) == 1 else tuple(m)
            while got and got[-1] is None:
                got.pop()
            assert tuple(got) == want, (arch, path, got, want)
            assert {d + stacked for d, m in dims.items() if "model" in m} \
                == {d + stacked for d in model_dims(
                    ctx, ax[stacked:], shapes[path][stacked:])}, \
                (arch, path)
            checked += 1
    assert checked > 150


def _flat_axes(tree, path=()):
    from repro.distributed.dp_shard import _is_axes_leaf
    if _is_axes_leaf(tree):
        return {"/".join(path): tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat_axes(v, path + (k,)))
    return out


def _flat_shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, path + (k,)))
        return out
    return {"/".join(path): tree}


@pytest.mark.parametrize("arch,n,want", [
    ("qwen2-0.5b", 4, {"attn": "unaligned", "mlp": "aligned",
                       "embed": "aligned"}),
    ("qwen3-1.7b", 4, {"attn": "aligned", "mlp": "aligned",
                       "embed": "aligned"}),
    ("granite-moe-3b-a800m", 2, {"attn": "aligned", "moe": "whole",
                                 "embed": "whole"})])
def test_torch_leaf_rules(arch, n, want):
    """The rule as a pure function of the config: uncut qwen2 at model 4
    gathers its attention leaves (224 columns are 3.5 heads, half a kv
    head) and uses its d_ff and vocabulary shards as they are; uncut qwen3
    at model 4 is aligned everywhere; granite at model 2 keeps its 40
    experts (no virtual layout) and its vocabulary of 49,155 whole."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ll
    rules = ll.leaf_rules(get_config(arch), n)
    assert rules and {k.split(".")[0] for k in rules} == set(want)
    for kind, r in rules.items():
        assert r == want[kind.split(".")[0]], (kind, r)


def test_torch_work_runs_cover():
    """Every rank's work ranges of a split leaf, over the ranks, cover its
    real rows exactly once (query heads, d_ff, virtual experts, the
    vocabulary) or each kv head by every rank whose groups use it."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ll
    for arch, n in (("qwen2-0.5b", 4), ("qwen3-1.7b", 4),
                    ("granite-moe-3b-a800m", 2), ("mixtral-8x22b", 4),
                    ("granite-moe-3b-a800m", 16)):
        cfg = get_config(arch)
        for kind in ll.leaf_rules(cfg, n):
            what = ll._MODEL_LEAVES[kind][0]
            runs = [r for k in range(n) for r in ll.work_runs(cfg, kind, n, k)]
            covered = sorted(i for a, b in runs for i in range(a, b))
            size = ll._model_size(cfg, what)
            if what in ("kv", "experts") and len(covered) > size:
                assert set(covered) == set(range(size)), (arch, kind)
            else:
                assert covered == list(range(size)), (arch, kind)


# ---- ranks ------------------------------------------------------------------

def _storage_inputs():
    from repro.models import build_model
    out = {}
    for name, (arch, ov) in STORAGE_ARCHS.items():
        cfg = _jax_config(arch, ov)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        r = np.random.default_rng(1)
        out[name] = dict(
            arch=arch, overrides=ov,
            tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
            batch={"tokens": r.integers(0, cfg.vocab_size, (B, S)),
                   "targets": r.integers(0, cfg.vocab_size, (B, S)),
                   "loss_mask": np.ones((B, S), np.float32)})
    return out


def _jax_step_ref(c, compress):
    from repro.distributed.grad_compress import init_error_feedback
    from repro.models import build_model
    from repro.train.optimizer import init_adamw
    from repro.train.train_step import (TrainState, TrainStepConfig,
                                        make_train_step)
    from repro_torch.models.convert import named_from_tree
    cfg = _jax_config(c["arch"], c["overrides"])
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(model, TrainStepConfig(
        remat_policy="dots", microbatches=1, compress_grads=compress)))
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in c["batch"].items()}
    err = init_error_feedback(params) if compress else None
    state, metrics = step(TrainState(params, init_adamw(params), err), batch)
    named = lambda t: named_from_tree(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), cfg.num_layers)
    return dict(params=named(state.params), mu=named(state.opt.mu),
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def _jax_lookup(c):
    from repro.models import layers as jl
    cfg = _jax_config("qwen2-0.5b", {})
    y, vjp = jax.vjp(lambda t: jl.embed({"tokens": t}, cfg,
                                        jnp.asarray(c["tokens"])),
                     jnp.asarray(c["table"]))
    (dt,) = vjp(jnp.asarray(c["cot"]).astype(y.dtype))
    return dict(y=np.asarray(y, np.float32), dtable=np.asarray(dt))


def _jax_serve(c):
    from repro.models import build_model
    cfg = _jax_config(c["arch"], {})
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = jnp.asarray(c["tokens"].astype(np.int32))
    logits, cache = jax.jit(model.prefill)(params, {"tokens": tokens},
                                           model.init_cache(B, S + 4))
    dec, _ = jax.jit(model.decode_step)(params, cache, tokens[:, :1],
                                        jnp.full((B,), S, jnp.int32))
    return dict(prefill=np.asarray(logits, np.float32),
                decode=np.asarray(dec, np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    workdir = tmp_path_factory.mktemp("storage_ranks")
    r = np.random.default_rng(15)
    archs = _storage_inputs()
    tokens = r.integers(0, 256, (2, S))
    tokens[0, :4] = tokens[1, :4]                 # repeated ids
    inputs = dict(
        storage_archs=archs, storage_runs=STORAGE_RUNS,
        step_config=TrainStepConfig(dp_manual=True, optimizer=AdamWConfig(
            b1=B1)),
        lookup=dict(table=(r.standard_normal((256, 64)) * 0.5).astype(
            np.float32), tokens=tokens,
            cot=r.standard_normal((2, S, 64)).astype(np.float32)),
        serve=dict(arch="granite-moe-3b-a800m",
                   tree=_flat(jax.tree_util.tree_map(
                       np.asarray, _granite_params())),
                   tokens=np.random.default_rng(0).integers(0, 256, (B, S))))
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jobs = {"1x2": ["storage_step", "lookup"],
            "1x4": ["storage_step", "lookup"],
            "2x2": ["storage_step", "serve_big"],
            "2x2x2": ["storage_step", "serve_big"],
            "1x1": ["storage_step"]}
    procs = {t: spawn_ranks(workdir, t, j, module="_torch_tp_ranks")
             for t, j in jobs.items()}
    try:
        refs = dict(
            step={(k, c): _jax_step_ref(a, c) for k, a in archs.items()
                  for c in (False, True)},
            lookup=_jax_lookup(inputs["lookup"]),
            serve=_jax_serve(inputs["serve"]))
    finally:
        for t in jobs:
            join_ranks(procs[t])
    second = {t: spawn_ranks(workdir, t, ["storage_restore"],
                             module="_torch_tp_ranks") for t in RESTORE_AT}
    for t in second:
        join_ranks(second[t])
    return workdir, refs, inputs


def _granite_params():
    from repro.models import build_model
    return build_model(_jax_config("granite-moe-3b-a800m", {})).init(
        jax.random.PRNGKey(0))


def _spec_numel(shape, dims, sizes):
    n = 1
    for i, s in enumerate(shape):
        count = 1
        for a in dims.get(i, ()):
            count *= sizes[a]
        n *= s // count
    return n


@pytest.mark.parametrize("arch", list(STORAGE_ARCHS))
@pytest.mark.parametrize("tag", list(STEP_MESHES))
def test_torch_storage_step(ranks, tag, arch):
    """One ``dp_manual`` step on a state built on the storage plan (remat
    and compression as ``COMBOS`` gives the mesh): against ``repro``'s
    single-device step with ``tests/test_dp_manual.py``'s tolerances, and
    against the port's world-1 step over the same microbatches (whole
    storage) to the tight bounds, with compression the first moments to
    them plus (1 - b1) int8 quanta; each rank holds exactly its shards'
    bytes (parameters, both moments, the error feedback), no model-mapped
    leaf at its whole shape; the gathers over ``"model"`` are the
    unaligned leaves', one a layer; every leaf gathered from the shards
    bit-equal across the model ranks; the model-axis sum covers exactly
    the leaves stored whole and used in part."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as ll
    from repro_torch.train.train_step import stacked_name
    workdir, refs, inputs = ranks
    remat, compress = COMBOS[tag]
    run = (arch, remat, compress, 1)
    res = rank_results(workdir, "storage_step", tag)
    got = res[0][run]
    assert got["path"] == "dp_manual"
    ref = refs["step"][arch, compress]
    worst = max(float(np.max(np.abs(got["params"][k] - v)))
                for k, v in ref["params"].items())
    assert worst < REF_PARAM_ATOL, worst
    assert abs(ref["loss"] - got["loss"]) < REF_LOSS_REL * ref["loss"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) < REF_NORM_ATOL
    one = rank_results(workdir, "storage_step", "1x1")[0][
        arch, remat, compress, STEP_MESHES[tag]]
    assert abs(got["loss"] - one["loss"]) <= \
        TIGHT_LOSS_REL * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= \
        (COMPRESS_NORM_REL if compress else TIGHT_NORM_REL) \
        * one["grad_norm"]
    for k, v in one["mu"].items():
        if compress:
            # the tight bound plus one int8 quantum of the stacked leaf's
            # scale, (1 - b1) of it in mu: 1/127 of its largest mu
            stacked = [n for n in one["mu"]
                       if stacked_name(n) == stacked_name(k)]
            amax = max(float(np.max(np.abs(one["mu"][n]))) for n in stacked)
            assert float(np.max(np.abs(got["mu"][k] - v))) <= amax / 127 \
                + TIGHT_MU_OF_MAX * float(np.max(np.abs(v))), k
            continue
        assert float(np.max(np.abs(got["mu"][k] - v))) <= \
            TIGHT_MU_OF_MAX * float(np.max(np.abs(v))), k
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= TIGHT_COSINE, k
    # storage: the plan's shards and nothing else
    mesh_sizes = dict(zip(
        ("pod", "data", "model") if tag == "2x2x2" else ("data", "model"),
        [int(d) for d in tag.split("x")]))
    leaves = 3 + compress
    for r in res:
        row = r[run]
        want = sum(_spec_numel(v.shape, got["plan"].get(k, {}), mesh_sizes)
                   for k, v in got["params"].items()) * 4 * leaves
        assert row["held"] == want, (row["held"], want)
        for k, dims in got["plan"].items():
            if any("model" in a for a in dims.values()):
                assert row["shapes"][k] != got["params"][k].shape, k
        if compress:
            assert row["err_shapes"] == row["shapes"]
    c = inputs["storage_archs"][arch]
    cfg = dataclasses.replace(reduced(get_config(c["arch"])),
                              **c["overrides"])
    n = mesh_sizes["model"]
    unaligned = sorted(k for k, v in ll.leaf_rules(cfg, n).items()
                       if v == "unaligned")
    # remat "dots" runs each layer's forward again in the backward
    again = 2 if remat == "dots" else 1
    assert got["model_gathers"] == {k: again * cfg.num_layers
                                    for k in unaligned}
    for group in _model_groups(tag):
        for rank in group[1:]:
            other = res[rank][run]
            for k, v in res[group[0]][run]["params"].items():
                assert other["params"][k].tobytes() == v.tobytes(), (rank, k)
            assert other["loss"] == res[group[0]][run]["loss"]
    split = {k for k, dims in got["plan"].items()
             if any("model" in a for a in dims.values())}
    # S divides every model axis here: the residual stream's tokens are
    # split over the model ranks (stack.sp_split), so the norms' scales and
    # the expert-parallel router are used in part too
    partial = {k for k in got["params"] if k not in split and (
        k.split(".")[-2] in ("attn", "moe", "ln1", "ln2", "final_norm")
        or k == "embed.tokens")}
    assert set(got["partial"]) == partial
    assert got["moved"] == {"direct": sum(got["collectives"].values())
                            + sum(got["model_collectives"].values())}


@pytest.mark.parametrize("world", LOOKUP_WORLDS)
def test_torch_vocab_parallel_lookup(ranks, world):
    """A table stored split over the vocabulary is looked up
    vocabulary-parallel (each rank its rows, zeros elsewhere, one sum over
    the ranks): the output equal to ``repro``'s ``embed`` and to the whole
    table's lookup bit for bit, the table's gradient gathered from the
    shards equal to ``repro``'s (repeated ids summed in bf16: one
    rounding of the largest row apart at most)."""
    workdir, refs, _ = ranks
    ref = refs["lookup"]
    for r in rank_results(workdir, "lookup", f"1x{world}"):
        assert r["shard_rows"] == 256 // world
        assert r["collectives"] == {"all_reduce": 1}
        np.testing.assert_array_equal(r["y"], ref["y"])
        np.testing.assert_array_equal(r["y"], r["whole"])
        scale = float(np.max(np.abs(ref["dtable"])))
        assert float(np.max(np.abs(r["dtable"] - ref["dtable"]))) \
            <= 2 ** -8 * scale


@pytest.mark.parametrize("dst", RESTORE_AT)
def test_torch_storage_checkpoint(ranks, dst):
    """A state saved on (data 1, model 4) writes the files and manifest a
    world-1 save of the same run writes; it restores at world 1, (1, 2)
    and (2, 2) with every leaf gathered back bit-equal to the bytes
    saved."""
    import os
    workdir, _, _ = ranks
    step = workdir / "cks_1x4" / "step_00000001"
    assert sorted(os.listdir(step)) == ["arrays_p0.npz", "aux.json",
                                        "manifest.json"]
    assert (step / "manifest.json").read_text() == \
        (workdir / "cks_1x1" / "step_00000001" / "manifest.json").read_text()
    with np.load(step / "arrays_p0.npz") as saved:
        saved = {k: saved[k] for k in saved.files}
    for r in rank_results(workdir, "storage_restore", dst):
        assert r["aux"]["mesh"] == "1x4"
        assert r["named"].keys() == saved.keys()
        for k, v in saved.items():
            assert r["named"][k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("tag", SERVE_MESHES)
def test_torch_serve_wrap_big_rules(ranks, tag):
    """Reduced granite served through ``_serve_wrap`` under
    ``SERVE_RULES_BIG``, its bf16 weights stored as the plan's shards (the
    embed dim over ``"data"``, gathered per layer; heads, virtual experts
    and vocabulary over ``"model"``): each rank's prefill and decode
    logits within ``tests/test_dp_manual.py``'s 0.05 of ``repro``'s
    single-device logits for its rows, equal across the model ranks."""
    workdir, refs, _ = ranks
    ref = refs["serve"]
    res = rank_results(workdir, "serve_big", tag)
    groups = _model_groups(tag)
    n = B // len(groups)
    plan = res[0]["plan"]
    assert plan["layers.0.attn.wq"] == {0: ("data",), 1: ("model",)}
    assert plan["layers.0.moe.wi"] == {0: ("model",), 1: ("data",)}
    assert res[0]["shapes"]["layers.0.attn.wq"] == (32, 32)
    for i, group in enumerate(groups):
        rows = slice(i * n, (i + 1) * n)
        for rank in group:
            for k in ("prefill", "decode"):
                d = float(np.max(np.abs(res[rank][k] - ref[k][rows])))
                assert d < SERVE_ATOL, (rank, k, d)
                np.testing.assert_array_equal(res[rank][k],
                                              res[group[0]][k])
