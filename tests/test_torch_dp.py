"""The port's data-parallel half (``repro_torch.distributed``,
``launch/mesh.py``, the ``dp_manual`` step, ``compressed_psum``, the
multi-rank ``put_global_batch`` and the resharded restore) against
``repro`` and against itself at other world sizes.

The multi-rank cases run gloo ranks on the CPU, each in a process of its
own (``tests/_torch_dp_ranks.py``, spawned by ``_torch_support``), joined
through a ``FileStore`` under the test's temporary directory; every wait
on them has its own timeout.  One module fixture starts every rank of the
first round (worlds 1, 2, 4 and 8) at once and computes the JAX references
while they run; a second round restores the checkpoints the first wrote.

``repro``'s sharded step cannot be run here (``tests/test_dp_manual.py``
fails while tracing on every mesh), so the port's step at world R is held
against ``repro``'s single-device step with that test's tolerances, and
against its own world-1 step to a tight bound.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_support import join_ranks, rank_results, spawn_ranks

ARCHS = ("qwen2-0.5b", "mamba2-780m", "granite-moe-3b-a800m")
B, S = 16, 32
WORLDS = (2, 4)
MICROBATCHES = 2
# world 1 runs the whole batch (held against repro) and each world's
# microbatch partition: R ranks of MICROBATCHES are R * MICROBATCHES
# microbatches of the same rows
DP_RUNS = {1: [(a, mb) for a in ARCHS
               for mb in (1,) + tuple(w * MICROBATCHES for w in WORLDS)],
           **{w: [(a, MICROBATCHES) for a in ARCHS] for w in WORLDS}}
PSUM_WORLDS = (2, 4, 8)
PSUM_SHAPES = ((64,), (8, 48), (3, 5, 7))
# restore at a world the checkpoint was not written at, both ways
RESTORE_FROM = {1: [2], 4: [2], 2: [1, 4]}
PUT_BATCH = (64, 16, 100, 8)          # items, seq len, vocab, global batch
# the port's world-R step against its own world-1 step over the same
# microbatches: the gradients (AdamW's first moment) differ only by the
# bf16 reduce-scatter's sum over the ranks, within two bf16 roundings of a
# leaf's largest entry.  Measured on this CPU over the three archs at
# worlds 2 and 4: loss 1.8e-7 relative, grad norm 6.5e-5 relative, every
# leaf within 3.7e-3 of its largest entry and at a cosine 1 - 1.9e-6
TIGHT_LOSS_REL = 1e-6
TIGHT_NORM_REL = 2e-4
TIGHT_MU_OF_MAX = 2 ** -7
TIGHT_COSINE = 1 - 1e-5


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _named(tree, cfg):
    from repro_torch.models.convert import named_from_tree
    return named_from_tree(jax.tree_util.tree_map(np.asarray, tree),
                           cfg.num_layers, cfg.encoder_layers)


def _jax_reference(arch):
    """``tests/test_dp_manual.py``'s single-device step, microbatches 1
    (the port's step reports the mean over its microbatches, and with an
    all-ones mask and equal microbatches the whole batch has the same
    loss and gradient as that mean)."""
    from repro.configs.base import get_config, reduced
    from repro.models import build_model
    from repro.train.optimizer import init_adamw
    from repro.train.train_step import (TrainState, TrainStepConfig,
                                        make_train_step)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": r.integers(0, cfg.vocab_size,
                                   (B, S)).astype(np.int32),
             "loss_mask": np.ones((B, S), np.float32)}
    step = jax.jit(make_train_step(
        model, TrainStepConfig(remat_policy="dots", microbatches=1)))
    state, metrics = step(TrainState(params, init_adamw(params), None),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg=cfg, tree=_flat(jax.tree_util.tree_map(np.asarray,
                                                          params)),
                batch={k: v.astype(np.int64) if v.dtype == np.int32 else v
                       for k, v in batch.items()},
                params=_named(state.params, cfg), mu=_named(state.opt.mu, cfg),
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def _psum_inputs():
    """{world: [per shape (world, 2 steps, *shape) gradients]}."""
    r = np.random.default_rng(7)
    return {w: [r.standard_normal((w, 2) + s).astype(np.float32)
                * r.uniform(0.1, 3.0, (w, 2) + (1,) * len(s)).astype(
                    np.float32)
                for s in PSUM_SHAPES] for w in PSUM_WORLDS}


def _gather_inputs():
    r = np.random.default_rng(3)
    out = {}
    for name, shape, dim in (("dim0", (8, 6), 0), ("dim1", (6, 8), 1)):
        out[name] = (r.standard_normal(shape).astype(np.float32), dim,
                     r.standard_normal((2,) + shape).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    workdir = tmp_path_factory.mktemp("dp_ranks")
    # the parameters and batches first, so the ranks start at once
    from repro.configs.base import get_config, reduced
    from repro.models import build_model
    trees, batches = {}, {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        trees[arch] = _flat(jax.tree_util.tree_map(np.asarray, params))
        r = np.random.default_rng(0)
        batches[arch] = {
            "tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int64),
            "targets": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int64),
            "loss_mask": np.ones((B, S), np.float32)}
    leaves = np.random.default_rng(5)
    inputs = dict(
        dp_runs=DP_RUNS, trees=trees, batches=batches,
        dp_step_config=TrainStepConfig(remat_policy="dots",
                                       microbatches=MICROBATCHES,
                                       dp_manual=True,
                                       optimizer=AdamWConfig()),
        psum_grads=_psum_inputs(), gather=_gather_inputs(),
        leaves={"w": leaves.standard_normal((8, 6)).astype(np.float32),
                "s": leaves.standard_normal((8,)).astype(np.float32)},
        put_batch=PUT_BATCH, restore_from=RESTORE_FROM)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jobs = {1: ["dp_step", "put_batch"],
            2: ["dp_step", "gather", "compressed_psum", "put_batch"],
            4: ["dp_step", "compressed_psum", "put_batch"],
            8: ["compressed_psum"]}
    procs = {w: spawn_ranks(workdir, w, j) for w, j in jobs.items()}
    try:
        refs = {arch: _jax_reference(arch) for arch in ARCHS}
        for arch in ARCHS:
            for k, v in batches[arch].items():
                np.testing.assert_array_equal(refs[arch]["batch"][k], v)
            assert refs[arch]["tree"].keys() == trees[arch].keys()
    finally:
        for w in jobs:
            join_ranks(procs[w])
    second = {w: spawn_ranks(workdir, w, ["restore"]) for w in RESTORE_FROM}
    for w in second:
        join_ranks(second[w])
    return workdir, refs, inputs


# ---- (a) the rules, with no devices ----------------------------------------

def _jax_trees(arch):
    from repro.configs.base import get_config
    from repro.models import build_model
    model = build_model(get_config(arch))
    return model.logical_axes(), model.abstract_params()


def _walk(axes_tree, other, path=()):
    """{path: (logical axes, the other tree's leaf)}."""
    if isinstance(axes_tree, tuple):
        return {"/".join(path): (axes_tree, other)}
    out = {}
    for k in axes_tree:
        out.update(_walk(axes_tree[k], other[k], path + (k,)))
    return out


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_torch_sharding_rules_match_jax(shape):
    """Every rule set, and for every config's parameters the partition
    spec of each leaf (and its dropped axes), ``rule_manual_dims``,
    ``param_manual_specs`` and ``validate_manual_divisibility``, equal
    ``repro``'s on an abstract mesh."""
    from repro.configs.base import list_configs
    from repro.distributed import dp_shard as jdp
    from repro.distributed import sharding_rules as jsr
    from repro_torch.configs import get_config
    from repro_torch.distributed import dp_shard as pdp
    from repro_torch.distributed import sharding_rules as psr
    from repro_torch.models.lm import param_specs
    from repro_torch.models.module import map_specs
    names = ("pod", "data", "model")[-len(shape):]
    mesh = AbstractMesh(shape, names)
    kinds = [("train", {}), ("train", {"seq_parallel": True}),
             ("prefill", {}), ("prefill", {"big_params": True}),
             ("decode", {}), ("decode", {"big_params": True})]
    for kind, kw in kinds:
        assert psr.rules_for(kind, **kw) == jsr.rules_for(kind, **kw)
    assert pdp.manual_axes(mesh) == jdp.manual_axes(mesh)
    assert pdp.manual_size(mesh) == jdp.manual_size(mesh)
    checked = 0
    for arch in list_configs():
        jaxes, jabs = _jax_trees(arch)
        specs = param_specs(get_config(arch))
        paxes = map_specs(lambda s: s.axes, specs)
        for kind, kw in kinds:
            rules = jsr.rules_for(kind, **kw)
            jctx, pctx = jsr.ShardingCtx(mesh, rules), \
                psr.ShardingCtx(mesh, rules)
            manual = jdp.manual_axes(mesh)
            jleaves, pleaves = _walk(jaxes, jabs), _walk(paxes, specs)
            assert sorted(jleaves) == sorted(pleaves), arch
            for path in sorted(jleaves):
                ax, ab = jleaves[path]
                pax, spec = pleaves[path]
                assert (ax, tuple(ab.shape)) == (pax, spec.shape)
                assert tuple(jctx.partition_spec(ax, ab.shape)) == \
                    pctx.partition_spec(pax, spec.shape), (arch, path)
                assert jdp.rule_manual_dims(jctx, ax, manual) == \
                    pdp.rule_manual_dims(pctx, pax, manual), (arch, path)
                checked += 1
            assert sorted(jctx.dropped) == sorted(pctx.dropped), arch
            jspecs = _walk(jaxes, jdp.param_manual_specs(jctx, jaxes, jabs,
                                                         manual))
            pspecs = _walk(paxes, pdp.param_manual_specs(pctx, paxes, specs,
                                                         manual))
            for path in jspecs:
                assert tuple(jspecs[path][1]) == pspecs[path][1], \
                    (arch, path)
            assert jdp.validate_manual_divisibility(
                jctx, jaxes, jabs, manual) == \
                pdp.validate_manual_divisibility(pctx, paxes, specs, manual)
    assert checked > 1000


def test_torch_dp_step_takes_plain_path_when_not_divisible():
    """As ``repro``: a manual axis that does not divide a planned dim
    (data 3 against d_model 64) leaves the plain step; so does no
    context, and ``dp_manual`` off."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.lm import build_model, param_specs
    from repro_torch.models.module import init_params
    from repro_torch.train.train_step import TrainStepConfig, make_train_step
    cfg = reduced(get_config("qwen2-0.5b"))
    model = build_model(cfg, init_params(param_specs(cfg),
                                         torch.Generator().manual_seed(0)),
                        device="cpu", trainable=True)
    dp = TrainStepConfig(dp_manual=True)
    assert make_train_step(model, dp).path == "plain"
    with use_rules(AbstractMesh((3, 1), ("data", "model")),
                   rules_for("train")):
        assert make_train_step(model, dp).path == "plain"
        assert make_train_step(model, TrainStepConfig()).path == "plain"


def test_torch_model_axis_raises():
    """Under a model axis of 2 every family runs (the vlm too, since the
    model axis covers it), and outside the manual region of the batch
    axes no layer splits its work (``model_axis.split_for`` is None), so
    the loss of the vlm, dense, moe and ssm families is the loss at a
    model axis of 1."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import model_axis
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.lm import build_model, param_specs
    from repro_torch.models.module import init_params
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long),
             "targets": torch.zeros((2, 8), dtype=torch.long)}
    for arch in ("phi-3-vision-4.2b", "mamba2-780m", "qwen2-0.5b",
                 "granite-moe-3b-a800m"):
        cfg = reduced(get_config(arch))
        model = build_model(cfg, init_params(
            param_specs(cfg), torch.Generator().manual_seed(0)), device="cpu")
        with use_rules(AbstractMesh((2, 1), ("data", "model")),
                       rules_for("train")):
            one = model.loss(batch)[0]
            assert torch.isfinite(one)
        with use_rules(AbstractMesh((1, 2), ("data", "model")),
                       rules_for("train")):
            assert float(model.loss(batch)[0]) == float(one)
            for logical in ("heads_act", "mlp_act", "experts_virt",
                            "vocab_act", "ssm_inner_act"):
                assert model_axis.split_for(logical) is None


# ---- (b) the gather -----------------------------------------------------------

def test_torch_gather_leaf_two_ranks(ranks):
    """Forward: the full leaf in bf16.  Backward: the bf16 sum of the two
    ranks' cotangents, this rank's slice, cast to the shard's fp32.
    ``gather_params`` keeps a 1-dim leaf in fp32 and is the identity
    outside a manual region."""
    workdir, _, inputs = ranks
    res = rank_results(workdir, "gather", 2)
    for name, (full, dim, cot) in inputs["gather"].items():
        want_y = torch.from_numpy(full).to(torch.bfloat16).float().numpy()
        total = (torch.from_numpy(cot[0]).to(torch.bfloat16)
                 + torch.from_numpy(cot[1]).to(torch.bfloat16)).float()
        n = full.shape[dim] // 2
        for rank, r in enumerate(res):
            got = r[name]
            assert got["y_dtype"] == "torch.bfloat16"
            np.testing.assert_array_equal(got["y"], want_y)
            assert got["grad_dtype"] == "torch.float32"
            want_g = np.take(total.numpy(), range(rank * n, (rank + 1) * n),
                             axis=dim)
            np.testing.assert_array_equal(got["grad"], want_g)
    for r in res:
        w, w_dtype = r["gather_params"]["w"]
        s, s_dtype = r["gather_params"]["s"]
        assert (w_dtype, s_dtype) == ("torch.bfloat16", "torch.float32")
        np.testing.assert_array_equal(
            w, torch.from_numpy(inputs["leaves"]["w"]).to(
                torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(s, inputs["leaves"]["s"])
        assert r["outside_region"]


# ---- (c) the step --------------------------------------------------------------

def _dp_result(workdir, world, arch, mb=MICROBATCHES, rank=0):
    return rank_results(workdir, "dp_step", world)[rank][arch, mb]


def _hold_against_jax(ref, got):
    """``tests/test_dp_manual.py``'s tolerances: worst parameter
    difference < 5e-3, loss within 2%, grad norm within 5e-3."""
    assert got["path"] == "dp_manual"
    assert got["params"].keys() == ref["params"].keys()
    worst = max(float(np.max(np.abs(got["params"][k] - v)))
                for k, v in ref["params"].items())
    assert worst < 5e-3, worst
    assert abs(ref["loss"] - got["loss"]) < 0.02 * ref["loss"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) < 5e-3


def _cosine(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_dp_step_matches_jax_single_device(ranks, arch, world):
    """The port's dp step (microbatches 2) at world ``world`` against
    ``repro``'s single-device step, to ``tests/test_dp_manual.py``'s
    tolerances.  Each rank holds only its shards and their moments: the
    planned dims divided by the data axis (2 at both worlds)."""
    workdir, refs, _ = ranks
    ref, got = refs[arch], _dp_result(workdir, world, arch)
    _hold_against_jax(ref, got)
    assert any(got["plan"].values())
    for rank in range(world):
        r = _dp_result(workdir, world, arch, rank=rank)
        for k, full in ref["params"].items():
            want = list(full.shape)
            for dim in got["plan"].get(k, {}):
                want[dim] //= 2
            assert r["shard_shapes"][k] == tuple(want), k
            assert r["mu_shapes"][k] == tuple(want), k


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_dp_step_world_1_gradients_match_jax(ranks, arch):
    """At world 1 over the whole batch the dp step is ``repro``'s
    single-device step but for the bf16 gathers: the same tolerances, and
    every gradient leaf (AdamW's first moment, (1 - b1) times the clipped
    gradient) at a cosine of at least 0.99 to ``repro``'s."""
    workdir, refs, _ = ranks
    ref, got = refs[arch], _dp_result(workdir, 1, arch, mb=1)
    _hold_against_jax(ref, got)
    for k, v in ref["mu"].items():
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= 0.99, k


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_dp_step_matches_own_world_1(ranks, arch, world):
    """The port's step at world R (2 microbatches a rank) against its own
    world-1 step over the same microbatches (2R of them): loss, grad norm
    and every gradient leaf to the tight bounds above; the collectives a
    step issues are those the plan implies."""
    workdir, _, _ = ranks
    one = _dp_result(workdir, 1, arch, mb=world * MICROBATCHES)
    got = _dp_result(workdir, world, arch)
    assert abs(got["loss"] - one["loss"]) <= \
        TIGHT_LOSS_REL * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= \
        TIGHT_NORM_REL * one["grad_norm"]
    for k, v in one["mu"].items():
        assert float(np.max(np.abs(got["mu"][k] - v))) <= \
            TIGHT_MU_OF_MAX * float(np.max(np.abs(v))), k
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= TIGHT_COSINE, k
    # per microbatch: a reduce-scatter per FSDP leaf, a gather per FSDP
    # leaf and one more per layer leaf (remat "dots" gathers again in the
    # backward); per step: an all-reduce per remaining manual axis of each
    # leaf, and of the loss, each of the three metrics and the norm's sum
    # of squares
    plan, counts = got["plan"], got["collectives"]
    fsdp_layers = sum(1 for k in plan if k.startswith(("layers.",
                                                       "encoder.")))
    assert counts["reduce_scatter"] == MICROBATCHES * len(plan)
    assert counts["all_gather"] == MICROBATCHES * (len(plan) + fsdp_layers)
    manual = 2 if world == 4 else 1
    assert counts.get("all_reduce", 0) == \
        manual * (len(got["params"]) + 5) - len(plan)


# ---- (d) compressed_psum -----------------------------------------------------------

def _jax_compressed_psum(grads):
    from repro.distributed.grad_compress import compressed_psum
    fn = jax.vmap(lambda g, e: compressed_psum(g, e, "data"),
                  axis_name="data")
    err = jnp.zeros(grads.shape[:1] + grads.shape[2:], jnp.float32)
    out = []
    for s in range(grads.shape[1]):
        mean, err = fn(jnp.asarray(grads[:, s]), err)
        out.append((np.asarray(mean), np.asarray(err)))
    return out


@pytest.mark.parametrize("world", PSUM_WORLDS)
def test_torch_compressed_psum_matches_jax(ranks, world):
    """Two steps of error feedback at ``world`` ranks: every rank's mean
    within one quantisation bin (the group's largest scale) of JAX's and
    of the true mean of the corrected gradients, the same on every rank;
    every rank's error feedback equal to JAX's to fp32 rounding."""
    workdir, _, inputs = ranks
    res = rank_results(workdir, "compressed_psum", world)
    for i, grads in enumerate(inputs["psum_grads"][world]):
        ref = _jax_compressed_psum(grads)
        err = np.zeros(grads.shape[:1] + grads.shape[2:], np.float32)
        for s, (jmean, jerr) in enumerate(ref):
            corrected = grads[:, s] + err
            bin_ = float(np.max(np.abs(corrected))) / 127
            for rank in range(world):
                mean, perr = res[rank][i][s]
                np.testing.assert_array_equal(mean, res[0][i][s][0])
                assert float(np.max(np.abs(mean - jmean[rank]))) <= bin_
                assert float(np.max(np.abs(mean - corrected.mean(0)))) \
                    <= bin_ + 1e-6
                np.testing.assert_allclose(perr, jerr[rank], rtol=0,
                                           atol=1e-6 * bin_ * 127)
            err = np.stack([res[r][i][s][1] for r in range(world)])


# ---- (e) put_global_batch ---------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
def test_torch_put_global_batch_multi_rank(ranks, world):
    """Each rank's loader puts its host index's rows on its own device;
    in rank order the rows are the global batch a one-host loader puts."""
    workdir, _, _ = ranks
    res = rank_results(workdir, "put_batch", world)
    (one,) = rank_results(workdir, "put_batch", 1)
    n, seq, vocab, gb = PUT_BATCH
    for r in res:
        assert r["tokens"][0].shape == (gb // world, seq)
        assert r["tokens"][1] == "cpu"
    for k, (whole, _) in one.items():
        np.testing.assert_array_equal(
            np.concatenate([r[k][0] for r in res]), whole)


# ---- (f) the resharded restore ------------------------------------------------------

@pytest.mark.parametrize("src,dst", [(2, 1), (2, 4), (1, 2), (4, 2)],
                         ids=lambda v: f"w{v}")
def test_torch_resharded_restore(ranks, src, dst):
    """A checkpoint of a sharded state written at world ``src`` restores
    at world ``dst`` through ``restore(shardings=plan)``: every leaf,
    gathered back, bit-equal to the saved one, each rank holding its
    shards; every world's files, names and manifest equal to the world-1
    save's."""
    workdir, _, inputs = ranks
    step = workdir / f"ck_w{src}" / "step_00000001"
    assert sorted(os.listdir(step)) == ["arrays_p0.npz", "aux.json",
                                        "manifest.json"]
    one = workdir / "ck_w1" / "step_00000001"
    assert (step / "manifest.json").read_text() == \
        (one / "manifest.json").read_text()
    assert json.loads((step / "aux.json").read_text()) == \
        {"world": src, "step": 1}
    with np.load(step / "arrays_p0.npz") as saved:
        saved = {k: saved[k] for k in saved.files}
    for rank, r in enumerate(rank_results(workdir, "restore", dst)):
        got = r[src]
        assert got["aux"]["world"] == src
        assert got["named"].keys() == saved.keys()
        for k, v in saved.items():
            assert got["named"][k].dtype == v.dtype, k
            assert got["named"][k].tobytes() == v.tobytes(), k
        run = DP_RUNS[dst][-1]
        want = rank_results(workdir, "dp_step", dst)[rank][run]
        assert got["shard_shapes"] == want["shard_shapes"]
