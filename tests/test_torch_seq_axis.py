"""The sequence over the model axis in the port, against ``repro``.

Training: ``repro``'s manual sequence parallelism (its ``TRAIN_RULES`` map
``seq_res`` to ``"model"``; ``repro/models/stack.py``'s ``run_stack``):
between the regions of a layer each model rank holds its block of the
residual stream's tokens (``stack.sp_split``), attention and the MLP or
MoE gather the sequence in and reduce-scatter their outputs
(``model_axis.gather_seq`` / ``scatter_seq``), and the leaves applied to
the block (the norms' scales, the expert-parallel router) are summed over
the model ranks once a step.  Serving: under ``SERVE_RULES`` (``kv_seq``
to ``"model"``) each rank's K/V cache holds a block of the slots
(``stack.kv_shards``) and decode combines the ranks' partial softmaxes
(``ref.mha_partial`` / ``combine_partial``).

The multi-rank cases run gloo ranks on the CPU, each a process of its own
(``tests/_torch_tp_ranks.py``, jobs ``seq_step`` and ``kv_serve``, spawned
by ``_torch_support``), while the parent computes ``repro``'s
single-device step and greedy decode on the same numpy-seeded inputs
(``repro``'s sharded paths fail on the CPU, ``tests/test_dp_manual.py``).
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_support import join_ranks, rank_results, spawn_ranks

B, S, S_NODIV = 8, 16, 15              # 15: no model axis here divides it
SEQ_ARCHS = {"qwen2_h14": ("qwen2-0.5b", {"num_heads": 14}),
             "granite": ("granite-moe-3b-a800m", {})}
# mesh tag -> batch shards R (pod x data)
STEP_MESHES = {"1x2": 1, "1x4": 1, "2x2": 2, "2x2x2": 4}
# (remat, compress) of each mesh's runs: each arch sees every pair
COMBOS = {"1x2": ("none", False), "1x4": ("dots", False),
          "2x2": ("full", True), "2x2x2": ("dots", True)}
NODIV_MESH = "1x4"
# a run that also issues the collectives over a group of one rank: at world
# 1, and over (data 1, model 2)'s data axis
UNSKIPPED = ("qwen2_h14", *COMBOS["1x2"], 1)
SEQ_RUNS = {
    **{t: [(a, *COMBOS[t], 1, v) for a in SEQ_ARCHS
           for v in ("sp", "control")]
       + [(a, *COMBOS[t], 1, "nodiv") for a in SEQ_ARCHS
          if t == NODIV_MESH]
       + [UNSKIPPED + ("issued",)] * (t == "1x2")
       for t in STEP_MESHES},
    # the port's world-1 step over the same microbatches
    "1x1": [(a, *COMBOS[t], r, "sp") for t, r in STEP_MESHES.items()
            for a in SEQ_ARCHS] + [UNSKIPPED + ("issued",)]}
# serving: (arch, prompt length, decode steps); max_len 32 (a 16-slot ring
# for mixtral's window): qwen2's and granite's prompts end two slots before
# a block boundary at model 2 and 4 and leave the last ranks without a key;
# mixtral's wraps its ring at prefill and its decode crosses a block
KV_ARCHS = {"qwen2": ("qwen2-0.5b", 14, 6),
            "granite": ("granite-moe-3b-a800m", 14, 6),
            "mixtral": ("mixtral-8x22b", 20, 6)}
KV_B, KV_MAX_LEN, KV_GUARD_LEN = 4, 32, 30        # 30: not a multiple of 4
KV_MESHES = ("1x2", "1x4", "2x2")
KV_RUNS = {t: [(a, KV_MAX_LEN) for a in KV_ARCHS]
           + [("qwen2", KV_GUARD_LEN)] * (t == "1x4") for t in KV_MESHES}
# against repro's single-device step: tests/test_dp_manual.py's bounds
REF_PARAM_ATOL, REF_LOSS_REL, REF_NORM_ATOL = 5e-3, 0.02, 5e-3
# against the port's world-1 step (tests/test_torch_model_storage.py's)
TIGHT_LOSS_REL = 1e-6
TIGHT_NORM_REL = 2e-4
TIGHT_MU_OF_MAX = 2 ** -7
TIGHT_COSINE = 1 - 1e-5
B1 = 0.9
COMPRESS_NORM_REL = TIGHT_NORM_REL + 2 ** -8
# serving in fp32 against repro: logits within 1e-4 of the largest
KV_OF_MAX = 1e-4


def _jax_config(arch, overrides):
    from repro.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def _port_config(arch, overrides):
    from repro_torch.configs import get_config, reduced
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
    """A mesh-shaped stand-in: axis sizes, and rank 0 of every axis."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


# ---- inputs and references --------------------------------------------------

def _params(arch, overrides):
    from repro.models import build_model
    return build_model(_jax_config(arch, overrides)).init(
        jax.random.PRNGKey(0))


def _seq_inputs():
    out = {}
    for name, (arch, ov) in SEQ_ARCHS.items():
        cfg = _jax_config(arch, ov)
        r = np.random.default_rng(2)
        batches = {}
        for key, s in (("batch", S), ("batch_nodiv", S_NODIV)):
            batches[key] = {
                "tokens": r.integers(0, cfg.vocab_size, (B, s)),
                "targets": r.integers(0, cfg.vocab_size, (B, s)),
                "loss_mask": np.ones((B, s), np.float32)}
        out[name] = dict(arch=arch, overrides=ov, tree=_flat(
            jax.tree_util.tree_map(np.asarray, _params(arch, ov))),
            **batches)
    return out


def _kv_inputs():
    out = {}
    for name, (arch, s, steps) in KV_ARCHS.items():
        r = np.random.default_rng(3)
        out[name] = dict(arch=arch, steps=steps, tree=_flat(
            jax.tree_util.tree_map(np.asarray, _params(arch, {}))),
            prompts=r.integers(0, 256, (KV_B, s)))
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


def _jax_greedy(c, max_len):
    """``repro``'s single-device prefill and greedy decode in fp32 over an
    fp32 K/V cache: the logits of every step (the prefill's last position
    first), the greedy tokens and the cache."""
    from repro.models import build_model
    model = build_model(_jax_config(c["arch"], {}))
    params = model.init(jax.random.PRNGKey(0))
    prompts = jnp.asarray(c["prompts"].astype(np.int32))
    Bp, Sp = prompts.shape
    cache = model.init_cache(Bp, max_len, kv_dtype=jnp.float32)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": prompts},
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
                k=np.asarray(cache["k"]), v=np.asarray(cache["v"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    workdir = tmp_path_factory.mktemp("seq_ranks")
    seq, kv = _seq_inputs(), _kv_inputs()
    inputs = dict(seq_archs=seq, seq_runs=SEQ_RUNS, kv_archs=kv,
                  kv_runs=KV_RUNS,
                  step_config=TrainStepConfig(
                      dp_manual=True, optimizer=AdamWConfig(b1=B1)))
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jobs = {t: ["seq_step"] + ["kv_serve"] * (t in KV_MESHES)
            for t in SEQ_RUNS}
    procs = {t: spawn_ranks(workdir, t, j, module="_torch_tp_ranks")
             for t, j in jobs.items()}
    try:
        refs = dict(
            step={(k, c): _jax_step_ref(a, c) for k, a in seq.items()
                  for c in (False, True)},
            kv={(k, n): _jax_greedy(c, n) for k, c in kv.items()
                for n in (KV_MAX_LEN, KV_GUARD_LEN)})
    finally:
        for t in jobs:
            join_ranks(procs[t])
    return workdir, refs, inputs


# ---- no ranks ---------------------------------------------------------------

class _SpFound(Exception):
    pass


class _Scan(Exception):
    pass


def _jax_sp(cfg, rules, shape, names, seq_len) -> bool:
    """``repro``'s own decision in ``run_stack`` inside the manual region
    of the batch axes: does it constrain the residual stream to
    ``RES_AXES_SP`` before its scan over the layers?  Read by running
    ``run_stack`` up to the one or the other."""
    from repro.distributed import sharding_rules as jsr
    from repro.models import stack as jstack
    real = jstack.constrain

    def spy(x, *axes):
        if axes == jstack.RES_AXES_SP:
            raise _SpFound
        return real(x, *axes)

    def scan(*args, **kwargs):
        raise _Scan

    # repro's use_rules enters its mesh, which an AbstractMesh refuses: set
    # the context it would set
    ctx = jsr.ShardingCtx(AbstractMesh(shape, names), rules)
    token = jsr._ACTIVE.set(ctx)
    real_scan = jax.lax.scan
    jstack.constrain, jax.lax.scan = spy, scan
    try:
        with ctx.manual_region(tuple(a for a in ("pod", "data")
                                     if a in names)):
            jstack.run_stack({}, cfg, jnp.zeros((1, seq_len, 1)),
                             positions=None)
    except _SpFound:
        return True
    except _Scan:
        return False
    finally:
        jstack.constrain, jax.lax.scan = real, real_scan
        jsr._ACTIVE.reset(token)
    raise AssertionError("repro's run_stack reached neither")


@pytest.mark.parametrize("rules", ("train", "train_sp", "serve"))
@pytest.mark.parametrize("mesh", [((1, 1), ("data", "model")),
                                  ((1, 2), ("data", "model")),
                                  ((1, 4), ("data", "model")),
                                  ((2, 2, 2), ("pod", "data", "model"))])
def test_torch_sp_split_matches_jax(mesh, rules):
    """``stack.sp_split`` takes sequence parallelism exactly where
    ``repro``'s ``run_stack`` does, for every config at a dividing and a
    non-dividing length (a model axis of 1, where ``repro``'s constraint
    is a no-op, takes none)."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import list_configs
    from repro.distributed import sharding_rules as jsr
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding_rules as tsr
    from repro_torch.models import stack as stk
    shape, names = mesh
    n = shape[-1]
    table = {"train": "TRAIN_RULES", "train_sp": "TRAIN_SP_RULES",
             "serve": "SERVE_RULES"}[rules]
    on = 0
    for arch in list_configs():
        for seq_len in (16, 18):
            want = _jax_sp(jget(arch), getattr(jsr, table), shape, names,
                           seq_len) and n > 1
            with tsr.use_rules(_Stand(shape, names),
                               getattr(tsr, table)) as ctx, \
                    ctx.manual_region(tuple(a for a in ("pod", "data")
                                            if a in names)):
                split = stk.sp_split(get_config(arch), seq_len)
            assert (split is not None) == want, (arch, seq_len)
            on += want
            if split is not None:
                assert split.size == n
    # the attention families without an SSM or a prefix, at 16 only (and
    # at 18 over 2): none under the serving rules
    assert (on > 0) == (rules != "serve" and n > 1)


@pytest.mark.parametrize("rules,max_len,cut", [
    ("serve", 32, True), ("serve", 30, True), ("serve_big", 32, True),
    ("train", 32, False)])
def test_torch_kv_cache_blocks(rules, max_len, cut):
    """Under rules that map ``kv_seq`` to ``"model"`` (4 here) a cache
    whose slots the axis divides holds a block of them a rank, for
    qwen2's full-length cache and mixtral's ring (16 slots); one that does
    not divide stays whole (``repro``'s guard), as does every cache under
    the training rules and off a mesh."""
    from repro_torch.distributed import sharding_rules as tsr
    from repro_torch.models import stack as stk
    rule_set = {"serve": tsr.SERVE_RULES, "serve_big": tsr.SERVE_RULES_BIG,
                "train": tsr.TRAIN_RULES}[rules]
    for arch, slots in (("qwen2-0.5b", max_len),
                        ("mixtral-8x22b", min(max_len, 16))):
        cfg = _port_config(arch, {})
        blocks = 4 if cut and slots % 4 == 0 else 1
        with tsr.use_rules(_Stand((1, 4), ("data", "model")), rule_set):
            cache = stk.init_cache(cfg, 2, max_len, device="cpu")
            if blocks > 1:       # a block used outside the region refuses
                with pytest.raises(ValueError, match="outside a kv_seq"):
                    stk.kv_split(cache)
            else:
                assert stk.kv_split(cache) is None
        assert cache.kv_shards == blocks, arch
        assert cache["k"].shape == (cfg.num_layers, 2, slots // blocks,
                                    cfg.num_kv_heads, cfg.head_dim)
        assert stk.init_cache(cfg, 2, max_len, device="cpu").kv_shards == 1


@pytest.mark.parametrize("how", ("plain_dict", "rebuilt_cache", "guard"))
def test_torch_kv_split_refuses_lost_blocks(how):
    """Inside a ``kv_seq`` split of 4 a cache that may have lost its block
    count refuses (a plain dict of the leaves, or a ``Cache`` rebuilt
    without ``kv_shards`` whose 8 slots the split divides), rather than
    take its block for the whole; a whole cache the guard keeps whole (30
    slots) passes as whole."""
    from repro_torch.distributed import sharding_rules as tsr
    from repro_torch.models import stack as stk
    cfg = _port_config("qwen2-0.5b", {})
    with tsr.use_rules(_Stand((1, 4), ("data", "model")),
                       tsr.SERVE_RULES) as ctx:
        cache = stk.init_cache(cfg, 2, 30 if how == "guard" else 32,
                               device="cpu")
        with ctx.manual_region(("data",)):
            if how == "guard":
                assert cache.kv_shards == 1 and stk.kv_split(cache) is None
                return
            assert stk.kv_split(cache).size == cache.kv_shards == 4
            if how == "plain_dict":
                lost, match = dict(cache), "plain dict"
            else:
                lost, match = stk.Cache(cache), "kv_shards lost"
            with pytest.raises(ValueError, match=match):
                stk.kv_split(lost)


@pytest.mark.parametrize("blocks", (2, 4))
@pytest.mark.parametrize("case", ("causal", "window_sinks", "ring",
                                  "valid_softcap"))
def test_torch_combine_partial_matches_mha(case, blocks):
    """``ref.mha_partial`` over each block of the keys and
    ``combine_partial`` over the blocks equal ``ref.mha`` over all of them
    at random masks, a row that sees no key at all included (0, no NaN);
    a block that sees no key adds exactly 0."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(hash((case, blocks)) % 2 ** 31)
    Bq, Sq, H, K, D, T = 3, 2, 4, 2, 16, 16
    q = torch.randn((Bq, Sq, H, D), generator=g)
    k = torch.randn((Bq, T, K, D), generator=g)
    v = torch.randn((Bq, T, K, D), generator=g)
    q_pos = torch.tensor([[5, 6], [12, 13], [0, 1]])
    kv_pos = torch.arange(T)[None].expand(Bq, T).clone()
    kw = dict(causal=True, q_pos=q_pos, kv_pos=kv_pos)
    if case == "window_sinks":
        kw.update(window=4, num_sink=2)
    elif case == "ring":
        kv_pos[0, 8:] = -(10 ** 9)           # slots not written yet
        kv_pos[2] = -(10 ** 9)               # a row with no key at all
    elif case == "valid_softcap":
        kw.update(kv_valid=torch.tensor([3, 16, 0]), softcap=5.0)
    want = ref.mha(q, k, v, **kw)
    n = T // blocks
    parts = [ref.mha_partial(q, k[:, i * n:(i + 1) * n],
                             v[:, i * n:(i + 1) * n],
                             **dict(kw, kv_pos=kv_pos[:, i * n:(i + 1) * n]))
             for i in range(blocks)]
    # each block is a rank: what each rank hands the gather, stacked
    handed = []
    for o, lse in parts:
        ref.combine_partial(o, lse, lambda t: handed.append(t) or t[None])
    stacked = torch.stack(handed)
    for o, lse in parts:
        got = ref.combine_partial(o, lse, lambda t: stacked)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-6)
    # a block that sees no key adds exactly 0 to both sums
    m = torch.stack([lse for _, lse in parts]).amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    empty = 0
    for o, lse in parts:
        none = torch.isneginf(lse)
        assert not torch.exp(lse - m)[none].any() and not o[none].any()
        empty += int(none.sum())
    if case in ("ring", "valid_softcap"):
        assert empty and not want[2].any()


# ---- the sequence-parallel step ---------------------------------------------

def _tight(got, one, compress) -> bool:
    """Does ``got`` match the port's world-1 step ``one`` to the tight
    bounds (with compression, the first moments to them plus (1 - b1)
    int8 quanta of the stacked leaf's scale)?"""
    from repro_torch.train.train_step import stacked_name
    if abs(got["loss"] - one["loss"]) > TIGHT_LOSS_REL * abs(one["loss"]):
        return False
    if abs(got["grad_norm"] - one["grad_norm"]) > \
            (COMPRESS_NORM_REL if compress else TIGHT_NORM_REL) \
            * one["grad_norm"]:
        return False
    for k, v in one["mu"].items():
        err = float(np.max(np.abs(got["mu"][k] - v)))
        if compress:
            stacked = [n for n in one["mu"]
                       if stacked_name(n) == stacked_name(k)]
            amax = max(float(np.max(np.abs(one["mu"][n]))) for n in stacked)
            if err > amax / 127 + TIGHT_MU_OF_MAX * float(np.max(np.abs(v))):
                return False
            continue
        if err > TIGHT_MU_OF_MAX * float(np.max(np.abs(v))):
            return False
        if np.any(v) and _cosine(v, got["mu"][k]) < TIGHT_COSINE:
            return False
    return True


def _split_leaves(got):
    return {k for k, dims in got["plan"].items()
            if any("model" in a for a in dims.values())}


@pytest.mark.parametrize("arch", list(SEQ_ARCHS))
@pytest.mark.parametrize("tag", list(STEP_MESHES))
def test_torch_seq_step(ranks, tag, arch):
    """The ``dp_manual`` step with the residual stream's tokens split over
    the model ranks, on the storage plan, remat and compression as
    ``COMBOS`` gives the mesh: against ``repro``'s single-device step with
    ``tests/test_dp_manual.py``'s tolerances and against the port's
    world-1 step over the same microbatches to the tight bounds; every
    layer receives a (B / R, S / n, D) block on every rank; every leaf
    bit-equal across the model ranks; the norms' scales (and the
    expert-parallel router) summed over the model ranks once, exactly the
    leaves stored whole whose gradient differed across them; the model
    axis moves activations only by all-gathers and reduce-scatters, the
    cross-entropy's two sums and one max being its only all-reduces."""
    workdir, refs, _ = ranks
    remat, compress = COMBOS[tag]
    run = (arch, remat, compress, 1, "sp")
    res = rank_results(workdir, "seq_step", tag)
    got = res[0][run]
    n, R = int(tag.split("x")[-1]), STEP_MESHES[tag]
    cfg = _port_config(*SEQ_ARCHS[arch])
    assert got["path"] == "dp_manual" and got["sp"] == n
    ref = refs["step"][arch, compress]
    worst = max(float(np.max(np.abs(got["params"][k] - v)))
                for k, v in ref["params"].items())
    assert worst < REF_PARAM_ATOL, worst
    assert abs(ref["loss"] - got["loss"]) < REF_LOSS_REL * ref["loss"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) < REF_NORM_ATOL
    one = rank_results(workdir, "seq_step", "1x1")[0][
        arch, remat, compress, R, "sp"]
    assert one["sp"] is None
    assert one["residual"] == [(B // R, S, cfg.d_model)]
    assert _tight(got, one, compress)
    for r in res:
        assert r[run]["residual"] == [(B // R, S // n, cfg.d_model)]
    for group in _model_groups(tag):
        for rank in group[1:]:
            other = res[rank][run]
            for k, v in res[group[0]][run]["params"].items():
                assert other["params"][k].tobytes() == v.tobytes(), (rank, k)
            assert other["loss"] == res[group[0]][run]["loss"]
    split = _split_leaves(got)
    partial = {k for k in got["params"] if k not in split and (
        k.split(".")[-2] in ("attn", "moe", "ln1", "ln2", "final_norm")
        or k == "embed.tokens")}
    assert set(got["partial"]) == partial
    assert {k for k in partial if k.endswith(".scale")} == \
        {f"layers.{i}.{g}.scale" for i in range(cfg.num_layers)
         for g in ("ln1", "ln2")} | {"final_norm.scale"}
    for r in res:
        assert set(r[run]["summed"]) == partial
        assert set(r[run]["differ"]) - split == partial
    # per layer two regions, each a gather and a reduce-scatter forward
    # and the transposes backward; a rematerialised layer gathers both
    # regions again and redoes attention's reduce-scatter, but not the
    # feed-forward half's, whose output no saved tensor of the layer needs
    # (the recompute stops early); the lookup's reduce-scatter into the
    # block where the table is split, the cross-entropy's gather, and the
    # lookup's and cross-entropy's transposes
    L, remat_ = cfg.num_layers, remat != "none"
    mc = got["model_collectives"]
    assert mc.get("all_reduce", 0) == 2 and mc.get("all_reduce_max") == 1
    assert mc["all_gather"] == L * (4 + 2 * remat_) + 2
    assert mc["reduce_scatter"] == L * (4 + remat_) + 1 \
        + ("embed.tokens" in split)
    assert got["moved"] == {"direct": sum(got["collectives"].values())
                            + sum(mc.values())}


@pytest.mark.parametrize("arch", list(SEQ_ARCHS))
@pytest.mark.parametrize("tag", list(STEP_MESHES))
def test_torch_seq_step_control_fails(ranks, tag, arch):
    """The control: ``scatter_seq`` slicing each rank's block of its own
    partial output, without the sum over the model ranks, misses the
    port's world-1 step by far more than the tight bounds."""
    workdir, _, _ = ranks
    remat, compress = COMBOS[tag]
    got = rank_results(workdir, "seq_step", tag)[0][
        arch, remat, compress, 1, "control"]
    one = rank_results(workdir, "seq_step", "1x1")[0][
        arch, remat, compress, STEP_MESHES[tag], "sp"]
    assert got["sp"] == int(tag.split("x")[-1])
    assert not _tight(got, one, compress)


@pytest.mark.parametrize("arch", list(SEQ_ARCHS))
def test_torch_seq_step_nodiv_takes_unsplit_path(ranks, arch):
    """At a sequence length the model axis does not divide (15 over 4) the
    residual stream stays whole, as ``repro``'s guard keeps it: every
    layer receives all 15 tokens on every rank, no activation is gathered
    or reduce-scattered over the model ranks (the regions end in
    all-reduces), and no norm scale is summed over them.  The numbers of
    this path are held against ``repro`` and the world-1 step in
    ``tests/test_torch_model_axis.py`` (``test_torch_model_axis_step_
    unsplit``)."""
    workdir, _, _ = ranks
    remat, compress = COMBOS[NODIV_MESH]
    cfg = _port_config(*SEQ_ARCHS[arch])
    for r in rank_results(workdir, "seq_step", NODIV_MESH):
        got = r[arch, remat, compress, 1, "nodiv"]
        assert got["sp"] is None
        assert got["residual"] == [(B, S_NODIV, cfg.d_model)]
        assert set(got["model_collectives"]) == {"all_reduce",
                                                 "all_reduce_max"}
        assert not any(k.endswith(".scale") and ".attn." not in k
                       for k in got["summed"])


# ---- the kv_seq-sharded decode cache ----------------------------------------

def _kv_check(res, ref, tag, run, blocks):
    """Every rank's logits and greedy tokens against ``repro``'s for its
    rows; each model group's K/V blocks, joined in rank order, against
    ``repro``'s cache; each rank holding 1 / ``blocks`` of the cache."""
    groups = _model_groups(tag)
    rows = KV_B // len(groups)
    for i, group in enumerate(groups):
        sl = slice(i * rows, (i + 1) * rows)
        want = ref["logits"][sl]
        for rank in group:
            got = res[rank][run]
            assert np.isfinite(got["logits"]).all()
            err = float(np.max(np.abs(got["logits"] - want)))
            assert err <= KV_OF_MAX * float(np.max(np.abs(want))), err
            np.testing.assert_array_equal(got["logits"].argmax(-1),
                                          ref["tokens"][sl])
            assert got["kv_shards"] == blocks
            assert got["bytes"] * blocks == 2 * ref["k"][:, sl].nbytes
        for name in ("k", "v"):
            parts = [res[r][run][name] for r in group]
            if blocks == 1:
                parts = parts[:1]
            union, w = np.concatenate(parts, axis=2), ref[name][:, sl]
            assert union.shape == w.shape
            assert float(np.max(np.abs(union - w))) <= \
                KV_OF_MAX * float(np.max(np.abs(w)))


@pytest.mark.parametrize("arch", list(KV_ARCHS))
@pytest.mark.parametrize("tag", KV_MESHES)
def test_torch_kv_serve_matches_jax(ranks, tag, arch):
    """Prefill and greedy decode through ``_serve_wrap`` under the serving
    rules, each rank holding a block of the K/V slots (T / n), in fp32
    against ``repro``'s single-device prefill and decode: logits within
    1e-4 of the largest at every step, equal greedy tokens, the blocks
    joined equal to ``repro``'s cache.  qwen2's and granite's prompts end
    before a block boundary the decode steps cross, with the last ranks'
    blocks empty at the prefill and the first steps (their partial softmax
    adds 0, never NaN); mixtral's ring wraps at the prefill and its decode
    crosses a block."""
    workdir, refs, _ = ranks
    n = int(tag.split("x")[-1])
    _, prompt, steps = KV_ARCHS[arch]
    slots = 16 if arch == "mixtral" else KV_MAX_LEN
    block = slots // n
    first, last = prompt % slots, (prompt + steps - 2) % slots
    assert first // block != last // block          # a boundary crossed
    if arch != "mixtral":      # the last block empty for two decode steps
        assert prompt + 1 < (n - 1) * block
    _kv_check(rank_results(workdir, "kv_serve", tag),
              refs["kv"][arch, KV_MAX_LEN], tag, (arch, KV_MAX_LEN), n)


def test_torch_kv_serve_guard_keeps_cache_whole(ranks):
    """A cache of 30 slots over a model axis of 4 stays whole on every
    rank (``repro``'s divisibility guard) and decodes as ``repro`` does."""
    workdir, refs, _ = ranks
    _kv_check(rank_results(workdir, "kv_serve", "1x4"),
              refs["kv"]["qwen2", KV_GUARD_LEN], "1x4",
              ("qwen2", KV_GUARD_LEN), 1)


# ---- a group of one rank ----------------------------------------------------

@pytest.mark.parametrize("tag", ("1x1", "1x2"))
def test_torch_group_of_one_issues_nothing(ranks, tag):
    """A collective over a group of one rank is not issued
    (``transport``): at world 1 the step issues none at all, and on (data
    1, model 2) none over the data axis (the model axis's sums of the
    partial leaves and of the grad norm are its only all-reduces); issuing
    them all the same changes no bit of the step."""
    workdir, _, _ = ranks
    for r in rank_results(workdir, "seq_step", tag):
        got, forced = r[UNSKIPPED + ("sp",)], r[UNSKIPPED + ("issued",)]
        assert got["loss"] == forced["loss"]
        assert got["grad_norm"] == forced["grad_norm"]
        for k, v in forced["params"].items():
            assert got["params"][k].tobytes() == v.tobytes(), k
            assert got["mu"][k].tobytes() == forced["mu"][k].tobytes(), k
        if tag == "1x1":
            assert got["collectives"] == got["model_collectives"] == {}
            assert got["moved"] == {}
        else:
            assert got["collectives"].get("all_reduce", 0) == \
                len(got["partial"]) + 1
            assert got["model_collectives"] == forced["model_collectives"]
        assert forced["collectives"]["all_reduce"] > \
            got["collectives"].get("all_reduce", 0)
