"""The families with an SSM under the port's model axis, against
``repro``'s single-device results: attention over head slices that
straddle GQA groups (hymba's 25 / 5 heads) or hold padding only, the SSM
mixer split by whole SSD heads (``models/ssm.py``) with its gate norm over
a row split across the ranks (``ops.rmsnorm_split``), the ``dp_manual``
step of reduced mamba2 and hymba on (data, model) meshes with the storage
plan, serving through ``launch/dryrun._serve_wrap`` under the serving
rules (the SSM cache split by heads, hymba's K/V cache cut on
``kv_seq``), and a checkpoint restored across model sizes.

The multi-rank cases run gloo ranks on the CPU, each a process of its own
(``tests/_torch_tp_ranks.py``, jobs ``ssm_pieces``, ``ssm_step``,
``ssm_serve`` and ``ssm_restore``, spawned by ``_torch_support``), joined
through a ``FileStore`` under the test's temporary directory; one module
fixture starts every rank of the first round at once and computes the JAX
references while they run.  ``repro``'s sharded paths fail while tracing
here (``tests/test_dp_manual.py``), so each piece is held against
``repro``'s unsharded function on the same numpy-seeded inputs.
"""
import dataclasses
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import join_ranks, rank_results, spawn_ranks

PIECE_WORLDS = (2, 4)
# attention: (arch, overrides, window, sinks); 25 / 5 heads pad to (5, 6)
# at model 2 and (6, 6) at 4, both straddling groups; 15 / 3 pad to (3, 6)
# at 2 (straddling) and (4, 5) at 4, where rank 3 holds padding only
ATTN = {"hymba25": ({"num_heads": 25, "num_kv_heads": 5}, 0, 0),
        "hymba25_window": ({"num_heads": 25, "num_kv_heads": 5}, 8, 4),
        "h15": ({"num_heads": 15, "num_kv_heads": 3}, 0, 0)}
ATTN_B, ATTN_S = 2, 24
# the SSM mixer: reduced mamba2 (8 heads of 16) and d_model 40 (5 heads:
# 3 / 2 at model 2, 2 / 1 / 1 / 1 at 4, the conv's 112 channels and the
# inner 80 stored split but unaligned, the heads' leaves whole)
MIXER = {"mamba2": {}, "uneven5": {"d_model": 40}}
MIXER_B, MIXER_S, MIXER_DECODE = 2, 16, 4
STEP_ARCHS = {"mamba2": ("mamba2-780m", {}),
              "hymba": ("hymba-1.5b", {"num_heads": 25, "num_kv_heads": 5})}
B, S = 8, 16
STEP_MESHES = ("1x2", "1x4", "2x2")
# hymba with int8 error-feedback compression, on (2, 2) against the
# world-1 step
COMPRESSED, COMPRESSED_MESH = "hymba_ef", "2x2"
# "1x1": the port's world-1 step over the same batch, which also writes
# the checkpoint the (2, 2) mesh restores
STEP_RUNS = {t: list(STEP_ARCHS) + [COMPRESSED] * (t in (COMPRESSED_MESH,
                                                       "1x1"))
             for t in STEP_MESHES + ("1x1",)}
RESTORE_FROM = {"1x1": "2x2", "2x2": "1x1"}
# serving: (arch, overrides, rows, prompt length, steps, max_len).  Hymba's
# internal cache holds 8 meta tokens + 32 = 40 slots: at model 4 a block of
# 10, so rank 0 holds the sinks and keys outside the window of 16 for
# every decode query of the long prompt (positions 28-33) and rank 3 no key
# until the third step; the short prompt leaves rank 1's block at model 2
# empty throughout
SERVE = {"mamba2": ("mamba2-780m", {}, 4, 12, 6, 24),
         "hymba_long": ("hymba-1.5b", {"num_heads": 25, "num_kv_heads": 5},
                        4, 20, 6, 32),
         "hymba_short": ("hymba-1.5b", {"num_heads": 25, "num_kv_heads": 5},
                         4, 4, 6, 32)}
SERVE_MESHES = ("1x2", "1x4", "2x2")
# pieces against repro in fp32: sums over the ranks in another order
PIECE_RTOL = 2e-5
# decode reads the conv tail in bf16, as in repro
DECODE_RTOL = 1e-4
CONV_RTOL = 2 ** -7
# against repro's single-device step: tests/test_dp_manual.py's bounds on
# the parameters and the loss; the grad norm relative, since the step
# gathers the FSDP leaves in bf16 (as repro's dp_manual step does), which
# moves reduced mamba2's grad norm 0.55% from the fp32 single-device
# step's (2.37298 against 2.38622, the port's world-1 step the same), past
# test_dp_manual's 5e-3 absolute; the split itself is held to the world-1
# step's tight bounds
REF_PARAM_ATOL, REF_LOSS_REL, REF_NORM_REL = 5e-3, 0.02, 1e-2
# every first moment's cosine to repro's: the bf16 gathers bring reduced
# mamba2's layers.1.ln1.scale to 0.99889 (the world-1 step the same)
REF_MU_COSINE = 0.995
# against the port's world-1 step (tests/test_torch_model_axis.py's)
TIGHT_LOSS_REL = 1e-6
TIGHT_NORM_REL = 2e-4
TIGHT_MU_OF_MAX = 2 ** -7
TIGHT_COSINE = 1 - 1e-5
# the compressed step's grad norm is taken before the int8 rounding, whose
# scale moves with the sum's order: test_torch_seq_axis's bound
COMPRESS_NORM_REL = TIGHT_NORM_REL + 2 ** -8
# serving in fp32 against repro: logits within 1e-4 of the largest
SERVE_OF_MAX = 1e-4


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


def _normal(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=PIECE_RTOL, what=""):
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


# ---- inputs -----------------------------------------------------------------

def _attn_inputs():
    from repro.models import layers as jl
    r = np.random.default_rng(31)
    out = {}
    for name, (ov, window, sinks) in ATTN.items():
        cfg = _jax_config("hymba-1.5b", ov)
        params = {k: _normal(r, s.shape, s.shape[0] ** -0.5)
                  for k, s in jl.attention_specs(cfg).items()}
        out[name] = dict(arch="hymba-1.5b", overrides=ov, params=params,
                         window=window, num_sink=sinks,
                         x=_normal(r, (ATTN_B, ATTN_S, cfg.d_model)),
                         dy=_normal(r, (ATTN_B, ATTN_S, cfg.d_model)))
    return out


def _mixer_inputs():
    from repro.models import ssm as jssm
    r = np.random.default_rng(32)
    out = {}
    for name, ov in MIXER.items():
        cfg = _jax_config("mamba2-780m", ov)
        params = {}
        for k, s in jssm.ssm_specs(cfg).items():
            if k in ("dt_bias", "A_log"):
                params[k] = _normal(r, s.shape, 0.5)
            elif k in ("D", "gate_norm", "conv_b"):
                params[k] = 1.0 + _normal(r, s.shape, 0.2)
            else:
                params[k] = _normal(r, s.shape, s.shape[0] ** -0.5)
        D = cfg.d_model
        out[name] = dict(arch="mamba2-780m", overrides=ov, params=params,
                         x=_normal(r, (MIXER_B, MIXER_S, D)),
                         dy=_normal(r, (MIXER_B, MIXER_S, D)),
                         x_dec=_normal(r, (MIXER_B, MIXER_DECODE, D)))
    return out


def _step_inputs():
    from repro.models import build_model
    out = {}
    for name, (arch, ov) in STEP_ARCHS.items():
        cfg = _jax_config(arch, ov)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        r = np.random.default_rng(33)
        out[name] = dict(
            arch=arch, overrides=ov,
            tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
            batch={"tokens": r.integers(0, cfg.vocab_size, (B, S)),
                   "targets": r.integers(0, cfg.vocab_size, (B, S)),
                   "loss_mask": np.ones((B, S), np.float32)})
    out[COMPRESSED] = dict(out["hymba"], compress=True)
    return out


def _serve_inputs():
    from repro.models import build_model
    out = {}
    for name, (arch, ov, rows, prompt, steps, max_len) in SERVE.items():
        cfg = _jax_config(arch, ov)
        params = build_model(cfg).init(jax.random.PRNGKey(1))
        out[name] = dict(
            arch=arch, overrides=ov, steps=steps, max_len=max_len,
            tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
            prompts=np.random.default_rng(34).integers(
                0, cfg.vocab_size, (rows, prompt)))
    return out


# ---- references -------------------------------------------------------------

def _jax_attention(c):
    from repro.models import layers as jl
    cfg = _jax_config(c["arch"], c["overrides"])
    p = {k: jnp.asarray(v) for k, v in c["params"].items()}
    pos = jnp.broadcast_to(jnp.arange(ATTN_S)[None], (ATTN_B, ATTN_S))
    y, vjp = jax.vjp(lambda p, x: jl.attention(
        p, cfg, x, positions=pos, window=c["window"],
        num_sink=c["num_sink"]), p, jnp.asarray(c["x"]))
    dp, dx = vjp(jnp.asarray(c["dy"]))
    return dict(y=np.asarray(y), dx=np.asarray(dx),
                grads={k: np.asarray(v) for k, v in dp.items()})


def _jax_mixer(c):
    from repro.models import ssm as jssm
    cfg = _jax_config(c["arch"], c["overrides"])
    p = {k: jnp.asarray(v) for k, v in c["params"].items()}
    y, vjp = jax.vjp(lambda p, x: jssm.ssm(p, cfg, x), p,
                     jnp.asarray(c["x"]))
    dp, dx = vjp(jnp.asarray(c["dy"]))
    y0, cache = jssm.ssm(p, cfg, jnp.asarray(c["x"]), return_state=True)
    steps = []
    for i in range(MIXER_DECODE):
        yi, cache = jssm.ssm_decode(p, cfg, jnp.asarray(c["x_dec"][:, i:i + 1]),
                                    cache)
        steps.append(np.asarray(yi))
    return dict(y=np.asarray(y), dx=np.asarray(dx),
                grads={k: np.asarray(v) for k, v in dp.items()},
                prefill=np.asarray(y0), decode=np.concatenate(steps, 1),
                conv=np.asarray(cache["conv"], np.float32),
                state=np.asarray(cache["state"]))


def _jax_step(c):
    """``tests/test_dp_manual.py``'s single-device step, microbatches 1."""
    from repro.models import build_model
    from repro.train.optimizer import init_adamw
    from repro.train.train_step import (TrainState, TrainStepConfig,
                                        make_train_step)
    from repro_torch.models.convert import named_from_tree
    cfg = _jax_config(c["arch"], c["overrides"])
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
    """``repro``'s single-device prefill and greedy decode in fp32 over an
    fp32 K/V cache: the logits of every step (the prefill's last position
    first), the greedy tokens and the cache."""
    from repro.models import build_model
    model = build_model(_jax_config(c["arch"], c["overrides"]))
    params = model.init(jax.random.PRNGKey(1))
    prompts = jnp.asarray(c["prompts"].astype(np.int32))
    Bp, Sp = prompts.shape
    cache = model.init_cache(Bp, c["max_len"], kv_dtype=jnp.float32)
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
                cache={k: np.asarray(v, np.float32)
                       for k, v in cache.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    workdir = tmp_path_factory.mktemp("ssm_ranks")
    inputs = dict(
        ssm_attn=_attn_inputs(), ssm_mixer=_mixer_inputs(),
        ssm_archs=_step_inputs(), ssm_step_runs=STEP_RUNS,
        ssm_restore_from=RESTORE_FROM, ssm_serve=_serve_inputs(),
        ssm_serve_runs={t: list(SERVE) for t in SERVE_MESHES},
        step_config=TrainStepConfig(remat_policy="dots", dp_manual=True,
                                    optimizer=AdamWConfig()))
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jobs = {"1x2": ["ssm_pieces", "ssm_step", "ssm_serve"],
            "1x4": ["ssm_pieces", "ssm_step", "ssm_serve"],
            "2x2": ["ssm_step", "ssm_serve"], "1x1": ["ssm_step"]}
    procs = {t: spawn_ranks(workdir, t, j, module="_torch_tp_ranks")
             for t, j in jobs.items()}
    try:
        refs = dict(
            attn={k: _jax_attention(c)
                  for k, c in inputs["ssm_attn"].items()},
            mixer={k: _jax_mixer(c) for k, c in inputs["ssm_mixer"].items()},
            step={k: _jax_step(inputs["ssm_archs"][k]) for k in STEP_ARCHS},
            serve={k: _jax_greedy(c)
                   for k, c in inputs["ssm_serve"].items()})
    finally:
        for t in jobs:
            join_ranks(procs[t])
    second = {t: spawn_ranks(workdir, t, ["ssm_restore"],
                             module="_torch_tp_ranks") for t in RESTORE_FROM}
    for t in second:
        join_ranks(second[t])
    return workdir, refs, inputs


# ---- no ranks ---------------------------------------------------------------

@pytest.mark.parametrize("shards", (2, 4, 8))
def test_torch_rank_heads_cover_every_head(shards):
    """For every config with attention, ``rank_heads`` over ``shards``
    model ranks gives every real head to exactly one rank, and each slot
    reads the kv head of its group: a real head's group is k0 plus its
    slot's ``kv`` index, the ``kv`` indices run over [0, k1 - k0) in
    order; the ``q`` work ranges cover the heads' columns once, the
    ``kv`` ranges every real kv head; straddling slices (hymba at every
    model axis past 1) are not ``uniform``.  For every config with an SSM
    the ``ssm_heads`` ranges cover its heads once, whole, and the ranks'
    counts differ by at most one."""
    from repro_torch.configs import get_config, list_configs
    from repro_torch.models import layers as ll
    straddle = []
    for arch in list_configs():
        cfg = get_config(arch)
        if cfg.ssm_state_dim:
            ranges = [ll.ssm_heads(cfg, shards, r) for r in range(shards)]
            assert [a for a, _ in ranges][1:] == [b for _, b in ranges][:-1]
            assert ranges[0][0] == 0 and ranges[-1][1] == cfg.ssm_num_heads
            sizes = [b - a for a, b in ranges]
            assert max(sizes) - min(sizes) <= 1 and min(sizes) > 0, arch
            runs = [ll.work_runs(cfg, "ssm.conv_w", shards, r)
                    for r in range(shards)]
            din = cfg.d_inner
            assert all(run[-1] == (din, ll._model_size(cfg, "conv"))
                       for run in runs)
        if not cfg.uses_attention:
            continue
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        G = H // K
        parts = [ll.rank_heads(cfg, shards, r) for r in range(shards)]
        assert sorted(h for rh in parts for h in rh.heads) == list(range(H))
        for rh in parts:
            assert len(rh.kv) == rh.count
            assert list(rh.kv) == sorted(rh.kv)
            assert set(rh.kv) == set(range(rh.k1 - rh.k0))
            for s, h in zip(rh.slots, rh.heads):
                assert h // G == rh.k0 + rh.kv[s], (arch, rh)
            if not rh.uniform:
                straddle.append(arch)
        q = sorted(run for r in range(shards)
                   for run in ll.work_runs(cfg, "attn.wq", shards, r))
        assert [a for a, _ in q][1:] == [b for _, b in q][:-1]
        assert q[0][0] == 0 and q[-1][1] == H * hd
        kv = {c for r in range(shards)
              for a, b in ll.work_runs(cfg, "attn.wk", shards, r)
              for c in range(a, b)}
        assert kv == set(range(K * hd)), arch
    assert sorted(set(straddle)) == ["hymba-1.5b"]


def _split_norm(x, scale, parts, dy, eps):
    """``ops.rmsnorm_split`` over ``parts`` column ranges of ``x``, each in
    a thread of its own standing in for a model rank, the sum over the
    ranks a barrier: each rank's output and its x and scale gradients."""
    from repro_torch.kernels import ops
    n = len(parts)
    barrier = threading.Barrier(n)
    slots = [None] * n
    out = [None] * n

    def reduce(i):
        def fn(t):
            slots[i] = t
            barrier.wait()
            total = sum(slots[j] for j in range(n))
            barrier.wait()
            return total
        return fn

    def rank(i):
        a, b = parts[i]
        xi = x[:, a:b].clone().requires_grad_(True)
        si = scale[a:b].clone().requires_grad_(True)
        y = ops.rmsnorm_split(xi, si, d_full=x.shape[1], reduce=reduce(i),
                              eps=eps)
        y.backward(dy[:, a:b])
        out[i] = (y.detach(), xi.grad, si.grad)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [torch.cat([o[k] for o in out], dim=-1) for k in range(3)]


@pytest.mark.parametrize("parts", ([(0, 48)], [(0, 32), (32, 48)],
                                   [(0, 20), (20, 36), (36, 48)],
                                   [(0, 12), (12, 24), (24, 36), (36, 48)]))
def test_torch_rmsnorm_split_matches_whole_row(parts):
    """The split-row rmsnorm's plain twin over 1 to 4 column parts (each
    a thread, the sums over the parts a barrier): the joined output, x's
    gradient and the scale's equal ``repro``'s whole-row ``ref.rmsnorm``
    and its ``jax.vjp`` in fp32; the part's norm over its own columns
    alone (the local sum of squares) is off whenever the row is split."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    r = np.random.default_rng(35)
    x, scale, dy = (_normal(r, (6, 48)), 1.0 + _normal(r, (48,), 0.3),
                    _normal(r, (6, 48)))
    eps = 1e-5
    want, vjp = jax.vjp(lambda x, s: jref.rmsnorm(x, s, eps),
                        jnp.asarray(x), jnp.asarray(scale))
    dx, dscale = vjp(jnp.asarray(dy))
    y, gx, gs = _split_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            parts, torch.from_numpy(dy), eps)
    _close(y.numpy(), np.asarray(want), 1e-6, "y")
    _close(gx.numpy(), np.asarray(dx), 1e-5, "dx")
    _close(gs.numpy(), np.asarray(dscale), 1e-5, "dscale")
    local = torch.cat([ref.rmsnorm(torch.from_numpy(x[:, a:b]),
                                   torch.from_numpy(scale[a:b]), eps)
                       for a, b in parts], dim=-1)
    err = float(np.max(np.abs(local.numpy() - np.asarray(want))))
    assert (err > 1e-3) == (len(parts) > 1), err


def test_torch_model_axis_covers_ssm_families():
    """``check_model_axis`` lets every family run under a model axis of 2
    and 4: the ssm and hybrid families, and the vlm and encdec, which it
    no longer refuses; ``MODEL_AXIS_FAMILIES`` names all six."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import stack as stk
    from jax.sharding import AbstractMesh
    assert set(stk.MODEL_AXIS_FAMILIES) == {"dense", "moe", "ssm", "hybrid",
                                            "vlm", "encdec"}
    for n in (2, 4):
        with use_rules(AbstractMesh((1, n), ("data", "model")),
                       rules_for("train")):
            for arch in ("mamba2-780m", "hymba-1.5b", "qwen2-0.5b",
                         "granite-moe-3b-a800m", "phi-3-vision-4.2b",
                         "whisper-large-v3"):
                stk.check_model_axis(get_config(arch))


# ---- the pieces -------------------------------------------------------------

@pytest.mark.parametrize("world", PIECE_WORLDS)
@pytest.mark.parametrize("case", list(ATTN))
def test_torch_attention_straddle_matches_jax(ranks, case, world):
    """Attention split by padded heads whose slices straddle GQA groups
    (hymba's 25 / 5, with and without its window and sinks; 15 / 3 at
    model 2) or hold padding only (15 / 3 at model 4, rank 3): the output
    on every rank and the gradients of x and of every weight (summed over
    the ranks) equal ``repro``'s unsharded attention."""
    workdir, refs, _ = ranks
    ref = refs["attn"][case]
    res = rank_results(workdir, "ssm_pieces", f"1x{world}")
    for r in res:
        got = r["attn", case]
        _close(got["y"], ref["y"], what="y")
        _close(got["dx"], ref["dx"], what="dx")
        for k, v in ref["grads"].items():
            _close(got["grads"][k], v, what=k)
    heads = [r["attn", case]["heads"] for r in res]
    if case.startswith("hymba"):
        assert not any(h.uniform for h in heads)
    if case == "h15" and world == 4:
        assert heads[3].heads == () and heads[3].plan == (4, 5)


@pytest.mark.parametrize("world", PIECE_WORLDS)
@pytest.mark.parametrize("case", list(MIXER))
def test_torch_ssm_mixer_split_matches_jax(ranks, case, world):
    """The SSM mixer split by whole SSD heads (uneven for 5 heads): the
    output on every rank and the gradients of x and of every leaf (summed
    over the ranks) equal ``repro``'s ``ssm``; the forward issues two
    all-reduces (the gate norm's sum of squares, the output's sum), the
    backward two more (x's gradient, the norm's second sum)."""
    workdir, refs, _ = ranks
    ref = refs["mixer"][case]
    res = rank_results(workdir, "ssm_pieces", f"1x{world}")
    for r in res:
        got = r["ssm", case]
        _close(got["y"], ref["y"], what="y")
        _close(got["dx"], ref["dx"], what="dx")
        for k, v in ref["grads"].items():
            _close(got["grads"][k], v, what=k)
        assert got["forward"] == {"all_reduce": 2}
        assert got["backward"] == {"all_reduce": 4}
    sizes = [b - a for a, b in (r["ssm", case]["heads"] for r in res)]
    nh = 8 if case == "mamba2" else 5
    assert sum(sizes) == nh and max(sizes) - min(sizes) <= 1
    assert (len(set(sizes)) > 1) == (case == "uneven5")


@pytest.mark.parametrize("world", PIECE_WORLDS)
@pytest.mark.parametrize("case", list(MIXER))
def test_torch_ssm_decode_split_matches_jax(ranks, case, world):
    """Prefill and four decode steps of the split mixer, each rank over
    its cache of its heads: every output equals ``repro``'s, each rank's
    SSD state its head slice of ``repro``'s and its conv tail ``repro``'s
    x channels of its heads and every B / C channel."""
    workdir, refs, inputs = ranks
    ref = refs["mixer"][case]
    cfg = _jax_config("mamba2-780m", inputs["ssm_mixer"][case]["overrides"])
    hd, din = cfg.ssm_head_dim, cfg.d_inner
    for r in rank_results(workdir, "ssm_pieces", f"1x{world}"):
        got = r["ssm", case]
        h0, h1 = got["heads"]
        _close(got["prefill"], ref["prefill"], what="prefill")
        _close(got["decode"], ref["decode"], DECODE_RTOL, "decode")
        _close(got["state"], ref["state"][:, h0:h1], DECODE_RTOL, "state")
        conv = np.concatenate([ref["conv"][..., h0 * hd:h1 * hd],
                               ref["conv"][..., din:]], -1)
        assert got["conv"].shape == conv.shape
        _close(got["conv"], conv, CONV_RTOL, "conv")


# ---- the step ---------------------------------------------------------------

@pytest.mark.parametrize("arch", list(STEP_ARCHS))
@pytest.mark.parametrize("tag", STEP_MESHES)
def test_torch_ssm_axis_step_matches_jax(ranks, tag, arch):
    """One ``dp_manual`` step of reduced mamba2 and hymba (25 / 5 heads:
    straddling slices) on a state built on the storage plan: against
    ``repro``'s single-device step (parameters within 5e-3, loss within
    2%, grad norm within 1%, every first moment's cosine), against the
    port's own
    world-1 step to the tight bounds, the residual stream left
    whole (no ``seq_res`` for these families), every leaf bit-equal
    across the model ranks, the bytes held equal to the shards'; the
    model-axis sum covers exactly the leaves stored whole whose gradient
    differed across the model ranks before it (``in_B`` / ``in_C``, the
    heads' leaves whole where the guard dropped their dim)."""
    workdir, refs, _ = ranks
    ref = refs["step"][arch]
    res = rank_results(workdir, "ssm_step", tag)
    got = res[0][arch]
    assert got["path"] == "dp_manual" and got["sp"] is None
    worst = max(float(np.max(np.abs(got["params"][k] - v)))
                for k, v in ref["params"].items())
    assert worst < REF_PARAM_ATOL, worst
    assert abs(ref["loss"] - got["loss"]) < REF_LOSS_REL * ref["loss"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) < \
        REF_NORM_REL * ref["grad_norm"]
    for k, v in ref["mu"].items():
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= REF_MU_COSINE, k
    one = rank_results(workdir, "ssm_step", "1x1")[0][arch]
    assert abs(got["loss"] - one["loss"]) <= \
        TIGHT_LOSS_REL * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= \
        TIGHT_NORM_REL * one["grad_norm"]
    for k, v in one["mu"].items():
        assert float(np.max(np.abs(got["mu"][k] - v))) <= \
            TIGHT_MU_OF_MAX * float(np.max(np.abs(v))), k
        if np.any(v):
            assert _cosine(v, got["mu"][k]) >= TIGHT_COSINE, k
    assert one["partial"] == one["summed"] == one["differ"] == []
    for group in _model_groups(tag):
        for rank in group[1:]:
            other = res[rank][arch]
            for k, v in res[group[0]][arch]["params"].items():
                assert other["params"][k].tobytes() == v.tobytes(), (rank, k)
            assert other["loss"] == res[group[0]][arch]["loss"]
    split = {k for k, dims in got["plan"].items()
             if any("model" in axes for axes in dims.values())}
    partial = set(got["partial"])
    assert {k for k in partial if k.endswith((".in_B", ".in_C"))} == \
        {k for k in got["params"] if k.endswith((".in_B", ".in_C"))}
    for r in res:
        assert r[arch]["held"] == r[arch]["shards"]
        assert set(r[arch]["summed"]) == partial
        assert set(r[arch]["differ"]) - split == partial


def test_torch_ssm_axis_step_compressed(ranks):
    """Hymba's step on (2, 2) with int8 error-feedback compression: the
    error feedback lives on the shards (each leaf's the shape of its
    parameter's shard), the bytes held count it, and loss, grad norm and
    every first moment agree with the port's compressed world-1 step to
    the tight bounds, every leaf bit-equal across the model ranks."""
    from repro_torch.train.train_step import stacked_name
    workdir, _, _ = ranks
    res = rank_results(workdir, "ssm_step", COMPRESSED_MESH)
    one = rank_results(workdir, "ssm_step", "1x1")[0][COMPRESSED]
    got = res[0][COMPRESSED]
    assert got["path"] == "dp_manual"
    assert abs(got["loss"] - one["loss"]) <= \
        TIGHT_LOSS_REL * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= \
        COMPRESS_NORM_REL * one["grad_norm"]
    for k, v in one["mu"].items():
        # plus one int8 quantum of the stacked leaf's scale, times 1 - b1
        # (test_torch_seq_axis's bound): a value on a rounding edge
        amax = max(float(np.max(np.abs(one["mu"][n]))) for n in one["mu"]
                   if stacked_name(n) == stacked_name(k))
        assert float(np.max(np.abs(got["mu"][k] - v))) <= \
            amax / 127 + TIGHT_MU_OF_MAX * float(np.max(np.abs(v))), k
    for r in res:
        assert r[COMPRESSED]["err_shapes"] == r[COMPRESSED]["shapes"]
        assert r[COMPRESSED]["held"] == r[COMPRESSED]["shards"]
    for group in _model_groups(COMPRESSED_MESH):
        for rank in group[1:]:
            for k, v in res[group[0]][COMPRESSED]["params"].items():
                assert res[rank][COMPRESSED]["params"][k].tobytes() == \
                    v.tobytes(), (rank, k)


@pytest.mark.parametrize("src,dst", list(RESTORE_FROM.items()))
def test_torch_ssm_axis_checkpoint(ranks, src, dst):
    """A reduced mamba2 state saved on (data 2, model 2) writes the files
    and manifest a world-1 save writes; each restores on the other mesh,
    every leaf gathered back bit-equal to the bytes saved."""
    workdir, _, _ = ranks
    step = workdir / f"ckssm_{src}" / "step_00000001"
    assert sorted(os.listdir(step)) == ["arrays_p0.npz", "aux.json",
                                        "manifest.json"]
    other = workdir / f"ckssm_{dst}" / "step_00000001"
    assert (step / "manifest.json").read_text() == \
        (other / "manifest.json").read_text()
    with np.load(step / "arrays_p0.npz") as saved:
        saved = {k: saved[k] for k in saved.files}
    for r in rank_results(workdir, "ssm_restore", dst):
        assert r["aux"]["mesh"] == src
        assert r["named"].keys() == saved.keys()
        for k, v in saved.items():
            assert r["named"][k].tobytes() == v.tobytes(), k


# ---- serving ----------------------------------------------------------------

@pytest.mark.parametrize("run", list(SERVE))
@pytest.mark.parametrize("tag", SERVE_MESHES)
def test_torch_ssm_axis_serve_matches_jax(ranks, tag, run):
    """Prefill and greedy decode through ``_serve_wrap`` under the serving
    rules, in fp32 against ``repro``'s single-device prefill and decode:
    every rank's logits within 1e-4 of the largest at every step and its
    greedy tokens equal; its SSM state the head slice of ``repro``'s and
    its conv tail its channels; hymba's K/V cache cut into blocks of the
    slots, joined equal to ``repro``'s, a rank holding only the sinks and
    keys outside the window (the long prompt at model 4) or no key (the
    short prompt) adding nothing."""
    workdir, refs, inputs = ranks
    ref = refs["serve"][run]
    c = inputs["ssm_serve"][run]
    cfg = _jax_config(c["arch"], c["overrides"])
    n = int(tag.split("x")[-1])
    hd, din = cfg.ssm_head_dim, cfg.d_inner
    res = rank_results(workdir, "ssm_serve", tag)
    groups = _model_groups(tag)
    rows = len(c["prompts"]) // len(groups)
    for i, group in enumerate(groups):
        sl = slice(i * rows, (i + 1) * rows)
        want = ref["logits"][sl]
        for rank in group:
            got = res[rank][run]
            assert np.isfinite(got["logits"]).all()
            _close(got["logits"], want, SERVE_OF_MAX, "logits")
            np.testing.assert_array_equal(got["logits"].argmax(-1),
                                          ref["tokens"][sl])
            h0, h1 = got["heads"]
            assert got["ssm_shards"] == n and h1 - h0 == cfg.ssm_num_heads // n
            _close(got["ssm_state"], ref["cache"]["ssm_state"][:, sl, h0:h1],
                   DECODE_RTOL, "ssm_state")
            conv = ref["cache"]["ssm_conv"][:, sl]
            conv = np.concatenate([conv[..., h0 * hd:h1 * hd],
                                   conv[..., din:]], -1)
            _close(got["ssm_conv"], conv, CONV_RTOL, "ssm_conv")
            assert got["kv_shards"] == (n if cfg.uses_attention else 1)
        if not cfg.uses_attention:
            continue
        for name in ("k", "v"):
            union = np.concatenate([res[r][run][name] for r in group], 2)
            w = ref["cache"][name][:, sl]
            assert union.shape == w.shape
            _close(union, w, SERVE_OF_MAX, name)
