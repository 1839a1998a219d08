"""The port's model axis (``distributed/model_axis.py``, the split paths
of ``models/layers.py``, ``collective_matmul.ring_weight_matmul``, the
``dp_manual`` step and ``launch/dryrun._serve_wrap`` on (data, model)
meshes) against ``repro``'s single-device results.

The multi-rank cases run gloo ranks on the CPU, each in a process of its
own (``tests/_torch_tp_ranks.py``, spawned by ``_torch_support``), joined
through a ``FileStore`` under the test's temporary directory.  One module
fixture starts every rank of the first round at once and computes the JAX
references while they run; a second round restores the checkpoints the
first wrote.  ``repro``'s sharded paths fail while tracing here
(``tests/test_dp_manual.py``), so each piece is held against ``repro``'s
unsharded function on the same numpy-seeded inputs.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_support import join_ranks, rank_results, spawn_ranks

B, S = 8, 16
# a length no model axis here divides: the residual stream stays whole on
# every model rank (stack.sp_split gives None), the path without sequence
# parallelism
S_UNSPLIT = 15
PIECE_WORLDS = (2, 4)
ATTN = {"h4": ("qwen2-0.5b", {}),                      # 4 / 2 heads of 16
        "h14": ("qwen2-0.5b", {"num_heads": 14})}      # (2, 8) at 4
XENT = {f"v{v}_cap{c}": {"vocab_size": v, "logit_softcap": float(c)}
        for v in (256, 257) for c in (0, 30)}
MOE = {"parts4": ({}, (2, 4)),                          # reduced granite
       "e6": ({"num_experts": 6}, (2, 4))}              # parts 1, V 8 at 4
STEP_ARCHS = {"qwen2": ("qwen2-0.5b", {}),
              "qwen2_h14": ("qwen2-0.5b", {"num_heads": 14}),
              "granite": ("granite-moe-3b-a800m", {})}
# mesh tag -> batch shards R (pod x data)
STEP_MESHES = {"1x2": 1, "1x4": 1, "2x2": 2, "2x2x2": 4}
# meshes that also run granite's step with REPRO_MOE_EP=0 (the MoE whole
# on every rank, attention, MLP and vocabulary split)
EP_OFF_MESHES = ("1x2", "2x2")
UNSPLIT_ARCHS = ("qwen2", "granite")
STEP_RUNS = {**{t: [(a, 1) for a in STEP_ARCHS]
                + [("granite", 1, "ep_off")] * (t in EP_OFF_MESHES)
                + [(a, 1, "unsplit") for a in UNSPLIT_ARCHS]
                for t in STEP_MESHES},
             "1x1": [(a, r) for a in STEP_ARCHS
                     for r in sorted(set(STEP_MESHES.values()))]
             + [(a, r, "unsplit") for a in UNSPLIT_ARCHS
                for r in sorted(set(STEP_MESHES.values()))]}
SERVE_MESHES = ("1x2", "2x2x2")
RESTORE_FROM = {"1x1": "2x2", "2x2": "1x1"}
# pieces against repro in fp32: sums over the ranks in another order
PIECE_RTOL = 2e-5
# the step against the port's own world-1 step over the same microbatches
# (test_torch_dp's tight bounds: the bf16 FSDP gathers sum in another order
# at data 2)
TIGHT_LOSS_REL = 1e-6
TIGHT_NORM_REL = 2e-4
TIGHT_MU_OF_MAX = 2 ** -7
TIGHT_COSINE = 1 - 1e-5


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


# ---- inputs -----------------------------------------------------------------

def _attn_inputs():
    r = np.random.default_rng(11)
    out = {}
    for name, (arch, ov) in ATTN.items():
        cfg = _jax_config(arch, ov)
        d, nq = cfg.d_model, cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        params = {"wq": _normal(r, (d, nq), d ** -0.5),
                  "wk": _normal(r, (d, nkv), d ** -0.5),
                  "wv": _normal(r, (d, nkv), d ** -0.5),
                  "wo": _normal(r, (nq, d), nq ** -0.5),
                  "bq": _normal(r, (nq,), 0.1), "bk": _normal(r, (nkv,), 0.1),
                  "bv": _normal(r, (nkv,), 0.1)}
        out[name] = dict(arch=arch, overrides=ov, params=params,
                         x=_normal(r, (2, S, d)), dy=_normal(r, (2, S, d)),
                         worlds=PIECE_WORLDS)
    return out


def _xent_inputs():
    r = np.random.default_rng(12)
    out = {}
    for name, ov in XENT.items():
        V = ov["vocab_size"]
        targets = r.integers(0, V, (2, S))
        targets[0, :2] = V - 1          # the last real row, next to the pad
        mask = (r.uniform(size=(2, S)) > 0.2).astype(np.float32)
        out[name] = dict(overrides=ov, table=_normal(r, (V, 64), 0.5),
                         x=_normal(r, (2, S, 64)), targets=targets,
                         mask=mask)
    return out


def _moe_inputs():
    from repro.models import layers as jl
    r = np.random.default_rng(13)
    out = {}
    for name, (ov, worlds) in MOE.items():
        cfg = _jax_config("granite-moe-3b-a800m", ov)
        specs = jl.moe_specs(cfg)
        params = {k: _normal(r, s.shape, 0.02 if k == "router"
                             else s.shape[-2] ** -0.5)
                  for k, s in specs.items()}
        out[name] = dict(overrides=ov, params=params,
                         x=_normal(r, (2, S, cfg.d_model)),
                         dy=_normal(r, (2, S, cfg.d_model)), aux_weight=3.0,
                         worlds=worlds)
    return out


def _step_inputs():
    from repro.models import build_model
    out = {}
    for name, (arch, ov) in STEP_ARCHS.items():
        cfg = _jax_config(arch, ov)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        r = np.random.default_rng(0)
        out[name] = dict(
            arch=arch, overrides=ov,
            tree=_flat(jax.tree_util.tree_map(np.asarray, params)),
            batch={"tokens": r.integers(0, cfg.vocab_size, (B, S)),
                   "targets": r.integers(0, cfg.vocab_size, (B, S)),
                   "loss_mask": np.ones((B, S), np.float32)})
        out[name]["batch_unsplit"] = {
            "tokens": r.integers(0, cfg.vocab_size, (B, S_UNSPLIT)),
            "targets": r.integers(0, cfg.vocab_size, (B, S_UNSPLIT)),
            "loss_mask": np.ones((B, S_UNSPLIT), np.float32)}
    return out


# ---- references -------------------------------------------------------------

def _jax_attention(c):
    from repro.models import layers as jl
    cfg = _jax_config(c["arch"], c["overrides"])
    p = {k: jnp.asarray(v) for k, v in c["params"].items()}
    y, vjp = jax.vjp(lambda p, x: jl.attention(p, cfg, x), p,
                     jnp.asarray(c["x"]))
    dp, dx = vjp(jnp.asarray(c["dy"]))
    return dict(y=np.asarray(y), dx=np.asarray(dx),
                grads={k: np.asarray(v) for k, v in dp.items()})


def _jax_xent(c):
    from repro.models import layers as jl
    cfg = _jax_config("qwen2-0.5b", c["overrides"])

    def f(table, x):
        ce, denom = jl.unembed_xent({"tokens": table}, cfg, x,
                                    jnp.asarray(c["targets"]),
                                    jnp.asarray(c["mask"]))
        return ce, denom
    (ce, denom), vjp = jax.vjp(f, jnp.asarray(c["table"]),
                               jnp.asarray(c["x"]))
    dtable, dx = vjp((jnp.ones(()), jnp.zeros(())))
    return dict(ce=float(ce), denom=float(denom), dx=np.asarray(dx),
                dtable=np.asarray(dtable))


def _jax_moe(c):
    from repro.models import layers as jl
    cfg = _jax_config("granite-moe-3b-a800m", c["overrides"])
    p = {k: jnp.asarray(v) for k, v in c["params"].items()}

    def f(p, x):
        y, aux = jl._moe_reference(p, cfg, x)
        return (y * jnp.asarray(c["dy"])).sum() + c["aux_weight"] * aux, \
            (y, aux)
    (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        p, jnp.asarray(c["x"]))
    return dict(y=np.asarray(y), aux=float(aux), dx=np.asarray(grads[1]),
                grads={k: np.asarray(v) for k, v in grads[0].items()})


def _jax_step(c, batch="batch"):
    """``tests/test_dp_manual.py``'s single-device step, microbatches 1,
    on ``c[batch]``."""
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
                            else v) for k, v in c[batch].items()}
    state, metrics = step(TrainState(params, init_adamw(params), None),
                          batch)
    named = lambda t: named_from_tree(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), cfg.num_layers)
    return dict(params=named(state.params), mu=named(state.opt.mu),
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def _jax_serve(c):
    """``tests/test_dp_manual.py``'s single-device prefill and decode."""
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


RING_CODE = """
import pickle, sys
import jax, numpy as np
from repro.distributed.collective_matmul import ring_weight_matmul
x, w = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((4,), ("model",))
with mesh:
    out = ring_weight_matmul(jax.numpy.asarray(x), jax.numpy.asarray(w), mesh)
pickle.dump(np.asarray(out), open(sys.argv[2], "wb"))
"""


def _start_jax_ring(workdir, x, w):
    """``repro``'s ring over 4 host devices in a subprocess, as
    ``tests/test_distributed.py`` runs it."""
    src, dst = workdir / "ring_in.pkl", workdir / "ring_out.pkl"
    with open(src, "wb") as f:
        pickle.dump((x, w), f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(here, "..", "src"))
    proc = subprocess.Popen([sys.executable, "-c", RING_CODE, str(src),
                             str(dst)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, dst


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    workdir = tmp_path_factory.mktemp("tp_ranks")
    r = np.random.default_rng(14)
    steps = _step_inputs()
    serve_tree = steps["granite"]["tree"]
    inputs = dict(
        attn=_attn_inputs(), xent=_xent_inputs(), moe=_moe_inputs(),
        ring=dict(x=_normal(r, (16, 32)), w=_normal(r, (32, 64)),
                  worlds=PIECE_WORLDS),
        step_archs=steps, step_runs=STEP_RUNS,
        step_config=TrainStepConfig(remat_policy="dots", dp_manual=True,
                                    optimizer=AdamWConfig()),
        serve=dict(arch="granite-moe-3b-a800m", tree=serve_tree,
                   tokens=np.random.default_rng(0).integers(
                       0, 256, (B, S))),
        restore_from=RESTORE_FROM)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jobs = {"1x2": ["pieces", "step", "serve"], "1x4": ["pieces", "step"],
            "2x2": ["step"], "2x2x2": ["step", "serve"], "1x1": ["step"]}
    procs = {t: spawn_ranks(workdir, t, j, module="_torch_tp_ranks")
             for t, j in jobs.items()}
    ring_proc, ring_out = _start_jax_ring(workdir, inputs["ring"]["x"],
                                          inputs["ring"]["w"])
    try:
        refs = dict(
            attn={k: _jax_attention(c) for k, c in inputs["attn"].items()},
            xent={k: _jax_xent(c) for k, c in inputs["xent"].items()},
            moe={k: _jax_moe(c) for k, c in inputs["moe"].items()},
            step={k: _jax_step(c) for k, c in steps.items()},
            step_unsplit={k: _jax_step(steps[k], "batch_unsplit")
                          for k in UNSPLIT_ARCHS},
            serve=_jax_serve(inputs["serve"]))
        log = ring_proc.communicate(timeout=120)[0]
        assert ring_proc.returncode == 0, log.decode()[-2000:]
        with open(ring_out, "rb") as f:
            refs["ring"] = pickle.load(f)
    finally:
        if ring_proc.poll() is None:
            ring_proc.kill()
        for t in jobs:
            join_ranks(procs[t])
    second = {t: spawn_ranks(workdir, t, ["restore"],
                             module="_torch_tp_ranks") for t in RESTORE_FROM}
    for t in second:
        join_ranks(second[t])
    return workdir, refs, inputs


# ---- no ranks ---------------------------------------------------------------

@pytest.mark.parametrize("shards", (1, 2, 4, 8, 16))
def test_torch_pad_plan_matches_jax(shards):
    """``_pad_plan`` equals ``repro``'s for every config; ``rank_heads``
    gives every real head to exactly one rank, its slices straddling GQA
    groups (not ``uniform``) for hymba alone, at every model axis past
    1."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import list_configs
    from repro.models import layers as jl
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ll
    straddle = []
    for arch in list_configs():
        jc, cfg = jget(arch), get_config(arch)
        if not cfg.num_heads:
            continue
        H, K = cfg.num_heads, cfg.num_kv_heads
        assert ll._pad_plan(H, K, shards) == jl._pad_plan(H, K, shards), arch
        assert (jc.num_heads, jc.num_kv_heads) == (H, K)
        parts = [ll.rank_heads(cfg, shards, r) for r in range(shards)]
        if not all(rh.uniform for rh in parts):
            straddle.append(arch)
        heads = [h for rh in parts for h in rh.heads]
        assert sorted(heads) == list(range(H)), arch
        for rh in parts:
            K2, G2 = rh.plan
            assert rh.count * shards == K2 * G2
            assert len(rh.slots) == len(rh.heads)
            assert all(h // (H // K) in range(rh.k0, rh.k1)
                       for h in rh.heads)
    assert straddle == ([] if shards == 1 else ["hymba-1.5b"])


def test_torch_backend_rule():
    """Collectives stage through the host only for gloo on a CUDA tensor."""
    from repro_torch.distributed.transport import stages_through_host
    assert stages_through_host("gloo", "cuda")
    assert not stages_through_host("gloo", "cpu")
    assert not stages_through_host("nccl", "cuda")
    assert not stages_through_host("nccl", "cpu")


@pytest.mark.parametrize("arch,family", [
    ("mamba2-780m", "ssm"), ("hymba-1.5b", "hybrid"),
    ("phi-3-vision-4.2b", "vlm"), ("whisper-large-v3", "encdec")])
def test_torch_model_axis_refuses_family(arch, family):
    """Under a model axis of 2 every family (ssm, hybrid, and since the
    model axis covers them the vlm and encdec too) gives the loss it
    gives under a model axis of 1 (outside the manual region every rank
    computes whole); under a model axis of 1 they all run."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.lm import build_model, param_specs
    from repro_torch.models.module import init_params
    cfg = reduced(get_config(arch))
    model = build_model(cfg, init_params(
        param_specs(cfg), torch.Generator().manual_seed(0)), device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long),
             "targets": torch.zeros((2, 8), dtype=torch.long)}
    if cfg.encoder_layers:
        batch["frames"] = torch.zeros((2, cfg.max_source_positions,
                                       cfg.d_model))
    with use_rules(AbstractMesh((2, 1), ("data", "model")),
                   rules_for("train")):
        one = model.loss(batch)[0]
        assert torch.isfinite(one)
    with use_rules(AbstractMesh((1, 2), ("data", "model")),
                   rules_for("train")):
        two = model.loss(batch)[0]
        assert abs(float(two) - float(one)) <= PIECE_RTOL * abs(float(one))


# ---- the pieces -------------------------------------------------------------

def _close(got, want, rtol=PIECE_RTOL, what=""):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("world", PIECE_WORLDS)
@pytest.mark.parametrize("case", list(ATTN))
def test_torch_attention_split_matches_jax(ranks, case, world):
    """Attention split by padded heads over the model ranks: the output on
    every rank and the gradients of x and of every weight (summed over
    the ranks) equal ``repro``'s unsharded attention; 14 / 2 heads pad to
    (2, 8) at model 4, and a pad head adds no gradient."""
    workdir, refs, _ = ranks
    ref = refs["attn"][case]
    res = rank_results(workdir, "pieces", f"1x{world}")
    for r in res:
        got = r["attn", case]
        _close(got["y"], ref["y"], what="y")
        _close(got["dx"], ref["dx"], what="dx")
        for k, v in ref["grads"].items():
            _close(got["grads"][k], v, what=k)
    plans = [r["attn", case]["heads"].plan for r in res]
    assert plans == [(2, 8) if case == "h14" and world == 4
                     else (2, {"h4": 2, "h14": 7}[case])] * world


@pytest.mark.parametrize("case", list(XENT))
@pytest.mark.parametrize("world", PIECE_WORLDS)
def test_torch_xent_split_matches_jax(ranks, world, case):
    """The vocab-split cross-entropy (V 257 pads to 258 / 260): the loss
    on every rank and the gradients of x and of the table (summed over
    the ranks) equal ``repro``'s dense cross-entropy."""
    workdir, refs, _ = ranks
    ref = refs["xent"][case]
    for r in rank_results(workdir, "pieces", f"1x{world}"):
        got = r["xent", case]
        assert abs(got["ce"] - ref["ce"]) <= PIECE_RTOL * abs(ref["ce"])
        assert got["denom"] == ref["denom"]
        _close(got["dx"], ref["dx"], what="dx")
        _close(got["dtable"], ref["dtable"], what="dtable")


@pytest.mark.parametrize("world", PIECE_WORLDS)
@pytest.mark.parametrize("case", list(MOE))
def test_torch_moe_ep_matches_jax(ranks, case, world):
    """The expert-parallel MoE (reduced granite: parts 4, 16 virtual
    experts; a 6-expert variant: parts 1, at model 4 eight virtual slots
    with two replicas): output, aux and every gradient (the experts'
    summed over the ranks) equal ``repro``'s ``_moe_reference``; the
    forward issues the combine's one all-reduce."""
    workdir, refs, _ = ranks
    ref = refs["moe"][case]
    for r in rank_results(workdir, "pieces", f"1x{world}"):
        got = r["moe", case]
        _close(got["y"], ref["y"], what="y")
        assert abs(got["aux"] - ref["aux"]) <= PIECE_RTOL * abs(ref["aux"])
        _close(got["dx"], ref["dx"], what="dx")
        for k, v in ref["grads"].items():
            _close(got["grads"][k], v, what=k)
        assert got["forward_collectives"] == {"all_reduce": 1}


@pytest.mark.parametrize("world", PIECE_WORLDS)
def test_torch_ring_weight_matmul(ranks, world):
    """Each rank's rows of ``ring_weight_matmul`` equal x @ w and
    ``repro``'s ring over 4 host devices; n - 1 ring steps."""
    workdir, refs, inputs = ranks
    x, w = inputs["ring"]["x"], inputs["ring"]["w"]
    res = rank_results(workdir, "pieces", f"1x{world}")
    got = np.concatenate([r["ring"]["rows"] for r in res])
    np.testing.assert_allclose(got, x @ w, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, refs["ring"], rtol=0, atol=1e-4)
    assert all(r["ring"]["send_recv"] == world - 1 for r in res)


# ---- the step ---------------------------------------------------------------

def _cosine(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _model_groups(tag):
    """Global ranks of each model group, rank = batch shard * n + model."""
    n = int(tag.split("x")[-1])
    total = int(np.prod([int(d) for d in tag.split("x")]))
    return [list(range(i, i + n)) for i in range(0, total, n)]


def _check_step(ranks, tag, arch, run):
    """Run ``run`` of ``arch``'s step on mesh ``tag`` against ``repro``'s
    single-device step and the port's world-1 step; every leaf, gathered
    from its shards, bit-equal across the model ranks; the model-axis sum
    covers exactly the leaves stored whole and used in part, which are
    exactly the leaves stored whole whose gradient differed across the
    model ranks before it; every collective counted and moved as the
    backend rule says (gloo on CPU tensors: directly).  A run tagged
    ``"unsplit"`` takes the batch of S_UNSPLIT tokens, which no model
    axis here divides, so the residual stream stays whole."""
    workdir, refs, _ = ranks
    unsplit = "unsplit" in run[2:]
    ref = refs["step_unsplit" if unsplit else "step"][arch]
    res = rank_results(workdir, "step", tag)
    got = res[0][run]
    n = int(tag.split("x")[-1])
    # sequence parallelism where the length divides the model axis
    # (stack.sp_split): the residual stream's tokens are split over the
    # model ranks, so the norms' scales and the expert-parallel router are
    # used in part too
    sp = (S_UNSPLIT if unsplit else S) % n == 0
    assert got["path"] == "dp_manual"
    assert got["sp"] == (n if sp else None)
    worst = max(float(np.max(np.abs(got["params"][k] - v)))
                for k, v in ref["params"].items())
    assert worst < 5e-3, worst
    assert abs(ref["loss"] - got["loss"]) < 0.02 * ref["loss"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) < 5e-3
    one = rank_results(workdir, "step", "1x1")[0][
        (arch, STEP_MESHES[tag]) + ("unsplit",) * unsplit]
    assert one["sp"] is None
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
    ep = "ep_off" not in run[2:]
    partial = set(got["partial"])
    # the leaves stored split over the model ranks hold their shard's
    # complete gradient; only those stored whole and used in part are summed
    split = {k for k, dims in got["plan"].items()
             if any("model" in axes for axes in dims.values())}
    for k in got["params"]:
        group, leaf = k.split(".")[-2:]
        used_in_part = group in ("attn", "mlp") or (
            ep and group == "moe" and (leaf != "router" or sp)) \
            or k == "embed.tokens" or (
                sp and group in ("ln1", "ln2", "final_norm"))
        assert (k in partial) == (used_in_part and k not in split), k
    for r in res:
        assert set(r[run]["summed"]) == partial
        assert set(r[run]["differ"]) - split == partial
    assert one["partial"] == one["summed"] == one["differ"] == []
    # the data-parallel reductions as at model 1 over the manual axes
    # larger than one rank (none over a data axis of 1), one model-axis sum
    # per partial leaf and the grad norm's sum over the model ranks
    manual = {"1x2": 0, "1x4": 0, "2x2": 1, "2x2x2": 2}[tag]
    batch_planned = [k for k, dims in got["plan"].items()
                     if any(a != "model" for axes in dims.values()
                            for a in axes)]
    assert got["collectives"]["all_reduce"] == \
        manual * (len(got["params"]) + 5) \
        - (len(batch_planned) if manual else 0) + len(partial) + 1
    assert got["moved"] == {"direct": sum(got["collectives"].values())
                            + sum(got["model_collectives"].values())}


@pytest.mark.parametrize("arch", list(STEP_ARCHS))
@pytest.mark.parametrize("tag", list(STEP_MESHES))
def test_torch_model_axis_step(ranks, tag, arch):
    """One ``dp_manual`` step on a (pod, data, model) mesh: against
    ``repro``'s single-device step with ``tests/test_dp_manual.py``'s
    tolerances (parameters within 5e-3, loss within 2%, grad norm within
    5e-3), against the port's own world-1 step over the same microbatches
    to the tight bounds, every leaf bit-equal across the model ranks; the
    model-axis sum covers exactly the leaves used in part."""
    _check_step(ranks, tag, arch, (arch, 1))


@pytest.mark.parametrize("tag", EP_OFF_MESHES)
def test_torch_model_axis_step_moe_ep_off(ranks, tag):
    """Granite's step with ``REPRO_MOE_EP=0``: the MoE computed whole on
    every model rank while attention, the MLP and the vocabulary split,
    held as above; the expert leaves are not summed over the model
    ranks."""
    _check_step(ranks, tag, "granite", ("granite", 1, "ep_off"))


@pytest.mark.parametrize("arch", UNSPLIT_ARCHS)
@pytest.mark.parametrize("tag", list(STEP_MESHES))
def test_torch_model_axis_step_unsplit(ranks, tag, arch):
    """The step at a length no model axis here divides (15 tokens), where
    the residual stream stays whole on every model rank and only
    attention, the MLP or MoE and the vocabulary split: held as above
    against ``repro``'s single-device step and the port's world-1 step on
    the same 15 tokens; the norms' scales and the router are not summed
    over the model ranks."""
    _check_step(ranks, tag, arch, (arch, 1, "unsplit"))


# ---- serving and the checkpoint ---------------------------------------------

@pytest.mark.parametrize("tag", SERVE_MESHES)
def test_torch_serve_wrap_matches_jax(ranks, tag):
    """Reduced granite's prefill and a decode step through ``_serve_wrap``
    (attention split by heads, the expert-parallel MoE, logits split by
    vocabulary rows and gathered) on each rank's rows: every rank's
    logits within ``tests/test_dp_manual.py``'s 0.05 of ``repro``'s
    single-device logits for its rows, equal across the model ranks."""
    workdir, refs, _ = ranks
    ref = refs["serve"]
    res = rank_results(workdir, "serve", tag)
    shards = len(_model_groups(tag))
    n = B // shards
    for i, group in enumerate(_model_groups(tag)):
        rows = slice(i * n, (i + 1) * n)
        for rank in group:
            for k in ("prefill", "decode"):
                d = float(np.max(np.abs(res[rank][k] - ref[k][rows])))
                assert d < 0.05, (rank, k, d)
                np.testing.assert_array_equal(res[rank][k],
                                              res[group[0]][k])


@pytest.mark.parametrize("src,dst", list(RESTORE_FROM.items()))
def test_torch_model_axis_checkpoint(ranks, src, dst):
    """A state saved on (data 2, model 2) writes the files and manifest a
    world-1 save of the same arch writes (model rank 0 writes the model
    replicas once); each restores on the other mesh, every leaf gathered
    back bit-equal to the bytes saved."""
    workdir, _, _ = ranks
    step = workdir / f"ck_{src}" / "step_00000001"
    assert sorted(os.listdir(step)) == ["arrays_p0.npz", "aux.json",
                                        "manifest.json"]
    other = workdir / f"ck_{dst}" / "step_00000001"
    assert (step / "manifest.json").read_text() == \
        (other / "manifest.json").read_text()
    with np.load(step / "arrays_p0.npz") as saved:
        saved = {k: saved[k] for k in saved.files}
    for r in rank_results(workdir, "restore", dst):
        assert r["aux"]["mesh"] == src
        assert r["named"].keys() == saved.keys()
        for k, v in saved.items():
            assert r["named"][k].tobytes() == v.tobytes(), k
