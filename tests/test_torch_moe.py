"""The port's MoE family on the CPU against the JAX package: the router,
the dispatch tables and the expert products, then reduced granite-moe and
mixtral (its ring cache) through the loss, its gradients, prefill, decode
and the engine.

Inputs are made from a seed with numpy; parameters are ``repro``'s,
carried across by ``from_jax_params``.  fp32 compute (tests/conftest.py).
Three configurations: reduced granite and reduced mixtral have 4 experts,
so both take the virtual (V, d, f/parts) layout with parts = 4, and
capacity 4.0, which drops nothing; ``granite_e16`` (16 experts, top 4,
capacity 1.25) takes the plain (E, d, f) layout and drops assignments,
as full-width granite does on the card.  Which assignment loses its slot
follows the stable sort's order, so the integer tables are held exactly;
gates, aux losses and outputs to atol = rtol 1e-5; the model's logits to
1e-4, the bf16 K/V cache to one bf16 ulp and the gradients to rtol 1e-4
with a floor of 1e-5 of each leaf's largest entry, as
tests/test_torch_models.py and tests/test_torch_train.py hold the dense
family.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, long_tensor
from repro.models import layers as jll
from repro_torch.models import layers as tll
from repro_torch.models import stack as tstack

ROOT = Path(__file__).resolve().parents[1]

# name -> (arch, overrides of the reduced config)
CONFIGS = {
    "granite": ("granite-moe-3b-a800m", {}),
    "mixtral": ("mixtral-8x22b", {}),
    "granite_e16": ("granite-moe-3b-a800m",
                    dict(num_experts=16, experts_per_token=4,
                         capacity_factor=1.25)),
}


def _configs(arch, **over):
    from repro.configs import get_config, reduced
    from repro_torch.configs import get_config as port_config
    from repro_torch.configs import reduced as port_reduced
    return (dataclasses.replace(reduced(get_config(arch)), **over),
            dataclasses.replace(port_reduced(port_config(arch)), **over))


def _models(name, seed=0):
    """(jax model, jax params, numpy tree, port model, jax cfg, port cfg)."""
    from repro.models import build_model
    from repro_torch.models.convert import from_jax_params
    arch, over = CONFIGS[name]
    jcfg, tcfg = _configs(arch, **over)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, tree, from_jax_params(tcfg, tree, device="cpu"), \
        jcfg, tcfg


def _close(out, expect, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(as_f32(out), as_f32(expect), atol=atol,
                               rtol=rtol)


def _close_cache(tc, jc):
    assert tc.dtype == torch.bfloat16 and tuple(tc.shape) == jc.shape
    np.testing.assert_allclose(as_f32(tc), as_f32(jc), rtol=2 ** -7,
                               atol=1e-6)


# ---- the layer's parts, on one layer's parameters ---------------------------

# (parts, capacity factor): reduced granite's virtual layout and the plain
# layout of 16 experts, each dropless and at the published 1.25
LAYER_CASES = [(4, 4.0), (4, 1.25), (1, 4.0), (1, 1.25)]
# (B, S): a prefill and a decode batch, whose capacities differ
SHAPES = [(2, 24), (4, 1)]


def _layer(parts, capacity_factor):
    """One MoE layer's parameters in both packages and the configs."""
    over = dict(capacity_factor=capacity_factor)
    if parts == 1:
        over.update(num_experts=16, experts_per_token=4)
    jcfg, tcfg = _configs("granite-moe-3b-a800m", **over)
    assert jll._moe_parts(jcfg) == tll._moe_parts(tcfg) == parts
    specs = jll.moe_specs(jcfg)
    from repro.models.module import init_params
    jp = init_params(specs, jax.random.PRNGKey(parts))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(B, S, d, seed=7):
    """Standard-normal tokens plus one shared direction of norm ~2 sqrt(d),
    as activations share a mean: the router's choices are skewed, so
    capacity 1.25 drops in every case here (centred tokens at the
    router's init scale load the experts too evenly to drop)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, S, d)) + 2.0 * rng.standard_normal(d)
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("parts", [4, 1])
def test_torch_moe_specs_and_dense_expert_weights_match_jax(parts):
    """The layer's spec tree, and the un-virtualised (E, d, f) weights
    equal JAX's exactly (a pure permutation)."""
    jcfg, tcfg, jp, tp = _layer(parts, 1.25)
    jspecs, tspecs = jll.moe_specs(jcfg), tll.moe_specs(tcfg)
    assert set(jspecs) == set(tspecs) == {"router", "wi", "wg", "wo"}
    for k, js in jspecs.items():
        ts = tspecs[k]
        assert (ts.shape, ts.init, ts.scale, ts.fan_in_dims) == \
            (js.shape, js.init, js.scale, js.fan_in_dims)
    for jw, tw in zip(jll._dense_expert_weights(jp, jcfg),
                      tll._dense_expert_weights(tp, tcfg)):
        assert tuple(tw.shape) == jw.shape
        np.testing.assert_array_equal(as_f32(tw), as_f32(jw))


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("parts,capacity_factor", LAYER_CASES)
def test_torch_moe_route_matches_jax(parts, capacity_factor, B, S):
    jcfg, tcfg, jp, tp = _layer(parts, capacity_factor)
    jx, tx = _x(B * S, 1, jcfg.d_model)
    jg, je, jaux = jll._route(jp, jcfg, jx[:, 0])
    tg, te, taux = tll._route(tp, tcfg, tx[:, 0])
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert bool((tg[:, :-1] >= tg[:, 1:]).all())       # descending
    _close(tg, jg)
    _close(taux, jaux)
    assert taux.dtype == torch.float32 and taux.dim() == 0


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("parts,capacity_factor", LAYER_CASES)
def test_torch_moe_tables_match_jax(parts, capacity_factor, B, S):
    """The sorted assignments and the slot tables, from JAX's routing: the
    integer tables exactly, and capacity 1.25 really drops assignments."""
    jcfg, tcfg, jp, _ = _layer(parts, capacity_factor)
    jx, _ = _x(B, S, jcfg.d_model)
    T, E, K = B * S, jcfg.num_experts, jcfg.experts_per_token
    jg, je, _ = jll._route(jp, jcfg, jx.reshape(T, -1))
    jsorted = jll._sorted_assignments(jg, je, T, E)
    tsorted = tll._sorted_assignments(torch.tensor(np.asarray(jg)),
                                      long_tensor(je), T, E)
    for name, j, t in zip(("se", "sg", "st", "pos_in_e"), jsorted, tsorted):
        if name == "sg":
            _close(t, j, atol=0, rtol=0)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    C = max(min(int(np.ceil(T * K / E * capacity_factor)), T), 1)
    se, sg, st, pos = jsorted
    jtok, jgate, jused = jll._slot_tables(se, sg, st, pos, num_slots=E,
                                          cap=C, slot_of=se, cap_pos=pos)
    tse, tsg, tst, tpos = tsorted
    ttok, tgate, tused = tll._slot_tables(tse, tsg, tst, tpos, num_slots=E,
                                          cap=C, slot_of=tse, cap_pos=tpos)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tused.numpy(), np.asarray(jused))
    _close(tgate, jgate, atol=0, rtol=0)
    kept = int(tused.sum())
    if capacity_factor >= E / K:
        assert kept == T * K                     # dropless
    else:
        assert kept < T * K, "capacity 1.25 dropped nothing here"


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("parts,capacity_factor", LAYER_CASES)
def test_torch_moe_matches_jax(parts, capacity_factor, B, S):
    jcfg, tcfg, jp, tp = _layer(parts, capacity_factor)
    jx, tx = _x(B, S, jcfg.d_model)
    jy, jaux = jll.moe(jp, jcfg, jx)
    for fn in (tll.moe, tll._moe_reference):
        ty, taux = fn(tp, tcfg, tx)
        assert ty.shape == tx.shape and ty.dtype == tx.dtype
        _close(ty, jy)
        _close(taux, jaux)


# ---- reduced models ---------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    jmodel, params, tree, port, jcfg, tcfg = _models(request.param)
    return dict(name=request.param, jmodel=jmodel, params=params, tree=tree,
                port=port, cfg=jcfg, port_cfg=tcfg)


def _train_batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jb = {"tokens": jnp.asarray(seq[:, :-1]),
          "targets": jnp.asarray(seq[:, 1:]), "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": long_tensor(seq[:, :-1]),
          "targets": long_tensor(seq[:, 1:]),
          "loss_mask": torch.from_numpy(mask)}
    return jb, tb


def _check_loss_and_grads(pair, policy):
    from repro_torch.models.convert import from_jax_params, named_from_tree
    cfg = pair["cfg"]
    jb, tb = _train_batch(cfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: pair["jmodel"].loss(p, jb, remat_policy=policy),
        has_aux=True))(pair["params"])
    model = from_jax_params(pair["port_cfg"], pair["tree"], device="cpu",
                            trainable=True)
    loss, m = model.loss(tb, remat_policy=policy)
    loss.backward()
    assert float(m["aux_loss"].detach()) > 0
    _close(loss.detach(), jloss, atol=1e-4, rtol=1e-4)
    _close(m["aux_loss"].detach(), jm["aux_loss"], atol=1e-4, rtol=1e-4)
    expect = named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads),
                             cfg.num_layers)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(expect)
    assert any(".moe.router" in k for k in got)
    for k, g in got.items():
        e = as_f32(expect[k])
        np.testing.assert_allclose(
            as_f32(g), e, rtol=1e-4,
            atol=1e-5 * float(np.abs(e).max() or 1.0), err_msg=k)


def test_torch_moe_loss_aux_and_grads_match_jax(pair):
    """The loss with its aux term, ``metrics["aux_loss"]`` and every
    gradient leaf, the router's and the experts' included."""
    _check_loss_and_grads(pair, "none")


@pytest.mark.parametrize("policy", ["full", "nothing", "dots"])
def test_torch_moe_aux_loss_summed_under_every_remat_policy(policy):
    """``run_stack`` sums the layers' aux losses also when each layer runs
    under ``torch.utils.checkpoint``; loss and gradients equal JAX's under
    the same policy (granite_e16, which drops)."""
    jmodel, params, tree, port, jcfg, tcfg = _models("granite_e16")
    _check_loss_and_grads(dict(jmodel=jmodel, params=params, tree=tree,
                               port=port, cfg=jcfg, port_cfg=tcfg), policy)


B, S, MAX_LEN, STEPS = 2, 12, 24, 4


def test_torch_moe_prefill_and_decode_match_jax(pair, monkeypatch):
    """Prefill logits and the K/V cache, then teacher-forced decode logits
    and the cache after them, on the same batches in both packages (with
    capacity the batch decides the drops, and decode's batch is not
    prefill's).  granite_e16 must really drop in both phases."""
    jmodel, params, port, cfg = (pair[k] for k in
                                 ("jmodel", "params", "port", "cfg"))
    kept = []
    slot_tables = tll._slot_tables

    def recording(*a, **kw):
        out = slot_tables(*a, **kw)
        kept.append((int(out[2].sum()), a[0].numel()))
        return out

    monkeypatch.setattr(tll, "_slot_tables", recording)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    jcache = jmodel.init_cache(B, MAX_LEN)
    jl, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)},
                                jcache)
    tcache = port.init_cache(B, MAX_LEN)
    tl, tcache = port.prefill({"tokens": long_tensor(prompts)}, tcache)
    assert tl.shape == (B, 1, cfg.vocab_size)
    _close(tl, jl, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        _close_cache(tcache[name], jcache[name])
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        jl, jcache = jmodel.decode_step(params, jcache,
                                        jnp.asarray(forced[:, i:i + 1]),
                                        jnp.asarray(pos))
        tl, tcache = port.decode_step(tcache, long_tensor(forced[:, i:i + 1]),
                                      long_tensor(pos))
        _close(tl, jl, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        _close_cache(tcache[name], jcache[name])
    dropped = [k < n for k, n in kept]
    if pair["name"] == "granite_e16":
        L = cfg.num_layers
        assert any(dropped[:L]) and any(dropped[L:])   # prefill, decode
    else:
        assert not any(dropped)


def test_torch_moe_greedy_tokens_match_jax_engine(pair):
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.serve.engine import ServeEngine
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, pair["cfg"].vocab_size, (3, 19)).astype(
        np.int32)
    jtoks = JaxEngine(pair["jmodel"], pair["params"], max_batch=4,
                      max_len=32).generate(prompts, 6).tokens
    ttoks = ServeEngine(pair["port"], max_batch=4, max_len=32,
                        device="cpu").generate(prompts, 6).tokens
    np.testing.assert_array_equal(ttoks, jtoks)


# ---- mixtral's ring cache ---------------------------------------------------

@pytest.fixture(scope="module")
def mixtral():
    return _models("mixtral")


def test_torch_ring_cache_shapes_match_jax(mixtral):
    from repro.models import stack as jstack
    _, _, _, port, jcfg, tcfg = mixtral
    assert tstack.use_ring_cache(tcfg) and jstack.use_ring_cache(jcfg)
    for max_len in (10, 64):
        jshapes = jstack.cache_shapes(jcfg, 2, max_len, ring=True)
        tshapes = tstack.cache_shapes(tcfg, 2, max_len)
        assert {k: s for k, (s, _) in tshapes.items()} == \
            {k: tuple(s) for k, (s, _) in jshapes.items()}
    assert port.init_cache(2, 64)["k"].shape[2] == tcfg.sliding_window


def test_torch_ring_prefill_past_the_window_and_decode_match_jax(mixtral):
    """A prompt of 45 > T = 16: the cache holds the last 16 positions
    rolled by 13 so position p sits in slot p % 16, as JAX's, in the
    default bf16 cache and in an fp32 one; then 20 decode steps (positions
    45-64) wrap the ring again at 48 and 64.  The steps run on the fp32
    cache: on a bf16 one each step's new K/V may round to the neighbouring
    bf16 value in one package and not the other (one ulp, as the prefill
    cache is held), and over 20 steps those flips move the logits by up to
    ~4e-4."""
    jmodel, params, _, port, cfg, _ = mixtral
    S, steps, T = 45, 20, cfg.sliding_window
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, steps)).astype(np.int32)
    for kv_dtype in (torch.bfloat16, torch.float32):
        jcache = jmodel.init_cache(2, S + steps + 4, kv_dtype=getattr(
            jnp, str(kv_dtype).removeprefix("torch.")))
        jl, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)},
                                    jcache)
        tcache = port.init_cache(2, S + steps + 4, kv_dtype=kv_dtype)
        assert tcache["k"].shape[2] == T
        tl, tcache = port.prefill({"tokens": long_tensor(prompts)}, tcache)
        _close(tl, jl, atol=1e-4, rtol=1e-4)
        for name in ("k", "v"):
            if kv_dtype == torch.bfloat16:
                _close_cache(tcache[name], jcache[name])
            else:
                _close(tcache[name], jcache[name])
    for step in range(steps):
        pos = np.full((2,), S + step, np.int32)
        jl, jcache = jmodel.decode_step(params, jcache,
                                        jnp.asarray(forced[:, step:step + 1]),
                                        jnp.asarray(pos))
        tl, tcache = port.decode_step(
            tcache, long_tensor(forced[:, step:step + 1]), long_tensor(pos))
        _close(tl, jl, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_torch_ring_decode_equals_a_full_forward(mixtral):
    """Reduced mixtral is dropless, so prefill + teacher-forced decode over
    an fp32 ring equals one full-sequence forward of the prompt and the
    forced tokens (the window bounds both); a ring rolled one slot off
    does not."""
    _, _, _, port, cfg, _ = mixtral
    from repro_torch.models import layers as ll
    S, steps = 40, 12
    rng = np.random.default_rng(13)
    seq = long_tensor(rng.integers(0, cfg.vocab_size, (2, S + steps)))
    with torch.no_grad():
        x = ll.embed(port.embed, cfg, seq)
        pos = torch.arange(S + steps)[None].expand(2, -1)
        x, _ = tstack.run_stack(port.layers, cfg, x, positions=pos)
        full = ll.unembed(port.embed, cfg,
                          ll.norm(port.final_norm, x, cfg))[:, S - 1:-1]
    cache = port.init_cache(2, S + steps, kv_dtype=torch.float32)
    logits, cache = port.prefill({"tokens": seq[:, :S]}, cache)
    rolled = {k: v.roll(1, dims=2) for k, v in cache.items()}
    outs = [logits[:, 0]]
    for j in range(steps - 1):
        p = torch.full((2,), S + j, dtype=torch.long)
        logits, cache = port.decode_step(cache, seq[:, S + j:S + j + 1], p)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, 1), full, atol=1e-4, rtol=1e-4)
    wrong, _ = port.decode_step(rolled, seq[:, S:S + 1],
                                torch.full((2,), S, dtype=torch.long))
    assert float((wrong[:, 0] - full[:, 1]).abs().max()) > 1e-3


def test_torch_mixtral_sliding_window_masks_distant_tokens(mixtral):
    """Stacked windowed attention reaches L * (window - 1) positions back;
    a token further away than that does not move the last logits."""
    _, _, _, port, cfg, _ = mixtral
    S = 48
    field = cfg.num_layers * (cfg.sliding_window - 1)       # 30
    assert S - 1 > field
    rng = np.random.default_rng(0)
    toks = long_tensor(rng.integers(0, cfg.vocab_size, (1, S)))
    l1, _ = port.prefill({"tokens": toks}, port.init_cache(1, S + 4))
    toks2 = toks.clone()
    toks2[0, 0] = (int(toks[0, 0]) + 1) % cfg.vocab_size
    l2, _ = port.prefill({"tokens": toks2}, port.init_cache(1, S + 4))
    np.testing.assert_allclose(as_f32(l1[:, -1]), as_f32(l2[:, -1]),
                               atol=1e-5)


# ---- checkpoints and entry points -------------------------------------------

def test_torch_moe_checkpoint_manifest_matches_jax(tmp_path):
    """A reduced granite train state saved by the port has ``repro``'s
    manifest byte for byte, the four MoE leaves stacked (L, ...) in the
    virtual layout."""
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.models import build_model
    from repro.train.train_step import TrainStepConfig, init_train_state
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.convert import from_jax_train_state
    jcfg, tcfg = _configs("granite-moe-3b-a800m")
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
    parts = jll._moe_parts(jcfg)
    assert manifest["0/layers/moe/wi"]["shape"] == [
        jcfg.num_layers, jcfg.num_experts * parts, jcfg.d_model,
        jcfg.expert_d_ff // parts]
    assert manifest["0/layers/moe/router"]["shape"] == [
        jcfg.num_layers, jcfg.d_model, jcfg.num_experts]


def _run(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", REPRO_COMPUTE_DTYPE="float32")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_torch_launch_serve_granite_moe_prints_json():
    summary = _run("repro_torch.launch.serve", "--arch",
                   "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
                   "--requests", "5", "--prompt-len", "11", "--max-new", "3",
                   "--max-batch", "4")
    assert summary["arch"].startswith("granite-moe-3b-a800m")
    assert summary["requests"] == 5 and summary["tokens_generated"] == 15
    assert summary["device"] == "cpu"


def test_torch_launch_train_reduced_moe_on_the_cpu(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", "mixtral-8x22b",
               "--reduced", "--device", "cpu", "--steps", "4",
               "--global-batch", "4", "--seq-len", "32", "--no-autotune",
               "--checkpoint-dir", str(tmp_path / "ck"))
    assert out["final_step"] == 4 and np.isfinite(out["loss"])
    assert (tmp_path / "ck" / "step_00000004" / "arrays_p0.npz").exists()
