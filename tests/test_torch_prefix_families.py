"""The port's prefix families on the CPU against the JAX package: the
hybrid family (hymba-1.5b: attention and SSD heads in every layer, meta
tokens kept visible as attention sinks, windowed and global layers) and
the vlm family (phi-3-vision-4.2b: projected patch embeddings in front of
the text), through the loss and its gradients, prefill, decode, the
engine, the checkpoint manifest and the launchers.

Reduced configs (2 layers; hymba: window 16, 8 meta tokens, layer 0
global, state n = 16, chunk 8; phi-3-vision: 4 patches of 32).  Inputs
are made from a seed with numpy; parameters are ``repro``'s, carried
across by ``from_jax_params``.  fp32 compute (tests/conftest.py).
Tolerances as tests/test_torch_models.py and tests/test_torch_moe.py
hold the other families: logits atol / rtol 1e-4, the bf16 caches to one
bf16 ulp (rtol 2^-7, atol 1e-6), the fp32 SSD state and gradients to
rtol 1e-4 with a floor of 1e-5 of each leaf's largest entry.
"""
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

from _torch_support import as_f32, host_copy, long_tensor, same_bytes

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"hymba": "hymba-1.5b", "phi3v": "phi-3-vision-4.2b"}
# a prompt past hymba's window (16) and sinks (8): 40 text tokens are 48
# internal positions, and the decode steps go on past them
B, S, STEPS = 2, 40, 6
MAX_LEN = S + STEPS + 2
CACHE_LEAVES = {"hymba": ("k", "v", "ssm_conv", "ssm_state"),
                "phi3v": ("k", "v")}


def _configs(arch):
    from repro.configs import get_config, reduced
    from repro_torch.configs import get_config as port_config
    from repro_torch.configs import reduced as port_reduced
    return reduced(get_config(arch)), port_reduced(port_config(arch))


def _models(name, seed=0):
    """(jax model, jax params, numpy tree, port model, jax cfg, port cfg)."""
    from repro.models import build_model
    from repro_torch.models.convert import from_jax_params
    jcfg, tcfg = _configs(ARCHS[name])
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, tree, from_jax_params(tcfg, tree, device="cpu"), \
        jcfg, tcfg


_PAIRS = {}


def _pair(name):
    """The reduced model of ``name`` in both packages, made once."""
    if name not in _PAIRS:
        jmodel, params, tree, port, jcfg, tcfg = _models(name)
        _PAIRS[name] = dict(name=name, jmodel=jmodel, params=params,
                            tree=tree, port=port, cfg=jcfg, port_cfg=tcfg)
    return _PAIRS[name]


@pytest.fixture(params=list(ARCHS))
def pair(request):
    return _pair(request.param)


@pytest.fixture
def hymba():
    return _pair("hymba")


@pytest.fixture
def phi3v():
    return _pair("phi3v")


def _close(out, expect, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(as_f32(out), as_f32(expect), atol=atol,
                               rtol=rtol)


def _close_cache(name, tc, jc):
    assert tuple(tc.shape) == jc.shape, name
    if name == "ssm_state":
        assert tc.dtype == torch.float32
        e = as_f32(jc)
        np.testing.assert_allclose(as_f32(tc), e, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(e).max()),
                                   err_msg=name)
        return
    assert tc.dtype == torch.bfloat16, name
    np.testing.assert_allclose(as_f32(tc), as_f32(jc), rtol=2 ** -7,
                               atol=1e-6, err_msg=name)


def _patches(cfg, batch, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.num_patches, cfg.patch_embed_dim)).astype(np.float32)


def _batches(cfg, prompts, patches=True):
    """The prefill batch in both packages (with seeded patch embeddings
    for the vlm unless ``patches`` is false)."""
    jb = {"tokens": jnp.asarray(prompts)}
    tb = {"tokens": long_tensor(prompts)}
    if cfg.num_patches and patches:
        pe = _patches(cfg, prompts.shape[0])
        jb["patch_embeds"] = jnp.asarray(pe)
        tb["patch_embeds"] = torch.from_numpy(pe)
    return jb, tb


# ---- specs and the prefix's parameters ------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("name", list(ARCHS))
def test_torch_prefix_param_specs_match_jax(name, reduce):
    """The spec trees (full width and reduced): the same leaves, shapes,
    init kinds and scales, the prefix's ``meta_tokens`` / ``patch_proj``
    and the hybrid layer's SSM and mixing norms included."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.module import is_spec
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import DecoderLM
    jcfg, tcfg = _configs(ARCHS[name]) if reduce else \
        (get_config(ARCHS[name]), port_config(ARCHS[name]))
    jspecs = build_model(jcfg).param_specs()
    tspecs = DecoderLM.param_specs(tcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=is_spec)[0]
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
    if name == "hymba":
        assert ("meta_tokens",) in flat
        assert {("layers", g, "scale") for g in
                ("mix_norm_attn", "mix_norm_ssm")} <= set(flat)
        assert ("layers", "ssm", "in_x") in flat
    else:
        assert {("patch_proj", "w"), ("patch_proj", "b")} <= set(flat)


def test_torch_hymba_meta_tokens_change_output(hymba):
    """The counterpart of tests/test_models.py's: moving the meta tokens
    moves the logits (and equally in both packages)."""
    from repro_torch.models.convert import from_jax_params
    cfg = hymba["cfg"]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 12)).astype(np.int32)
    tree2 = dict(hymba["tree"],
                 meta_tokens=hymba["tree"]["meta_tokens"] + 1.0)
    port2 = from_jax_params(hymba["port_cfg"], tree2, device="cpu")
    params2 = dict(hymba["params"])
    params2["meta_tokens"] = hymba["params"]["meta_tokens"] + 1.0
    _, tb = _batches(cfg, prompts)
    l1, _ = hymba["port"].prefill(tb, hymba["port"].init_cache(B, 16))
    l2, _ = port2.prefill(tb, port2.init_cache(B, 16))
    assert float((l1 - l2).abs().max()) > 1e-4
    jl2, _ = hymba["jmodel"].prefill(params2,
                                     {"tokens": jnp.asarray(prompts)},
                                     hymba["jmodel"].init_cache(B, 16))
    _close(l2, jl2)


def test_torch_vlm_patches_affect_text_logits(phi3v):
    """The counterpart of tests/test_models.py's: other patches move the
    text's logits (and equally in both packages)."""
    cfg, port = phi3v["cfg"], phi3v["port"]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 12)).astype(np.int32)
    jb, tb = _batches(cfg, prompts)
    l1, _ = port.prefill(tb, port.init_cache(B, 16))
    tb2 = dict(tb, patch_embeds=tb["patch_embeds"] + 5.0)
    l2, _ = port.prefill(tb2, port.init_cache(B, 16))
    assert float((l1 - l2).abs().max()) > 1e-4
    jb2 = dict(jb, patch_embeds=jb["patch_embeds"] + 5.0)
    jl2, _ = phi3v["jmodel"].prefill(phi3v["params"], jb2,
                                    phi3v["jmodel"].init_cache(B, 16))
    _close(l2, jl2)


def test_torch_prefix_params_load_in_their_dtypes(pair):
    """A serving model holds the meta tokens and the patch projection in
    the compute dtype and the mixing norms in fp32, as JAX uses them; the
    global flags follow the config."""
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as tstack
    port, cfg = pair["port"], pair["port_cfg"]
    if pair["name"] == "hymba":
        assert port.meta_tokens.dtype == ll.COMPUTE_DTYPE
        assert tuple(port.meta_tokens.shape) == (cfg.num_meta_tokens,
                                                 cfg.d_model)
        assert port.layers[0]["mix_norm_ssm"]["scale"].dtype == torch.float32
        assert tstack.global_flags(cfg) == (True, False)
        assert not tstack.use_ring_cache(cfg)
        assert port.prefix_len == cfg.num_meta_tokens
    else:
        assert port.patch_proj["w"].dtype == ll.COMPUTE_DTYPE
        assert port.prefix_len == cfg.num_patches
        assert tstack.global_flags(cfg) == (False, False)


# ---- training -------------------------------------------------------------

def _train_batch(cfg, Bt=2, St=24, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, (Bt, St + 1)).astype(np.int32)
    mask = (rng.random((Bt, St)) > 0.2).astype(np.float32)
    jb = {"tokens": jnp.asarray(seq[:, :-1]),
          "targets": jnp.asarray(seq[:, 1:]), "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": long_tensor(seq[:, :-1]),
          "targets": long_tensor(seq[:, 1:]),
          "loss_mask": torch.from_numpy(mask)}
    if cfg.num_patches:
        pe = _patches(cfg, Bt, seed=seed + 1)
        jb["patch_embeds"] = jnp.asarray(pe)
        tb["patch_embeds"] = torch.from_numpy(pe)
    return jb, tb


@pytest.mark.parametrize("policy", ["none", "full", "nothing", "dots"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_torch_prefix_loss_and_grads_match_jax(name, policy):
    """The loss (prefix cut before the unembedding) and every gradient
    leaf, ``meta_tokens`` and ``patch_proj`` included, equal ``jax.grad``'s
    under each remat policy.  A hymba sequence of 24 text tokens is 32
    internal positions: past the window of 16."""
    from repro_torch.models.convert import from_jax_params, named_from_tree
    jmodel, params, tree, _, cfg, tcfg = _models(name)
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
                             cfg.num_layers)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(expect)
    assert ("meta_tokens" if name == "hymba" else "patch_proj.w") in got
    for k, g in got.items():
        e = as_f32(expect[k])
        np.testing.assert_allclose(
            as_f32(g), e, rtol=1e-4,
            atol=1e-5 * float(np.abs(e).max() or 1.0), err_msg=k)


# ---- serving ---------------------------------------------------------------

def _prefill_both(pair, prompts, patches=True, kv_dtype=torch.bfloat16):
    """Prefill in both packages over a K/V cache of ``kv_dtype``:
    (jax logits, jax cache, port logits, port cache)."""
    jmodel, params, port, cfg = (pair[k] for k in
                                 ("jmodel", "params", "port", "cfg"))
    jb, tb = _batches(cfg, prompts, patches)
    jcache = jmodel.init_cache(prompts.shape[0], MAX_LEN, kv_dtype=getattr(
        jnp, str(kv_dtype).removeprefix("torch.")))
    jl, jcache = jmodel.prefill(params, jb, jcache)
    tcache = port.init_cache(prompts.shape[0], MAX_LEN, kv_dtype=kv_dtype)
    tl, tcache = port.prefill(tb, tcache)
    return jl, jcache, tl, tcache


def _close_caches(tcache, jcache):
    """Every leaf after decode steps, which run on an fp32 K/V cache: on
    a bf16 one a step's new K/V may round to the neighbouring bf16 value
    in one package and not the other, and the next layers' K/V then move
    by a few ulps of their small entries (as tests/test_torch_moe.py
    found for mixtral's ring).  K/V to 1e-4, the SSM leaves as after
    prefill."""
    for name in tcache:
        if name in ("k", "v"):
            assert tcache[name].dtype == torch.float32
            _close(tcache[name], jcache[name])
        else:
            _close_cache(name, tcache[name], jcache[name])


def _decode_both(pair, jcache, tcache, forced, start):
    """Teacher-forced decode steps from text position ``start`` in both
    packages; each step's logits held."""
    jmodel, params, port = pair["jmodel"], pair["params"], pair["port"]
    for i in range(forced.shape[1]):
        pos = np.full((forced.shape[0],), start + i, np.int32)
        jl, jcache = jmodel.decode_step(params, jcache,
                                        jnp.asarray(forced[:, i:i + 1]),
                                        jnp.asarray(pos))
        tl, tcache = port.decode_step(tcache,
                                      long_tensor(forced[:, i:i + 1]),
                                      long_tensor(pos))
        _close(tl, jl)
    return jcache, tcache


def test_torch_prefix_prefill_and_decode_match_jax(pair):
    """Prefill logits and every cache leaf (K/V as long as the text and
    the prefix; hymba's conv tail and SSD state), then teacher-forced
    decode steps past the window and the sinks, and the caches after
    them."""
    cfg = pair["cfg"]
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    jl, jcache, tl, tcache = _prefill_both(pair, prompts)
    assert tl.shape == (B, 1, cfg.vocab_size)
    _close(tl, jl)
    prefix = cfg.num_meta_tokens + cfg.num_patches
    assert set(tcache) == set(CACHE_LEAVES[pair["name"]]) == set(jcache)
    assert tcache["k"].shape[2] == MAX_LEN + prefix
    if pair["name"] == "hymba":
        assert S + prefix > 2 * cfg.sliding_window
    for name in tcache:
        _close_cache(name, tcache[name], jcache[name])
    assert not as_f32(tcache["k"])[:, :, S + prefix:].any()
    jl, jcache, tl, tcache = _prefill_both(pair, prompts,
                                           kv_dtype=torch.float32)
    _close(tl, jl)
    jcache, tcache = _decode_both(pair, jcache, tcache, forced, S)
    _close_caches(tcache, jcache)


def test_torch_hymba_decode_equals_a_full_forward(hymba):
    """Prefill + teacher-forced decode over an fp32 K/V cache equals one
    full-sequence forward of the prompt and the forced tokens: the
    windowed layer's masks with their sinks and the global layer's full
    view agree between the two paths.  The prompt's last position is held
    to 1e-4.  Each decode step reads the conv tail the cache keeps in
    bf16, as JAX's does (2^-9 relative on the conv's last three inputs),
    which moves these logits (largest ~0.57) by up to 2.5e-3: the steps
    are held to 1e-2, and a cache whose sinks (the windowed layer's
    meta-token K/V) are zeroed must miss the next step by more than
    5e-2 (it does by ~0.1)."""
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as tstack
    port, cfg = hymba["port"], hymba["port_cfg"]
    rng = np.random.default_rng(13)
    seq = long_tensor(rng.integers(0, cfg.vocab_size, (B, S + STEPS)))
    with torch.no_grad():
        x, pos, prefix = port._compose_input({"tokens": seq})
        x, _ = tstack.run_stack(port.layers, cfg, x, positions=pos)
        h = ll.norm(port.final_norm, x[:, prefix + S - 1:-1], cfg)
        full = ll.unembed(port.embed, cfg, h)
    cache = port.init_cache(B, S + STEPS, kv_dtype=torch.float32)
    logits, cache = port.prefill({"tokens": seq[:, :S]}, cache)
    assert tstack.global_flags(cfg) == (True, False)
    no_sink = {k: v.clone() for k, v in cache.items()}
    for k in ("k", "v"):
        no_sink[k][1, :, :prefix] = 0
    outs = [logits[:, 0]]
    for j in range(STEPS - 1):
        p = torch.full((B,), S + j, dtype=torch.long)
        logits, cache = port.decode_step(cache, seq[:, S + j:S + j + 1], p)
        outs.append(logits[:, 0])
    outs = torch.stack(outs, 1)
    _close(outs[:, 0], full[:, 0])
    _close(outs[:, 1:], full[:, 1:], atol=1e-2, rtol=0)
    wrong, _ = port.decode_step(no_sink, seq[:, S:S + 1],
                                torch.full((B,), S, dtype=torch.long))
    assert float((wrong[:, 0] - full[:, 1]).abs().max()) > 5e-2

def test_torch_vlm_text_only_matches_jax(phi3v):
    """phi-3-vision served without patches, as ``repro`` serves it: the
    prefill has no prefix, yet the cache is ``num_patches`` longer and
    decode positions sit ``num_patches`` past the prompt, in both
    packages alike."""
    cfg = phi3v["cfg"]
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    jl, jcache, tl, tcache = _prefill_both(phi3v, prompts, patches=False)
    _close(tl, jl)
    assert tcache["k"].shape[2] == MAX_LEN + cfg.num_patches
    for name in tcache:
        _close_cache(name, tcache[name], jcache[name])
    jl, jcache, tl, tcache = _prefill_both(phi3v, prompts, patches=False,
                                           kv_dtype=torch.float32)
    jcache, tcache = _decode_both(phi3v, jcache, tcache, forced, S)
    _close_caches(tcache, jcache)
    # the written slots: the prompt at 0 .. S-1, the steps from S + P on
    k = as_f32(tcache["k"])
    P = cfg.num_patches
    assert not k[:, :, S:S + P].any()
    assert k[:, :, S + P:S + P + STEPS].any(axis=(0, 1, 3, 4)).all()


def test_torch_vlm_text_only_decode_sees_the_patch_gap(phi3v):
    """The reference's text-only quirk, in the port: without patches the
    decode positions sit ``num_patches`` past the prompt and the unwritten
    zero K slots between are visible, so a prefill of S - 1 tokens and
    one decode step miss a prefill of all S by far more than rounding;
    with patches (over an fp32 K/V cache) the two agree to 1e-4."""
    port, cfg = phi3v["port"], phi3v["port_cfg"]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 16)).astype(np.int32)
    gaps = {}
    for patches in (False, True):
        _, tb = _batches(cfg, prompts, patches)
        full, _ = port.prefill(tb, port.init_cache(B, 20))
        cache = port.init_cache(B, 20, kv_dtype=torch.float32)
        _, cache = port.prefill(dict(tb, tokens=tb["tokens"][:, :-1]), cache)
        step, _ = port.decode_step(cache, tb["tokens"][:, -1:],
                                   torch.full((B,), 15, dtype=torch.long))
        gaps[patches] = float((step - full).abs().max())
    assert gaps[True] < 1e-4 and gaps[False] > 0.1, gaps


def test_torch_prefix_greedy_tokens_match_jax_engine(pair):
    """The engines' greedy tokens are equal, a vlm's patches passed as
    ``extra_inputs`` to both."""
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.serve.engine import ServeEngine
    cfg = pair["cfg"]
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (3, 19)).astype(np.int32)
    extra = {"patch_embeds": _patches(cfg, 3)} if cfg.num_patches else None
    jtoks = JaxEngine(pair["jmodel"], pair["params"], max_batch=4,
                      max_len=32).generate(prompts, 6,
                                           extra_inputs=extra).tokens
    ttoks = ServeEngine(pair["port"], max_batch=4, max_len=32,
                        device="cpu").generate(prompts, 6,
                                               extra_inputs=extra).tokens
    np.testing.assert_array_equal(ttoks, jtoks)


# ---- checkpoints and entry points -------------------------------------------

@pytest.mark.parametrize("name", list(ARCHS))
def test_torch_prefix_checkpoint_manifest_matches_jax(name, tmp_path):
    """A train state saved by the port has ``repro``'s manifest byte for
    byte: the bare ``meta_tokens`` leaf and the ``patch_proj`` group at
    the top beside the stacked layers, in JAX's flatten order."""
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.models import build_model
    from repro.train.train_step import TrainStepConfig, init_train_state
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.convert import from_jax_train_state
    jcfg, tcfg = _configs(ARCHS[name])
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
    if name == "hymba":
        assert manifest["0/meta_tokens"]["shape"] == [jcfg.num_meta_tokens,
                                                      jcfg.d_model]
        assert manifest["0/layers/mix_norm_ssm/scale"]["shape"] == [
            jcfg.num_layers, jcfg.d_model]
    else:
        assert manifest["0/patch_proj/w"]["shape"] == [jcfg.patch_embed_dim,
                                                       jcfg.d_model]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", REPRO_COMPUTE_DTYPE="float32")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    return env


def _run(module, *args):
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, env=_env(),
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(ARCHS))
def test_torch_launch_serve_prefix_families_print_json(name):
    summary = _run("repro_torch.launch.serve", "--arch", ARCHS[name],
                   "--reduced", "--device", "cpu", "--requests", "3",
                   "--prompt-len", "9", "--max-new", "3", "--max-batch", "2")
    assert summary["arch"].startswith(ARCHS[name])
    assert summary["requests"] == 3 and summary["tokens_generated"] == 9
    assert summary["device"] == "cpu"


def test_torch_launch_train_reduced_vlm_on_the_cpu(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", "phi-3-vision-4.2b",
               "--reduced", "--device", "cpu", "--steps", "3",
               "--global-batch", "4", "--seq-len", "16", "--no-autotune",
               "--num-items", "64", "--checkpoint-dir", str(tmp_path / "ck"))
    assert out["final_step"] == 3 and np.isfinite(out["loss"])


def test_torch_launch_train_vlm_delivers_repro_s_first_batch(monkeypatch):
    """Both launchers build the vlm stub dataset from one seeded generator
    in the same order: the first batch the loader delivers (read with no
    worker threads, so the patches are drawn in the items' order) is
    ``repro``'s byte for byte.  The Trainer is replaced by a recorder of
    the loader it is given."""
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

    argv = ["train", "--arch", "phi-3-vision-4.2b", "--reduced", "--steps",
            "1", "--global-batch", "4", "--seq-len", "16", "--num-items",
            "32", "--seed", "3"]
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
    assert firsts["port"]["patch_embeds"].shape == (4, 4, 32)
    assert same_bytes(firsts["port"], firsts["jax"])
