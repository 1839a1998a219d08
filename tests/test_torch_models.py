"""The port's dense DecoderLM against the JAX package's, on the CPU.

Reduced qwen2-0.5b (QKV bias) and qwen3-1.7b (qk-norm) get the same
parameters in both packages (carried across by ``from_jax_params``); prefill
logits, the whole bf16 K/V cache and teacher-forced decode logits must
agree.  fp32 compute (tests/conftest.py), so atol/rtol 1e-4 on logits only
allows for summation order across the 2 layers; the cache is compared at
bf16 resolution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, jax_and_port, long_tensor

ARCHS = ["qwen2-0.5b", "qwen3-1.7b"]
B, S, MAX_LEN, STEPS = 2, 12, 24, 4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jmodel, params, port, cfg = jax_and_port(request.param)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jcache = jmodel.init_cache(B, MAX_LEN)
    jlogits, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(prompts)},
                                     jcache)
    tcache = port.init_cache(B, MAX_LEN)
    tlogits, tcache = port.prefill({"tokens": long_tensor(prompts)}, tcache)
    return dict(jmodel=jmodel, params=params, port=port, cfg=cfg,
                prompts=prompts, jlogits=jlogits, jcache=jcache,
                tlogits=tlogits, tcache=tcache)


def test_torch_prefill_logits_match_jax(pair):
    assert pair["tlogits"].shape == (B, 1, pair["cfg"].vocab_size)
    np.testing.assert_allclose(as_f32(pair["tlogits"]),
                               as_f32(pair["jlogits"]), atol=1e-4, rtol=1e-4)


def test_torch_prefill_cache_matches_jax(pair):
    for name in ("k", "v"):
        jc, tc = pair["jcache"][name], pair["tcache"][name]
        assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16
        assert tuple(tc.shape) == jc.shape
        # one bf16 ulp (2^-7 relative) where an fp32 value sits on a
        # rounding boundary; slots past the prompt stay zero in both
        np.testing.assert_allclose(as_f32(tc), as_f32(jc), rtol=2 ** -7,
                                   atol=1e-6)
        assert not as_f32(tc)[:, :, S:].any()


def test_torch_decode_logits_match_jax(pair):
    """Four teacher-forced decode steps from the prefilled caches."""
    jmodel, params, port = pair["jmodel"], pair["params"], pair["port"]
    jcache = pair["jcache"]
    tcache = {k: v.clone() for k, v in pair["tcache"].items()}
    rng = np.random.default_rng(1)
    forced = rng.integers(0, pair["cfg"].vocab_size, (B, STEPS)).astype(np.int32)
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        jl, jcache = jmodel.decode_step(params, jcache,
                                        jnp.asarray(forced[:, i:i + 1]),
                                        jnp.asarray(pos))
        tl, tcache = port.decode_step(tcache, long_tensor(forced[:, i:i + 1]),
                                      long_tensor(pos))
        np.testing.assert_allclose(as_f32(tl), as_f32(jl), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(as_f32(tcache["k"]), as_f32(jcache["k"]),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-1.7b", "yi-34b",
                                  "mistral-large-123b", "mamba2-780m",
                                  "granite-moe-3b-a800m", "mixtral-8x22b"])
def test_torch_param_specs_match_jax(arch):
    """Full-width spec trees: same leaves, shapes and init kinds (no
    parameter is allocated)."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.module import is_spec
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import DecoderLM

    jspecs = build_model(get_config(arch)).param_specs()
    tspecs = DecoderLM.param_specs(port_config(arch))
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


def test_torch_init_params_draw_from_the_generator():
    """fp32 leaves of the spec shapes, with each init kind's statistics,
    reproducible from the generator's seed."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import DecoderLM
    from repro_torch.models.module import init_params

    cfg = reduced(get_config("qwen2-0.5b"))
    specs = DecoderLM.param_specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(3))
    b = init_params(specs, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a["layers"]["attn"]["wq"],
                               b["layers"]["attn"]["wq"], rtol=0, atol=0)
    wq = a["layers"]["attn"]["wq"]
    assert wq.dtype == torch.float32
    assert wq.shape == (cfg.num_layers, cfg.d_model,
                        cfg.num_heads * cfg.head_dim)
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(float(a["embed"]["tokens"].std()) - 0.02) < 0.002
    assert bool((a["layers"]["attn"]["bq"] == 0).all())
    assert bool((a["final_norm"]["scale"] == 1).all())


def test_torch_model_keeps_norms_fp32_and_casts_weights_once():
    """Weights JAX casts at every use are stored in the compute dtype;
    the norm scales stay fp32, as JAX uses them."""
    from repro_torch.models import layers as ll
    _, _, port, _ = jax_and_port("qwen3-1.7b")
    layer = port.layers[0]
    assert layer["attn"]["wq"].dtype == ll.COMPUTE_DTYPE
    assert port.embed["tokens"].dtype == ll.COMPUTE_DTYPE
    assert layer["ln1"]["scale"].dtype == torch.float32
    assert layer["attn"]["q_norm"].dtype == torch.float32
    assert not any(p.requires_grad for p in port.parameters())
    assert len(port.layers) == 2


def test_torch_convert_rejects_a_mismatched_tree():
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import from_jax_params
    _, params, _, _ = jax_and_port("qwen2-0.5b")
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(ValueError, match="mismatch"):      # no qk-norm leaves
        from_jax_params(reduced(get_config("qwen3-1.7b")), tree, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(dataclasses.replace(cfg, d_ff=96), tree,
                        device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-780m", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "whisper-large-v3",
                                  "phi-3-vision-4.2b"])
def test_torch_unported_families_raise(arch):
    """Every family is ported now, in training and serving, and each
    builds, prefills and decodes here: the SSM cache holds JAX's
    ``ssm_conv`` / ``ssm_state`` leaves and no K/V, the MoE and vlm
    caches K/V, the hybrid cache both, K/V as long as the text and the
    prefix (meta tokens or patches), and the encdec cache (whisper, fed
    frame embeddings) self K/V and the cross K/V over its source
    positions; tests/test_torch_ssm_serve.py, tests/test_torch_moe.py,
    tests/test_torch_prefix_families.py and tests/test_torch_encdec.py
    hold them against ``repro``.  (The name is kept from when a family
    still raised.)"""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, param_specs
    from repro_torch.models.module import init_params
    cfg = reduced(get_config(arch))
    leaves = {"ssm": {"ssm_conv", "ssm_state"}, "moe": {"k", "v"},
              "vlm": {"k", "v"},
              "hybrid": {"k", "v", "ssm_conv", "ssm_state"},
              "encdec": {"k", "v", "cross_k", "cross_v"}}
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0))
    model = build_model(cfg, params, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    cache = model.init_cache(1, 8)
    assert set(cache) == leaves[cfg.family]
    prefix = cfg.num_meta_tokens + cfg.num_patches
    if "k" in cache:
        assert cache["k"].shape == (cfg.num_layers, 1, 8 + prefix,
                                    cfg.num_kv_heads, cfg.head_dim)
    if "cross_k" in cache:
        assert cache["cross_k"].shape == (cfg.num_layers, 1,
                                          cfg.max_source_positions,
                                          cfg.num_kv_heads, cfg.head_dim)
    batch = {"tokens": tokens}
    if cfg.num_patches:
        batch["patch_embeds"] = torch.ones(
            (1, cfg.num_patches, cfg.patch_embed_dim))
    if cfg.encoder_layers:
        batch["frames"] = torch.ones(
            (1, cfg.max_source_positions, cfg.d_model))
    logits, cache = model.prefill(batch, cache)
    if "k" in cache:
        written = cache["k"].abs().sum(dim=(0, 1, 3, 4)) > 0
        assert bool(written[:4 + prefix].all())
        assert not bool(written[4 + prefix:].any())
    if "cross_k" in cache:
        assert bool((cache["cross_k"].abs().sum(dim=(0, 1, 3, 4)) > 0).all())
    if "ssm_state" in cache:
        assert bool((cache["ssm_state"] != 0).any())
    logits, cache = model.decode_step(
        cache, tokens[:, :1], torch.full((1,), 4, dtype=torch.long))
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    if "k" in cache:
        assert bool((cache["k"][:, :, 4 + prefix] != 0).any())
