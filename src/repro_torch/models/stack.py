"""Blocks, the layer stack for training and the encoder, and the decode
cache.

The counterpart of ``repro/models/stack.py`` on one device: the dense,
MoE, SSM, hybrid, vlm and encdec families.  JAX scans one block over
stacked parameters; here the model keeps a ``ModuleList`` of per-layer
parameter dicts and loops over it (``run_stack``, ``lm.py``), so JAX's
``jax.lax.cond`` between full and windowed attention on a hybrid layer is
a Python branch on the layer's flag (``global_flags``).  A hybrid layer
runs attention and the SSM side by side on the same normed input and adds
half the sum of their normed outputs.  The decode cache holds K/V for the
families with attention (a ring of ``min(max_len, window)`` slots when
every layer is windowed and there are no meta tokens, ``use_ring_cache``;
otherwise full length, windowing being a mask) and the conv tail and SSD
state for the families with an SSM, under JAX's leaf names.  An encdec
decoder layer (whisper) also attends, not causally, over the encoder's
output: its cross K/V are projected once at prefill, returned as the
layer's ``cross_k`` / ``cross_v`` leaves and read by every decode step;
encdec uses no rotary embedding anywhere.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import dp_shard
from repro_torch.distributed.sharding_rules import current_ctx
from repro_torch.models import layers as ll
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.module import map_specs, stack_specs

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def check_family(cfg: ModelConfig, families=PORTED_FAMILIES) -> None:
    """Raise ``NotImplementedError`` unless cfg's family is in ``families``
    (training and the decode cache both cover every decoder family)."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet here; "
            f"the port covers {', '.join(families)}")


def block_specs(cfg: ModelConfig, cross: bool = False):
    """One layer's specs; ``cross``: an encdec decoder layer, with
    ``ln_cross`` and ``cross`` (attention without qk-norm)."""
    check_family(cfg)
    if cfg.family == "ssm":
        return {"ln1": ll.norm_specs(cfg), "ssm": ssm_mod.ssm_specs(cfg)}
    p = {"ln1": ll.norm_specs(cfg), "attn": ll.attention_specs(cfg),
         "ln2": ll.norm_specs(cfg)}
    if cross:
        p["ln_cross"] = ll.norm_specs(cfg)
        p["cross"] = ll.attention_specs(cfg, cross=True)
    if cfg.family == "moe":
        p["moe"] = ll.moe_specs(cfg)
    else:
        p["mlp"] = ll.mlp_specs(cfg)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.ssm_specs(cfg)
        p["mix_norm_attn"] = ll.rmsnorm_specs(cfg.d_model)
        p["mix_norm_ssm"] = ll.rmsnorm_specs(cfg.d_model)
    return p


def manual_layer_hook(cfg: ModelConfig, *, cross: bool = False):
    """Per-layer FSDP gather hook (bf16) for ``run_stack``: a layer's
    parameters -> the same tree as plain dicts with their manual-sharded
    dims gathered (``dp_shard.layer_hook``).  None outside a manual region
    (no mesh, or a mesh outside the data-parallel step)."""
    ctx = current_ctx()
    if ctx is None or not ctx.manual:
        return None
    return dp_shard.layer_hook(map_specs(lambda s: s.axes,
                                         block_specs(cfg, cross=cross)))


def global_flags(cfg: ModelConfig, num_layers: int = 0) -> Tuple[bool, ...]:
    """Per layer of a stack of ``num_layers`` (the decoder's
    ``cfg.num_layers`` if 0): does it attend over the whole sequence (one
    of ``global_attn_layers``)?"""
    n = num_layers or cfg.num_layers
    return tuple(i in cfg.global_attn_layers for i in range(n))


def _use_rope(cfg: ModelConfig) -> bool:
    return cfg.family != "encdec"


def _attn_window(cfg: ModelConfig, is_global: bool) -> Tuple[int, int]:
    """(window, num_sink) of a layer's attention: a global layer of a
    config with global layers and a window sees everything; every other
    windowed layer keeps the meta tokens visible as sinks."""
    if cfg.global_attn_layers and cfg.sliding_window and is_global:
        return 0, 0
    window = cfg.sliding_window
    return window, cfg.num_meta_tokens if window else 0


def _mix(p, cfg: ModelConfig, attn_y, ssm_y):
    """The hybrid layer's residual update: half the sum of the normed
    attention and SSM outputs."""
    return 0.5 * (ll.rmsnorm(p["mix_norm_attn"], attn_y, cfg.norm_eps)
                  + ll.rmsnorm(p["mix_norm_ssm"], ssm_y, cfg.norm_eps))


def stack_param_specs(cfg: ModelConfig, num_layers: int = 0,
                      cross: bool = False):
    """The stacked specs of ``num_layers`` layers (``cfg.num_layers`` if
    0: the encoder passes its own ``encoder_layers``)."""
    return stack_specs(block_specs(cfg, cross=cross),
                       num_layers or cfg.num_layers)


def _ffn(p, cfg: ModelConfig, h):
    """The layer's feed-forward half: (y, aux), aux the MoE router's
    load-balancing loss, 0 for a dense MLP."""
    if cfg.family == "moe":
        return ll.moe(p["moe"], cfg, h)
    return ll.mlp(p["mlp"], cfg, h), torch.zeros((), device=h.device)


def _ssm_branch(p, cfg: ModelConfig, h, ssm_state: bool):
    """The SSM mixer on h: (y, its cache leaves if ``ssm_state``, else
    none)."""
    if not ssm_state:
        return ssm_mod.ssm(p["ssm"], cfg, h), {}
    y, c = ssm_mod.ssm(p["ssm"], cfg, h, return_state=True)
    return y, {"ssm_conv": c["conv"], "ssm_state": c["state"]}


def block(p, cfg: ModelConfig, x, *, positions, is_global: bool,
          causal: bool = True, ssm_state: bool = False, enc_out=None):
    """One full-sequence layer.  Returns (x, aux, leaves): the layer's
    load-balancing loss (0-d fp32, 0 but for MoE) and its decode cache
    leaves under the cache's names: the post-rotary ``k`` and ``v`` for
    the families with attention, for those with an SSM ``ssm_conv`` and
    ``ssm_state`` if ``ssm_state`` (prefill), and for an encdec decoder
    layer given the encoder's output ``enc_out`` the ``cross_k`` and
    ``cross_v`` it attends over (unrounded; the cache rounds them to its
    dtype).  ``is_global``: the layer's flag (``global_flags``)."""
    h = ll.norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        y, leaves = _ssm_branch(p, cfg, h, ssm_state)
        return x + y, torch.zeros((), device=x.device), leaves
    window, num_sink = _attn_window(cfg, is_global)
    attn_y, k, v = ll.attention(p["attn"], cfg, h, positions=positions,
                                causal=causal, window=window,
                                num_sink=num_sink, rope=_use_rope(cfg))
    leaves = {"k": k, "v": v}
    if cfg.family == "hybrid":
        ssm_y, ssm_leaves = _ssm_branch(p, cfg, h, ssm_state)
        leaves.update(ssm_leaves)
        x = x + _mix(p, cfg, attn_y, ssm_y)
    else:
        x = x + attn_y
    if enc_out is not None and "cross" in p:
        cross_y, leaves["cross_k"], leaves["cross_v"] = ll.attention(
            p["cross"], cfg, ll.norm(p["ln_cross"], x, cfg),
            positions=positions, causal=False, kv_x=enc_out, rope=False)
        x = x + cross_y
    y, aux = _ffn(p, cfg, ll.norm(p["ln2"], x, cfg))
    return x + y, aux, leaves


# matmuls without batch dims: what JAX's checkpoint_dots_with_no_batch_dims
# saves (``x @ W`` on a (B,S,D) activation runs as one aten.mm)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def run_stack(layers, cfg: ModelConfig, x, *, positions, causal: bool = True,
              remat_policy: str = "none", enc_out=None):
    """Every layer over x, for training and the encoder (``causal``
    false), an encdec decoder's layers attending over ``enc_out``.
    Returns (x, aux), aux the sum of the layers' load-balancing losses (0
    but for MoE).

    ``remat_policy`` maps JAX's ``jax.checkpoint`` of the scan body onto
    ``torch.utils.checkpoint`` per layer: "none" keeps every activation;
    "full" and "nothing" keep only each layer's input and recompute the
    layer in the backward pass; "dots" also keeps the outputs of its
    matmuls (``create_selective_checkpoint_contexts``).  The aux loss is
    an output of the checkpointed layer, so it is summed under every
    policy.  A kernel launched through ctypes (flash attention's
    ``_FlashAttention``, rmsnorm) is invisible to the dispatcher: the
    recompute runs it again under every policy, since "dots" saves only
    ``aten.mm`` / ``aten.addmm`` outputs and recomputes the ``aten.empty``
    a kernel writes into, never replaying one the kernel has not written.

    Inside the data-parallel step's manual region each layer's parameters
    pass through ``manual_layer_hook`` inside the checkpointed function,
    so a rematerialised layer gathers its FSDP leaves again in the
    backward, as the hook inside ``repro``'s checkpointed scan body does."""
    if remat_policy not in ("none", "full", "nothing", "dots"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    hook = manual_layer_hook(cfg, cross=len(layers) > 0
                             and "cross" in layers[0])

    def layer(p, xc, is_global):
        if hook is not None:
            p = hook(p)
        return block(p, cfg, xc, positions=positions, is_global=is_global,
                     causal=causal, enc_out=enc_out)[:2]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, is_global in zip(layers, global_flags(cfg, len(layers))):
        if remat_policy == "none":
            x, aux_l = layer(p, x, is_global)
        else:
            kw = {}
            if remat_policy == "dots":
                kw["context_fn"] = functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _save_dots)
            x, aux_l = ckpt.checkpoint(layer, p, x, is_global,
                                       use_reentrant=False, **kw)
        aux = aux + aux_l
    return x, aux


def _ssm_decode(p, cfg: ModelConfig, h, cache_layer):
    """The SSM mixer's decode step on h; writes the new conv tail and
    state into ``cache_layer`` in place."""
    y, c = ssm_mod.ssm_decode(
        p["ssm"], cfg, h,
        {"conv": cache_layer["ssm_conv"], "state": cache_layer["ssm_state"]})
    cache_layer["ssm_conv"].copy_(c["conv"])
    cache_layer["ssm_state"].copy_(c["state"])
    return y


def decode_block(p, cfg: ModelConfig, x, cache_layer, *, positions,
                 is_global: bool):
    """One decode layer; writes this step's K/V and the SSM's new conv
    tail and state into ``cache_layer`` (views of the stacked cache); an
    encdec layer then attends over the cached ``cross_k`` / ``cross_v``.
    ``is_global``: the layer's flag (``global_flags``)."""
    h = ll.norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        return x + _ssm_decode(p, cfg, h, cache_layer)
    window, num_sink = _attn_window(cfg, is_global)
    attn_y = ll.attention_decode(p["attn"], cfg, h, cache_layer,
                                 positions=positions, window=window,
                                 num_sink=num_sink, ring=use_ring_cache(cfg),
                                 rope=_use_rope(cfg))
    if cfg.family == "hybrid":
        x = x + _mix(p, cfg, attn_y, _ssm_decode(p, cfg, h, cache_layer))
    else:
        x = x + attn_y
    if "cross" in p:
        x = x + ll.attention_decode(
            p["cross"], cfg, ll.norm(p["ln_cross"], x, cfg), None,
            positions=positions,
            cross_kv=(cache_layer["cross_k"], cache_layer["cross_v"]))
    y, _ = _ffn(p, cfg, ll.norm(p["ln2"], x, cfg))
    return x + y


def use_ring_cache(cfg: ModelConfig) -> bool:
    return (cfg.sliding_window > 0 and not cfg.global_attn_layers
            and cfg.num_meta_tokens == 0)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 kv_dtype=torch.bfloat16) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Shapes and dtypes of the stacked decode cache (leading dim = layers):
    K/V (``kv_dtype``, bf16 by default whatever the compute dtype, as in
    JAX) for a family with attention, ``min(max_len, window)`` slots long
    for a ring cache; ``ssm_conv`` (bf16) and ``ssm_state`` (fp32) for one
    with an SSM (the hybrid family has both), whose size does not depend
    on ``max_len``; for encdec the cross K/V ``cross_k`` / ``cross_v``
    (``kv_dtype``) over the ``max_source_positions`` encoder outputs."""
    check_family(cfg)
    L = cfg.num_layers
    out = {}
    if cfg.uses_attention:
        T = min(max_len, cfg.sliding_window) if use_ring_cache(cfg) \
            else max_len
        kvshape = (L, batch, T, cfg.num_kv_heads, cfg.head_dim)
        out["k"] = (kvshape, kv_dtype)
        out["v"] = (kvshape, kv_dtype)
    if cfg.ssm_state_dim:
        shapes = ssm_mod.ssm_cache_shapes(cfg, batch)
        out["ssm_conv"] = ((L,) + shapes["conv"][0], shapes["conv"][1])
        out["ssm_state"] = ((L,) + shapes["state"][0], shapes["state"][1])
    if cfg.encoder_layers:
        enc_kv = (L, batch, cfg.max_source_positions, cfg.num_kv_heads,
                  cfg.head_dim)
        out["cross_k"] = (enc_kv, kv_dtype)
        out["cross_v"] = (enc_kv, kv_dtype)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               kv_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    shapes = cache_shapes(cfg, batch, max_len, kv_dtype=kv_dtype)
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in shapes.items()}
