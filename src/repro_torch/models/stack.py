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

Under a model axis two rule sets shard a sequence dim over ``"model"``.
Training's ``seq_res`` (``sp_split``, ``repro``'s manual sequence
parallelism): between the regions of a layer each rank holds its block of
the tokens of the residual stream, (B, S/n, D); the norms and adds run on
the block, and attention and the MLP or MoE gather the sequence in and
reduce-scatter their outputs back (``model_axis.enter`` / ``leave``).
Serving's ``kv_seq`` (``kv_shards``): each rank's K/V cache holds a
contiguous block of T/n slots, and decode combines the ranks' partial
softmaxes (``layers.attention_decode``).  The families with an SSM split
its heads over the model ranks (``ssm_inner_act``, ``models/ssm.py``), so
their SSM cache holds a rank's conv channels and heads (``ssm_shards``);
a hybrid layer's attention and SSM are two split regions side by side,
each summed over the ranks before ``_mix`` normalises it.  Neither family
splits the residual stream's tokens (``sp_split``), nor does the vlm,
whose patches sit in front of the text.  An encdec model's encoder and
decoder each take ``seq_res`` on their own length, its cross-attention
splits by heads as self-attention does, and ``kv_seq`` cuts its cross
K/V cache into blocks of the encoder positions too (``Cache``'s
``cross_shards``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import dp_shard, model_axis
from repro_torch.distributed.sharding_rules import current_ctx, model_dims
from repro_torch.models import layers as ll
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.module import map_specs, stack_specs

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
# the families whose layers split their work over a model axis: all
MODEL_AXIS_FAMILIES = PORTED_FAMILIES


def check_family(cfg: ModelConfig, families=PORTED_FAMILIES) -> None:
    """Raise ``NotImplementedError`` unless cfg's family is in ``families``
    (training and the decode cache both cover every decoder family)."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet here; "
            f"the port covers {', '.join(families)}")


def check_model_axis(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` under a mesh whose ``"model"`` axis
    is larger than 1 unless cfg's family splits its layers over it
    (``MODEL_AXIS_FAMILIES``: every ported family, the vlm and encdec
    included)."""
    ctx = current_ctx()
    n = ctx.shape.get("model", 1) if ctx is not None else 1
    if n > 1 and cfg.family not in MODEL_AXIS_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) under a model axis of {n} "
            f"is not ported yet; the model axis covers "
            f"{', '.join(MODEL_AXIS_FAMILIES)}")


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


def manual_layer_hook(cfg: ModelConfig, *, cross: bool = False,
                      compute_dtype=torch.bfloat16):
    """Per-layer FSDP gather hook for ``run_stack`` and the serving loops:
    a layer's parameters -> the same tree as plain dicts with their
    manual-sharded dims gathered (``dp_shard.layer_hook``; 2-dim and larger
    leaves in ``compute_dtype``).  A leaf also stored split over
    ``"model"`` keeps that dim as this rank's shard: the layer takes its
    part of it (``layers.work``), which is the shard itself where aligned
    and a gather over ``"model"`` inside the layer where not.  None outside
    a manual region (no mesh, or a mesh outside the data-parallel step or
    the serve wrapper)."""
    ctx = current_ctx()
    if ctx is None or not ctx.manual:
        return None
    return dp_shard.layer_hook(map_specs(lambda s: s.axes,
                                         block_specs(cfg, cross=cross)),
                               compute_dtype=compute_dtype)


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


def _ffn(p, cfg: ModelConfig, h, seq=None):
    """The layer's feed-forward half: (y, aux), aux the MoE router's
    load-balancing loss, 0 for a dense MLP; ``seq`` as ``block``'s."""
    if cfg.family == "moe":
        return ll.moe(p["moe"], cfg, h, seq=seq)
    return ll.mlp(p["mlp"], cfg, h, seq=seq), torch.zeros((), device=h.device)


def _ssm_branch(p, cfg: ModelConfig, h, ssm_state: bool):
    """The SSM mixer on h: (y, its cache leaves if ``ssm_state``, else
    none)."""
    if not ssm_state:
        return ssm_mod.ssm(p["ssm"], cfg, h), {}
    y, c = ssm_mod.ssm(p["ssm"], cfg, h, return_state=True)
    return y, {"ssm_conv": c["conv"], "ssm_state": c["state"]}


def sp_split(cfg: ModelConfig, seq_len: int) -> Optional[model_axis.Split]:
    """The split of the residual stream's tokens over the model ranks
    (``repro``'s manual sequence parallelism, ``run_stack``), or None: on
    for a family with attention and no SSM, meta tokens or patches, when
    ``seq_res`` splits the work here (``model_axis.split_for``: a mesh axis
    larger than 1, inside the manual region of the batch axes) and its size
    divides ``seq_len``.  A pure function of the rules, the mesh and the
    config, so every rank reaches the same answer."""
    if not cfg.uses_attention or cfg.ssm_state_dim or cfg.num_meta_tokens \
            or cfg.num_patches:
        return None
    split = model_axis.split_for("seq_res")
    return split if split is not None and seq_len % split.size == 0 \
        else None


def block(p, cfg: ModelConfig, x, *, positions, is_global: bool,
          causal: bool = True, ssm_state: bool = False, enc_out=None,
          seq: Optional[model_axis.Split] = None):
    """One full-sequence layer.  Returns (x, aux, leaves): the layer's
    load-balancing loss (0-d fp32, 0 but for MoE) and its decode cache
    leaves under the cache's names: the post-rotary ``k`` and ``v`` for
    the families with attention, for those with an SSM ``ssm_conv`` and
    ``ssm_state`` if ``ssm_state`` (prefill), and for an encdec decoder
    layer given the encoder's output ``enc_out`` the ``cross_k`` and
    ``cross_v`` it attends over (unrounded; the cache rounds them to its
    dtype; ``enc_out`` from ``layers.cross_source``).  ``is_global``: the
    layer's flag (``global_flags``).  Under a model split of the heads the
    ``k`` / ``v`` and cross leaves are every kv head's only when
    ``ssm_state`` (prefill) asks for the cache leaves.  With
    ``seq`` (``sp_split``) x is this rank's block of the tokens and so is
    the result: the norms and adds run on it, attention and the feed-forward
    half gather the sequence and scatter their outputs back."""
    check_model_axis(cfg)
    h = ll.norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        y, leaves = _ssm_branch(p, cfg, h, ssm_state)
        return x + y, torch.zeros((), device=x.device), leaves
    window, num_sink = _attn_window(cfg, is_global)
    attn_y, k, v = ll.attention(p["attn"], cfg, h, positions=positions,
                                causal=causal, window=window,
                                num_sink=num_sink, rope=_use_rope(cfg),
                                full_kv=ssm_state, seq=seq)
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
            positions=positions, causal=False, kv_x=enc_out, rope=False,
            full_kv=ssm_state, seq=seq)
        x = x + cross_y
    y, aux = _ffn(p, cfg, ll.norm(p["ln2"], x, cfg), seq)
    return x + y, aux, leaves


# matmuls without batch dims: what JAX's checkpoint_dots_with_no_batch_dims
# saves (``x @ W`` on a (B,S,D) activation runs as one aten.mm)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def run_stack(layers, cfg: ModelConfig, x, *, positions, causal: bool = True,
              remat_policy: str = "none", enc_out=None,
              seq: Optional[model_axis.Split] = None):
    """Every layer over x, for training and the encoder (``causal``
    false), an encdec decoder's layers attending over ``enc_out``.
    Returns (x, aux), aux the sum of the layers' load-balancing losses (0
    but for MoE).  With ``seq`` (``sp_split``) x is this rank's block of
    the tokens, and so is the result (``block``); ``positions`` stay the
    whole sequence's.

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
    and the layer gathers its unaligned model-sharded leaves there too
    (``model_storage``), so a rematerialised layer gathers both again in
    the backward, as the hook inside ``repro``'s checkpointed scan body
    does.  So do the sequence gathers under ``seq``, which sit inside the
    layer."""
    if remat_policy not in ("none", "full", "nothing", "dots"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    hook = manual_layer_hook(cfg, cross=len(layers) > 0
                             and "cross" in layers[0])

    def layer(p, xc, is_global):
        if hook is not None:
            p = hook(p)
        return block(p, cfg, xc, positions=positions, is_global=is_global,
                     causal=causal, enc_out=enc_out, seq=seq)[:2]

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
                 is_global: bool, kv: Optional[model_axis.Split] = None,
                 cross: Optional[model_axis.Split] = None):
    """One decode layer; writes this step's K/V and the SSM's new conv
    tail and state into ``cache_layer`` (views of the stacked cache); an
    encdec layer then attends over the cached ``cross_k`` / ``cross_v``.
    ``is_global``: the layer's flag (``global_flags``).  Every model rank
    computes every query head of attention's decode; with ``kv``
    (``kv_split``) its K/V cache holds a block of the slots, attended over
    and combined across the ranks (``layers.attention_decode``), else the
    whole cache; with ``cross`` (``kv_split(cache, cross=True)``) its
    cross K/V hold a block of the encoder positions, alike."""
    check_model_axis(cfg)
    h = ll.norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        return x + _ssm_decode(p, cfg, h, cache_layer)
    window, num_sink = _attn_window(cfg, is_global)
    attn_y = ll.attention_decode(p["attn"], cfg, h, cache_layer,
                                 positions=positions, window=window,
                                 num_sink=num_sink, ring=use_ring_cache(cfg),
                                 rope=_use_rope(cfg), kv=kv)
    if cfg.family == "hybrid":
        x = x + _mix(p, cfg, attn_y, _ssm_decode(p, cfg, h, cache_layer))
    else:
        x = x + attn_y
    if "cross" in p:
        x = x + ll.attention_decode(
            p["cross"], cfg, ll.norm(p["ln_cross"], x, cfg), None,
            positions=positions,
            cross_kv=(cache_layer["cross_k"], cache_layer["cross_v"]),
            kv=cross)
    y, _ = _ffn(p, cfg, ll.norm(p["ln2"], x, cfg))
    return x + y


def use_ring_cache(cfg: ModelConfig) -> bool:
    return (cfg.sliding_window > 0 and not cfg.global_attn_layers
            and cfg.num_meta_tokens == 0)


def kv_slots(cfg: ModelConfig, max_len: int) -> int:
    """The K/V cache's slots for ``max_len`` positions: a ring of
    ``min(max_len, window)`` (``use_ring_cache``), else ``max_len``."""
    return min(max_len, cfg.sliding_window) if use_ring_cache(cfg) \
        else max_len


def kv_shards(cfg: ModelConfig, slots: int) -> int:
    """How many blocks a K/V cache of ``slots`` slots is cut into over the
    model ranks: the size of the mesh axis the current rules map
    ``kv_seq`` to (``SERVE_RULES``: ``"model"``) where it divides
    ``slots`` (``repro``'s divisibility guard) and the family has
    attention, else 1.  Decided from the rules and the mesh, inside or
    outside the manual region."""
    ctx = current_ctx()
    if ctx is None or not cfg.uses_attention:
        return 1
    dims = model_dims(ctx, ("kv_seq",), (slots,))
    return ctx.shape["model"] if dims else 1


def ssm_shards(cfg: ModelConfig) -> Tuple[int, int]:
    """(n, rank): the model ranks an SSM decode cache's heads are split
    over and this rank's place among them (``ssm_mod.ssm_cache_shapes``),
    where the current rules map ``ssm_inner_act`` to ``"model"`` and it
    is larger than 1, as the mixer splits its heads inside the manual
    region (``model_axis.split_for``); else (1, 0).  Decided from the rules
    and the mesh, inside or outside the manual region."""
    ctx = current_ctx()
    if ctx is None or not cfg.ssm_state_dim \
            or ctx.mesh_axes_for("ssm_inner_act",
                                 include_manual=True) != ("model",) \
            or ctx.shape["model"] <= 1:
        return 1, 0
    return ctx.shape["model"], ctx.mesh.get_local_rank("model")


def kv_split(cache, cross: bool = False) -> Optional[model_axis.Split]:
    """The split of ``cache``'s K/V slots over the model ranks (``Cache``'s
    ``kv_shards``), or with ``cross`` of its cross K/V's encoder positions
    (``cross_shards``), or None for a whole cache.  Raises where a cache
    cut into blocks is used outside a ``kv_seq`` split of its size, and
    where a cache that may have lost its block count is used inside one:
    a plain dict of the leaves, or a ``Cache`` held whole whose slots the
    split divides (``init_cache`` would have cut it)."""
    leaf = "cross_k" if cross else "k"
    n = getattr(cache, "cross_shards" if cross else "kv_shards", 1)
    split = model_axis.split_for("kv_seq")
    if n == 1:
        if split is None or leaf not in cache:
            return None
        if not isinstance(cache, Cache):
            raise ValueError(f"a plain dict of cache leaves used inside a "
                             f"kv_seq split of {split.size}: only a Cache "
                             f"(init_cache) says whether its K/V leaves "
                             f"are blocks")
        slots = cache[leaf].shape[2]
        if slots % split.size == 0:
            raise ValueError(f"a whole K/V cache of {slots} slots used "
                             f"inside a kv_seq split of {split.size}, which "
                             f"divides them: init_cache cuts such a cache "
                             f"into blocks (was its kv_shards lost?)")
        return None
    if split is None or split.size != n:
        raise ValueError(f"a K/V cache cut into {n} blocks over the model "
                         f"ranks used outside a kv_seq split of {n}")
    return split


class Cache(dict):
    """The stacked decode cache, by leaf name; ``kv_shards``: how many
    blocks of slots its K/V leaves hold one of (``kv_shards``), rank r's
    block being slots [r T/n, (r + 1) T/n) of the whole ring or context,
    as a block sharding lays them out; ``cross_shards``: how many blocks
    of the encoder positions its cross K/V hold one of, alike;
    ``ssm_shards``: how many model ranks its SSM leaves' heads are split
    over (``ssm_shards``).  A plain dict of the leaves is a whole cache,
    and ``kv_split`` refuses one inside a ``kv_seq`` split."""

    kv_shards = 1
    cross_shards = 1
    ssm_shards = 1


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 kv_dtype=torch.bfloat16) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Shapes and dtypes of the stacked decode cache (leading dim = layers):
    K/V (``kv_dtype``, bf16 by default whatever the compute dtype, as in
    JAX) for a family with attention, ``min(max_len, window)`` slots long
    for a ring cache, a rank's block of them where ``kv_shards`` cuts
    them; ``ssm_conv`` (bf16) and ``ssm_state`` (fp32) for one with an SSM
    (the hybrid family has both), whose size does not depend on
    ``max_len``, and this rank's channels and heads of them where
    ``ssm_shards`` splits the heads; for encdec the cross K/V ``cross_k``
    / ``cross_v`` (``kv_dtype``) over the ``max_source_positions``
    encoder outputs, a rank's block of them where ``kv_shards`` cuts
    them."""
    check_family(cfg)
    L = cfg.num_layers
    out = {}
    if cfg.uses_attention:
        T = kv_slots(cfg, max_len)
        kvshape = (L, batch, T // kv_shards(cfg, T), cfg.num_kv_heads,
                   cfg.head_dim)
        out["k"] = (kvshape, kv_dtype)
        out["v"] = (kvshape, kv_dtype)
    if cfg.ssm_state_dim:
        shapes = ssm_mod.ssm_cache_shapes(cfg, batch, *ssm_shards(cfg))
        out["ssm_conv"] = ((L,) + shapes["conv"][0], shapes["conv"][1])
        out["ssm_state"] = ((L,) + shapes["state"][0], shapes["state"][1])
    if cfg.encoder_layers:
        T = cfg.max_source_positions
        enc_kv = (L, batch, T // kv_shards(cfg, T), cfg.num_kv_heads,
                  cfg.head_dim)
        out["cross_k"] = (enc_kv, kv_dtype)
        out["cross_v"] = (enc_kv, kv_dtype)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               kv_dtype=torch.bfloat16) -> Cache:
    """A zero ``Cache`` of ``cache_shapes``; under rules that map
    ``kv_seq`` to a model axis of n that divides its slots, this rank's
    block of them (``kv_shards`` n), and of the encoder positions where n
    divides those (``cross_shards`` n); under rules that split the SSD
    heads over n model ranks, this rank's SSM leaves (``ssm_shards``
    n)."""
    shapes = cache_shapes(cfg, batch, max_len, kv_dtype=kv_dtype)
    cache = Cache({k: torch.zeros(s, dtype=d, device=device)
                   for k, (s, d) in shapes.items()})
    if cfg.uses_attention:
        cache.kv_shards = kv_shards(cfg, kv_slots(cfg, max_len))
    if cfg.encoder_layers:
        cache.cross_shards = kv_shards(cfg, cfg.max_source_positions)
    cache.ssm_shards = ssm_shards(cfg)[0]
    return cache
