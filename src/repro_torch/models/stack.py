"""Decoder blocks, the layer stack for training, and the decode cache.

The counterpart of the dense, MoE and SSM subsets of
``repro/models/stack.py``.  JAX scans one block over stacked parameters;
here the model keeps a ``ModuleList`` of per-layer parameter dicts and
loops over it (``run_stack``, ``lm.py``).  The decode cache holds K/V for
the dense and MoE families (a ring of ``min(max_len, window)`` slots when
every layer is windowed, ``use_ring_cache``) and the conv tail and SSD
state for the SSM family, under JAX's leaf names.  The hybrid and
cross-attention branches are not ported yet and raise.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.module import stack_specs

PORTED_FAMILIES = ("dense", "moe", "ssm")


def check_family(cfg: ModelConfig, families=PORTED_FAMILIES) -> None:
    """Raise ``NotImplementedError`` unless cfg's family is in ``families``
    (training and the decode cache both cover the dense, MoE and SSM
    families)."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet here; "
            f"the port covers {', '.join(families)}")


def block_specs(cfg: ModelConfig):
    check_family(cfg)
    if cfg.family == "ssm":
        return {"ln1": ll.norm_specs(cfg), "ssm": ssm_mod.ssm_specs(cfg)}
    p = {"ln1": ll.norm_specs(cfg), "attn": ll.attention_specs(cfg),
         "ln2": ll.norm_specs(cfg)}
    if cfg.family == "moe":
        p["moe"] = ll.moe_specs(cfg)
    else:
        p["mlp"] = ll.mlp_specs(cfg)
    return p


def stack_param_specs(cfg: ModelConfig):
    return stack_specs(block_specs(cfg), cfg.num_layers)


def _ffn(p, cfg: ModelConfig, h):
    """The layer's feed-forward half: (y, aux), aux the MoE router's
    load-balancing loss, 0 for a dense MLP."""
    if cfg.family == "moe":
        return ll.moe(p["moe"], cfg, h)
    return ll.mlp(p["mlp"], cfg, h), torch.zeros((), device=h.device)


def block(p, cfg: ModelConfig, x, *, positions, causal: bool = True,
          ssm_state: bool = False):
    """One full-sequence layer.  Returns (x, aux, leaves): the layer's
    load-balancing loss (0-d fp32, 0 but for MoE) and its decode cache
    leaves under the cache's names, the post-rotary ``k`` and ``v`` for
    the families with attention, and for the SSM family ``ssm_conv`` and
    ``ssm_state`` if ``ssm_state`` (prefill) or none."""
    h = ll.norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        zero = torch.zeros((), device=x.device)
        if not ssm_state:
            return x + ssm_mod.ssm(p["ssm"], cfg, h), zero, {}
        y, c = ssm_mod.ssm(p["ssm"], cfg, h, return_state=True)
        return x + y, zero, {"ssm_conv": c["conv"], "ssm_state": c["state"]}
    attn_y, k, v = ll.attention(p["attn"], cfg, h, positions=positions,
                                causal=causal, window=cfg.sliding_window)
    x = x + attn_y
    y, aux = _ffn(p, cfg, ll.norm(p["ln2"], x, cfg))
    return x + y, aux, {"k": k, "v": v}


# matmuls without batch dims: what JAX's checkpoint_dots_with_no_batch_dims
# saves (``x @ W`` on a (B,S,D) activation runs as one aten.mm)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def run_stack(layers, cfg: ModelConfig, x, *, positions, causal: bool = True,
              remat_policy: str = "none"):
    """Every layer over x, for training.  Returns (x, aux), aux the sum of
    the layers' load-balancing losses (0 but for MoE).

    ``remat_policy`` maps JAX's ``jax.checkpoint`` of the scan body onto
    ``torch.utils.checkpoint`` per layer: "none" keeps every activation;
    "full" and "nothing" keep only each layer's input and recompute the
    layer in the backward pass; "dots" also keeps the outputs of its
    matmuls (``create_selective_checkpoint_contexts``).  The aux loss is
    an output of the checkpointed layer, so it is summed under every
    policy."""
    if remat_policy not in ("none", "full", "nothing", "dots"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")

    def layer(p, xc):
        return block(p, cfg, xc, positions=positions, causal=causal)[:2]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        if remat_policy == "none":
            x, aux_l = layer(p, x)
        else:
            kw = {}
            if remat_policy == "dots":
                kw["context_fn"] = functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _save_dots)
            x, aux_l = ckpt.checkpoint(layer, p, x, use_reentrant=False,
                                       **kw)
        aux = aux + aux_l
    return x, aux


def decode_block(p, cfg: ModelConfig, x, cache_layer, *, positions):
    """One decode layer; writes this step's K/V, or the SSM's new conv tail
    and state, into ``cache_layer`` (views of the stacked cache)."""
    h = ll.norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        y, c = ssm_mod.ssm_decode(
            p["ssm"], cfg, h,
            {"conv": cache_layer["ssm_conv"], "state": cache_layer["ssm_state"]})
        cache_layer["ssm_conv"].copy_(c["conv"])
        cache_layer["ssm_state"].copy_(c["state"])
        return x + y
    x = x + ll.attention_decode(p["attn"], cfg, h, cache_layer,
                                positions=positions,
                                window=cfg.sliding_window,
                                ring=use_ring_cache(cfg))
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
    with an SSM, whose size does not depend on ``max_len``."""
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
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               kv_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    shapes = cache_shapes(cfg, batch, max_len, kv_dtype=kv_dtype)
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in shapes.items()}
