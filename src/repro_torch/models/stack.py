"""Decoder blocks, the layer stack for training, and the decode cache.

The counterpart of the dense and SSM subsets of ``repro/models/stack.py``.
JAX scans one block over stacked parameters; here the model keeps a
``ModuleList`` of per-layer parameter dicts and loops over it
(``run_stack``, ``lm.py``).  The decode cache holds K/V for the dense
family and the conv tail and SSD state for the SSM family, under JAX's
leaf names.  The MoE, hybrid and cross-attention branches and the ring
(sliding-window) cache are not ported yet and raise.
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

PORTED_FAMILIES = ("dense", "ssm")


def check_family(cfg: ModelConfig, families=PORTED_FAMILIES) -> None:
    """Raise ``NotImplementedError`` unless cfg's family is in ``families``
    (training and the decode cache both cover the dense and SSM
    families)."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet here; "
            f"the port covers {', '.join(families)}")


def block_specs(cfg: ModelConfig):
    check_family(cfg)
    if cfg.family == "ssm":
        return {"ln1": ll.norm_specs(cfg), "ssm": ssm_mod.ssm_specs(cfg)}
    return {"ln1": ll.norm_specs(cfg), "attn": ll.attention_specs(cfg),
            "ln2": ll.norm_specs(cfg), "mlp": ll.mlp_specs(cfg)}


def stack_param_specs(cfg: ModelConfig):
    return stack_specs(block_specs(cfg), cfg.num_layers)


def block(p, cfg: ModelConfig, x, *, positions, causal: bool = True,
          ssm_state: bool = False):
    """One full-sequence layer.  Returns (x, leaves): this layer's decode
    cache leaves under the cache's names, the post-rotary ``k`` and ``v``
    for the dense family, and for the SSM family ``ssm_conv`` and
    ``ssm_state`` if ``ssm_state`` (prefill) or none."""
    h = ll.norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        if not ssm_state:
            return x + ssm_mod.ssm(p["ssm"], cfg, h), {}
        y, c = ssm_mod.ssm(p["ssm"], cfg, h, return_state=True)
        return x + y, {"ssm_conv": c["conv"], "ssm_state": c["state"]}
    attn_y, k, v = ll.attention(p["attn"], cfg, h, positions=positions,
                                causal=causal, window=cfg.sliding_window)
    x = x + attn_y
    h2 = ll.norm(p["ln2"], x, cfg)
    return x + ll.mlp(p["mlp"], cfg, h2), {"k": k, "v": v}


# matmuls without batch dims: what JAX's checkpoint_dots_with_no_batch_dims
# saves (``x @ W`` on a (B,S,D) activation runs as one aten.mm)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def run_stack(layers, cfg: ModelConfig, x, *, positions, causal: bool = True,
              remat_policy: str = "none"):
    """Every layer over x, for training.  Returns (x, aux); aux is 0 for
    the ported families (only MoE adds a load-balancing loss).

    ``remat_policy`` maps JAX's ``jax.checkpoint`` of the scan body onto
    ``torch.utils.checkpoint`` per layer: "none" keeps every activation;
    "full" and "nothing" keep only each layer's input and recompute the
    layer in the backward pass; "dots" also keeps the outputs of its
    matmuls (``create_selective_checkpoint_contexts``)."""
    if remat_policy not in ("none", "full", "nothing", "dots"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")

    def layer(p, xc):
        return block(p, cfg, xc, positions=positions, causal=causal)[0]

    for p in layers:
        if remat_policy == "none":
            x = layer(p, x)
            continue
        kw = {}
        if remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        x = ckpt.checkpoint(layer, p, x, use_reentrant=False, **kw)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
                                window=cfg.sliding_window)
    h2 = ll.norm(p["ln2"], x, cfg)
    return x + ll.mlp(p["mlp"], cfg, h2)


def use_ring_cache(cfg: ModelConfig) -> bool:
    return (cfg.sliding_window > 0 and not cfg.global_attn_layers
            and cfg.num_meta_tokens == 0)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 kv_dtype=torch.bfloat16) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Shapes and dtypes of the stacked decode cache (leading dim = layers):
    K/V (``kv_dtype``, bf16 by default whatever the compute dtype, as in
    JAX) for a family with attention; ``ssm_conv`` (bf16) and
    ``ssm_state`` (fp32) for one with an SSM, whose size does not depend on
    ``max_len``."""
    check_family(cfg)
    L = cfg.num_layers
    out = {}
    if cfg.uses_attention:
        if use_ring_cache(cfg):
            raise NotImplementedError("the ring (sliding-window) cache is "
                                      "not ported yet")
        kvshape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
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
