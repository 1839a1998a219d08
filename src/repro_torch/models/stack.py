"""Decoder block and decode cache for the dense family.

The counterpart of the dense subset of ``repro/models/stack.py``.  JAX
scans one block over stacked parameters; here the model keeps a
``ModuleList`` of per-layer parameter dicts and loops over it (``lm.py``).
The MoE, SSM, hybrid and cross-attention branches are not ported yet and
raise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models.module import stack_specs


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"port covers the dense family")


def block_specs(cfg: ModelConfig):
    _check_family(cfg)
    return {"ln1": ll.norm_specs(cfg), "attn": ll.attention_specs(cfg),
            "ln2": ll.norm_specs(cfg), "mlp": ll.mlp_specs(cfg)}


def stack_param_specs(cfg: ModelConfig):
    return stack_specs(block_specs(cfg), cfg.num_layers)


def block(p, cfg: ModelConfig, x, *, positions, causal: bool = True):
    """One full-sequence layer.  Returns (x, k, v), with k and v the
    layer's post-rotary keys and values for the decode cache."""
    h = ll.norm(p["ln1"], x, cfg)
    attn_y, k, v = ll.attention(p["attn"], cfg, h, positions=positions,
                                causal=causal, window=cfg.sliding_window)
    x = x + attn_y
    h2 = ll.norm(p["ln2"], x, cfg)
    return x + ll.mlp(p["mlp"], cfg, h2), k, v


def decode_block(p, cfg: ModelConfig, x, cache_layer, *, positions):
    """One decode layer; writes this step's K/V into ``cache_layer``."""
    h = ll.norm(p["ln1"], x, cfg)
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
    """Shapes and dtypes of the stacked decode cache (leading dim = layers).
    bf16 by default, whatever the compute dtype, as in JAX."""
    _check_family(cfg)
    if use_ring_cache(cfg):
        raise NotImplementedError("the ring (sliding-window) cache is not "
                                  "ported yet")
    kvshape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (kvshape, kv_dtype), "v": (kvshape, kv_dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               kv_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    shapes = cache_shapes(cfg, batch, max_len, kv_dtype=kv_dtype)
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in shapes.items()}
