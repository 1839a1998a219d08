"""Layers of the dense decoder: norms, rotary, GQA attention, SwiGLU MLP,
embedding.  The PyTorch counterpart of the dense subset of
``repro/models/layers.py``.

Conventions:
* ``p`` is a mapping of parameter name to tensor (a ``ParameterDict``).
  Weights keep JAX's ``(d_in, d_out)`` orientation and are applied as
  ``x @ W``, so nothing is transposed when parameters are carried across.
* Weights are cast to the compute dtype where JAX casts them, at every
  use.  A serving model stores them in the compute dtype already, cast
  once at load, so there the cast returns the tensor itself; a training
  model holds fp32 masters and the cast is part of the autograd graph
  (``lm.DecoderLM``).  Norm scales stay fp32, as they do in JAX.
  Activations are in the compute dtype.
* Projections keep flattened feature dims, q: (D, H*hd), and reshape to
  heads after the matmul.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.module import spec

COMPUTE_DTYPE = getattr(torch, os.environ.get("REPRO_COMPUTE_DTYPE",
                                              "bfloat16"))


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rmsnorm_specs(d: int):
    return {"scale": spec((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float):
    return ops.rmsnorm(x, p["scale"], eps=eps)


def norm_specs(cfg: ModelConfig):
    if cfg.family == "encdec":
        raise NotImplementedError("layernorm (encdec) is not ported yet")
    return rmsnorm_specs(cfg.d_model)


def norm(p, x, cfg: ModelConfig):
    return rmsnorm(p, x, cfg.norm_eps)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------
def rotary(x, positions, theta: float):
    """x: (B,S,H,D) (D even); positions: (B,S) integer.

    A bf16 x times the fp32 cos/sin promotes to fp32, as in JAX; the
    result is cast back to x's type at the end."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs            # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def attention_specs(cfg: ModelConfig):
    d, nq = cfg.d_model, cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    p = {
        "wq": spec((d, nq), ("embed", "heads")),
        "wk": spec((d, nkv), ("embed", "kv_heads")),
        "wv": spec((d, nkv), ("embed", "kv_heads")),
        "wo": spec((nq, d), ("heads", "embed")),
    }
    if cfg.attn_bias:
        p["bq"] = spec((nq,), ("heads",), init="zeros")
        p["bk"] = spec((nkv,), ("kv_heads",), init="zeros")
        p["bv"] = spec((nkv,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = spec((cfg.head_dim,), (None,), init="ones")
        p["k_norm"] = spec((cfg.head_dim,), (None,), init="ones")
    return p


def _project_qkv(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    x = cast(x)
    q = x @ cast(p["wq"])
    k = x @ cast(p["wk"])
    v = x @ cast(p["wv"])
    if "bq" in p:
        q = q + cast(p["bq"])
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    q = q.view(B, S, cfg.num_heads, cfg.head_dim)
    k = k.view(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.view(B, S, cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = ops.rmsnorm(q, p["q_norm"], eps=cfg.norm_eps)
        k = ops.rmsnorm(k, p["k_norm"], eps=cfg.norm_eps)
    return q, k, v


def attention(p, cfg: ModelConfig, x, *, positions, causal: bool = True,
              window: int = 0, num_sink: int = 0):
    """Full-sequence self-attention (prefill).  x: (B,S,D).

    Returns (y, k, v): the output and the post-rotary K and V, which
    prefill writes into the decode cache, so the layer stack runs once."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=causal, window=window,
                        num_sink=num_sink)
    y = out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ cast(p["wo"])
    return y, k, v


def attention_decode(p, cfg: ModelConfig, x, kv_cache, *, positions,
                     window: int = 0, num_sink: int = 0):
    """Single-step decode.  x: (B,1,D); positions: (B,) absolute positions;
    kv_cache: {"k","v"} of shape (B,T,K,hd), T the full context.

    The new K/V are written into ``kv_cache`` in place (the engine owns
    the cache, as JAX's donated buffer); windowing is a mask."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q = rotary(q, positions[:, None], cfg.rope_theta)
    k_new = rotary(k_new, positions[:, None], cfg.rope_theta)

    k_cache, v_cache = kv_cache["k"], kv_cache["v"]
    T = k_cache.shape[1]
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, positions] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, positions] = v_new[:, 0].to(v_cache.dtype)

    kv_pos = torch.arange(T, device=x.device)[None, :].expand(B, T)
    out = ops.attention(q, k_cache, v_cache, causal=True,
                        q_pos=positions[:, None], kv_pos=kv_pos,
                        kv_valid=positions + 1, window=window,
                        num_sink=num_sink)
    return out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ cast(p["wo"])


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig):
    if cfg.mlp_activation != "swiglu":
        raise NotImplementedError(
            f"mlp activation {cfg.mlp_activation!r} is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": spec((d, f), ("embed", "mlp")),
        "wg": spec((d, f), ("embed", "mlp")),
        "wo": spec((f, d), ("mlp", "embed")),
    }


def mlp(p, cfg: ModelConfig, x):
    x = cast(x)
    h = F.silu(x @ cast(p["wg"])) * (x @ cast(p["wi"]))
    return h @ cast(p["wo"])


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------
def embed_specs(cfg: ModelConfig):
    p = {"tokens": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                        init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            scale=0.02)
    return p


def embed(p, cfg: ModelConfig, tokens):
    return cast(p["tokens"])[tokens]


def unembed(p, cfg: ModelConfig, x):
    w = cast(p["tokens"]).t() if cfg.tie_embeddings else cast(p["unembed"])
    logits = cast(x) @ w
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def xent_sum(logits, targets, mask):
    """fp32 cross-entropy (logsumexp, no z-loss) summed over the tokens
    where mask (B,S) is 1.  Returns (ce_sum, denom), denom at least 1."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum(), torch.clamp(mask.sum(), min=1.0)


def unembed_xent(p, cfg: ModelConfig, x, targets, mask):
    """Unembed and cross-entropy, the dense path of JAX's ``unembed_xent``
    (the vocab-sharded one waits for the distributed port): fp32
    logsumexp over the compute-dtype logits.  Returns (ce_sum, denom)."""
    return xent_sum(unembed(p, cfg, x), targets, mask)
