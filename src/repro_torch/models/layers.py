"""Layers of the dense and MoE decoders: norms, rotary, GQA attention
(with the ring cache's decode), SwiGLU MLP, top-k MoE, embedding.  The
PyTorch counterpart of the dense and MoE subsets of
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

import math
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
                     window: int = 0, num_sink: int = 0, ring: bool = False):
    """Single-step decode.  x: (B,1,D); positions: (B,) absolute positions;
    kv_cache: {"k","v"} of shape (B,T,K,hd).

    The new K/V are written into ``kv_cache`` in place (the engine owns
    the cache, as JAX's donated buffer).  Without ``ring`` T is the full
    context and windowing is a mask; with ``ring`` the cache is a ring of
    T slots (every layer windowed, T = min(max_len, window)): position p
    is written to slot p % T and each slot is masked by the absolute
    position it holds, as ``repro``'s ``attention_decode`` does."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q = rotary(q, positions[:, None], cfg.rope_theta)
    k_new = rotary(k_new, positions[:, None], cfg.rope_theta)

    k_cache, v_cache = kv_cache["k"], kv_cache["v"]
    T = k_cache.shape[1]
    slot = positions % T if ring else positions
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)

    j = torch.arange(T, device=x.device)[None, :]
    pos_b = positions[:, None]
    if ring:
        # the absolute position each slot holds; a slot not written yet
        # lands at a negative position, which the mask drops
        kv_pos = pos_b - (pos_b - j) % T
        kv_pos = torch.where(kv_pos > pos_b, -(10 ** 9), kv_pos)
        kv_valid = None
    else:
        kv_pos = j.expand(B, T)
        kv_valid = positions + 1
    out = ops.attention(q, k_cache, v_cache, causal=True, q_pos=pos_b,
                        kv_pos=kv_pos, kv_valid=kv_valid, window=window,
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
# MoE (top-k routing, capacity-bounded gather dispatch)
# --------------------------------------------------------------------------
EP_DESIGN = 16   # production model-axis size; fixes the virtual layout


def _moe_parts(cfg: ModelConfig) -> int:
    """f-split factor of the virtual-expert layout.

    When E < EP_DESIGN and divides it (mixtral: 8 experts) each expert is
    split into ``parts`` f-slices, V = E * parts virtual experts, the
    layout ``repro`` shards on its 16-way model axis.  The port keeps that
    layout in its parameters, so a checkpoint crosses between the packages
    unchanged, and un-virtualises it at use (``_dense_expert_weights``)."""
    E, f = cfg.num_experts, cfg.expert_d_ff
    if 0 < E < EP_DESIGN and EP_DESIGN % E == 0:
        p = EP_DESIGN // E
        if f % p == 0:
            return p
    return 1


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    parts = _moe_parts(cfg)
    p = {"router": spec((d, e), ("embed", "experts"), scale=0.02)}
    if parts > 1:
        # virtual layout (V, d, f/parts); wo keeps the logical fan-in f
        v, fl = e * parts, f // parts
        p.update({
            "wi": spec((v, d, fl), ("experts_virt", "embed", None),
                       fan_in_dims=(1,)),
            "wg": spec((v, d, fl), ("experts_virt", "embed", None),
                       fan_in_dims=(1,)),
            "wo": spec((v, fl, d), ("experts_virt", None, "embed"),
                       scale=1.0 / math.sqrt(f)),
        })
    else:
        p.update({
            "wi": spec((e, d, f), ("experts", "embed", None),
                       fan_in_dims=(1,)),
            "wg": spec((e, d, f), ("experts", "embed", None),
                       fan_in_dims=(1,)),
            "wo": spec((e, f, d), ("experts", None, "embed"),
                       fan_in_dims=(1,)),
        })
    return p


def _dense_expert_weights(p, cfg: ModelConfig):
    """Un-virtualise (V, d, f/parts) -> (E, d, f) (and wo to (E, f, d))."""
    parts = _moe_parts(cfg)
    if parts == 1:
        return p["wi"], p["wg"], p["wo"]
    E, f = cfg.num_experts, cfg.expert_d_ff
    d, fl = cfg.d_model, f // parts

    def join(w):
        return w.reshape(E, parts, d, fl).transpose(1, 2).reshape(E, d, f)

    return join(p["wi"]), join(p["wg"]), p["wo"].reshape(E, parts * fl, d)


def _route(p, cfg: ModelConfig, xf):
    """Router: the product in the compute dtype, softmax in fp32, the top
    k gates in descending order renormalised to sum 1, and the
    load-balancing loss from the first choice's density.  xf: (T, D).
    Returns (top_g (T,K) fp32, top_e (T,K), aux 0-d fp32)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = cast(xf) @ cast(p["router"])
    gates = torch.softmax(logits.float(), dim=-1)                 # (T, E)
    top_g, top_e = torch.topk(gates, K, dim=-1, sorted=True)      # (T, K)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = cfg.router_aux_loss * E * torch.sum(density * gates.mean(0))
    return top_g, top_e, aux


def _sorted_assignments(top_g, top_e, T: int, E: int):
    """The T*K (token, k) assignments, flattened token-major and stably
    sorted by expert; ``pos_in_e`` is each one's rank within its expert
    (the exclusive cumsum of the one-hot), which decides who keeps a slot.
    Returns (se, sg, st, pos_in_e)."""
    K = top_e.shape[1]
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    sg = top_g.reshape(-1)[order]
    st = torch.arange(T, device=top_e.device).repeat_interleave(K)[order]
    # the one-hot is laid out (E, TK) so the cumsum runs along the inner
    # dim: the same integers, but CUDA scans an outer dim one column per
    # thread, which took 200 of the 260 ms of device time of a full-width
    # granite prefill of 8 x 512 on an H100
    same = F.one_hot(se, E).t().contiguous()                      # (E, TK)
    excl = torch.cumsum(same, dim=1) - same
    pos_in_e = excl[se, torch.arange(se.shape[0], device=se.device)]
    return se, sg, st, pos_in_e


def _slot_tables(se, sg, st, pos_in_e, *, num_slots: int, cap: int,
                 slot_of, cap_pos):
    """Scatter the sorted assignments into dense (num_slots * cap,)
    tables (tok, gate, used).  An assignment past its slot's capacity goes
    to index num_slots * cap, one past the end, and is dropped, as JAX's
    ``mode="drop"``.  Unused slots hold token 0 with used = 0."""
    n = num_slots * cap
    ids = torch.where(cap_pos < cap, slot_of * cap + cap_pos, n)
    dev = se.device
    tok = torch.zeros(n + 1, dtype=torch.long, device=dev)
    gate = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    used = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    tok[ids] = st
    gate[ids] = sg.float()
    used[ids] = 1.0
    return tok[:n], gate[:n], used[:n]


def _moe_reference(p, cfg: ModelConfig, x):
    """Capacity-bounded gather dispatch on one device: each expert takes
    its first C = ceil(T K / E * capacity_factor) assignments (at most T)
    in the stable sort's order, runs SwiGLU on them as three batched
    products, and the gate-weighted outputs are added back to their
    tokens in the compute dtype.  On a CUDA tensor that add is
    ``index_add_``'s atomics, whose order is not fixed, so a bf16 result
    may differ in the last bit from run to run.  Returns (y, aux)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, D)
    top_g, top_e, aux = _route(p, cfg, xf)
    se, sg, st, pos_in_e = _sorted_assignments(top_g, top_e, T, E)
    C = max(min(math.ceil(T * K / E * cfg.capacity_factor), T), 1)
    tok, gate, used = _slot_tables(se, sg, st, pos_in_e, num_slots=E, cap=C,
                                   slot_of=se, cap_pos=pos_in_e)

    wi, wg, wo = _dense_expert_weights(p, cfg)
    xe = cast(xf)[tok].reshape(E, C, D)
    xe = xe * used.reshape(E, C, 1).to(xe.dtype)
    h = F.silu(torch.bmm(xe, cast(wg))) * torch.bmm(xe, cast(wi))
    ye = torch.bmm(h, cast(wo))
    ye_flat = ye.reshape(E * C, D) * (gate * used)[:, None].to(ye.dtype)
    y = torch.zeros((T, D), dtype=ye_flat.dtype, device=x.device)
    return y.index_add(0, tok, ye_flat).reshape(B, S, D), aux


def moe(p, cfg: ModelConfig, x):
    """Top-k MoE on one device: ``_moe_reference``.  ``repro``'s
    expert-parallel branch (a ``shard_map`` over the model axis with one
    combine psum) waits for the port's distributed slice.
    Returns (y, aux_loss)."""
    return _moe_reference(p, cfg, x)


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
