"""Layers of every family: rmsnorm and layernorm, rotary, GQA attention
(self and cross, with the ring cache's decode and the cross cache's),
SwiGLU and gelu MLPs, top-k MoE, embedding.  The PyTorch counterpart of
``repro/models/layers.py``.

Under a model axis (inside the manual region of a ``use_rules`` mesh whose
``"model"`` axis is larger than 1, ``model_axis.split_for``) five layers
split their work over the model ranks, as ``repro``'s rules shard the
activations, and sum with explicit collectives: attention by padded heads
(``heads_act``; cross-attention too, over an encoder output entered once
through ``cross_source``), the MLP by d_ff (``mlp_act``), the MoE by
virtual experts (``experts_virt``, ``repro``'s expert-parallel branch),
the embedding lookup, unembedding and cross-entropy by vocabulary rows
(``vocab_act``), and the SSM mixer (``models/ssm.py``) by whole SSD heads
(``ssm_inner_act``, ``ssm_heads`` here).
A leaf the rules map to ``"model"`` arrives as this rank's shard where the
guard keeps the dim (``dp_shard.ShardPlan.for_storage``), else whole; a
layer takes its part of each leaf through ``model_storage.take``
(``work`` and ``whole`` here, ``work_runs`` the ranges), which uses an
aligned shard as it is and gathers any other.  ``model_partial_leaves``
names the leaves stored whole whose gradient a rank then holds only in
part; ``leaf_rules`` gives each leaf's rule from the config alone.

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
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import model_axis, model_storage
from repro_torch.distributed.sharding_rules import (TRAIN_RULES,
                                                    ShardingCtx, current_ctx,
                                                    model_dims)
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


def layernorm_specs(d: int):
    return {"scale": spec((d,), ("embed",), init="ones"),
            "bias": spec((d,), ("embed",), init="zeros")}


def layernorm(p, x, eps: float):
    """In fp32 with the population variance (JAX's ``jnp.var``; note
    ``torch.var`` defaults to the sample variance), cast back to x's
    type.  Plain PyTorch on every device: JAX computes it outside any
    Pallas kernel."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def norm_specs(cfg: ModelConfig):
    return layernorm_specs(cfg.d_model) if cfg.family == "encdec" \
        else rmsnorm_specs(cfg.d_model)


def norm(p, x, cfg: ModelConfig):
    return layernorm(p, x, cfg.norm_eps) if "bias" in p \
        else rmsnorm(p, x, cfg.norm_eps)


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
def attention_specs(cfg: ModelConfig, cross: bool = False):
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
    if cfg.qk_norm and not cross:
        p["q_norm"] = spec((cfg.head_dim,), (None,), init="ones")
        p["k_norm"] = spec((cfg.head_dim,), (None,), init="ones")
    return p


def _project_q(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    q = cast(x) @ cast(whole(p, cfg, "attn.wq"))
    if "bq" in p:
        q = q + cast(whole(p, cfg, "attn.bq"))
    return q.view(B, S, cfg.num_heads, cfg.head_dim)


def _project_qkv(p, cfg: ModelConfig, x, kv_x=None):
    """Q from x, K and V from ``kv_x`` (x itself unless cross-attention),
    each viewed as heads over its own length."""
    kv_x = cast(x if kv_x is None else kv_x)
    B, T, _ = kv_x.shape
    q = _project_q(p, cfg, x)
    k = kv_x @ cast(whole(p, cfg, "attn.wk"))
    v = kv_x @ cast(whole(p, cfg, "attn.wv"))
    if "bk" in p:
        k = k + cast(whole(p, cfg, "attn.bk"))
        v = v + cast(whole(p, cfg, "attn.bv"))
    k = k.view(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.view(B, T, cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = ops.rmsnorm(q, p["q_norm"], eps=cfg.norm_eps)
        k = ops.rmsnorm(k, p["k_norm"], eps=cfg.norm_eps)
    return q, k, v


def _heads_shards() -> int:
    """Number of shards the heads_act rule would apply (1 outside a mesh)."""
    ctx = current_ctx()
    if ctx is None:
        return 1
    n = 1
    for a in ctx.mesh_axes_for("heads_act"):
        n *= ctx.shape[a]
    return n


def _pad_plan(num_heads: int, num_kv: int, shards: int):
    """Smallest (K2, G2) with K2 >= K, G2 >= G and K2*G2 % shards == 0.

    Sharding attention by heads requires head count divisible by the model
    axis; five assigned archs (yi 56H, qwen2 14H, whisper 20H, granite 24H,
    hymba 25H) are not.  Padding GQA groups (and kv heads when needed) costs
    (K2*G2/H - 1) extra attention flops — always far below the 16x waste of
    replicating attention over the model axis, and it keeps the parameter
    layout unchanged (activations are padded, not weights)."""
    if shards <= 1 or num_heads % shards == 0:
        return None
    g = num_heads // num_kv
    best = None
    for k2 in range(num_kv, num_kv + shards + 1):
        for g2 in range(g, g + shards + 1):
            if (k2 * g2) % shards == 0:
                if best is None or k2 * g2 < best[0] * best[1]:
                    best = (k2, g2)
    return best


class RankHeads(NamedTuple):
    """A model rank's slice of the padded heads: the plan (K2, G2), the
    rank's padded head count, the slots among them that hold real heads
    and those heads' indices, the kv heads [k0, k1) its groups use (those
    past K are padding), and for each of its ``count`` slots the index
    within [k0, k1) of the kv head it reads."""
    plan: Tuple[int, int]
    count: int
    slots: Tuple[int, ...]
    heads: Tuple[int, ...]
    k0: int
    k1: int
    kv: Tuple[int, ...]

    @property
    def uniform(self) -> bool:
        """Does every kv head of the slice serve the same number of its
        slots (whole GQA groups, or a slice of one group)?"""
        G2 = self.plan[1]
        return self.count % G2 == 0 or G2 % self.count == 0


def rank_heads(cfg: ModelConfig, shards: int, rank: int) -> RankHeads:
    """Rank ``rank`` of ``shards`` owns padded heads [rank * H2 / shards,
    (rank + 1) * H2 / shards) of the plan (K2, G2) (``_pad_plan``, or (K,
    G) when the heads divide), padded head j being slot j % G2 of kv group
    j // G2, real when the group is below K and the slot below G.  A
    slice may straddle GQA groups (hymba's 25 / 5 heads: plan (5, 6) at
    model 2 gives rank 0 groups 0 and 1 whole and half of group 2), and
    it may hold padding only (15 / 3 heads at model 4: plan (4, 5), rank 3
    holds group 3, past K)."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    G = H // K
    plan = _pad_plan(H, K, shards) or (K, G)
    K2, G2 = plan
    count = K2 * G2 // shards
    j0 = rank * count
    k0 = j0 // G2
    slots, heads, kv = [], [], []
    for s in range(count):
        kk, g = divmod(j0 + s, G2)
        kv.append(kk - k0)
        if kk < K and g < G:
            slots.append(s)
            heads.append(kk * G + g)
    return RankHeads(plan, count, tuple(slots), tuple(heads), k0,
                     (j0 + count - 1) // G2 + 1, tuple(kv))


def ssm_heads(cfg: ModelConfig, shards: int, rank: int) -> Tuple[int, int]:
    """The SSD heads [h0, h1) model rank ``rank`` of ``shards`` computes:
    whole heads, the first ``nh % shards`` ranks one more than the rest
    where they do not divide (hymba's 50 at model 4: 13 / 13 / 12 / 12).
    Raises ``NotImplementedError`` where a rank would hold none."""
    nh = cfg.ssm_num_heads
    if nh < shards:
        raise NotImplementedError(f"{cfg.name}: {nh} SSD heads over "
                                  f"{shards} model ranks")
    base, extra = divmod(nh, shards)
    h0 = rank * base + min(rank, extra)
    return h0, h0 + base + (rank < extra)


def _runs(heads):
    """Consecutive head indices as [start, stop) runs."""
    runs = []
    for h in heads:
        if runs and runs[-1][1] == h:
            runs[-1][1] = h + 1
        else:
            runs.append([h, h + 1])
    return runs


# each model-mapped leaf kind: (which work range, its model dim)
_MODEL_LEAVES = {
    "attn.wq": ("q", -1), "attn.bq": ("q", 0), "attn.wo": ("q", 0),
    "attn.wk": ("kv", -1), "attn.wv": ("kv", -1), "attn.bk": ("kv", 0),
    "attn.bv": ("kv", 0),
    "mlp.wi": ("mlp", -1), "mlp.wg": ("mlp", -1), "mlp.bi": ("mlp", 0),
    "mlp.wo": ("mlp", 0),
    "moe.wi": ("experts", 0), "moe.wg": ("experts", 0),
    "moe.wo": ("experts", 0),
    "embed.tokens": ("vocab", 0), "embed.unembed": ("vocab", -1),
    "ssm.in_x": ("inner", -1), "ssm.in_z": ("inner", -1),
    "ssm.gate_norm": ("inner", 0), "ssm.out": ("inner", 0),
    "ssm.in_dt": ("ssm_heads", -1), "ssm.dt_bias": ("ssm_heads", 0),
    "ssm.A_log": ("ssm_heads", 0), "ssm.D": ("ssm_heads", 0),
    "ssm.conv_w": ("conv", -1), "ssm.conv_b": ("conv", 0),
}


def _model_size(cfg: ModelConfig, what: str) -> int:
    """Elements of a leaf's model dim: the flattened heads, kv heads,
    d_ff, the stored expert rows (virtual when parts > 1), the
    vocabulary, the SSM's inner width, its heads, its conv channels."""
    if what == "inner":
        return cfg.d_inner
    if what == "ssm_heads":
        return cfg.ssm_num_heads
    if what == "conv":
        return cfg.d_inner + 2 * cfg.ssm_num_groups * cfg.ssm_state_dim
    return {"q": cfg.num_heads * cfg.head_dim,
            "kv": cfg.num_kv_heads * cfg.head_dim, "mlp": cfg.d_ff,
            "experts": cfg.num_experts * _moe_parts(cfg),
            "vocab": cfg.vocab_size}[what]


def work_runs(cfg: ModelConfig, kind: str, n: int, rank: int):
    """The [lo, hi) ranges of leaf kind ``kind``'s model dim (``attn.wq``,
    ``mlp.wo``, ``moe.wi``, ``embed.tokens``, ...) that model rank
    ``rank`` of ``n`` computes with under a split of the work: the real
    heads of its ``rank_heads`` slice (``q``), the real kv heads its
    groups use (``kv``), its d_ff slice, its ``Vloc`` virtual experts (as
    rows of the stored experts, wrapping when replicas round E up), its
    rows of the vocabulary padded to a multiple of ``n``, and the SSM's
    by its ``ssm_heads``: their inner columns (``inner``), the heads
    themselves (``ssm_heads``), and of the conv's channels their ``x``
    channels and every B / C channel (``conv``)."""
    what = _MODEL_LEAVES[kind][0]
    if what in ("inner", "ssm_heads", "conv"):
        h0, h1 = ssm_heads(cfg, n, rank)
        if what == "ssm_heads":
            return [(h0, h1)]
        hd, din = cfg.ssm_head_dim, cfg.d_inner
        runs = [(h0 * hd, h1 * hd)]
        return runs + [(din, _model_size(cfg, "conv"))] if what == "conv" \
            else runs
    if what in ("q", "kv"):
        hd, K = cfg.head_dim, cfg.num_kv_heads
        rh = rank_heads(cfg, n, rank)
        if what == "q":
            return [(a * hd, b * hd) for a, b in _runs(rh.heads)]
        return model_storage.runs_of_range(rh.k0 * hd,
                                           max(rh.k0, min(rh.k1, K)) * hd)
    if what == "mlp":
        f = cfg.d_ff // n
        return [(rank * f, (rank + 1) * f)]
    if what == "experts":
        E, parts = cfg.num_experts, _moe_parts(cfg)
        if parts > 1:
            vloc = E * parts // n
            return [(rank * vloc, (rank + 1) * vloc)]
        vloc = math.ceil(E / n)
        out = []
        for v in range(rank * vloc, (rank + 1) * vloc):
            e = v % E
            if out and out[-1][1] == e:
                out[-1] = (out[-1][0], e + 1)
            else:
                out.append((e, e + 1))
        return out
    off, _, rows = _vocab_rows(cfg, n, rank)
    return model_storage.runs_of_range(off, off + rows)


def work(p, cfg: ModelConfig, kind: str, split):
    """This rank's part of leaf ``kind`` of group ``p`` under the work
    split ``split`` (``model_storage.take``: an aligned shard as it is,
    any other leaf gathered or narrowed)."""
    what, dim = _MODEL_LEAVES[kind]
    return model_storage.take(
        p[kind.split(".")[1]], dim, _model_size(cfg, what), kind=kind,
        runs_of=lambda r: work_runs(cfg, kind, split.size, r), split=split,
        dtype=COMPUTE_DTYPE)


def whole(p, cfg: ModelConfig, kind: str):
    """Leaf ``kind`` of group ``p`` whole: as it is, or gathered over the
    model ranks where it is stored split (its gradient then this rank's
    slice: the leaf is used whole on replicated inputs)."""
    what, dim = _MODEL_LEAVES[kind]
    return model_storage.take(p[kind.split(".")[1]], dim,
                              _model_size(cfg, what), kind=kind,
                              dtype=COMPUTE_DTYPE)


def _leaf_spec(cfg: ModelConfig, kind: str):
    """Leaf ``kind``'s spec, or None where ``cfg``'s layers have no such
    leaf."""
    group, leaf = kind.split(".")
    if group == "ssm":
        if not cfg.ssm_state_dim:
            return None
        from repro_torch.models.ssm import ssm_specs
        return ssm_specs(cfg).get(leaf)
    if group == "attn" and not cfg.uses_attention \
            or group == "mlp" and cfg.family in ("ssm", "moe") \
            or group == "moe" and cfg.family != "moe":
        return None
    specs = {"attn": attention_specs, "mlp": mlp_specs, "moe": moe_specs,
             "embed": embed_specs}[group](cfg)
    return specs.get(leaf)


def _stored_split(ctx: ShardingCtx, cfg: ModelConfig, kind: str) -> bool:
    """Does ``ctx``'s rule set store leaf ``kind`` split over ``"model"``
    (the guard keeping its dim)?"""
    s = _leaf_spec(cfg, kind) if kind in _MODEL_LEAVES else None
    return s is not None and bool(model_dims(ctx, s.axes, s.shape))


class _ModelMesh:
    """A mesh-shaped stand-in: (data 1, model n)."""

    def __init__(self, n: int):
        self.shape = {"data": 1, "model": n}


def leaf_rules(cfg: ModelConfig, n: int, rules=TRAIN_RULES):
    """{leaf kind: ``model_storage`` rule} of every model-mapped leaf of
    ``cfg``'s layers and embedding at a model axis of ``n`` under
    ``rules``, for the training step's split (the expert-parallel MoE):
    ``"aligned"``, ``"unaligned"`` or ``"whole"``.  A pure function of the
    config: ``model_storage.take`` reaches the same rule from the shapes it
    is handed."""
    ctx = ShardingCtx(_ModelMesh(n), rules)
    out = {}
    for kind, (what, _) in _MODEL_LEAVES.items():
        if _leaf_spec(cfg, kind) is None:
            continue
        out[kind] = model_storage.rule(
            _model_size(cfg, what), n, _stored_split(ctx, cfg, kind),
            lambda r, k=kind: work_runs(cfg, k, n, r))
    return out


def _attention_split(p, cfg: ModelConfig, x, split, *, positions, causal,
                     window, num_sink, rope, full_kv, seq=None, kv_x=None):
    """``attention`` on this model rank's slice of the padded heads
    (``rank_heads``): q projected for its real heads only and zero in the
    pad slots, K/V for the kv heads its groups use (zero for a pad kv
    head), qk-norm and rotary per head, flash over (B, S, count, hd), the
    real heads' outputs times their rows of ``wo``, summed over the model
    ranks (``model_axis.enter`` / ``leave``: with ``seq`` x and y are this
    rank's block of the tokens).  A pad head's output is dropped before
    ``wo``, so its dO is 0 and it adds no gradient.  Each weight is this
    rank's part (``work``), the K/V weights whole if ``full_kv``.  Returns
    (y, k, v): K/V of every kv head if ``full_kv`` (prefill's cache), else
    of this rank's.  Cross-attention (``kv_x``, whole on every rank and
    entered into the split by the caller, ``cross_source``) projects K/V
    from ``kv_x`` the same way: the rank's kv heads, or with ``full_kv``
    every kv head.

    A slice that straddles GQA groups (not ``uniform``: its kv heads serve
    6, 6 and 3 of its slots) expands its kv heads to one per slot by an
    index on the head dim (``rank_heads``' ``kv``) and runs one flash call
    with groups of one, the MHA path; the index's backward sums each
    slot's dK / dV into its kv head.  One flash call per run of whole
    groups would keep K/V unexpanded but launch up to three kernels a
    layer, forward and backward, each over a few heads; the expanded K/V
    cost G2 times the bytes of the rank's K/V, less than its q.  A rank
    with no real head (padding only) attends over nothing: its y is the
    product of its zero-width q with the zero rows of ``wo`` it holds plus
    zero-width sums of its K and V, 0 but a function of every leaf it
    took, so every rank issues the same collectives forward and backward
    (a gathered leaf's reduce-scatter included)."""
    xin = cast(model_axis.enter(x, split, seq))
    kv_in = xin if kv_x is None else cast(kv_x)
    B, S, _ = xin.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    rh = rank_heads(cfg, split.size, split.rank)
    kr0, kr1 = rh.k0, max(rh.k0, min(rh.k1, K))       # the real kv heads

    def part(leaf):
        return work(p, cfg, "attn." + leaf, split)

    def kv_part(leaf):
        return whole(p, cfg, "attn." + leaf) if full_kv else part(leaf)

    def project(src, w, b):
        y = src @ cast(w)
        if b is not None:
            y = y + cast(b)
        return y.view(B, src.shape[1], y.shape[-1] // hd, hd)

    bias = "bq" in p
    q = project(xin, part("wq"), part("bq") if bias else None)
    k = project(kv_in, kv_part("wk"), kv_part("bk") if bias else None)
    v = project(kv_in, kv_part("wv"), kv_part("bv") if bias else None)
    if "q_norm" in p:
        if rh.heads:
            q = ops.rmsnorm(q, p["q_norm"], eps=cfg.norm_eps)
        if k.shape[2]:
            k = ops.rmsnorm(k, p["k_norm"], eps=cfg.norm_eps)
    if rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    if not rh.heads:
        y = q.flatten(2) @ cast(part("wo"))
        for t in (k, v):          # zero-width: K/V's gathers see a gradient
            y = y + t.flatten(2)[..., :0].sum(-1, keepdim=True)
        return model_axis.leave(y, split, seq), k, v
    padded = len(rh.heads) < rh.count
    if padded:
        slots = torch.tensor(rh.slots, dtype=torch.long, device=x.device)
        q = q.new_zeros(B, S, rh.count, hd).index_copy(2, slots, q)
    kl, vl = (t[:, :, kr0:kr1] for t in (k, v)) if full_kv else (k, v)
    pad_kv = (rh.k1 - rh.k0) - (kr1 - kr0)
    if pad_kv:
        kl, vl = (F.pad(t, (0, 0, 0, pad_kv)) for t in (kl, vl))
    if not rh.uniform:
        per_slot = torch.tensor(rh.kv, dtype=torch.long, device=x.device)
        kl, vl = (t.index_select(2, per_slot) for t in (kl, vl))
    out = ops.attention(q, kl, vl, causal=causal, window=window,
                        num_sink=num_sink)
    if padded:
        out = out[:, :, slots]
    y = out.reshape(B, S, len(rh.heads) * hd) @ cast(part("wo"))
    return model_axis.leave(y, split, seq), k, v


def attention(p, cfg: ModelConfig, x, *, positions, causal: bool = True,
              window: int = 0, num_sink: int = 0, kv_x=None,
              rope: bool = True, full_kv: bool = True, seq=None):
    """Full-sequence attention (train, prefill, the encoder, and with
    ``kv_x`` (B,T,D) cross-attention over it).  x: (B,S,D).

    Returns (y, k, v): the output and the K and V attended over (after
    rotary if ``rope``), which prefill writes into the decode cache, so
    the layer stack runs once.  Under a model split of the heads (self- and
    cross-attention) each rank attends over its slice of the padded heads
    (``_attention_split``); its k and v are then every kv head's only if
    ``full_kv``, and ``kv_x`` must come through ``cross_source``.  With
    ``seq`` (``stack.sp_split``) x and y are this rank's block of the
    tokens, the sequence gathered in between; ``positions`` are the whole
    sequence's."""
    split = model_axis.split_for("heads_act")
    if split is not None:
        return _attention_split(p, cfg, x, split, positions=positions,
                                causal=causal, window=window,
                                num_sink=num_sink, rope=rope, full_kv=full_kv,
                                seq=seq, kv_x=kv_x)
    x = model_axis.enter(x, None, seq)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=causal, window=window,
                        num_sink=num_sink)
    y = out.reshape(B, S, cfg.num_heads * cfg.head_dim) \
        @ cast(whole(p, cfg, "attn.wo"))
    return model_axis.leave(y, None, seq), k, v


def cross_source(enc, seq=None):
    """The encoder's output as cross-attention reads it in every decoder
    layer: whole on every rank, its gradient summed over the model ranks
    once for all the layers (``model_axis.enter`` for the heads split:
    each rank's K/V use only its kv heads' part of it).  With ``seq``
    (the encoder's ``stack.sp_split``) ``enc`` is this rank's block of
    the positions, gathered whole here."""
    return model_axis.enter(enc, model_axis.split_for("heads_act"), seq)


def attention_decode(p, cfg: ModelConfig, x, kv_cache, *, positions,
                     window: int = 0, num_sink: int = 0, ring: bool = False,
                     rope: bool = True, cross_kv=None, kv=None):
    """Single-step decode.  x: (B,1,D); positions: (B,) absolute positions;
    kv_cache: {"k","v"} of shape (B,T,K,hd).

    With ``cross_kv`` (the cached cross K and V, (B,T_src,K,hd) each) it
    is cross-attention: Q alone is projected and attends, not causally,
    over them; ``kv_cache`` is not read or written.  With ``kv`` too the
    cross K/V are rank r's block of T_src/n encoder positions, attended
    over (the block is not ragged: on the card the flash forward kernel,
    writing its lse too) and combined across the ranks as the self K/V
    blocks below.

    The new K/V are written into ``kv_cache`` in place (the engine owns
    the cache, as JAX's donated buffer).  Without ``ring`` T is the full
    context and windowing is a mask; with ``ring`` the cache is a ring of
    T slots (every layer windowed, T = min(max_len, window)): position p
    is written to slot p % T and each slot is masked by the absolute
    position it holds, as ``repro``'s ``attention_decode`` does.

    With ``kv`` (a split of the n model ranks, ``stack.kv_split``) the
    cache holds rank r's block of T/n slots, [r T/n, (r + 1) T/n) of the
    whole: the rank that owns the new slot writes it, each rank attends
    with every query head over its slots (``ops.attention_partial``), and
    the ranks' partial softmaxes are combined (``ops.combine_partial``
    over one all-gather of each rank's output and lse: the max of the lse,
    then the weighted sums), as ``repro``'s decode over a cache its rules
    shard on ``kv_seq``."""
    B = x.shape[0]
    if cross_kv is not None:
        q = _project_q(p, cfg, x)
        k, v = (t.to(q.dtype) for t in cross_kv)    # no copy when equal
        if kv is None:
            out = ops.attention(q, k, v, causal=False)
        else:
            part, lse = ops.attention_partial(q, k, v, causal=False)
            out = ops.combine_partial(
                part, lse, lambda t: model_axis.stack_ranks(t, kv)
            ).to(q.dtype)
        return out.reshape(B, 1, cfg.num_heads * cfg.head_dim) \
            @ cast(whole(p, cfg, "attn.wo"))
    q, k_new, v_new = _project_qkv(p, cfg, x)
    if rope:
        q = rotary(q, positions[:, None], cfg.rope_theta)
        k_new = rotary(k_new, positions[:, None], cfg.rope_theta)

    k_cache, v_cache = kv_cache["k"], kv_cache["v"]
    n, lo = (1, 0) if kv is None else (kv.size, kv.rank * k_cache.shape[1])
    T = k_cache.shape[1] * n
    slot = positions % T if ring else positions
    bidx = torch.arange(B, device=x.device)
    if kv is None:
        k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)
    else:
        # rows whose slot another rank holds write their old value back
        own = ((slot >= lo) & (slot < lo + k_cache.shape[1]))[:, None, None]
        local = (slot - lo).clamp(0, k_cache.shape[1] - 1)
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            cache[bidx, local] = torch.where(own, new[:, 0].to(cache.dtype),
                                             cache[bidx, local])

    j = lo + torch.arange(k_cache.shape[1], device=x.device)[None, :]
    pos_b = positions[:, None]
    if ring:
        # the absolute position each slot holds; a slot not written yet
        # lands at a negative position, which the mask drops
        kv_pos = pos_b - (pos_b - j) % T
        kv_pos = torch.where(kv_pos > pos_b, -(10 ** 9), kv_pos)
        kv_valid = None
    else:
        kv_pos = j.expand(B, j.shape[1])
        kv_valid = positions + 1
    mask = dict(causal=True, q_pos=pos_b, kv_pos=kv_pos, kv_valid=kv_valid,
                window=window, num_sink=num_sink)
    if kv is None:
        out = ops.attention(q, k_cache, v_cache, **mask)
    else:
        part, lse = ops.attention_partial(q, k_cache, v_cache, **mask)
        out = ops.combine_partial(
            part, lse, lambda t: model_axis.stack_ranks(t, kv)).to(q.dtype)
    return out.reshape(B, 1, cfg.num_heads * cfg.head_dim) \
        @ cast(whole(p, cfg, "attn.wo"))


# --------------------------------------------------------------------------
# MLP (SwiGLU, or gelu with biases)
# --------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_activation == "gelu":
        return {
            "wi": spec((d, f), ("embed", "mlp")),
            "bi": spec((f,), ("mlp",), init="zeros"),
            "wo": spec((f, d), ("mlp", "embed")),
            "bo": spec((d,), ("embed",), init="zeros"),
        }
    return {
        "wi": spec((d, f), ("embed", "mlp")),
        "wg": spec((d, f), ("embed", "mlp")),
        "wo": spec((f, d), ("mlp", "embed")),
    }


def _mlp_split(cfg: ModelConfig):
    """The model split of d_ff, or None (none, or d_ff does not divide:
    the rule's divisibility guard replicates)."""
    split = model_axis.split_for("mlp_act")
    return split if split is not None and cfg.d_ff % split.size == 0 \
        else None


def mlp(p, cfg: ModelConfig, x, *, seq=None):
    """The gelu MLP is ``jax.nn.gelu``'s default, the tanh approximation
    (``F.gelu``'s default is the exact erf form).  Under a model split of
    d_ff each rank takes its slice of the ``wi`` / ``wg`` columns (and
    ``bi``) and ``wo`` rows (``work``); the outputs are summed over the
    ranks (into this rank's block of the tokens with ``seq``) and the
    output bias ``bo`` added once, after the sum."""
    split = _mlp_split(cfg)
    x = cast(model_axis.enter(x, split, seq))
    if split is not None:
        def w(leaf):
            return cast(work(p, cfg, "mlp." + leaf, split))
    else:
        def w(leaf):
            return cast(whole(p, cfg, "mlp." + leaf))
    if "bi" in p:
        h = F.gelu(x @ w("wi") + w("bi"), approximate="tanh")
    else:
        h = F.silu(x @ w("wg")) * (x @ w("wi"))
    y = model_axis.leave(h @ w("wo"), split, seq)
    return y + cast(p["bo"]) if "bo" in p else y


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
    """Un-virtualise (V, d, f/parts) -> (E, d, f) (and wo to (E, f, d)),
    each leaf whole (``whole``)."""
    parts = _moe_parts(cfg)
    wi, wg, wo = (whole(p, cfg, "moe." + k) for k in ("wi", "wg", "wo"))
    if parts == 1:
        return wi, wg, wo
    E, f = cfg.num_experts, cfg.expert_d_ff
    d, fl = cfg.d_model, f // parts

    def join(w):
        return w.reshape(E, parts, d, fl).transpose(1, 2).reshape(E, d, f)

    return join(wi), join(wg), wo.reshape(E, parts * fl, d)


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
    density = _one_hot(top_e[:, 0], E).float().mean(0)
    aux = cfg.router_aux_loss * E * torch.sum(density * gates.mean(0))
    return top_g, top_e, aux


def _one_hot(ids, n: int, *, classes_first: bool = False):
    """The int64 one-hot of 1-D ``ids`` over ``n`` classes, (N, n), or
    (n, N) with ``classes_first``: a comparison against ``arange(n)``,
    which takes the same ops on every device (``F.one_hot`` checks the
    values on the CPU, scatters on CUDA and compares on meta), so the
    dry-run counts the card's work on meta and on the CPU alike."""
    cls = torch.arange(n, device=ids.device)
    if classes_first:
        return (cls[:, None] == ids[None, :]).long()
    return (ids[:, None] == cls[None, :]).long()


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
    same = _one_hot(se, E, classes_first=True)                   # (E, TK)
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


def _ep_split():
    """The expert-parallel split, taken under ``repro``'s conditions: a
    context, batch axes manual, one EP axis larger than 1
    (``split_for("experts_virt")``), and ``REPRO_MOE_EP`` not ``"0"``."""
    return model_axis.split_for("experts_virt") if model_axis.ep_enabled() \
        else None


def _moe_ep(p, cfg: ModelConfig, x, split, seq=None):
    """``repro``'s expert-parallel branch.  Routing and the slot tables
    are computed on every rank from the replicated tokens; each rank runs
    its ``Vloc`` virtual experts on the tokens routed to them and the
    gate-weighted outputs are summed over the ranks (the combine).

    * parts > 1: V = E * parts f-slices; every part of an expert receives
      the same capacity slots; rank r holds rows [r Vloc, (r+1) Vloc) of
      the virtual stack;
    * parts = 1: V rounds E up to the ranks; virtual slot v runs expert
      v % E, an expert's assignments alternating over its replicas
      (``v = replica * E + expert``) with a capacity per virtual slot.

    The gates and the dispatched tokens enter the split through
    ``to_model``, so the router's gradient is whole on every rank.  With
    ``seq`` x is this rank's block of the tokens, gathered whole first;
    the gather's reduce-scatter then sums every partial gradient of the
    tokens, so the gates and tokens enter as they are, the router's
    gradient is partial (``model_partial_leaves``) and the aux loss, which
    every rank computes alike, counts on one rank (``model_axis.once``);
    the combine reduce-scatters into the block."""
    if seq is not None:
        x = model_axis.gather_seq(x, seq)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    parts = _moe_parts(cfg)
    n, r = split.size, split.rank
    T = B * S
    xf = x.reshape(T, D)
    top_g, top_e, aux = _route(p, cfg, xf)
    if seq is None:
        top_g = model_axis.to_model(top_g, split)
        xd = model_axis.to_model(xf, split)
    else:
        aux, xd = model_axis.once(aux, split), xf
    se, sg, st, pos_in_e = _sorted_assignments(top_g, top_e, T, E)
    if parts > 1:
        V = E * parts
        if V % n:
            raise NotImplementedError(
                f"{cfg.name}: {V} virtual experts over {n} model ranks")
        C = max(min(math.ceil(T * K / E * cfg.capacity_factor), T), 1)
        tables = _slot_tables(se, sg, st, pos_in_e, num_slots=E, cap=C,
                              slot_of=se, cap_pos=pos_in_e)
        tok, gate, used = (t.reshape(E, 1, C).expand(E, parts, C).reshape(-1)
                           for t in tables)
    else:
        V = math.ceil(E / n) * n
        C = max(math.ceil(T * K / V * cfg.capacity_factor), 1)
        n_virt = (V - se - 1) // E + 1          # replicas of this expert
        v_of = (pos_in_e % n_virt) * E + se
        tok, gate, used = _slot_tables(se, sg, st, pos_in_e, num_slots=V,
                                       cap=C, slot_of=v_of,
                                       cap_pos=pos_in_e // n_virt)
    Vloc = V // n
    lo = r * Vloc
    wi, wg, wo = (work(p, cfg, "moe." + k, split) for k in ("wi", "wg", "wo"))
    sl = slice(lo * C, (lo + Vloc) * C)
    tok, gate, used = tok[sl], gate[sl], used[sl]
    xe = cast(xd)[tok].reshape(Vloc, C, D)
    xe = xe * used.reshape(Vloc, C, 1).to(xe.dtype)
    h = F.silu(torch.bmm(xe, cast(wg))) * torch.bmm(xe, cast(wi))
    ye = torch.bmm(h, cast(wo))
    ye_flat = ye.reshape(Vloc * C, D) * (gate * used)[:, None].to(ye.dtype)
    y = torch.zeros((T, D), dtype=ye_flat.dtype, device=x.device)
    y = y.index_add(0, tok, ye_flat).reshape(B, S, D)
    return model_axis.leave(y, split, seq), aux


def moe(p, cfg: ModelConfig, x, *, seq=None):
    """Top-k MoE: ``_moe_reference`` on one device, ``repro``'s
    expert-parallel branch (``_moe_ep``) under a model split of the
    virtual experts; with ``seq`` x and y are this rank's block of the
    tokens.  Returns (y, aux_loss)."""
    split = _ep_split()
    if split is not None:
        return _moe_ep(p, cfg, x, split, seq)
    y, aux = _moe_reference(p, cfg, model_axis.enter(x, None, seq))
    return model_axis.leave(y, None, seq), aux


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


def _vocab_rows(cfg: ModelConfig, n: int, rank: int):
    """(offset, Vloc, real rows) of model rank ``rank``'s slice of the
    vocabulary padded to Vp = ceil(V / n) * n rows."""
    V = cfg.vocab_size
    Vloc = -(-V // n)
    off = rank * Vloc
    return off, Vloc, max(0, min(V, off + Vloc) - off)


def _vocab_weight(p, cfg: ModelConfig, split):
    """This rank's real rows of the unembedding as a (D, rows) view (the
    tied table's rows, transposed; ``work``), in the compute dtype."""
    w = work(p, cfg, "embed.tokens", split).t() if cfg.tie_embeddings \
        else work(p, cfg, "embed.unembed", split)
    return cast(w)


def embed(p, cfg: ModelConfig, tokens, *, seq=None):
    """The lookup.  A table stored split over the vocabulary (under a
    model split of it) is looked up vocabulary-parallel, as Megatron's
    ``VocabParallelEmbedding``: each rank looks up the tokens its rows hold
    and writes zero for the rest, and ``from_model`` sums over the ranks,
    the same bits as the whole lookup; each rank's rows then take their
    whole gradient.  A table stored whole is looked up whole on every
    rank; under a model split of the vocabulary a tied one's lookup
    gradient keeps this rank's rows only (``own_rows_grad``): the
    unembedding's part is per rank, and the once-a-step sum then adds each
    row once.  With ``seq`` the result is this rank's block of the tokens
    (the vocabulary-parallel sum reduce-scattered into it)."""
    t = p["tokens"]
    split = model_axis.split_for("vocab_act")
    if split is not None and t.shape[0] != cfg.vocab_size:
        off, _, rows = _vocab_rows(cfg, split.size, split.rank)
        w = cast(work(p, cfg, "embed.tokens", split))
        local = tokens - off
        inside = (local >= 0) & (local < rows)
        y = w[local.clamp(0, rows - 1)]
        y = torch.where(inside[..., None], y, torch.zeros((), dtype=y.dtype,
                                                           device=y.device))
        return model_axis.leave(y, split, seq)
    w = cast(t)
    if split is not None and cfg.tie_embeddings:
        off, _, rows = _vocab_rows(cfg, split.size, split.rank)
        w = model_axis.own_rows_grad(w, off, off + rows)
    return model_axis.leave(w[tokens], None, seq)


def unembed(p, cfg: ModelConfig, x):
    """Logits in the compute dtype.  Under a model split of the vocabulary
    each rank computes its rows' and they are all-gathered (the padded
    rows cut)."""
    split = model_axis.split_for("vocab_act")
    if split is not None:
        _, Vloc, rows = _vocab_rows(cfg, split.size, split.rank)
        logits = cast(model_axis.to_model(x, split)) \
            @ _vocab_weight(p, cfg, split)
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        logits = F.pad(logits, (0, Vloc - rows))
        return model_axis.gather_from_model(
            logits, split)[..., :cfg.vocab_size]
    w = cast(whole(p, cfg, "embed.tokens")).t() if cfg.tie_embeddings \
        else cast(whole(p, cfg, "embed.unembed"))
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


def _xent_split(p, cfg: ModelConfig, x, targets, mask, split, seq=None):
    """``repro``'s vocab-sharded cross-entropy: each rank's fp32 logits
    for its Vloc rows of the padded table (softcapped if set, the padded
    rows at -1e30), then three (B, S) reductions over the ranks: the max
    (no gradient), the sum of exponentials and the gold logit, gathered
    on the rank whose rows hold the target."""
    off, Vloc, rows = _vocab_rows(cfg, split.size, split.rank)
    if rows < Vloc and targets.device.type != "meta" \
            and bool((targets >= cfg.vocab_size).any()):
        # repro's error where the targets hold values; a meta trace has
        # none to read
        raise ValueError(f"a target past the vocabulary of "
                         f"{cfg.vocab_size}")
    logits = (cast(model_axis.enter(x, split, seq))
              @ _vocab_weight(p, cfg, split)).float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if rows < Vloc:
        logits = F.pad(logits, (0, Vloc - rows), value=-1e30)
    m = model_axis.pmax(logits.detach().amax(-1), split)
    se = model_axis.psum(torch.exp(logits - m[..., None]).sum(-1), split)
    lse = m + torch.log(se)
    t_loc = (targets - off).clamp(0, Vloc - 1).long()
    in_range = (targets >= off) & (targets < off + Vloc)
    gold_loc = torch.gather(logits, -1, t_loc[..., None])[..., 0]
    gold = model_axis.psum(torch.where(in_range, gold_loc, 0.0), split)
    return ((lse - gold) * mask).sum(), torch.clamp(mask.sum(), min=1.0)


def unembed_xent(p, cfg: ModelConfig, x, targets, mask, *, seq=None):
    """Unembed and cross-entropy: fp32 logsumexp over the compute-dtype
    logits, or under a model split of the vocabulary ``repro``'s
    vocab-sharded form (``_xent_split``).  With ``seq`` x is this rank's
    block of the tokens, gathered whole first; ``targets`` and ``mask``
    are whole.  Returns (ce_sum, denom)."""
    split = model_axis.split_for("vocab_act")
    if split is not None:
        return _xent_split(p, cfg, x, targets, mask, split, seq)
    return xent_sum(unembed(p, cfg, model_axis.enter(x, None, seq)),
                    targets, mask)


def _on_residual(specs, name: str) -> bool:
    """Is parameter ``name`` (a port name) applied along the residual
    stream token by token: a vector over d_model alone (logical axes
    ``("embed",)``: a norm's scale, a bias added to the stream), where
    ``specs`` is the model's spec tree in ``repro``'s layout
    (``lm.param_specs``)?"""
    parts = name.split(".")
    node = specs
    for i, k in enumerate(parts):
        if i == 1 and parts[0] in ("layers", "encoder"):
            continue                                  # the layer index
        node = node[k]
    return tuple(node.axes[1:] if parts[0] in ("layers", "encoder")
                 else node.axes) == ("embed",)


def model_partial_leaves(cfg: ModelConfig, specs, names, seq=None,
                         enc_seq=None):
    """The parameters among ``names`` (port names, ``layers.3.attn.wq``)
    stored whole whose gradient a model rank holds only in part under the
    current splits: what the data-parallel step sums over the model ranks
    once a step (qk-norm's scales on a rank's heads; a leaf whose model
    dim the guard dropped).  A leaf stored split holds its shard's whole
    gradient (``model_storage``); the norm scales, the router and a table
    used only by the lookup are used whole on replicated inputs.
    ``specs`` is the model's spec tree (``lm.param_specs``).  An encdec
    decoder layer's cross-attention (``cross``) splits by heads as
    self-attention does.  Under a split of the SSD heads
    (``ssm_inner_act``) every SSM leaf feeds only the rank's heads:
    ``in_B``, ``in_C`` and the B / C channels of the conv, which every
    rank uses whole, and whichever of the others the guard left whole.

    Under sequence parallelism (``seq``, ``stack.sp_split``) a rank
    applies every leaf that acts on the residual stream token by token
    (``_on_residual``, read from ``specs``: the norms' scales and
    biases, the final norm's included) to its block of the tokens only:
    those are used in part too; the encoder's stack and ``enc_norm`` go
    by the encoder's own split (``enc_seq``).  So is the expert-parallel
    MoE's router, which its spec cannot tell: it is applied to the whole
    gathered sequence, but under ``seq`` its gates enter the expert split
    without ``to_model`` (``_moe_ep``), so each rank's gradient of them
    holds only its own experts' share."""
    attn = model_axis.split_for("heads_act") is not None
    mlp_ = _mlp_split(cfg) is not None
    ep = _ep_split() is not None
    vocab = model_axis.split_for("vocab_act") is not None
    ssm_ = model_axis.split_for("ssm_inner_act") is not None
    ctx = current_ctx()
    out = []
    for name in names:
        group, leaf = ([""] + name.split("."))[-2:]      # meta_tokens: ""
        if group == "cross":
            group = "attn"
        res_seq = enc_seq if name.startswith(("encoder.", "enc_norm.")) \
            else seq
        if (group == "attn" and attn or group == "ssm" and ssm_
                or group == "mlp" and mlp_ and leaf != "bo"
                or group == "moe" and ep and (leaf != "router"
                                              or seq is not None)
                or group == "embed" and vocab and (
                    leaf == "unembed" or cfg.tie_embeddings)
                or res_seq is not None and _on_residual(specs, name)) \
                and not _stored_split(ctx, cfg, f"{group}.{leaf}"):
            out.append(name)
    return out
