"""Mamba2 (SSD) mixer: projections, causal depthwise conv and the chunked
SSD scan over the full sequence, with a single-token recurrent path for
decode.  The counterpart of ``repro/models/ssm.py`` (``ssm_specs``,
``ssm_cache_shapes``, ``_causal_conv``, ``_project``, ``ssm``,
``ssm_decode``).  Prefill (``ssm(..., return_state=True)``) runs the SSD
scan kernel, which also returns the final state; decode carries a cache of
the conv's last W-1 inputs (bf16 whatever the compute dtype, as in JAX)
and the fp32 SSD state.

Shapes follow the Mamba2 paper: inner width din = expand * d_model, nh =
din / head_dim SSD heads, state (nh, head_dim, N) per sequence.  Casts are
JAX's, leaf by leaf: the projections, ``conv_w``, ``conv_b`` and ``D`` are
cast to the compute dtype; ``dt_bias``, ``A_log`` and ``gate_norm`` are
used in fp32.

Under a model axis (``model_axis.split_for("ssm_inner_act")``, ``repro``'s
rule for the mixer's activations) each rank computes whole SSD heads
[h0, h1) (``layers.ssm_heads``, uneven where they do not divide): its
heads' columns of ``in_x`` and ``in_z``, its heads' ``in_dt``,
``dt_bias``, ``A_log`` and ``D``, B and C whole (the groups are 1), the
conv over its ``x`` channels and every B / C channel, the scan over its
heads, the gate norm over its part of each row with the row's sum of
squares summed over the ranks (``ops.rmsnorm_split``), its rows of
``out``; the ranks' outputs are summed (``model_axis.enter`` /
``leave``).  Each leaf is the rank's part (``layers.work``: an aligned
shard as it is, any other gathered or narrowed).  Decode carries the
rank's conv channels and the state of its heads (``ssm_cache_shapes``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import model_axis
from repro_torch.kernels import ops
from repro_torch.models import layers as ll
from repro_torch.models.layers import cast
from repro_torch.models.module import spec

# leaves JAX uses in fp32, uncast
FP32_LEAVES = frozenset({"dt_bias", "A_log", "gate_norm"})


def ssm_specs(cfg: ModelConfig):
    d, din = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads
    w = cfg.ssm_conv_width
    conv_dim = din + 2 * g * n
    return {
        "in_x": spec((d, din), ("embed", "ssm_inner")),
        "in_z": spec((d, din), ("embed", "ssm_inner")),
        "in_B": spec((d, g * n), ("embed", "ssm_state")),
        "in_C": spec((d, g * n), ("embed", "ssm_state")),
        "in_dt": spec((d, nh), ("embed", "ssm_heads")),
        "dt_bias": spec((nh,), ("ssm_heads",), init="zeros"),
        "A_log": spec((nh,), ("ssm_heads",), init="zeros"),
        "D": spec((nh,), ("ssm_heads",), init="ones"),
        "conv_w": spec((w, conv_dim), (None, "ssm_inner"), scale=0.5,
                       fan_in_dims=(0,)),
        "conv_b": spec((conv_dim,), ("ssm_inner",), init="zeros"),
        "gate_norm": spec((din,), ("ssm_inner",), init="ones"),
        "out": spec((din, d), ("ssm_inner", "embed")),
    }


def ssm_cache_shapes(cfg: ModelConfig, batch: int, shards: int = 1,
                     rank: int = 0):
    """Per-layer decode state shapes and dtypes (the stack adds the layer
    dim): the conv tail in bf16 and the SSD state in fp32; under a split
    of the heads over ``shards`` model ranks, rank ``rank``'s: the conv
    channels and the state of its ``layers.ssm_heads``."""
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    bc = 2 * cfg.ssm_num_groups * cfg.ssm_state_dim
    h0, h1 = ll.ssm_heads(cfg, shards, rank) if shards > 1 else (0, nh)
    return {
        "conv": ((batch, cfg.ssm_conv_width - 1, (h1 - h0) * hd + bc),
                 torch.bfloat16),
        "state": ((batch, h1 - h0, hd, cfg.ssm_state_dim), torch.float32),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv1d.  u: (B,S,C); w: (W,C); b: (C,)."""
    W, S = w.shape[0], u.shape[1]
    out = u * cast(w[-1])
    for i in range(1, W):
        shifted = F.pad(u, (0, 0, i, 0))[:, :S]
        out = out + shifted * cast(w[-1 - i])
    return out + cast(b)


def _leaves(p, cfg: ModelConfig, split):
    """{leaf: this rank's part} of the mixer's leaves: under ``split`` its
    heads' (``layers.work``; ``in_B`` / ``in_C`` whole), else every leaf
    whole (``layers.whole``)."""
    out = {}
    for leaf in p:
        kind = "ssm." + leaf
        if kind not in ll._MODEL_LEAVES:
            out[leaf] = p[leaf]
        elif split is None:
            out[leaf] = ll.whole(p, cfg, kind)
        else:
            out[leaf] = ll.work(p, cfg, kind, split)
    return out


def _project(p, cfg: ModelConfig, x):
    x = cast(x)
    xs = x @ cast(p["in_x"])
    z = x @ cast(p["in_z"])
    Bm = x @ cast(p["in_B"])
    Cm = x @ cast(p["in_C"])
    dt = x @ cast(p["in_dt"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    return xs, z, Bm, Cm, dt


def _gate_norm(p, cfg: ModelConfig, y, split):
    """The gate norm over d_inner: whole, or under ``split`` over this
    rank's part of each row, the row's sum of squares summed over the
    model ranks."""
    if split is None:
        return ops.rmsnorm(y, p["gate_norm"], eps=cfg.norm_eps)
    return ops.rmsnorm_split(
        y, p["gate_norm"], d_full=cfg.d_inner, eps=cfg.norm_eps,
        reduce=lambda t: model_axis.sum_ranks(t, split))


def ssm(p, cfg: ModelConfig, x, *, return_state: bool = False):
    """Full-sequence SSD.  x: (B,S,D) -> (B,S,D); with ``return_state``
    also this layer's decode cache {"conv": the last W-1 pre-conv inputs
    in bf16, "state": the SSD state after the last token, fp32}: under a
    split of the heads this rank's (``ssm_cache_shapes``)."""
    split = model_axis.split_for("ssm_inner_act")
    p = _leaves(p, cfg, split)
    x = model_axis.enter(x, split)
    B, S, _ = x.shape
    g, n, hd = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_head_dim
    xs, z, Bm, Cm, dt = _project(p, cfg, x)
    din = xs.shape[-1]                            # this rank's inner width
    u_raw = torch.cat([xs, Bm, Cm], dim=-1)
    u = F.silu(_causal_conv(u_raw, p["conv_w"], p["conv_b"]))
    # views of u: the scan reads x, B and C through their strides
    xs, Bm, Cm = torch.split(u, [din, g * n, g * n], dim=-1)

    xh = xs.reshape(B, S, din // hd, hd)
    Bh = Bm.reshape(B, S, g, n)
    Ch = Cm.reshape(B, S, g, n)
    A = -torch.exp(p["A_log"].float())

    if return_state:
        y, state = ops.ssd_prefill(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk)
    else:
        y = ops.ssd(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk)
    y = y + xh * cast(p["D"])[None, None, :, None]
    y = y.reshape(B, S, din)
    y = y * F.silu(z)
    y = _gate_norm(p, cfg, y, split)
    out = model_axis.leave(cast(y) @ cast(p["out"]), split)
    if not return_state:
        return out
    # the pre-conv inputs (not the conv output the scan read), rounded to
    # the cache's bf16 as JAX rounds them; a prompt shorter than the tail
    # leaves zeros before it, as the conv's own left padding does
    w = cfg.ssm_conv_width
    tail = F.pad(u_raw, (0, 0, max(0, w - 1 - S), 0))[:, -(w - 1):]
    return out, {"conv": tail.to(torch.bfloat16), "state": state}


def ssm_decode(p, cfg: ModelConfig, x, cache):
    """Single-token recurrence.  x: (B,1,D); cache: this layer's
    {"conv", "state"} (``ssm_cache_shapes``: under a split of the heads
    this rank's channels and heads).  Returns (out (B,1,D), the new
    {"conv", "state"})."""
    split = model_axis.split_for("ssm_inner_act")
    p = _leaves(p, cfg, split)
    x = model_axis.enter(x, split)
    B = x.shape[0]
    g, n, hd = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_head_dim
    xs, z, Bm, Cm, dt = _project(p, cfg, x)
    din = xs.shape[-1]
    u_new = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]              # (B, conv_dim)
    conv_hist = cache["conv"]                                   # (B, W-1, C)
    if conv_hist.shape[-1] != u_new.shape[-1]:
        raise ValueError(f"{cfg.name}: an SSM cache of {conv_hist.shape[-1]}"
                         f" conv channels for {u_new.shape[-1]}: a cache "
                         f"made for another split of the heads")
    u_win = torch.cat([conv_hist.to(u_new.dtype), u_new[:, None]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", u_win, cast(p["conv_w"])) \
        + cast(p["conv_b"])
    u = F.silu(conv_out)
    new_conv = u_win[:, 1:].to(conv_hist.dtype)

    xs1, Bm1, Cm1 = torch.split(u, [din, g * n, g * n], dim=-1)
    xh = xs1.reshape(B, din // hd, hd)
    A = -torch.exp(p["A_log"].float())
    y, new_state = ops.ssd_step(cache["state"], xh, dt[:, 0], A,
                                Bm1.reshape(B, g, n), Cm1.reshape(B, g, n))
    y = y + xh * cast(p["D"])[None, :, None]
    y = y.reshape(B, 1, din)
    y = y * F.silu(z)
    y = _gate_norm(p, cfg, y, split)
    out = model_axis.leave(cast(y) @ cast(p["out"]), split)
    return out, {"conv": new_conv, "state": new_state}
