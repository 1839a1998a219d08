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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
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


def ssm_cache_shapes(cfg: ModelConfig, batch: int):
    """Per-layer decode state shapes and dtypes (the stack adds the layer
    dim): the conv tail in bf16 and the SSD state in fp32."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_num_groups * cfg.ssm_state_dim
    return {
        "conv": ((batch, cfg.ssm_conv_width - 1, conv_dim), torch.bfloat16),
        "state": ((batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                   cfg.ssm_state_dim), torch.float32),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv1d.  u: (B,S,C); w: (W,C); b: (C,)."""
    W, S = w.shape[0], u.shape[1]
    out = u * cast(w[-1])
    for i in range(1, W):
        shifted = F.pad(u, (0, 0, i, 0))[:, :S]
        out = out + shifted * cast(w[-1 - i])
    return out + cast(b)


def _project(p, cfg: ModelConfig, x):
    x = cast(x)
    xs = x @ cast(p["in_x"])
    z = x @ cast(p["in_z"])
    Bm = x @ cast(p["in_B"])
    Cm = x @ cast(p["in_C"])
    dt = x @ cast(p["in_dt"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    return xs, z, Bm, Cm, dt


def ssm(p, cfg: ModelConfig, x, *, return_state: bool = False):
    """Full-sequence SSD.  x: (B,S,D) -> (B,S,D); with ``return_state``
    also this layer's decode cache {"conv": the last W-1 pre-conv inputs
    in bf16, "state": the SSD state after the last token, fp32}."""
    B, S, _ = x.shape
    g, n, nh, hd = (cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads,
                    cfg.ssm_head_dim)
    xs, z, Bm, Cm, dt = _project(p, cfg, x)
    u_raw = torch.cat([xs, Bm, Cm], dim=-1)
    u = F.silu(_causal_conv(u_raw, p["conv_w"], p["conv_b"]))
    # views of u: the scan reads x, B and C through their strides
    xs, Bm, Cm = torch.split(u, [cfg.d_inner, g * n, g * n], dim=-1)

    xh = xs.reshape(B, S, nh, hd)
    Bh = Bm.reshape(B, S, g, n)
    Ch = Cm.reshape(B, S, g, n)
    A = -torch.exp(p["A_log"].float())

    if return_state:
        y, state = ops.ssd_prefill(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk)
    else:
        y = ops.ssd(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk)
    y = y + xh * cast(p["D"])[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = y * F.silu(z)
    y = ops.rmsnorm(y, p["gate_norm"], eps=cfg.norm_eps)
    out = cast(y) @ cast(p["out"])
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
    {"conv", "state"} (``ssm_cache_shapes``).  Returns (out (B,1,D), the
    new {"conv", "state"})."""
    B = x.shape[0]
    g, n, nh, hd = (cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads,
                    cfg.ssm_head_dim)
    xs, z, Bm, Cm, dt = _project(p, cfg, x)
    u_new = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]              # (B, conv_dim)
    conv_hist = cache["conv"]                                   # (B, W-1, C)
    u_win = torch.cat([conv_hist.to(u_new.dtype), u_new[:, None]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", u_win, cast(p["conv_w"])) \
        + cast(p["conv_b"])
    u = F.silu(conv_out)
    new_conv = u_win[:, 1:].to(conv_hist.dtype)

    xs1, Bm1, Cm1 = torch.split(u, [cfg.d_inner, g * n, g * n], dim=-1)
    xh = xs1.reshape(B, nh, hd)
    A = -torch.exp(p["A_log"].float())
    y, new_state = ops.ssd_step(cache["state"], xh, dt[:, 0], A,
                                Bm1.reshape(B, g, n), Cm1.reshape(B, g, n))
    y = y + xh * cast(p["D"])[None, :, None]
    y = y.reshape(B, 1, cfg.d_inner)
    y = y * F.silu(z)
    y = ops.rmsnorm(y, p["gate_norm"], eps=cfg.norm_eps)
    return cast(y) @ cast(p["out"]), {"conv": new_conv, "state": new_state}
