"""Mamba2 (SSD) mixer for the full sequence: projections, causal depthwise
conv and the chunked SSD scan.  The counterpart of the full-sequence path
of ``repro/models/ssm.py`` (``ssm_specs``, ``_causal_conv``, ``_project``,
``ssm`` with ``return_state=False``); the decode recurrence and its cache
wait for the SSM serving slice.

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


def ssm(p, cfg: ModelConfig, x):
    """Full-sequence SSD.  x: (B,S,D) -> (B,S,D)."""
    B, S, _ = x.shape
    g, n, nh, hd = (cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads,
                    cfg.ssm_head_dim)
    xs, z, Bm, Cm, dt = _project(p, cfg, x)
    u = torch.cat([xs, Bm, Cm], dim=-1)
    u = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    # views of u: the scan reads x, B and C through their strides
    xs, Bm, Cm = torch.split(u, [cfg.d_inner, g * n, g * n], dim=-1)

    xh = xs.reshape(B, S, nh, hd)
    Bh = Bm.reshape(B, S, g, n)
    Ch = Cm.reshape(B, S, g, n)
    A = -torch.exp(p["A_log"].float())

    y = ops.ssd(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk)
    y = y + xh * cast(p["D"])[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = y * F.silu(z)
    y = ops.rmsnorm(y, p["gate_norm"], eps=cfg.norm_eps)
    return cast(y) @ cast(p["out"])
