"""Plain PyTorch versions of the attention and norm kernels.

Each function computes what the JAX package's ``repro.kernels.ref`` computes
(same masks, fp32 softmax and reductions, output in the input's type).  They
are the CPU path of ``ops.py`` and the twins the hand-written kernels are
held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(q_pos, kv_pos, *, causal: bool, window: int,
                   kv_valid: Optional[torch.Tensor] = None,
                   num_sink: int = 0):
    """Boolean mask (B, S, T): True = attend.

    q_pos: (B,S) absolute query positions; kv_pos: (B,T) key positions
    (negative = slot not written yet); kv_valid: (B,) number of valid cache
    slots (decode), or None.  Positions < num_sink stay visible through a
    sliding window (attention sinks)."""
    m = kv_pos[:, None, :] >= 0
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        in_window = q_pos[:, :, None] - kv_pos[:, None, :] < window
        if num_sink > 0:
            in_window = in_window | (kv_pos[:, None, :] < num_sink)
        m = m & in_window
    if kv_valid is not None:
        m = m & (kv_pos[:, None, :] < kv_valid[:, None, None])
    return m


def mha(q, k, v, *, causal: bool = True, window: int = 0,
        q_pos=None, kv_pos=None, kv_valid=None, softcap: float = 0.0,
        scale: Optional[float] = None, num_sink: int = 0):
    """GQA attention.  q: (B,S,H,D); k, v: (B,T,K,D) with H % K == 0."""
    B, S, H, D = q.shape
    _, T, K, _ = k.shape
    if H % K:
        raise ValueError(f"num heads {H} not a multiple of kv heads {K}")
    G = H // K
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(S, device=dev)[None, :].expand(B, S)
    if kv_pos is None:
        kv_pos = torch.arange(T, device=dev)[None, :].expand(B, T)
    scale = scale if scale is not None else D ** -0.5

    qg = q.reshape(B, S, K, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window,
                          kv_valid=kv_valid, num_sink=num_sink)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # fully masked rows (padding) give zeros, not a uniform average
    any_valid = mask.any(-1)[:, None, None, :, None]
    probs = probs.masked_fill(~any_valid, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def mha_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                num_sink: int = 0, scale: Optional[float] = None,
                block_q: int = 512):
    """Exact attention over query blocks: peak memory O(block_q * T)
    instead of O(S * T).  Same math and masks as ``mha``."""
    B, S, H, D = q.shape
    _, T, K, _ = k.shape
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(T, device=dev)
    outs = []
    for start in range(0, S, block_q):
        qblk = q[:, start:start + block_q]
        bq = qblk.shape[1]
        qf = qblk.reshape(B, bq, K, G, D).float()
        logits = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
        q_pos = start + torch.arange(bq, device=dev)
        m = torch.ones((bq, T), dtype=torch.bool, device=dev)
        if causal:
            m = m & (kv_pos[None, :] <= q_pos[:, None])
        if window > 0:
            in_w = q_pos[:, None] - kv_pos[None, :] < window
            if num_sink > 0:
                in_w = in_w | (kv_pos[None, :] < num_sink)
            m = m & in_w
        logits = logits.masked_fill(~m, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        probs = probs.masked_fill(~m.any(-1)[:, None], 0.0)
        ob = torch.einsum("bkgst,btkd->bskgd", probs, vf)
        outs.append(ob.reshape(B, bq, H, D).to(q.dtype))
    return torch.cat(outs, dim=1)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x * rsqrt(mean(x²) + eps) * scale per row, in fp32, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
