"""Kernel entry points the models call, routed by the tensor's device.

* A CUDA tensor goes to the hand-written kernel (``flash_attention``,
  ``rmsnorm``, ``rmsnorm_residual``, ``ssd_scan``, and for prefill
  ``ssd_scan_state``, the same kernel writing its final state too), which
  launches or raises; nothing falls back.  Attention has a gradient on the
  card: under autograd ``flash_attention`` runs ``_FlashAttention``, whose
  backward is the flash backward kernels (bf16; fp32 or unaligned inputs
  that need a gradient raise).
* A CPU tensor goes to the plain PyTorch version (``ref.py``), with the
  chunked attention for sequences of 1024 or more, so peak memory stays
  O(block * T).
* Ragged attention (explicit positions, a valid-length bound, a softcap or
  sinks) has no kernel on either backend and goes to ``ref.mha`` on every
  device, as in the JAX package.  That covers all of decode.
* The one-token SSD recurrence of decode (``ssd_step``) is plain PyTorch
  on every device, as the JAX package computes it outside any Pallas
  kernel: a few elementwise ops and two small contractions per layer,
  bound by reading and writing the (b, h, p, n) fp32 state.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_pos=None, kv_pos=None, kv_valid=None, softcap: float = 0.0,
              q_offset: int = 0, scale: Optional[float] = None,
              num_sink: int = 0):
    """Multi-head (GQA) attention.  q: (B,S,H,D); k, v: (B,T,K,D)."""
    ragged = q_pos is not None or kv_pos is not None or kv_valid is not None \
        or softcap > 0.0 or num_sink > 0
    if not ragged and q.device.type != "cpu":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if q_offset and q_pos is None:
        B, S = q.shape[:2]
        q_pos = (q_offset + torch.arange(S, device=q.device))[None].expand(B, S)
    simple = (q_pos is None and kv_pos is None and kv_valid is None
              and softcap == 0.0)
    if simple and q.shape[1] >= 1024:
        return _ref.mha_chunked(q, k, v, causal=causal, window=window,
                                num_sink=num_sink, scale=scale)
    return _ref.mha(q, k, v, causal=causal, window=window, q_pos=q_pos,
                    kv_pos=kv_pos, kv_valid=kv_valid, softcap=softcap,
                    scale=scale, num_sink=num_sink)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    return _rn.rmsnorm(x, scale, eps=eps)


def rmsnorm_residual(x, residual, scale, *, eps: float = 1e-6):
    """Returns (normed, new_residual) for a fused residual add + norm."""
    return _rn.rmsnorm_residual(x, residual, scale, eps=eps)


def _pad_to_chunk(x, dt, B, C, chunk: int):
    """Zero-pad the sequence to a multiple of the chunk (at most the
    sequence).  dt = 0 on the padding gives exp(0 * A) = 1, no decay, and
    adds nothing to the state, so the padding neither changes y on the
    real steps nor the state after them.  Returns (x, dt, B, C, chunk)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    return x, dt, B, C, chunk


def ssd(x, dt, A, B, C, *, chunk: int = 256):
    """Chunked SSD scan (training / prefill); shapes as ``ssd_scan``.  A
    sequence that is not a multiple of the chunk is padded
    (``_pad_to_chunk``) and the output cut back."""
    s = x.shape[1]
    x, dt, B, C, chunk = _pad_to_chunk(x, dt, B, C, chunk)
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)[:, :s]


def ssd_prefill(x, dt, A, B, C, *, chunk: int = 256):
    """The SSD scan of a prompt with its final state, for prefill -> decode:
    (y (b,s,h,p), state (b,h,p,n) fp32), padded as ``ssd`` pads.  A CUDA
    tensor runs the kernel, which writes the state itself."""
    s = x.shape[1]
    x, dt, B, C, chunk = _pad_to_chunk(x, dt, B, C, chunk)
    y, state = _ssd.ssd_scan_state(x, dt, A, B, C, chunk=chunk)
    return y[:, :s], state


def ssd_step(state, x, dt, A, B, C):
    """One decode token of the SSD recurrence: (y (b,h,p), new state).
    Plain PyTorch on every device (see the module docstring)."""
    return _ref.ssd_step(state, x, dt, A, B, C)
