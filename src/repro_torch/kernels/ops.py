"""Kernel entry points the models call, routed by the tensor's device.

* A CUDA tensor goes to the hand-written kernel (``flash_attention``,
  ``rmsnorm``, ``rmsnorm_residual``, the split-row pair ``row_sumsq`` /
  ``rmsnorm_total`` of ``rmsnorm_split``, ``ssd_scan``, and for prefill
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
  device, as in the JAX package.  That covers decode over the self K/V
  cache, including its partial form over a block of a cache cut over the
  model ranks (``attention_partial``, ``ref.mha_partial``).  Decode over
  the cross K/V cache is not ragged: whole, it takes ``flash_attention``;
  cut over the ranks, ``attention_partial`` sends a CUDA tensor to
  ``flash_attention_partial`` (the forward kernel writing its lse too).
  The ranks' blocks are merged by ``combine_partial`` (plain PyTorch on
  every device: a few elementwise ops on a (ranks, B, 1, H, D) stack).
* The one-token SSD recurrence of decode (``ssd_step``) is plain PyTorch
  on every device, as the JAX package computes it outside any Pallas
  kernel: a few elementwise ops and two small contractions per layer,
  bound by reading and writing the (b, h, p, n) fp32 state.

Each entry point that reaches a kernel opens its kernel region
(``roofline.counter.region``, a no-op unless a ``Counter`` counts) with
the kernel's work formula from ``roofline/costs.py``, and keeps its
outputs as live; the split-row pair opens one per kernel in
``rmsnorm.py``.  While a counter counts, attention that is not ragged
takes ``flash_attention`` on every device, so the CPU runs the kernel's
plain twins forward and backward (``_FlashAttention``) as the card runs
the kernels; a meta tensor takes the kernels' shape functions.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ssd_scan import scratch_bytes as _ssd_scratch
from repro_torch.roofline import costs as _costs
from repro_torch.roofline import counter as _counter


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_pos=None, kv_pos=None, kv_valid=None, softcap: float = 0.0,
              q_offset: int = 0, scale: Optional[float] = None,
              num_sink: int = 0):
    """Multi-head (GQA) attention.  q: (B,S,H,D); k, v: (B,T,K,D)."""
    ragged = q_pos is not None or kv_pos is not None or kv_valid is not None \
        or softcap > 0.0 or num_sink > 0
    if not ragged and (q.device.type != "cpu" or _counter.active()):
        B, S, H, D = q.shape
        with _counter.region("flash_attention", lambda: _costs.flash_forward(
                B, S, k.shape[1], H, k.shape[2], D, causal=causal,
                window=window, q_offset=q_offset, elem=q.element_size())):
            out = _fa.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, scale=scale)
            _counter.keep(out)
        return out
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


def attention_partial(q, k, v, *, causal: bool = True, window: int = 0,
                      q_pos=None, kv_pos=None, kv_valid=None,
                      softcap: float = 0.0, scale: Optional[float] = None,
                      num_sink: int = 0):
    """``attention`` over one block of the keys, unfinished: (out fp32,
    lse fp32), decode only.  A block that is not ragged (the cross K/V
    cache's) on a CUDA tensor goes to the forward kernel
    (``flash_attention_partial``); a ragged one, or a CPU tensor, to
    ``ref.mha_partial``."""
    ragged = q_pos is not None or kv_pos is not None or kv_valid is not None \
        or softcap > 0.0 or num_sink > 0
    if not ragged and (q.device.type != "cpu" or _counter.active()):
        B, S, H, D = q.shape
        with _counter.region(
                "flash_attention_partial", lambda: _costs.flash_partial(
                    B, S, k.shape[1], H, k.shape[2], D, causal=causal,
                    window=window, elem=q.element_size())):
            out = _fa.flash_attention_partial(q, k, v, causal=causal,
                                              window=window, scale=scale)
            _counter.keep(*out)
        return out
    return _ref.mha_partial(q, k, v, causal=causal, window=window,
                            q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
                            softcap=softcap, scale=scale, num_sink=num_sink)


def combine_partial(out, lse, gather):
    """The blocks' ``attention_partial`` results merged
    (``ref.combine_partial``; ``gather`` stacks the ranks')."""
    return _ref.combine_partial(out, lse, gather)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    d = x.shape[-1]
    with _counter.region("rmsnorm", lambda: _costs.rmsnorm(
            x.numel() // max(d, 1), d, elem=x.element_size(),
            scale_elem=scale.element_size())):
        out = _rn.rmsnorm(x, scale, eps=eps)
        _counter.keep(out)
    return out


def rmsnorm_split(x, scale, *, d_full: int, reduce, eps: float = 1e-6):
    """rmsnorm of rows split across the model ranks: x (..., d) holds this
    rank's columns of rows of ``d_full``, ``scale`` its columns of the
    scale; ``reduce`` sums a (rows,) fp32 tensor over the ranks."""
    return _rn.rmsnorm_split(x, scale, d_full=d_full, reduce=reduce, eps=eps)


def rmsnorm_residual(x, residual, scale, *, eps: float = 1e-6):
    """Returns (normed, new_residual) for a fused residual add + norm."""
    d = x.shape[-1]
    with _counter.region("rmsnorm_residual", lambda: _costs.rmsnorm_residual(
            x.numel() // max(d, 1), d, elem=x.element_size(),
            scale_elem=scale.element_size())):
        out = _rn.rmsnorm_residual(x, residual, scale, eps=eps)
        _counter.keep(*out)
    return out


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


def _scan_input(x, dt, B, C, chunk: int):
    """(x, dt, B, C, chunk) as the scan takes them: padded to a multiple of
    the chunk (``_pad_to_chunk``), unless the kernels read the ragged end
    as zeros themselves (``ssd_scan.takes_ragged``: the wgmma kernels)."""
    c = min(chunk, x.shape[1])
    if _ssd.takes_ragged(x, B, C, c):
        return x, dt, B, C, c
    return _pad_to_chunk(x, dt, B, C, chunk)


def ssd(x, dt, A, B, C, *, chunk: int = 256):
    """Chunked SSD scan (training / prefill); shapes as ``ssd_scan``.  A
    sequence that is not a multiple of the chunk is padded
    (``_scan_input``) and the output cut back."""
    s = x.shape[1]
    with _ssd_region(x, B, chunk):
        x, dt, B, C, chunk = _scan_input(x, dt, B, C, chunk)
        y = _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)[:, :s]
        _counter.keep(y)
    return y


def _ssd_region(x, B, chunk: int, state: bool = False):
    """``ssd``'s and ``ssd_prefill``'s kernel region: the work of the
    unpadded positions, the bf16 path's scratch at the padded length."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    c = min(chunk, s)
    return _counter.region(
        "ssd_scan", lambda: _costs.ssd_scan(b, s, h, p, g, n, c,
                                            elem=x.element_size(),
                                            state=state),
        scratch=_ssd_scratch(b, s + (-s) % c, h, p, n, c, x.dtype))


def ssd_prefill(x, dt, A, B, C, *, chunk: int = 256):
    """The SSD scan of a prompt with its final state, for prefill -> decode:
    (y (b,s,h,p), state (b,h,p,n) fp32), padded as ``ssd`` pads.  A CUDA
    tensor runs the kernel, which writes the state itself."""
    s = x.shape[1]
    with _ssd_region(x, B, chunk, state=True):
        x, dt, B, C, chunk = _scan_input(x, dt, B, C, chunk)
        y, state = _ssd.ssd_scan_state(x, dt, A, B, C, chunk=chunk)
        y = y[:, :s]
        _counter.keep(y, state)
    return y, state


def ssd_step(state, x, dt, A, B, C):
    """One decode token of the SSD recurrence: (y (b,h,p), new state).
    Plain PyTorch on every device (see the module docstring)."""
    return _ref.ssd_step(state, x, dt, A, B, C)
