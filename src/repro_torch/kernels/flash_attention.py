"""Flash attention: hand-written CUDA C++ kernels for Hopper, forward and
backward, and their plain PyTorch twins.

The forward kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/flash_attention.py`` · ``flash_attention``; the
backward kernels replace nothing on the TPU (``repro`` differentiates its
plain reference, ``ref.mha``).  The source's header says what bounds each
on an H100 and how the design answers that.  They are compiled by nvcc for
``sm_90a`` at first use (``_build.py``) and called through ctypes on
PyTorch's current stream.

``flash_attention`` launches the forward kernel for CUDA tensors and raises
on anything the kernel does not take; it uses the plain twin only for
tensors on the CPU.  When q, k or v needs a gradient it goes through
``_FlashAttention``, an ``autograd.Function``:

* on CUDA tensors its forward launches the kernel with the per-row
  logsumexp (``lse``, fp32 (B, H, S)) and saves q, k, v, o and lse; its
  backward launches the three backward kernels.  bf16 with a head dim
  that is a multiple of 16 and 16-byte-aligned rows only: anything else
  (fp32, head dim 24, unaligned views) raises ``NotImplementedError``;
* on CPU tensors the same Function runs the plain twins
  ``flash_attention_plain_lse`` and ``flash_attention_backward_plain``
  (FlashAttention-2's equations from the saved lse, not autograd).

Without a gradient the forward writes no lse.  ``flash_attention.launches``
counts forward kernel launches, ``flash_attention.backward_launches``
backward calls on the card (one a call, for its three launches).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 24, 32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, scale: Optional[float] = None):
    """The plain twin: the same function through ``ref.mha``."""
    B, S = q.shape[:2]
    q_pos = None
    if q_offset:
        q_pos = (q_offset + torch.arange(S, device=q.device))[None].expand(B, S)
    return ref.mha(q, k, v, causal=causal, window=window, q_pos=q_pos,
                   scale=scale)


def _plain_scores(q, k, causal, window, q_offset, scale):
    """Masked scaled scores (B, K, G, S, T) in fp32 (fp64 for fp64
    inputs), -inf where masked, and the mask (B, 1, 1, S, T)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, S, K, H // K, D).to(ct)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(ct)) * scale
    q_pos = (q_offset + torch.arange(S, device=q.device))[None].expand(B, S)
    kv_pos = torch.arange(T, device=q.device)[None].expand(B, T)
    mask = ref.attention_mask(q_pos, kv_pos, causal=causal,
                              window=window)[:, None, None]
    return logits.masked_fill(~mask, float("-inf")), mask


def flash_attention_plain_lse(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              scale: Optional[float] = None):
    """The plain twin of the forward under a gradient: (o, lse), o as
    ``ref.mha`` computes it (fp32 softmax, rows that see no key give 0) in
    q's type, lse (B, H, S) the logsumexp of each row's scaled visible
    scores, -inf for a row that sees none (fp32; fp64 for fp64 inputs)."""
    B, S, H, D = q.shape
    logits, _ = _plain_scores(q, k, causal, window, q_offset, scale)
    lse = torch.logsumexp(logits, dim=-1)                 # (B,K,G,S)
    seen = torch.isfinite(lse)
    probs = torch.exp(logits - torch.where(seen, lse, 0.0)[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(probs.dtype))
    return (out.reshape(B, S, H, D).to(q.dtype),
            lse.reshape(B, H, S))


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = True, window: int = 0,
                                   q_offset: int = 0,
                                   scale: Optional[float] = None):
    """The plain twin of the backward kernels: (dq, dk, dv) in the inputs'
    types from the saved o and lse, by FlashAttention-2's equations in
    fp32 (fp64 for fp64 inputs), not by autograd:
    P = exp(S scale - lse), dV = P^T dO, dP = dO V^T, Di = rowsum(dO o O),
    dS = P o (dP - Di), dQ = scale dS K, dK = scale dS^T Q."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    logits, mask = _plain_scores(q, k, causal, window, q_offset, scale)
    ct = logits.dtype
    lse = lse.reshape(B, K, G, S).to(ct)
    seen = torch.isfinite(lse)[..., None]
    p = torch.exp(logits - torch.where(seen, lse[..., None], 0.0))
    p = p.masked_fill(~(mask & seen), 0.0)
    dog = do.reshape(B, S, K, G, D).to(ct)
    delta = (dog * o.reshape(B, S, K, G, D).to(ct)).sum(-1)   # (B,S,K,G)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(ct))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(ct)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.reshape(B, S, K, G, D).to(ct)) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [ptr] * 4 + [i32] * 7 + [i64] * 12
        + [ctypes.c_float, i32, i32, i32, ptr, ptr])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_bwd.argtypes = (
        [ptr] * 10 + [i32] * 6 + [i64] * 24
        + [ctypes.c_float, i32, i32, i32, i32, ptr])
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B,S,H,D) / "
                         "(B,T,K,D)")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    K = k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention: H={H} not a multiple of K={K}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; need one of float32 / bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: head dim must have unit stride")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H={B * H} exceeds the grid")


def _aligned16(t) -> bool:
    """Every (.., D) row of t starts on a 16-byte boundary (bf16)."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in t.stride()[:3])


def _check_backward(q, k, v):
    """What the backward kernels take: bf16, a head dim that is a
    multiple of 16, rows 16-byte aligned.  Raises NotImplementedError
    naming the case otherwise (nothing falls back to the plain twin)."""
    D = q.shape[3]
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"flash_attention backward: {q.dtype} on the card has no "
            f"kernel (bf16 only)")
    if D % 16:
        raise NotImplementedError(
            f"flash_attention backward: head dim {D} is not a multiple of "
            f"16 (no tensor-core tiles)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned16(t):
            raise NotImplementedError(
                f"flash_attention backward: {name}'s rows are not 16-byte "
                f"aligned (a strided view)")


def _forward_kernel(q, k, v, causal, window, q_offset, scale, lse=None):
    """Launch the forward kernel; ``lse`` (fp32 (B,H,S)) receives each
    row's logsumexp when given.  Returns o (contiguous, q's type)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, T, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], scale, int(causal), int(window),
            int(q_offset), None if lse is None else lse.data_ptr(), stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    with _count_lock:
        flash_attention.launches += 1
    return out


def backward_kernel(q, k, v, o, lse, do, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None, which: int = 7,
                    delta=None, grads=None):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv), new
    contiguous bf16 tensors.  ``which`` (7: all three) and the optional
    ``delta`` scratch and ``grads`` outputs let a timing harness run one
    pass alone on buffers made once; the Function uses the defaults.
    Counts no launch."""
    _check(q, k, v)
    _check_backward(q, k, v)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else D ** -0.5)
    if do.dtype != q.dtype:
        do = do.to(q.dtype)
    if not _aligned16(do) or do.stride(3) != 1:
        do = do.contiguous()
    if not _aligned16(o) or o.stride(3) != 1:
        raise NotImplementedError("flash_attention backward: o's rows are "
                                  "not 16-byte aligned")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention backward: lse must be a "
                         "contiguous float32 (B, H, S)")
    if grads is None:
        grads = (torch.empty_like(q, memory_format=torch.contiguous_format),
                 torch.empty_like(k, memory_format=torch.contiguous_format),
                 torch.empty_like(v, memory_format=torch.contiguous_format))
    dq, dk, dv = grads
    if delta is None:
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, T, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], scale, int(causal),
            int(window), int(q_offset), int(which), stream)
    if err:
        raise RuntimeError(f"flash_attention backward: kernel launch "
                           f"failed with CUDA error {err}")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the kernels on CUDA tensors, the
    plain twins on CPU tensors (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  scale=scale)
        if q.device.type == "cpu":
            out, lse = flash_attention_plain_lse(q, k, v, **kw)
        else:
            _check(q, k, v)
            _check_backward(q, k, v)
            B, S, H, _ = q.shape
            lse = torch.empty((B, H, S), dtype=torch.float32,
                              device=q.device)
            out = _forward_kernel(q, k, v, causal, window, q_offset, scale,
                                  lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_backward_plain(q, k, v, out, lse, do,
                                                   **ctx.kw)
        else:
            grads = backward_kernel(q, k, v, out, lse, do, **ctx.kw)
            with _count_lock:
                flash_attention.backward_launches += 1
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """q: (B,S,H,D); k, v: (B,T,K,D), H % K == 0.  Returns (B,S,H,D) in
    q's type.  Query i sits at absolute position ``q_offset + i``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                     scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    _check(q, k, v)
    return _forward_kernel(q, k, v, causal, window, q_offset, scale)


flash_attention.launches = 0
flash_attention.backward_launches = 0
