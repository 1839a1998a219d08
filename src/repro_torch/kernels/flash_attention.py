"""Flash attention: a hand-written CUDA C++ kernel for Hopper and its plain
PyTorch twin.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py`` · ``flash_attention``; its header says
what bounds it on an H100 and how the design answers that.  It is compiled
by nvcc for ``sm_90a`` at first use (``_build.py``) and called through
ctypes on PyTorch's current stream.

``flash_attention`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it uses the plain twin only for tensors
on the CPU.  ``flash_attention.launches`` counts kernel launches.
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [ptr] * 4 + [i32] * 7 + [i64] * 12
        + [ctypes.c_float, i32, i32, i32, ptr])
    lib.flash_attention_fwd.restype = ctypes.c_int
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """q: (B,S,H,D); k, v: (B,T,K,D), H % K == 0.  Returns (B,S,H,D) in
    q's type.  Query i sits at absolute position ``q_offset + i``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention has no backward yet")
    _check(q, k, v)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    scale = float(scale if scale is not None else D ** -0.5)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, T, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], scale, int(causal), int(window),
            int(q_offset), stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    with _count_lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
