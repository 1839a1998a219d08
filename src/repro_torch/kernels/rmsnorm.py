"""RMSNorm: a Triton kernel for the card and its plain PyTorch twin.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` · ``rmsnorm``
(body ``_kernel``, wrapper ``rmsnorm``).

What bounds it on an H100: bytes.  Each row is read once, reduced, scaled
and written once, about 1 FLOP per byte, far below the ~295 FLOP/byte at
which bf16 tensor-core work would become the limit.  So the kernel's only
job is to touch every byte once: one program per row loads the whole row
(``BLOCK_D = next_pow2(d)``, masked, so d = 896 runs as 1024 lanes with no
padding copy), sums x² in fp32, divides by the true d and stores the scaled
row in the input's type.  The TPU kernel's 256-row blocks and 128-lane
padding exist for VMEM tiling and have no counterpart here.

Why Triton and not CUDA C++: the kernel is one row reduction and one
elementwise scale, which Triton's masked block loads and ``tl.sum`` state
directly, at the bytes/s hand-written CUDA would reach (4.6 us at
(4096, 896) bf16 against a 4.4 us bound on an H100 80GB HBM3 at 700 W,
PERF.md).

``rmsnorm`` launches the kernel for a CUDA tensor and raises on anything it
does not take; it uses the plain twin only for a tensor on the CPU.
``rmsnorm.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import ref

_SUPPORTED = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The plain twin: same arithmetic as the kernel, in PyTorch ops."""
    return ref.rmsnorm(x, scale, eps)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Define the Triton kernel on first use (``triton`` is only imported
    where a card is present)."""
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, y_ptr, x_row_stride, y_row_stride, d,
                       eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * (1.0 / tl.sqrt(var + eps)) * w
        tl.store(y_ptr + row * y_row_stride + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_kernel, triton.next_power_of_2


def _launch(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    rows, d = x2.shape
    out = torch.empty((rows, d), dtype=x2.dtype, device=x2.device)
    if rows == 0:
        return out
    kernel, next_pow2 = _kernel()
    block_d = next_pow2(d)
    num_warps = 4 if block_d <= 2048 else 8
    kernel[(rows,)](x2, scale, out, x2.stride(0), out.stride(0), d,
                    float(eps), BLOCK_D=block_d, num_warps=num_warps)
    with _count_lock:
        rmsnorm.launches += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Returns rmsnorm(x) * scale in x's type."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported")
    if scale.shape != (d,) or scale.device != x.device \
            or scale.dtype not in _SUPPORTED or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous ({d},) float "
                         f"tensor on {x.device}, got {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device}")
    if x.dim() == 2 and x.stride(1) == 1:
        x2 = x                      # rows may be strided
    elif x.is_contiguous():
        x2 = x.view(-1, d)          # (..., d) viewed as rows, no copy
    else:
        raise ValueError("rmsnorm: x must be contiguous, or 2-D with "
                         "unit stride in its last dimension")
    return _launch(x2, scale, eps).view(x.shape)


rmsnorm.launches = 0
