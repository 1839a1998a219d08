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
``rmsnorm.launches`` counts kernel launches.  When x or the scale requires
a gradient the call goes through ``_RMSNorm``: the same forward, and a
closed-form backward in fp32 whose plain twin is ``rmsnorm_backward`` (the
TPU kernel has no backward to port).  On CUDA tensors the backward is two
Triton kernels (``backward_kernel``): one pass over blocks of
``BWD_ROWS`` rows writes dx, each row from its x, dy and the scale
(r = rsqrt(mean(x²) + eps), u = dy scale, dx = r (u - x r² mean(u x)),
the twin's arithmetic op for op), and the block's fp32 partial of dscale
= sum dy x r; a second pass sums the partials, in tiles of 64 summed as a
tree and the tiles in order.  Bound by bytes like the forward (x and dy
read, dx written, the partials about 1/BWD_ROWS of a row each); no
atomics, so a second call gives the same bits.  ``rmsnorm.backward_launches``
counts the backward's calls, one per ``_RMSNorm`` backward; the CPU takes
the twin and counts none.

``rmsnorm_residual`` replaces ``repro/kernels/rmsnorm.py`` ·
``rmsnorm_residual`` (body ``_kernel_residual``): h = x + residual in fp32,
returned as (rmsnorm(h) * scale, h), both in x's type.  It is the same
Triton program with a second load and a second store, bound by bytes in
the same way; its twin is ``rmsnorm_residual_plain`` and its count
``rmsnorm_residual.launches``.  No model calls it, and it has no backward.

``rmsnorm_split`` is the gate norm of the SSM mixer under a model axis,
whose row of d_inner is split across the model ranks by whole SSD heads
(``models/ssm.py``), so the kernel above would take a mean over this
rank's columns only.  It is a Triton pair with one all-reduce between:
``row_sumsq`` writes each row's fp32 sum of squares over the rank's
columns, the caller's ``reduce`` sums those (rows,) floats over the model
ranks (``model_axis.sum_ranks``, counted and staged as every collective),
and ``rmsnorm_total`` writes x * rsqrt(total / d_full + eps) * scale.
Each is one program per row over ``BLOCK_D = next_pow2(d)`` lanes, a row
reduction or an elementwise pass bound by bytes, the same case as the
kernel above, which is why Triton serves here too.  Moving the rank's
part of y to one rank instead would stage a (B, S, d_inner / n)
activation through the host a layer, where the sum moves 4 bytes a row.
The backward (``_RMSNormSplit``) is in closed form in plain PyTorch, fp32,
with one more sum over the ranks, of each row's sum of dy * scale * x.
The plain twins are ``ref.row_sumsq`` / ``ref.rmsnorm_total``; the counts
``row_sumsq.launches`` and ``rmsnorm_total.launches``.

A ``meta`` tensor, while a ``roofline.counter.Counter`` counts, takes
each kernel's shape function (empty outputs of its shapes and types);
meta carries no values, so this is no fallback, and outside a count it
raises as any device without a kernel.  ``_RMSNorm``'s backward is a
kernel region (``rmsnorm_backward``), empty gradients on meta, as are
``row_sumsq`` and
``rmsnorm_total`` (``ops.rmsnorm`` opens ``rmsnorm``'s);
``_RMSNormSplit``'s backward, plain PyTorch with a sum over the ranks
between, is counted op by op on every device.
"""
from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.roofline import costs
from repro_torch.roofline import counter as _counter

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

    @triton.jit
    def rmsnorm_residual_kernel(x_ptr, r_ptr, w_ptr, y_ptr, h_ptr,
                                x_row_stride, r_row_stride, y_row_stride,
                                h_row_stride, d, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        h = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        h += tl.load(r_ptr + row * r_row_stride + cols, mask=mask,
                     other=0.0).to(tl.float32)
        tl.store(h_ptr + row * h_row_stride + cols,
                 h.to(h_ptr.dtype.element_ty), mask=mask)
        var = tl.sum(h * h, axis=0) / d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = h * (1.0 / tl.sqrt(var + eps)) * w
        tl.store(y_ptr + row * y_row_stride + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def row_sumsq_kernel(x_ptr, out_ptr, x_row_stride, d,
                         BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        x = tl.load(x_ptr + row * x_row_stride + cols, mask=cols < d,
                    other=0.0).to(tl.float32)
        tl.store(out_ptr + row, tl.sum(x * x, axis=0))

    @triton.jit
    def rmsnorm_total_kernel(x_ptr, w_ptr, t_ptr, y_ptr, x_row_stride,
                             y_row_stride, d, d_full, eps,
                             BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.load(t_ptr + row) / d_full
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * (1.0 / tl.sqrt(var + eps)) * w
        tl.store(y_ptr + row * y_row_stride + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)

    return (rmsnorm_kernel, rmsnorm_residual_kernel, triton.next_power_of_2,
            row_sumsq_kernel, rmsnorm_total_kernel)


# rows of a block of the backward's first pass: fewer blocks mean fewer
# dscale partials to write and sum; BWD_MIN_BLOCKS keeps the card full
BWD_ROWS, BWD_MIN_BLOCKS = 32, 264


@functools.lru_cache(maxsize=None)
def _backward_kernels():
    """The backward's two Triton kernels, defined on first use."""
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_bwd_kernel(x_ptr, dy_ptr, w_ptr, dx_ptr, part_ptr, rows,
                           x_row_stride, dy_row_stride, dx_row_stride, d,
                           eps, rows_per, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        dw = tl.zeros((BLOCK_D,), dtype=tl.float32)
        first = pid * rows_per
        for i in range(0, rows_per):
            row = (first + i).to(tl.int64)
            if row < rows:
                x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + row * dy_row_stride + cols, mask=mask,
                             other=0.0).to(tl.float32)
                # the twin's arithmetic, op for op: rsqrt of the mean
                r = tl.math.rsqrt(tl.sum(x * x, axis=0) / d + eps)
                u = dy * w
                mux = tl.sum(u * x, axis=0) / d
                dx = r * (u - x * (r * r) * mux)
                tl.store(dx_ptr + row * dx_row_stride + cols,
                         dx.to(dx_ptr.dtype.element_ty), mask=mask)
                dw += dy * x * r
        tl.store(part_ptr + pid.to(tl.int64) * d + cols, dw, mask=mask)

    @triton.jit
    def rmsnorm_dscale_kernel(part_ptr, dw_ptr, blocks, d,
                              BLOCK_C: tl.constexpr, BLOCK_P: tl.constexpr):
        # the partials in tiles of BLOCK_P, each summed as a tree, the
        # tiles' sums in order: fixed, and near a pairwise sum's error
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        mask = cols < d
        acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
        for i0 in range(0, blocks, BLOCK_P):
            rows = i0 + tl.arange(0, BLOCK_P)
            tile = tl.load(part_ptr + rows[:, None].to(tl.int64) * d
                           + cols[None, :],
                           mask=(rows[:, None] < blocks) & mask[None, :],
                           other=0.0)
            acc += tl.sum(tile, axis=0)
        tl.store(dw_ptr + cols, acc.to(dw_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_bwd_kernel, rmsnorm_dscale_kernel


def backward_blocks(rows: int) -> tuple:
    """(rows a block, blocks) of the backward's first pass for ``rows``:
    ``BWD_ROWS`` a block, fewer where that would leave fewer than
    ``BWD_MIN_BLOCKS`` blocks."""
    per = max(1, min(BWD_ROWS, rows // BWD_MIN_BLOCKS))
    return per, -(-rows // per)


def backward_kernel(x, scale, dy, eps: float):
    """``_RMSNorm``'s backward on CUDA tensors: (dx in x's type and shape,
    dscale in the scale's type), by the two Triton kernels."""
    _check_scale("rmsnorm", x, scale)
    x2 = _rows("rmsnorm", x)
    dy2 = _rows("rmsnorm", dy.to(x.dtype).contiguous())
    rows, d = x2.shape
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dscale = torch.empty_like(scale)
    if rows == 0:
        dscale.zero_()
        return dx.view(x.shape), dscale
    per, blocks = backward_blocks(rows)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    first, second = _backward_kernels()
    grid = _grid(d)
    first[(blocks,)](x2, dy2, scale, dx, part, rows, x2.stride(0),
                     dy2.stride(0), dx.stride(0), d, float(eps), per,
                     **grid)
    second[(-(-d // 64),)](part, dscale, blocks, d, BLOCK_C=64, BLOCK_P=64,
                           num_warps=4)
    with _count_lock:
        rmsnorm.backward_launches += 1
    return dx.view(x.shape), dscale


def backward_scratch_bytes(rows: int, d: int) -> int:
    """The fp32 dscale partials ``backward_kernel`` allocates."""
    return 4 * d * backward_blocks(rows)[1] if rows else 0


def _grid(d: int):
    """BLOCK_D and num_warps for rows of d."""
    block_d = _kernel()[2](d)
    return dict(BLOCK_D=block_d, num_warps=4 if block_d <= 2048 else 8)


def _launch(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    rows, d = x2.shape
    out = torch.empty((rows, d), dtype=x2.dtype, device=x2.device)
    if rows == 0:
        return out
    _kernel()[0][(rows,)](x2, scale, out, x2.stride(0), out.stride(0), d,
                          float(eps), **_grid(d))
    with _count_lock:
        rmsnorm.launches += 1
    return out


def _check_scale(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    d = x.shape[-1]
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    if scale.shape != (d,) or scale.device != x.device \
            or scale.dtype not in _SUPPORTED or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be a contiguous ({d},) float "
                         f"tensor on {x.device}, got {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device}")


def _rows(name: str, x: torch.Tensor) -> torch.Tensor:
    """x as (rows, d) without a copy: rows may be strided in 2-D."""
    if x.dim() == 2 and x.stride(1) == 1:
        return x
    if x.is_contiguous():
        return x.view(-1, x.shape[-1])
    raise ValueError(f"{name}: x must be contiguous, or 2-D with unit "
                     f"stride in its last dimension")


def _meta(x: torch.Tensor) -> bool:
    """A meta tensor while a counter counts: the shape functions' route."""
    return x.device.type == "meta" and _counter.active() is not None


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if _meta(x):
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    _check_scale("rmsnorm", x, scale)
    return _launch(_rows("rmsnorm", x), scale, eps).view(x.shape)


def rmsnorm_backward(x, scale, dy, eps: float):
    """Closed-form gradients of ``sum(rmsnorm(x) * scale * dy)`` for x and
    scale, in fp32: with r = rsqrt(mean(x²) + eps) and u = dy * scale,
    dx = r u - x r³ mean(u x) and dscale = sum over rows of dy x r."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    u = dyf * scale.float()
    dx = r * (u - xf * (r * r) * (u * xf).mean(-1, keepdim=True))
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        d = x.shape[-1]
        rows = x.numel() // d
        with _counter.region(
                "rmsnorm_backward", lambda: costs.rmsnorm_backward(
                    rows, d, elem=x.element_size(),
                    scale_elem=scale.element_size()),
                scratch=backward_scratch_bytes(rows, d)):
            if _meta(x):
                grads = (torch.empty_like(x), torch.empty_like(scale))
            elif x.device.type == "cpu":
                grads = rmsnorm_backward(x, scale, dy, ctx.eps)
            else:
                grads = backward_kernel(x, scale, dy, ctx.eps)
            _counter.keep(*grads)
        return (*grads, None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Returns rmsnorm(x) * scale in x's type."""
    if x.device.type not in ("cpu", "cuda") and not _meta(x):
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


rmsnorm.launches = 0
rmsnorm.backward_launches = 0


def rmsnorm_residual_plain(x, residual, scale, eps: float = 1e-6):
    """The plain twin: h = x + residual in fp32, normed from the fp32 h."""
    h = x.float() + residual.float()
    return ref.rmsnorm(h, scale, eps).to(x.dtype), h.to(x.dtype)


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor,
                     scale: torch.Tensor, *, eps: float = 1e-6):
    """x, residual: (..., d); scale: (d,).  Returns (rmsnorm(x + residual)
    * scale, x + residual), both in x's type.  Forward only."""
    if x.device.type == "cpu":
        return rmsnorm_residual_plain(x, residual, scale, eps)
    if _meta(x):
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                torch.empty_like(x, memory_format=torch.contiguous_format))
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_residual: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, residual, scale)):
        raise NotImplementedError("rmsnorm_residual has no backward")
    _check_scale("rmsnorm_residual", x, scale)
    if residual.shape != x.shape or residual.device != x.device:
        raise ValueError(f"rmsnorm_residual: residual {tuple(residual.shape)}"
                         f" on {residual.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    x2 = _rows("rmsnorm_residual", x)
    r2 = _rows("rmsnorm_residual", residual)
    rows, d = x2.shape
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    h = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows:
        _kernel()[1][(rows,)](x2, r2, scale, y, h, x2.stride(0), r2.stride(0),
                              y.stride(0), h.stride(0), d, float(eps),
                              **_grid(d))
        with _count_lock:
            rmsnorm_residual.launches += 1
    return y.view(x.shape), h.view(x.shape)


rmsnorm_residual.launches = 0


def row_sumsq(x: torch.Tensor) -> torch.Tensor:
    """x: (..., d).  Each row's sum of squares in fp32, x's leading
    shape: the kernel for a CUDA tensor, the plain twin on the CPU."""
    d = x.shape[-1]
    with _counter.region("row_sumsq", lambda: costs.row_sumsq(
            x.numel() // max(d, 1), d, elem=x.element_size())):
        out = _row_sumsq(x)
        _counter.keep(out)
    return out


def _row_sumsq(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.row_sumsq(x)
    if _meta(x):
        return torch.empty(x.shape[:-1], dtype=torch.float32,
                           device=x.device)
    if x.device.type != "cuda" or x.dtype not in _SUPPORTED:
        raise ValueError(f"row_sumsq: no kernel for {x.dtype} on {x.device}")
    x2 = _rows("row_sumsq", x)
    rows, d = x2.shape
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        _kernel()[3][(rows,)](x2, out, x2.stride(0), d, **_grid(d))
        with _count_lock:
            row_sumsq.launches += 1
    return out.view(x.shape[:-1])


row_sumsq.launches = 0


def rmsnorm_total(x: torch.Tensor, scale: torch.Tensor, total: torch.Tensor,
                  d_full: int, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d), this rank's columns of rows of ``d_full``; scale: its
    (d,) columns; total: each whole row's sum of squares, fp32, x's
    leading shape.  Returns x * rsqrt(total / d_full + eps) * scale in
    x's type."""
    d = x.shape[-1]
    with _counter.region("rmsnorm_total", lambda: costs.rmsnorm_total(
            x.numel() // max(d, 1), d, elem=x.element_size(),
            scale_elem=scale.element_size())):
        out = _rmsnorm_total(x, scale, total, d_full, eps)
        _counter.keep(out)
    return out


def _rmsnorm_total(x, scale, total, d_full: int, eps: float):
    if x.device.type == "cpu":
        return ref.rmsnorm_total(x, scale, total, d_full, eps)
    if _meta(x):
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_total: no kernel for device {x.device}")
    _check_scale("rmsnorm_total", x, scale)
    x2 = _rows("rmsnorm_total", x)
    rows, d = x2.shape
    t = total.reshape(-1)
    if t.shape != (rows,) or t.dtype != torch.float32 \
            or t.device != x.device or not t.is_contiguous():
        raise ValueError(f"rmsnorm_total: total must be a contiguous fp32 "
                         f"({rows},) tensor on {x.device}, got "
                         f"{tuple(total.shape)} {total.dtype}")
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows:
        _kernel()[4][(rows,)](x2, scale, t, out, x2.stride(0),
                              out.stride(0), d, float(d_full), float(eps),
                              **_grid(d))
        with _count_lock:
            rmsnorm_total.launches += 1
    return out.view(x.shape)


rmsnorm_total.launches = 0


def rmsnorm_split_backward(x, scale, total, dy, reduce, d_full: int,
                           eps: float):
    """Closed-form gradients of ``sum(rmsnorm_split(x) * dy)`` for x and
    this rank's columns of the scale, in fp32: with r = rsqrt(total /
    d_full + eps) and u = dy * scale, dx = r u - x r^3 s / d_full, s the
    sum over the whole row (``reduce`` of the rank's sums) of u x, and
    dscale = sum over rows of dy x r."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(total.float() / d_full + eps)[..., None]
    u = dyf * scale.float()
    s = reduce((u * xf).sum(-1))[..., None]
    dx = r * u - xf * (r * r * r) * s / d_full
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNormSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, reduce, d_full, eps):
        total = reduce(row_sumsq(x))
        ctx.save_for_backward(x, scale, total)
        ctx.reduce, ctx.d_full, ctx.eps = reduce, d_full, eps
        return rmsnorm_total(x, scale, total, d_full, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, total = ctx.saved_tensors
        dx, dscale = rmsnorm_split_backward(x, scale, total, dy, ctx.reduce,
                                            ctx.d_full, ctx.eps)
        return dx, dscale, None, None, None


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, *, d_full: int,
                  reduce, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm of rows of ``d_full`` split across ranks: x (..., d) and
    scale (d,) this rank's columns; ``reduce`` sums a fp32 tensor of x's
    leading shape over the ranks (returning the sum).  ``row_sumsq``, the
    sum, then ``rmsnorm_total``; with a gradient through
    ``_RMSNormSplit``, whose backward sums once more."""
    if x.device.type not in ("cpu", "cuda") and not _meta(x):
        raise ValueError(f"rmsnorm_split: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormSplit.apply(x, scale, reduce, d_full, eps)
    return rmsnorm_total(x, scale, reduce(row_sumsq(x)), d_full, eps)
