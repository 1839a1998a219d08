"""Mamba2 SSD chunked scan: a hand-written CUDA C++ kernel for Hopper, its
plain PyTorch twin, and its gradient.

The kernels (``csrc/ssd_scan.cu``) replace the Pallas TPU kernel
``repro/kernels/ssd_scan.py`` · ``ssd_scan``; the source's header says what
bounds them on an H100 and how the design answers that.  They are compiled
by nvcc for ``sm_90a`` at first use (``_build.py``) and called through
ctypes on PyTorch's current stream.  In bf16 one ``ssd_scan_fwd`` call
launches the three stages of the Mamba2 chunked algorithm (chunk state,
state passing, chunk scan, the plain ``ref.ssd_chunk_state`` /
``ssd_state_passing`` / ``ssd_chunk_scan``) on tensor cores, through fp32
scratch the wrapper allocates; fp32 inputs take the first, scalar kernel.

Why CUDA C++ and not Triton: per chunk the scan is four small matrix
products with a state carried from one chunk to the next inside the
program, not a fused elementwise pass or a reduction.

``ssd_scan`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; it uses the plain twin (``ref.ssd_chunked``) only
for tensors on the CPU.  ``ssd_scan_state`` is the same for prefill: it
also returns the state after the last chunk, which the kernel writes into
a buffer the wrapper allocates (the TPU kernel returns y only; the JAX
package's prefill takes its jnp chunked path instead).  No gradient flows
through it: serving only.  ``ssd_scan.launches`` counts the
``ssd_scan_fwd`` calls of both, one per forward, bf16 or fp32; the CPU
path counts none.  ``run_stage`` launches one bf16 stage alone, to hold it
against its stage function; it is not counted.

The gradient: when an input requires one, the call goes through
``_SSDScan``, whose forward is the kernel and whose backward,
``ssd_scan_backward``, recomputes y through the masked chunked form under
autograd from the saved inputs.  The TPU kernel has no backward (the JAX
package differentiates its jnp reference), so there is no backward kernel
yet; the backward is counted op by op, on every device.

A ``meta`` tensor, while a ``roofline.counter.Counter`` counts, takes the
kernel's shape function: empty y (and the fp32 final state) of the
kernel's shapes; meta carries no values, so this is no fallback, and
outside a count it raises as any device without a kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build, ref
from repro_torch.roofline import counter as _counter

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
# the bf16 stage kernels' C entries, in the order ssd_scan_fwd runs them
STAGES = {"chunk_state": "ssd_scan_chunk_state_fwd",
          "state_passing": "ssd_scan_state_passing_fwd",
          "chunk_scan": "ssd_scan_chunk_scan_fwd"}


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 256):
    """The plain twin: the same function through ``ref.ssd_chunked``."""
    return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)[0]


def ssd_scan_state_plain(x, dt, A, B, C, *, chunk: int = 256):
    """The plain twin of ``ssd_scan_state``: (y, final state)."""
    return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)


def ssd_scan_backward(x, dt, A, B, C, dy, *, chunk: int):
    """Gradients of ``sum(y * dy)`` for x, dt, A, B and C, by recomputing y
    through ``ref.ssd_chunked`` (masked before its exp, so finite at any
    chunk) under autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
        y, _ = ref.ssd_chunked(*leaves, chunk=chunk)
        return torch.autograd.grad(y, leaves, dy)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in ("ssd_scan_fwd", *STAGES.values()):
        fn = getattr(lib, entry)
        fn.argtypes = [ptr] * 9 + [i32] * 8 + [i64] * 15 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError("ssd_scan: x (b,s,h,p), dt (b,s,h), A (h,), "
                         "B, C (b,s,g,n) expected")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape[:2]) != (b, s) or C.shape != B.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} disagree")
    if h % g:
        raise ValueError(f"ssd_scan: h={h} not a multiple of g={g}")
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan: p={p} > {MAX_P} or n={n} > {MAX_N}")
    if not 0 < chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must be in 1..{MAX_CHUNK} "
                         f"and divide s={s} (ops.ssd pads)")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: dtypes x {x.dtype}, B {B.dtype}, C "
                        f"{C.dtype}; need one of float32 / bfloat16")
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("ssd_scan: inputs on different devices")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd_scan: the last dim of x, B, C must have unit "
                         "stride")


def _scratch(x, B, chunk: int):
    """The bf16 path's fp32 scratch: cum (b, h, chunks, chunk) and the
    states (b, h, chunks, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[3]
    kw = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((b, h, s // chunk, chunk), **kw),
            torch.empty((b, h, s // chunk, p, n), **kw))


def _call(entry: str, x, dt, A, B, C, y, cum, states, chunk: int,
          final=None) -> None:
    """One C entry.  ``final``: a contiguous fp32 (b, h, p, n) buffer for
    the state after the last chunk, or None."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(),
            None if cum is None else cum.data_ptr(),
            None if states is None else states.data_ptr(),
            None if final is None else final.data_ptr(),
            _DTYPES[x.dtype], b, s, h, p, g, n, chunk, *x.stride()[:3],
            *dt.stride(), *B.stride()[:3], *C.stride()[:3], *y.stride()[:3],
            stream)
    if err:
        raise RuntimeError(f"ssd_scan: {entry} failed with CUDA error {err}")


def _launch(x, dt, A, B, C, chunk: int, *, with_state: bool = False):
    """Launch ``ssd_scan_fwd``: y, or (y, final state) ``with_state``."""
    _check(x, dt, A, B, C, chunk)
    dt = dt.float()
    A = A.float().contiguous()
    b, _, h, p = x.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # its own contiguous buffer, apart from the states scratch (which has a
    # chunk axis and is overwritten in place); torch's allocation keeps it
    # 16-byte aligned for the kernel's vector stores
    final = (torch.empty((b, h, p, B.shape[3]), dtype=torch.float32,
                         device=x.device) if with_state else None)
    if y.numel() == 0:
        if final is not None:
            final.zero_()
        return (y, final) if with_state else y
    cum = states = None
    if x.dtype == torch.bfloat16:
        cum, states = _scratch(x, B, chunk)
    _call("ssd_scan_fwd", x, dt, A, B, C, y, cum, states, chunk, final)
    with _count_lock:
        ssd_scan.launches += 1
    return (y, final) if with_state else y


def run_stage(stage: str, x, dt, A, B, C, *, chunk: int, cum=None,
              states=None):
    """One bf16 stage kernel alone on CUDA tensors, to hold it against its
    plain stage function in ``ref``; not counted in ``ssd_scan.launches``.

    ``chunk_state`` returns new (cum, states) like ``ref.ssd_chunk_state``;
    ``state_passing`` returns (the states entering each chunk, computed in
    place on a copy of ``states`` (from stage 1) with ``cum``, and the
    final state);
    ``chunk_scan`` returns y from ``cum`` and the entering ``states``."""
    if stage not in STAGES:
        raise ValueError(f"ssd_scan: no stage {stage!r}; one of "
                         f"{list(STAGES)}")
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("ssd_scan: the stage kernels take bf16 CUDA tensors")
    _check(x, dt, A, B, C, chunk)
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    final = None
    if stage == "chunk_state":
        cum, states = _scratch(x, B, chunk)
    elif stage == "state_passing":
        states = states.contiguous().clone()
        b, _, h, p = x.shape
        final = torch.empty((b, h, p, B.shape[3]), dtype=torch.float32,
                            device=x.device)
    _call(STAGES[stage], x, dt, A, B, C, y, cum.contiguous(),
          states.contiguous(), chunk, final)
    return {"chunk_state": (cum, states), "state_passing": (states, final),
            "chunk_scan": y}[stage]


def _meta(x) -> bool:
    """A meta tensor while a counter counts: the shape function's route."""
    return x.device.type == "meta" and _counter.active() is not None


def _meta_outputs(x, B):
    """The shape function: y (b,s,h,p) in x's type, the final state
    (b,h,p,n) fp32, empty."""
    b, _, h, p = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((b, h, p, B.shape[3]), dtype=torch.float32,
                        device=x.device))


def scratch_bytes(b: int, s: int, h: int, p: int, n: int, chunk: int,
                  dtype) -> int:
    """The bytes of the bf16 path's fp32 scratch (``_scratch``) at a
    (padded) length s; the fp32 path takes none."""
    if dtype != torch.bfloat16:
        return 0
    return 4 * b * h * (s + (s // chunk) * p * n)


def _forward(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if _meta(x):
        return _meta_outputs(x, B)[0]
    return _launch(x, dt, A, B, C, chunk)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = ssd_scan_backward(*ctx.saved_tensors, dy, chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256) -> torch.Tensor:
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n), h % g == 0, s a
    multiple of ``chunk``.  Returns y: (b,s,h,p) in x's type."""
    if x.device.type not in ("cpu", "cuda") and not _meta(x):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        return _SSDScan.apply(x, dt, A, B, C, chunk)
    return _forward(x, dt, A, B, C, chunk)


ssd_scan.launches = 0


def ssd_scan_state(x, dt, A, B, C, *, chunk: int = 256):
    """``ssd_scan`` that also returns the state after the last chunk, for
    prefill: (y (b,s,h,p) in x's type, state (b,h,p,n) fp32).  The kernel
    writes both on CUDA (counted in ``ssd_scan.launches``); the plain twin
    computes them on the CPU.  No gradient: serving only."""
    if x.device.type not in ("cpu", "cuda") and not _meta(x):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        raise NotImplementedError("ssd_scan_state has no backward: it "
                                  "serves prefill only")
    if x.device.type == "cpu":
        return ssd_scan_state_plain(x, dt, A, B, C, chunk=chunk)
    if _meta(x):
        return _meta_outputs(x, B)
    return _launch(x, dt, A, B, C, chunk, with_state=True)
