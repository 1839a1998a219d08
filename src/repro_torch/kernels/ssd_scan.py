"""Mamba2 SSD chunked scan: hand-written CUDA C++ kernels for Hopper, their
plain PyTorch twin, and the gradient.

The kernels (``csrc/ssd_scan.cu``) replace the Pallas TPU kernel
``repro/kernels/ssd_scan.py`` · ``ssd_scan``; the source's header says what
bounds them on an H100 and how the design answers that.  They are compiled
by nvcc for ``sm_90a`` at first use (``_build.py``) and called through
ctypes on PyTorch's current stream.  Three variants, chosen in one place,
``variant``, and launched by the C entry as told (a call its variant does
not take is refused, never sent to another kernel):

* ``"wgmma"``: bf16 at the model's shapes (p a multiple of 16 up to 64, n
  16, 32, 64 or 128, a chunk a multiple of 64, every base and stride of x,
  B and C 16-byte aligned, as the conv output's slices are).  Two kernels
  on Hopper's warpgroup products, fed by TMA: the state kernel
  (``ref.ssd_chunk_state`` and ``ref.ssd_state_passing`` in one, each
  (b, h) walking its chunks with the fp32 state in its accumulator; it
  writes the entering states as the bf16 pairs of ``ref.ssd_state_split``)
  and the chunk scan (``ref.ssd_chunk_scan``, C B^T computed once for
  ``WQ_HEADS`` heads of a group).  Tiles are as wide as the state: hymba's
  n = 16 is not padded; nor is a sequence that is not a multiple of the
  chunk (``takes_ragged``: the kernels read its end as zeros).  What
  bounds them: the products need wgmma to reach the card's rate, and the
  mma kernels moved the state scratch three times; now the chunk scan's
  alternation of decays and products holds them.  At mamba2-780m's
  training shape (4 x 2048) they take 0.1467-0.1509 ms against 0.3305 ms
  for the mma kernels, and at hymba's prefill 0.0747 against 0.3014, in
  turns on an NVIDIA H100 80GB HBM3 at 700 W (``tools/kernel_compare.py``;
  PERF.md section 6).
* ``"mma"``: the other bf16 shapes (small p or n, a chunk of 24,
  unaligned views): three ``mma.sync`` stage kernels, chunk state, state
  passing and chunk scan, tiles padded to p 64 and n 128.
* ``"scalar"``: fp32, the first, scalar kernel.

Why CUDA C++ and not Triton: per chunk the scan is four small matrix
products with a state carried from one chunk to the next inside the
program, not a fused elementwise pass or a reduction.

``ssd_scan`` launches the kernels for CUDA tensors and raises on anything
no kernel takes; it uses the plain twin (``ref.ssd_chunked``) only for
tensors on the CPU.  ``ssd_scan_state`` is the same for prefill: it also
returns the state after the last chunk, which the kernels write into a
buffer the wrapper allocates (the TPU kernel returns y only; the JAX
package's prefill takes its jnp chunked path instead).  No gradient flows
through it: serving only.  ``ssd_scan.launches`` counts the
``ssd_scan_fwd`` calls of both, one per forward, bf16 or fp32, and
``ssd_scan.launches_by_variant`` the same by variant; the CPU path counts
none.  ``run_stage`` launches one kernel of a variant alone, to hold it
against its stage function; it is not counted.

The gradient: when an input requires one, the call goes through
``_SSDScan``, whose forward is the kernel and whose backward routes by
device, as ``_FlashAttention``'s does.  On CUDA tensors it launches the
backward kernels (``csrc/ssd_scan_bwd.cu``, no TPU counterpart: the TPU
kernel has no backward and the JAX package differentiates its jnp
reference): the entering states again in fp32, the d-states, the chunk
kernel and a reduction, of the variant ``backward_variant`` chooses
(``backward_kernel``): ``"wgmma"`` at the models' shapes (the chunk stage
in band form: a block per (b, chunk, band of ``backward_band`` heads), C
B^T once a band, dCB summed over the band before its products with B and
C, wgmma fed by TMA, one dB / dC partial a band), ``"mma"`` at the other
bf16 shapes, ``"scalar"`` for fp32.  On CPU tensors it takes the staged twin
``ref.ssd_chunked_backward`` (the same stages in closed form); on meta,
while a counter counts, empty gradients of the inputs' shapes.  It is one
counter region, ``ssd_scan_backward``.  ``ssd_scan.backward_launches``
counts the backward kernel calls (one per backward, by variant in
``backward_launches_by_variant``); the CPU path counts none.
``ssd_scan_backward`` (autograd through ``ref.ssd_chunked``) is kept as an
independent oracle for checks; no route calls it.

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
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.roofline import costs
from repro_torch.roofline import counter as _counter

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
# the variants, by the code the C entry takes; the state widths n the wgmma
# kernels are built for and the rows of their sub-blocks (the chunk is a
# multiple)
VARIANTS = {"scalar": 0, "mma": 1, "wgmma": 2}
WGMMA_WIDTHS = (16, 32, 64, 128)
WGMMA_TILE = 64
# each bf16 variant's kernels alone: {stage: C entry}, in the order
# ssd_scan_fwd runs them
STAGES = {"mma": {"chunk_state": "ssd_scan_chunk_state_fwd",
                  "state_passing": "ssd_scan_state_passing_fwd",
                  "chunk_scan": "ssd_scan_chunk_scan_fwd"},
          "wgmma": {"state": "ssd_scan_state_wgmma_fwd",
                    "chunk_scan": "ssd_scan_chunk_scan_wgmma_fwd"}}


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 256):
    """The plain twin: the same function through ``ref.ssd_chunked``."""
    return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)[0]


def ssd_scan_state_plain(x, dt, A, B, C, *, chunk: int = 256):
    """The plain twin of ``ssd_scan_state``: (y, final state)."""
    return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)


def ssd_scan_backward(x, dt, A, B, C, dy, *, chunk: int):
    """Gradients of ``sum(y * dy)`` for x, dt, A, B and C, by recomputing y
    through ``ref.ssd_chunked`` (masked before its exp, so finite at any
    chunk) under autograd: an oracle independent of the staged twin
    (``ref.ssd_chunked_backward``) and of the kernels; no route calls it.
    A sequence that is not a multiple of the chunk (the wgmma kernels'
    forward takes it as it is) is padded with zeros, dt 0, inside the
    recompute: the padding's arithmetic, and the gradients of the unpadded
    inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
        lx, ldt, lA, lB, lC = leaves
        s = x.shape[1]
        pad = (-s) % chunk
        if pad:
            lx, lB, lC = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (lx, lB, lC))
            ldt = F.pad(ldt, (0, 0, 0, pad))
        y, _ = ref.ssd_chunked(lx, ldt, lA, lB, lC, chunk=chunk)
        return torch.autograd.grad(y[:, :s], leaves, dy)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = [ptr] * 9 + [i32] * 8 + [i64] * 15 + [ptr]
    for entry in ("ssd_scan_fwd",
                  *(e for stages in STAGES.values() for e in stages.values())):
        fn = getattr(lib, entry)
        fn.argtypes = args + [i32] if entry == "ssd_scan_fwd" else args
        fn.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [i32] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_int
    return lib


def _aligned16(t) -> bool:
    """t starts on a 16-byte boundary and every stride but the last is a
    whole number of 16-byte chunks (bf16): what a TMA tensor map takes."""
    return (t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:-1]))


def variant(p: int, n: int, chunk: int, dtype, aligned: bool) -> str:
    """The kernels that serve a call on the card: ``"wgmma"`` for bf16 with
    p a multiple of 16 (up to ``MAX_P``), n one of ``WGMMA_WIDTHS``, a
    chunk a multiple of ``WGMMA_TILE`` and x, B and C 16-byte aligned
    (``aligned``: ``_aligned16`` of each); ``"mma"`` for any other bf16
    call; ``"scalar"`` for fp32."""
    if dtype != torch.bfloat16:
        return "scalar"
    if (aligned and p % 16 == 0 and p <= MAX_P and n in WGMMA_WIDTHS
            and chunk % WGMMA_TILE == 0 and chunk <= MAX_CHUNK):
        return "wgmma"
    return "mma"


def _variant_of(x, B, C, chunk: int) -> str:
    """``variant`` of these tensors."""
    return variant(x.shape[3], B.shape[3], chunk, x.dtype,
                   _aligned16(x) and _aligned16(B) and _aligned16(C))


def takes_ragged(x, B, C, chunk: int) -> bool:
    """Whether a sequence that is not a multiple of ``chunk`` goes to the
    kernels as it is: the wgmma kernels read the rows past it as zeros and
    dt there as 0, the arithmetic of ``ops``' padding without its copies.
    Every other path is padded by ``ops``."""
    return x.device.type == "cuda" and _variant_of(x, B, C, chunk) == "wgmma"


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
    if not 0 < chunk <= MAX_CHUNK or (s % chunk and not takes_ragged(
            x, B, C, chunk)):
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


def _scratch(x, B, chunk: int, which: str = "mma"):
    """A bf16 variant's scratch: cum (b, h, chunks, chunk) fp32 and the
    states, for ``"mma"`` each chunk's (b, h, chunks, p, n) fp32, for
    ``"wgmma"`` the state entering each chunk as bf16 pairs (b, h, chunks,
    p, 2, n), hi then lo (``ref.ssd_state_split``).  The same bytes."""
    b, s, h, p = x.shape
    n = B.shape[3]
    nc = -(-s // chunk)     # a ragged end (the wgmma kernels) is a chunk
    cum = torch.empty((b, h, nc, chunk), dtype=torch.float32,
                      device=x.device)
    if which == "wgmma":
        states = torch.empty((b, h, nc, p, 2, n), dtype=torch.bfloat16,
                             device=x.device)
    else:
        states = torch.empty((b, h, nc, p, n), dtype=torch.float32,
                             device=x.device)
    return cum, states


def _call(entry: str, x, dt, A, B, C, y, cum, states, chunk: int,
          final=None) -> None:
    """One C entry.  ``final``: a contiguous fp32 (b, h, p, n) buffer for
    the state after the last chunk, or None.  ``ssd_scan_fwd`` is told the
    variant of these tensors (``variant``)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    lib = _library()
    extra = ((VARIANTS[_variant_of(x, B, C, chunk)],)
             if entry == "ssd_scan_fwd" else ())
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
            stream, *extra)
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
    which = _variant_of(x, B, C, chunk)
    cum = states = None
    if which != "scalar":
        cum, states = _scratch(x, B, chunk, which)
    _call("ssd_scan_fwd", x, dt, A, B, C, y, cum, states, chunk, final)
    with _count_lock:
        ssd_scan.launches += 1
        ssd_scan.launches_by_variant[which] += 1
    return (y, final) if with_state else y


def run_stage(stage: str, x, dt, A, B, C, *, chunk: int, cum=None,
              states=None):
    """One bf16 kernel alone on CUDA tensors, of the variant of these
    inputs (``variant``), to hold it against its plain stage function in
    ``ref``; not counted in ``ssd_scan.launches``.

    The mma variant: ``chunk_state`` returns new (cum, states) like
    ``ref.ssd_chunk_state``; ``state_passing`` returns (the states
    entering each chunk, computed in place on a copy of ``states`` (from
    stage 1) with ``cum``, and the final state); ``chunk_scan`` returns y
    from ``cum`` and the entering ``states``.  The wgmma variant:
    ``state`` returns (cum, the entering states as (hi, lo) bf16 pairs
    (b, h, chunks, p, 2, n), the final state) like ``ref.ssd_chunk_state``,
    ``ref.ssd_state_passing`` and ``ref.ssd_state_split`` together;
    ``chunk_scan`` returns y from ``cum`` and the pairs ``states``."""
    if not any(stage in stages for stages in STAGES.values()):
        raise ValueError(f"ssd_scan: no stage {stage!r}; one of "
                         f"{ {k: list(v) for k, v in STAGES.items()} }")
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("ssd_scan: the stage kernels take bf16 CUDA tensors")
    _check(x, dt, A, B, C, chunk)
    which = _variant_of(x, B, C, chunk)
    if stage not in STAGES[which]:
        raise ValueError(f"ssd_scan: the {which} variant serves these "
                         f"inputs and has no stage {stage!r}")
    dt = dt.float()
    A = A.float().contiguous()
    b, _, h, p = x.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    final = None
    if stage in ("chunk_state", "state"):
        cum, states = _scratch(x, B, chunk, which)
    if stage in ("state_passing", "state"):
        if stage == "state_passing":
            states = states.contiguous().clone()
        final = torch.empty((b, h, p, B.shape[3]), dtype=torch.float32,
                            device=x.device)
    _call(STAGES[which][stage], x, dt, A, B, C, y, cum.contiguous(),
          states.contiguous(), chunk, final)
    return {"chunk_state": (cum, states), "state_passing": (states, final),
            "state": (cum, states, final), "chunk_scan": y}[stage]


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
    """The bytes of a bf16 variant's scratch (``_scratch``) at a length s
    padded to the chunk (the wgmma kernels' ragged end takes a whole
    chunk's too), the same for both: fp32 cum, and fp32 states or as many
    bytes of bf16 pairs; the fp32 path takes none."""
    if dtype != torch.bfloat16:
        return 0
    nc = -(-s // chunk)
    return 4 * b * h * nc * (chunk + p * n)


def _forward(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if _meta(x):
        return _meta_outputs(x, B)[0]
    return _launch(x, dt, A, B, C, chunk)


# the backward's variants, by the code its C entry takes, and the state
# widths the mma chunk kernel is built for (n is padded up to one)
BACKWARD_VARIANTS = {"scalar": 0, "mma": 1, "wgmma": 2}
BACKWARD_MMA_WIDTHS = (16, 32, 64, 128)
# the wgmma chunk kernel: heads a band takes at most (a block per (b,
# chunk, band)), the longest chunk its shared memory holds a column of C
# B^T for, and the multiprocessors of the card it is sized for (an H100
# SXM: one block each)
BACKWARD_BAND = 4
BACKWARD_WGMMA_MAX_CHUNK = 256
BACKWARD_SMS = 132


def backward_variant(p: int, n: int, chunk: int, dtype,
                     aligned: bool = True) -> str:
    """The backward kernels that serve a call on the card, chosen here and
    nowhere else: ``"wgmma"`` for bf16 at the models' shapes (p a multiple
    of 16 up to ``MAX_P``, n one of ``WGMMA_WIDTHS``, a chunk a multiple of
    ``WGMMA_TILE`` up to ``BACKWARD_WGMMA_MAX_CHUNK``, and x, B, C and dy
    16-byte aligned: ``aligned``, ``_aligned16`` of each): the chunk stage
    in band form on wgmma fed by TMA; ``"mma"`` for the other bf16 shapes
    (the test shapes' chunk of 24, p 12 or n 10, unaligned views: the
    mma.sync chunk kernel, p padded to 64 and n to the next of
    ``BACKWARD_MMA_WIDTHS``; TMA needs 16-byte rows and wgmma 64-row
    tiles); ``"scalar"`` (register-tiled fp32 FMAs) for fp32.  Every shape
    the forward takes (p <= ``MAX_P``, n <= ``MAX_N``, a chunk up to
    ``MAX_CHUNK``) has a kernel; anything else raises: no call is sent to
    another kernel or the twin."""
    if dtype not in _DTYPES or not (0 < p <= MAX_P and 0 < n <= MAX_N
                                    and 0 < chunk <= MAX_CHUNK):
        raise NotImplementedError(
            f"ssd_scan backward: no kernel for p={p}, n={n}, chunk={chunk}, "
            f"{dtype}")
    if dtype != torch.bfloat16:
        return "scalar"
    if (aligned and p % 16 == 0 and n in WGMMA_WIDTHS
            and chunk % WGMMA_TILE == 0
            and chunk <= BACKWARD_WGMMA_MAX_CHUNK):
        return "wgmma"
    return "mma"


def backward_band(b: int, s: int, h: int, g: int, chunk: int,
                  which: str) -> int:
    """Heads a block of the backward's chunk stage takes.  For
    ``"wgmma"`` a band of W heads of one group, so C B^T is computed once
    a band and dCB is summed over the band before its products with B and
    C, and dB / dC leave as one partial a band; a group whose head count W
    does not divide ends in a ragged band (hymba's 25 heads a rank at W 2:
    twelve bands of 2 and one of 1), and no band takes two groups.  W is
    the one of 4, 2, 1 (at most the group's heads) whose blocks, one a
    multiprocessor, need the fewest waves of head work (waves x W), the
    widest on a tie: a block's time grows with its heads (the kernel waits
    on each head's products), so at mamba2-780m's 4 x 2048 the three take
    the same chunk time and 4 leaves the fewest partials, while a grid of
    a few dozen blocks (a model-axis rank, 2 x 2048) runs faster in more,
    narrower bands (PERF.md section 6).  The other variants take one head
    a block."""
    if which != "wgmma":
        return 1
    hpg, nc = h // g, -(-s // chunk)

    def waves(w):
        blocks = b * nc * g * -(-hpg // w)
        return -(-blocks // BACKWARD_SMS) * w

    return min((w for w in (BACKWARD_BAND, 2, 1) if w <= hpg),
               key=waves)


def _backward_dy(x, dy):
    """dy as the backward kernels read it: in x's type, the last dimension
    contiguous."""
    dy = dy.to(x.dtype)
    return dy if dy.stride(3) == 1 else dy.contiguous()


def _backward_variant_of(x, B, C, dy, chunk: int) -> str:
    """``backward_variant`` of these tensors (dy as ``_backward_dy``)."""
    return backward_variant(
        x.shape[3], B.shape[3], chunk, x.dtype,
        all(_aligned16(t) for t in (x, B, C, dy)))


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bwd.argtypes = ([ptr] * 17 + [i32] * 8
                                 + [i64] * 15 + [ptr, i32, i32])
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i32]
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def _backward_parts(b: int, s: int, h: int, g: int, chunk: int,
                    which: str) -> int:
    """The dB / dC partials of a (b, t): one a head, or for ``"wgmma"``
    one a band (``backward_band``), each group's bands side by side."""
    band = backward_band(b, s, h, g, chunk, which)
    return g * -(-(h // g) // band)


def _backward_scratch(b: int, s: int, h: int, p: int, g: int, n: int,
                      chunk: int, which: str, device) -> dict:
    """The scratch ``backward_kernel`` allocates for a variant, fp32: the
    entering states and the d-states (b, h, chunks, p, n; the wgmma walks
    leave them as bf16 pairs in the same bytes), the dB / dC partials (b,
    s, parts, n: a head's, or a band's for ``"wgmma"``), the (b, chunks,
    h) dA partials and, for bf16, each chunk's exp(total)."""
    nc = -(-s // chunk)
    parts = _backward_parts(b, s, h, g, chunk, which)
    f32 = dict(dtype=torch.float32, device=device)
    out = dict(states=torch.empty((b, h, nc, p, n), **f32),
               dS=torch.empty((b, h, nc, p, n), **f32),
               dB_part=torch.empty((b, s, parts, n), **f32),
               dC_part=torch.empty((b, s, parts, n), **f32),
               dA_part=torch.empty((b, nc, h), **f32),
               tot=None)
    if which != "scalar":
        out["tot"] = torch.empty((b, h, nc), **f32)
    return out


def backward_scratch_bytes(b: int, s: int, h: int, p: int, n: int,
                           chunk: int, dtype, *, g: int = 1,
                           which: str | None = None) -> int:
    """The bytes ``backward_kernel`` allocates beside the gradients
    (``_backward_scratch``) for the variant ``which`` (by default the one
    an aligned call of this shape takes, ``backward_variant``): the fp32
    entering states and d-states, the dB / dC partials (a head's, or a
    band's for ``"wgmma"``: 1 / band of them), the dA partials and, for
    bf16, each chunk's exp(total)."""
    if which is None:
        which = backward_variant(p, n, chunk, dtype)
    nc = -(-s // chunk)
    parts = _backward_parts(b, s, h, g, chunk, which)
    return (8 * b * h * nc * p * n + 8 * b * s * parts * n
            + 4 * b * nc * h * (1 if which == "scalar" else 2))


def backward_kernel(x, dt, A, B, C, dy, *, chunk: int):
    """The backward kernels on CUDA tensors: (dx, ddt, dA, dB, dC), each in
    its input's type and contiguous, of the variant ``backward_variant``
    names for these tensors.  The kernels compute the entering states
    again themselves, in fp32 (dA's sums need more than the forward's bf16
    operands give: PERF.md section 6).  For ``"wgmma"`` the chunk stage
    takes bands of ``backward_band`` heads and leaves dB and dC as one
    fp32 partial a band, which the reduction sums in band order (the other
    variants leave one a head); ``backward_scratch_bytes`` counts what is
    allocated here."""
    _check(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError("ssd_scan backward: the kernels take CUDA tensors")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dy = _backward_dy(x, dy)
    which = _backward_variant_of(x, B, C, dy, chunk)
    dtf = dt.float()
    Af = A.float().contiguous()
    dev = x.device
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = _backward_scratch(b, s, h, p, g, n, chunk, which, dev)
    ddt = torch.empty((b, s, h), **f32)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, s, g, n), dtype=B.dtype, device=dev)
    dC = torch.empty((b, s, g, n), dtype=C.dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_library().ssd_scan_bwd(
            x.data_ptr(), dtf.data_ptr(), Af.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), ptr(scratch["states"]),
            ptr(scratch["dS"]), dx.data_ptr(), ddt.data_ptr(),
            ptr(scratch["dB_part"]), ptr(scratch["dC_part"]),
            ptr(scratch["dA_part"]), ptr(scratch["tot"]), dB.data_ptr(),
            dC.data_ptr(), dA.data_ptr(), _DTYPES[x.dtype], b, s, h, p, g, n,
            chunk, *x.stride()[:3], *dtf.stride(), *B.stride()[:3],
            *C.stride()[:3], *dy.stride()[:3], stream,
            BACKWARD_VARIANTS[which],
            backward_band(b, s, h, g, chunk, which))
    if err:
        raise RuntimeError(f"ssd_scan: ssd_scan_bwd failed with CUDA error "
                           f"{err}")
    with _count_lock:
        ssd_scan.backward_launches += 1
        ssd_scan.backward_launches_by_variant[which] += 1
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        which = _backward_variant_of(x, B, C, _backward_dy(x, dy), chunk)
        with _counter.region(
                "ssd_scan_backward",
                lambda: costs.ssd_scan_backward(b, s, h, p, g, n, chunk,
                                                elem=x.element_size()),
                scratch=backward_scratch_bytes(b, s, h, p, n, chunk,
                                               x.dtype, g=g, which=which)):
            if x.device.type == "cpu":
                grads = tuple(t.contiguous() for t in
                              ref.ssd_chunked_backward(x, dt, A, B, C, dy,
                                                       chunk=chunk))
            elif x.device.type == "meta":
                grads = tuple(torch.empty_like(
                    t, memory_format=torch.contiguous_format)
                    for t in (x, dt, A, B, C))
            else:
                grads = backward_kernel(x, dt, A, B, C, dy, chunk=chunk)
            _counter.keep(*grads)
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
ssd_scan.launches_by_variant = dict.fromkeys(VARIANTS, 0)
ssd_scan.backward_launches = 0
ssd_scan.backward_launches_by_variant = dict.fromkeys(BACKWARD_VARIANTS, 0)


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
