"""Flash attention: hand-written CUDA C++ kernels for Hopper, forward and
backward, and their plain PyTorch twins.

The forward kernels (``csrc/flash_attention.cu``) replace the Pallas TPU
kernel ``repro/kernels/flash_attention.py`` · ``flash_attention``; the
backward kernels replace nothing on the TPU (``repro`` differentiates its
plain reference, ``ref.mha``).  The source's header says what bounds each
on an H100 and how the design answers that.  They are compiled by nvcc for
``sm_90a`` at first use (``_build.py``) and called through ctypes on
PyTorch's current stream.

``flash_attention`` launches a forward kernel for CUDA tensors and raises
on anything the kernels do not take; it uses the plain twin only for
tensors on the CPU.  ``forward_variant`` names the forward kernel of a
call, in one place, and the C entry launches what it is told:

* ``"wgmma"`` (``flash_fwd_wgmma_kernel<D>``): bf16, head dim 16, 32, 64,
  96 or 128, every row 16-byte aligned, more than ``DECODE_ROWS`` queries:
  prefill and training, on Hopper's warpgroup products (wgmma) with Q, K
  and V brought by TMA into mbarrier rings by a producer warp;
* ``"decode"`` (``flash_fwd_decode_kernel<D>``): the same with at most
  ``DECODE_ROWS`` queries (whisper's cross-attention decode, a ``kv_seq``
  rank's block): the key tiles split over the block's warps, their partial
  softmaxes combined in a fixed order;
* ``"scalar"`` (``flash_fwd_kernel``): fp32, head dim 24 and unaligned
  views.

When q, k or v needs a gradient it goes through ``_FlashAttention``, an
``autograd.Function``:

* on CUDA tensors its forward launches the kernel with the per-row
  logsumexp (``lse``, fp32 (B, H, S)) and saves q, k, v, o and lse; its
  backward launches the three backward kernels.  bf16 with a head dim
  that is a multiple of 16 and 16-byte-aligned rows only: anything else
  (fp32, head dim 24, unaligned views, a GQA group larger than a cluster)
  raises ``NotImplementedError``;
* on CPU tensors the same Function runs the plain twins
  ``flash_attention_plain_lse`` and ``flash_attention_backward_plain``
  (FlashAttention-2's equations from the saved lse, not autograd).

The backward on the card is bound by its matrix products (nine where the
bound counts five: S and dP in both passes, dS as a bf16 pair).  Every
tensor-core head dim (16, 32, 64, 96, 128) runs the ``wgmma`` kernels:
products on Hopper's warpgroup tensor-core instruction, tiles brought by
TMA into a two-stage ring of mbarrier-guarded stages by a producer warp
(a 192-byte row of head dim 96 as three swizzle panels of 64 bytes), one
dK / dV block per query head with the GQA group summed in fixed order
across a thread-block cluster (no atomics: the same bits on every call);
the shared memory a block takes is in the source's header (52 KB for
dK / dV at head dim 64, two blocks a multiprocessor).  ``backward_plan``
is the launch plan they read: each pass's grid, the cluster size and its
work list, (tile, first tile on the other side, tiles) per block,
heaviest first, built here from the masks so the CPU tests hold it.

Without a gradient the forward writes no lse, except in
``flash_attention_partial``: decode over one block of a K/V cache cut
over the model ranks (whisper's cross K/V on ``kv_seq``), where the
forward kernel writes o and lse for ``ops.combine_partial`` to merge the
ranks' blocks; its plain twin is ``flash_attention_plain_lse``.
``flash_attention.launches`` counts forward kernel launches (the partial
form's too) and ``flash_attention.launches_by_variant`` the same by
kernel; ``flash_attention.backward_launches`` counts backward calls on the
card (one a call, for its three launches).

A ``meta`` tensor, while a ``roofline.counter.Counter`` counts, takes the
kernels' shape functions: empty outputs of the kernel's shapes and types
(o, and lse where the kernel writes one; dq, dk, dv), no value computed.
Meta carries no values, so this is no fallback; outside a count a meta
tensor raises as any device without a kernel.  The backward is a kernel
region of its own (``flash_attention_backward``), declaring its scratch.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.roofline import costs
from repro_torch.roofline import counter as _counter

HEAD_DIMS = (16, 24, 32, 64, 96, 128)
# the backward's head dims (all on wgmma), its tile (queries or keys a
# block and a work item) and the largest cluster Hopper launches
# (non-portable past 8)
WGMMA_HEAD_DIMS = (16, 32, 64, 96, 128)
BWD_TILE = 64
MAX_CLUSTER = 16
# the forward's kernels, by the code the C entry takes, and the most query
# rows the decode form takes (one 16-row tile)
FORWARD_VARIANTS = {"scalar": 0, "wgmma": 1, "decode": 2}
DECODE_ROWS = 16
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


@dataclass(frozen=True, eq=False)
class BackwardPlan:
    """How the backward's passes launch at one shape.

    ``variant``: the kernels that serve the head dim (``"wgmma"``).
    ``cluster``: blocks in a dK / dV cluster, the GQA group, whose clusters
    sum it.  Grids as (x, y, z): ``grid_dkdv`` and ``grid_dq`` are
    (H, B, items);
    ``grid_preprocess`` (blocks,).  ``dkdv_items``: int32 (n, 3), one row
    per key tile, (key tile, first query tile, query tiles) that see it;
    ``dq_items``: one row per query tile, (query tile, first key tile, key
    tiles) it sees; both heaviest first.  Block z of a pass reads row z.
    ``s_pad``: S rounded up to a whole tile (the scratch's rows).  Plans
    are cached and shared: compared by identity, never written."""
    variant: str
    cluster: int
    grid_dkdv: Tuple[int, int, int]
    grid_dq: Tuple[int, int, int]
    grid_preprocess: Tuple[int]
    dkdv_items: torch.Tensor
    dq_items: torch.Tensor
    s_pad: int


def backward_variant(D: int, group: int) -> str:
    """The backward kernels that serve head dim D with ``group`` query heads
    per kv head.  Raises NotImplementedError for a head dim no tensor-core
    kernel takes and for a group no cluster holds."""
    if D not in WGMMA_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention backward: head dim {D} has no kernel "
            f"(tensor-core head dims {list(WGMMA_HEAD_DIMS)})")
    if group > MAX_CLUSTER:
        raise NotImplementedError(
            f"flash_attention backward: a GQA group of {group} query "
            f"heads needs a thread-block cluster of {group}; Hopper "
            f"launches at most {MAX_CLUSTER}")
    return "wgmma"


def forward_variant(S: int, T: int, H: int, K: int, D: int, dtype,
                    aligned: bool) -> str:
    """The forward kernel that serves a call on the card: ``"wgmma"`` for
    bf16 at a tensor-core head dim with every row of q, k, v and o 16-byte
    aligned (``aligned``) and more than ``DECODE_ROWS`` queries,
    ``"decode"`` for the same with at most ``DECODE_ROWS``, ``"scalar"``
    for anything else (fp32, head dim 24, unaligned views, no keys).  The
    GQA shape (H, K) takes every form."""
    if (dtype != torch.bfloat16 or D not in WGMMA_HEAD_DIMS or not aligned
            or T < 1):
        return "scalar"
    return "decode" if S <= DECODE_ROWS else "wgmma"


def _items(n_tiles: int, span) -> torch.Tensor:
    """Rows (tile, first tile, tiles) for tiles 0 .. n_tiles - 1, where
    ``span(tile)`` is the half-open range [lo, hi) of indices on the other
    side that see the tile; heaviest first, ties in tile order."""
    rows = []
    for j in range(n_tiles):
        lo, hi = span(j)
        n = -(-hi // BWD_TILE) - lo // BWD_TILE if hi > lo else 0
        rows.append((j, lo // BWD_TILE if n else 0, n))
    rows.sort(key=lambda r: -r[2])
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=256)
def backward_plan(B: int, S: int, T: int, H: int, K: int, D: int,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> BackwardPlan:
    """The launch plan of the backward at one shape (see BackwardPlan).
    Query i sits at position q_offset + i and sees key t when t < T, t <=
    q_offset + i (causal) and q_offset + i - t < window (window > 0): the
    forward's masks, so key tile j is seen by queries [lo, hi) and query
    tile i sees keys [lo, hi), each an interval.  The kernels mask single
    elements only on the tiles that cross the diagonal, a window's edge or
    T.  Raises as ``backward_variant`` does."""
    group = H // K
    variant = backward_variant(D, group)
    tile = BWD_TILE

    def queries_of(j):              # the queries that see key tile j
        k0, k_last = j * tile, min(j * tile + tile, T) - 1
        lo = max(0, k0 - q_offset) if causal else 0
        hi = min(S, k_last + window - q_offset) if window > 0 else S
        return lo, hi

    def keys_of(i):                 # the keys query tile i sees
        p0 = i * tile + q_offset
        p_last = min(i * tile + tile, S) - 1 + q_offset
        lo = max(0, p0 - window + 1) if window > 0 else 0
        hi = min(T, p_last + 1) if causal else T
        return lo, hi

    dkdv = _items(-(-T // tile), queries_of)
    dq = _items(-(-S // tile), keys_of)
    s_pad = -(-S // tile) * tile
    return BackwardPlan(
        variant=variant, cluster=group,
        grid_dkdv=(H, B, len(dkdv)), grid_dq=(H, B, len(dq)),
        grid_preprocess=(-(-B * H * s_pad // 8),),
        dkdv_items=dkdv, dq_items=dq, s_pad=s_pad)


@functools.lru_cache(maxsize=256)
def _device_items(plan: BackwardPlan, device: torch.device):
    """The plan's work lists on the card, copied once per plan."""
    return (plan.dkdv_items.to(device), plan.dq_items.to(device))


def backward_scratch(B: int, H: int, S: int, device) -> torch.Tensor:
    """The backward's fp32 scratch: lse in log2 units and Di = rowsum(dO o
    O), each (B, H, S) with S padded to a whole tile."""
    s_pad = -(-S // BWD_TILE) * BWD_TILE
    return torch.empty((2, B, H, s_pad), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [ptr] * 4 + [i32] * 7 + [i64] * 12
        + [ctypes.c_float, i32, i32, i32, ptr, i32, ptr])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_bwd.argtypes = (
        [ptr] * 10 + [i32] * 6 + [i64] * 24
        + [ctypes.c_float, i32, i32, i32, i32, ptr, i32, ptr, i32, i32, ptr])
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_attributes.argtypes = [i32, i32, i32,
                                                   ctypes.POINTER(i32)]
    lib.flash_attention_bwd_attributes.restype = ctypes.c_int
    lib.flash_attention_fwd_attributes.argtypes = [i32, i32, i32,
                                                   ctypes.POINTER(i32)]
    lib.flash_attention_fwd_attributes.restype = ctypes.c_int
    return lib


def forward_attributes(variant: str, D: int, lse: bool = False) -> dict:
    """What the forward kernel of a tensor-core ``variant`` at head dim D
    (``lse``: the one that writes lse) asks of a multiprocessor, as
    ``backward_attributes`` reads it."""
    vals = (ctypes.c_int * 5)()
    err = _library().flash_attention_fwd_attributes(
        FORWARD_VARIANTS[variant], D, int(lse), vals)
    if err:
        raise RuntimeError(f"flash_attention: attributes of the {variant} "
                           f"forward at D {D}: CUDA error {err}")
    return dict(registers=vals[0], static_smem=vals[1], dynamic_smem=vals[2],
                local_bytes=vals[3], resident_blocks=vals[4])


def backward_attributes(D: int, group: int = 1) -> dict:
    """What each backward kernel at head dim D asks of a multiprocessor,
    from ``cudaFuncGetAttributes`` on the card: registers a thread at
    launch, static and dynamic shared memory, local memory a thread, and
    how many of its blocks the card holds at once (the dK / dV pass
    launched in clusters of ``group``)."""
    lib = _library()
    out = {}
    for name, pass_ in (("preprocess", 1), ("dkdv", 2), ("dq", 4)):
        vals = (ctypes.c_int * 5)()
        err = lib.flash_attention_bwd_attributes(pass_, D, group, vals)
        if err:
            raise RuntimeError(f"flash_attention backward: attributes of "
                               f"pass {pass_} at D {D}: CUDA error {err}")
        out[name] = dict(registers=vals[0], static_smem=vals[1],
                         dynamic_smem=vals[2], local_bytes=vals[3],
                         resident_blocks=vals[4])
    return out


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
    s = t.stride()
    return (t.data_ptr() % 16 == 0 and s[0] % 8 == 0 and s[1] % 8 == 0
            and s[2] % 8 == 0)


def _check_backward(q, k, v):
    """What the backward kernels take: bf16, a head dim that is a
    multiple of 16, rows 16-byte aligned, and a GQA group a cluster
    holds.  Raises NotImplementedError naming the case
    otherwise (nothing falls back to the plain twin)."""
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
    backward_variant(D, q.shape[2] // k.shape[2])


def _forward_kernel(q, k, v, causal, window, q_offset, scale, lse=None):
    """Launch the forward kernel ``forward_variant`` names; ``lse`` (fp32
    (B,H,S)) receives each row's logsumexp when given.  Returns o
    (contiguous, q's type)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    # o, new and contiguous, has aligned rows at every tensor-core head dim
    aligned = (q.dtype == torch.bfloat16 and _aligned16(q) and _aligned16(k)
               and _aligned16(v))
    variant = forward_variant(S, T, H, K, D, q.dtype, aligned)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, T, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], scale, int(causal), int(window),
            int(q_offset), None if lse is None else lse.data_ptr(),
            FORWARD_VARIANTS[variant], stream)
    if err == -3:
        raise RuntimeError("flash_attention: a TMA tensor map of q, k or v "
                           "could not be encoded")
    if err:
        raise RuntimeError(f"flash_attention: {variant} kernel launch "
                           f"failed with CUDA error {err}")
    with _count_lock:
        flash_attention.launches += 1
        flash_attention.launches_by_variant[variant] += 1
    return out


def backward_kernel(q, k, v, o, lse, do, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None, which: int = 7,
                    scratch=None, grads=None):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv), new
    contiguous bf16 tensors.  ``which`` (7: all three) and the optional
    ``scratch`` (``backward_scratch``) and ``grads`` outputs let a timing
    harness run one pass alone on buffers made once; the Function uses the
    defaults.  Counts no launch."""
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
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    plan = backward_plan(B, S, T, H, K, D, bool(causal), int(window),
                         int(q_offset))
    if scratch is None:
        scratch = backward_scratch(B, H, S, q.device)
    dkdv_items, dq_items = _device_items(plan, q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, T, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], scale, int(causal),
            int(window), int(q_offset), int(which), dkdv_items.data_ptr(),
            len(plan.dkdv_items), dq_items.data_ptr(), len(plan.dq_items),
            plan.cluster, stream)
    if err == -2:
        raise NotImplementedError(
            f"flash_attention backward: no thread-block cluster of "
            f"{plan.cluster} blocks (the GQA group) fits the card at head "
            f"dim {D}")
    if err:
        raise RuntimeError(f"flash_attention backward: kernel launch "
                           f"failed with error {err}")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the kernels on CUDA tensors, the
    plain twins on CPU tensors (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  scale=scale)
        ctx.kw_mask = dict(causal=causal, window=window, q_offset=q_offset)
        if q.device.type == "cpu":
            out, lse = flash_attention_plain_lse(q, k, v, **kw)
            out = out.contiguous()
        elif q.device.type == "meta":
            out, lse = _meta_forward(q)
        else:
            _check(q, k, v)
            _check_backward(q, k, v)
            B, S, H, _ = q.shape
            lse = torch.empty((B, H, S), dtype=torch.float32,
                              device=q.device)
            out = _forward_kernel(q, k, v, causal, window, q_offset, scale,
                                  lse)
        _counter.keep(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        B, S, H, D = q.shape
        T, K = k.shape[1], k.shape[2]
        with _counter.region(
                "flash_attention_backward",
                lambda: costs.flash_backward(B, S, T, H, K, D,
                                             elem=q.element_size(),
                                             **ctx.kw_mask),
                scratch=8 * B * H * (-(-S // BWD_TILE) * BWD_TILE)):
            if q.device.type == "cpu":
                # contiguous, as the kernels write them
                grads = tuple(g.contiguous() for g in
                              flash_attention_backward_plain(
                                  q, k, v, out, lse, do, **ctx.kw))
            elif q.device.type == "meta":
                grads = tuple(torch.empty_like(
                    t, memory_format=torch.contiguous_format)
                    for t in (q, k, v))
            else:
                grads = backward_kernel(q, k, v, out, lse, do, **ctx.kw)
                with _count_lock:
                    flash_attention.backward_launches += 1
            _counter.keep(*grads)
        return (*grads, None, None, None, None)


def _device_ok(t) -> bool:
    """A device with a route: the CPU, the card, or meta while a counter
    counts."""
    return t.device.type in ("cpu", "cuda") or (
        t.device.type == "meta" and _counter.active() is not None)


def _meta_forward(q):
    """The forward's shape function: o (contiguous, q's type) and lse
    (B, H, S) fp32, empty."""
    B, S, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty((B, H, S), dtype=torch.float32, device=q.device))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """q: (B,S,H,D); k, v: (B,T,K,D), H % K == 0.  Returns (B,S,H,D) in
    q's type.  Query i sits at absolute position ``q_offset + i``."""
    if not _device_ok(q):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                     scale)
    if q.device.type == "meta":
        return _meta_forward(q)[0]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    _check(q, k, v)
    return _forward_kernel(q, k, v, causal, window, q_offset, scale)


def flash_attention_partial(q, k, v, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            scale: Optional[float] = None):
    """``flash_attention`` over one block of the keys, left for
    ``ops.combine_partial`` to finish, as ``ref.mha_partial`` gives it:
    (out (B,S,H,D) fp32, lse (B,S,H) fp32), out this block's softmax
    applied to its V (rounded to q's type by the kernel) and lse the
    logsumexp of each row's scaled visible scores, -inf for a row that
    sees none.  On CUDA tensors the forward kernel writes both; on CPU
    tensors the plain twin ``flash_attention_plain_lse``.  No gradient:
    decode only."""
    if not _device_ok(q):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention_partial has no backward "
                                  "(decode only)")
    if q.device.type == "cpu":
        out, lse = flash_attention_plain_lse(q, k, v, causal=causal,
                                             window=window,
                                             q_offset=q_offset, scale=scale)
    elif q.device.type == "meta":
        out, lse = _meta_forward(q)
    else:
        _check(q, k, v)
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _forward_kernel(q, k, v, causal, window, q_offset, scale, lse)
    return out.float(), lse.float().transpose(1, 2)


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(FORWARD_VARIANTS, 0)
flash_attention.backward_launches = 0
