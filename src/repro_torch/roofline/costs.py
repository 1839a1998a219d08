"""The work of each hand-written kernel: the FLOPs and bytes the function
needs for its inputs, whatever implements it.

Each function returns ``(flops, bytes)``: the bytes are each input read
once and each output written once, the FLOPs the arithmetic the function
needs (a multiply-add counts 2).  ``bound`` turns a pair into the least time an H100
could take for it (``analysis``' peaks).  Where the work depends on the
masks (attention) it is the work this call's masks leave, in closed form,
so a 500k-token cell costs no more to count than a short one.

The kernel regions of ``counter.py`` add these under the kernel's name,
so a step counts the same work on the meta device, on the CPU (the plain
twins) and on the card (the kernels); ``chip_smoke.py``'s kernel rows
take their ``flops``, ``bytes`` and ``bound_ms`` from here too.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.roofline.analysis import PEAK_BYTES, PEAK_FLOPS

Cost = Tuple[float, float]


def _series(a: int, b: int) -> int:
    """a + (a + 1) + ... + (b - 1); 0 when b <= a."""
    return (a + b - 1) * (b - a) // 2 if b > a else 0


def visible_pairs(S: int, T: int, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> int:
    """Visible (query, key) pairs of one (batch, head): query i sits at
    position p = q_offset + i and sees keys [lo, hi), hi = min(T, p + 1)
    if causal else T, lo = max(0, p - window + 1) if window > 0 else 0.
    Summed in closed form over the pieces where hi - lo is linear in p."""
    a0, a1 = q_offset, q_offset + S
    cuts = {a0, a1}
    if causal:
        cuts.add(T)
    if window > 0:
        cuts.add(window)
    edges = sorted(c for c in cuts if a0 <= c <= a1)
    total = 0
    for u, v in zip(edges, edges[1:]):
        A = B = 0
        if causal and u < T:
            A, B = 1, 1                      # hi = p + 1
        else:
            A = T                            # hi = T
        if window > 0 and u >= window:
            A, B = A + window - 1, B - 1     # lo = p - window + 1
        if B == 0:
            total += (v - u) * max(0, A)
        elif B == 1:                         # A + p > 0 for p >= 1 - A
            lo = max(u, 1 - A)
            total += (v - lo) * A + _series(lo, v) if lo < v else 0
        else:                                # A - p > 0 for p < A
            hi = min(v, A)
            total += (hi - u) * A - _series(u, hi) if u < hi else 0
    return total


def flash_forward(B: int, S: int, T: int, H: int, K: int, D: int, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  elem: int = 2) -> Cost:
    """Attention's forward: two products of 2 FLOPs a visible pair and
    head dim; q, k, v read and o written, in ``elem``-byte elements."""
    pairs = visible_pairs(S, T, causal, window, q_offset)
    return (4.0 * B * H * D * pairs,
            float(elem * (2 * B * S * H * D + 2 * B * T * K * D)))


def flash_partial(B: int, S: int, T: int, H: int, K: int, D: int, *,
                  causal: bool = False, window: int = 0,
                  elem: int = 2) -> Cost:
    """The forward over one block of the keys writing its fp32 lse too
    (``flash_attention_partial``)."""
    flops, nbytes = flash_forward(B, S, T, H, K, D, causal=causal,
                                  window=window, elem=elem)
    return flops, nbytes + 4.0 * B * S * H


def flash_backward(B: int, S: int, T: int, H: int, K: int, D: int, *,
                   causal: bool = True, window: int = 0, q_offset: int = 0,
                   elem: int = 2) -> Cost:
    """Attention's backward from the saved o and lse: five products of 2
    FLOPs a visible pair and head dim (S and dP recomputed, dV, dQ, dK);
    q, o, dO read and dQ written, k, v read and dK, dV written, lse
    read."""
    pairs = visible_pairs(S, T, causal, window, q_offset)
    return (10.0 * B * H * D * pairs,
            float(elem * (4 * B * S * H * D + 4 * B * T * K * D)
                  + 4 * B * H * S))


def rmsnorm(rows: int, d: int, *, elem: int = 2,
            scale_elem: int = 4) -> Cost:
    """x read and y written, the (d,) scale read once; 4 FLOPs an element
    (square, sum, scale twice)."""
    return 4.0 * rows * d, float(2 * rows * d * elem + d * scale_elem)


def rmsnorm_backward(rows: int, d: int, *, elem: int = 2,
                     scale_elem: int = 4) -> Cost:
    """The closed-form gradient (``rmsnorm.rmsnorm_backward``): x and dy
    read, dx written, the scale read and its gradient written; 12 FLOPs
    an element (the norm again, u = dy scale, mean(u x), dx, and dy x r
    summed into dscale)."""
    return (12.0 * rows * d,
            float(3 * rows * d * elem + 2 * d * scale_elem))


def rmsnorm_residual(rows: int, d: int, *, elem: int = 2,
                     scale_elem: int = 4) -> Cost:
    """x and the residual read, y and h written; the add and the norm."""
    return 5.0 * rows * d, float(4 * rows * d * elem + d * scale_elem)


def row_sumsq(rows: int, d: int, *, elem: int = 2) -> Cost:
    """Each row's fp32 sum of squares: x read, one float a row written."""
    return 2.0 * rows * d, float(rows * d * elem + 4 * rows)


def rmsnorm_total(rows: int, d: int, *, elem: int = 2,
                  scale_elem: int = 4) -> Cost:
    """x * rsqrt(total / d_full + eps) * scale: x and the rows' totals
    read, y written, the scale's columns read once."""
    return (3.0 * rows * d,
            float(2 * rows * d * elem + d * scale_elem + 4 * rows))


def ssd_scan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int, *,
             elem: int = 2, state: bool = False) -> Cost:
    """The chunked SSD scan over the ``s`` positions it is given, in chunks
    of ``chunk`` and a last partial one (per chunk of c positions: the
    causal triangle of C B^T and its product with x dt, c (c + 1) / 2
    pairs of 2 (n + p) each, and the two state products), and the bytes of
    x, dt, A, B, C and y (dt and A fp32), with ``state`` the fp32 final
    state written too.  The padding a wrapper adds is its own choice, not
    work the function needs, so it is not counted."""
    def per_chunk(c):
        return 2 * (c * (c + 1) // 2) * (n + p) + 4 * c * n * p

    flops = float(b * h * ((s // chunk) * per_chunk(chunk)
                           + per_chunk(s % chunk)))
    nbytes = float(elem * (2 * b * s * h * p + 2 * b * s * g * n)
                   + 4 * (b * s * h + h))
    if state:
        nbytes += 4.0 * b * h * p * n
    return flops, nbytes


def ssd_scan_backward(b: int, s: int, h: int, p: int, g: int, n: int,
                      chunk: int, *, elem: int = 2) -> Cost:
    """The SSD scan's gradient (``ref.ssd_chunked_backward``) over the
    ``s`` positions it is given, stated as ``ssd_scan``: per chunk of c
    positions, over the c (c + 1) / 2 causal pairs, for each head G = dy
    u^T and (C B^T o L)^T dy (2p each), and for each group, whose heads
    share B and C, C B^T, dCB B and dCB^T C (2n each: dC and dB are sums
    over the group's heads, so the products run once on the heads' summed
    dCB); and per head five state products of 2 c n p (the entering
    states again, the d-state, dy in_z, B dS^T and u dS); the bytes of x,
    dt, A, B, C and dy read and dx, ddt, dA, dB and dC written (dt, A and
    their gradients fp32)."""
    def per_head(c):
        return 2 * (c * (c + 1) // 2) * 2 * p + 10 * c * n * p

    def per_group(c):
        return 2 * (c * (c + 1) // 2) * 3 * n

    def over_chunks(f):
        return (s // chunk) * f(chunk) + f(s % chunk)

    flops = float(b * (h * over_chunks(per_head) + g * over_chunks(per_group)))
    nbytes = float(elem * (3 * b * s * h * p + 4 * b * s * g * n)
                   + 4 * (2 * b * s * h + 2 * h))
    return flops, nbytes


def bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time in ms an H100 takes for the work, the larger of the
    bytes over HBM's rate and the FLOPs over the peak of ``dtype``
    (``"bfloat16"`` on the tensor cores, ``"float32"`` outside them), and
    which of the two it is (``"operations"`` or ``"bytes"``)."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")
