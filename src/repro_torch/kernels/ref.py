"""Plain PyTorch versions of the attention, norm and SSD kernels.

Each function computes what the JAX package's ``repro.kernels.ref`` computes
(same masks, fp32 softmax and reductions, output in the input's type).  They
are the CPU path of ``ops.py`` and the twins the hand-written kernels are
held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(q_pos, kv_pos, *, causal: bool, window: int,
                   kv_valid: Optional[torch.Tensor] = None,
                   num_sink: int = 0):
    """Boolean mask (B, S, T): True = attend.

    q_pos: (B,S) absolute query positions; kv_pos: (B,T) key positions
    (negative = slot not written yet); kv_valid: (B,) number of valid cache
    slots (decode), or None.  Positions < num_sink stay visible through a
    sliding window (attention sinks)."""
    m = kv_pos[:, None, :] >= 0
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        in_window = q_pos[:, :, None] - kv_pos[:, None, :] < window
        if num_sink > 0:
            in_window = in_window | (kv_pos[:, None, :] < num_sink)
        m = m & in_window
    if kv_valid is not None:
        m = m & (kv_pos[:, None, :] < kv_valid[:, None, None])
    return m


def mha(q, k, v, *, causal: bool = True, window: int = 0,
        q_pos=None, kv_pos=None, kv_valid=None, softcap: float = 0.0,
        scale: Optional[float] = None, num_sink: int = 0):
    """GQA attention.  q: (B,S,H,D); k, v: (B,T,K,D) with H % K == 0."""
    B, S, H, D = q.shape
    _, T, K, _ = k.shape
    if H % K:
        raise ValueError(f"num heads {H} not a multiple of kv heads {K}")
    G = H // K
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(S, device=dev)[None, :].expand(B, S)
    if kv_pos is None:
        kv_pos = torch.arange(T, device=dev)[None, :].expand(B, T)
    scale = scale if scale is not None else D ** -0.5

    qg = q.reshape(B, S, K, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window,
                          kv_valid=kv_valid, num_sink=num_sink)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # fully masked rows (padding) give zeros, not a uniform average
    any_valid = mask.any(-1)[:, None, None, :, None]
    probs = probs.masked_fill(~any_valid, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def mha_partial(q, k, v, *, causal: bool = True, window: int = 0,
                q_pos=None, kv_pos=None, kv_valid=None, softcap: float = 0.0,
                scale: Optional[float] = None, num_sink: int = 0):
    """``mha`` over one block of the keys, left for ``combine_partial`` to
    finish: (out (B,S,H,D) fp32, lse (B,S,H) fp32), out the softmax over
    the block's visible keys applied to its V and lse the log of the sum
    of their exponentials.  A row that sees no key of the block gives out
    0 and lse -inf."""
    B, S, H, D = q.shape
    _, T, K, _ = k.shape
    if H % K:
        raise ValueError(f"num heads {H} not a multiple of kv heads {K}")
    G = H // K
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(S, device=dev)[None, :].expand(B, S)
    if kv_pos is None:
        kv_pos = torch.arange(T, device=dev)[None, :].expand(B, T)
    scale = scale if scale is not None else D ** -0.5

    qg = q.reshape(B, S, K, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window,
                          kv_valid=kv_valid, num_sink=num_sink)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    any_valid = mask.any(-1)[:, None, None, :]                 # (B,1,1,S)
    lse = torch.logsumexp(logits, dim=-1).masked_fill(~any_valid,
                                                      float("-inf"))
    probs = torch.softmax(logits, dim=-1).masked_fill(~any_valid[..., None],
                                                      0.0)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D), lse.permute(0, 3, 1, 2).reshape(B, S, H)


def combine_partial(out, lse, gather):
    """``mha``'s result (fp32) from the blocks' ``mha_partial`` results,
    one block a rank: ``gather`` stacks every rank's (out, lse) along a
    new leading dim in rank order; with m the max of the lse over the
    ranks, the sum of exp(lse - m) * out over the sum of exp(lse - m).  A
    block that sees no key has weight exp(-inf) = 0 and adds exactly 0; a
    row no block sees is 0, as in ``mha``.  Every rank computes the same
    sums in the same order, so every rank gets the same bits."""
    packed = gather(torch.cat([out, lse[..., None]], dim=-1))
    outs, lses = packed[..., :-1], packed[..., -1:]
    m = lses.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lses - m)
    num, den = (w * outs).sum(0), w.sum(0)
    # den is 0 (no block saw a key: num is 0 too) or at least 1 (the block
    # holding the max adds exp(0))
    return num / den.clamp_min(1.0)


def mha_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                num_sink: int = 0, scale: Optional[float] = None,
                block_q: int = 512):
    """Exact attention over query blocks: peak memory O(block_q * T)
    instead of O(S * T).  Same math and masks as ``mha``."""
    B, S, H, D = q.shape
    _, T, K, _ = k.shape
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(T, device=dev)
    outs = []
    for start in range(0, S, block_q):
        qblk = q[:, start:start + block_q]
        bq = qblk.shape[1]
        qf = qblk.reshape(B, bq, K, G, D).float()
        logits = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
        q_pos = start + torch.arange(bq, device=dev)
        m = torch.ones((bq, T), dtype=torch.bool, device=dev)
        if causal:
            m = m & (kv_pos[None, :] <= q_pos[:, None])
        if window > 0:
            in_w = q_pos[:, None] - kv_pos[None, :] < window
            if num_sink > 0:
                in_w = in_w | (kv_pos[None, :] < num_sink)
            m = m & in_w
        logits = logits.masked_fill(~m, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        probs = probs.masked_fill(~m.any(-1)[:, None], 0.0)
        ob = torch.einsum("bkgst,btkd->bskgd", probs, vf)
        outs.append(ob.reshape(B, bq, H, D).to(q.dtype))
    return torch.cat(outs, dim=1)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x * rsqrt(mean(x²) + eps) * scale per row, in fp32, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def row_sumsq(x):
    """Each row's sum of squares in fp32: x (..., d) -> (...,)."""
    xf = x.float()
    return (xf * xf).sum(-1)


def rmsnorm_total(x, scale, total, d_full: int, eps: float = 1e-6):
    """A part of each row normed by the whole row's sum of squares
    ``total`` (x's leading shape, fp32) over ``d_full`` elements:
    x * rsqrt(total / d_full + eps) * scale, in fp32, cast back."""
    r = torch.rsqrt(total.float() / d_full + eps)[..., None]
    return (x.float() * r * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# mamba2 SSD (state-space duality) scan
# --------------------------------------------------------------------------
def ssd_naive(x, dt, A, B, C, *, initial_state=None):
    """Sequential recurrence, the ground truth the chunked forms match.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) (negative); B, C: (b, s, g, n)
    with h % g == 0.  Returns (y (b, s, h, p) in x's type, final state
    (b, h, p, n) fp32).  Its decay ``exp(dt * A)`` is at most 1, so its
    gradient is finite at any chunk length."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2).float()          # (b,s,h,n)
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A.float()[None, None, :])     # (b,s,h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _chunked(t, chunk):
    """(b, s, ...) -> (b, s // chunk, chunk, ...) in fp32."""
    b, s = t.shape[:2]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    return t.float().reshape(b, s // chunk, chunk, *t.shape[2:])


def _per_head(M, h):
    """B or C (b, s, g, n) -> (b, s, h, n): head h reads group h // (h/g)."""
    return M.repeat_interleave(h // M.shape[2], dim=2)


def ssd_chunk_state(x, dt, A, B, *, chunk: int):
    """Stage 1 of the chunked scan, per chunk z: ``cum``, the inclusive
    cumsum of dt * A over the chunk, and the chunk's own addition to the
    state, ``S_z = (x o dt exp(total - cum))^T B`` with total = cum[-1].

    Returns (cum (b, h, chunks, chunk), S (b, h, chunks, p, n)), both fp32:
    the layouts of the kernel's scratch."""
    h = x.shape[2]
    xf, dtf = _chunked(x, chunk), _chunked(dt, chunk)     # (b,z,c,h[,p])
    Bh = _chunked(_per_head(B, h), chunk)                  # (b,z,c,h,n)
    cum = torch.cumsum(dtf * A.float()[None, None, None, :], dim=2)
    tail = torch.exp(cum[:, :, -1:, :] - cum)              # (b,z,c,h)
    states = torch.einsum("bzjhn,bzjhp->bhzpn", Bh * tail[..., None],
                          xf * dtf[..., None])
    return cum.permute(0, 3, 1, 2), states


def ssd_state_passing(states, cum, *, initial_state=None):
    """Stage 2: the state entering each chunk, in chunk order:
    ``in_0 = initial`` (0 by default) and
    ``in_z = in_{z-1} exp(total_{z-1}) + S_{z-1}``.

    states: (b, h, chunks, p, n) from stage 1; cum: (b, h, chunks, chunk).
    Returns (in (b, h, chunks, p, n), final state (b, h, p, n)), fp32."""
    b, h, nc, p, n = states.shape
    decay = torch.exp(cum[..., -1])                        # (b,h,z)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=states.device)
             if initial_state is None else initial_state.float())
    entering = []
    for z in range(nc):
        entering.append(state)
        state = state * decay[:, :, z, None, None] + states[:, :, z]
    return torch.stack(entering, dim=2), state


def ssd_state_split(entering):
    """The fp32 states entering each chunk (b, h, chunks, p, n) as the
    wgmma chunk scan reads them: bf16 pairs (b, h, chunks, p, 2, n), hi
    the state rounded to bf16 and lo what hi leaves over, rounded to bf16,
    so hi + lo carries ~16 of fp32's mantissa bits."""
    hi = entering.to(torch.bfloat16)
    lo = (entering - hi.float()).to(torch.bfloat16)
    return torch.stack((hi, lo), dim=-2)


def ssd_state_join(pairs):
    """``ssd_state_split``'s pairs back as fp32 states, hi + lo."""
    return pairs[..., 0, :].float() + pairs[..., 1, :].float()


def ssd_chunk_scan(x, dt, B, C, cum, entering, *, chunk: int):
    """Stage 3: y_i = exp(cum_i) C_i in_z^T
    + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j within each chunk.

    The causal mask is applied *before* the exp, as
    ``exp(where(j <= i, cum_i - cum_j, -inf))``: for j > i the difference
    is positive and, with real dt over a chunk of 256, large enough for exp
    to overflow fp32; masking after the exp (as
    ``repro.kernels.ref.ssd_chunked`` does) gives the same forward but sends
    ``0 * inf = NaN`` into the gradient.  Returns y (b, s, h, p) in x's
    type."""
    b, s, h, p = x.shape
    xf, dtf = _chunked(x, chunk), _chunked(dt, chunk)
    Bh = _chunked(_per_head(B, h), chunk)
    Ch = _chunked(_per_head(C, h), chunk)
    cum = cum.permute(0, 2, 3, 1)                          # (b,z,c,h)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,z,i,j,h)
    L = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                   float("-inf")))
    scores = torch.einsum("bzihn,bzjhn->bzijh", Ch, Bh) * L
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", scores, xf * dtf[..., None])
    y_inter = torch.einsum("bzihn,bhzpn->bzihp",
                           Ch * torch.exp(cum)[..., None], entering)
    return (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype)


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 64, initial_state=None):
    """Chunked SSD, the parallel form the kernel implements; same shapes and
    result as ``ssd_naive`` (up to fp error): the three stages of the Mamba2
    paper's chunked algorithm (arXiv:2405.21060), ``ssd_chunk_state`` ->
    ``ssd_state_passing`` -> ``ssd_chunk_scan``.  Returns (y in x's type,
    final state (b, h, p, n) fp32)."""
    cum, states = ssd_chunk_state(x, dt, A, B, chunk=chunk)
    entering, state = ssd_state_passing(states, cum,
                                        initial_state=initial_state)
    return ssd_chunk_scan(x, dt, B, C, cum, entering, chunk=chunk), state


# --------------------------------------------------------------------------
# the SSD scan's backward in closed form, staged as its kernels are
# --------------------------------------------------------------------------
# Per (b, h) and chunk z, with cum the in-chunk inclusive cumsum of dt A,
# total = cum[-1], u = x dt, in_z the state entering the chunk and
# L_ij = exp(cum_i - cum_j) for j <= i (masked before the exp):
#   y_i      = sum_j (C_i . B_j) L_ij u_j + exp(cum_i) in_z C_i
#   in_{z+1} = exp(total) in_z + sum_j exp(total - cum_j) u_j (x) B_j
# The backward walks the chunks in reverse for dS_z, the gradient of
# in_{z+1}, then differentiates each chunk on its own, then each chunk's
# cumsum.

def ssd_state_passing_bwd(dy, C, cum, *, chunk: int):
    """The d-state stage, in reverse chunk order: ``dS_z``, the gradient
    reaching the state after chunk z, is d in_{z+1}: dS_{last} = 0 and
    ``d in_z = exp(total_z) d in_{z+1} + sum_i exp(cum_i) dy_i (x) C_i``.

    dy: (b, s, h, p); C: (b, s, g, n); cum: (b, h, chunks, chunk).
    Returns dS (b, h, chunks, p, n) fp32."""
    h = dy.shape[2]
    dyf = _chunked(dy, chunk)                              # (b,z,c,h,p)
    Ch = _chunked(_per_head(C, h), chunk)                  # (b,z,c,h,n)
    cz = cum.permute(0, 2, 3, 1)                           # (b,z,c,h)
    own = torch.einsum("bzihp,bzihn->bhzpn", dyf * torch.exp(cz)[..., None],
                       Ch)
    decay = torch.exp(cum[..., -1])                        # (b,h,z)
    d_in = torch.zeros_like(own[:, :, 0])
    out = []
    for z in range(own.shape[2] - 1, -1, -1):
        out.append(d_in)
        d_in = d_in * decay[:, :, z, None, None] + own[:, :, z]
    return torch.stack(out[::-1], dim=2)


def ssd_chunk_bwd(x, dt, B, C, dy, cum, entering, dS, *, chunk: int):
    """The chunk stage: each chunk's gradients from its entering state and
    its ``dS_z`` (``ssd_state_passing_bwd``).  With CB = C B^T,
    G = dy u^T, dCB = G o L and M = dCB o CB:

    * du = (CB o L)^T dy + exp(total - cum) o (B dS^T); dx = du dt, and
      dt's direct part du . x;
    * dC = dCB B + exp(cum) o (dy in_z); dB = dCB^T C + exp(total - cum)
      o (u dS), each summed over the heads of a group;
    * d cum = rowsum(M) - colsum(M) + C . (exp(cum) dy in_z)
      - B . (exp(total - cum) u dS), and d total (added to the last row)
      = sum_j B_j . (exp(total - cum_j) u_j dS) + exp(total) <in_z, dS>.

    x, dy: (b, s, h, p); dt: (b, s, h); B, C: (b, s, g, n); cum: (b, h,
    chunks, chunk); entering, dS: (b, h, chunks, p, n).  Returns (dx (b,
    s, h, p), ddt's direct part (b, s, h), dB, dC (b, s, g, n), d cum (b,
    h, chunks, chunk)), all fp32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    xf, dtf, dyf = _chunked(x, chunk), _chunked(dt, chunk), _chunked(dy,
                                                                     chunk)
    Bh = _chunked(_per_head(B, h), chunk)                  # (b,z,c,h,n)
    Ch = _chunked(_per_head(C, h), chunk)
    u = xf * dtf[..., None]
    cz = cum.permute(0, 2, 3, 1)                           # (b,z,c,h)
    total = cz[:, :, -1:, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    diff = cz[:, :, :, None, :] - cz[:, :, None, :, :]     # (b,z,i,j,h)
    L = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                   float("-inf")))
    CB = torch.einsum("bzihn,bzjhn->bzijh", Ch, Bh)
    dCB = torch.einsum("bzihp,bzjhp->bzijh", dyf, u) * L
    M = dCB * CB
    w = torch.exp(total - cz)                              # (b,z,c,h)
    du = (torch.einsum("bzijh,bzihp->bzjhp", CB * L, dyf)
          + w[..., None] * torch.einsum("bzjhn,bhzpn->bzjhp", Bh, dS))
    dB_state = w[..., None] * torch.einsum("bzjhp,bhzpn->bzjhn", u, dS)
    dC_inter = torch.exp(cz)[..., None] * torch.einsum(
        "bzihp,bhzpn->bzihn", dyf, entering)
    dCh = torch.einsum("bzijh,bzjhn->bzihn", dCB, Bh) + dC_inter
    dBh = torch.einsum("bzijh,bzihn->bzjhn", dCB, Ch) + dB_state
    b_state = (Bh * dB_state).sum(-1)                      # (b,z,c,h)
    dcum = (M.sum(3) - M.sum(2) + (Ch * dC_inter).sum(-1) - b_state)
    passing = torch.exp(total[:, :, 0]) * torch.einsum(
        "bhzpn,bhzpn->bzh", entering, dS)
    dcum[:, :, -1] += b_state.sum(2) + passing
    dx = (du * dtf[..., None]).reshape(b, s, h, p)
    ddt = (du * xf).sum(-1).reshape(b, s, h)

    def group_sum(t):                                      # heads -> groups
        return t.reshape(b, s, g, h // g, n).sum(3)

    return (dx, ddt, group_sum(dBh.reshape(b, s, h, n)),
            group_sum(dCh.reshape(b, s, h, n)), dcum.permute(0, 3, 1, 2))


def ssd_cum_bwd(dcum, dt, A, *, chunk: int):
    """The cumsum stage: d a, the in-chunk reverse cumsum of d cum, for
    a = dt A: returns (ddt's part A d a (b, s, h), dA = sum dt d a (h,)),
    fp32.  dcum: (b, h, chunks, chunk)."""
    b, s, h = dt.shape
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    da = da.permute(0, 2, 3, 1).reshape(b, s, h)
    return da * A.float(), (da * dt.float()).sum((0, 1))


def ssd_chunked_backward(x, dt, A, B, C, dy, *, chunk: int):
    """Gradients of ``sum(y * dy)`` of ``ssd_chunked`` (zero initial state)
    for x, dt, A, B and C, in closed form through the three stages: the
    entering states (``ssd_chunk_state``, ``ssd_state_passing``), then
    ``ssd_state_passing_bwd``, ``ssd_chunk_bwd`` and ``ssd_cum_bwd``.  A
    sequence that is not a multiple of the chunk is padded with zeros (dt
    0), the arithmetic of the kernels' ragged end, and its gradients cut
    back.  Each gradient in its input's type."""
    s = x.shape[1]
    pad = (-s) % chunk
    xp, dtp, Bp, Cp, dyp = x, dt, B, C, dy
    if pad:
        xp, Bp, Cp, dyp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (x, B, C, dy))
        dtp = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    cum, states = ssd_chunk_state(xp, dtp, A, Bp, chunk=chunk)
    entering, _ = ssd_state_passing(states, cum)
    dS = ssd_state_passing_bwd(dyp, Cp, cum, chunk=chunk)
    dx, ddt, dB, dC, dcum = ssd_chunk_bwd(xp, dtp, Bp, Cp, dyp, cum,
                                          entering, dS, chunk=chunk)
    ddt_a, dA = ssd_cum_bwd(dcum, dtp, A, chunk=chunk)
    return (dx[:, :s].to(x.dtype), (ddt + ddt_a)[:, :s].to(dt.dtype),
            dA.to(A.dtype), dB[:, :s].to(B.dtype), dC[:, :s].to(C.dtype))


def ssd_step(state, x, dt, A, B, C):
    """One token of the SSD recurrence (decode).  state: (b, h, p, n) fp32;
    x: (b, h, p); dt: (b, h); A: (h,); B, C: (b, g, n).  Returns (y (b, h,
    p) in x's type, new state (b, h, p, n) fp32)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()            # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1).float()
    dtf = dt.float()
    decay = torch.exp(dtf * A.float()[None, :])
    state = state * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x.float() * dtf[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x.dtype), state
