"""The model axis made explicit: the collectives that GSPMD and
``repro``'s ``shard_map`` bodies insert when work is split over the
``"model"`` mesh axis.

A region of a layer whose work is split over the model ranks (attention
by heads, the MLP by d_ff, the MoE by virtual experts, the unembedding
by vocabulary rows) is entered and left through Megatron's pair of
operators:

* ``to_model``: the identity forward, an all-reduce of the gradient
  backward (a replicated input used by every rank's part);
* ``from_model`` (also ``psum``): an all-reduce forward, the identity
  backward (the ranks' partial outputs summed into a replicated one).

``pmax`` takes no gradient (``repro`` stop-gradients the max it reduces),
nor does ``sum_ranks`` (a split row's statistic, ``ops.rmsnorm_split``);
``gather_from_model`` all-gathers a split last dim; ``ppermute`` passes a
tensor one step along the ring (``collective_matmul``).

Under sequence parallelism (``repro``'s ``seq_res`` rule) the residual
stream between the regions holds this rank's block of the tokens, and the
pair becomes ``gather_seq`` (all-gather the sequence in, reduce-scatter
its gradient) and ``scatter_seq`` (reduce-scatter the partial outputs
into the block, all-gather the gradient).  ``enter`` / ``leave`` pick the
pair for a region from its work split and the stream's sequence split.

``split_for(logical)`` says whether a logical activation axis splits the
work here: under a ``use_rules`` context whose rules map it to exactly one
mesh axis that is not manual and larger than 1, inside the manual region
of the batch axes (the data-parallel step or the serve wrapper), as
``repro`` requires for its explicit paths.  Outside such a region the
port's tensors are whole and every rank computes everything.

Every collective moves its tensors under ``transport``'s backend rule
(over a gloo group a CUDA tensor is staged through host memory).

Every collective issued here adds one to ``collectives`` under its kind:
``all_reduce``, ``all_reduce_max``, ``all_gather``, ``reduce_scatter`` or
``send_recv``; one over a group of one rank is not issued (``transport``)
and counts nowhere.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding_rules import current_ctx
from repro_torch.distributed.transport import (all_gather, all_reduce_,
                                               reduce_scatter, send_recv)

# collectives issued by this module, by kind (read and zeroed by callers)
collectives: collections.Counter = collections.Counter()


# ---- where the work splits --------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """The model-axis split of a region: its mesh axis, the number of
    ranks along it, this rank's index and the axis's process group."""
    axis: str
    size: int
    rank: int
    group: object


def batch_manual(ctx) -> bool:
    """Are the batch axes under manual control (inside the data-parallel
    step's or the serve wrapper's region)?"""
    return all(a in ctx.manual
               for a in ctx.mesh_axes_for("batch", include_manual=True))


def split_for(logical: str) -> Optional[Split]:
    """The split of the work along logical activation axis ``logical``
    (``"heads_act"``, ``"mlp_act"``, ``"experts_virt"``, ``"vocab_act"``),
    or None where every rank computes the whole."""
    ctx = current_ctx()
    if ctx is None or not ctx.manual or not batch_manual(ctx):
        return None
    axes = tuple(a for a in ctx.mesh_axes_for(logical, include_manual=True)
                 if a not in ctx.manual)
    if len(axes) != 1 or ctx.shape[axes[0]] <= 1:
        return None
    a = axes[0]
    return Split(a, ctx.shape[a], ctx.mesh.get_local_rank(a),
                 ctx.mesh.get_group(a))


def ep_enabled() -> bool:
    """``REPRO_MOE_EP=0`` turns the expert-parallel MoE off, as in
    ``repro``."""
    return os.environ.get("REPRO_MOE_EP", "1") != "0"


# ---- the autograd pair and the other collectives ----------------------------

class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_(g, ctx.group, tally=collectives)
        return g, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        all_reduce_(out, group, tally=collectives)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Enter a split region: the identity; the gradient is summed over the
    model ranks."""
    return _ToModel.apply(x, split.group)


def from_model(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Leave a split region: the ranks' partial ``x`` summed; the gradient
    passes to each rank as it is."""
    return _FromModel.apply(x, split.group)


psum = from_model


def pmax(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The elementwise max over the model ranks, without a gradient."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    all_reduce_(out, split.group, op=dist.ReduceOp.MAX, tally=collectives)
    return out


def sum_ranks(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The sum over the model ranks of ``x``, without a gradient: a
    statistic of a row split across the ranks (the gate norm's sum of
    squares), whose own backward sums what it needs again."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    all_reduce_(out, split.group, tally=collectives)
    return out


def _gather_dim(x: torch.Tensor, dim: int, split: Split) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order,
    contiguous (the kernels take contiguous rows)."""
    src = x.movedim(dim, 0).contiguous()
    return all_gather(src, split.group,
                      tally=collectives).movedim(0, dim).contiguous()


def _scatter_dim(x: torch.Tensor, dim: int, split: Split) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over the ranks of ``x``,
    contiguous."""
    src = x.movedim(dim, 0).contiguous()
    return reduce_scatter(src, split.group,
                          tally=collectives).movedim(0, dim).contiguous()


def _own_block(x: torch.Tensor, dim: int, split: Split) -> torch.Tensor:
    n = x.shape[dim] // split.size
    return x.narrow(dim, split.rank * n, n).contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _gather_dim(x, -1, split)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, -1, ctx.split), None


def gather_from_model(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim, in rank order;
    the gradient is this rank's slice of the (replicated) cotangent."""
    return _GatherFromModel.apply(x, split)


def stack_ranks(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading dim, in rank order
    (an all-gather; no gradient)."""
    return _gather_dim(x.detach()[None], 0, split)


# ---- the sequence over the model axis ---------------------------------------

class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, summed):
        ctx.split, ctx.summed = split, summed
        return _gather_dim(x, 1, split)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _scatter_dim(g, 1, ctx.split), None, None
        return _own_block(g, 1, ctx.split), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, summed):
        ctx.split = split
        if summed:
            return _scatter_dim(x, 1, split)
        return _own_block(x, 1, split)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, 1, ctx.split), None, None


def gather_seq(x: torch.Tensor, split: Split, summed: bool = True):
    """The sequence (dim 1) of ``x``, each rank holding a block of it in
    rank order, all-gathered whole.  The gradient: its reduce-scatter
    (``summed``: the ranks used the whole sequence each for a part of the
    work, so their gradients are partial), else this rank's block of it
    (every rank computed the same whole)."""
    return _GatherSeq.apply(x, split, summed)


def scatter_seq(x: torch.Tensor, split: Split, summed: bool = True):
    """This rank's block of the sequence (dim 1) of ``x``: of the sum over
    the ranks' partial ``x`` (``summed``: a reduce-scatter), else of ``x``
    itself (whole and equal on every rank).  The gradient is all-gathered
    back along the sequence."""
    return _ScatterSeq.apply(x, split, summed)


def enter(x: torch.Tensor, split: Optional[Split],
          seq: Optional[Split] = None) -> torch.Tensor:
    """The input of a layer's region whose work is split over ``split``
    (None: computed whole on every rank), from the residual stream ``x``:
    whole, or with ``seq`` (the stream's split of the sequence,
    ``stack.sp_split``) this rank's block of the tokens, gathered whole
    here.  The region's gradients are summed over the ranks once: by
    ``to_model``, or by the gather's reduce-scatter."""
    if seq is not None:
        return gather_seq(x, seq, summed=split is not None)
    return x if split is None else to_model(x, split)


def leave(y: torch.Tensor, split: Optional[Split],
          seq: Optional[Split] = None) -> torch.Tensor:
    """A region's output back on the residual stream: the ranks' partial
    ``y`` summed (``from_model``), or with ``seq`` reduce-scattered into
    this rank's block of the tokens; a whole ``y`` as it is, or its
    block."""
    if seq is not None:
        return scatter_seq(y, seq, summed=split is not None)
    return y if split is None else from_model(y, split)


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank = rank
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.rank == 0 else torch.zeros_like(g)), None


def once(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The identity; the gradient passes on model rank 0 only.  A term
    every rank computes alike, inside a region whose gradients are summed
    over the ranks, then counts once."""
    return _Once.apply(x, split.rank)


class _OwnRowsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        out = torch.zeros_like(g)
        out[ctx.lo:ctx.hi] = g[ctx.lo:ctx.hi]
        return out, None, None


def own_rows_grad(w: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The identity; the gradient keeps rows ``[lo, hi)`` only.  A leaf a
    rank uses whole on replicated inputs, whose gradient is equal on every
    rank, keeps its own rows so that the once-a-step sum over the model
    ranks adds each row once."""
    return _OwnRowsGrad.apply(w, lo, hi)


def ppermute(t: torch.Tensor, split: Split, shift: int = 1):
    """Start passing ``t`` to rank ``rank + shift`` (mod size) of the
    split's group while receiving the tensor rank ``rank - shift`` sends.
    Returns ``wait()``, which blocks until both are done and returns the
    received tensor (on ``t``'s device)."""
    n, r, group = split.size, split.rank, split.group
    return send_recv(t, dist.get_global_rank(group, (r + shift) % n),
                     dist.get_global_rank(group, (r - shift) % n), group,
                     tally=collectives)
