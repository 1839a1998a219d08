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

``pmax`` takes no gradient (``repro`` stop-gradients the max it reduces);
``gather_from_model`` all-gathers a split last dim; ``ppermute`` passes a
tensor one step along the ring (``collective_matmul``).

``split_for(logical)`` says whether a logical activation axis splits the
work here: under a ``use_rules`` context whose rules map it to exactly one
mesh axis that is not manual and larger than 1, inside the manual region
of the batch axes (the data-parallel step or the serve wrapper), as
``repro`` requires for its explicit paths.  Outside such a region the
port's tensors are whole and every rank computes everything.

Every collective moves its tensors under ``transport``'s backend rule
(over a gloo group a CUDA tensor is staged through host memory).

Every collective issued here adds one to ``collectives`` under its kind:
``all_reduce``, ``all_reduce_max``, ``all_gather`` or ``send_recv``.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding_rules import current_ctx
from repro_torch.distributed.transport import (all_gather_into, all_reduce_,
                                               send_recv)

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
        all_reduce_(g, ctx.group)
        collectives["all_reduce"] += 1
        return g, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        all_reduce_(out, group)
        collectives["all_reduce"] += 1
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
    all_reduce_(out, split.group, op=dist.ReduceOp.MAX)
    collectives["all_reduce_max"] += 1
    return out


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        src = x.movedim(-1, 0).contiguous()
        out = torch.empty((split.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        all_gather_into(out, src, split.group)
        collectives["all_gather"] += 1
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.split.size
        r = ctx.split.rank
        return g[..., r * n:(r + 1) * n], None


def gather_from_model(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim, in rank order;
    the gradient is this rank's slice of the (replicated) cotangent."""
    return _GatherFromModel.apply(x, split)


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
    wait = send_recv(t, dist.get_global_rank(group, (r + shift) % n),
                     dist.get_global_rank(group, (r - shift) % n), group)
    collectives["send_recv"] += 1
    return wait
