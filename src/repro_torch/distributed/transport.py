"""How a collective moves its tensors: the backend rule, and a group of
one.

A collective over a gloo group on a CUDA tensor copies the tensor to host
memory, runs there and copies the result back; under NCCL, or on CPU
tensors, tensors pass as they are.  The host copies are pinned, from
PyTorch's caching host allocator, which hands a freed buffer to the next
collective of its size instead of page-locking new memory.  The group's
backend decides (``stages_through_host``), never a caught failure.
Every collective of ``dp_shard`` and ``model_axis`` goes through here.

A collective over a group of one rank is not issued: an all-reduce
returns its tensor as it is, an all-gather a copy, a reduce-scatter its
input (``repro``'s ``psum`` over an axis of size 1 is the identity too).

Every collective issued adds one to ``moved`` under ``"staged"`` (through
host memory) or ``"direct"``, so a run can show which way its tensors
went, and, given ``tally``, one to ``tally[kind]`` under the collective's
own kind: the caller's count by kind (``dp_shard.collectives``,
``model_axis.collectives``).  One not issued adds to neither.  Each
issued is also reported to a counting ``roofline.counter.Counter``, if
one counts: its kind, its group (the counter names the mesh axis) and its
bytes, the larger of its input and output.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch.roofline import counter as _counter

# collectives by how they moved their tensors (read and zeroed by callers)
moved: collections.Counter = collections.Counter()


def stages_through_host(backend: str, device_type: str) -> bool:
    """Does a collective of a group with ``backend`` on a tensor of
    ``device_type`` run on a host copy?  Only gloo on a CUDA tensor: gloo
    reduces host memory, NCCL device memory."""
    return str(backend) == "gloo" and device_type == "cuda"


def single(group) -> bool:
    """Is ``group`` one rank (every collective over it the identity)?"""
    return dist.get_world_size(group) == 1


def staged(t: torch.Tensor, group, tally=None, kind: str = "") -> bool:
    """Does a collective of ``group`` on ``t`` run on a host copy?  Counts
    the collective in ``moved`` and, given ``tally``, in ``tally[kind]``."""
    s = stages_through_host(dist.get_backend(group), t.device.type)
    moved["staged" if s else "direct"] += 1
    if tally is not None:
        tally[kind] += 1
    return s


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * dtype.itemsize


def _pinned(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``."""
    h = _pinned(t.shape, t.dtype)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM, *,
                tally=None):
    """``t`` reduced over ``group`` in place (``t`` itself over one
    rank); tallied as ``"all_reduce_max"`` under ``MAX``, else
    ``"all_reduce"``."""
    if single(group):
        return t
    kind = "all_reduce_max" if op == dist.ReduceOp.MAX else "all_reduce"
    _counter.collective(kind, group, _nbytes(t.shape, t.dtype))
    if staged(t, group, tally, kind):
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(src: torch.Tensor, group, *, tally=None) -> torch.Tensor:
    """Every rank's contiguous ``src`` concatenated along dim 0 in rank
    order (``dist.all_gather_into_tensor``); a copy of ``src`` over one
    rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return src.clone()
    out_shape = (n * src.shape[0],) + tuple(src.shape[1:])
    _counter.collective("all_gather", group, _nbytes(out_shape, src.dtype))
    if staged(src, group, tally, "all_gather"):
        h = _pinned(out_shape, src.dtype)
        dist.all_gather_into_tensor(h, _to_host(src), group=group)
        return h.to(src.device)
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def reduce_scatter(src: torch.Tensor, group, *,
                   tally=None) -> torch.Tensor:
    """This rank's block along dim 0 of the sum over ``group`` of the
    contiguous ``src`` (``dist.reduce_scatter_tensor``); ``src`` itself
    over one rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return src
    out_shape = (src.shape[0] // n,) + tuple(src.shape[1:])
    _counter.collective("reduce_scatter", group,
                        _nbytes(src.shape, src.dtype))
    if staged(src, group, tally, "reduce_scatter"):
        h = _pinned(out_shape, src.dtype)
        dist.reduce_scatter_tensor(h, _to_host(src), op=dist.ReduceOp.SUM,
                                   group=group)
        return h.to(src.device)
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out


def send_recv(t: torch.Tensor, dst: int, src: int, group, *, tally=None):
    """Start sending ``t`` to global rank ``dst`` while receiving a tensor
    like it from global rank ``src``.  Returns ``wait()``, which blocks
    until both are done and returns the received tensor on ``t``'s
    device (over one rank, ``t`` itself)."""
    if single(group):
        return lambda: t
    _counter.collective("send_recv", group, _nbytes(t.shape, t.dtype))
    host = staged(t, group, tally, "send_recv")
    send = _to_host(t) if host else t.contiguous()
    recv = _pinned(send.shape, send.dtype) if host else torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, src, group)])

    def wait():
        for q in reqs:
            q.wait()
        return recv.to(t.device) if host else recv

    return wait
