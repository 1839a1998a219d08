"""How a collective moves its tensors: the backend rule.

A collective over a gloo group on a CUDA tensor copies the tensor to host
memory, runs there and copies the result back; under NCCL, or on CPU
tensors, tensors pass as they are.  The host copies are pinned, from
PyTorch's caching host allocator, which hands a freed buffer to the next
collective of its size instead of page-locking new memory.  The group's backend decides
(``stages_through_host``), never a caught failure.  Every collective of
``dp_shard`` and ``model_axis`` goes through here.

Every collective adds one to ``moved`` under ``"staged"`` (through host
memory) or ``"direct"``, so a run can show which way its tensors went.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# collectives by how they moved their tensors (read and zeroed by callers)
moved: collections.Counter = collections.Counter()


def stages_through_host(backend: str, device_type: str) -> bool:
    """Does a collective of a group with ``backend`` on a tensor of
    ``device_type`` run on a host copy?  Only gloo on a CUDA tensor: gloo
    reduces host memory, NCCL device memory."""
    return str(backend) == "gloo" and device_type == "cuda"


def staged(t: torch.Tensor, group) -> bool:
    """Does a collective of ``group`` on ``t`` run on a host copy?  Counts
    the collective in ``moved``."""
    s = stages_through_host(dist.get_backend(group), t.device.type)
    moved["staged" if s else "direct"] += 1
    return s


def _pinned(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``."""
    h = _pinned(t.shape, t.dtype)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """``t`` reduced over ``group`` in place."""
    if staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, src: torch.Tensor, group):
    """``dist.all_gather_into_tensor``."""
    if staged(src, group):
        h = _pinned(out.shape, out.dtype)
        dist.all_gather_into_tensor(h, _to_host(src), group=group)
        out.copy_(h)
    else:
        dist.all_gather_into_tensor(out, src, group=group)
    return out


def reduce_scatter_into(out: torch.Tensor, src: torch.Tensor, group):
    """``dist.reduce_scatter_tensor``, a sum."""
    if staged(src, group):
        h = _pinned(out.shape, out.dtype)
        dist.reduce_scatter_tensor(h, _to_host(src), op=dist.ReduceOp.SUM,
                                   group=group)
        out.copy_(h)
    else:
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
    return out


def send_recv(t: torch.Tensor, dst: int, src: int, group):
    """Start sending ``t`` to global rank ``dst`` while receiving a tensor
    like it from global rank ``src``.  Returns ``wait()``, which blocks
    until both are done and returns the received tensor on ``t``'s
    device."""
    host = staged(t, group)
    send = _to_host(t) if host else t.contiguous()
    recv = _pinned(send.shape, send.dtype) if host else torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, src, group)])

    def wait():
        for q in reqs:
            q.wait()
        return recv.to(t.device) if host else recv

    return wait
