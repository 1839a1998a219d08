"""Int8 error-feedback gradient compression: the lossy channel a
data-parallel all-reduce's payload passes through.

The counterpart of ``repro/distributed/grad_compress.py``: symmetric
per-tensor int8 quantisation with the quantisation error carried to the
next step in an fp32 accumulator (EF-SGD), which keeps the mean applied
update on the true gradient; ``compressed_psum`` runs it through a
``torch.distributed`` all-reduce whose payload is the quantised integers.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]


def _round(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: returns (q, scale)."""
    scale = (torch.max(torch.abs(x)) + 1e-12) / 127.0
    return _round(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Quantise ``g`` plus the carried error and dequantise it.  Returns
    (g_hat, new_err)."""
    corrected = g.float() + err
    g_hat = dequantize_int8(*quantize_int8(corrected))
    return g_hat, corrected - g_hat


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over the process group ``group`` (the
    default group if None).  Every rank quantises against the group's
    largest scale (an all-reduce MAX), sums the quantised values as int32
    (an all-reduce SUM) and divides by the group's size.  Returns
    (mean gradient, new error), the error measured against this rank's
    own scale, as in ``repro``."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    q2 = torch.clamp(torch.round(corrected / scale_max), -127, 127
                     ).to(torch.int32)
    dist.all_reduce(q2, op=dist.ReduceOp.SUM, group=group)
    size = float(dist.get_world_size(group))
    return q2.float() * scale_max / size, new_err


def compress_tree(grads: Tree, err: Tree, *,
                  group: Callable[[str], str] = lambda name: name,
                  amax_reduce: Optional[Callable] = None
                  ) -> Tuple[Tree, Tree]:
    """``compress_decompress`` on every leaf, with one scale for all the
    leaves whose names ``group`` maps to the same key (by default each leaf
    alone).  ``amax_reduce(keys, amax)``: the largest magnitude of those
    leaves over every rank that holds a shard of them, given this rank's
    (a max over the ranks, so that shards of one leaf share ``repro``'s
    scale of the whole leaf); by default this rank's.  Returns (grads,
    errors)."""
    groups: Dict[str, list] = {}
    for k in grads:
        groups.setdefault(group(k), []).append(k)
    out_g, out_e = {}, {}
    for keys in groups.values():
        corrected = {k: grads[k].float() + err[k] for k in keys}
        amax = torch.stack([torch.max(torch.abs(c)) if c.numel()
                            else c.new_zeros(())
                            for c in corrected.values()]).max()
        if amax_reduce is not None:
            amax = amax_reduce(keys, amax)
        scale = (amax + 1e-12) / 127.0
        for k, c in corrected.items():
            out_g[k] = dequantize_int8(_round(c, scale), scale)
            out_e[k] = c - out_g[k]
    return out_g, out_e
