"""Int8 error-feedback gradient compression: the lossy channel a
data-parallel all-reduce's payload passes through.

The counterpart of ``repro/distributed/grad_compress.py`` without its
collective (``compressed_psum`` waits for the distributed port): symmetric
per-tensor int8 quantisation with the quantisation error carried to the
next step in an fp32 accumulator (EF-SGD), which keeps the mean applied
update on the true gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

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


def compress_tree(grads: Tree, err: Tree, *,
                  group: Callable[[str], str] = lambda name: name
                  ) -> Tuple[Tree, Tree]:
    """``compress_decompress`` on every leaf, with one scale for all the
    leaves whose names ``group`` maps to the same key (by default each leaf
    alone).  Returns (grads, errors)."""
    groups: Dict[str, list] = {}
    for k in grads:
        groups.setdefault(group(k), []).append(k)
    out_g, out_e = {}, {}
    for keys in groups.values():
        corrected = {k: grads[k].float() + err[k] for k in keys}
        amax = torch.stack([torch.max(torch.abs(c))
                            for c in corrected.values()]).max()
        scale = (amax + 1e-12) / 127.0
        for k, c in corrected.items():
            out_g[k] = dequantize_int8(_round(c, scale), scale)
            out_e[k] = c - out_g[k]
    return out_g, out_e
