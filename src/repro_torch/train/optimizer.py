"""AdamW, its learning-rate schedule and global-norm clipping.

The counterpart of ``repro/train/optimizer.py``.  Parameters, gradients and
both moments are flat dicts of tensors keyed alike (the JAX package keeps
pytrees); the moments are fp32.  ``adamw_update`` works in place, leaf by
leaf, under ``torch.no_grad()``: a 780M-parameter model's masters and
moments are 9.4 GB, and a functional update would hold a second copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int                    # updates taken so far
    mu: Tree                     # first moment, fp32, keyed like the params
    nu: Tree                     # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"     # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step) -> float:
    """Linear warm-up to ``peak_lr``, then the schedule's decay to
    ``min_lr_ratio * peak_lr`` at ``total_steps``."""
    step = float(step)
    warm = min(1.0, step / max(1, cfg.warmup_steps))
    frac = min(1.0, max(0.0, (step - cfg.warmup_steps)
                        / max(1, cfg.total_steps - cfg.warmup_steps)))
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + math.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * decay
    return cfg.peak_lr * warm * decay


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(tree: Tree, max_norm: float):
    """Returns (tree scaled so its global norm is at most ``max_norm``,
    the norm before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


def init_adamw(params: Tree) -> AdamWState:
    return AdamWState(
        step=0,
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: AdamWState, *, grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step (bias-corrected moments, decoupled weight decay,
    global-norm clipping) applied to ``params`` and to the moments in
    ``state`` in place.  Returns (params, new state, metrics).

    ``grad_norm``: a norm computed elsewhere to clip with; by default the
    global norm of ``grads``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for k, p in params.items():
        g = grads[k].float() * clip
        m, v = state.mu[k], state.nu[k]
        m.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
        v.mul_(cfg.b2).add_(torch.square(g), alpha=1.0 - cfg.b2)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (delta + cfg.weight_decay * pf))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
