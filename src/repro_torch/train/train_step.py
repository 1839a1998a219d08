"""The train step: loss and gradients, optional microbatch accumulation and
int8 error-feedback gradient compression, then an in-place AdamW update.

The counterpart of ``repro/train/train_step.py`` off a mesh
(``make_train_step``'s pjit path; ``dp_manual`` has no mesh to act on here
and takes the same path, as JAX does off a mesh).  The model holds the fp32
master parameters (``build_model(..., trainable=True)``); the step updates
them, the AdamW moments and the error feedback in place.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import grad_compress
from repro_torch.models.lm import build_model, param_specs
from repro_torch.models.module import init_params
from repro_torch.utils.device import resolve_device
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, init_adamw)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat_policy: str = "dots"         # none | dots | nothing | full
    microbatches: int = 1              # gradient accumulation steps
    compress_grads: bool = False       # int8 EF-compression of the DP sync
    dp_manual: bool = False            # no mesh in the port yet: same path
    optimizer: AdamWConfig = AdamWConfig()


class TrainState:
    """The trainable model (its parameters are the fp32 masters), the
    AdamW state and the error feedback (None without compression)."""

    def __init__(self, model, opt: AdamWState,
                 err: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model
        self.opt = opt
        self.err = err

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The masters by name (``embed.tokens``, ``layers.0.ssm.in_x``,
        ...), the keys of ``opt.mu``, ``opt.nu`` and ``err``."""
        return dict(self.model.named_parameters())


def init_train_state(model_or_cfg, generator: Optional[torch.Generator],
                     cfg: TrainStepConfig, *, device="cuda") -> TrainState:
    """A fresh train state on ``device`` (the card unless ``"cpu"`` is
    given; raises if there is no card).  Given a ``ModelConfig``, the
    masters are drawn from ``generator``, on the generator's device; given
    a trainable model (``build_model(..., trainable=True)``), its
    parameters are the masters."""
    dev = resolve_device(device)
    if isinstance(model_or_cfg, ModelConfig):
        params = init_params(param_specs(model_or_cfg), generator)
        model = build_model(model_or_cfg, params, device=dev, trainable=True)
        del params
    else:
        model = model_or_cfg
        if not model.trainable:
            raise ValueError("init_train_state needs a trainable model "
                             "(build_model(..., trainable=True))")
        model = model.to(dev)
        model.device = dev
    params = dict(model.named_parameters())
    err = grad_compress.init_error_feedback(params) if cfg.compress_grads \
        else None
    return TrainState(model, init_adamw(params), err)


def stacked_name(name: str) -> str:
    """The leaf of JAX's stacked tree a parameter belongs to:
    ``layers.3.ssm.in_x`` -> ``layers.ssm.in_x``, ``encoder.3.attn.wq`` ->
    ``encoder.attn.wq``.  JAX compresses each stacked (L, ...) leaf as one
    tensor, so the layers of a group share its scale."""
    return re.sub(r"^(layers|encoder)\.\d+\.", r"\1.", name)


def _split_microbatches(batch, n: int):
    def sp(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"{n} microbatches")
        return x.chunk(n)
    parts = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(model, cfg: TrainStepConfig):
    """Returns step(state, batch) -> (state, metrics) for ``model``, the
    model ``state`` holds.  ``batch``: {"tokens", "targets", optional
    "loss_mask"}, (B,S) tensors on the model's device, and the stub
    frontends' fields (a vlm's ``patch_embeds``, whisper's ``frames``).
    Metrics are 0-d tensors (read them with ``float``) and the lr, a
    float; with microbatches, loss and metrics are the last microbatch's,
    as in JAX."""

    def loss_and_grads(params, mb):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(mb, remat_policy=cfg.remat_policy)
        loss.backward()
        return loss.detach(), metrics, {k: p.grad for k, p in params.items()}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        params = state.params
        if cfg.microbatches <= 1:
            loss, metrics, grads = loss_and_grads(params, batch)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for mb in _split_microbatches(batch, cfg.microbatches):
                loss, metrics, g = loss_and_grads(params, mb)
                for k, acc in grads.items():
                    acc.add_(g[k])
            for acc in grads.values():
                acc.div_(cfg.microbatches)
        for p in params.values():
            p.grad = None
        err = state.err
        if cfg.compress_grads:
            grads, err = grad_compress.compress_tree(grads, err,
                                                     group=stacked_name)
        _, opt, opt_metrics = adamw_update(cfg.optimizer, params, grads,
                                           state.opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(state.model, opt, err), metrics

    return step
