"""The train step: loss and gradients, optional microbatch accumulation and
int8 error-feedback gradient compression, then an in-place AdamW update.

The counterpart of ``repro/train/train_step.py``: the plain step, and with
``dp_manual`` under a ``use_rules`` mesh the explicit data-parallel step
(``_make_manual_dp_step``, on ``distributed/dp_shard.py``) over a state
held on the storage plan (``param_plan``): each leaf as this rank's shard
of the dims the rules map to the batch axes and to ``"model"``, built so
leaf by leaf (``init_train_state(..., ctx=)``) or cut from a whole state
(``shard_train_state``).  The model holds the fp32 master parameters
(``build_model(..., trainable=True)``); the step updates them, the AdamW
moments and the error feedback in place.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import dp_shard, grad_compress
from repro_torch.distributed.sharding_rules import ShardingCtx, current_ctx
from repro_torch.models import layers as ll
from repro_torch.models import stack as stk
from repro_torch.models.lm import (build_model, init_sharded_params,
                                   param_specs, top_axes)
from repro_torch.models.module import init_params, map_specs
from repro_torch.utils.device import resolve_device
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, init_adamw)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat_policy: str = "dots"         # none | dots | nothing | full
    microbatches: int = 1              # gradient accumulation steps
    compress_grads: bool = False       # int8 EF-compression of the DP sync
    dp_manual: bool = False            # the explicit data-parallel step
                                       # under a use_rules mesh (see
                                       # distributed/dp_shard.py); the plain
                                       # step off a mesh
    optimizer: AdamWConfig = AdamWConfig()


class TrainState:
    """The trainable model (its parameters are the fp32 masters), the
    AdamW state and the error feedback (None without compression).
    ``plan``: the ``dp_shard.ShardPlan`` of a state ``shard_train_state``
    sharded (its planned leaves, moments and error feedback are this
    rank's shards), else None."""

    def __init__(self, model, opt: AdamWState,
                 err: Optional[Dict[str, torch.Tensor]] = None,
                 plan: Optional[dp_shard.ShardPlan] = None):
        self.model = model
        self.opt = opt
        self.err = err
        self.plan = plan

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The masters by name (``embed.tokens``, ``layers.0.ssm.in_x``,
        ...), the keys of ``opt.mu``, ``opt.nu`` and ``err``."""
        return dict(self.model.named_parameters())


def init_train_state(model_or_cfg, generator: Optional[torch.Generator],
                     cfg: TrainStepConfig, *, device="cuda",
                     ctx: Optional[ShardingCtx] = None) -> TrainState:
    """A fresh train state on ``device`` (the card unless ``"cpu"`` is
    given; raises if there is no card).  Given a ``ModelConfig``, the
    masters are drawn from ``generator``, on the generator's device; given
    a trainable model (``build_model(..., trainable=True)``), its
    parameters are the masters (and its plan, if it was built on one, the
    state's).  With ``ctx`` (a ``ModelConfig`` only) the
    state is this rank's shards on ``ctx``'s storage plan, drawn leaf by
    leaf (``init_sharded_params``: the whole init's values, and never the
    whole state on the rank); it carries the plan."""
    dev = resolve_device(device)
    plan = None
    if ctx is not None:
        if not isinstance(model_or_cfg, ModelConfig):
            raise TypeError("init_train_state(ctx=) draws the shards from a "
                            "ModelConfig; shard a model's state with "
                            "shard_train_state")
        plan = param_plan(model_or_cfg, ctx)
        params = init_sharded_params(model_or_cfg, generator, plan)
        model = build_model(model_or_cfg, params, device=dev, trainable=True,
                            plan=plan)
        del params
    elif isinstance(model_or_cfg, ModelConfig):
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
        plan = getattr(model, "plan", None)
    params = dict(model.named_parameters())
    err = grad_compress.init_error_feedback(params) if cfg.compress_grads \
        else None
    return TrainState(model, init_adamw(params), err, plan)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """{port parameter name: global shape} of ``cfg``'s parameters (a
    stacked leaf's per-layer tensors without the layers dim)."""
    counts = {"layers": cfg.num_layers, "encoder": cfg.encoder_layers}
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif path and path[0] in counts:
                for i in range(counts[path[0]]):
                    out[".".join((path[0], str(i)) + path[1:] + (k,))] = \
                        tuple(v.shape[1:])
            else:
                out[".".join(path + (k,))] = tuple(v.shape)

    walk(param_specs(cfg), ())
    return out


def param_plan(cfg: ModelConfig, ctx: ShardingCtx) -> dp_shard.ShardPlan:
    """The storage plan of ``cfg``'s parameters on ``ctx``'s mesh
    (``ShardPlan.for_storage``): each leaf's dims that the rules map to a
    manual axis, and to ``"model"`` where that axis is larger than 1 and
    the dim divides, as ``repro``'s ``param_shardings`` places them."""
    axes = dp_shard.named_axes(param_specs(cfg), cfg.num_layers,
                               cfg.encoder_layers)
    return dp_shard.ShardPlan.for_storage(ctx, axes, param_shapes(cfg),
                                          dp_shard.manual_axes(ctx.mesh))


@torch.no_grad()
def shard_train_state(state: TrainState, ctx: ShardingCtx) -> TrainState:
    """``state`` with each planned leaf's data replaced by this rank's
    shard (``param_plan``: over the batch axes and ``"model"``), and the
    AdamW moments and the error feedback shaped like the shards (ZeRO: the
    moments live on the same shards).  The returned state, and its model,
    carry the plan."""
    plan = param_plan(state.model.cfg, ctx)
    for name, p in state.params.items():
        if name in plan.dims:
            p.data = plan.local(name, p.data).contiguous()
    state.model.plan = plan
    mu = dp_shard.shard_tree(state.opt.mu, plan)
    nu = dp_shard.shard_tree(state.opt.nu, plan)
    err = dp_shard.shard_tree(state.err, plan) if state.err is not None \
        else None
    return TrainState(state.model, AdamWState(state.opt.step, mu, nu), err,
                      plan)


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


def _make_manual_dp_step(model, cfg: TrainStepConfig, ctx: ShardingCtx,
                         manual):
    """Train step with EXPLICIT data parallelism (distributed/dp_shard.py)
    over a state ``shard_train_state`` sharded; ``batch`` is this rank's
    rows.

    * the microbatches split the LOCAL batch, their count clamped to it;
    * FSDP leaves are gathered at use (the top-level groups here, before
      the loss; the layers' inside ``run_stack``), in bf16 for 2D+ leaves,
      and their gradients reduce-scattered once per microbatch;
    * every gradient is summed locally over the microbatches and reduced
      once per step over the manual axes that do not shard it, scaled by
      1/(R n_mb) (R ranks over the manual axes, n_mb microbatches);
    * under a model axis the layers split their work over the model ranks
      (``layers.py``) and take their part of each leaf stored split over
      them (an aligned shard as it is; any other gathered in the layer,
      its gradient reduce-scattered back); the leaves stored whole that a
      rank used only in part (``layers.model_partial_leaves``) are summed
      over the model ranks once per step beside that reduction
      (``dp_shard.model_psum``), so every gradient is then complete for
      the shard (or whole leaf) the rank holds;
    * where the rules map ``seq_res`` to the model axis and it divides
      the sequence (``stack.sp_split``), the residual stream between the
      layers' regions is each rank's block of the tokens: the norms' scales
      (and a layernorm's biases) are then also used in part and join that
      sum; an encdec model's encoder decides on its frames' length alike;
    * with ``compress_grads`` the reduced gradient passes through the int8
      error-feedback channel as the plain step's does
      (``grad_compress.compress_tree``, one scale per stacked leaf): the
      scale is the largest magnitude over the whole leaf, a max over the
      ranks that shard it, and the error feedback lives on the shards;
    * loss and metrics are the mean over microbatches, summed over the
      ranks of the manual axes and divided by R (the model ranks hold
      equal copies);
    * the global gradient norm is exact: each leaf's local sum of squares
      divided by how many ranks hold each of its elements (over the manual
      axes and ``"model"``), summed over those ranks;
    * AdamW updates the shards and their moments in place."""
    mc = model.cfg
    R = dp_shard.manual_size(ctx.mesh)
    plan = param_plan(mc, ctx)
    specs = param_specs(mc)
    top = top_axes(specs)

    def group_max(names, amax):
        """The compression scale's max over the ranks sharding ``names``."""
        axes = [a for a in plan.axes
                if any(a in ax for k in names
                       for ax in plan.dims.get(k, {}).values())]
        return dp_shard.all_reduce(amax.clone(), axes, ctx.mesh,
                                   op=torch.distributed.ReduceOp.MAX)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        if state.plan is None:
            raise ValueError("the data-parallel step needs a state that "
                             "shard_train_state sharded")
        params = state.params
        local_b = batch["tokens"].shape[0]
        n_mb = max(1, min(cfg.microbatches, local_b))
        mbs = _split_microbatches(batch, n_mb) if n_mb > 1 else [batch]
        for p in params.values():
            p.grad = None
        losses, per_mb = [], []
        with ctx.manual_region(manual):
            for mb in mbs:
                # the top-level groups gathered here, inside the graph, so
                # their gradients come back through the reduce-scatter; the
                # layers' leaves per layer inside run_stack.  The gradients
                # of the microbatches accumulate in .grad
                loss, metrics = model.loss(
                    mb, remat_policy=cfg.remat_policy,
                    params=dp_shard.gather_params(model.top_params(), top))
                loss.backward()
                losses.append(loss.detach())
                per_mb.append({k: v.detach() for k, v in metrics.items()})
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            for p in params.values():
                p.grad = None
            seq = stk.sp_split(mc, batch["tokens"].shape[1])
            enc_seq = stk.sp_split(mc, batch["frames"].shape[1]) \
                if "frames" in batch else None
            dp_shard.model_psum(grads, ll.model_partial_leaves(
                mc, specs, grads, seq, enc_seq), ctx.mesh)
            dp_shard.deferred_psum(grads, plan, 1.0 / (R * n_mb))
            err = state.err
            if cfg.compress_grads:
                grads, err = grad_compress.compress_tree(
                    grads, err, group=stacked_name, amax_reduce=group_max)
            loss = dp_shard.all_reduce(torch.stack(losses).mean(), manual,
                                       ctx.mesh) / R
            metrics = {k: dp_shard.all_reduce(
                torch.stack([m[k] for m in per_mb]).float().mean(), manual,
                ctx.mesh) / R for k in per_mb[0]}
            sq = sum(torch.sum(torch.square(g.float())) / plan.replication(k)
                     for k, g in grads.items())
            gnorm = torch.sqrt(dp_shard.all_reduce(sq, plan.axes, ctx.mesh))
            _, opt, opt_metrics = adamw_update(cfg.optimizer, params, grads,
                                               state.opt, grad_norm=gnorm)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(state.model, opt, err, state.plan), metrics

    step.path = "dp_manual"
    return step


def make_train_step(model, cfg: TrainStepConfig):
    """Returns step(state, batch) -> (state, metrics) for ``model``, the
    model ``state`` holds.  ``batch``: {"tokens", "targets", optional
    "loss_mask"}, (B,S) tensors on the model's device, and the stub
    frontends' fields (a vlm's ``patch_embeds``, whisper's ``frames``).
    Metrics are 0-d tensors (read them with ``float``) and the lr, a
    float; with microbatches, loss and metrics are the last microbatch's,
    as in JAX.

    With ``cfg.dp_manual``, a ``use_rules`` context active, manual axes on
    its mesh and every planned dim dividing its global size, the step is
    the explicit data-parallel one (``_make_manual_dp_step``); otherwise
    the plain step, as in JAX.  ``step.path`` says which
    (``"dp_manual"`` or ``"plain"``)."""
    if cfg.dp_manual:
        ctx = current_ctx()
        if ctx is not None:
            manual = dp_shard.manual_axes(ctx.mesh)
            specs = param_specs(model.cfg)
            if manual and dp_shard.validate_manual_divisibility(
                    ctx, map_specs(lambda s: s.axes, specs), specs, manual):
                return _make_manual_dp_step(model, cfg, ctx, manual)

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

    step.path = "plain"
    return step
