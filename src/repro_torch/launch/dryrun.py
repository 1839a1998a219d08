"""The serve wrapper of ``repro/launch/dryrun.py`` (``_serve_wrap``).

``repro`` wraps prefill and decode in a ``shard_map`` over the batch axes
so that its manual paths (the expert-parallel MoE, the vocab-sharded
logits, attention split by heads, the per-layer bf16 gathers of the
leaves ``SERVE_RULES_BIG`` shards over ``"data"``) are taken while
serving.  Here the wrapper cuts this rank's rows of the batch and enters
the same manual region around a call on them; inside it the model's
prefill and decode gather each layer's batch-sharded leaves
(``lm._serve_params``) and the layers take their part of the
model-sharded ones (``layers.work``).  The rest of ``repro``'s
``dryrun.py`` (cell lowering, HLO reports) has no counterpart yet.
"""
from __future__ import annotations

from repro_torch.distributed import dp_shard
from repro_torch.models.module import map_specs
from repro_torch.models.lm import param_specs


def _serve_wrap(model, ctx, fn):
    """``fn(batch, cache)`` (``model``'s ``prefill``, or a decode step)
    wrapped to run inside ``ctx.manual_region`` of the mesh's batch axes,
    or None where ``repro`` returns None: no batch axes, or a planned dim
    that does not divide.  The wrapped function takes the global batch,
    of which it passes ``fn`` this rank's rows (``dp_shard.local_rows``),
    and this rank's cache as it is: it holds those rows, and where the
    rules cut its K/V slots over the model ranks (``kv_seq``, made by
    ``init_cache`` under them) this rank's block of the slots; it returns
    ``fn``'s result for them.

    ``model`` holds its leaves as ``ctx``'s rules store them: on the
    storage plan of its mesh (``build_model(..., plan=)``, as
    ``train_step.param_plan`` makes it), or whole where the rules shard no
    leaf over the batch axes (each layer then takes its part of a whole
    leaf).  A model whose storage is neither raises ``ValueError``."""
    from repro_torch.train.train_step import param_plan
    cfg, mesh = model.cfg, ctx.mesh
    manual = dp_shard.manual_axes(mesh)
    specs = param_specs(cfg)
    axes = map_specs(lambda s: s.axes, specs)
    if not manual or not dp_shard.validate_manual_divisibility(
            ctx, axes, specs, manual):
        return None
    plan = param_plan(cfg, ctx)
    held = getattr(model, "plan", None)
    if held is None:
        batch_sharded = [name for name, dims in plan.dims.items()
                         if any(a in manual for ax in dims.values()
                                for a in ax)]
        if batch_sharded:
            raise ValueError(
                f"the rules shard {len(batch_sharded)} leaves of {cfg.name} "
                f"over {manual} (e.g. {batch_sharded[0]}) and the model holds "
                f"them whole; build it on the storage plan (build_model(..., "
                f"plan=param_plan(cfg, ctx)))")
    elif held.dims != plan.dims:
        raise ValueError(f"{cfg.name} is stored on another plan than the "
                         f"rules give this mesh")

    def wrapped(batch, cache):
        rows = dp_shard.local_rows(mesh, batch)
        with ctx.manual_region(set(manual)):
            return fn(rows, cache)

    return wrapped
