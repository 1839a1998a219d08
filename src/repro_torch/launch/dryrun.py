"""The serve wrapper of ``repro/launch/dryrun.py`` (``_serve_wrap``).

``repro`` wraps prefill and decode in a ``shard_map`` over the batch axes
so that its manual paths (the expert-parallel MoE, the vocab-sharded
logits, attention split by heads) are taken while serving.  Here the
wrapper cuts this rank's rows of the batch and enters the same manual
region around a call on them.  The rest of ``repro``'s ``dryrun.py``
(cell lowering, HLO reports) has no counterpart yet.
"""
from __future__ import annotations

from repro_torch.distributed import dp_shard
from repro_torch.models.lm import param_specs
from repro_torch.models.module import map_specs


def _serve_wrap(model, ctx, fn):
    """``fn(batch, cache)`` (``model``'s ``prefill``, or a decode step)
    wrapped to run inside ``ctx.manual_region`` of the mesh's batch axes,
    or None where ``repro`` returns None: no batch axes, or a planned dim
    that does not divide.  The wrapped function takes the global batch,
    of which it passes ``fn`` this rank's rows (``dp_shard.local_rows``),
    and this rank's cache, which holds those rows; it returns ``fn``'s
    result for them.

    ``repro`` gathers the leaves its rules shard over the batch axes
    (``SERVE_RULES_BIG``'s FSDP) inside the region; the port's serving
    model holds every parameter whole, so a rule set that shards one is
    refused."""
    cfg, mesh = model.cfg, ctx.mesh
    manual = dp_shard.manual_axes(mesh)
    specs = param_specs(cfg)
    axes = map_specs(lambda s: s.axes, specs)
    if not manual or not dp_shard.validate_manual_divisibility(
            ctx, axes, specs, manual):
        return None
    sharded = [name for name, ax in dp_shard.named_axes(
        specs, cfg.num_layers, cfg.encoder_layers).items()
        if dp_shard.rule_manual_dims(ctx, ax, manual)]
    if sharded:
        raise NotImplementedError(
            f"the rules shard {len(sharded)} leaves of {cfg.name} over "
            f"{manual} (e.g. {sharded[0]}); the port serves whole "
            f"parameters")

    def wrapped(batch, cache):
        rows = dp_shard.local_rows(mesh, batch)
        with ctx.manual_region(set(manual)):
            return fn(rows, cache)

    return wrapped
