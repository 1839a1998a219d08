"""Which part of a leaf a model rank holds, and which part it computes with.

A leaf whose dim the rules map to ``"model"`` is stored as this rank's
shard of that dim, as ``repro``'s ``param_shardings`` places it
(``sharding_rules.storage_dims``, with the divisibility guard;
``dp_shard.ShardPlan.for_storage``).  Under a model split the layers
compute with a part of the leaf, the work range the split gives the rank
(``layers.work_runs``: its ``rank_heads`` runs, its d_ff slice, its
``Vloc`` virtual experts, its vocabulary rows).  One rule per leaf,
decided from shapes alone (``rule``), says how the rank gets that part:

* **aligned**: the leaf is stored split and every rank's storage range is
  its work range.  The shard itself, with no collective; its gradient is
  complete on the rank and takes no sum;
* **unaligned**: stored split, and the ranges differ.  The leaf is
  all-gathered over ``"model"`` at use (``dp_shard.gather_model``, in the
  compute dtype for 2 or more dims), then narrowed; the gather's backward
  reduce-scatters the gradient over the model ranks, which is also its
  sum;
* **whole**: the guard dropped the model dim, so every rank holds the
  leaf whole and narrows it; a leaf used in part is summed over the model
  ranks once a step (``dp_shard.model_psum``).

``take`` is the one place that slices a leaf for the model axis.  Called
inside a layer, it gathers inside the function the remat policy
checkpoints, so a rematerialised layer gathers again in the backward.  A
leaf used whole on replicated inputs (decode's attention, the MoE with
the expert-parallel branch off) is gathered whole, its gradient this
rank's slice of the equal ones.

Every collective goes through ``transport``'s backend rule and is counted
in ``dp_shard.collectives``; a gather also in ``dp_shard.model_gathers``
under its leaf's kind.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import dp_shard, model_axis
from repro_torch.distributed.sharding_rules import current_ctx

Runs = Sequence[Tuple[int, int]]

ALIGNED, UNALIGNED, WHOLE = "aligned", "unaligned", "whole"


def storage_split() -> Optional[model_axis.Split]:
    """The ``"model"`` axis leaves are stored split over: inside the
    manual region of the batch axes, on a mesh whose ``"model"`` axis is
    larger than 1; else None (every leaf is whole)."""
    ctx = current_ctx()
    if ctx is None or not ctx.manual or not model_axis.batch_manual(ctx):
        return None
    n = ctx.shape.get("model", 1)
    if n <= 1:
        return None
    return model_axis.Split("model", n, ctx.mesh.get_local_rank("model"),
                            ctx.mesh.get_group("model"))


def rule(size: int, n: int, stored_split: bool,
         runs_of: Callable[[int], Runs]) -> str:
    """The rule of a leaf whose model dim has ``size`` elements over ``n``
    model ranks: ``WHOLE`` unless ``stored_split``; ``ALIGNED`` if every
    rank r's work ranges ``runs_of(r)`` are exactly its storage range
    [r size / n, (r + 1) size / n); else ``UNALIGNED``.  Every rank
    reaches the same answer, so every rank issues the same gathers."""
    if not stored_split:
        return WHOLE
    s = size // n
    aligned = all([tuple(run) for run in runs_of(r)] == [(r * s, (r + 1) * s)]
                  for r in range(n))
    return ALIGNED if aligned else UNALIGNED


def narrow(t: torch.Tensor, dim: int, runs: Runs) -> torch.Tensor:
    """The ranges ``runs`` of ``t`` along ``dim`` in order: a view for
    one range, else their concatenation."""
    parts = [t.narrow(dim, a, b - a) for a, b in runs]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim) if parts else t.narrow(dim, 0, 0)


def take(t: torch.Tensor, dim: int, size: int, *, kind: str,
         runs_of: Optional[Callable[[int], Runs]] = None, split=None,
         dtype=None) -> torch.Tensor:
    """The part of leaf ``t`` that this rank computes with.  ``dim``: the
    leaf's model dim, ``size`` elements whole; ``t`` holds either all of
    them or this rank's storage shard of them.  ``runs_of(r)``: the
    [lo, hi) ranges along ``dim`` that model rank r computes with under
    the work split ``split`` (this rank's is ``runs_of(split.rank)``);
    None for the whole leaf, used whole on replicated inputs.  A gather
    (``UNALIGNED``, or the whole of a stored-split leaf) casts a leaf of 2
    or more dims to ``dtype``; ``kind`` names the leaf in
    ``dp_shard.model_gathers``.  Raises on a shard outside a model
    split of its size."""
    dim %= t.ndim
    part = runs_of is not None
    if t.shape[dim] != size:
        store = storage_split()
        if store is None or t.shape[dim] * store.size != size:
            raise ValueError(f"{kind}: {t.shape[dim]} of {size} elements "
                             f"along dim {dim} outside a model split that "
                             f"stores them")
        if part and rule(size, store.size, True, runs_of) == ALIGNED:
            return t
        t = dp_shard.gather_model(t, dim, store, kind=kind,
                                  dtype=dtype if t.ndim >= 2 else None,
                                  summed=part)
    if not part:
        return t
    return narrow(t, dim, runs_of(split.rank))


def runs_of_range(lo: int, hi: int) -> List[Tuple[int, int]]:
    """[lo, hi) as a list of runs (none when empty)."""
    return [(lo, hi)] if hi > lo else []
