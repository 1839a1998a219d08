"""Explicit (manual) data parallelism for the train step.

The counterpart of ``repro/distributed/dp_shard.py`` on ``torch.distributed``
collectives.  The train step (``train_step._make_manual_dp_step``) runs
every rank's microbatches locally and makes the data-parallel traffic
explicit:

* FSDP leaves (a dim the rules map to a manual mesh axis: ``"embed"`` to
  ``"data"`` under ``TRAIN_RULES``) are held as this rank's shard and
  all-gathered at use (``gather_leaf``), in **bf16** when the leaf has 2 or
  more dims and in fp32 when it has 1; stacked leaves one layer at a time,
  inside the layer the remat policy checkpoints (``layer_hook``), so the
  backward of a rematerialised layer gathers again.  The gather's backward
  is a reduce-scatter in the gathered dtype, once per microbatch;
* every other gradient is summed locally over the microbatches and reduced
  once per step over the manual axes it is not sharded on
  (``deferred_psum``);
* the model axis is not manual, but it stores: a leaf whose dim the rules
  map to ``"model"`` (``sharding_rules.storage_dims``, with the guard) is
  held as this rank's shard of it too (``ShardPlan.for_storage``), and so
  are its AdamW moments, gradient and error feedback.  Inside the region
  the layers split their work over the model ranks (``model_axis``) and
  take their part of each leaf (``model_storage``): a shard that is
  exactly the rank's part is used as it is; any other is all-gathered
  over ``"model"`` at use (``gather_model``, bf16 for 2 or more dims),
  whose backward reduce-scatters the gradient over the model ranks, which
  is also its sum.  Only a leaf stored whole and used in part is summed
  over the model ranks once per step (``model_psum``), next to
  ``deferred_psum``.

Every collective follows ``transport``'s backend rule: over a gloo group a
CUDA tensor is staged through host memory.

The gathers are written by hand, not with FSDP2's ``fully_shard``: its
mixed-precision policy casts every parameter to one dtype and shards every
parameter of a module, where ``repro`` keeps 1-dim leaves in fp32 and leaves
an unplanned leaf replicated until the once-a-step reduction.

A plan is rule-based: ``rule_manual_dims`` gives each leaf ``{dim: mesh
axes}``, and ``validate_manual_divisibility`` says whether every planned dim
divides on the global shapes (``make_train_step`` takes the plain step when
it does not, as ``repro`` does).  A dim sharded over several axes is laid out
major to minor in the axes' order (``("pod", "data")``: pod-major).

Every collective issued here adds one to ``collectives`` under its kind:
``all_gather``, ``reduce_scatter`` or ``all_reduce``; a gather over
``"model"`` also adds one to ``model_gathers`` under the leaf's kind
(``attn.wq``, ...).  A collective over an axis of one rank is not issued
(``transport``) and counts nowhere.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import transport
from repro_torch.distributed.sharding_rules import (ShardingCtx,
                                                    _is_axes_leaf,
                                                    current_ctx, mesh_shape,
                                                    model_dims)

MANUAL_CANDIDATES = ("pod", "data")     # batch-parallel mesh axes

Dims = Dict[int, Tuple[str, ...]]

# collectives issued by this module, by kind, and the gathers over "model"
# by leaf kind (read and zeroed by callers)
collectives: collections.Counter = collections.Counter()
model_gathers: collections.Counter = collections.Counter()


def manual_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in MANUAL_CANDIDATES if a in shape)


def manual_size(mesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in manual_axes(mesh):
        n *= shape[a]
    return n


def local_rows(mesh, batch):
    """This rank's rows of a global batch (a dict of tensors, or one
    tensor) along the manual axes, pod-major, as the data-parallel step
    and the serve wrapper take them."""
    shape = mesh_shape(mesh)
    index, count = 0, 1
    for a in manual_axes(mesh):
        index = index * shape[a] + mesh.get_local_rank(a)
        count *= shape[a]

    def cut(x):
        if x.shape[0] % count:
            raise ValueError(f"a batch of {x.shape[0]} rows over {count} "
                             f"batch shards")
        n = x.shape[0] // count
        return x[index * n:(index + 1) * n]

    return {k: cut(v) for k, v in batch.items()} \
        if isinstance(batch, Mapping) else cut(batch)


def rule_manual_dims(ctx: ShardingCtx, axes, manual) -> Dims:
    """dim -> manual mesh axes that shard it per the rules (axis used once,
    first dim wins, as ``ShardingCtx.partition_spec`` orders them)."""
    out: Dims = {}
    used = set()
    for i, name in enumerate(axes):
        mesh_ax = ctx.mesh_axes_for(name, include_manual=True)
        m = tuple(a for a in mesh_ax if a in manual and a not in used)
        if m:
            out[i] = m
            used.update(m)
    return out


def _leaves(axes_tree, other_tree):
    """(axes, other) pairs of two trees of the same nested-dict structure,
    the first one's leaves being logical-axes tuples."""
    if _is_axes_leaf(axes_tree):
        return [(axes_tree, other_tree)]
    return [pair for k in axes_tree
            for pair in _leaves(axes_tree[k], other_tree[k])]


def validate_manual_divisibility(ctx: ShardingCtx, axes_tree, abstract_tree,
                                 manual) -> bool:
    """True iff every manual-mapped dim divides cleanly on the GLOBAL
    shapes (``abstract_tree``'s leaves have a ``shape``)."""
    for ax, ab in _leaves(axes_tree, abstract_tree):
        for i, m in rule_manual_dims(ctx, ax, manual).items():
            n = 1
            for a in m:
                n *= ctx.shape[a]
            if ab.shape[i] % n:
                return False
    return True


def manual_pspec(ctx: ShardingCtx, axes, manual, ndim: int):
    """The partition spec restricted to manual axes, one entry per dim,
    trailing ``None``s dropped."""
    dims = rule_manual_dims(ctx, axes, manual)
    entries: list = []
    for i in range(ndim):
        m = dims.get(i, ())
        entries.append(m[0] if len(m) == 1 else (tuple(m) or None))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_manual_specs(ctx: ShardingCtx, axes_tree, abstract_tree, manual):
    """``manual_pspec`` of every leaf, in the trees' structure."""
    if _is_axes_leaf(axes_tree):
        return manual_pspec(ctx, axes_tree, manual, len(abstract_tree.shape))
    return {k: param_manual_specs(ctx, axes_tree[k], abstract_tree[k], manual)
            for k in axes_tree}


def named_axes(specs, num_layers: int, encoder_layers: int = 0
               ) -> Dict[str, Tuple[Optional[str], ...]]:
    """{port parameter name: logical axes of that tensor} for a spec tree
    in ``repro``'s layout: a stacked leaf's per-layer tensors
    (``layers.3.ssm.in_x``, ``encoder.3.attn.wq``) carry its axes without
    the leading ``"layers"``."""
    counts = {"layers": num_layers, "encoder": encoder_layers}
    out: Dict[str, Tuple[Optional[str], ...]] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            elif path and path[0] in counts:
                for i in range(counts[path[0]]):
                    out[".".join((path[0], str(i)) + path[1:] + (k,))] = \
                        tuple(v.axes[1:])
            else:
                out[".".join(path + (k,))] = tuple(v.axes)

    walk(specs, ())
    return out


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = transport.all_gather(src, group, tally=collectives)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = transport.reduce_scatter(src, group, tally=collectives)
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, axes, mesh,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the mesh axes ``axes``, one axis after
    the other (a sum of sums, a max of maxes); an axis of one rank issues
    nothing."""
    for a in axes:
        transport.all_reduce_(t, mesh.get_group(a), op=op, tally=collectives)
    return t


class GatherLeaf(torch.autograd.Function):
    """All-gather a leaf's planned dims (``dims``: {dim: mesh axes}).
    Forward: cast to ``dtype`` (if given), then one all-gather per axis,
    the minor axis first.  Backward: the transpose, a reduce-scatter per
    axis in the gathered dtype, then the cast back to the shard's dtype."""

    @staticmethod
    def forward(ctx, x, dims: Dims, mesh, dtype):
        ctx.dims, ctx.mesh, ctx.in_dtype = dims, mesh, x.dtype
        t = x if dtype is None else x.to(dtype)
        for dim, axes in sorted(dims.items()):
            for a in reversed(axes):
                t = _all_gather(t, dim, mesh.get_group(a))
        return t

    @staticmethod
    def backward(ctx, g):
        for dim, axes in sorted(ctx.dims.items(), reverse=True):
            for a in axes:
                g = _reduce_scatter(g, dim, ctx.mesh.get_group(a))
        return g.to(ctx.in_dtype), None, None, None


class GatherModel(torch.autograd.Function):
    """All-gather dim ``dim`` of a leaf stored split over the model ranks
    (``split``: a ``model_axis.Split``).  Forward: cast to ``dtype`` (if
    given), then the all-gather.  Backward: a reduce-scatter in the
    gathered dtype when each rank used its own part of the leaf
    (``summed``: the ranks' partial gradients summed), else this rank's
    slice of the gradient (the leaf used whole on replicated inputs, whose
    gradient is equal on every rank); then the cast back."""

    @staticmethod
    def forward(ctx, x, dim: int, split, dtype, summed: bool):
        ctx.dim, ctx.split, ctx.summed = dim, split, summed
        ctx.in_dtype = x.dtype
        t = x if dtype is None else x.to(dtype)
        return _all_gather(t, dim, split.group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.split.size
        if ctx.summed:
            g = _reduce_scatter(g, ctx.dim, ctx.split.group)
        else:
            g = g.narrow(ctx.dim, ctx.split.rank * n, n)
        return g.to(ctx.in_dtype), None, None, None, None


def gather_model(x, dim: int, split, *, kind: str, dtype=None,
                 summed: bool = True):
    """``GatherModel``: ``x``'s dim ``dim`` gathered over the model ranks,
    counted in ``model_gathers`` under ``kind``."""
    model_gathers[kind] += 1
    return GatherModel.apply(x, dim % x.ndim, split, dtype, summed)


def gather_leaf(x, dims: Dims, mesh, *, dtype=None):
    """``GatherLeaf``: ``x`` with its planned dims gathered (``x`` cast to
    ``dtype`` and nothing gathered when ``dims`` is empty)."""
    if not dims:
        return x if dtype is None else x.to(dtype)
    return GatherLeaf.apply(x, dims, mesh, dtype)


def _gather_tree(tree, axes_tree, ctx: ShardingCtx, *, skip_layers_dim: bool,
                 compute_dtype):
    """``tree`` (nested dicts, ``ParameterDict``s or ``ModuleDict``s of
    tensors) as plain dicts with every leaf's manual dims gathered: bf16
    (``compute_dtype``) for 2-dim and larger leaves, fp32 for 1-dim ones."""
    if _is_axes_leaf(axes_tree):
        if skip_layers_dim and axes_tree and axes_tree[0] == "layers":
            return tree                   # per-layer hook handles these
        dims = rule_manual_dims(ctx, axes_tree, ctx.manual)
        if not dims:
            return tree
        dt = compute_dtype if tree.ndim >= 2 else None   # 1D: keep f32
        return gather_leaf(tree, dims, ctx.mesh, dtype=dt)
    return {k: _gather_tree(tree[k], axes_tree[k], ctx,
                            skip_layers_dim=skip_layers_dim,
                            compute_dtype=compute_dtype) for k in axes_tree}


def gather_params(params, axes_tree, *, compute_dtype=torch.bfloat16):
    """Gather the manual-sharded dims of every NON-stacked leaf (stacked
    leaves, whose leading logical axis is ``"layers"``, are gathered per
    layer by ``layer_hook``).  No-op outside a manual region."""
    ctx = current_ctx()
    if ctx is None or not ctx.manual:
        return params
    return _gather_tree(params, axes_tree, ctx, skip_layers_dim=True,
                        compute_dtype=compute_dtype)


def layer_hook(axes_tree, *, compute_dtype=torch.bfloat16):
    """Per-layer FSDP gather for ``stack.run_stack``: gathers one layer's
    parameters' manual-sharded dims (bf16 for 2D+ leaves).  ``axes_tree``
    is the per-layer (unstacked) logical-axes tree."""
    def hook(p_layer):
        ctx = current_ctx()
        if ctx is None or not ctx.manual:
            return p_layer
        return _gather_tree(p_layer, axes_tree, ctx, skip_layers_dim=False,
                            compute_dtype=compute_dtype)
    return hook


class ShardPlan:
    """The per-leaf plan ``{name: {dim: mesh axes}}`` of a flat parameter
    dict on one mesh, and this rank's place in it.  Leaves absent from
    ``dims`` are replicated.  ``axes``: the axes a plan may shard, the
    manual ones and, for a storage plan (``for_storage``) on a mesh whose
    ``"model"`` axis is larger than 1, ``"model"``."""

    def __init__(self, ctx: ShardingCtx, dims: Dict[str, Dims], manual,
                 *, model: bool = False):
        self.mesh = ctx.mesh
        self.shape = ctx.shape
        self.dims = dims
        self.manual = tuple(manual)
        self.axes = self.manual + (("model",) if model else ())

    @classmethod
    def for_storage(cls, ctx: ShardingCtx, axes: Mapping[str, tuple],
                    shapes: Mapping[str, Tuple[int, ...]], manual):
        """The storage plan of a {name: logical axes} dict whose leaves
        have the global ``shapes``: each leaf's manual dims
        (``rule_manual_dims``) and, where the mesh's ``"model"`` axis is
        larger than 1, the dims the rules map to it that divide
        (``sharding_rules.model_dims``): ``repro``'s ``param_shardings``
        placement, given that the manual dims divide."""
        model = ctx.shape.get("model", 1) > 1
        dims = {}
        for name, ax in axes.items():
            d = dict(rule_manual_dims(ctx, ax, manual))
            for i, m in model_dims(ctx, ax, shapes[name]).items():
                d[i] = d.get(i, ()) + m
            if d:
                dims[name] = d
        return cls(ctx, dims, manual, model=model)

    def _place(self, axes) -> Tuple[int, int]:
        """(this rank's shard index, shard count) along ``axes``, major to
        minor."""
        index, count = 0, 1
        for a in axes:
            n = self.shape[a]
            index = index * n + self.mesh.get_local_rank(a)
            count *= n
        return index, count

    def local(self, name: str, full, lead: int = 0):
        """This rank's slice of ``full`` (a tensor or numpy array of leaf
        ``name``'s global shape, behind ``lead`` leading dims: 1 for a
        stack of layers); ``full`` itself if the leaf is replicated."""
        out = full
        for dim, axes in self.dims.get(name, {}).items():
            index, count = self._place(axes)
            size = out.shape[lead + dim] // count
            sl = [slice(None)] * out.ndim
            sl[lead + dim] = slice(index * size, (index + 1) * size)
            out = out[tuple(sl)]
        return out

    def shards(self, name: str, dim: int) -> int:
        """How many shards dim ``dim`` of leaf ``name`` is cut into."""
        n = 1
        for a in self.dims.get(name, {}).get(dim, ()):
            n *= self.shape[a]
        return n

    def local_shape(self, name: str, shape) -> Tuple[int, ...]:
        """The shape of this rank's shard of leaf ``name`` of global
        ``shape``."""
        return tuple(s // self.shards(name, i) for i, s in enumerate(shape))

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """Leaf ``name`` at its global shape, gathered from every rank's
        shard in its own dtype (no gradient)."""
        t = shard
        with torch.no_grad():
            for dim, axes in sorted(self.dims.get(name, {}).items()):
                for a in reversed(axes):
                    t = _all_gather(t, dim, self.mesh.get_group(a))
        return t

    def replication(self, name: str) -> int:
        """How many ranks hold each element of leaf ``name``: the sizes of
        the plan's axes (``axes``) that do not shard it."""
        used = {a for axes in self.dims.get(name, {}).values() for a in axes}
        rep = 1
        for a in self.axes:
            if a not in used:
                rep *= self.shape[a]
        return rep


def shard_tree(tree: Mapping[str, Any], plan: ShardPlan) -> Dict[str, Any]:
    """This rank's slice of each planned leaf of a flat {name: tensor}
    dict, made contiguous; unplanned leaves as they are."""
    return {k: (plan.local(k, v).contiguous() if k in plan.dims else v)
            for k, v in tree.items()}


def deferred_psum(grads: Dict[str, torch.Tensor], plan: ShardPlan, scale):
    """One-per-step DP gradient sync, in place.  Leaves with a
    manual-sharded dim were already summed over those axes by the gather's
    reduce-scatter; they (and everything else) still need the sum over the
    REMAINING manual axes (``"pod"`` when only ``"data"`` shards them).
    Every leaf is then multiplied by ``scale``."""
    for name, g in grads.items():
        used = {a for axes in plan.dims.get(name, {}).values() for a in axes}
        rest = tuple(a for a in plan.manual if a not in used)
        all_reduce(g, rest, plan.mesh)
        g.mul_(scale)
    return grads


def model_psum(grads: Dict[str, torch.Tensor], names, mesh):
    """The once-a-step sum over the ``"model"`` axis, in place, of the
    leaves ``names``: those stored whole that the model ranks used only in
    part (each rank holds the gradient of its slice of the work).  After
    it their gradients are whole and equal on every model rank; a leaf
    used whole on replicated inputs already was, and a leaf stored split
    holds its shard's complete gradient (its own part, or the
    reduce-scatter of ``gather_model``)."""
    for name in names:
        all_reduce(grads[name], ("model",), mesh)
    return grads
