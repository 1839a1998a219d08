"""Logical-axis -> mesh-axis sharding rules (MaxText-style), with the
divisibility guard of ``repro/distributed/sharding_rules.py``.

Parameters and activations are annotated with *logical* axis names; a rule
set maps those to mesh axes.  ``ShardingCtx.partition_spec`` drops any mesh
axis that does not evenly divide its dimension and records the drop in
``dropped``; a dropped axis means replication, which is always correct.

The rule dicts are ``repro``'s, verbatim.  A partition spec here is a tuple
with one entry per dimension (``None``, one mesh axis name, or a tuple of
them), trailing ``None``s dropped, as ``jax.sharding.PartitionSpec`` holds
them.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or any
object whose ``shape`` maps axis names to sizes (``mesh_shape``).

The port's tensors are local: ``constrain`` is the identity (a rule never
moves data here; the data-parallel step in ``dp_shard`` shards and gathers
explicitly).  A leaf is stored as ``repro``'s ``param_shardings`` places
it: ``storage_dims`` gives the dims that the rules map to the batch axes
and to ``"model"``, with the guard, and each rank holds its shard of them
(``dp_shard.ShardPlan``).  Inside the manual region of the batch axes the
layers split attention heads, d_ff, virtual experts and vocabulary rows
over the model ranks (``model_axis``) and compute with their part of each
leaf (``model_storage``).  ``model_group`` / ``model_rank`` /
``model_size`` read the axis off a mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
PartitionSpec = Tuple[MeshAxes, ...]

# --- rule sets -------------------------------------------------------------
# batch-like axes shard over ("pod","data") when the pod axis exists; the
# helper filters mesh axes that are absent from the mesh, so one rule set
# serves single-pod and multi-pod meshes.

TRAIN_RULES: Dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": "model",        # residual stream between layers (manual-SP:
                               # stack.run_stack gathers before attention/MLP
                               # and reduce-scatters their outputs)
    "kv_seq": None,
    "qkv": "model",            # flattened heads*head_dim activation dim
    "heads_act": "model",      # per-head activation dim (guarded: replicates
    "kv_heads_act": "model",   # when head count doesn't divide the axis)
    "mlp_act": "model",
    "embed_act": None,
    "vocab_act": "model",
    "experts_act": None,
    "moe_cap": ("pod", "data"),    # MoE dispatch capacity slots (DP-sharded)
    "ssm_inner_act": "model",
    # params
    "vocab": "model",
    "embed": "data",           # FSDP: gather-per-layer under scan
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": None,
    "experts_virt": "model",   # virtual EP layout (E<16 archs; see layers.moe)
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "pos": None,
}

# Megatron-style sequence parallelism for the residual stream: norms/embeds
# run on seq-sharded activations; enabled for long-sequence training cells.
TRAIN_SP_RULES = dict(TRAIN_RULES, seq="model")

# Serving: weight-stationary sharding — params replicated over the batch
# axes (no optimizer state to amortize; per-step FSDP gathers would
# dominate decode latency) and TP over model; batch over data; KV-cache
# *sequence* dim over model (flash-decoding style partial softmax —
# kv-head counts don't divide 16, seq always does).
SERVE_RULES: Dict[str, MeshAxes] = dict(
    TRAIN_RULES,
    batch=("pod", "data"),
    kv_seq="model",
    embed=None,
    seq_res=None,
    vocab="model",
)

# >20B params: bf16 weights / 16-way TP crowd device memory next to the KV
# cache, so serving keeps the FSDP data-axis sharding and pays per-layer
# bf16 gathers.
SERVE_RULES_BIG = dict(SERVE_RULES, embed="data")

# Long-context prefill: shard the sequence dimension as well.
PREFILL_RULES = dict(SERVE_RULES, seq=None)
PREFILL_RULES_BIG = dict(SERVE_RULES_BIG, seq=None)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                         default=None)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh whose ``shape``
    is already such a mapping."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class ShardingCtx:
    def __init__(self, mesh, rules: Dict[str, MeshAxes]):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        self.rules = dict(rules)
        self.dropped: list = []
        # mesh axes currently under manual control (the data-parallel
        # step's region): partition_spec must not mention them (the dims
        # they shard are already local inside the region)
        self.manual: frozenset = frozenset()

    @contextlib.contextmanager
    def manual_region(self, axes):
        prev = self.manual
        self.manual = frozenset(axes) | prev
        try:
            yield self
        finally:
            self.manual = prev

    def mesh_axes_for(self, logical: Optional[str],
                      *, include_manual: bool = False) -> Tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.rules.get(logical)
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        out = tuple(a for a in axes if a in self.shape)
        if not include_manual:
            out = tuple(a for a in out if a not in self.manual)
        return out

    def partition_spec(self, logical_axes: Sequence[Optional[str]],
                       dims: Optional[Sequence[int]] = None) -> PartitionSpec:
        """Map logical axes to a partition spec; drop non-dividing mesh
        axes (recorded in ``dropped``)."""
        entries = []
        used = set()
        for i, name in enumerate(logical_axes):
            axes = self.mesh_axes_for(name)
            axes = tuple(a for a in axes if a not in used)
            if dims is not None and axes:
                shards = 1
                kept = []
                for a in axes:
                    n = self.shape[a]
                    if dims[i] % (shards * n) == 0:
                        kept.append(a)
                        shards *= n
                    else:
                        self.dropped.append((name, a, dims[i]))
                axes = tuple(kept)
            used.update(axes)
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(axes)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, MeshAxes]):
    ctx = ShardingCtx(mesh, rules)
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)


def current_ctx() -> Optional[ShardingCtx]:
    return _ACTIVE.get()


def constrain(x, *logical_axes: Optional[str]):
    """The identity on the port's local tensors (``repro``'s
    ``with_sharding_constraint``); checks the annotation's rank."""
    if len(logical_axes) != x.ndim:
        raise ValueError(f"constrain rank mismatch: {logical_axes} vs "
                         f"{tuple(x.shape)}")
    return x


def model_size(mesh) -> int:
    """Size of the mesh's ``"model"`` axis (1 where it has none)."""
    return mesh_shape(mesh).get("model", 1)


def model_rank(mesh) -> int:
    """This rank's index along the mesh's ``"model"`` axis."""
    return mesh.get_local_rank("model") if model_size(mesh) > 1 else 0


def model_group(mesh):
    """The process group of this rank's ``"model"`` axis (a
    ``DeviceMesh``)."""
    return mesh["model"].get_group()


def _is_axes_leaf(t) -> bool:
    return isinstance(t, tuple) and all(a is None or isinstance(a, str)
                                        for a in t)


def param_shardings(specs_logical_axes, abstract, mesh,
                    rules: Dict[str, MeshAxes]):
    """Partition-spec tree for a param tree given its logical-axes tree
    (nested dicts; ``abstract``'s leaves have a ``shape``)."""
    ctx = ShardingCtx(mesh, rules)

    def walk(axes, ab):
        if _is_axes_leaf(axes):
            return ctx.partition_spec(axes, tuple(ab.shape))
        return {k: walk(axes[k], ab[k]) for k in axes}

    return walk(specs_logical_axes, abstract)


def storage_dims(ctx: ShardingCtx, logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Dict[int, Tuple[str, ...]]:
    """{dim: mesh axes} of a leaf's storage: ``partition_spec`` of its
    logical axes and global ``shape`` under ``ctx``'s rules, with the
    divisibility guard, over every mesh axis (the batch axes and
    ``"model"``) whatever region ``ctx`` is in.  A dim the guard drops is
    absent: every rank holds it whole."""
    spec = ShardingCtx(ctx.mesh, ctx.rules).partition_spec(logical_axes,
                                                           tuple(shape))
    return {i: (e,) if isinstance(e, str) else tuple(e)
            for i, e in enumerate(spec) if e is not None}


def model_dims(ctx: ShardingCtx, logical_axes: Sequence[Optional[str]],
               shape: Sequence[int]) -> Dict[int, Tuple[str, ...]]:
    """The dims of ``storage_dims`` that ``"model"`` shards, where the mesh
    has a ``"model"`` axis larger than 1."""
    if ctx.shape.get("model", 1) <= 1:
        return {}
    return {i: ("model",) for i, axes in storage_dims(
        ctx, logical_axes, shape).items() if "model" in axes}


def rules_for(kind: str, *, seq_parallel: bool = False,
              big_params: bool = False) -> Dict[str, MeshAxes]:
    if kind == "train":
        return TRAIN_SP_RULES if seq_parallel else TRAIN_RULES
    if kind == "prefill":
        return PREFILL_RULES_BIG if big_params else PREFILL_RULES
    if kind == "decode":
        return SERVE_RULES_BIG if big_params else SERVE_RULES
    raise ValueError(kind)
