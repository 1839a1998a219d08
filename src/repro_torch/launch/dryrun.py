"""Multi-pod dry-run on the H100: trace every (arch x shape x mesh) cell's
step for one rank, count what it computes, moves and holds, and write its
roofline terms.  The counterpart of ``repro/launch/dryrun.py``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, resumable
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

``repro`` lowers and compiles each cell for 512 fake host devices and reads
XLA's memory and cost analyses and HLO.  The port runs its own program
instead, and compiles nothing: rank 0 of the mesh's world joins a
``torch.distributed`` group on the ``"fake"`` backend (every collective
a no-op), the production mesh is built over it (``make_production_mesh(
device="cpu")``), the model's leaves are ``meta`` tensors of the rank's
shapes on its storage plan (``train_step.param_plan``), and the step runs
once on them: the ``dp_manual`` train step with AdamW, the prefill under
``_serve_wrap``, or one decode step under it, all inside a
``roofline.counter.Counter``.  The kernels take their shape functions and
count their ``roofline/costs.py`` formulas.  ``repro`` decodes on its pjit
path; the port's decode step runs under the serve wrapper too.  Where the
batch axes do not divide the batch (``long_500k``'s one row) ``repro``
serves on its pjit path, where GSPMD keeps the leaves and the cache's
``kv_seq`` sharded and replicates the batch dim; the port's wrapper then
hands every rank all the rows with the model still split
(``"serve_replicated"``).  Only where the wrapper does not apply at all
(no batch axes, or a planned dim that does not divide) does the rank
compute the call whole, with no rules (``"whole"``).

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with ``repro``'s keys: ``memory`` (``peak_per_device`` the rank's state
and batch bytes plus the counted peak), ``cost`` (counted FLOPs and
bytes), ``roofline`` (``analysis.RooflineReport``), ``fits_hbm_80g``; a
cell that fails is recorded with its error, as in ``repro``.  Nothing
here is a measured time.

``_serve_wrap``: ``repro`` wraps prefill and decode in a ``shard_map``
over the batch axes so that its manual paths (the expert-parallel MoE,
the vocab-sharded logits, attention split by heads, the per-layer bf16
gathers of the leaves ``SERVE_RULES_BIG`` shards over ``"data"``) are
taken while serving.  Here the wrapper cuts this rank's rows of the batch
(or, for a batch the batch axes do not divide, passes all of them) and
enters the same manual region around a call on them; inside it the
model's prefill and decode gather each layer's batch-sharded leaves
(``lm._serve_params``) and the layers take their part of the
model-sharded ones (``layers.work``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      applicable_shapes, get_config,
                                      list_configs)
from repro_torch.distributed import dp_shard
from repro_torch.models.module import map_specs
from repro_torch.models.lm import param_specs

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")
TRAIN_MANUAL_BATCH = ("pod", "data")


# ---------------------------------------------------------------------------
# per-arch knobs: repro's rules, kept as they are
# ---------------------------------------------------------------------------
def train_step_config(cfg: ModelConfig):
    """``repro``'s per-arch training knobs: 8 microbatches a rank (16
    above 50e9 parameters), remat "nothing" above 20e9 else "dots", the
    explicit data-parallel step."""
    from repro_torch.train.train_step import TrainStepConfig
    n = cfg.param_count()
    if n > 50e9:
        mb, remat = 16, "nothing"
    elif n > 20e9:
        mb, remat = 8, "nothing"
    else:
        mb, remat = 8, "dots"
    return TrainStepConfig(remat_policy=remat, microbatches=mb,
                           dp_manual=True)


def use_seq_parallel(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """``repro`` keeps its Megatron-style sequence-parallel rules off."""
    return False


def serve_params_dtype(t: torch.Tensor) -> torch.Tensor:
    """A leaf as ``repro`` serves it: an empty bf16 (meta) tensor of its
    shape where it is fp32, else itself."""
    if t.dtype == torch.float32:
        return torch.empty(t.shape, dtype=torch.bfloat16, device="meta")
    return t


def choose_kv_dtype(model, cfg: ModelConfig, shape: ShapeConfig,
                    chips: int):
    """fp8 KV-cache quantization when the bf16 cache would exceed ~7 GB per
    device (``repro``'s rule): the whole cache of the shape's batch and
    length (with the model's prefix), over ``chips``."""
    from repro_torch.models import stack as stk
    prefix = getattr(model, "prefix_len", None)
    if prefix is None:
        prefix = cfg.num_meta_tokens + cfg.num_patches \
            if cfg.family != "encdec" else 0
    shapes = stk.cache_shapes(cfg, shape.global_batch,
                              shape.seq_len + prefix)
    total = sum(torch.Size(s).numel() * d.itemsize
                for s, d in shapes.values())
    return torch.float8_e4m3fn if total / chips > 7e9 else torch.bfloat16


# ---------------------------------------------------------------------------
# sharding trees: the port's partition tuples
# ---------------------------------------------------------------------------
def _named_axes(cfg: ModelConfig):
    return dp_shard.named_axes(param_specs(cfg), cfg.num_layers,
                               cfg.encoder_layers)


def params_shardings(model, ctx) -> Dict[str, tuple]:
    """{parameter name: partition tuple} of the model's leaves at their
    global shapes (``ctx.partition_spec``); where a rank stores what, the
    storage plan says (``train_step.param_plan``)."""
    from repro_torch.train.train_step import param_shapes
    cfg = model.cfg if hasattr(model, "cfg") else model
    shapes = param_shapes(cfg)
    return {k: ctx.partition_spec(ax, shapes[k])
            for k, ax in _named_axes(cfg).items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """{name: (global shape, dtype)} of a cell's batch, as ``repro``'s
    ``model.input_specs``."""
    from repro_torch.models import layers as ll
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32), "positions": ((B,), i32)}
    text = S - cfg.num_patches if cfg.num_patches else S
    d = {"tokens": ((B, text), i32)}
    if shape.kind == "train":
        d["targets"] = ((B, text), i32)
        d["loss_mask"] = ((B, text), torch.float32)
    if cfg.num_patches:
        d["patch_embeds"] = ((B, cfg.num_patches, cfg.patch_embed_dim),
                             ll.COMPUTE_DTYPE)
    if cfg.encoder_layers:
        d["frames"] = ((B, cfg.max_source_positions, cfg.d_model),
                       ll.COMPUTE_DTYPE)
    return d


def batch_shardings(specs: Dict, ctx) -> Dict[str, tuple]:
    """Each batch leaf's partition tuple: its rows over ``"batch"``."""
    return {k: ctx.partition_spec(("batch",) + (None,) * (len(s) - 1), s)
            for k, (s, _) in specs.items()}


CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", None, None),
    "v": ("layers", "batch", "kv_seq", None, None),
    "cross_k": ("layers", "batch", "kv_seq", None, None),
    "cross_v": ("layers", "batch", "kv_seq", None, None),
    "ssm_conv": ("layers", "batch", None, "ssm_inner"),
    "ssm_state": ("layers", "batch", "ssm_heads", None, None),
}


def cache_shardings(cache_shapes, ctx) -> Dict[str, tuple]:
    """{leaf: partition tuple} of a cache given as {leaf: (shape, dtype)}
    (``stack.cache_shapes``) or {leaf: tensor}."""
    def shape_of(v):
        return tuple(v[0]) if isinstance(v, tuple) else tuple(v.shape)
    return {k: ctx.partition_spec(CACHE_AXES[k], shape_of(v))
            for k, v in cache_shapes.items()}


def opt_state_shardings(model, ctx):
    """The AdamW state's partition tuples: the moments as the parameters,
    the step count replicated."""
    from repro_torch.train.optimizer import AdamWState
    p = params_shardings(model, ctx)
    return AdamWState(step=(), mu=p, nu=p)


# ---------------------------------------------------------------------------
# the serve wrapper
# ---------------------------------------------------------------------------
def serve_path(mesh, batch_rows: int) -> str:
    """The path ``_serve_wrap`` takes for a global batch of ``batch_rows``
    rows on ``mesh``: ``"serve_wrap"`` where the batch axes divide it
    (each rank its rows), else ``"serve_replicated"`` (every rank all of
    them, ``repro``'s pjit path with the batch dim replicated)."""
    return "serve_wrap" if batch_rows % dp_shard.manual_size(mesh) == 0 \
        else "serve_replicated"


def _serve_wrap(model, ctx, fn):
    """``fn(batch, cache)`` (``model``'s ``prefill``, or a decode step)
    wrapped to run inside ``ctx.manual_region`` of the mesh's batch axes,
    or None where ``repro`` returns None: no batch axes, or a planned dim
    that does not divide.  The wrapped function takes the global batch and
    this rank's cache as it is, and returns ``fn``'s result for the rows
    it passed:

    * where the batch axes divide the batch (``"serve_wrap"``) it passes
      ``fn`` this rank's rows (``dp_shard.local_rows``), and the cache
      holds those rows;
    * else (``"serve_replicated"``, as ``long_500k``'s one row) every rank
      passes ``fn`` all the rows and the cache holds all of them, as
      ``repro``'s pjit path replicates a batch dim the guard drops: the
      data ranks compute the same rows and each returns the whole batch's
      result.  Nothing is padded: an expert's capacity counts every row's
      tokens, as on that path.

    On both paths the model stays split over ``"model"`` (the manual region
    of the batch axes), and where the rules cut the cache's K/V slots over
    the model ranks (``kv_seq``, made by ``init_cache`` under them) it
    holds this rank's block of the slots.  The function's ``path`` says
    which path its last call took (None before the first).

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
        wrapped.path = serve_path(mesh, batch["tokens"].shape[0])
        if wrapped.path == "serve_wrap":
            batch = dp_shard.local_rows(mesh, batch)
        with ctx.manual_region(set(manual)):
            return fn(batch, cache)

    wrapped.path = None
    return wrapped


# ---------------------------------------------------------------------------
# meta models, states and batches
# ---------------------------------------------------------------------------
def meta_params(cfg: ModelConfig, plan=None):
    """``cfg``'s parameters in the spec tree's layout as empty fp32 meta
    tensors, each this rank's shard under ``plan`` (a stacked leaf the
    stack of its layers' shards)."""
    from repro_torch.models.lm import _shard_leaf

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        full = torch.empty(node.shape, device="meta")
        return full if plan is None else _shard_leaf(plan, path, full)

    return walk(param_specs(cfg), ())


def meta_model(cfg: ModelConfig, *, plan=None, trainable: bool = False,
               device="meta", seed: int = 0):
    """A model of meta leaves (``build_model`` on ``meta_params``), or on
    another ``device`` drawn from ``seed`` (the CPU twin of a trace)."""
    from repro_torch.models.lm import build_model, init_sharded_params
    from repro_torch.models.module import init_params
    if torch.device(device).type == "meta":
        params = meta_params(cfg, plan)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_sharded_params(cfg, gen, plan) if plan is not None \
            else init_params(param_specs(cfg), gen)
    return build_model(cfg, params, device=device, trainable=trainable,
                       plan=plan)


def meta_batch(specs: Dict, rows: Optional[int] = None, device="meta",
               vocab: int = 2, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Tensors of ``input_specs``' shapes (``rows`` rows each, if given):
    empty on meta, else drawn from ``seed`` on ``device`` (ids below
    ``vocab``, positions at the cache's last slot, masks of ones)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, (s, d) in specs.items():
        s = ((rows,) + tuple(s[1:])) if rows is not None else tuple(s)
        if torch.device(device).type == "meta":
            out[k] = torch.empty(s, dtype=d, device=device)
        elif k in ("tokens", "targets"):
            out[k] = torch.randint(0, vocab, s, generator=gen,
                                   dtype=d).to(device)
        elif k == "loss_mask":
            out[k] = torch.ones(s, dtype=d, device=device)
        elif k == "positions":
            out[k] = torch.full(s, vocab, dtype=d, device=device)
        else:
            out[k] = torch.randn(s, generator=gen).to(device=device, dtype=d)
    return out


def state_names(state) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a train state's parameters and moments, which
    name an op's scope in the counter."""
    names = dict(state.params)
    names.update({f"{k}.mu": v for k, v in state.opt.mu.items()})
    names.update({f"{k}.nu": v for k, v in state.opt.nu.items()})
    return names


def _bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def count_train(cfg: ModelConfig, scfg, B: int, S: int, *, ctx=None,
                device="meta", specs=None):
    """One train step of ``cfg`` on meta, counted: the state on ``ctx``'s
    storage plan (whole without ``ctx``), a batch of ``B`` rows of ``S``
    tokens (this rank's rows under ``ctx``'s batch axes).  Returns
    (counter, {"params", "opt", "batch": bytes}, the step's path).  On
    another ``device`` the same step runs on seeded values.  ``specs``
    ({name: (shape, dtype)}) replaces the batch's ``input_specs``."""
    from repro_torch.roofline.counter import Counter
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, param_plan)
    plan = None
    if ctx is not None and scfg.dp_manual:
        manual = dp_shard.manual_axes(ctx.mesh)
        pspecs = param_specs(cfg)
        if manual and dp_shard.validate_manual_divisibility(
                ctx, map_specs(lambda s: s.axes, pspecs), pspecs, manual):
            plan = param_plan(cfg, ctx)
    model = meta_model(cfg, plan=plan, trainable=True, device=device)
    state = init_train_state(model, None, scfg, device=device)
    step = make_train_step(model, scfg)
    specs = specs or input_specs(cfg, ShapeConfig("cell", S, B, "train"))
    batch = meta_batch(specs, device=device, vocab=cfg.vocab_size)
    held = {"params": _bytes(state.params.values()),
            "opt": _bytes(list(state.opt.mu.values())
                          + list(state.opt.nu.values())),
            "batch": _bytes(batch.values())}
    with Counter(state_names(state)) as c:
        step(state, batch)
    return c, held, step.path


def count_serve(cfg: ModelConfig, kind: str, B: int, S: int, *, ctx=None,
                kv_dtype=torch.bfloat16, device="meta", specs=None,
                cache_len: Optional[int] = None):
    """A prefill of ``B`` x ``S`` (``kind`` "prefill") or one decode step
    of ``B`` rows over a cache of ``S`` positions (``kind`` "decode") of
    ``cfg`` on meta, counted.  Under ``ctx`` it runs through
    ``_serve_wrap`` wherever the wrapper applies: the model on the storage
    plan, ``B`` the global batch, the cache made under the rules (so
    ``kv_seq`` and the SSM heads cut it) for this rank's rows, B / R where
    the R batch shards divide B and all B where they do not; else whole,
    with no rules.  Returns (counter, {"params", "cache", "batch": bytes},
    the path: ``_serve_wrap``'s ``"serve_wrap"`` or
    ``"serve_replicated"``, or ``"whole"``).  On another ``device`` the
    same call runs on seeded values.  ``specs`` replaces the batch's
    ``input_specs``; ``cache_len`` the cache's positions (``S``)."""
    from repro_torch.roofline.counter import Counter
    from repro_torch.train.train_step import param_plan
    sharded = ctx is not None and bool(dp_shard.manual_axes(ctx.mesh))
    model = meta_model(cfg, plan=param_plan(cfg, ctx) if sharded else None,
                       device=device)
    specs = specs or input_specs(cfg, ShapeConfig("cell", S, B, kind))
    batch = meta_batch(specs, device=device, vocab=cfg.vocab_size
                       if kind == "prefill" else S - 1)
    if kind == "prefill":
        def fn(b, cache):
            return model.prefill(b, cache)
    else:
        def fn(b, cache):
            return model.decode_step(cache, b["tokens"], b["positions"])
    wrapped = _serve_wrap(model, ctx, fn) if sharded else None
    if wrapped is None:
        path, rows = "whole", B
        if model.plan is not None:
            model = meta_model(cfg, device=device)
    else:
        path = serve_path(ctx.mesh, B)
        rows = B // dp_shard.manual_size(ctx.mesh) \
            if path == "serve_wrap" else B
    # unwrapped, the rank computes the whole call: no rules cut its cache
    with contextlib.nullcontext() if wrapped is not None else _no_rules():
        cache = model.init_cache(rows, cache_len or S, kv_dtype=kv_dtype)
        held = {"params": _bytes(model.parameters()),
                "cache": _bytes(cache.values()),
                "batch": _bytes(meta_batch(specs, rows).values())}
        with Counter(dict(model.named_parameters())) as c:
            (wrapped or fn)(batch, cache)
    return c, held, path


@contextlib.contextmanager
def _no_rules():
    """No ``use_rules`` context inside: the port's tensors whole."""
    from repro_torch.distributed import sharding_rules
    token = sharding_rules._ACTIVE.set(None)
    try:
        yield
    finally:
        sharding_rules._ACTIVE.reset(token)


# ---------------------------------------------------------------------------
# cell lowering
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_group(world: int):
    """Rank 0 of a ``world``-rank process group on torch.distributed's
    ``"fake"`` backend (its collectives complete at once and move
    nothing), destroyed on leaving.  Raises where the backend is missing
    or a group is already initialised: the dry-run never falls back."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run traces rank 0 of a fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def lower_cell(arch: str, shape: ShapeConfig, mesh, mesh_name: str, *,
               cfg: Optional[ModelConfig] = None,
               with_counter: bool = False):
    """Trace rank 0's step of the cell on meta over ``mesh`` (a
    ``DeviceMesh`` of the initialised group) and return the artifact dict
    (and the counter, ``with_counter``).  ``cfg`` replaces the arch's
    config (a reduced one, in tests)."""
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch.mesh import mesh_chips
    from repro_torch.models import layers as ll
    from repro_torch.roofline.analysis import HBM_BYTES, build_report
    cfg = cfg or get_config(arch)
    chips = mesh_chips(mesh)
    rules = rules_for(shape.kind, seq_parallel=use_seq_parallel(cfg, shape),
                      big_params=cfg.param_count() > 20e9)
    t0 = time.perf_counter()
    with use_rules(mesh, rules) as ctx:
        if shape.kind == "train":
            scfg = train_step_config(cfg)
            R = dp_shard.manual_size(mesh)
            counter, held, path = count_train(
                cfg, scfg, shape.global_batch // R, shape.seq_len, ctx=ctx)
        else:
            kv_dtype = choose_kv_dtype(None, cfg, shape, chips)
            counter, held, path = count_serve(
                cfg, shape.kind, shape.global_batch, shape.seq_len, ctx=ctx,
                kv_dtype=kv_dtype)
            held["kv_dtype"] = str(kv_dtype).replace("torch.", "")
    trace_s = time.perf_counter() - t0
    dtype = str(ll.COMPUTE_DTYPE).replace("torch.", "")
    report = build_report(arch=arch, shape=shape, mesh_name=mesh_name,
                          chips=chips, counter=counter, cfg=cfg,
                          compute_dtype=dtype)
    args = sum(v for k, v in held.items() if isinstance(v, int))
    out = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "path": path,
        "lower_s": round(trace_s, 2),
        "dropped_shardings": [list(map(str, d)) for d in ctx.dropped[:20]],
        "ok": True,
        "memory": {
            "argument_bytes": args,
            "output_bytes": 0,
            "temp_bytes": int(counter.peak),
            "alias_bytes": 0,
            "peak_per_device": int(args + counter.peak),
            **{f"{k}_bytes" if isinstance(v, int) else k: v
               for k, v in held.items()},
        },
        "cost": {"flops": counter.flops, "bytes_accessed": counter.traffic},
        "kernels": counter.summary()["kernels"],
        "roofline": report.to_dict(),
    }
    out["fits_hbm_80g"] = out["memory"]["peak_per_device"] < HBM_BYTES
    return (out, counter) if with_counter else out


def cell_path(arch: str, shape_name: str, mesh_name: str) -> str:
    os.makedirs(ARTIFACTS, exist_ok=True)
    return os.path.join(ARTIFACTS, f"{arch}__{shape_name}__{mesh_name}.json")


def trace_cell(arch: str, shape_name: str, mesh_name: str, *,
               cfg: Optional[ModelConfig] = None, with_counter=False):
    """``lower_cell`` of one cell on its production mesh, under a fake
    group of the mesh's world size that is destroyed before returning."""
    from repro_torch.launch.mesh import make_production_mesh
    multi = mesh_name == "multi"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        return lower_cell(arch, SHAPES[shape_name], mesh, mesh_name,
                          cfg=cfg, with_counter=with_counter)


def run_cell(arch: str, shape_name: str, mesh_name: str,
             *, force: bool = False) -> dict:
    path = cell_path(arch, shape_name, mesh_name)
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    try:
        out = trace_cell(arch, shape_name, mesh_name)
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        out = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def all_cells():
    for arch in list_configs():
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            for mesh_name in ("single", "multi"):
                yield arch, shape.name, mesh_name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        for c in all_cells():
            print("/".join(c))
        return 0

    if args.all:
        failures = 0
        for arch, shape_name, mesh_name in all_cells():
            out = run_cell(arch, shape_name, mesh_name, force=args.force)
            status = "OK " if out.get("ok") else "FAIL"
            extra = ""
            if out.get("ok") and "memory" in out:
                extra = (f" peak/dev={out['memory']['peak_per_device']/2**30:.2f}GiB"
                         f" dominant={out['roofline']['dominant']}")
            else:
                extra = f" {out.get('error', '')[:200]}"
            print(f"[{status}] {arch} x {shape_name} x {mesh_name}{extra}",
                  flush=True)
            failures += 0 if out.get("ok") else 1
        return 1 if failures else 0

    assert args.arch and args.shape, "--arch and --shape (or --all)"
    out = run_cell(args.arch, args.shape, args.mesh, force=args.force)
    print(json.dumps({k: v for k, v in out.items() if k != "traceback"},
                     indent=1))
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
