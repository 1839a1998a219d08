"""One rank of the port's model-axis CPU tests
(``tests/test_torch_model_axis.py``, ``tests/test_torch_model_storage.py``,
``tests/test_torch_seq_axis.py``, ``tests/test_torch_ssm_axis.py``,
``tests/test_torch_vlm_axis.py``, ``tests/test_torch_encdec_axis.py``,
``tests/test_torch_solo_serve.py``).

Run by ``_torch_support.spawn_ranks(..., module="_torch_tp_ranks")`` as

    python -c "import _torch_tp_ranks as r; r.main()" WORKDIR MESH RANK JOBS

with ``tests`` and ``src`` on the path.  MESH is a tag of ``MESHES``
(``"1x2"``: data 1, model 2).  The rank joins a gloo group of the mesh's
size through a ``FileStore`` in WORKDIR, runs each job named in the
comma-separated JOBS in turn and writes each job's result to
``WORKDIR/res_<job>_w<MESH>_r<RANK>.pkl``; the inputs come from
``WORKDIR/inputs.pkl``.  This module imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

# (mesh shape, axis names) of each mesh the tests run
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def make_mesh(tag: str):
    shape, names = MESHES[tag]
    if names == ("data", "model"):
        from repro_torch.launch.mesh import make_local_mesh
        return make_local_mesh(model_axis=shape[1], device="cpu")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def port_config(arch: str, overrides):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def _tensors(tree, grad=True):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _sum_partial(grads, names, mesh):
    """The once-a-step sum over the model ranks of the leaves ``names``."""
    from repro_torch.distributed import dp_shard
    dp_shard.model_psum(grads, names, mesh)
    return grads


def job_pieces(inp, tag, rank, workdir):
    """Attention, the vocab-split cross-entropy, the expert-parallel MoE
    and ``ring_weight_matmul`` at this mesh's model axis: outputs and
    gradients, the partial ones summed over the model ranks."""
    from repro_torch.distributed import model_axis
    from repro_torch.distributed.collective_matmul import ring_weight_matmul
    from repro_torch.distributed.sharding_rules import (model_rank,
                                                        model_size,
                                                        rules_for, use_rules)
    from repro_torch.models import layers as ll
    mesh = make_mesh(tag)
    n = model_size(mesh)
    out = {}
    with use_rules(mesh, rules_for("train")) as ctx, \
            ctx.manual_region(("data",)):
        for name, c in inp["attn"].items():
            if n not in c["worlds"]:
                continue
            cfg = port_config(c["arch"], c["overrides"])
            p = _tensors(c["params"])
            x = torch.tensor(c["x"], requires_grad=True)
            B, S, _ = x.shape
            pos = torch.arange(S)[None].expand(B, S)
            y, _, _ = ll.attention(p, cfg, x, positions=pos)
            y.backward(torch.from_numpy(c["dy"]))
            grads = {k: v.grad for k, v in p.items()}
            _sum_partial(grads, list(grads), mesh)
            out["attn", name] = dict(
                y=y.detach().numpy(), dx=x.grad.numpy(),
                grads={k: v.numpy() for k, v in grads.items()},
                heads=ll.rank_heads(cfg, n, model_rank(mesh)))
        for name, c in inp["xent"].items():
            cfg = port_config("qwen2-0.5b", c["overrides"])
            p = _tensors({"tokens": c["table"]})
            x = torch.tensor(c["x"], requires_grad=True)
            ce, denom = ll.unembed_xent(p, cfg, x,
                                        torch.from_numpy(c["targets"]),
                                        torch.from_numpy(c["mask"]))
            ce.backward()
            grads = {"tokens": p["tokens"].grad}
            _sum_partial(grads, ["tokens"], mesh)
            out["xent", name] = dict(ce=float(ce), denom=float(denom),
                                     dx=x.grad.numpy(),
                                     dtable=grads["tokens"].numpy())
        for name, c in inp["moe"].items():
            if n not in c["worlds"]:
                continue
            cfg = port_config("granite-moe-3b-a800m", c["overrides"])
            p = _tensors(c["params"])
            x = torch.tensor(c["x"], requires_grad=True)
            model_axis.collectives.clear()
            y, aux = ll.moe(p, cfg, x)
            counts = dict(model_axis.collectives)
            ((y * torch.from_numpy(c["dy"])).sum() + c["aux_weight"] * aux
             ).backward()
            grads = {k: v.grad for k, v in p.items()}
            _sum_partial(grads, ["wi", "wg", "wo"], mesh)
            out["moe", name] = dict(
                y=y.detach().numpy(), aux=float(aux), dx=x.grad.numpy(),
                grads={k: v.numpy() for k, v in grads.items()},
                forward_collectives=counts)
    if n in inp["ring"]["worlds"]:
        x, w = inp["ring"]["x"], inp["ring"]["w"]
        r = model_rank(mesh)
        m, f = x.shape[0] // n, w.shape[1] // n
        model_axis.collectives.clear()
        got = ring_weight_matmul(torch.from_numpy(x[r * m:(r + 1) * m]),
                                 torch.from_numpy(w[:, r * f:(r + 1) * f]),
                                 mesh)
        out["ring"] = dict(rows=got.numpy(),
                           send_recv=model_axis.collectives["send_recv"])
    return out


def _port_state(arch, overrides, tree, tcfg):
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import init_train_state
    from _torch_dp_ranks import unflatten
    cfg = port_config(arch, overrides)
    model = from_jax_params(cfg, unflatten(tree), device="cpu",
                            trainable=True)
    return init_train_state(model, None, tcfg, device="cpu")


def _differ_over_model(grads, mesh):
    """The leaves whose gradient is not equal on every model rank."""
    group = mesh.get_group("model")
    n = dist.get_world_size(group)
    out = []
    for k, g in grads.items():
        got = [torch.empty_like(g) for _ in range(n)]
        dist.all_gather(got, g.contiguous(), group=group)
        if any(not torch.equal(got[0], t) for t in got[1:]):
            out.append(k)
    return out


@contextlib.contextmanager
def _env(run):
    """``REPRO_MOE_EP=0`` for a run tagged ``"ep_off"``."""
    if "ep_off" not in run[2:]:
        yield
        return
    os.environ["REPRO_MOE_EP"] = "0"
    try:
        yield
    finally:
        del os.environ["REPRO_MOE_EP"]


def job_step(inp, tag, rank, workdir):
    """The data-parallel step of each run of this mesh (on
    ``batch_unsplit`` for a run tagged ``"unsplit"``): every leaf at its
    global shape after one step, AdamW's first moment, loss, grad norm,
    the sequence split, the collectives, the partial leaves, and the
    leaves the step summed over the model ranks beside those whose
    gradient differed across them before that sum.  The first run's state
    is then saved (``ck_<tag>``)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import dp_shard, model_axis, transport
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import layers as ll
    from repro_torch.models.lm import param_specs
    from repro_torch.models import stack as stk
    from repro_torch.train.train_step import (make_train_step,
                                              shard_train_state)
    mesh = make_mesh(tag)
    out, first = {}, None
    real_sum = dp_shard.model_psum
    for run in inp["step_runs"][tag]:
        name, mb = run[:2]
        c = inp["step_archs"][name]
        tcfg = dataclasses.replace(inp["step_config"], microbatches=mb)
        state = _port_state(c["arch"], c["overrides"], c["tree"], tcfg)
        key = "batch_unsplit" if "unsplit" in run[2:] else "batch"
        batch = {k: torch.from_numpy(v) for k, v in c[key].items()}
        seen = {}

        def spy(grads, names, mesh_):
            seen["summed"] = list(names)
            seen["differ"] = _differ_over_model(grads, mesh_)
            return real_sum(grads, names, mesh_)

        with use_rules(mesh, rules_for("train")) as ctx, _env(run):
            state = shard_train_state(state, ctx)
            step = make_train_step(state.model, tcfg)
            local = dp_shard.local_rows(mesh, batch)
            with ctx.manual_region(dp_shard.manual_axes(mesh)):
                split = stk.sp_split(state.model.cfg,
                                     batch["tokens"].shape[1])
                partial = ll.model_partial_leaves(
                    state.model.cfg, param_specs(state.model.cfg),
                    state.params, split)
            dp_shard.collectives.clear()
            model_axis.collectives.clear()
            transport.moved.clear()
            dp_shard.model_psum = spy
            try:
                state, m = step(state, local)
            finally:
                dp_shard.model_psum = real_sum
            counts = dict(collectives=dict(dp_shard.collectives),
                          model_collectives=dict(model_axis.collectives),
                          moved=dict(transport.moved))
            plan = state.plan
            out[run] = dict(
                path=step.path, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]),
                params={k: plan.full(k, p.detach()).numpy()
                        for k, p in state.params.items()},
                mu={k: plan.full(k, v).numpy()
                    for k, v in state.opt.mu.items()},
                plan=dict(plan.dims), partial=partial,
                sp=None if split is None else split.size, **counts, **seen)
        if first is None:
            first = state
    Checkpointer(os.path.join(workdir, f"ck_{tag}")).save(
        1, first, aux={"mesh": tag}, block=True)
    return out


def job_restore(inp, tag, rank, workdir):
    """Restore the other mesh's checkpoint into a sharded template of the
    first run's arch on this mesh: every leaf gathered back."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.convert import to_jax_named
    from repro_torch.train.train_step import shard_train_state
    mesh = make_mesh(tag)
    name, mb = inp["step_runs"][tag][0][:2]
    c = inp["step_archs"][name]
    tcfg = dataclasses.replace(inp["step_config"], microbatches=mb)
    state = _port_state(c["arch"], c["overrides"], c["tree"], tcfg)
    src = inp["restore_from"][tag]
    with use_rules(mesh, rules_for("train")) as ctx:
        state = shard_train_state(state, ctx)
        state, aux = Checkpointer(os.path.join(workdir, f"ck_{src}")).restore(
            state, shardings=state.plan)
        named = to_jax_named(state)
    return dict(named=named, aux=aux)


def job_serve(inp, tag, rank, workdir):
    """Prefill and one decode step of reduced granite through
    ``_serve_wrap`` on the global batch: the logits of this rank's
    rows."""
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch.dryrun import _serve_wrap
    from repro_torch.models.convert import from_jax_params
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    c = inp["serve"]
    cfg = port_config(c["arch"], {})
    model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu")
    tokens = torch.from_numpy(c["tokens"])
    B, S = tokens.shape
    B //= dp_shard.manual_size(mesh)        # this rank's rows
    with use_rules(mesh, rules_for("prefill")) as ctx:
        prefill = _serve_wrap(model, ctx, model.prefill)
        logits, cache = prefill({"tokens": tokens},
                                model.init_cache(B, S + 4))
    with use_rules(mesh, rules_for("decode")) as ctx:
        decode = _serve_wrap(model, ctx,
                             lambda b, cache: model.decode_step(
                                 cache, b["tokens"], b["positions"]))
        dec, _ = decode({"tokens": tokens[:, :1],
                         "positions": torch.full((len(tokens),), S)}, cache)
    return dict(prefill=logits.float().numpy(), decode=dec.float().numpy())


def _held_bytes(state) -> int:
    """The bytes of every tensor a train state holds: parameters, AdamW
    moments, error feedback."""
    trees = [state.params, state.opt.mu, state.opt.nu] + (
        [state.err] if state.err is not None else [])
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree.values())


def job_storage_step(inp, tag, rank, workdir):
    """The ``dp_manual`` step of each storage run of this mesh on a state
    built on the storage plan from ``repro``'s parameters: the shapes and
    bytes it holds, every leaf gathered after the step, the first moments,
    loss, grad norm, the gathers over ``"model"`` by leaf kind, the leaves
    summed over the model ranks.  The first run's state is saved
    (``cks_<tag>``)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import dp_shard, model_axis, transport
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import layers as ll
    from repro_torch.models.lm import param_specs
    from repro_torch.models import stack as stk
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, param_plan)
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out, first = {}, None
    for run in inp["storage_runs"][tag]:
        name, remat, compress, mb = run
        c = inp["storage_archs"][name]
        tcfg = dataclasses.replace(inp["step_config"], remat_policy=remat,
                                   compress_grads=compress, microbatches=mb)
        cfg = port_config(c["arch"], c["overrides"])
        batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
        with use_rules(mesh, rules_for("train")) as ctx:
            plan = param_plan(cfg, ctx)
            model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                    trainable=True, plan=plan)
            state = init_train_state(model, None, tcfg, device="cpu")
            held = _held_bytes(state)
            shapes = {k: tuple(p.shape) for k, p in state.params.items()}
            step = make_train_step(state.model, tcfg)
            local = dp_shard.local_rows(mesh, batch)
            with ctx.manual_region(dp_shard.manual_axes(mesh)):
                partial = ll.model_partial_leaves(
                    cfg, param_specs(cfg), state.params,
                    stk.sp_split(cfg, batch["tokens"].shape[1]))
            for counter in (dp_shard.collectives, dp_shard.model_gathers,
                            model_axis.collectives, transport.moved):
                counter.clear()
            state, m = step(state, local)
            out[run] = dict(
                path=step.path, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]), held=held, shapes=shapes,
                err_shapes=None if state.err is None else
                {k: tuple(v.shape) for k, v in state.err.items()},
                params={k: plan.full(k, p.detach()).numpy()
                        for k, p in state.params.items()},
                mu={k: plan.full(k, v).numpy()
                    for k, v in state.opt.mu.items()},
                plan=dict(plan.dims), partial=partial,
                model_gathers=dict(dp_shard.model_gathers),
                collectives=dict(dp_shard.collectives),
                moved=dict(transport.moved),
                model_collectives=dict(model_axis.collectives))
        if first is None:
            first = state
    Checkpointer(os.path.join(workdir, f"cks_{tag}")).save(
        1, first, aux={"mesh": tag}, block=True)
    return out


def job_storage_restore(inp, tag, rank, workdir):
    """Restore the (1, 4) storage checkpoint into a template of its run
    built on this mesh's storage plan: every leaf gathered back."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.convert import from_jax_params, to_jax_named
    from repro_torch.train.train_step import init_train_state, param_plan
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    name, remat, compress, mb = inp["storage_runs"]["1x4"][0]
    c = inp["storage_archs"][name]
    tcfg = dataclasses.replace(inp["step_config"], remat_policy=remat,
                               compress_grads=compress, microbatches=mb)
    cfg = port_config(c["arch"], c["overrides"])
    with use_rules(mesh, rules_for("train")) as ctx:
        plan = param_plan(cfg, ctx)
        state = init_train_state(from_jax_params(
            cfg, unflatten(c["tree"]), device="cpu", trainable=True,
            plan=plan), None, tcfg, device="cpu")
        state, aux = Checkpointer(os.path.join(workdir, "cks_1x4")).restore(
            state, shardings=state.plan)
        named = to_jax_named(state)
    return dict(named=named, aux=aux)


def job_lookup(inp, tag, rank, workdir):
    """The vocabulary-parallel lookup of a table stored split over the
    model ranks: its output, the table's gradient gathered from the
    shards, and the lookup of the same table stored whole."""
    from repro_torch.distributed import model_axis
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import layers as ll
    from repro_torch.train.train_step import param_plan
    mesh = make_mesh(tag)
    c = inp["lookup"]
    cfg = port_config("qwen2-0.5b", {})
    tokens = torch.from_numpy(c["tokens"])
    with use_rules(mesh, rules_for("train")) as ctx, \
            ctx.manual_region(("data",)):
        plan = param_plan(cfg, ctx)
        shard = torch.tensor(plan.local("embed.tokens", c["table"]),
                             requires_grad=True)
        model_axis.collectives.clear()
        y = ll.embed({"tokens": shard}, cfg, tokens)
        counts = dict(model_axis.collectives)
        y.float().backward(torch.from_numpy(c["cot"]))
        whole = ll.embed({"tokens": torch.from_numpy(c["table"])}, cfg,
                         tokens)
        return dict(y=y.detach().float().numpy(),
                    whole=whole.float().numpy(),
                    shard_rows=shard.shape[0], collectives=counts,
                    dtable=plan.full("embed.tokens", shard.grad).numpy())


def job_serve_big(inp, tag, rank, workdir):
    """Prefill and one decode step of reduced granite through
    ``_serve_wrap`` under ``SERVE_RULES_BIG``, the serving model built on
    that storage plan: the logits of this rank's rows, the shapes it
    holds."""
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch.dryrun import _serve_wrap
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import param_plan
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    c = inp["serve"]
    cfg = port_config(c["arch"], {})
    tokens = torch.from_numpy(c["tokens"])
    B, S = tokens.shape
    B //= dp_shard.manual_size(mesh)        # this rank's rows
    with use_rules(mesh, rules_for("prefill", big_params=True)) as ctx:
        plan = param_plan(cfg, ctx)
        model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                plan=plan)
        prefill = _serve_wrap(model, ctx, model.prefill)
        logits, cache = prefill({"tokens": tokens},
                                model.init_cache(B, S + 4))
    with use_rules(mesh, rules_for("decode", big_params=True)) as ctx:
        decode = _serve_wrap(model, ctx,
                             lambda b, cache: model.decode_step(
                                 cache, b["tokens"], b["positions"]))
        dec, _ = decode({"tokens": tokens[:, :1],
                         "positions": torch.full((len(tokens),), S)}, cache)
    return dict(prefill=logits.float().numpy(), decode=dec.float().numpy(),
                shapes={k: tuple(p.shape)
                        for k, p in model.named_parameters()},
                plan=dict(plan.dims))


@contextlib.contextmanager
def _seq_variant(variant, seen):
    """A run's variant of the sequence-parallel step: ``"sp"`` and
    ``"nodiv"`` (an S no model axis here divides) record the residual
    stream's shape at each layer; ``"control"`` reduce-scatters nothing
    (``scatter_seq`` slices each rank's block of its own partial output);
    ``"issued"`` issues every collective over a group of one rank as well
    (``transport`` skips them)."""
    from repro_torch.distributed import model_axis, transport
    from repro_torch.models import stack as stk
    real_block, real_scatter = stk.block, model_axis.scatter_seq
    real_single = transport.single

    def block(p, cfg, x, **kw):
        seen.setdefault("residual", set()).add(tuple(x.shape))
        return real_block(p, cfg, x, **kw)

    if variant in ("sp", "nodiv"):
        stk.block = block
    elif variant == "control":
        model_axis.scatter_seq = lambda x, split, summed=True: real_scatter(
            x, split, summed=False)
    elif variant == "issued":
        transport.single = lambda group: False
    try:
        yield
    finally:
        stk.block, model_axis.scatter_seq = real_block, real_scatter
        transport.single = real_single


def job_seq_step(inp, tag, rank, workdir):
    """The sequence-parallel ``dp_manual`` step of each run of this mesh
    on a state built on the storage plan: every leaf gathered after the
    step, the first moments, loss, grad norm, the collectives by kind, the
    residual stream's shapes, the partial leaves, and the leaves summed
    over the model ranks beside those whose gradient differed across them
    before that sum."""
    from repro_torch.distributed import dp_shard, model_axis, transport
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import layers as ll
    from repro_torch.models.lm import param_specs
    from repro_torch.models import stack as stk
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, param_plan)
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out = {}
    real_sum = dp_shard.model_psum
    for run in inp["seq_runs"][tag]:
        name, remat, compress, mb, variant = run
        c = inp["seq_archs"][name]
        tcfg = dataclasses.replace(inp["step_config"], remat_policy=remat,
                                   compress_grads=compress, microbatches=mb)
        cfg = port_config(c["arch"], c["overrides"])
        key = "batch_nodiv" if variant == "nodiv" else "batch"
        batch = {k: torch.from_numpy(v) for k, v in c[key].items()}
        seen = {}

        def spy(grads, names, mesh_):
            seen["summed"] = list(names)
            seen["differ"] = _differ_over_model(grads, mesh_)
            return real_sum(grads, names, mesh_)

        with use_rules(mesh, rules_for("train")) as ctx:
            plan = param_plan(cfg, ctx)
            model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                    trainable=True, plan=plan)
            state = init_train_state(model, None, tcfg, device="cpu")
            step = make_train_step(state.model, tcfg)
            local = dp_shard.local_rows(mesh, batch)
            with ctx.manual_region(dp_shard.manual_axes(mesh)):
                split = stk.sp_split(cfg, local["tokens"].shape[1])
                partial = ll.model_partial_leaves(cfg, param_specs(cfg),
                                                  state.params, split)
            for counter in (dp_shard.collectives, model_axis.collectives,
                            transport.moved):
                counter.clear()
            dp_shard.model_psum = spy
            try:
                with _seq_variant(variant, seen):
                    state, m = step(state, local)
            finally:
                dp_shard.model_psum = real_sum
            out[run] = dict(
                path=step.path, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]),
                params={k: plan.full(k, p.detach()).numpy()
                        for k, p in state.params.items()},
                mu={k: plan.full(k, v).numpy()
                    for k, v in state.opt.mu.items()},
                plan=dict(plan.dims), partial=partial,
                sp=None if split is None else split.size,
                collectives=dict(dp_shard.collectives),
                model_collectives=dict(model_axis.collectives),
                moved=dict(transport.moved),
                residual=sorted(seen.pop("residual", ())), **seen)
    return out


def _greedy(model, ctx_of, prompts, steps, max_len, rows, extra=None,
            paths=None):
    """Prefill and ``steps - 1`` greedy decode steps through ``_serve_wrap``
    (the prefill and decode rules of ``ctx_of(kind)``) over an fp32 K/V
    cache made under the prefill rules: this rank's rows' logits of each
    step (the prefill's last position first) and the cache.  ``extra``:
    more fields of the global prefill batch (a vlm's patches, whisper's
    frames), cut with its rows.  ``paths``, a list, receives the path of
    each wrapped call."""
    from repro_torch.launch.dryrun import _serve_wrap
    B, S = prompts.shape
    paths = [] if paths is None else paths
    with ctx_of("prefill") as ctx:
        cache = model.init_cache(rows, max_len, kv_dtype=torch.float32)
        prefill = _serve_wrap(model, ctx, model.prefill)
        logits, cache = prefill({"tokens": prompts, **(extra or {})}, cache)
        paths.append(prefill.path)
    outs = [logits[:, -1].float()]
    for i in range(steps - 1):
        # every rank feeds the global batch: each rank's rows' tokens
        local = outs[-1].argmax(-1)
        gathered = [torch.empty_like(local)
                    for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, local)
        with ctx_of("decode") as ctx:
            decode = _serve_wrap(model, ctx, lambda b, c: model.decode_step(
                c, b["tokens"], b["positions"]))
            logits, cache = decode(
                {"tokens": _global_tokens(gathered, B, rows)[:, None],
                 "positions": torch.full((B,), S + i)}, cache)
            paths.append(decode.path)
        outs.append(logits[:, -1].float())
    return torch.stack(outs, 1), cache


def _global_tokens(gathered, B, rows):
    """The global batch's tokens from every rank's rows (rank = batch
    shard x model + model rank: the model ranks of a shard agree)."""
    per_shard = B // rows
    n = len(gathered) // per_shard
    return torch.cat([gathered[i * n] for i in range(per_shard)])


def job_kv_serve(inp, tag, rank, workdir):
    """Prefill and greedy decode through ``_serve_wrap`` of each serve
    run of this mesh under the serving rules, whose ``kv_seq`` cuts the
    K/V cache over the model ranks: this rank's rows' logits at every
    step, its K/V blocks, the blocks' count and bytes."""
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.convert import from_jax_params
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out = {}
    for run in inp["kv_runs"][tag]:
        name, max_len = run
        c = inp["kv_archs"][name]
        cfg = port_config(c["arch"], {})
        model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu")
        prompts = torch.from_numpy(c["prompts"])
        rows = prompts.shape[0] // dp_shard.manual_size(mesh)
        logits, cache = _greedy(
            model, lambda kind: use_rules(mesh, rules_for(kind)), prompts,
            c["steps"], max_len, rows)
        out[run] = dict(logits=logits.numpy(), kv_shards=cache.kv_shards,
                        k=cache["k"].numpy(), v=cache["v"].numpy(),
                        bytes=sum(cache[k].numel() * cache[k].element_size()
                                  for k in ("k", "v")))
    return out


def job_solo_serve(inp, tag, rank, workdir):
    """Prefill and greedy decode through ``_serve_wrap`` of each run of a
    batch the data ranks may not divide (1 or 3 rows over 2), the model on
    the storage plan of the serving rules (``SERVE_RULES_BIG`` where the
    run says ``big``): every rank's logits of all the rows at every step,
    its cache's leaves and cuts, the wrapper's path at each call, and the
    elements it holds against its plan's shards and the whole model's."""
    from repro_torch.distributed.sharding_rules import (model_rank,
                                                        rules_for, use_rules)
    from repro_torch.models import layers as ll
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import param_plan, param_shapes
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out = {}
    for run in inp["solo_runs"]:
        c = inp["solo"][run]
        cfg = port_config(c["arch"], c["overrides"])

        def ctx_of(kind, big=c["big"]):
            return use_rules(mesh, rules_for(kind, big_params=big))

        with ctx_of("prefill") as ctx:
            plan = param_plan(cfg, ctx)
        model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                plan=plan)
        prompts = torch.from_numpy(c["prompts"])
        paths = []
        logits, cache = _greedy(model, ctx_of, prompts, c["steps"],
                                c["max_len"], prompts.shape[0], paths=paths)
        shapes = param_shapes(cfg)
        res = dict(logits=logits.numpy(), paths=paths,
                   kv_shards=cache.kv_shards, ssm_shards=cache.ssm_shards,
                   cache={k: v.float().numpy() for k, v in cache.items()},
                   held=sum(p.numel() for p in model.parameters()),
                   shards=sum(int(np.prod(plan.local_shape(k, v)))
                              for k, v in shapes.items()),
                   whole=sum(int(np.prod(v)) for v in shapes.values()))
        if cfg.ssm_state_dim:
            res["heads"] = ll.ssm_heads(cfg, cache.ssm_shards,
                                        model_rank(mesh))
        out[run] = res
    return out


def job_ssm_pieces(inp, tag, rank, workdir):
    """The families with an SSM at this mesh's model axis
    (``tests/test_torch_ssm_axis.py``): attention over head slices that
    straddle GQA groups or hold padding only, and the SSM mixer split by
    heads (forward, every gradient summed over the model ranks, the
    collectives of each pass), then its prefill and decode steps with
    this rank's cache."""
    from repro_torch.distributed import model_axis
    from repro_torch.distributed.sharding_rules import (model_rank,
                                                        model_size,
                                                        rules_for, use_rules)
    from repro_torch.models import layers as ll
    from repro_torch.models import ssm as ssm_mod
    mesh = make_mesh(tag)
    n, r = model_size(mesh), model_rank(mesh)
    out = {}
    with use_rules(mesh, rules_for("train")) as ctx, \
            ctx.manual_region(("data",)):
        for name, c in inp["ssm_attn"].items():
            cfg = port_config(c["arch"], c["overrides"])
            p = _tensors(c["params"])
            x = torch.tensor(c["x"], requires_grad=True)
            B, S, _ = x.shape
            pos = torch.arange(S)[None].expand(B, S)
            y, _, _ = ll.attention(p, cfg, x, positions=pos,
                                   window=c["window"],
                                   num_sink=c["num_sink"])
            y.backward(torch.from_numpy(c["dy"]))
            grads = {k: v.grad for k, v in p.items()}
            _sum_partial(grads, list(grads), mesh)
            out["attn", name] = dict(
                y=y.detach().numpy(), dx=x.grad.numpy(),
                grads={k: v.numpy() for k, v in grads.items()},
                heads=ll.rank_heads(cfg, n, r))
        for name, c in inp["ssm_mixer"].items():
            cfg = port_config(c["arch"], c["overrides"])
            p = _tensors(c["params"])
            x = torch.tensor(c["x"], requires_grad=True)
            model_axis.collectives.clear()
            y = ssm_mod.ssm(p, cfg, x)
            forward = dict(model_axis.collectives)
            y.backward(torch.from_numpy(c["dy"]))
            backward = dict(model_axis.collectives)
            grads = {k: v.grad for k, v in p.items()}
            _sum_partial(grads, list(grads), mesh)
            with torch.no_grad():
                p = _tensors(c["params"], grad=False)
                y0, cache = ssm_mod.ssm(p, cfg, torch.from_numpy(c["x"]),
                                       return_state=True)
                steps = []
                for i in range(c["x_dec"].shape[1]):
                    yi, cache = ssm_mod.ssm_decode(
                        p, cfg, torch.from_numpy(c["x_dec"][:, i:i + 1]),
                        cache)
                    steps.append(yi.numpy())
            out["ssm", name] = dict(
                y=y.detach().numpy(), dx=x.grad.numpy(),
                grads={k: v.numpy() for k, v in grads.items()},
                forward=forward, backward=backward,
                heads=ll.ssm_heads(cfg, n, r), prefill=y0.numpy(),
                decode=np.concatenate(steps, 1),
                conv=cache["conv"].float().numpy(),
                state=cache["state"].numpy())
    return out


def job_ssm_step(inp, tag, rank, workdir):
    """The ``dp_manual`` step of each SSM-family run of this mesh on a
    state built on the storage plan from ``repro``'s parameters (an arch
    marked ``compress`` with int8 error-feedback compression): every
    leaf gathered after the step, the first moments, loss, grad norm, the
    bytes held against the shards', the shapes of the shards and of the
    error feedback, the partial leaves, and the leaves
    summed over the model ranks beside those whose gradient differed
    across them before that sum.  The first run's state is saved
    (``ckssm_<tag>``)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as stk
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.lm import param_specs
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, param_plan,
                                              param_shapes)
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out, first = {}, None
    real_sum = dp_shard.model_psum
    for name in inp["ssm_step_runs"][tag]:
        c = inp["ssm_archs"][name]
        tcfg = dataclasses.replace(inp["step_config"],
                                   compress_grads=c.get("compress", False))
        cfg = port_config(c["arch"], c["overrides"])
        batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
        seen = {}

        def spy(grads, names, mesh_):
            seen["summed"] = list(names)
            seen["differ"] = _differ_over_model(grads, mesh_)
            return real_sum(grads, names, mesh_)

        with use_rules(mesh, rules_for("train")) as ctx:
            plan = param_plan(cfg, ctx)
            model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                    trainable=True, plan=plan)
            state = init_train_state(model, None, tcfg, device="cpu")
            held = _held_bytes(state)
            shards = 4 * (3 + tcfg.compress_grads) * sum(
                int(np.prod(plan.local_shape(k, v)))
                for k, v in param_shapes(cfg).items())
            step = make_train_step(state.model, tcfg)
            local = dp_shard.local_rows(mesh, batch)
            with ctx.manual_region(dp_shard.manual_axes(mesh)):
                partial = ll.model_partial_leaves(cfg, param_specs(cfg),
                                                  state.params)
                sp = stk.sp_split(cfg, local["tokens"].shape[1])
            dp_shard.model_psum = spy
            try:
                state, m = step(state, local)
            finally:
                dp_shard.model_psum = real_sum
            out[name] = dict(
                path=step.path, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]), held=held, shards=shards,
                params={k: plan.full(k, p.detach()).numpy()
                        for k, p in state.params.items()},
                mu={k: plan.full(k, v).numpy()
                    for k, v in state.opt.mu.items()},
                err_shapes=None if state.err is None else
                {k: tuple(v.shape) for k, v in state.err.items()},
                shapes={k: tuple(p.shape) for k, p in state.params.items()},
                plan=dict(plan.dims), partial=partial, sp=sp, **seen)
        if first is None:
            first = state
    Checkpointer(os.path.join(workdir, f"ckssm_{tag}")).save(
        1, first, aux={"mesh": tag}, block=True)
    return out


def job_ssm_restore(inp, tag, rank, workdir):
    """Restore the other mesh's SSM-family checkpoint into a template of
    its run built on this mesh's storage plan: every leaf gathered
    back."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.convert import from_jax_params, to_jax_named
    from repro_torch.train.train_step import init_train_state, param_plan
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    c = inp["ssm_archs"][inp["ssm_step_runs"][tag][0]]
    cfg = port_config(c["arch"], c["overrides"])
    src = inp["ssm_restore_from"][tag]
    with use_rules(mesh, rules_for("train")) as ctx:
        plan = param_plan(cfg, ctx)
        state = init_train_state(from_jax_params(
            cfg, unflatten(c["tree"]), device="cpu", trainable=True,
            plan=plan), None, inp["step_config"], device="cpu")
        state, aux = Checkpointer(
            os.path.join(workdir, f"ckssm_{src}")).restore(
                state, shardings=state.plan)
        named = to_jax_named(state)
    return dict(named=named, aux=aux)


def job_ssm_serve(inp, tag, rank, workdir):
    """Prefill and greedy decode through ``_serve_wrap`` of each SSM-family
    serve run of this mesh under the serving rules, the model on their
    storage plan: this rank's rows' logits at every step, its cache's
    K/V blocks and SSM leaves, their cuts."""
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import (model_rank,
                                                        rules_for, use_rules)
    from repro_torch.models import layers as ll
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import param_plan
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out = {}
    for run in inp["ssm_serve_runs"][tag]:
        c = inp["ssm_serve"][run]
        cfg = port_config(c["arch"], c["overrides"])
        with use_rules(mesh, rules_for("prefill")) as ctx:
            plan = param_plan(cfg, ctx)
        model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                plan=plan)
        prompts = torch.from_numpy(c["prompts"])
        rows = prompts.shape[0] // dp_shard.manual_size(mesh)
        logits, cache = _greedy(
            model, lambda kind: use_rules(mesh, rules_for(kind)), prompts,
            c["steps"], c["max_len"], rows)
        res = dict(logits=logits.numpy(), kv_shards=cache.kv_shards,
                   ssm_shards=cache.ssm_shards,
                   heads=ll.ssm_heads(cfg, cache.ssm_shards,
                                      model_rank(mesh)),
                   ssm_state=cache["ssm_state"].numpy(),
                   ssm_conv=cache["ssm_conv"].float().numpy())
        if "k" in cache:
            res.update(k=cache["k"].numpy(), v=cache["v"].numpy())
        out[run] = res
    return out


def _batch_of(c, key="batch"):
    return {k: torch.from_numpy(v) for k, v in c[key].items()}


@contextlib.contextmanager
def _unsummed(name, when=lambda kw: True):
    """``layers.<name>`` run without the sum over the model ranks it ends
    in (``from_model`` the identity; under ``seq_res`` its reduce-scatter
    a slice of its own partial output) at each call whose keywords pass
    ``when``: the controls of the vlm / encdec step."""
    from repro_torch.distributed import model_axis
    from repro_torch.models import layers as ll
    real, real_from, real_scatter = (getattr(ll, name),
                                     model_axis.from_model,
                                     model_axis.scatter_seq)

    def fn(*args, **kw):
        if not when(kw):
            return real(*args, **kw)
        model_axis.from_model = lambda y, s: y
        model_axis.scatter_seq = lambda y, s, summed=True: real_scatter(
            y, s, summed=False)
        try:
            return real(*args, **kw)
        finally:
            model_axis.from_model = real_from
            model_axis.scatter_seq = real_scatter

    setattr(ll, name, fn)
    try:
        yield
    finally:
        setattr(ll, name, real)


def _ve_control(cfg):
    """The control of a family's step: cross-attention's per-rank outputs
    left unsummed (encdec), the vocabulary-parallel lookup without its
    sum (vlm)."""
    if cfg.encoder_layers:
        return _unsummed("_attention_split",
                         lambda kw: kw.get("kv_x") is not None)
    return _unsummed("embed")


def job_ve_pieces(inp, tag, rank, workdir):
    """The encdec pieces at this mesh's model axis
    (``tests/test_torch_encdec_axis.py``): cross-attention split by heads
    (forward, x's and the encoder output's gradients, every weight's
    summed over the model ranks), with the decoder's tokens whole and
    under ``seq_res``; the encoder stack on the storage plan under
    ``seq_res`` (its output gathered whole, the gradients of every leaf
    gathered from the shards, the partial ones summed)."""
    from repro_torch.distributed import dp_shard, model_axis
    from repro_torch.distributed.sharding_rules import (model_rank,
                                                        model_size,
                                                        rules_for, use_rules)
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as stk
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.lm import param_specs
    from repro_torch.train.train_step import param_plan
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    n, r = model_size(mesh), model_rank(mesh)
    out = {}
    with use_rules(mesh, rules_for("train")) as ctx, \
            ctx.manual_region(("data",)):
        for name, c in inp["ve_cross"].items():
            if n not in c["worlds"]:
                continue
            cfg = port_config(c["arch"], c["overrides"])
            p = _tensors(c["params"])
            x = torch.tensor(c["x"], requires_grad=True)
            enc = torch.tensor(c["enc"], requires_grad=True)
            B, S, _ = x.shape
            seq = stk.sp_split(cfg, S) if c["seq"] else None
            xin = x if seq is None else model_axis.scatter_seq(
                x, seq, summed=False)
            model_axis.collectives.clear()
            y, _, _ = ll.attention(p, cfg, xin, positions=None,
                                   causal=False, kv_x=ll.cross_source(enc),
                                   rope=False, full_kv=False, seq=seq)
            forward = dict(model_axis.collectives)
            if seq is not None:
                y = model_axis.gather_seq(y, seq, summed=False)
            y.backward(torch.from_numpy(c["dy"]))
            grads = {k: v.grad for k, v in p.items()}
            _sum_partial(grads, list(grads), mesh)
            out["cross", name] = dict(
                y=y.detach().numpy(), dx=x.grad.numpy(),
                denc=enc.grad.numpy(), forward=forward,
                grads={k: v.numpy() for k, v in grads.items()},
                heads=ll.rank_heads(cfg, n, r),
                sp=None if seq is None else seq.size)
    # the encoder under rules that store no leaf over "data": no bf16
    # gathers, so the split alone is held to the fp32 bounds
    with use_rules(mesh, dict(rules_for("train"), embed=None)) as ctx, \
            ctx.manual_region(("data",)):
        c = inp["ve_encoder"]
        cfg = port_config(c["arch"], c["overrides"])
        plan = param_plan(cfg, ctx)
        model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                trainable=True, plan=plan)
        frames = torch.from_numpy(c["frames"])
        seq = stk.sp_split(cfg, frames.shape[1])
        residual, real_block = set(), stk.block

        def block(p_, cfg_, x_, **kw):
            residual.add(tuple(x_.shape))
            return real_block(p_, cfg_, x_, **kw)

        stk.block = block
        try:
            enc = ll.cross_source(model.encode(frames, seq=seq), seq)
        finally:
            stk.block = real_block
        # every rank reads the whole output: a 1/n share of the cotangent
        # each, as the heads of the decoder's cross-attention split it
        (enc * torch.from_numpy(c["dy"]) / n).sum().backward()
        names = [k for k, _ in model.named_parameters()
                 if k.startswith(("encoder.", "enc_norm."))]
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in model.named_parameters() if k in names}
        partial = ll.model_partial_leaves(cfg, param_specs(cfg), names,
                                          enc_seq=seq)
        dp_shard.model_psum(grads, partial, mesh)
        out["encoder"] = dict(
            y=enc.detach().numpy(), sp=None if seq is None else seq.size,
            residual=sorted(residual), partial=partial,
            grads={k: plan.full(k, g).numpy() for k, g in grads.items()})
    return out


def job_ve_step(inp, tag, rank, workdir):
    """The ``dp_manual`` step of each vlm / encdec run of this mesh on a
    state built on the storage plan from ``repro``'s parameters: every
    leaf gathered after the step, the first moments, loss, grad norm, the
    bytes held against the shards', the residual stream's shapes by
    stack, the sequence splits, the collectives, the partial leaves and
    the leaves summed over the model ranks beside those whose gradient
    differed across them before that sum.  A run tagged ``"control"``
    leaves out one sum over the model ranks (``_ve_control``).  The first
    run's state is saved (``ckve_<tag>``)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import dp_shard, model_axis, transport
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as stk
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.lm import param_specs
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, param_plan,
                                              param_shapes)
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out, first = {}, None
    real_sum = dp_shard.model_psum
    for run in inp["ve_step_runs"][tag]:
        name = run[0]
        c = inp["ve_archs"][name]
        tcfg = inp["step_config"]
        cfg = port_config(c["arch"], c["overrides"])
        batch = _batch_of(c)
        seen = {}

        def spy(grads, names, mesh_):
            seen["summed"] = list(names)
            seen["differ"] = _differ_over_model(grads, mesh_)
            return real_sum(grads, names, mesh_)

        residual, real_block = {}, stk.block

        def block(p_, cfg_, x_, **kw):
            key = "decoder" if kw.get("enc_out") is not None else "encoder"
            if not cfg_.encoder_layers:
                key = "decoder"
            residual.setdefault(key, set()).add(tuple(x_.shape))
            return real_block(p_, cfg_, x_, **kw)

        with use_rules(mesh, rules_for("train")) as ctx:
            plan = param_plan(cfg, ctx)
            model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                    trainable=True, plan=plan)
            state = init_train_state(model, None, tcfg, device="cpu")
            held = _held_bytes(state)
            shards = 4 * 3 * sum(int(np.prod(plan.local_shape(k, v)))
                                 for k, v in param_shapes(cfg).items())
            step = make_train_step(state.model, tcfg)
            local = dp_shard.local_rows(mesh, batch)
            with ctx.manual_region(dp_shard.manual_axes(mesh)):
                sp = stk.sp_split(cfg, local["tokens"].shape[1])
                enc_sp = stk.sp_split(cfg, local["frames"].shape[1]) \
                    if "frames" in local else None
                partial = ll.model_partial_leaves(
                    cfg, param_specs(cfg), state.params, sp, enc_sp)
            for counter in (dp_shard.collectives, model_axis.collectives,
                            transport.moved, dp_shard.model_gathers):
                counter.clear()
            dp_shard.model_psum = spy
            stk.block = block
            try:
                with (_ve_control(cfg) if "control" in run[1:]
                      else contextlib.nullcontext()):
                    state, m = step(state, local)
            finally:
                dp_shard.model_psum = real_sum
                stk.block = real_block
            out[run] = dict(
                path=step.path, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]), held=held, shards=shards,
                params={k: plan.full(k, p.detach()).numpy()
                        for k, p in state.params.items()},
                mu={k: plan.full(k, v).numpy()
                    for k, v in state.opt.mu.items()},
                plan=dict(plan.dims), partial=partial,
                sp=None if sp is None else sp.size,
                enc_sp=None if enc_sp is None else enc_sp.size,
                residual={k: sorted(v) for k, v in residual.items()},
                collectives=dict(dp_shard.collectives),
                model_collectives=dict(model_axis.collectives),
                model_gathers=dict(dp_shard.model_gathers),
                moved=dict(transport.moved), **seen)
        if first is None:
            first = state
    Checkpointer(os.path.join(workdir, f"ckve_{tag}")).save(
        1, first, aux={"mesh": tag}, block=True)
    return out


def job_ve_restore(inp, tag, rank, workdir):
    """Restore the other mesh's vlm / encdec checkpoint into a template
    of its first run built on this mesh's storage plan: every leaf
    gathered back."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.convert import from_jax_params, to_jax_named
    from repro_torch.train.train_step import init_train_state, param_plan
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    c = inp["ve_archs"][inp["ve_step_runs"][tag][0][0]]
    cfg = port_config(c["arch"], c["overrides"])
    src = inp["ve_restore_from"][tag]
    with use_rules(mesh, rules_for("train")) as ctx:
        plan = param_plan(cfg, ctx)
        state = init_train_state(from_jax_params(
            cfg, unflatten(c["tree"]), device="cpu", trainable=True,
            plan=plan), None, inp["step_config"], device="cpu")
        state, aux = Checkpointer(
            os.path.join(workdir, f"ckve_{src}")).restore(
                state, shardings=state.plan)
        named = to_jax_named(state)
    return dict(named=named, aux=aux, shapes={
        k: tuple(p.shape) for k, p in state.params.items()})


def job_ve_serve(inp, tag, rank, workdir):
    """Prefill and greedy decode through ``_serve_wrap`` of each vlm /
    encdec serve run of this mesh under the serving rules, the model on
    their storage plan, the prefill's extra inputs (``patch_embeds``,
    ``frames``) cut with the rows: this rank's rows' logits at every
    step, its cache's leaves and cuts.  A run tagged ``"unweighted"``
    combines the ranks' partial softmaxes without their lse weights."""
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.kernels import ops
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import param_plan
    from _torch_dp_ranks import unflatten
    mesh = make_mesh(tag)
    out = {}
    for run in inp["ve_serve_runs"][tag]:
        c = inp["ve_serve"][run[0]]
        cfg = port_config(c["arch"], c["overrides"])
        with use_rules(mesh, rules_for("prefill")) as ctx:
            plan = param_plan(cfg, ctx)
        model = from_jax_params(cfg, unflatten(c["tree"]), device="cpu",
                                plan=plan)
        prompts = torch.from_numpy(c["prompts"])
        extra = {k: torch.from_numpy(v) for k, v in c["extra"].items()}
        rows = prompts.shape[0] // dp_shard.manual_size(mesh)
        real = ops.combine_partial
        if "unweighted" in run[1:]:
            ops.combine_partial = _unweighted_combine
        try:
            logits, cache = _greedy(
                model, lambda kind: use_rules(mesh, rules_for(kind)),
                prompts, c["steps"], c["max_len"], rows, extra)
        finally:
            ops.combine_partial = real
        out[run] = dict(logits=logits.numpy(), kv_shards=cache.kv_shards,
                        cross_shards=cache.cross_shards,
                        cache={k: v.numpy() for k, v in cache.items()})
    return out


def _unweighted_combine(out, lse, gather):
    """The ranks' normalised partial outputs averaged over the ranks that
    saw a key, without the weights exp(lse - max)."""
    packed = gather(torch.cat([out, lse[..., None]], dim=-1))
    seen = torch.isfinite(packed[..., -1:]).to(out.dtype)
    return (seen * packed[..., :-1]).sum(0) / seen.sum(0).clamp_min(1.0)


JOBS = {"pieces": job_pieces, "step": job_step, "restore": job_restore,
        "serve": job_serve, "storage_step": job_storage_step,
        "storage_restore": job_storage_restore, "lookup": job_lookup,
        "serve_big": job_serve_big, "seq_step": job_seq_step,
        "kv_serve": job_kv_serve, "ssm_pieces": job_ssm_pieces,
        "ssm_step": job_ssm_step, "ssm_restore": job_ssm_restore,
        "ssm_serve": job_ssm_serve, "ve_pieces": job_ve_pieces,
        "ve_step": job_ve_step, "ve_restore": job_ve_restore,
        "ve_serve": job_ve_serve, "solo_serve": job_solo_serve}


def main() -> None:
    workdir, tag, rank, jobs = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
        sys.argv[4].split(",")
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    world = int(np.prod(MESHES[tag][0]))
    store = dist.FileStore(os.path.join(workdir, f"store_{tag}_{jobs[0]}"),
                           world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        for job in jobs:
            res = JOBS[job](inp, tag, rank, workdir)
            path = os.path.join(workdir, f"res_{job}_w{tag}_r{rank}.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()
