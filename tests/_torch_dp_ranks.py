"""One rank of the port's multi-rank CPU tests (``tests/test_torch_dp.py``).

Run by ``_torch_support.spawn_ranks`` as

    python -c "import _torch_dp_ranks as r; r.main()" WORKDIR WORLD RANK JOBS

with ``tests`` and ``src`` on the path.  It joins a gloo group of WORLD ranks
through a ``FileStore`` in WORKDIR (no TCP port), runs each job named in the
comma-separated JOBS in turn, and writes each job's result, a dict of numpy
arrays and numbers, to ``WORKDIR/res_<job>_w<WORLD>_r<RANK>.pkl``.  The
inputs come from ``WORKDIR/inputs.pkl``, which the test process wrote.
This module imports torch and the port only, never JAX.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

# (mesh shape, axis names) of each world size the tests run
MESHES = {1: ((1, 1), ("data", "model")),
          2: ((2, 1), ("data", "model")),
          4: ((2, 2, 1), ("pod", "data", "model")),
          8: ((8, 1), ("data", "model"))}


def make_mesh(world: int):
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = MESHES[world]
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def batch_index(mesh) -> int:
    """This rank's batch shard along ("pod", "data"), pod-major."""
    from repro_torch.distributed.sharding_rules import mesh_shape
    shape = mesh_shape(mesh)
    index = 0
    for a in ("pod", "data"):
        if a in shape:
            index = index * shape[a] + mesh.get_local_rank(a)
    return index


def unflatten(flat):
    """{"a/b/c": leaf} -> nested dicts."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _port_state(arch: str, tree, tcfg):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import from_jax_params
    from repro_torch.train.train_step import init_train_state
    cfg = reduced(get_config(arch))
    model = from_jax_params(cfg, unflatten(tree), device="cpu",
                            trainable=True)
    return init_train_state(model, None, tcfg, device="cpu")


def job_dp_step(inp, world, rank, workdir):
    """The data-parallel step for each (arch, microbatches) of this world's
    runs: full params and moments after one step, loss, grad norm, the
    collectives it issued.  The last run's state is then saved sharded
    (``ck_w<world>``)."""
    import dataclasses
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.train.train_step import (make_train_step,
                                              shard_train_state)
    mesh = make_mesh(world)
    out = {}
    for arch, mb in inp["dp_runs"][world]:
        tcfg = dataclasses.replace(inp["dp_step_config"], microbatches=mb)
        state = _port_state(arch, inp["trees"][arch], tcfg)
        b = {k: torch.from_numpy(v) for k, v in inp["batches"][arch].items()}
        with use_rules(mesh, rules_for("train")) as ctx:
            state = shard_train_state(state, ctx)
            step = make_train_step(state.model, tcfg)
            n = b["tokens"].shape[0] // dp_shard.manual_size(mesh)
            i = batch_index(mesh)
            local = {k: v[i * n:(i + 1) * n] for k, v in b.items()}
            dp_shard.collectives.clear()
            state, m = step(state, local)
            counts = dict(dp_shard.collectives)
            plan = state.plan
            full = {k: plan.full(k, p.detach()).numpy()
                    for k, p in state.params.items()}
            mu = {k: plan.full(k, v).numpy() for k, v in state.opt.mu.items()}
            shard_shapes = {k: tuple(p.shape)
                            for k, p in state.params.items()}
            mu_shapes = {k: tuple(v.shape) for k, v in state.opt.mu.items()}
        out[arch, mb] = dict(path=step.path, params=full, mu=mu,
                             loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]),
                             collectives=counts, plan=dict(plan.dims),
                             shard_shapes=shard_shapes, mu_shapes=mu_shapes)
    Checkpointer(os.path.join(workdir, f"ck_w{world}")).save(
        1, state, aux={"world": world}, block=True)
    return out if rank == 0 else {run: {"shard_shapes": o["shard_shapes"],
                                        "mu_shapes": o["mu_shapes"]}
                                  for run, o in out.items()}


def job_restore(inp, world, rank, workdir):
    """Restore the other worlds' sharded checkpoints into a sharded
    template of the same arch (``shardings=`` its plan): every leaf
    gathered back to its global shape, and this rank's shard shapes."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models.convert import to_jax_named
    from repro_torch.train.train_step import shard_train_state
    mesh = make_mesh(world)
    arch = inp["dp_runs"][world][-1][0]
    out = {}
    for src in inp["restore_from"][world]:
        state = _port_state(arch, inp["trees"][arch], inp["dp_step_config"])
        with use_rules(mesh, rules_for("train")) as ctx:
            state = shard_train_state(state, ctx)
            ck = Checkpointer(os.path.join(workdir, f"ck_w{src}"))
            state, aux = ck.restore(state, shardings=state.plan)
            named = to_jax_named(state)
        out[src] = dict(named=named, aux=aux,
                        shard_shapes={k: tuple(p.shape)
                                      for k, p in state.params.items()})
    return out


def job_gather(inp, world, rank, workdir):
    """``gather_leaf`` forward and backward on two leaves (planned dim 0
    and dim 1) and ``gather_params`` on a 2-dim and a 1-dim leaf."""
    from repro_torch.distributed import dp_shard
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    mesh = make_mesh(world)
    out = {}
    with use_rules(mesh, rules_for("train")) as ctx:
        for name, (full, dim, cot) in inp["gather"].items():
            n = full.shape[dim] // world
            shard = torch.from_numpy(np.take(
                full, range(rank * n, (rank + 1) * n), axis=dim).copy())
            shard.requires_grad_(True)
            y = dp_shard.gather_leaf(shard, {dim: ("data",)}, mesh,
                                     dtype=torch.bfloat16)
            y.backward(torch.from_numpy(cot[rank]).to(torch.bfloat16))
            out[name] = dict(y=y.detach().float().numpy(),
                             y_dtype=str(y.dtype),
                             grad=shard.grad.numpy(),
                             grad_dtype=str(shard.grad.dtype))
        axes = {"w": ("embed", "mlp"), "s": ("embed",)}
        leaves = {k: torch.from_numpy(v) for k, v in inp["leaves"].items()}
        plan = dp_shard.ShardPlan.for_storage(
            ctx, axes, {k: tuple(v.shape) for k, v in leaves.items()},
            ("data",))
        local = dp_shard.shard_tree(leaves, plan)
        with ctx.manual_region(("data",)):
            got = dp_shard.gather_params(local, axes)
        out["gather_params"] = {k: (v.float().numpy(), str(v.dtype))
                                for k, v in got.items()}
        out["outside_region"] = dp_shard.gather_params(local, axes) is local
    return out


def job_compressed_psum(inp, world, rank, workdir):
    """Two steps of ``compressed_psum`` with error feedback on this rank's
    gradients: each step's mean and new error."""
    from repro_torch.distributed.grad_compress import compressed_psum
    out = []
    for leaf in inp["psum_grads"][world]:
        err = torch.zeros(leaf.shape[2:])
        steps = []
        for s in range(leaf.shape[1]):
            mean, err = compressed_psum(torch.from_numpy(leaf[rank, s]), err)
            steps.append((mean.numpy(), err.numpy()))
        out.append(steps)
    return out


def job_put_batch(inp, world, rank, workdir):
    """The first batch each rank's loader puts on its device: its host
    index's rows."""
    from repro_torch.data import DataLoader, LoaderParams, token_dataset
    n, seq, vocab, gb = inp["put_batch"]
    loader = DataLoader(token_dataset(n, seq, vocab, seed=0), gb,
                        params=LoaderParams(num_workers=0), seed=0,
                        host_index=dist.get_rank(),
                        host_count=dist.get_world_size(), device="cpu")
    stream = loader.stream(to_device=True)
    try:
        batch = next(iter(stream))
    finally:
        stream.close()
    return {k: (v.numpy(), str(v.device)) for k, v in batch.items()}


JOBS = {"dp_step": job_dp_step, "restore": job_restore, "gather": job_gather,
        "compressed_psum": job_compressed_psum, "put_batch": job_put_batch}


def main() -> None:
    workdir, world, rank, jobs = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4].split(",")
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    store = dist.FileStore(os.path.join(workdir, f"store_w{world}_{jobs[0]}"),
                           world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        for job in jobs:
            res = JOBS[job](inp, world, rank, workdir)
            path = os.path.join(workdir, f"res_{job}_w{world}_r{rank}.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()
