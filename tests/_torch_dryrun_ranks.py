"""The ranks of the dry-run's collective test (``tests/test_torch_dryrun.py``).

    python -c "import _torch_dryrun_ranks as r; r.main()" WORKDIR MESH RANK JOBS
    python -c "import _torch_dryrun_ranks as r; r.meta_main()" WORKDIR

``main`` is one rank of a real gloo group on the mesh ``MESH`` (a tag of
``_torch_tp_ranks.MESHES``), joined through a ``FileStore`` in WORKDIR: it
counts one ``dp_manual`` train step of reduced qwen2 on the CPU on its
storage plan (``launch.dryrun.count_train(device="cpu")``) and writes the
counter's collectives and the bytes it holds.  ``meta_main`` traces the
same step for rank 0 of a 4-rank ``"fake"`` group on meta, and reduced
configs' cells on the (16, 16) production mesh (qwen2's train, prefill
and decode cells, mixtral's long_500k); it writes their results.
Both write ``WORKDIR/res_<job>_w<MESH>_r<RANK>.pkl``.  This module imports
torch and the port only.
"""
from __future__ import annotations

import os
import pickle
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
LONG_ARCH = "mixtral-8x22b"     # long_500k needs a subquadratic config
ROWS, SEQ = 2, 16          # a rank's rows at (data 2, model 2)


def _write(workdir, job, tag, rank, res) -> None:
    path = os.path.join(workdir, f"res_{job}_w{tag}_r{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(path + ".tmp", path)


def _count(mesh, device):
    """One counted ``dp_manual`` step of reduced qwen2 on ``mesh``: the
    counter's summary, the bytes the rank holds and its plan's bytes."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch import dryrun as dr
    from repro_torch.train.train_step import TrainStepConfig, param_plan, \
        param_shapes
    cfg = reduced(get_config(ARCH))
    scfg = TrainStepConfig(remat_policy="dots", microbatches=2,
                           dp_manual=True)
    with use_rules(mesh, rules_for("train")) as ctx:
        c, held, path = dr.count_train(cfg, scfg, ROWS, SEQ, ctx=ctx,
                                       device=device)
        plan = param_plan(cfg, ctx)
        planned = 4 * sum(torch.Size(plan.local_shape(k, s)).numel()
                          for k, s in param_shapes(cfg).items())
    return dict(summary=c.summary(), held=held, planned_bytes=planned,
                path=path)


def main() -> None:
    from _torch_tp_ranks import MESHES, make_mesh
    workdir, tag, rank, jobs = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
        sys.argv[4].split(",")
    world = 1
    for d in MESHES[tag][0]:
        world *= d
    store = dist.FileStore(os.path.join(workdir, f"store_{tag}_{jobs[0]}"),
                           world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        _write(workdir, "collectives", tag, rank,
               _count(make_mesh(tag), "cpu"))
    finally:
        dist.destroy_process_group()


def meta_main() -> None:
    """Rank 0 of a 4-rank fake group at (data 2, model 2) on meta, then
    reduced qwen2's three kinds of cell and reduced mixtral's long_500k on
    the (16, 16) mesh, with that cell's storage plan."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_local_mesh
    workdir = sys.argv[1]
    with dr.fake_group(4):
        _write(workdir, "collectives", "2x2", "meta",
               _count(make_local_mesh(model_axis=2, device="cpu"), "meta"))
    cells = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        arch = LONG_ARCH if shape == "long_500k" else ARCH
        cfg = reduced(get_config(arch))
        out = dr.trace_cell(arch, shape, "single", cfg=cfg)
        cells[shape] = {k: out[k] for k in ("ok", "chips", "path", "memory",
                                            "fits_hbm_80g")}
        cells[shape]["dominant"] = out["roofline"]["dominant"]
    cells["long_500k"].update(_long_plan(reduced(get_config(LONG_ARCH))))
    _write(workdir, "cells", "16x16", "meta", cells)


def _long_plan(cfg) -> dict:
    """Rank 0's storage plan for serving ``cfg`` on the (16, 16) mesh: the
    bytes of a meta model on it and of the whole model, and the elements
    of its shards by the plan's own shapes."""
    import math

    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train.train_step import param_plan, param_shapes
    with dr.fake_group(256):
        mesh = make_production_mesh(multi_pod=False, device="cpu")
        with use_rules(mesh, rules_for("decode")) as ctx:
            plan = param_plan(cfg, ctx)

            def held(model):
                return [sum(p.numel() * p.element_size()
                            for p in model.parameters()),
                        sum(p.numel() for p in model.parameters())]

            planned_bytes, numel = held(dr.meta_model(cfg, plan=plan))
            whole_bytes, _ = held(dr.meta_model(cfg))
            shards = sum(math.prod(plan.local_shape(k, v))
                         for k, v in param_shapes(cfg).items())
    return dict(planned_bytes=planned_bytes, whole_bytes=whole_bytes,
                planned_numel=numel, shard_numel=shards)
