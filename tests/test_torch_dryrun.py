"""The port's dry-run (``repro_torch/launch/dryrun.py``,
``launch/diagnose.py``) against ``repro.launch.dryrun`` on the CPU.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices when it is
imported, so its answers are read in a subprocess (as
``tests/test_dp_manual.py`` imports it): the cells in order, the per-arch
train knobs, the fp8 K/V decision for every cell on both production
meshes.  The dry-run's own traces run in subprocesses too, so no fake
process group is ever initialised in a test worker: reduced qwen2's
``dp_manual`` step at (data 2, model 2), traced for rank 0 of a fake
group on meta, issues the same collectives (kind, count, bytes, mesh
axis) as rank 0 of a real 4-rank gloo run of the same step on the CPU,
and its rank holds exactly its storage plan's parameter and AdamW bytes;
a reduced config's train, prefill and decode cells on the (16, 16) mesh
complete with ``ok``.
"""
from __future__ import annotations

import ast
import json
import os
import pickle
import subprocess
import sys

import pytest
import torch

from _torch_support import join_ranks, spawn_ranks

from repro_torch.configs.base import (SHAPES, applicable_shapes, get_config,
                                      list_configs)
from repro_torch.launch import dryrun as dr

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HERE = os.path.dirname(os.path.abspath(__file__))

REPRO_SIDE = r"""
import json, os, sys
sys.path.insert(0, "src")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import repro.launch.dryrun as d
from repro.configs.base import applicable_shapes, get_config, list_configs
from repro.models import build_model
out = {"cells": [list(c) for c in d.all_cells()], "train": {}, "kv": {}}
for arch in list_configs():
    cfg = get_config(arch)
    t = d.train_step_config(cfg)
    out["train"][arch] = [t.remat_policy, t.microbatches, t.dp_manual]
    model = build_model(cfg)
    for shape in applicable_shapes(cfg):
        if shape.kind == "train":
            continue
        for chips in (256, 512):
            out["kv"][f"{arch}/{shape.name}/{chips}"] = str(
                d.choose_kv_dtype(model, cfg, shape, chips))
print("JSON" + json.dumps(out))
"""


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE, os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT, env=env)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return r.stdout


@pytest.fixture(scope="module")
def repro_side():
    out = _run(["-c", REPRO_SIDE])
    return json.loads(out[out.index("JSON") + 4:])


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Rank 0 of the gloo run and of the meta trace at (2, 2), and the
    reduced cells at (16, 16): all started at once."""
    workdir = str(tmp_path_factory.mktemp("dryrun_ranks"))
    procs = spawn_ranks(workdir, "2x2", ["collectives"],
                        module="_torch_dryrun_ranks")
    meta = subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c",
         "import _torch_dryrun_ranks as r; r.meta_main()", workdir],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1",
                            PYTHONPATH=os.pathsep.join(
                                [HERE, os.path.join(ROOT, "src")])))
    join_ranks(procs)
    log, _ = meta.communicate(timeout=300)
    assert meta.returncode == 0, log[-3000:]

    def load(name):
        with open(os.path.join(workdir, name), "rb") as f:
            return pickle.load(f)

    return {"gloo": load("res_collectives_w2x2_r0.pkl"),
            "meta": load("res_collectives_w2x2_rmeta.pkl"),
            "cells": load("res_cells_w16x16_rmeta.pkl")}


# ---- repro's decisions ------------------------------------------------------
def test_torch_all_cells_match_repro(repro_side):
    assert [list(c) for c in dr.all_cells()] == repro_side["cells"]


def test_torch_dryrun_list_matches_repro(repro_side):
    out = _run(["-m", "repro_torch.launch.dryrun", "--list"])
    assert out.split() == ["/".join(c) for c in repro_side["cells"]]


@pytest.mark.parametrize("arch", list_configs())
def test_torch_train_step_config_matches_repro(repro_side, arch):
    t = dr.train_step_config(get_config(arch))
    assert [t.remat_policy, t.microbatches, t.dp_manual] == \
        repro_side["train"][arch]


@pytest.mark.parametrize("arch", list_configs())
def test_torch_choose_kv_dtype_matches_repro(repro_side, arch):
    """fp8 where the bf16 cache passes 7e9 bytes a device, on both
    production meshes, for every serving cell of the arch."""
    cfg = get_config(arch)
    for shape in applicable_shapes(cfg):
        if shape.kind == "train":
            continue
        for chips in (256, 512):
            got = dr.choose_kv_dtype(None, cfg, shape, chips)
            want = repro_side["kv"][f"{arch}/{shape.name}/{chips}"]
            assert str(got).replace("torch.", "") == \
                want.rsplit(".", 1)[-1].replace("'>", ""), (shape, chips)


def test_torch_dryrun_has_every_public_name_of_repro():
    """``launch/dryrun.py`` defines every public name of ``repro``'s
    (read from its source: importing it would set ``XLA_FLAGS``)."""
    tree = ast.parse(open(os.path.join(
        ROOT, "src", "repro", "launch", "dryrun.py")).read())
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    names |= {t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)}
    missing = sorted(n for n in names if not n.startswith("__")
                     and not hasattr(dr, n))
    assert not missing


def test_torch_dryrun_shardings_and_specs():
    """The partition tuples of the port's helpers on a (16, 16) mesh
    shape: parameters by the rules, the batch over ``"batch"``, the cache
    by ``CACHE_AXES``; the batch's specs as ``repro``'s input specs."""
    from repro_torch.distributed.sharding_rules import (ShardingCtx,
                                                        rules_for)
    from repro_torch.models import stack as stk

    class Mesh:
        shape = {"data": 16, "model": 16}

    cfg = get_config("qwen2-0.5b")
    ctx = ShardingCtx(Mesh(), rules_for("decode"))
    p = dr.params_shardings(cfg, ctx)
    assert set(p) == {k for k in dr._named_axes(cfg)}
    specs = dr.input_specs(cfg, SHAPES["decode_32k"])
    assert specs == {"tokens": ((128, 1), torch.int32),
                     "positions": ((128,), torch.int32)}
    assert dr.batch_shardings(specs, ctx)["tokens"][0] in ("data",
                                                           ("data",))
    c = dr.cache_shardings(stk.cache_shapes(cfg, 128, 32768), ctx)
    assert set(c) == {"k", "v"}
    opt = dr.opt_state_shardings(cfg, ctx)
    assert opt.mu == p and opt.step == ()


# ---- the traces -------------------------------------------------------------
def test_torch_meta_counts_the_gloo_collectives(traces):
    """Rank 0's collectives of one ``dp_manual`` step at (data 2, model
    2): kind, count, bytes and mesh axis, on meta under a fake group as in
    a real 4-rank gloo run on the CPU."""
    g, m = traces["gloo"]["summary"], traces["meta"]["summary"]
    assert g["collective_counts"] and g["collective_axes"].keys() == \
        {"data", "model"}
    for key in ("collective_counts", "collective_bytes", "collective_axes"):
        assert m[key] == g[key], key
    assert traces["meta"]["path"] == traces["gloo"]["path"] == "dp_manual"


def test_torch_meta_rank_holds_its_storage_plan(traces):
    """The traced rank holds its plan's shards: fp32 masters, and the two
    AdamW moments of each, exactly; so does the gloo rank."""
    for side in ("meta", "gloo"):
        t = traces[side]
        assert t["held"]["params"] == t["planned_bytes"]
        assert t["held"]["opt"] == 2 * t["planned_bytes"]
    assert traces["meta"]["held"] == traces["gloo"]["held"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                   "decode_32k", "long_500k"])
def test_torch_reduced_cell_on_the_production_mesh(traces, shape):
    """Reduced qwen2's train, prefill and decode cells and reduced
    mixtral's long_500k (one row, which the 16 data ranks do not divide)
    on the (16, 16) mesh: ok on their paths, within 80 GB; the long_500k
    rank holds its storage plan's shards of the leaves, not the whole
    model."""
    cell = traces["cells"][shape]
    assert cell["ok"] and cell["chips"] == 256
    assert cell["path"] == {"train_4k": "dp_manual",
                            "long_500k": "serve_replicated"}.get(
                                shape, "serve_wrap")
    if shape == "long_500k":
        mem = cell["memory"]
        assert cell["planned_numel"] == cell["shard_numel"]
        assert mem["params_bytes"] == cell["planned_bytes"] < \
            cell["whole_bytes"]
    mem = cell["memory"]
    assert mem["peak_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"] > 0
    assert cell["fits_hbm_80g"]
    assert cell["dominant"] in ("compute", "memory", "collective")
