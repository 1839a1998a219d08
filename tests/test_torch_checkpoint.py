"""The port's Checkpointer: the cases of tests/test_checkpoint.py on
``repro_torch.checkpoint.Checkpointer``, and checkpoints crossing between
the packages in both directions — a train state saved by either package
restores bit-equal in the other, under identical manifests.
"""
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from conftest import flat_indices
from repro_torch.checkpoint import Checkpointer


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g),
                       "b": torch.arange(4.0)},
            "opt": {"mu": torch.zeros((8, 16)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_torch_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(12, state, aux={"loader": {"epoch": 1}}, block=True)
    restored, aux = ck.restore(_state(seed=99))
    assert aux["step"] == 12
    assert aux["loader"]["epoch"] == 1
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_torch_latest_step_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for s in (5, 10, 15, 20):
        ck.save(s, _state(), block=True)
    assert ck.latest_step() == 20
    assert ck.all_steps() == [15, 20]


def test_torch_async_save_does_not_block(tmp_path):
    ck = Checkpointer(str(tmp_path))
    big = {"w": torch.zeros((512, 512))}
    t0 = time.perf_counter()
    ck.save(1, big)            # returns before the file lands
    submit_time = time.perf_counter() - t0
    ck.wait()
    assert ck.latest_step() == 1
    assert submit_time < 5.0


def test_torch_async_save_snapshots_before_returning(tmp_path):
    """The train loop updates tensors in place right after ``save``
    returns: the file holds the values at the call."""
    ck = Checkpointer(str(tmp_path))
    w = torch.ones(64, 64)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    restored, _ = ck.restore({"w": torch.zeros(64, 64)})
    assert bool((restored["w"] == 1.0).all())


def test_torch_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=5)
    for s in (1, 2, 3):
        ck.save(s, {"v": np.float32(s)}, block=True)
    restored, aux = ck.restore({"v": np.float32(0)}, step=2)
    assert float(restored["v"]) == 2.0
    assert aux["step"] == 2


def test_torch_restore_missing_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(_state())


def test_torch_atomicity_no_partial_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _state(), block=True)
    entries = os.listdir(tmp_path)
    assert all(not e.endswith(".tmp") for e in entries)


# ---- loader aux: checkpointing mid-quarantine (DESIGN.md §10) --------------

def _faulty_loader(n, gb, bad):
    from repro_torch.data import (DataLoader, Dataset, FaultyStorage,
                                  LoaderParams, StorageFaultSpec)
    from repro_torch.data.storage import ArrayStorage
    items = [np.full((4,), i, np.int32) for i in range(n)]
    ds = Dataset(FaultyStorage(ArrayStorage(items),
                               StorageFaultSpec(corrupt_items=bad)),
                 transform=lambda a: {"x": a})
    # prefetch window of one: the producer cannot run far enough ahead of
    # the checkpoint to quarantine ids the consumed position hasn't seen
    return DataLoader(ds, gb, params=LoaderParams(
        num_workers=1, prefetch_factor=1, on_bad_sample="skip",
        retry_attempts=2, retry_backoff_s=1e-3), shuffle=False, seed=0,
        device="cpu")


def test_torch_loader_checkpoint_mid_quarantine(tmp_path):
    """A checkpoint taken mid-epoch, after some corrupt samples were
    quarantined, restores the quarantine through the loader aux: the
    resumed stream keeps skipping the same ids without re-probing them,
    and combined coverage is exact (epoch minus quarantine, no dups)."""
    from repro_torch.data.sampler import SamplerState

    n, gb, bad = 64, 8, (3, 17, 58)
    bpe = n // gb
    dl = _faulty_loader(n, gb, bad)
    s = dl.stream(to_device=False)
    try:
        first = [next(s) for _ in range(bpe // 2)]   # sees 3 and 17, not 58
        saved = dl.state_dict()
        saved["sampler"] = SamplerState.from_absolute(s.position, bpe) \
            .to_dict()
        ck = Checkpointer(str(tmp_path))
        ck.save(s.position, _state(), aux={"loader": saved}, block=True)
    finally:
        s.close()
    assert sorted(dl.quarantine.ids().tolist()) == [3, 17]

    _, aux = Checkpointer(str(tmp_path)).restore(_state(seed=1))
    dl2 = _faulty_loader(n, gb, bad)
    dl2.load_state_dict(aux["loader"])
    assert sorted(dl2.quarantine.ids().tolist()) == [3, 17]
    before = dl2.dataset.storage.corrupt_raised
    s2 = dl2.stream(to_device=False)
    try:
        rest = [next(s2) for _ in range(bpe - bpe // 2)]
    finally:
        s2.close()
    # restored ids were screened up front, never re-read; 58 is fresh
    assert flat_indices(first + rest) == \
        [i for i in range(n) if i not in bad]
    assert sorted(dl2.quarantine.ids().tolist()) == sorted(bad)
    assert dl2.dataset.storage.corrupt_raised == before + 1


# ---- across the packages: a reduced qwen2-0.5b train state -----------------

ARCH = "qwen2-0.5b"


def _jax_state(seed):
    """A JAX TrainState with compressed gradients (so ``2/...`` is on
    disk) whose every leaf is distinct: the moments, error feedback and
    step are drawn too, not left at their zero init."""
    from repro.configs import get_config, reduced
    from repro.models import build_model
    from repro.train.optimizer import AdamWState
    from repro.train.train_step import (TrainState, TrainStepConfig,
                                        init_train_state)
    model = build_model(reduced(get_config(ARCH)))
    st = init_train_state(model, jax.random.PRNGKey(seed),
                          TrainStepConfig(compress_grads=True))
    rng = np.random.default_rng(seed)

    def draw(tree, fn=lambda a: a):
        return jax.tree_util.tree_map(
            lambda x: fn(rng.standard_normal(x.shape).astype(np.float32)),
            tree)

    params = jax.tree_util.tree_map(np.asarray, st.params)
    opt = AdamWState(np.int32(17), draw(st.opt.mu), draw(st.opt.nu, np.abs))
    return TrainState(params, opt, draw(st.err))


def _port_template(seed=5):
    from repro_torch.configs import get_config, reduced
    from repro_torch.train.train_step import TrainStepConfig, init_train_state
    return init_train_state(reduced(get_config(ARCH)),
                            torch.Generator().manual_seed(seed),
                            TrainStepConfig(compress_grads=True),
                            device="cpu")


def _port_named(state):
    """Every leaf of a port TrainState by a name of its own."""
    out = {f"p:{k}": v for k, v in state.params.items()}
    out.update({f"mu:{k}": v for k, v in state.opt.mu.items()})
    out.update({f"nu:{k}": v for k, v in state.opt.nu.items()})
    out.update({f"err:{k}": v for k, v in state.err.items()})
    out["step"] = torch.tensor(state.opt.step)
    return out


def test_torch_restores_jax_checkpoint_bit_equal(tmp_path):
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import from_jax_train_state

    jstate = _jax_state(0)
    JaxCheckpointer(str(tmp_path)).save(17, jstate, aux={"k": 1}, block=True)
    template = _port_template()
    tmpl_ids = {k: id(v) for k, v in _port_named(template).items()
                if k != "step"}
    got, aux = Checkpointer(str(tmp_path)).restore(template)
    assert aux == {"k": 1, "step": 17}
    expect = from_jax_train_state(reduced(get_config(ARCH)), jstate,
                                  device="cpu")
    got_named, expect_named = _port_named(got), _port_named(expect)
    assert got_named.keys() == expect_named.keys()
    for k, v in got_named.items():
        assert v.dtype == expect_named[k].dtype, k
        assert torch.equal(v, expect_named[k]), k
        if k != "step":
            assert id(v) == tmpl_ids[k], f"{k} was not restored in place"
    assert got.opt.step == 17


def test_jax_restores_torch_checkpoint_bit_equal(tmp_path):
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.utils.tree import flatten_with_names
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import from_jax_train_state

    # the port's state: JAX's state carried across, so the expected
    # values are known in JAX's layout
    jstate = _jax_state(1)
    port = from_jax_train_state(reduced(get_config(ARCH)), jstate,
                                device="cpu")
    Checkpointer(str(tmp_path)).save(17, port, block=True)
    restored, aux = JaxCheckpointer(str(tmp_path)).restore(_jax_state(2))
    assert aux["step"] == 17
    got, want = flatten_with_names(restored), flatten_with_names(jstate)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_torch_and_jax_manifests_identical(tmp_path):
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import from_jax_train_state

    jstate = _jax_state(3)
    port = from_jax_train_state(reduced(get_config(ARCH)), jstate,
                                device="cpu")
    JaxCheckpointer(str(tmp_path / "jax")).save(4, jstate, block=True)
    Checkpointer(str(tmp_path / "port")).save(4, port, block=True)
    texts = [(tmp_path / d / "step_00000004" / "manifest.json").read_text()
             for d in ("jax", "port")]
    assert texts[0] == texts[1]
    manifest = json.loads(texts[0])
    assert "1/.step" in manifest and manifest["1/.step"] == {
        "shape": [], "dtype": "int32"}
    assert any(n.startswith("2/") for n in manifest)
    assert manifest["0/layers/attn/wq"]["shape"][0] == 2     # stacked (L, ...)
    names = [sorted(np.load(tmp_path / d / "step_00000004" / "arrays_p0.npz")
                    .files) for d in ("jax", "port")]
    assert names[0] == names[1]


def test_torch_restore_with_shardings_single_process(tmp_path):
    """The resharded restore in one process (a one-rank gloo group):
    a sharded state saves the files, names and bytes an unsharded save
    writes, and ``restore(shardings=plan)`` into a sharded template gives
    every leaf back bit-equal, in place.  ``tests/test_torch_dp.py``
    crosses world sizes."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.train.train_step import shard_train_state

    cfg = reduced(get_config(ARCH))
    jstate = _jax_state(4)
    Checkpointer(str(tmp_path / "plain")).save(
        3, from_jax_train_state(cfg, jstate, device="cpu"), block=True)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with use_rules(make_local_mesh(device="cpu"),
                       rules_for("train")) as ctx:
            state = shard_train_state(
                from_jax_train_state(cfg, jstate, device="cpu"), ctx)
            Checkpointer(str(tmp_path / "sharded")).save(3, state,
                                                         block=True)
            template = shard_train_state(
                from_jax_train_state(cfg, _jax_state(5), device="cpu"), ctx)
            ids = {k: id(v) for k, v in _port_named(template).items()
                   if k != "step"}
            got, aux = Checkpointer(str(tmp_path / "sharded")).restore(
                template, shardings=template.plan)
    finally:
        dist.destroy_process_group()
    assert aux == {"step": 3} and got.plan is template.plan
    want = _port_named(state)
    for k, v in _port_named(got).items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
        if k != "step":
            assert id(v) == ids[k], f"{k} was not restored in place"
    dirs = [tmp_path / d / "step_00000003" for d in ("plain", "sharded")]
    assert [sorted(os.listdir(d)) for d in dirs] == \
        [["arrays_p0.npz", "aux.json", "manifest.json"]] * 2
    assert (dirs[0] / "manifest.json").read_text() == \
        (dirs[1] / "manifest.json").read_text()
    with np.load(dirs[0] / "arrays_p0.npz") as a, \
            np.load(dirs[1] / "arrays_p0.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
