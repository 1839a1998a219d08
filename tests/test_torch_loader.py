"""The port's data plane against ``repro``'s.

For the same seed, dataset and ``LoaderParams``, a ``repro`` loader
(``to_device=False``) and a ``repro_torch`` loader (``device="cpu"``,
through its device edge) deliver byte-identical batches: across every
delivery knob, across a hot swap and an elastic reshard of a live stream,
and after a ``state_dict`` carried from one package to the other.  Times
are never held here: this box has one core.
"""
import json
import math

import numpy as np
import pytest
import torch

from _torch_support import batch_key, host_copy, image_loaders, same_bytes

import repro_torch.data as tdata
from repro_torch.core import DPT, DPTConfig, LoaderEvaluator
from repro_torch.data.loader import TransferStats
from repro_torch.data.prefetcher import (DevicePrefetcher, StagingPool,
                                         put_global_batch)

NB = 16     # batches compared per case: past one epoch of 96 items at gb 8


def _take(stream, k):
    return [host_copy(next(stream)) for _ in range(k)]


def _pair_streams(jl, tl):
    return jl.stream(to_device=False), tl.stream(to_device=True)


def _assert_same_sequence(ref, port):
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert same_bytes(a, b), f"batch {i} differs"


KNOBS = {
    "default": dict(num_workers=2),
    "no_fast_path": dict(num_workers=2, fast_path=False),
    "zero_copy": dict(num_workers=3, prefetch_factor=2, zero_copy=True),
    "zero_copy_unstaged": dict(num_workers=2, zero_copy=True,
                               staging_buffers=0),
    "zero_copy_two_lanes": dict(num_workers=2, zero_copy=True,
                                transfer_threads=2),
    "locality_chunk": dict(num_workers=2, locality_chunk=8),
    "cache_budget": dict(num_workers=2, locality_chunk=8,
                         cache_budget_bytes=1 << 14),
    "slow_lane": dict(num_workers=2, slow_lane_workers=1,
                      slow_lane_lookahead=2),
    "processes": dict(num_workers=2, use_processes=True),
    "zero_workers": dict(num_workers=0),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_torch_loader_delivers_repros_bytes(knob):
    jl, tl = image_loaders(KNOBS[knob])
    js, ts = _pair_streams(jl, tl)
    try:
        ref, port = _take(js, NB), _take(ts, NB)
    finally:
        js.close()
        ts.close()
    _assert_same_sequence(ref, port)
    assert all(isinstance(v, np.ndarray) for v in port[0].values())


def test_torch_loader_unordered_delivers_repros_multiset():
    """``ordered=False`` delivers in completion order: one epoch, through
    the port's device edge, is the same multiset of batches."""
    params = dict(num_workers=3, ordered=False, zero_copy=True)
    jl, tl = image_loaders(params)
    ref = [host_copy(b) for b in jl.host_batches(epoch=0)]
    pf = DevicePrefetcher(tl.host_batches(epoch=0), device="cpu")
    port = [host_copy(b) for b in pf]
    assert len(ref) == 96 // 8
    assert sorted(map(batch_key, ref)) == sorted(map(batch_key, port))


@pytest.mark.parametrize("policy", ["skip", "substitute"])
def test_torch_loader_bad_samples_match_repro(policy):
    """Corrupt items and transient faults, each package through its own
    ``FaultyStorage`` with the same spec: the same batches (shorter ones
    under "skip", resampled members under "substitute") and the same
    quarantine."""
    spec = dict(corrupt_items=(3, 17, 40, 41), transient_rate=0.2, seed=7)
    params = dict(num_workers=2, on_bad_sample=policy, retry_attempts=3,
                  retry_backoff_s=0.0, degraded_fault_rate=0.0)
    jl, tl = image_loaders(params, fault_spec=spec)
    js, ts = _pair_streams(jl, tl)
    try:
        ref, port = _take(js, NB), _take(ts, NB)
    finally:
        js.close()
        ts.close()
    _assert_same_sequence(ref, port)
    assert tl.quarantine.state_dict() == jl.quarantine.state_dict()
    assert [i for i, _ in tl.quarantine.state_dict()["items"]] == \
        [3, 17, 40, 41]
    if policy == "skip":
        assert any(b["image"].shape[0] < 8 for b in port)


def test_torch_loader_hot_swap_on_a_live_stream_matches_repro():
    """``apply_params`` mid-stream (workers, prefetch, device depth,
    staging, zero-copy and locality): the same sequence, nothing lost or
    repeated, in both packages."""
    jl, tl = image_loaders(dict(num_workers=2, prefetch_factor=2))
    js, ts = _pair_streams(jl, tl)
    new = dict(num_workers=3, prefetch_factor=3, device_prefetch=3,
               staging_buffers=3, zero_copy=True, locality_chunk=8)
    try:
        ref, port = _take(js, 5), _take(ts, 5)
        # the locality change latches at an epoch the producer has not
        # reached; pinned, so run-ahead cannot move it
        jl.apply_params(jl.params.replace(**new), locality_epoch=2)
        tl.apply_params(tl.params.replace(**new), locality_epoch=2)
        ref += _take(js, 2 * NB)
        port += _take(ts, 2 * NB)
        assert js.swaps == ts.swaps == 1
        assert ts._prefetcher.depth == 3
        assert tl.sampler.chunk_for_epoch(1) == 0
        assert tl.sampler.chunk_for_epoch(2) == 8
    finally:
        js.close()
        ts.close()
    _assert_same_sequence(ref, port)


def test_torch_loader_reshard_on_a_live_stream_matches_repro():
    """``reshard`` at a barrier with a makeup chunk: old-shard batches up
    to the barrier, then the makeup, then this host's half of each global
    batch — the same bytes in both packages."""
    jl, tl = image_loaders(dict(num_workers=2, zero_copy=True))
    js, ts = _pair_streams(jl, tl)
    makeup = [np.arange(60, 64)]
    try:
        ref, port = _take(js, 3), _take(ts, 3)
        barrier = js.position + 2
        assert jl.reshard(2, 1, at_batch=barrier, makeup=makeup) == \
            tl.reshard(2, 1, at_batch=barrier, makeup=makeup) == barrier
        ref += _take(js, NB)
        port += _take(ts, NB)
        assert js.reshards == ts.reshards == 1
    finally:
        js.close()
        ts.close()
    _assert_same_sequence(ref, port)
    assert port[-1]["image"].shape[0] == 4      # half of global batch 8


@pytest.mark.parametrize("direction", ["repro_to_port", "port_to_repro"])
def test_torch_loader_state_dict_crosses_packages(direction):
    """A checkpoint taken mid-epoch (with a deferred locality change, a
    learned cost table and a quarantine) loads into the other package's
    loader, through json, and both continue with the same batches."""
    spec = dict(corrupt_items=(5,), seed=1)
    params = dict(num_workers=2, on_bad_sample="skip", retry_backoff_s=0.0)
    jl, tl = image_loaders(params, fault_spec=spec)
    src, dst = (jl, tl) if direction == "repro_to_port" else (tl, jl)
    list(src.host_batches(num_batches=5))
    src.apply_params(src.params.replace(locality_chunk=8))
    state = json.loads(json.dumps(src.state_dict()))
    assert state["quarantine"]["items"] and state["costs"]["records"]
    dst.load_state_dict(state)
    assert dst.params.locality_chunk == 8
    assert dst.sampler.chunk_for_epoch(1) == 8
    assert dst.cost_tracker.records == src.cost_tracker.records
    assert dst.quarantine.state_dict() == src.quarantine.state_dict()

    a = [host_copy(b) for b in src.host_batches(num_batches=NB)]
    b = [host_copy(b) for b in dst.host_batches(num_batches=NB)]
    _assert_same_sequence(a, b)


def test_torch_zero_copy_batches_stay_private_after_slabs_recycle():
    """With ``zero_copy=True`` on the CPU device every delivered tensor is
    a private copy: after the stream has moved on and recycled every slab
    (staged and unstaged), each equals its first reading."""
    for staging in (2, 0):
        _, tl = image_loaders(dict(num_workers=2, prefetch_factor=1,
                                   zero_copy=True, staging_buffers=staging))
        ts = tl.stream(to_device=True)
        try:
            kept, first = [], []
            for _ in range(NB):
                b = next(ts)
                kept.append(b)
                first.append(host_copy(b))
            arena = tl._stream_arena
            assert arena is not None and arena.capacity < NB
        finally:
            ts.close()
        for b, f in zip(kept, first):
            assert all(isinstance(v, torch.Tensor) for v in b.values())
            assert same_bytes(host_copy(b), f)


def test_torch_put_global_batch_on_the_cpu_copies():
    src = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
           "y": np.arange(3, dtype=np.int32)}
    out = put_global_batch(src, "cpu")
    src["x"][:] = -1
    assert out["x"].dtype == torch.float32 and out["y"].dtype == torch.int32
    assert torch.equal(out["x"], torch.arange(12.).reshape(3, 4))


def test_torch_staging_pool_counts_and_ragged_batches():
    pool = StagingPool(2)
    full = {"x": np.zeros((8, 3), np.float32)}
    a = pool.acquire(full)
    pool.release(a)
    b = pool.acquire(full)
    assert b is a and pool.hits == 1 and pool.misses == 1
    short = pool.acquire({"x": np.zeros((5, 3), np.float32)})
    assert short["x"].shape == (5, 3) and pool.misses == 2
    pool.release(short)                 # not the latched spec: dropped
    pool.release(b)
    assert pool.acquire(full) is a and pool.retired == 0
    assert pool.hit_rate == pytest.approx(2 / 4)


def test_torch_prefetcher_set_depth_and_staging_live():
    """``set_depth`` and ``set_staging`` on a live prefetcher: the bytes
    keep matching ``repro``'s, and the knobs read back."""
    jl, tl = image_loaders(dict(num_workers=2, zero_copy=True))
    js, ts = _pair_streams(jl, tl)
    pf = ts._prefetcher
    try:
        ref, port = _take(js, 3 * 5), _take(ts, 3)
        pf.set_depth(4)
        pf.set_staging(0)
        port += _take(ts, 4)
        assert pf.depth == 4 and pf.staging_hit_rate is None
        pf.set_depth(1)
        pf.set_staging(3)
        port += _take(ts, 8)
        assert pf.depth == 1 and pf._staging.capacity == 3
        assert pf.staging_hit_rate is not None
    finally:
        js.close()
        ts.close()
    _assert_same_sequence(ref, port)


def test_torch_prefetcher_raises_a_transfer_error_to_the_consumer():
    def bad():
        yield {"x": np.zeros(2, np.float32)}
        yield {"x": object()}

    pf = DevicePrefetcher(bad(), device="cpu")
    it = iter(pf)
    assert torch.equal(next(it)["x"], torch.zeros(2))
    with pytest.raises(TypeError):
        next(it)
    pf.close()


def test_torch_loader_and_prefetcher_refuse_cuda_without_a_card(monkeypatch):
    """The default device is CUDA; with no card both raise at
    construction instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = tdata.synthetic_image_dataset(8, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.DataLoader(ds, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrefetcher(iter([]))


def test_torch_loader_evaluator_trial_reports_transfer_stats():
    _, tl = image_loaders(dict(zero_copy=True), latency_s=1e-4)
    ev = LoaderEvaluator(tl, to_device=True)
    stats = ev(2, 2, num_batches=4)
    assert isinstance(stats, TransferStats) and ev.calls == 1
    assert stats.batches == 4 and not stats.overflowed
    assert stats.bytes == 4 * 8 * (8 * 8 * 3 * 4 + 4)
    assert len(stats.batch_seconds) == 4 and stats.seconds > 0
    assert stats.peak_loader_bytes > 0
    assert stats.staging_hit_rate is not None
    assert stats.coalesced_requests > 0
    assert tl.params.num_workers == 2 and tl.params.zero_copy


def test_torch_quickstart_flow_small():
    """``examples/quickstart.py`` at a small size: DPT over the real loader
    (device edge included), then the tuned loader in use."""
    _, tl = image_loaders(n=64, res=16, latency_s=2e-4)
    cfg = DPTConfig(num_cpu_cores=4, num_devices=1, max_prefetch=2,
                    num_batches=4)
    result = DPT(LoaderEvaluator(tl, to_device=True), cfg).run()
    cells = {(t.nworker, t.nprefetch) for t in result.trials}
    assert {(i, j) for i in (1, 2, 3, 4) for j in (1, 2)} <= cells
    assert (result.nworker, result.nprefetch) in cells
    assert math.isfinite(result.optimal_time) and result.default_time > 0
    assert result.optimal_time == min(t.seconds for t in result.trials)
    tl.with_params(tdata.LoaderParams(num_workers=result.nworker,
                                      prefetch_factor=result.nprefetch))
    stats = tl.measure_transfer_time(8, to_device=True)
    assert stats.batches == 8 and stats.bytes == 8 * 8 * (16 * 16 * 3 * 4 + 4)


def test_torch_tuned_token_stream_trains_like_repro():
    """The slice as a whole, reduced: a token dataset behind latency
    storage, tuned with DPT over the real loader, streamed through the
    port's device edge (int32 tokens, as ``repro``'s loader delivers) into
    the port's mamba2 train step, against ``repro``'s loader and JAX train
    step from the same state: the same batches and the same losses."""
    import jax

    import repro.data as jdata
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    jcfg = jreduced(jget_config("mamba2-780m"))
    opt = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10, eps=1e-4)
    jtc = jts.TrainStepConfig(optimizer=jopt.AdamWConfig(**opt))
    jstate = jts.init_train_state(build_model(jcfg), jax.random.PRNGKey(0),
                                  jtc)
    tstate = from_jax_train_state(
        reduced(get_config("mamba2-780m")),
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")

    loaders = []
    for pkg in (jdata, tdata):
        ds = pkg.token_dataset(16, 12, jcfg.vocab_size, seed=0)
        ds = ds.with_storage(pkg.LatencyStorage(ds.storage, latency_s=1e-4,
                                                bandwidth=1e9))
        kw = {} if pkg is jdata else {"device": "cpu"}
        loaders.append(pkg.DataLoader(ds, 4, seed=0, **kw))
    jl, tl = loaders
    result = DPT(LoaderEvaluator(tl, to_device=True),
                 DPTConfig(num_cpu_cores=2, num_devices=None, max_prefetch=2,
                           num_batches=2)).run()
    tl.with_params(tl.params.replace(num_workers=result.nworker,
                                     prefetch_factor=result.nprefetch))

    jstep = jax.jit(jts.make_train_step(build_model(jcfg), jtc))
    tstep = tts.make_train_step(tstate.model, tts.TrainStepConfig(
        optimizer=topt.AdamWConfig(**opt)))
    js, ts = jl.stream(to_device=False), tl.stream(to_device=True)
    try:
        for _ in range(2):
            jb, tb = next(js), next(ts)
            assert tb["tokens"].dtype == torch.int32
            assert same_bytes(host_copy(jb), host_copy(tb))
            jstate, jm = jstep(jstate, jb)
            tstate, tm = tstep(tstate, tb)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-4)
    finally:
        js.close()
        ts.close()
