"""Serving a batch the batch axes do not divide, with the model still split,
in the port, against ``repro``.

``repro``'s ``_serve_wrap`` returns None for such a batch (``long_500k``'s
one row) and serves it on its pjit path, where GSPMD keeps every leaf and
the cache's ``kv_seq`` sharded over ``"model"`` and replicates the batch
dim.  The port's ``launch/dryrun._serve_wrap`` passes every rank all the
rows inside the manual region of the batch axes (``"serve_replicated"``):
heads, d_ff, the virtual experts, the vocabulary, the SSD heads and the
K/V slots stay split over the model ranks, the data ranks compute the
same rows, and an expert's capacity counts every row's tokens.

The ranks run on (data 2, model 2) as gloo processes on the CPU
(``tests/_torch_tp_ranks.py``, job ``solo_serve``, one spawn) while the
parent computes ``repro``'s single-device prefill and greedy decode in
fp32 on the same weights (``models/convert.py`` carries them over).
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import join_ranks, rank_results, spawn_ranks

TAG = "2x2"
DATA, MODEL = 2, 2
# (arch, overrides, SERVE_RULES_BIG, prompt length, decode steps, max_len).
# granite at capacity 1.0 drops assignments, so which rows share a
# capacity decides its logits; mixtral's 20-token prompt wraps its ring of
# 16 slots (the reduced window) at the prefill; hymba's 8 meta tokens + 32
# slots make blocks of 20, the first holding the sinks; hymba at 25 / 5
# heads straddles its GQA groups at model 2 (tests/test_torch_ssm_axis.py)
FAMILIES = {
    "qwen2": ("qwen2-0.5b", {}, False, 14, 6, 32),
    "granite": ("granite-moe-3b-a800m", {"capacity_factor": 1.0}, False,
                14, 6, 32),
    "mixtral": ("mixtral-8x22b", {}, True, 20, 6, 32),
    "hymba": ("hymba-1.5b", {"num_heads": 25, "num_kv_heads": 5}, False,
              20, 6, 32),
    "mamba2": ("mamba2-780m", {}, False, 12, 6, 24),
}
BATCHES = (1, 3)                # neither divides over the 2 data ranks
RUNS = [(f, b) for f in FAMILIES for b in BATCHES]
# in fp32 against repro (tests/test_torch_seq_axis.py's kv_serve bound):
# logits and K/V within 1e-4 of the largest entry
OF_MAX = 1e-4
# the families with an SSM keep the conv tail in bf16 whatever the compute
# dtype, as repro does: the prefill writes an fp32 input that the split's
# blocking moves by a rounding, which can land one bf16 ulp (2^-8) apart
# (mamba2 at batch 3: one entry of 1,728 at layer 0), and every decode step
# reads it back.  So the prefill's logits are held to OF_MAX, the decode
# steps' logits and the decoded SSM state to a quarter of a bf16 ulp of the
# largest entry (that one flipped entry moved them 1.35e-4 and 2.6e-4), the
# conv tail to a bf16 ulp (tests/test_torch_ssm_axis.py's CONV_RTOL)
DECODED_OF_MAX, CONV_OF_MAX = 2 ** -10, 2 ** -7


def _jax_config(arch, overrides):
    from repro.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _inputs():
    from repro.models import build_model
    solo = {}
    for name, (arch, ov, big, prompt, steps, max_len) in FAMILIES.items():
        cfg = _jax_config(arch, ov)
        tree = _flat(jax.tree_util.tree_map(
            np.asarray, build_model(cfg).init(jax.random.PRNGKey(5))))
        prompts = np.random.default_rng(30).integers(
            0, cfg.vocab_size, (max(BATCHES), prompt))
        for b in BATCHES:
            solo[name, b] = dict(arch=arch, overrides=ov, big=big,
                                 steps=steps, max_len=max_len, tree=tree,
                                 prompts=prompts[:b])
    return solo


def _jax_greedy(c, prompts=None, steps=None):
    """``repro``'s single-device prefill and greedy decode in fp32 over an
    fp32 K/V cache, all the rows at once: the logits of every step (the
    prefill's last position first), the greedy tokens and the cache."""
    from repro.models import build_model
    from _torch_dp_ranks import unflatten
    model = build_model(_jax_config(c["arch"], c["overrides"]))
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(c["tree"]))
    prompts = jnp.asarray((c["prompts"] if prompts is None
                           else prompts).astype(np.int32))
    Bp, Sp = prompts.shape
    cache = model.init_cache(Bp, c["max_len"], kv_dtype=jnp.float32)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": prompts},
                                           cache)
    outs = [np.asarray(logits[:, -1], np.float32)]
    decode = jax.jit(model.decode_step)
    for i in range((c["steps"] if steps is None else steps) - 1):
        tok = jnp.asarray(outs[-1].argmax(-1).astype(np.int32))[:, None]
        logits, cache = decode(params, cache, tok,
                               jnp.full((Bp,), Sp + i, jnp.int32))
        outs.append(np.asarray(logits[:, -1], np.float32))
    logits = np.stack(outs, 1)
    return dict(logits=logits, tokens=logits.argmax(-1),
                cache={k: np.asarray(v, np.float32)
                       for k, v in cache.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("solo_ranks")
    solo = _inputs()
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(dict(solo=solo, solo_runs=RUNS), f)
    procs = spawn_ranks(workdir, TAG, ["solo_serve"],
                        module="_torch_tp_ranks")
    try:
        refs = {run: _jax_greedy(c) for run, c in solo.items()}
        # granite's three rows served as two batches, as a per-data-rank
        # capacity would count them: its prefill must read otherwise
        c = solo["granite", 3]
        refs["granite_split"] = np.concatenate(
            [_jax_greedy(c, c["prompts"][sl], steps=1)["logits"]
             for sl in (slice(0, 2), slice(2, 3))])
    finally:
        join_ranks(procs)
    return rank_results(workdir, "solo_serve", TAG), refs, solo


def _close(got, want, of_max, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= of_max * scale, (what, err, scale)


def _model_groups():
    """Global ranks of each model group, rank = data rank * MODEL + model
    rank."""
    return [list(range(i, i + MODEL)) for i in range(0, DATA * MODEL, MODEL)]


@pytest.mark.parametrize("run", RUNS, ids=[f"{f}-b{b}" for f, b in RUNS])
def test_torch_solo_serve_matches_jax(ranks, run):
    """Prefill and greedy decode of all the rows on every rank, in fp32
    against ``repro``'s single-device run over the same rows: logits
    within 1e-4 of the largest at every step (a quarter of a bf16 ulp at
    the decode steps of the families with an SSM, which read their conv
    tail back from bf16), equal greedy tokens; the
    K/V cache cut into a block of the slots a model rank, the blocks
    joined equal to ``repro``'s cache; the SSM cache the rank's head
    slice of ``repro``'s; each rank holding its plan's shards of the
    leaves, not the whole model; every call on ``serve_replicated``."""
    res, refs, solo = ranks
    c, ref = solo[run], refs[run]
    cfg = _jax_config(c["arch"], c["overrides"])
    B = len(c["prompts"])
    decoded = DECODED_OF_MAX if cfg.ssm_state_dim else OF_MAX
    for group in _model_groups():
        for rank in group:
            got = res[rank][run]
            assert got["paths"] == ["serve_replicated"] * c["steps"]
            assert got["logits"].shape == ref["logits"].shape
            assert np.isfinite(got["logits"]).all()
            _close(got["logits"][:, 0], ref["logits"][:, 0], OF_MAX,
                   "prefill logits")
            _close(got["logits"][:, 1:], ref["logits"][:, 1:], decoded,
                   "decode logits")
            np.testing.assert_array_equal(got["logits"].argmax(-1),
                                          ref["tokens"])
            assert got["held"] == got["shards"] < got["whole"]
            assert got["kv_shards"] == (MODEL if cfg.uses_attention else 1)
            if cfg.ssm_state_dim:
                h0, h1 = got["heads"]
                hd, din = cfg.ssm_head_dim, cfg.d_inner
                assert got["ssm_shards"] == MODEL
                assert h1 - h0 == cfg.ssm_num_heads // MODEL
                _close(got["cache"]["ssm_state"],
                       ref["cache"]["ssm_state"][:, :, h0:h1], decoded,
                       "ssm_state")
                conv = ref["cache"]["ssm_conv"]
                conv = np.concatenate([conv[..., h0 * hd:h1 * hd],
                                       conv[..., din:]], -1)
                _close(got["cache"]["ssm_conv"], conv, CONV_OF_MAX,
                       "ssm_conv")
        if not cfg.uses_attention:
            continue
        for name in ("k", "v"):
            parts = [res[r][run]["cache"][name] for r in group]
            assert all(p.shape[1] == B for p in parts)
            union = np.concatenate(parts, axis=2)
            assert union.shape == ref["cache"][name].shape
            _close(union, ref["cache"][name], OF_MAX, name)


@pytest.mark.parametrize("run", RUNS, ids=[f"{f}-b{b}" for f, b in RUNS])
def test_torch_solo_serve_data_ranks_bit_equal(ranks, run):
    """The data ranks compute the same rows: each model rank's logits at
    every step and its cache's leaves are bit-equal across the data
    ranks."""
    res = ranks[0]
    for m in range(MODEL):
        first = res[m][run]
        for d in range(1, DATA):
            other = res[d * MODEL + m][run]
            assert other["logits"].tobytes() == first["logits"].tobytes()
            assert other["cache"].keys() == first["cache"].keys()
            for k, v in first["cache"].items():
                assert other["cache"][k].tobytes() == v.tobytes(), k


def test_torch_solo_serve_capacity_counts_every_row(ranks):
    """granite at capacity 1.0 drops assignments: its three rows served
    as two batches (a capacity per batch) read other prefill logits than
    all three at once, and the ranks read the latter."""
    res, refs, _ = ranks
    whole = refs["granite", 3]["logits"][:, :1]
    split = refs["granite_split"]
    scale = float(np.max(np.abs(whole)))
    assert float(np.max(np.abs(split - whole))) > OF_MAX * scale
    for r in res:
        _close(r["granite", 3]["logits"][:, :1], whole, OF_MAX, "prefill")


def test_torch_serve_path_and_local_rows_refusal():
    """``serve_path`` names the path of a batch on a (data 2, model 2)
    mesh and on a (pod 2, data 2, model 2) one; ``dp_shard.local_rows``
    still refuses a batch the batch axes do not divide, and cuts one they
    do."""
    from repro_torch.distributed import dp_shard
    from repro_torch.launch.dryrun import serve_path

    class Mesh:
        def __init__(self, shape):
            self.shape = shape

        def get_local_rank(self, axis):
            return 1

    m2 = Mesh({"data": 2, "model": 2})
    m4 = Mesh({"pod": 2, "data": 2, "model": 2})
    assert [serve_path(m2, b) for b in (1, 2, 3, 4)] == \
        ["serve_replicated", "serve_wrap"] * 2
    assert [serve_path(m4, b) for b in (2, 4, 6, 8)] == \
        ["serve_replicated", "serve_wrap", "serve_replicated", "serve_wrap"]
    for mesh, b in ((m2, 3), (m4, 6)):
        with pytest.raises(ValueError, match="batch shards"):
            dp_shard.local_rows(mesh, {"tokens": torch.zeros(b, 4)})
    rows = dp_shard.local_rows(m4, {"tokens": torch.arange(8)[:, None]})
    assert rows["tokens"].ravel().tolist() == [6, 7]      # shard 3 of 4
