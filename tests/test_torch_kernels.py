"""The port's kernel layer on the CPU against the JAX package's kernels.

On the CPU the port's wrappers take their plain PyTorch twins; these are
held against ``repro``'s Pallas kernels in interpret mode and against
``repro.kernels.ref``, on the shapes and tolerances of test_kernels.py.
The hand-written CUDA / Triton kernels themselves run only on the card
(``chip_smoke.py`` holds them against the same twins there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, rand
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn

FLASH_CASES = [
    (1, 32, 32, 4, 4, 16, True, 0),      # MHA causal
    (2, 64, 64, 4, 2, 32, True, 0),      # GQA causal
    (2, 48, 48, 6, 2, 16, False, 0),     # non-causal (encoder)
    (1, 64, 64, 4, 1, 16, True, 20),     # sliding window, MQA
    (2, 40, 40, 4, 4, 24, True, 0),      # non-pow2 seq + head_dim 24
    (1, 128, 128, 8, 8, 64, True, 48),   # bigger window
]


def _close(out, expect, tol):
    np.testing.assert_allclose(as_f32(out), as_f32(expect), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", FLASH_CASES)
def test_torch_flash_matches_jax(B, S, T, H, K, D, causal, window, dtype):
    jq, tq = rand(0, (B, S, H, D), dtype)
    jk, tk = rand(1, (B, T, K, D), dtype)
    jv, tv = rand(2, (B, T, K, D), dtype)
    kernel = jflash(jq, jk, jv, causal=causal, window=window, block_q=16,
                    block_k=16, interpret=True)
    oracle = jref.mha(jq, jk, jv, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for out in (ops.attention(tq, tk, tv, causal=causal, window=window),
                fa.flash_attention(tq, tk, tv, causal=causal, window=window),
                ref.mha(tq, tk, tv, causal=causal, window=window)):
        assert out.dtype == tq.dtype and out.shape == tq.shape
        _close(out, kernel, tol)
        _close(out, oracle, tol)


@pytest.mark.parametrize("S,T,q_offset,window", [(16, 64, 48, 0),
                                                 (24, 40, 16, 12)])
def test_torch_flash_q_offset_matches_jax(S, T, q_offset, window):
    jq, tq = rand(3, (2, S, 4, 32))
    jk, tk = rand(4, (2, T, 2, 32))
    jv, tv = rand(5, (2, T, 2, 32))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    expect = jflash(jq, jk, jv, block_q=8, block_k=16, interpret=True, **kw)
    _close(fa.flash_attention(tq, tk, tv, **kw), expect, 2e-5)
    _close(ops.attention(tq, tk, tv, **kw), expect, 2e-5)


@pytest.mark.parametrize("window,sink", [(0, 0), (24, 0), (24, 4)])
def test_torch_mha_chunked_matches_jax(window, sink):
    jq, tq = rand(0, (2, 100, 4, 16))
    jk, tk = rand(1, (2, 100, 2, 16))
    jv, tv = rand(2, (2, 100, 2, 16))
    expect = jref.mha_chunked(jq, jk, jv, causal=True, window=window,
                              num_sink=sink, block_q=32)
    out = ref.mha_chunked(tq, tk, tv, causal=True, window=window,
                          num_sink=sink, block_q=32)
    _close(out, expect, 1e-5)
    _close(out, ref.mha(tq, tk, tv, causal=True, window=window,
                        num_sink=sink), 1e-5)


def test_torch_long_sequences_take_the_chunked_path():
    """S >= 1024 on the CPU goes through mha_chunked and equals mha."""
    _, tq = rand(0, (1, 1024, 2, 16))
    _, tk = rand(1, (1, 1024, 1, 16))
    _, tv = rand(2, (1, 1024, 1, 16))
    _close(ops.attention(tq, tk, tv, causal=True),
           ref.mha(tq, tk, tv, causal=True), 1e-5)


@pytest.mark.parametrize("window,sink,softcap", [(0, 0, 0.0), (6, 0, 0.0),
                                                 (6, 2, 0.0), (0, 0, 5.0)])
def test_torch_ragged_decode_matches_jax(window, sink, softcap):
    """Decode-style calls (q_pos, kv_pos, kv_valid) take ref.mha on every
    device and agree with repro.kernels.ref.mha."""
    B, T = 3, 20
    jq, tq = rand(6, (B, 1, 4, 16))
    jk, tk = rand(7, (B, T, 2, 16))
    jv, tv = rand(8, (B, T, 2, 16))
    pos = np.array([4, 11, 19], np.int32)
    kv_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kw = dict(causal=True, window=window, num_sink=sink, softcap=softcap)
    expect = jref.mha(jq, jk, jv, q_pos=pos[:, None], kv_pos=kv_pos,
                      kv_valid=pos + 1, **kw)
    tpos = torch.as_tensor(pos, dtype=torch.long)
    out = ops.attention(tq, tk, tv, q_pos=tpos[:, None],
                        kv_pos=torch.as_tensor(kv_pos, dtype=torch.long),
                        kv_valid=tpos + 1, **kw)
    _close(out, expect, 2e-5)


def test_torch_attention_mask_matches_jax():
    q_pos = np.array([[3, 4, 5], [0, 1, 9]], np.int32)
    kv_pos = np.array([[-1, 0, 1, 2, 3, 4, 5, 6]] * 2, np.int32)
    valid = np.array([5, 8], np.int32)
    for causal, window, sink in [(True, 0, 0), (True, 3, 0), (False, 3, 1)]:
        expect = jref.attention_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                     causal=causal, window=window,
                                     kv_valid=jnp.asarray(valid),
                                     num_sink=sink)
        out = ref.attention_mask(torch.as_tensor(q_pos),
                                 torch.as_tensor(kv_pos), causal=causal,
                                 window=window,
                                 kv_valid=torch.as_tensor(valid),
                                 num_sink=sink)
        np.testing.assert_array_equal(out.numpy(), np.asarray(expect))


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 100), (1, 1, 1, 256),
                                   (5, 333)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_rmsnorm_matches_jax(shape, dtype):
    jx, tx = rand(0, shape, dtype)
    js, ts = rand(1, shape[-1:])
    kernel = jrmsnorm(jx, js, interpret=True)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for out in (ops.rmsnorm(tx, ts), rn.rmsnorm(tx, ts),
                rn.rmsnorm_plain(tx, ts)):
        assert out.dtype == tx.dtype and out.shape == tx.shape
        _close(out, kernel, tol)
        _close(out, jref.rmsnorm(jx, js), tol)


def test_torch_cpu_path_never_counts_a_launch():
    fa.flash_attention.launches = 0
    rn.rmsnorm.launches = 0
    _, t = rand(0, (1, 16, 2, 16))
    ops.attention(t, t[:, :, :1], t[:, :, :1])
    ops.rmsnorm(t, torch.ones(16))
    assert fa.flash_attention.launches == 0
    assert rn.rmsnorm.launches == 0


def test_torch_wrappers_refuse_what_the_kernels_do_not_take():
    """Tensors on neither the CPU nor CUDA raise instead of falling back,
    and the flash wrapper's checks reject shapes the kernel cannot run."""
    q = torch.empty((1, 8, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="no kernel"):
        rn.rmsnorm(q, torch.empty((16,), device="meta"))
    ok = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    fa._check(ok, kv, kv)
    with pytest.raises(ValueError, match="multiple"):
        fa._check(ok, torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="head dim"):
        fa._check(torch.zeros((1, 8, 4, 40)), torch.zeros((1, 8, 2, 40)),
                  torch.zeros((1, 8, 2, 40)))
    with pytest.raises(TypeError):
        fa._check(ok.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="unit stride"):
        fa._check(torch.zeros((1, 8, 16, 4)).transpose(2, 3), kv, kv)


def test_torch_kernel_build_targets_hopper():
    """The CUDA build compiles for sm_90a into a content-addressed library
    under build/, which .gitignore lists."""
    from pathlib import Path

    from repro_torch.kernels import _build
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    lib = _build.library_path("flash_attention")
    root = Path(__file__).resolve().parents[1]
    assert lib.parent == root / "build" / "kernels"
    assert lib == _build.library_path("flash_attention")
    assert "build/" in (root / ".gitignore").read_text().split()
