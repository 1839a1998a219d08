"""The port's SSD scan, SSM mixer and norm gradients on the CPU against the
JAX package.

On the CPU the port's ``ssd_scan`` wrapper takes its plain twin (the masked
chunked form); these hold it, ``ref.ssd_chunked`` and ``ref.ssd_naive``
against ``repro``'s Pallas ``ssd_scan`` in interpret mode and its jnp
references on the shapes and tolerances of test_kernels.py (fp32, atol
1e-4, rtol 1e-3: the chunked and sequential forms sum in different
orders).  Gradients are held against ``jax.grad`` of ``repro.kernels.ref``.
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, jax_and_port, rand
from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm_residual as jrmsnorm_residual
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ss

SSD_SHAPES = [
    (1, 32, 2, 8, 1, 4, 8),
    (2, 64, 4, 16, 2, 8, 16),
    (2, 64, 4, 16, 4, 8, 32),     # groups == heads
    (1, 96, 6, 8, 2, 16, 24),     # chunk not a power of two
]


def ssd_inputs(b, s, h, p, g, n, *, a_scale=0.5, a_value=None):
    """The inputs of test_kernels.py's SSD cases for both frameworks:
    dt = softplus(N(0,1)), A = -exp(N(0,1) * a_scale) (or -a_value)."""
    jx, tx = rand(0, (b, s, h, p))
    jdt_raw, tdt_raw = rand(1, (b, s, h))
    jA_raw, tA_raw = rand(2, (h,))
    jB, tB = rand(3, (b, s, g, n))
    jC, tC = rand(4, (b, s, g, n))
    jdt = jax.nn.softplus(jdt_raw)
    tdt = torch.tensor(np.asarray(jdt, np.float32))
    if a_value is None:
        jA = -jnp.exp(jA_raw * a_scale)
    else:
        jA = -jnp.full((h,), a_value, jnp.float32)
    tA = torch.tensor(np.asarray(jA, np.float32))
    return (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC)


def _close(out, expect, atol=1e-4, rtol=1e-3):
    np.testing.assert_allclose(as_f32(out), as_f32(expect), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_torch_ssd_matches_jax(b, s, h, p, g, n, chunk):
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    naive, jstate = jref.ssd_naive(*jin)
    kernel = jssd_scan(*jin, chunk=chunk, interpret=True)
    _, jchunk_state = jref.ssd_chunked(*jin, chunk=chunk)
    tnaive, tnaive_state = ref.ssd_naive(*tin)
    tchunked, tstate = ref.ssd_chunked(*tin, chunk=chunk)
    for out in (tnaive, tchunked, ss.ssd_scan(*tin, chunk=chunk),
                ss.ssd_scan_plain(*tin, chunk=chunk),
                ops.ssd(*tin, chunk=chunk)):
        assert out.shape == (b, s, h, p) and out.dtype == torch.float32
        _close(out, naive)
        _close(out, kernel)
    for state in (tnaive_state, tstate):
        assert state.shape == (b, h, p, n)
        _close(state, jstate)
        _close(state, jchunk_state)


@pytest.mark.parametrize("s,chunk", [(30, 8), (20, 256), (50, 24)])
def test_torch_ops_ssd_pads_like_jax(s, chunk):
    """A sequence that is not a multiple of the chunk is padded and cut
    back, with the chunk clamped to the sequence, as JAX's ops.ssd does."""
    from repro.kernels import ops as jops
    jin, tin = ssd_inputs(2, s, 4, 8, 2, 4)
    out = ops.ssd(*tin, chunk=chunk)
    assert out.shape == (2, s, 4, 8)
    _close(out, jops.ssd(*jin, chunk=chunk))
    _close(out, jref.ssd_naive(*jin)[0])


def test_torch_ssd_accepts_strided_views():
    """x, B, C as slices of one conv output (the model's layout) give the
    same result as contiguous copies."""
    _, tin = ssd_inputs(2, 32, 4, 8, 1, 4)
    x, dt, A, B, C = tin
    u = torch.cat([x.reshape(2, 32, 32), B.reshape(2, 32, 4),
                   C.reshape(2, 32, 4)], dim=-1)
    xv, Bv, Cv = torch.split(u, [32, 4, 4], dim=-1)
    out = ss.ssd_scan(xv.reshape(2, 32, 4, 8), dt, A, Bv.reshape(2, 32, 1, 4),
                      Cv.reshape(2, 32, 1, 4), chunk=8)
    torch.testing.assert_close(out, ss.ssd_scan(*tin, chunk=8), rtol=0,
                               atol=0)


def _jax_grads(fn, jin, dy):
    """Gradients of sum(fn(*jin)[0] * dy) for every input."""
    def loss(*args):
        return jnp.sum(fn(*args)[0] * dy)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jin)


def test_torch_ssd_backward_matches_jax_grad():
    """At chunk 8 ``ssd_scan_backward`` and the autograd path through
    ``ssd_scan`` match ``jax.grad`` of ``ref.ssd_chunked``."""
    b, s, h, p, g, n, chunk = 2, 32, 4, 8, 2, 4, 8
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    jdy, tdy = rand(5, (b, s, h, p))
    expect = _jax_grads(lambda *a: jref.ssd_chunked(*a, chunk=chunk), jin,
                        jdy)
    direct = ss.ssd_scan_backward(*tin, tdy, chunk=chunk)
    leaves = [t.clone().requires_grad_() for t in tin]
    y = ss.ssd_scan(*leaves, chunk=chunk)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    through_op = torch.autograd.grad(y, leaves, tdy)
    for got in (direct, through_op):
        for gt, ge in zip(got, expect):
            scale = float(np.abs(np.asarray(ge)).max())
            _close(gt, ge, atol=1e-5 * scale, rtol=1e-4)


def test_torch_ssd_backward_of_a_ragged_sequence():
    """The wgmma kernels' forward takes a sequence that is not a multiple
    of the chunk as it is (``ssd_scan.takes_ragged``); its backward pads
    inside the recompute and gives the gradients of the unpadded inputs:
    ``jax.grad`` of the sequential ``ref.ssd_naive``."""
    b, s, h, p, g, n, chunk = 2, 40, 4, 8, 2, 4, 16
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    jdy, tdy = rand(5, (b, s, h, p))
    expect = _jax_grads(jref.ssd_naive, jin, jdy)
    got = ss.ssd_scan_backward(*tin, tdy, chunk=chunk)
    for gt, ge, t in zip(got, expect, tin):
        assert gt.shape == t.shape
        scale = float(np.abs(np.asarray(ge)).max())
        _close(gt, ge, atol=1e-5 * scale, rtol=1e-4)


def test_torch_ssd_gradient_is_finite_at_chunk_256():
    """At the published chunk of 256 with real dt (softplus of N(0,1)) and
    A = -1, the reference's chunked form has a NaN gradient (it masks after
    its exp, which overflows for j > i); the port's, masked before the exp,
    is finite and matches ``jax.grad`` of the sequential ``ref.ssd_naive``."""
    b, s, h, p, g, n, chunk = 1, 256, 2, 8, 1, 16, 256
    jin, tin = ssd_inputs(b, s, h, p, g, n, a_value=1.0)
    jdy, tdy = rand(5, (b, s, h, p))
    jax_chunked = _jax_grads(lambda *a: jref.ssd_chunked(*a, chunk=chunk),
                             jin, jdy)
    assert not np.isfinite(np.asarray(jax_chunked[1])).all()   # d/d dt
    expect = _jax_grads(jref.ssd_naive, jin, jdy)
    got = ss.ssd_scan_backward(*tin, tdy, chunk=chunk)
    for gt, ge in zip(got, expect):
        assert torch.isfinite(gt).all()
        scale = float(np.abs(np.asarray(ge)).max())
        _close(gt, ge, atol=1e-4 * scale, rtol=1e-3)


def test_torch_ssm_layer_matches_jax():
    """``models.ssm.ssm`` of reduced mamba2 (chunk 8; S = 20 is padded) on
    layer 0's carried parameters against ``repro.models.ssm.ssm``."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    jmodel, params, port, cfg = jax_and_port("mamba2-780m")
    jx, tx = rand(7, (2, 20, cfg.d_model))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["ssm"])
    expect = jssm.ssm(jp, cfg, jx)
    out = tssm.ssm(port.layers[0]["ssm"], port.cfg, tx)
    assert out.shape == (2, 20, cfg.d_model)
    _close(out, expect, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 100), (5, 333)])
def test_torch_rmsnorm_backward_matches_jax_grad(shape):
    jx, tx = rand(0, shape)
    js, ts = rand(1, shape[-1:])
    jdy, tdy = rand(2, shape)
    gx, gs = jax.grad(lambda x, s: jnp.sum(jref.rmsnorm(x, s) * jdy),
                      argnums=(0, 1))(jx, js)
    direct = rn.rmsnorm_backward(tx, ts, tdy, 1e-6)
    x, scale = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    y = ops.rmsnorm(x, scale)
    assert "RMSNorm" in type(y.grad_fn).__name__
    through_op = torch.autograd.grad(y, (x, scale), tdy)
    for got in (direct, through_op):
        _close(got[0], gx, atol=1e-5, rtol=1e-4)
        _close(got[1], gs, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_rmsnorm_residual_matches_jax(dtype):
    """(4, 37, 96), the shape of test_rmsnorm_residual_fusion, against the
    interpret-mode Pallas kernel."""
    jx, tx = rand(0, (4, 37, 96), dtype)
    jr, tr = rand(1, (4, 37, 96), dtype)
    js, ts = rand(2, (96,))
    jnormed, jnew = jrmsnorm_residual(jx, jr, js, interpret=True)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for normed, new in (ops.rmsnorm_residual(tx, tr, ts),
                        rn.rmsnorm_residual(tx, tr, ts),
                        rn.rmsnorm_residual_plain(tx, tr, ts)):
        assert normed.dtype == new.dtype == tx.dtype
        _close(new, jnew, atol=tol, rtol=tol)
        _close(normed, jnormed, atol=tol, rtol=tol)
    _close(rn.rmsnorm_residual(tx, tr, ts)[1], (tx.float() + tr.float()),
           atol=tol, rtol=tol)


def test_torch_ssd_and_residual_cpu_paths_never_count_a_launch():
    ss.ssd_scan.launches = 0
    rn.rmsnorm_residual.launches = 0
    _, tin = ssd_inputs(1, 16, 2, 8, 1, 4)
    ops.ssd(*tin, chunk=8)
    x = torch.ones((3, 16))
    ops.rmsnorm_residual(x, x, torch.ones(16))
    assert ss.ssd_scan.launches == 0
    assert rn.rmsnorm_residual.launches == 0


def test_torch_ssd_wrapper_refuses_what_the_kernel_does_not_take():
    """Tensors on neither the CPU nor CUDA raise instead of falling back,
    and the checks reject what the CUDA kernel cannot run."""
    meta = torch.empty((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ss.ssd_scan(meta, meta[..., 0], meta[0, 0, :, 0], meta[..., :1, :4],
                    meta[..., :1, :4], chunk=8)
    with pytest.raises(ValueError, match="no kernel"):
        rn.rmsnorm_residual(meta, meta, torch.empty((8,), device="meta"))
    _, (x, dt, A, B, C) = ssd_inputs(1, 16, 2, 8, 1, 4)
    ss._check(x, dt, A, B, C, 8)
    with pytest.raises(ValueError, match="chunk"):
        ss._check(x, dt, A, B, C, 5)
    with pytest.raises(ValueError, match="multiple"):
        ss._check(torch.zeros((1, 16, 3, 8)), torch.zeros((1, 16, 3)),
                  torch.zeros(3), torch.zeros((1, 16, 2, 4)),
                  torch.zeros((1, 16, 2, 4)), 8)
    with pytest.raises(ValueError, match="p="):
        ss._check(torch.zeros((1, 16, 2, 72)), dt, A, B, C, 8)
    with pytest.raises(TypeError):
        ss._check(x.half(), dt, A, B.half(), C.half(), 8)
    with pytest.raises(ValueError, match="unit stride"):
        ss._check(torch.zeros((1, 16, 8, 2)).transpose(2, 3), dt, A, B, C, 8)


def test_torch_ssd_kernel_builds_for_hopper():
    """The SSD kernel source sits beside flash attention's and builds into
    the same content-addressed build directory."""
    from repro_torch.kernels import _build
    src = _build.CSRC / "ssd_scan.cu"
    assert src.exists() and "extern \"C\" int ssd_scan_fwd" in src.read_text()
    lib = _build.library_path("ssd_scan")
    assert lib.parent == _build.library_path("flash_attention").parent
    assert lib.name.startswith("libssd_scan-")
