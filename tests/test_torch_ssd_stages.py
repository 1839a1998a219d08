"""The three stages of the port's chunked SSD scan on the CPU against the
JAX package.

``repro_torch.kernels.ref`` splits the chunked scan into the stages of the
Mamba2 paper's chunked algorithm (arXiv:2405.21060), as the CUDA kernels do:
``ssd_chunk_state`` (each chunk's cumsum and its own state addition),
``ssd_state_passing`` (the state entering each chunk) and
``ssd_chunk_scan`` (y from C, B, x and the entering state).  These hold
their composition against ``repro.kernels.ref.ssd_naive`` and the Pallas
``ssd_scan`` in interpret mode, and the state entering every chunk against
the sequential recurrence run up to that chunk; the entering states as the
wgmma chunk scan reads them (``ref.ssd_state_split``, bf16 pairs) carry the
state and give the same y.  Inputs are made with numpy
from a seed and handed to both packages.  Tolerance: fp32, 1e-4 absolute and
1e-3 relative (``_close`` of test_torch_ssm.py): the chunked and sequential
forms sum in different orders.  The stage kernels run only on the card,
where ``chip_smoke.py`` holds each against its stage function.
"""
import numpy as np
import pytest
import torch

from test_torch_ssm import SSD_SHAPES, _close, ssd_inputs
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ss

# the shapes of test_kernels.py, plus the model's chunk of 256 at a narrow
# width (two chunks)
STAGE_SHAPES = SSD_SHAPES + [(1, 512, 2, 8, 1, 8, 256)]


def _stages(tin, chunk):
    x, dt, A, B, C = tin
    cum, states = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    entering, final = ref.ssd_state_passing(states, cum)
    y = ref.ssd_chunk_scan(x, dt, B, C, cum, entering, chunk=chunk)
    return cum, states, entering, final, y


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", STAGE_SHAPES)
def test_torch_ssd_stages_compose_to_the_scan(b, s, h, p, g, n, chunk):
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    naive, jstate = jref.ssd_naive(*jin)
    kernel = jssd_scan(*jin, chunk=chunk, interpret=True)
    cum, states, entering, final, y = _stages(tin, chunk)
    nc = s // chunk
    assert cum.shape == (b, h, nc, chunk) and cum.dtype == torch.float32
    assert states.shape == entering.shape == (b, h, nc, p, n)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    _close(y, naive)
    _close(y, kernel)
    _close(final, jstate)
    # the composition is the port's chunked form and its plain twin
    y_chunked, state_chunked = ref.ssd_chunked(*tin, chunk=chunk)
    np.testing.assert_array_equal(y.numpy(), y_chunked.numpy())
    np.testing.assert_array_equal(final.numpy(), state_chunked.numpy())
    np.testing.assert_array_equal(
        y.numpy(), ss.ssd_scan_plain(*tin, chunk=chunk).numpy())


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", STAGE_SHAPES)
def test_torch_ssd_state_entering_each_chunk(b, s, h, p, g, n, chunk):
    """Stage 2's state entering chunk z is the sequential recurrence's
    state after the first z * chunk steps (0 for the first chunk)."""
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    _, _, entering, _, _ = _stages(tin, chunk)
    np.testing.assert_array_equal(entering[:, :, 0].numpy(), 0.0)
    jx, jdt, jA, jB, jC = jin
    for z in range(1, s // chunk):
        t = z * chunk
        _, expect = jref.ssd_naive(jx[:, :t], jdt[:, :t], jA, jB[:, :t],
                                   jC[:, :t])
        _close(entering[:, :, z], expect)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", STAGE_SHAPES)
def test_torch_ssd_chunk_state_is_each_chunk_alone(b, s, h, p, g, n, chunk):
    """Stage 1's addition of chunk z is the recurrence's state after that
    chunk run alone from 0, and its cum is the cumsum of dt * A there."""
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    cum, states = ref.ssd_chunk_state(*tin[:4], chunk=chunk)
    jx, jdt, jA, jB, jC = jin
    dtA = np.asarray(jdt, np.float32) * np.asarray(jA, np.float32)
    for z in range(s // chunk):
        sl = slice(z * chunk, (z + 1) * chunk)
        _, expect = jref.ssd_naive(jx[:, sl], jdt[:, sl], jA, jB[:, sl],
                                   jC[:, sl])
        _close(states[:, :, z], expect)
        _close(cum[:, :, z], np.cumsum(dtA[:, sl], axis=1).transpose(0, 2, 1))


def test_torch_ssd_state_passing_takes_an_initial_state():
    """A given initial state enters chunk 0 and is carried like the
    recurrence's ``initial_state``."""
    b, s, h, p, g, n, chunk = 1, 64, 2, 8, 1, 4, 16
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    init = np.random.default_rng(7).standard_normal(
        (b, h, p, n)).astype(np.float32)
    cum, states = ref.ssd_chunk_state(*tin[:4], chunk=chunk)
    entering, final = ref.ssd_state_passing(
        states, cum, initial_state=torch.from_numpy(init))
    np.testing.assert_array_equal(entering[:, :, 0].numpy(), init)
    _, expect = jref.ssd_naive(*jin, initial_state=init)
    _close(final, expect)


def test_torch_ssd_stages_reject_a_ragged_sequence():
    _, (x, dt, A, B, C) = ssd_inputs(1, 30, 2, 8, 1, 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_chunk_state(x, dt, A, B, chunk=8)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", STAGE_SHAPES)
def test_torch_ssd_chunk_scan_from_zero_state_is_each_chunk_alone(
        b, s, h, p, g, n, chunk):
    """Stage 3 with a zero state entering every chunk gives each chunk's
    output as if the chunk were the whole sequence: the intra-chunk part
    alone."""
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    x, dt, A, B, C = tin
    cum, states = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    y = ref.ssd_chunk_scan(x, dt, B, C, cum, torch.zeros_like(states),
                           chunk=chunk)
    jx, jdt, jA, jB, jC = jin
    for z in range(s // chunk):
        sl = slice(z * chunk, (z + 1) * chunk)
        expect, _ = jref.ssd_naive(jx[:, sl], jdt[:, sl], jA, jB[:, sl],
                                   jC[:, sl])
        _close(y[:, sl], expect)


def test_torch_ssd_scratch_shapes():
    """The bf16 path's scratch: cum (b, h, chunks, chunk) and states
    (b, h, chunks, p, n), fp32, allocated by the wrapper."""
    x = torch.zeros((2, 64, 3, 8), dtype=torch.bfloat16)
    B = torch.zeros((2, 64, 1, 16), dtype=torch.bfloat16)
    cum, states = ss._scratch(x, B, 16)
    assert cum.shape == (2, 3, 4, 16) and cum.dtype == torch.float32
    assert states.shape == (2, 3, 4, 8, 16) and states.dtype == torch.float32


def test_torch_ssd_run_stage_refuses_the_cpu():
    """The stage kernels run only on the card; on the CPU the stage
    functions of ``ref`` are the path, and ``run_stage`` says so."""
    _, (x, dt, A, B, C) = ssd_inputs(1, 32, 2, 8, 1, 4)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        ss.run_stage("chunk_scan", x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="no stage"):
        ss.run_stage("scan", x, dt, A, B, C, chunk=8)


def test_torch_kernel_library_hash_covers_shared_headers(tmp_path,
                                                         monkeypatch):
    """An edited csrc/*.cuh gives every source a new library name, so a
    stale build is never loaded."""
    import shutil

    from repro_torch.kernels import _build
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in ("flash_attention",
                                                  "ssd_scan")}
    header = tmp_path / "mma_utils.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(before[n] != after[n] for n in before)
    assert '#include "mma_utils.cuh"' in (
        tmp_path / "flash_attention.cu").read_text()


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", STAGE_SHAPES)
def test_torch_ssd_state_split_carries_the_entering_state(b, s, h, p, g, n,
                                                          chunk):
    """The entering states as the wgmma chunk scan reads them
    (``ref.ssd_state_split``, the state kernel's output): bf16 pairs
    (b, h, chunks, p, 2, n) whose sum (``ref.ssd_state_join``) is each
    fp32 state to within 2^-16 of itself, and so the JAX recurrence's
    state at each chunk's start; the chunk scan from the joined pairs
    gives ``repro``'s y, from the recurrence and from the Pallas kernel in
    interpret mode."""
    jin, tin = ssd_inputs(b, s, h, p, g, n)
    x, dt, A, B, C = tin
    cum, states = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    entering, _ = ref.ssd_state_passing(states, cum)
    pairs = ref.ssd_state_split(entering)
    assert pairs.shape == (b, h, s // chunk, p, 2, n)
    assert pairs.dtype == torch.bfloat16
    joined = ref.ssd_state_join(pairs)
    assert joined.dtype == torch.float32
    assert bool(((joined - entering).abs()
                 <= 2.0 ** -16 * entering.abs()).all())
    jx, jdt, jA, jB, jC = jin
    for z in range(1, s // chunk):
        t = z * chunk
        _, expect = jref.ssd_naive(jx[:, :t], jdt[:, :t], jA, jB[:, :t],
                                   jC[:, :t])
        _close(joined[:, :, z], expect)
    y = ref.ssd_chunk_scan(x, dt, B, C, cum, joined, chunk=chunk)
    _close(y, jref.ssd_naive(*jin)[0])
    _close(y, jssd_scan(*jin, chunk=chunk, interpret=True))


def test_torch_ssd_state_split_is_exact_for_bf16_states():
    """A state that bf16 holds exactly splits into itself and zeros."""
    e = torch.tensor([[1.0, -0.5, 3.0, 0.0]]).reshape(1, 1, 1, 1, 4)
    pairs = ref.ssd_state_split(e)
    assert torch.equal(pairs[..., 0, :].float(), e)
    assert torch.equal(pairs[..., 1, :].float(), torch.zeros_like(e))
