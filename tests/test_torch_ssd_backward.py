"""The SSD scan's backward and rmsnorm's backward on the CPU.

The port's SSD backward is a staged closed form (``ref.ssd_chunked_backward``:
the entering states, ``ssd_state_passing_bwd``, ``ssd_chunk_bwd``,
``ssd_cum_bwd``), the plain twin of the CUDA kernels in
``csrc/ssd_scan_bwd.cu`` and ``_SSDScan``'s route for CPU tensors.  Each
stage and the whole are held against ``jax.grad`` of ``repro``'s
sequential ``ref.ssd_naive`` (and, at small chunks, its ``ref.ssd_chunked``)
on inputs made from a seed with numpy, all five gradients, fp32: atol
1e-5 of the largest entry and rtol 1e-4 (the forms sum in other orders),
1e-4 / 1e-3 at the chunk of 256 (longer sums).  The kernels themselves run
only on the card (``chip_smoke.py``'s ``ssd_scan_backward`` and
``rmsnorm_backward`` rows); here their choice of variant, their C entry
against the source, the cost formula and the counter's regions.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import as_f32, rand
from repro.kernels import ref as jref
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import _build, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun as dr
from repro_torch.roofline import costs
from repro_torch.train.train_step import TrainStepConfig

# (b, s, h, p, g, n, chunk): g > 1; g = h; a chunk of 24; n 16; a ragged
# end (40 at chunk 16); one group of six heads
SHAPES = {
    "groups": (2, 64, 4, 16, 2, 8, 16),
    "g_eq_h": (2, 64, 4, 16, 4, 8, 32),
    "chunk24": (1, 96, 6, 8, 2, 16, 24),
    "n16": (1, 32, 2, 8, 1, 16, 8),
    "ragged": (2, 40, 4, 8, 2, 4, 16),
    "one_group": (1, 48, 6, 8, 1, 4, 16),
}
NAMES = ("dx", "ddt", "dA", "dB", "dC")
SOURCE = (_build.CSRC / "ssd_scan_bwd.cu").read_text()


def ssd_inputs(b, s, h, p, g, n, *, a_value=None, seed=0):
    """x, B, C ~ N(0,1), dt = softplus(N(0,1)), A = -exp(N(0,1) / 2) (or
    -a_value), dy ~ N(0,1), for both frameworks."""
    jx, tx = rand(seed, (b, s, h, p))
    jdt_raw, _ = rand(seed + 1, (b, s, h))
    jA_raw, _ = rand(seed + 2, (h,))
    jB, tB = rand(seed + 3, (b, s, g, n))
    jC, tC = rand(seed + 4, (b, s, g, n))
    jdy, tdy = rand(seed + 5, (b, s, h, p))
    jdt = jax.nn.softplus(jdt_raw)
    jA = (-jnp.exp(0.5 * jA_raw) if a_value is None
          else -jnp.full((h,), a_value, jnp.float32))
    tdt = torch.tensor(np.asarray(jdt, np.float32))
    tA = torch.tensor(np.asarray(jA, np.float32))
    return (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC), jdy, tdy


def jax_grads(fn, jin, jdy):
    """Gradients of sum(fn(*jin)[0] * dy) for x, dt, A, B, C."""
    return jax.grad(lambda *a: jnp.sum(fn(*a)[0] * jdy),
                    argnums=(0, 1, 2, 3, 4))(*jin)


def close(got, expect, atol_of_max=1e-5, rtol=1e-4):
    e = as_f32(expect)
    scale = float(np.abs(e).max())
    np.testing.assert_allclose(as_f32(got), e, atol=atol_of_max * scale,
                               rtol=rtol)


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_torch_ssd_staged_backward_matches_jax_grad(shape):
    """``ref.ssd_chunked_backward`` against ``jax.grad`` of the sequential
    ``ref.ssd_naive``, and where s is a multiple of the chunk of the
    chunked ``ref.ssd_chunked``."""
    b, s, h, p, g, n, chunk = SHAPES[shape]
    jin, tin, jdy, tdy = ssd_inputs(b, s, h, p, g, n)
    got = ref.ssd_chunked_backward(*tin, tdy, chunk=chunk)
    expects = [jax_grads(jref.ssd_naive, jin, jdy)]
    if s % chunk == 0:
        expects.append(jax_grads(lambda *a: jref.ssd_chunked(*a, chunk=chunk),
                                 jin, jdy))
    for expect in expects:
        for name, gt, ge, t in zip(NAMES, got, expect, tin):
            assert gt.shape == t.shape and gt.dtype == t.dtype, name
            close(gt, ge)


def test_torch_ssd_staged_backward_is_finite_at_chunk_256():
    """At the published chunk with real dt and A = -1 the reference's
    chunked gradient is NaN (it masks after its exp); the staged form,
    masked before, is finite and matches ``jax.grad`` of ``ssd_naive``."""
    jin, tin, jdy, tdy = ssd_inputs(1, 256, 2, 8, 1, 16, a_value=1.0)
    chunked = jax_grads(lambda *a: jref.ssd_chunked(*a, chunk=256), jin, jdy)
    assert not np.isfinite(np.asarray(chunked[1])).all()
    got = ref.ssd_chunked_backward(*tin, tdy, chunk=256)
    for gt, ge in zip(got, jax_grads(jref.ssd_naive, jin, jdy)):
        assert torch.isfinite(gt).all()
        close(gt, ge, atol_of_max=1e-4, rtol=1e-3)


@pytest.mark.parametrize("shape", ["groups", "chunk24", "one_group"])
def test_torch_ssd_state_passing_bwd_gives_the_initial_states_gradient(
        shape):
    """The d-state stage: d in_0 = exp(total_0) dS_0 + sum_i exp(cum_i)
    dy_i (x) C_i over chunk 0 is ``jax.grad`` of sum(y dy) for the
    initial state of ``repro``'s chunked form; and dS of the last chunk
    is 0."""
    b, s, h, p, g, n, chunk = SHAPES[shape]
    jin, tin, jdy, tdy = ssd_inputs(b, s, h, p, g, n)
    x, dt, A, B, C = tin
    j0 = jnp.zeros((b, h, p, n), jnp.float32)
    expect = jax.grad(lambda st: jnp.sum(
        jref.ssd_chunked(*jin, chunk=chunk, initial_state=st)[0] * jdy))(j0)
    cum, _ = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    dS = ref.ssd_state_passing_bwd(tdy, C, cum, chunk=chunk)
    assert dS.shape == (b, h, s // chunk, p, n)
    assert not dS[:, :, -1].any()
    c0 = cum[:, :, 0]                                      # (b, h, c)
    dy0 = tdy[:, :chunk].permute(0, 2, 1, 3)               # (b, h, c, p)
    C0 = C[:, :chunk].repeat_interleave(h // g, dim=2).permute(0, 2, 1, 3)
    d_in0 = (torch.exp(c0[..., -1])[..., None, None] * dS[:, :, 0]
             + torch.einsum("bhcp,bhcn->bhpn", dy0 * torch.exp(c0)[..., None],
                            C0))
    close(d_in0, expect)


@pytest.mark.parametrize("shape", ["groups", "g_eq_h", "chunk24", "n16"])
def test_torch_ssd_chunk_and_cum_stages_match_jax_grad(shape):
    """The chunk stage alone gives dx, dB and dC; with the cumsum stage,
    ddt (its direct part plus A d a) and dA."""
    b, s, h, p, g, n, chunk = SHAPES[shape]
    jin, tin, jdy, tdy = ssd_inputs(b, s, h, p, g, n)
    x, dt, A, B, C = tin
    expect = jax_grads(jref.ssd_naive, jin, jdy)
    cum, states = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    entering, _ = ref.ssd_state_passing(states, cum)
    dS = ref.ssd_state_passing_bwd(tdy, C, cum, chunk=chunk)
    dx, ddt_direct, dB, dC, dcum = ref.ssd_chunk_bwd(
        x, dt, B, C, tdy, cum, entering, dS, chunk=chunk)
    assert dcum.shape == cum.shape
    ddt_a, dA = ref.ssd_cum_bwd(dcum, dt, A, chunk=chunk)
    for got, name in ((dx, "dx"), (ddt_direct + ddt_a, "ddt"), (dA, "dA"),
                      (dB, "dB"), (dC, "dC")):
        close(got, expect[NAMES.index(name)])


def test_torch_ssd_cum_bwd_is_the_reverse_cumsum():
    """``ssd_cum_bwd`` against ``jax.grad`` of sum(cumsum(dt A) over each
    chunk * d cum) for dt and A."""
    b, s, h, chunk = 2, 48, 3, 16
    jdt, tdt = rand(0, (b, s, h))
    jA, tA = rand(1, (h,))
    jd, td = rand(2, (b, h, s // chunk, chunk))

    def f(dt, A):
        a = (dt * A[None, None, :]).reshape(b, s // chunk, chunk, h)
        cum = jnp.cumsum(a, axis=2).transpose(0, 3, 1, 2)
        return jnp.sum(cum * jd)

    gdt, gA = jax.grad(f, argnums=(0, 1))(jdt, jA)
    ddt, dA = ref.ssd_cum_bwd(td, tdt, tA, chunk=chunk)
    close(ddt, gdt)
    close(dA, gA)


@pytest.mark.parametrize("shape", ["groups", "ragged", "chunk24"])
def test_torch_ssd_cpu_route_takes_the_staged_twin(shape, monkeypatch):
    """``_SSDScan``'s backward on CPU tensors: the staged twin, the same
    gradients as ``jax.grad`` of ``ssd_naive``, no call of the autograd
    recompute ``ssd_scan_backward``, no launch counted."""
    b, s, h, p, g, n, chunk = SHAPES[shape]
    jin, tin, jdy, tdy = ssd_inputs(b, s, h, p, g, n)

    def refused(*a, **k):
        raise AssertionError("the CPU route called ssd_scan_backward")

    monkeypatch.setattr(ss, "ssd_scan_backward", refused)
    before = (ss.ssd_scan.backward_launches,
              dict(ss.ssd_scan.backward_launches_by_variant))
    leaves = [t.clone().requires_grad_() for t in tin]
    if s % chunk:       # the CPU path takes whole chunks: ops pads
        from repro_torch.kernels import ops
        y = ops.ssd(*leaves, chunk=chunk)
    else:
        y = ss.ssd_scan(*leaves, chunk=chunk)
        assert "SSDScan" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, tdy)
    for gt, ge in zip(got, jax_grads(jref.ssd_naive, jin, jdy)):
        close(gt, ge)
    assert (ss.ssd_scan.backward_launches,
            ss.ssd_scan.backward_launches_by_variant) == before


def test_torch_ssd_backward_cost_against_a_hand_count():
    """``costs.ssd_scan_backward`` at a tiny shape, counted by hand: per
    chunk of c, 2 (2p) a causal pair and 10 c n p for each head, 2 (3n) a
    causal pair for each group (C B^T, dCB B and dCB^T C: B and C are the
    group's); a last partial chunk of s % chunk; bytes of x, dy, dx and of
    B, C, dB, dC in the element size, dt, ddt, A and dA in fp32."""
    b, h, p, g, n = 1, 2, 2, 1, 3
    # chunk 4: pairs 10; a head 2 * 10 * 4 + 10 * 4 * 6 = 320 a chunk, a
    # group 2 * 10 * 9 = 180
    assert costs.ssd_scan_backward(b, 8, h, p, g, n, 4, elem=2) == (
        2 * 2 * 320.0 + 2 * 180, 2.0 * (3 * 8 * 2 * 2 + 4 * 8 * 3)
        + 4 * (2 * 8 * 2 + 2 * 2))
    # one group a head: the group's products twice
    flops, _ = costs.ssd_scan_backward(b, 8, h, p, 2, n, 4, elem=2)
    assert flops == 2 * 2 * 320 + 2 * 2 * 180
    # s 10: two chunks and one of 2 (pairs 3: a head 24 + 120, a group 54)
    flops, _ = costs.ssd_scan_backward(b, 10, h, p, g, n, 4, elem=4)
    assert flops == 2 * (2 * 320 + 144) + (2 * 180 + 54)
    # the training shape: 46 GFLOP (0.046 ms on the bf16 tensor cores)
    # against 0.163 GB, so bound by bytes
    ms, by = costs.bound(*costs.ssd_scan_backward(4, 2048, 48, 64, 1, 128,
                                                  256), "bfloat16")
    assert by == "bytes" and 0.048 < ms < 0.049


def test_torch_ssd_backward_variant_and_entry_agree_with_the_source():
    """``backward_variant`` is chosen in Python in one place: bf16 on the
    wgmma band kernels at the models' shapes (p a multiple of 16, n one of
    the wgmma widths, a chunk a multiple of 64 up to 256, x, B, C and dy
    aligned), on the mma kernels at every other shape the forward takes
    and whenever a view is unaligned, fp32 on the scalar kernels, anything
    else refused; its codes, the widths and limits the kernels are built
    for and the C entry's arguments agree with the source."""
    for p, n, chunk in ((64, 128, 256), (64, 16, 256), (32, 64, 256),
                        (16, 32, 64), (48, 128, 128)):
        assert ss.backward_variant(p, n, chunk, torch.bfloat16) == "wgmma"
        assert ss.backward_variant(p, n, chunk, torch.bfloat16,
                                   aligned=False) == "mma"
        assert ss.backward_variant(p, n, chunk, torch.float32) == "scalar"
    for p, n, chunk in ((8, 16, 24), (12, 10, 32), (8, 4, 8), (64, 128, 512),
                        (64, 128, 96), (24, 128, 256), (64, 48, 256),
                        (64, 8, 256)):
        assert ss.backward_variant(p, n, chunk, torch.bfloat16) == "mma"
        assert ss.backward_variant(p, n, chunk, torch.float32) == "scalar"
    for args in ((64, 128, 256, torch.float16), (72, 128, 256, torch.bfloat16),
                 (64, 136, 256, torch.bfloat16),
                 (64, 128, 1024, torch.float32)):
        with pytest.raises(NotImplementedError):
            ss.backward_variant(*args)
    assert list(ss.BACKWARD_VARIANTS) == ["scalar", "mma", "wgmma"]
    for name, code in ss.BACKWARD_VARIANTS.items():
        assert f"constexpr int BWD_{name.upper()} = {code};" in SOURCE
    assert [int(w) for w in re.findall(r"p\.N <= (\d+)", SOURCE)] == \
        list(ss.BACKWARD_MMA_WIDTHS[:-1])
    assert "launch_mma_n<128>" in SOURCE
    widths = re.search(r"constexpr int WB_WIDTHS\[\] = \{([^}]*)\};",
                       SOURCE).group(1)
    assert tuple(int(w) for w in widths.split(",")) == ss.WGMMA_WIDTHS
    for const, value in (("WB_TILE", ss.WGMMA_TILE),
                         ("WB_MAX_BAND", ss.BACKWARD_BAND),
                         ("WB_MAX_CHUNK", ss.BACKWARD_WGMMA_MAX_CHUNK)):
        assert re.search(rf"constexpr int {const} = (\d+);",
                         SOURCE).group(1) == str(value), const
    for w in ss.WGMMA_WIDTHS:
        assert f"case {w}: return launch_wgmma_n<{w}>(p, st);" in SOURCE
    entry = re.search(r'extern "C" int ssd_scan_bwd\((.*?)\) \{', SOURCE,
                      re.S).group(1)
    params = [a.strip() for a in entry.split(",")]
    kinds = ["ptr" if "*" in a else "i64" if "long long" in a else "i32"
             for a in params]
    expect = ["ptr"] * 17 + ["i32"] * 8 + ["i64"] * 15 + ["ptr", "i32", "i32"]
    assert kinds == expect
    assert params[-2:] == ["int variant", "int band"]
    assert ss._bwd_library.__wrapped__ is not None
    lib = _build.library_path("ssd_scan_bwd")
    assert lib.parent == _build.library_path("ssd_scan").parent


def test_torch_ssd_backward_kernel_refuses_the_cpu():
    """The kernel wrapper takes CUDA tensors only; the mma kernel bf16
    only: neither gives way to the twin."""
    _, tin, _, tdy = ssd_inputs(1, 16, 2, 8, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ss.backward_kernel(*tin, tdy, chunk=8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_torch_ssd_backward_scratch_is_what_the_wrapper_allocates(dtype):
    """``backward_scratch_bytes`` (the counter region's scratch) is the
    sum of the buffers ``backward_kernel`` allocates beside the
    gradients, at a ragged length: the fp32 entering states and dS, the
    per-head dB / dC, the dA partials, and each chunk's exp(total) for
    bf16."""
    b, s, h, p, n, chunk = 2, 300, 6, 16, 8, 64
    nc = -(-s // chunk)
    expect = (2 * 4 * b * h * nc * p * n + 2 * 4 * b * s * h * n
              + 4 * b * nc * h + (4 * b * h * nc if dtype == torch.bfloat16
                                  else 0))
    assert ss.backward_scratch_bytes(b, s, h, p, n, chunk, dtype) == expect


# (b, s, h, g, chunk) -> the wgmma band: mamba2-780m's training shape
# (bands of 4), hymba's rank (25 heads: bands of 2 and a ragged one),
# two groups of 8 heads at a ragged length (bands of 4), one head a group
BAND_SHAPES = {"mamba2": ((4, 2048, 48, 1, 256), 4),
               "ragged_band": ((2, 640, 25, 1, 256), 2),
               "two_groups": ((8, 2000, 16, 2, 256), 4),
               "g_eq_h": ((2, 300, 8, 8, 64), 1)}


@pytest.mark.parametrize("which", ["scalar", "mma", "wgmma"])
@pytest.mark.parametrize("case", list(BAND_SHAPES))
def test_torch_ssd_backward_scratch_bytes_by_variant(which, case):
    """``backward_scratch_bytes`` for each variant equals what
    ``backward_kernel`` allocates (``_backward_scratch``, here on meta):
    the wgmma variant's dB / dC partials are one a band (25 heads in bands
    of 2: 13, the last of one head; two groups of 8 in bands of 4: 4; g =
    h: one a head), the others' one a head."""
    (b, s, h, g, chunk), band = BAND_SHAPES[case]
    p, n = 16, 32
    dtype = torch.float32 if which == "scalar" else torch.bfloat16
    bufs = ss._backward_scratch(b, s, h, p, g, n, chunk, which, "meta")
    allocated = sum(t.numel() * t.element_size() for t in bufs.values()
                    if t is not None)
    assert ss.backward_scratch_bytes(b, s, h, p, n, chunk, dtype, g=g,
                                     which=which) == allocated
    parts = g * -(-(h // g) // band) if which == "wgmma" else h
    assert tuple(bufs["dB_part"].shape) == (b, s, parts, n)
    assert (bufs["tot"] is None) == (which == "scalar")


def test_torch_ssd_backward_band_rule():
    """The band of the wgmma chunk kernel: the widest of 4, 2, 1 heads of
    one group with the fewest waves of head work on ``BACKWARD_SMS``
    blocks (4 at mamba2-780m's 4 x 2048, 2 at 6 x 2048 and 2 x 2048 and at
    hymba's rank, 1 at the small model-axis grids), a ragged last band
    when the group's head count is not a multiple, never more than the
    group's heads and never a band across two groups; the other variants
    take one head a block.  The bands tile each group's heads once, in
    order."""
    assert (ss.BACKWARD_BAND, ss.BACKWARD_SMS) == (4, 132)
    cases = [(shape, band) for shape, band in BAND_SHAPES.values()] + [
        ((6, 2048, 48, 1, 256), 2), ((2, 2048, 48, 1, 256), 2),
        ((2, 512, 24, 1, 256), 1), ((2, 512, 8, 2, 256), 1),
        ((4, 2048, 2, 1, 256), 1), ((64, 2048, 2, 1, 256), 2)]
    for (b, s, h, g, chunk), band in cases:
        assert ss.backward_band(b, s, h, g, chunk, "wgmma") == band, (
            b, s, h, g)
        hpg, bands = h // g, -(-(h // g) // band)
        assert ss._backward_parts(b, s, h, g, chunk, "wgmma") == g * bands
        for which in ("mma", "scalar"):
            assert ss.backward_band(b, s, h, g, chunk, which) == 1
            assert ss._backward_parts(b, s, h, g, chunk, which) == h
        # the kernel's blocks: band k of group q takes heads q h / g + k W
        # up to the group's end
        covered = []
        for q in range(g):
            for k in range(bands):
                kh = min(band, hpg - k * band)
                assert kh > 0
                heads = list(range(q * hpg + k * band,
                                   q * hpg + k * band + kh))
                assert {hd // hpg for hd in heads} == {q}
                covered += heads
        assert covered == list(range(h))
    # hymba's rank ends in a band of one head
    assert 25 % ss.backward_band(2, 640, 25, 1, 256, "wgmma") == 1


def test_torch_meta_counts_the_mamba2_step_with_its_backward_regions():
    """A reduced mamba2 step counts the same on meta (empty gradients in
    the regions) as on the CPU (the staged twin and the norms' plain
    backward in the regions): one ``ssd_scan_backward`` region a layer
    and one ``rmsnorm_backward`` a norm, each with its cost."""
    cfg = reduced(get_config("mamba2-780m"))
    got = {}
    for dev in ("meta", "cpu"):
        c, held, _ = dr.count_train(cfg, TrainStepConfig(remat_policy="none"),
                                    2, 24, device=dev)
        got[dev] = (c.summary(), held)
    assert got["meta"] == got["cpu"]
    kernels = got["meta"][0]["kernels"]
    L = cfg.num_layers
    assert kernels["ssd_scan_backward"]["regions"] == L
    assert kernels["rmsnorm_backward"]["regions"] == 2 * L + 1
    h = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    per_layer, _ = costs.ssd_scan_backward(
        2, 24, h, cfg.ssm_head_dim, cfg.ssm_num_groups, cfg.ssm_state_dim,
        cfg.ssm_chunk)
    assert kernels["ssd_scan_backward"]["flops"] == L * per_layer


def test_torch_rmsnorm_backward_cpu_route_counts_no_launch():
    """``_RMSNorm``'s backward on CPU tensors takes the twin and counts no
    launch of the Triton kernels; their blocks and scratch follow
    ``backward_blocks``."""
    before = rn.rmsnorm.backward_launches
    _, x = rand(0, (5, 64))
    _, s_ = rand(1, (64,))
    _, dy = rand(2, (5, 64))
    x, s_ = x.requires_grad_(), s_.requires_grad_()
    got = torch.autograd.grad(rn.rmsnorm(x, s_), (x, s_), dy)
    direct = rn.rmsnorm_backward(x.detach(), s_.detach(), dy, 1e-6)
    for a, b in zip(got, direct):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert rn.rmsnorm.backward_launches == before
    # 8,192 rows: 31 a block keeps at least BWD_MIN_BLOCKS (264) blocks
    assert (rn.BWD_ROWS, rn.BWD_MIN_BLOCKS) == (32, 264)
    assert rn.backward_blocks(8192) == (31, 265)
    assert rn.backward_blocks(12288) == (32, 384)
    assert rn.backward_blocks(8) == (1, 8)
    assert rn.backward_scratch_bytes(8192, 1536) == 4 * 1536 * 265
    assert rn.backward_scratch_bytes(0, 1536) == 0


def test_torch_chip_smoke_backward_rows_name_their_variants():
    """``chip_smoke.py``'s backward rows: every bf16 SSD case on the mma
    kernels and the fp32 one on the scalar kernels (as the script checks
    on the card), the ragged case not a multiple of its chunk, and the
    rmsnorm rows at the train path's rows of 4 x 2048."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    expect = {"slice": "wgmma", "fleet6": "wgmma", "dp_mb": "wgmma",
              "tp_ssm_rank": "wgmma", "tp_hybrid_rank": "wgmma",
              "p32_groups": "wgmma", "t4_chunk24": "mma", "unaligned": "mma",
              "slice_fp32": "scalar"}
    assert set(cs.SSD_BWD_CASES) == set(expect)
    for name, (shape, strided, dtype) in cs.SSD_BWD_CASES.items():
        b, s, h, p, g, n, chunk = shape
        # the script's inputs: x, B and C slices of one conv output when
        # strided, dy contiguous
        u = torch.empty((b, s, h * p + 2 * g * n), dtype=torch.bfloat16,
                        device="meta")
        x = (u[..., :h * p].reshape(b, s, h, p) if strided
             else torch.empty((b, s, h, p), device="meta"))
        Bm = u[..., h * p:h * p + g * n].reshape(b, s, g, n)
        aligned = strided and all(ss._aligned16(t) for t in (x, Bm))
        assert ss.backward_variant(p, n, chunk, getattr(torch, dtype),
                                   aligned) == expect[name], name
    assert cs.SSD_BWD_CASES["tp_hybrid_rank"][0][1] % 256
    # hymba's rank: 25 heads in bands of 2 and a ragged last band of 1
    shape = cs.SSD_BWD_CASES["tp_hybrid_rank"][0]
    b, s, h, p, g, n, chunk = shape
    assert ss.backward_band(b, s, h, g, chunk, "wgmma") == 2
    assert ss._backward_parts(b, s, h, g, chunk, "wgmma") == 13
    assert {v[0] for v in cs.RMSNORM_BWD_CASES.values()} == \
        {cs.TRAIN_BATCH * cs.TRAIN_SEQ}
