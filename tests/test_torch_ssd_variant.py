"""Which SSD scan kernels serve a call on the card (``ssd_scan.variant``),
checked on the CPU.

The kernels run only on the card; the choice is made in Python, in one
place, and the C entry launches what it is told or refuses.  Every bf16
SSD row of ``chip_smoke.py`` at a model's shapes maps to the wgmma kernels
(PERF.md section 6), the test shapes (small p or n, a chunk of 24 or 32,
rows that are not whole 16-byte chunks) to the mma.sync kernels, fp32 to
the scalar kernel, and no case to the plain twin.  The conv output's
slices, which the model hands the scan (``models/ssm.py``), count as
16-byte aligned at mamba2's and hymba's widths; an offset view does not.
The codes, the widths, the chunk rule and the C entries agree with the
CUDA source, and ``scratch_bytes`` (which phase 24's count holds against
the card) is what the wrapper allocates for each variant.
"""
import contextlib
import importlib.util
import itertools
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ssd_scan as ss

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
cs = chip_smoke
SOURCE = (_build.CSRC / "ssd_scan.cu").read_text()

# chip_smoke.py's bf16 SSD rows: name -> ((b, s, h, p, g, n, chunk),
# strided); strided: x, B and C are views of one conv output
MODEL_ROWS = {
    "slice": ((cs.TRAIN_BATCH, cs.TRAIN_SEQ, 48, 64, 1, 128, 256), True),
    "fleet6": ((6, cs.TRAIN_SEQ, 48, 64, 1, 128, 256), True),
    "dp_mb": ((cs.TRAIN_BATCH // cs.DP_MICROBATCHES, cs.TRAIN_SEQ, 48, 64,
               1, 128, 256), True),
    "padded300": ((2, 300, 48, 64, 1, 128, 256), False),
    "serve_prefill": ((8, 512, 48, 64, 1, 128, 256), True),
    "serve_prefill300": ((4, 300, 48, 64, 1, 128, 256), True),
    "hymba_prefill": ((8, 640, 50, 64, 1, 16, 256), True),
    "tp_hybrid_rank": ((cs.TP_BATCH, cs.TP_SEQ + 128, 25, 64, 1, 16, 256),
                       True),
    "tp_ssm_rank": ((cs.TP_BATCH, cs.TP_SEQ, 24, 64, 1, 128, 256), True),
}
TEST_ROWS = {
    "t1": ((1, 32, 2, 8, 1, 4, 8), False),
    "t2_groups": ((2, 64, 4, 16, 2, 8, 16), False),
    "t3_g_eq_h": ((2, 64, 4, 16, 4, 8, 32), False),
    "t4_chunk24": ((1, 96, 6, 8, 2, 16, 24), False),
    "unaligned": ((1, 64, 3, 12, 1, 10, 32), False),
}


def _inputs(b, s, h, p, g, n, strided, dtype=torch.bfloat16):
    """Zero tensors laid out as chip_smoke.ssd_inputs lays them out (meta
    would do, but the alignment test reads the addresses)."""
    dt = torch.zeros((b, s, h))
    A = torch.zeros((h,))
    if strided:
        u = torch.zeros((b, s, h * p + 2 * g * n), dtype=dtype)
        xs, Bm, Cm = torch.split(u, [h * p, g * n, g * n], dim=-1)
        return (xs.reshape(b, s, h, p), dt, A, Bm.reshape(b, s, g, n),
                Cm.reshape(b, s, g, n))
    return (torch.zeros((b, s, h, p), dtype=dtype), dt, A,
            torch.zeros((b, s, g, n), dtype=dtype),
            torch.zeros((b, s, g, n), dtype=dtype))


def _served(shape, strided, dtype=torch.bfloat16) -> str:
    """The variant of the call ``ops.ssd`` makes for this row (after its
    padding to the chunk)."""
    b, s, h, p, g, n, chunk = shape
    x, dt, _, B, C = _inputs(b, s, h, p, g, n, strided, dtype)
    x, dt, B, C, chunk = ops._pad_to_chunk(x, dt, B, C, chunk)
    return ss._variant_of(x, B, C, chunk)


@pytest.mark.parametrize("name", sorted(MODEL_ROWS))
def test_model_rows_take_the_wgmma_kernels(name):
    shape, strided = MODEL_ROWS[name]
    assert _served(shape, strided) == "wgmma"
    assert _served(shape, strided, torch.float32) == "scalar"


@pytest.mark.parametrize("name", sorted(TEST_ROWS))
def test_test_rows_take_the_mma_kernels(name):
    shape, strided = TEST_ROWS[name]
    assert _served(shape, strided) == "mma"
    assert _served(shape, strided, torch.float32) == "scalar"


def test_chip_smoke_names_these_rows():
    """The rows above are chip_smoke.py's SSD rows, by name."""
    text = (ROOT / "chip_smoke.py").read_text()
    for name in (*MODEL_ROWS, *TEST_ROWS):
        assert f'("{name}"' in text, name


def test_variant_names_a_kernel_for_every_case():
    """Every width, chunk, dtype and alignment lands on one of the three
    kernels, never on the plain twin; wgmma takes exactly the bf16 aligned
    calls at its widths, a p a multiple of 16 and a chunk a multiple of
    its tile."""
    for p, n, chunk, dtype, aligned in itertools.product(
            (8, 12, 16, 32, 48, 64), (4, 8, 10, 16, 32, 64, 96, 128),
            (8, 24, 32, 64, 128, 192, 256, 512),
            (torch.bfloat16, torch.float32), (True, False)):
        got = ss.variant(p, n, chunk, dtype, aligned)
        assert got in ss.VARIANTS
        if dtype == torch.float32:
            assert got == "scalar"
            continue
        wgmma = (aligned and p % 16 == 0 and n in ss.WGMMA_WIDTHS
                 and chunk % ss.WGMMA_TILE == 0)
        assert got == ("wgmma" if wgmma else "mma")


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_conv_output_slices_are_aligned(arch):
    """The model's x, B and C (``models/ssm.py``: views of the conv output
    of width d_inner + 2 g n, 3,328 for mamba2 and 3,232 for hymba) count
    as 16-byte aligned; the same views one element in do not, and take the
    mma kernels."""
    cfg = get_config(arch)
    h = cfg.d_inner // cfg.ssm_head_dim
    g, n, p = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_head_dim
    width = cfg.d_inner + 2 * g * n
    assert width == {"mamba2-780m": 3328, "hymba-1.5b": 3232}[arch]
    # the conv output itself, and the same width one element into rows of
    # width + 8 (whose strides are still whole 16-byte chunks)
    u = torch.zeros((2, 512, width + 8), dtype=torch.bfloat16)
    for view, want in ((torch.zeros((2, 512, width), dtype=torch.bfloat16),
                        True), (u[..., 1:1 + width], False)):
        xs, Bm, Cm = torch.split(view, [cfg.d_inner, g * n, g * n], dim=-1)
        x = xs.reshape(2, 512, h, p)
        B, C = Bm.reshape(2, 512, g, n), Cm.reshape(2, 512, g, n)
        got = all(ss._aligned16(t) for t in (x, B, C))
        assert got == want
        assert ss._variant_of(x, B, C, cfg.ssm_chunk) == (
            "wgmma" if want else "mma")


def _source_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not defined in ssd_scan.cu"
    return int(m.group(1))


def test_variant_codes_widths_and_chunk_rule_match_the_source():
    codes = {"scalar": "SSD_SCALAR", "mma": "SSD_MMA", "wgmma": "SSD_WGMMA"}
    assert {k: _source_int(v) for k, v in codes.items()} == ss.VARIANTS
    m = re.search(r"constexpr int WG_WIDTHS\[\] = \{([\d, ]+)\};", SOURCE)
    assert m and tuple(int(v) for v in m.group(1).split(",")) == \
        ss.WGMMA_WIDTHS
    assert _source_int("WG_TILE") == ss.WGMMA_TILE
    assert _source_int("MAX_P") == ss.MAX_P
    assert _source_int("MAX_CHUNK") == ss.MAX_CHUNK
    # each width has its two kernels' sizes in ssd_scan_smem_bytes
    for w in ss.WGMMA_WIDTHS:
        assert f"WG_SMEM({w})" in SOURCE


def test_stage_entries_are_the_source_entries():
    exported = set(re.findall(r'extern "C" int (\w+)\(', SOURCE))
    assert "ssd_scan_fwd" in exported
    for stages in ss.STAGES.values():
        assert set(stages.values()) <= exported
    assert list(ss.STAGES) == ["mma", "wgmma"]
    assert list(ss.STAGES["wgmma"]) == ["state", "chunk_scan"]


@pytest.mark.parametrize("which", ["mma", "wgmma"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (4, 2048, 48, 64, 128, 256),     # slice
    (8, 768, 50, 64, 16, 256),       # hymba_prefill, padded
    (1, 96, 6, 8, 16, 24),           # t4_chunk24
])
def test_scratch_bytes_is_the_wrapper_allocation(which, b, s, h, p, n,
                                                 chunk):
    x = torch.empty((b, s, h, p), dtype=torch.bfloat16, device="meta")
    B = torch.empty((b, s, 1, n), dtype=torch.bfloat16, device="meta")
    cum, states = ss._scratch(x, B, chunk, which)
    want = {"mma": torch.float32, "wgmma": torch.bfloat16}[which]
    assert states.dtype == want
    got = sum(t.numel() * t.element_size() for t in (cum, states))
    assert got == ss.scratch_bytes(b, s, h, p, n, chunk, torch.bfloat16)
    assert ss.scratch_bytes(b, s, h, p, n, chunk, torch.float32) == 0


def test_region_scratch_is_the_allocation_at_the_padded_length(
        monkeypatch):
    """``ops._ssd_region`` declares the scratch the wrapper allocates for
    the padded call: hymba's prefill of 640 positions, padded to 768."""
    seen = {}

    def region(name, cost, *, scratch=0):
        seen[name] = scratch
        return contextlib.nullcontext()

    monkeypatch.setattr(ops._counter, "region", region)
    x = torch.empty((8, 640, 50, 64), dtype=torch.bfloat16, device="meta")
    B = torch.empty((8, 640, 1, 16), dtype=torch.bfloat16, device="meta")
    with ops._ssd_region(x, B, 256):
        pass
    xp = torch.empty((8, 768, 50, 64), dtype=torch.bfloat16, device="meta")
    cum, states = ss._scratch(xp, B, 256, "wgmma")
    assert seen["ssd_scan"] == sum(t.numel() * t.element_size()
                                   for t in (cum, states))


def test_launch_counts_by_variant(monkeypatch):
    """A launch counts one ``ssd_scan`` launch and one of its variant;
    the C entry is stubbed (no card here)."""
    from repro_torch.kernels import ref
    calls = []

    def fake_call(entry, x, dt, A, B, C, y, cum, states, chunk, final=None):
        calls.append((entry, None if states is None else states.dtype))
        y.copy_(ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)[0])

    monkeypatch.setattr(ss, "_call", fake_call)
    ss.ssd_scan.launches = 0
    ss.ssd_scan.launches_by_variant = dict.fromkeys(ss.VARIANTS, 0)
    for dtype, strided, shape in (
            (torch.bfloat16, True, (1, 256, 2, 64, 1, 16, 256)),
            (torch.bfloat16, False, (1, 32, 2, 8, 1, 4, 8)),
            (torch.float32, False, (1, 32, 2, 8, 1, 4, 8))):
        b, s, h, p, g, n, chunk = shape
        x, dt, A, B, C = _inputs(b, s, h, p, g, n, strided, dtype)
        ss._launch(x, dt, A, B, C, chunk)
    assert ss.ssd_scan.launches == 3
    assert ss.ssd_scan.launches_by_variant == {"scalar": 1, "mma": 1,
                                               "wgmma": 1}
    assert [c[1] for c in calls] == [torch.bfloat16, torch.float32, None]
