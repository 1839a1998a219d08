"""Which flash-attention forward kernel serves a call on the card
(``flash_attention.forward_variant``), checked on the CPU.

The kernels run only on the card; the choice is made in Python, in one
place, and the C entry launches what it is told or refuses.  Every bf16
row of ``chip_smoke.py``'s flash checks (PERF.md section 6) maps to the
wgmma kernel, or to the decode form where it has at most 16 query rows;
fp32, head dim 24, unaligned views and a call with no keys map to the
scalar kernel; no case maps to the plain twin; the codes, the decode
form's row count and the key tile agree with the CUDA source and with
``chip_smoke.py``'s controls.
"""
import importlib.util
import itertools
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
cs = chip_smoke
SOURCE = (_build.CSRC / "flash_attention.cu").read_text()

# chip_smoke.py's bf16 flash rows: name -> (B, S, T, H, K, D)
CHIP_ROWS = {
    "slice": (8, 512, 512, 14, 2, 64),
    "window48": (8, 512, 512, 14, 2, 64),
    "ragged300": (4, 300, 300, 14, 2, 64),
    "q_offset": (8, 64, 512, 14, 2, 64),
    "q_offset_off_grid": (8, 63, 512, 14, 2, 64),
    "window100": (8, 512, 512, 14, 2, 64),
    "d128": (2, 256, 256, 16, 8, 128),
    "d96": (2, 512, 512, 32, 32, 96),
    "d16_full": (2, 48, 80, 6, 2, 16),
    "granite": (8, 512, 512, 24, 8, 64),
    "mixtral_window": (cs.RING_BATCH, cs.RING_PROMPT, cs.RING_PROMPT, 48, 8,
                       128),
    "hymba_global": (8, 640, 640, 25, 5, 64),
    "phi3v": (8, 1088, 1088, 32, 32, 96),
    "whisper_enc": (8, 1500, 1500, 20, 20, 64),
    "whisper_cross": (8, 224, 1500, 20, 20, 64),
    "whisper_cross_decode": (8, 1, 1500, 20, 20, 64),
    "whisper_self": (8, 224, 224, 20, 20, 64),
    "tp_rank": (cs.TP_BATCH, cs.TP_SEQ, cs.TP_SEQ, 4, 1, 64),
    "ep_rank": (cs.EP_BATCH // cs.EP_DATA, cs.EP_PROMPT, cs.EP_PROMPT, 12, 4,
                64),
    "tp_big_rank": (cs.BIG_BATCH, cs.BIG_SEQ, cs.BIG_SEQ, 4, 2, 128),
    "tp_hybrid_rank": (cs.TP_BATCH, cs.TP_SEQ + 128, cs.TP_SEQ + 128, 15, 15,
                       64),
    **{name: shape for name, (shape, _) in cs.BWD_CASES.items()
       if name.startswith(("tp_vlm", "tp_whisper"))},
    "tp_whisper_cross_decode_rank": (cs.TP_BATCH, 1, 1500 // cs.VE_TP_MODEL,
                                     10, 10, 64),
    "train": (cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.TRAIN_SEQ, 14, 2, 64),
}
DECODE_ROWS = {"whisper_cross_decode", "tp_whisper_cross_decode_rank"}


def _source_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not defined in flash_attention.cu"
    return int(m.group(1))


@pytest.mark.parametrize("name", sorted(CHIP_ROWS))
def test_forward_variant_of_each_chip_row(name):
    B, S, T, H, K, D = CHIP_ROWS[name]
    want = "decode" if name in DECODE_ROWS else "wgmma"
    assert fa.forward_variant(S, T, H, K, D, torch.bfloat16, True) == want


@pytest.mark.parametrize("S, T, H, K, D, dtype, aligned", [
    (512, 512, 14, 2, 64, torch.float32, True),      # fp32
    (1, 1500, 10, 10, 64, torch.float32, True),      # fp32 decode
    (100, 100, 4, 2, 24, torch.bfloat16, True),      # head dim 24
    (128, 128, 14, 2, 64, torch.bfloat16, False),    # a strided view
    (1, 750, 10, 10, 64, torch.bfloat16, False),     # unaligned decode
    (64, 0, 4, 2, 64, torch.bfloat16, True),         # no keys
])
def test_forward_variant_scalar_cases(S, T, H, K, D, dtype, aligned):
    assert fa.forward_variant(S, T, H, K, D, dtype, aligned) == "scalar"


def test_forward_variant_names_a_kernel_for_every_case():
    """Every head dim, dtype, alignment and query count lands on one of the
    three kernels, never on the plain twin; the tensor-core forms take
    exactly the bf16 aligned calls at their head dims, split at
    DECODE_ROWS."""
    for S, D, dtype, aligned in itertools.product(
            (1, 2, 15, 16, 17, 63, 64, 65, 1500), fa.HEAD_DIMS,
            (torch.bfloat16, torch.float32), (True, False)):
        got = fa.forward_variant(S, 300, 8, 2, D, dtype, aligned)
        assert got in fa.FORWARD_VARIANTS
        tensor_core = (dtype == torch.bfloat16 and aligned
                       and D in fa.WGMMA_HEAD_DIMS)
        assert (got != "scalar") == tensor_core
        if tensor_core:
            assert got == ("decode" if S <= fa.DECODE_ROWS else "wgmma")


def test_forward_variant_codes_match_the_source():
    """The codes ``_forward_kernel`` passes, the decode form's rows and the
    key tile are the C source's, and chip_smoke.py's zero-filled-key
    controls use that tile."""
    assert {name: _source_int(f"FWD_{name.upper()}")
            for name in fa.FORWARD_VARIANTS} == fa.FORWARD_VARIANTS
    assert _source_int("DEC_ROWS") == fa.DECODE_ROWS
    assert _source_int("FWD_BK") == chip_smoke.FLASH_KEY_TILE


@pytest.mark.parametrize("shape, cut, aligned", [
    ((2, 128, 14, 64), None, True),
    ((2, 128, 14, 66), slice(1, 65), False),     # rows start 2 bytes in
    ((2, 128, 14, 72), slice(8, 72), True),      # 16 bytes in, stride 72
    ((2, 128, 3, 64), None, True),
])
def test_aligned16_of_views(shape, cut, aligned):
    """The wrapper's test of 16-byte rows, which sends strided views to the
    scalar kernel."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    if cut is not None:
        x = x[..., cut]
    assert fa._aligned16(x) == aligned
