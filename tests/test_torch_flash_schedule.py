"""The flash-attention backward's launch plan (``backward_plan``) on the CPU.

The kernels run only on the card, but what they are told to do is built
here: each pass's grid and a work list that block z reads, (tile, first
tile on the other side, tiles), heaviest first.  The plan must cover every
(b, query head, key tile, query tile) pair that the forward's masks let see
each other exactly once in both passes, order its items heaviest first,
give the dK / dV pass clusters of the GQA group, serve every tensor-core
head dim on the wgmma kernels, and refuse a group no cluster holds.
Visibility is taken element by element from ``ref.attention_mask`` (the
plain twin's mask), independent of the plan's interval arithmetic.  The
shapes are the nine of ``test_torch_flash_backward.py`` and those of
``chip_smoke.py``'s backward rows.
"""
import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from test_torch_flash_backward import CASES as CPU_CASES

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TILE = fa.BWD_TILE
SHAPES = {**{f"cpu_{name}": case for name, case in CPU_CASES.items()},
          **{f"chip_{name}": (*shape, kw) for name, (shape, kw)
             in chip_smoke.BWD_CASES.items()}}


def _masks(kw):
    return dict(causal=kw.get("causal", True), window=kw.get("window", 0),
                q_offset=kw.get("q_offset", 0))


def _visible_tiles(S, T, causal, window, q_offset):
    """{(key tile, query tile)} holding at least one visible pair."""
    q_pos = (q_offset + torch.arange(S))[None]
    mask = ref.attention_mask(q_pos, torch.arange(T)[None], causal=causal,
                              window=window)[0].numpy()          # (S, T)
    pad = np.zeros((-(-S // TILE) * TILE, -(-T // TILE) * TILE), bool)
    pad[:S, :T] = mask
    tiles = pad.reshape(pad.shape[0] // TILE, TILE, pad.shape[1] // TILE,
                        TILE).any(axis=(1, 3))                    # (qt, kt)
    return {(int(kt), int(qt)) for qt, kt in zip(*np.nonzero(tiles))}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_covers_each_visible_tile_pair_once(name):
    B, S, T, H, K, D, kw = SHAPES[name]
    m = _masks(kw)
    plan = fa.backward_plan(B, S, T, H, K, D, **m)
    visible = _visible_tiles(S, T, **m)
    expect = Counter((b, h, kt, qt) for b in range(B) for h in range(H)
                     for kt, qt in visible)

    # a dK / dV block at grid x walks query head x
    x_n, y_n, z_n = plan.grid_dkdv
    assert (x_n, y_n, z_n) == (H, B, len(plan.dkdv_items))
    dkdv = Counter()
    for kt, first, n in plan.dkdv_items.tolist():
        for h in range(H):
            for b in range(B):
                for qt in range(first, first + n):
                    dkdv[(b, h, kt, qt)] += 1
    assert dkdv == expect

    x_n, y_n, z_n = plan.grid_dq
    assert (x_n, y_n, z_n) == (H, B, len(plan.dq_items))
    dq = Counter()
    for qt, first, n in plan.dq_items.tolist():
        for h in range(H):
            for b in range(B):
                for kt in range(first, first + n):
                    dq[(b, h, kt, qt)] += 1
    assert dq == expect

    # every key tile has a dK / dV item (a tile no query sees writes 0) and
    # every query tile a dQ item, so every output row is written
    assert sorted(plan.dkdv_items[:, 0].tolist()) == list(range(-(-T // TILE)))
    assert sorted(plan.dq_items[:, 0].tolist()) == list(range(-(-S // TILE)))
    assert plan.s_pad == -(-S // TILE) * TILE >= S
    assert plan.grid_preprocess == (-(-B * H * plan.s_pad // 8),)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_orders_tiles_heaviest_first(name):
    B, S, T, H, K, D, kw = SHAPES[name]
    plan = fa.backward_plan(B, S, T, H, K, D, **_masks(kw))
    for items in (plan.dkdv_items, plan.dq_items):
        assert items.dtype == torch.int32 and items.shape[1] == 3
        counts = items[:, 2].tolist()
        assert counts == sorted(counts, reverse=True)
        # ties keep tile order, so the list is the same on every call
        tiles = items[:, 0].tolist()
        assert all(tiles[i] < tiles[i + 1] for i in range(len(tiles) - 1)
                   if counts[i] == counts[i + 1])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_cluster_is_the_gqa_group(name):
    B, S, T, H, K, D, kw = SHAPES[name]
    plan = fa.backward_plan(B, S, T, H, K, D, **_masks(kw))
    assert plan.cluster == H // K
    assert plan.grid_dkdv[0] == H and plan.grid_dkdv[0] % plan.cluster == 0


@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
def test_plan_variant_by_head_dim(D):
    """Every tensor-core head dim runs the wgmma kernels."""
    assert fa.backward_plan(2, 128, 128, 4, 2, D).variant == "wgmma"
    assert fa.backward_variant(D, 2) == "wgmma"
    assert D in fa.WGMMA_HEAD_DIMS


def test_plan_refuses_a_head_dim_without_a_tensor_core_kernel():
    with pytest.raises(NotImplementedError, match="head dim 24"):
        fa.backward_plan(2, 64, 64, 4, 2, 24)


@pytest.mark.parametrize("H, K, D, refused", [
    (34, 2, 64, True),      # a group of 17: past the largest cluster
    (64, 2, 128, True),     # 32
    (32, 2, 64, False),     # 16: the largest cluster (non-portable)
    (24, 2, 128, False),    # mistral-large's 12
    (34, 2, 96, True),      # 17 at head dim 96
    (32, 32, 96, False),    # phi-3-vision: no grouping, a cluster of 1
])
def test_group_no_cluster_holds_is_refused(H, K, D, refused):
    """On CPU tensors: the plan, and the check the CUDA forward makes
    before it saves anything for the backward."""
    group = H // K
    q = torch.zeros((1, 64, H, D), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, K, D), dtype=torch.bfloat16)
    if refused:
        with pytest.raises(NotImplementedError, match=f"group of {group}"):
            fa.backward_plan(1, 64, 64, H, K, D)
        with pytest.raises(NotImplementedError, match=f"group of {group}"):
            fa._check_backward(q, k, k)
    else:
        assert fa.backward_plan(1, 64, 64, H, K, D).cluster == group
        fa._check_backward(q, k, k)


def test_backward_scratch_matches_the_plan():
    plan = fa.backward_plan(2, 300, 300, 14, 2, 64)
    scratch = fa.backward_scratch(2, 14, 300, "cpu")
    assert scratch.shape == (2, 2, 14, plan.s_pad) == (2, 2, 14, 320)
    assert scratch.dtype == torch.float32
