"""The port's roofline (``repro_torch/roofline/``) on the CPU.

* ``analysis``: ``model_flops_for`` equals ``repro``'s for every cell, and
  ``RooflineReport``'s properties equal ``repro``'s given the same terms;
  no TPU constant is left.
* ``costs``: each kernel's formula against a brute-force count at small
  shapes (visible pairs by loop over ``ref.attention_mask``; the SSD
  scan's per-chunk work by loop; bytes from the tensors themselves), and
  three of ``chip_smoke.py``'s kernel rows at their recorded bounds.
* ``counter``: regions, nesting and peaks by storage; for reduced configs
  of all six families the train step (remat "none" and "dots"), prefill
  and decode at world 1 count the same FLOPs, traffic, kernel regions
  and peak on meta (the kernels' shape functions) as on the CPU (their
  plain twins); the dense step's FLOPs outside the kernels equal the
  analytic count of its matrix products.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import sys

import pytest
import torch

from repro.configs import base as jbase
from repro.roofline import analysis as janalysis

from repro_torch.configs.base import (SHAPES, applicable_shapes, get_config,
                                      list_configs, reduced)
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as dr
from repro_torch.roofline import analysis, costs, counter
from repro_torch.train.train_step import TrainStepConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
FAMILIES = ("qwen2-0.5b", "mamba2-780m", "granite-moe-3b-a800m",
            "hymba-1.5b", "phi-3-vision-4.2b", "whisper-large-v3")
CELLS = [(a, s.name) for a in list_configs()
         for s in applicable_shapes(get_config(a))]


# ---- analysis ---------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_torch_model_flops_for_matches_repro(arch, shape):
    assert analysis.model_flops_for(get_config(arch), SHAPES[shape]) == \
        janalysis.model_flops_for(jbase.get_config(arch),
                                  jbase.SHAPES[shape])


TERMS = [dict(compute_s=1.0, memory_s=2.0, collective_s=0.5),
         dict(compute_s=3.0, memory_s=2.0, collective_s=0.5),
         dict(compute_s=0.1, memory_s=0.2, collective_s=0.7),
         dict(compute_s=0.0, memory_s=0.0, collective_s=0.0)]


@pytest.mark.parametrize("terms", TERMS)
def test_torch_roofline_report_properties_match_repro(terms):
    common = dict(arch="a", shape="s", mesh="m", chips=256,
                  flops_per_device=2e15, traffic_bytes_per_device=1e12,
                  collective_bytes_per_device=3e10,
                  collective_breakdown={}, collective_counts={},
                  hbm_per_device=1e9, model_flops=4e17, **terms)
    ours = analysis.RooflineReport(collective_axes={},
                                   compute_dtype="bfloat16", **common)
    theirs = janalysis.RooflineReport(cost_flops_body_once=0.0,
                                      cost_bytes_body_once=0.0, **common)
    for prop in ("dominant", "step_s", "useful_flops_ratio",
                 "roofline_fraction"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    d = ours.to_dict()
    assert d["dominant"] == theirs.dominant and d["step_s"] == theirs.step_s


def test_torch_roofline_constants_are_the_h100s():
    """The H100 SXM data sheet's peaks; none of repro's TPU v5e constants
    (197 TFLOP/s, 819 GB/s, 50 GB/s ICI as the only link)."""
    assert analysis.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert analysis.PEAK_BYTES == 3.35e12 and analysis.HBM_BYTES == 80e9
    assert analysis.axis_bandwidth(True) == 450e9
    assert analysis.axis_bandwidth(False) == 50e9
    text = open(analysis.__file__).read() + open(costs.__file__).read()
    for tpu in ("197e12", "819e9", "v5e"):
        assert tpu not in text


# ---- costs ------------------------------------------------------------------
def _pairs_by_mask(S, T, causal, window, q_offset):
    q_pos = (q_offset + torch.arange(S))[None]
    kv_pos = torch.arange(T)[None]
    return int(ref.attention_mask(q_pos, kv_pos, causal=causal,
                                  window=window).expand(1, S, T).sum())


MASKS = [(S, T, causal, window, off)
         for S, T in ((1, 1), (7, 7), (16, 40), (40, 16), (33, 64), (0, 5))
         for causal in (True, False)
         for window in (0, 1, 5, 16, 100)
         for off in (0, 3, 24)]


@pytest.mark.parametrize("case", range(0, len(MASKS), 20))
def test_torch_visible_pairs_in_closed_form(case):
    """The closed form against the masks the kernel applies, element by
    element (``ref.attention_mask``), over a block of cases."""
    for S, T, causal, window, off in MASKS[case:case + 20]:
        assert costs.visible_pairs(S, T, causal, window, off) == \
            _pairs_by_mask(S, T, causal, window, off), (S, T, causal,
                                                        window, off)


def test_torch_visible_pairs_at_long_context():
    """A 500k-token window costs no more to count than a short one."""
    S = 524288
    assert costs.visible_pairs(S, S, True, 4096, 0) == \
        4096 * S - 4096 * 4095 // 2
    assert costs.visible_pairs(S, S, True, 0, 0) == S * (S + 1) // 2


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=5, q_offset=3)])
def test_torch_flash_formulas_by_brute_force(kw):
    B, S, T, H, K, D = 2, 12, 20, 4, 2, 16
    pairs = _pairs_by_mask(S, T, kw.get("causal", True), kw.get("window", 0),
                           kw.get("q_offset", 0))
    q, o = (torch.empty(B, S, H, D, dtype=torch.bfloat16) for _ in "qo")
    k, v = (torch.empty(B, T, K, D, dtype=torch.bfloat16) for _ in "kv")
    nb = [t.numel() * t.element_size() for t in (q, k, v, o)]
    assert costs.flash_forward(B, S, T, H, K, D, **kw) == (
        4.0 * B * H * D * pairs, float(sum(nb)))
    lse = 4 * B * H * S
    assert costs.flash_backward(B, S, T, H, K, D, **kw) == (
        10.0 * B * H * D * pairs, float(2 * sum(nb) + lse))
    if not kw.get("q_offset"):
        assert costs.flash_partial(B, S, T, H, K, D,
                                   causal=kw["causal"],
                                   window=kw.get("window", 0)) == (
            4.0 * B * H * D * pairs, float(sum(nb) + lse))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 32, 2, 8, 1, 4, 8),
                                               (2, 50, 4, 16, 2, 8, 16),
                                               (1, 7, 3, 4, 3, 2, 8)])
def test_torch_ssd_formula_by_brute_force(b, s, h, p, g, n, chunk):
    """Per chunk of c positions: each (query, key <= query) pair of the
    causal triangle costs 2 (n + p), each position 4 n p for the two state
    products; the padding past s counts nothing."""
    flops = 0
    for c0 in range(0, s, chunk):
        c = min(chunk, s - c0)
        flops += sum(2 * (n + p) for i in range(c) for j in range(i + 1))
        flops += 4 * c * n * p
    flops *= b * h
    elem = 2
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * g * n) \
        + 4 * (b * s * h + h)
    assert costs.ssd_scan(b, s, h, p, g, n, chunk) == (float(flops),
                                                       float(nbytes))
    assert costs.ssd_scan(b, s, h, p, g, n, chunk, state=True)[1] == \
        nbytes + 4 * b * h * p * n


def test_torch_norm_formulas_by_bytes():
    rows, d = 6, 10
    x = torch.empty(rows, d, dtype=torch.bfloat16)
    xb, sb = x.numel() * 2, d * 4
    assert costs.rmsnorm(rows, d) == (4.0 * rows * d, float(2 * xb + sb))
    assert costs.rmsnorm_backward(rows, d) == (12.0 * rows * d,
                                               float(3 * xb + 2 * sb))
    assert costs.rmsnorm_residual(rows, d) == (5.0 * rows * d,
                                               float(4 * xb + sb))
    assert costs.row_sumsq(rows, d) == (2.0 * rows * d, float(xb + 4 * rows))
    assert costs.rmsnorm_total(rows, d) == (3.0 * rows * d,
                                            float(2 * xb + sb + 4 * rows))


def test_torch_chip_smoke_bounds_come_from_costs():
    """``chip_smoke.py`` keeps no work formula of its own, and three of its
    kernel rows keep their recorded bounds: flash at the slice shape
    0.0050 ms (bytes), its backward at ``train`` 0.0760 ms (operations),
    the SSD scan at the training shape 0.0326 ms (operations)."""
    sys.path.insert(0, ROOT)
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)
    for gone in ("flash_pairs", "ssd_cost", "bound", "PEAK_FLOPS"):
        assert not hasattr(cs, gone)
    ms, by = costs.bound(*costs.flash_forward(8, 512, 512, 14, 2, 64),
                         "bfloat16")
    assert (round(ms, 4), by) == (0.0050, "bytes")
    (B, S, T, H, K, D), kw = cs.BWD_CASES["train"]
    ms, by = costs.bound(*costs.flash_backward(B, S, T, H, K, D, **kw),
                         "bfloat16")
    assert (round(ms, 4), by) == (0.0760, "operations")
    ms, by = costs.bound(*costs.ssd_scan(cs.TRAIN_BATCH, cs.TRAIN_SEQ, 48,
                                         64, 1, 128, 256), "bfloat16")
    assert (round(ms, 4), by) == (0.0326, "operations")


# ---- counter ----------------------------------------------------------------
def test_torch_counter_regions_nest_and_peaks_by_storage():
    """A region adds its formula once (a nested one counts nothing), the
    ops inside it count nothing, and what it keeps is live; outside a
    region views cost nothing and share their storage's bytes."""
    x = torch.ones(64, 32)
    with counter.Counter() as c:
        with counter.region("k", lambda: (10.0, 20.0), scratch=5000):
            with counter.region("inner", lambda: (1e9, 1e9)):
                y = x * 2
            counter.keep(y)
        v = y[:8]            # a view: no bytes, no new storage
        z = v + 1
        del y, v
    assert c.kernels == {"k": {"regions": 1, "flops": 10.0, "bytes": 20.0}}
    assert c.flops == 10.0
    assert c.traffic == 20.0 + 2 * z.numel() * 4
    # y (kept) and the scratch; later y and z at 9,216 bytes stay below
    assert c.peak == 64 * 32 * 4 + 5000
    assert counter.active() is None
    with counter.region("off", lambda: 1 / 0):   # nothing counts: no call
        pass


def test_torch_counter_reaches_the_backward():
    """The backward's matrix products count (6 N per row of a linear
    layer: forward, and both products of its backward)."""
    w = torch.ones(16, 8, requires_grad=True)
    x = torch.ones(4, 16, requires_grad=True)
    with counter.Counter() as c:
        (x @ w).sum().backward()
    assert c.flops == 3 * 2 * 4 * 16 * 8


@pytest.mark.parametrize("kind", ["train", "train_dots", "prefill",
                                  "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_torch_meta_counts_the_cpu_step(arch, kind):
    """The dry-run's trace on meta and the same step on the CPU on seeded
    values count the same FLOPs, traffic, kernel regions (each with its
    FLOPs and bytes) and peak."""
    cfg = reduced(get_config(arch))
    got = {}
    for dev in ("meta", "cpu"):
        if kind.startswith("train"):
            scfg = TrainStepConfig(
                remat_policy="dots" if kind == "train_dots" else "none")
            c, held, _ = dr.count_train(cfg, scfg, 2, 24, device=dev)
        else:
            c, held, _ = dr.count_serve(cfg, kind, 2, 24, device=dev)
        got[dev] = (c.summary(), held)
    assert got["meta"] == got["cpu"]
    s = got["meta"][0]
    assert s["flops"] > 0 and s["traffic"] > 0 and s["peak"] > 0
    assert s["kernels"]


def test_torch_dense_step_flops_outside_kernels_are_its_matmuls():
    """The dense step at remat "none": 2 x tokens x (every layer's q, k,
    v, o and SwiGLU weights, and the logits' d x V) forward, three times
    that with the backward; everything else is inside a kernel region."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              num_layers=3)
    c, _, _ = dr.count_train(cfg, TrainStepConfig(remat_policy="none"), 2,
                             16)
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.head_dim
    per_layer = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
        + 3 * d * cfg.d_ff
    assert c.kernel_totals()["other_flops"] == \
        6.0 * 2 * 16 * (L * per_layer + d * cfg.vocab_size)
