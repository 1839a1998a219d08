#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and data-loading paths and
its Trainer on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, its power limit, torch and CUDA versions; TF32 off.
2. build: compile every kernel from the checkout's sources (one nvcc per
   CUDA C++ source, flash attention and the SSD scan, all started
   together; Triton's JIT for rmsnorm and rmsnorm_residual meanwhile),
   with ptxas' registers, static shared memory and spills for every CUDA
   kernel and the dynamic shared memory the launches ask for, as the
   kernels' own launch code computes it.
3. kernel_check: each kernel against its plain PyTorch twin on the card,
   in bf16 and fp32, at the shapes the serving and training paths give it,
   with its time, the twin's, one PyTorch library call's where one
   computes the same function (a yardstick the port never calls) and the
   least time the card could take (``bound_ms``); flash also at
   phi-3-vision's head dim 96 (``d96``) and at the MoE paths' prefills
   (``granite``; ``mixtral_window``, where SDPA takes the window as an
   explicit mask; every row names the backend SDPA picked); the SSD scan
   also with its final state through ``ops.ssd_prefill`` at the serving
   prefill shapes (8 x 512 and 4 x 300, padded), y and the state each
   held to its own tolerance
   and timed against the y-only scan; and each bf16 stage kernel of the
   SSD scan (chunk state, state passing with the final state, chunk scan)
   against its plain stage function, timed alone (``ssd_stage`` lines).
4. serve: full-width qwen2-0.5b in bf16, weights drawn from a seeded CUDA
   generator, 16 requests of 512 prompt tokens and 4 of 300, 32 new tokens
   each, through ``BatchingFrontend`` -> ``ServeEngine`` ->
   ``DecoderLM.prefill`` / ``decode_step``.  Launch counters are zeroed
   just before and read just after; every kernel of the path must have
   launched, and exactly as often as the path's shape implies.  Then two
   profile lines: one prefill and eight decode steps under
   ``torch.profiler``, with wall time, device busy time, idle share and
   the kernels that took longest; the prefill window must show the flash
   kernel.
5. plain: the same prompts teacher-forced through the kernels and through
   the plain twins on the card; cosine similarity of the logits and top-1
   agreement must clear the stated tolerances.
6. serve_ssm: phases 4-5 for full-width mamba2-780m (48 layers, d_model
   1536, 48 heads of 64, state 128): prefill runs the SSD scan kernel with
   its final state, decode the recurrence over the conv-tail / SSD-state
   cache; launches exactly 48 ssd_scan a batch and 97 rmsnorm a forward,
   no flash; the prefill profile must show the scan's kernels.  Then
   ``plain_ssm`` (phase 5 for this model) and ``prefill_vs_full``: the
   prefill + decode logits against one full-sequence forward of the prompt
   and the forced tokens, both through the kernels, to the same
   tolerances, in fp32 and, at the prompt's last position and the first
   decode step of every sequence, in bf16 on the served model.
6b. serve_moe: phases 4-5 for full-width, full-depth granite-moe-3b-a800m
   (32 layers, d_model 1536, 24 / 8 heads of 64, 40 experts of 512, top
   8, capacity 1.25): exactly 32 flash launches a prefill batch and 65
   rmsnorm a forward; each profile line also splits the MoE layers'
   device time between routing and dispatch and the three batched expert
   products (``moe_split``).  Then ``plain_moe``: the kernels against the
   plain twins in fp32 compute to phase 5's bounds, in bf16 by distance
   to an fp32 plain reference against the plain bf16 path's own (an
   rmsnorm with a coarser output must fail that bound), and the route
   agreement of the two paths, layer by layer.
6c. serve_ring: mixtral-8x22b at published widths and depth 2, dropless
   (``RING_REDUCED`` says why), two prompts of 4,608 tokens through the
   frontend: flash with window 4,096 at head dim 128 (2 launches a
   prefill), a K/V ring of 4,096 slots that wraps at prefill and again in
   decode.  ``ring_vs_full``: each ring slot holds the K of its position,
   and prefill + decode equals one full-sequence forward (4,640
   positions) in fp32 at every position and in bf16 at the handoff; the
   fp32 full forward through the kernels equals the one through the plain
   twins to phase 5's bounds.
7. train: full-width mamba2-780m, bf16 compute with fp32 masters and
   AdamW moments drawn from a seeded CUDA generator, one batch of 4 x 2048
   tokens made from the seed, through ``init_train_state`` ->
   ``make_train_step`` -> ``DecoderLM.loss``.  A warm-up step, then four
   timed steps with the launch counters zeroed before and read after
   (exactly 48 ssd_scan and 97 rmsnorm launches per forward); finite,
   falling losses starting near ln(vocab); step time, tokens/s and peak
   memory; one step under the profiler, which must show the SSD stage
   kernels; one step with remat "full", whose
   loss must equal the forward's and whose recompute launches are counted.
8. train_plain: one loss and gradient on the same parameters and batch
   through the kernels and through the plain twins, in bf16 compute (the
   loss's relative difference and the mean gradient-leaf cosine) and in
   fp32 compute (the loss and every gradient leaf's cosine), each against
   a fixed tolerance.
9. device_edge: 1,024 ImageNet-crop images (224 x 224 x 3 uint8, seed 0)
   behind a ``LatencyStorage`` (2 ms, 400 MB/s), global batch 64 (38.5 MB
   of float32), 16 batches through ``DataLoader.stream(to_device=True)``
   with 4 workers, once with pageable puts and once through the pinned
   staging ring (``zero_copy``); every delivered CUDA tensor must equal the
   host batch of the sampler's indices byte for byte.  The edge's bound is
   the rate of 20 ``non_blocking`` copies of one pinned 38.5 MB buffer.
10. dpt: Algorithm 1 (``DPT(LoaderEvaluator(loader, to_device=True))``) on
   the same data, 8 cores x 4 prefetch values, 16 batches a cell: every
   trial, the pick and its speedup over the default; every trial's window
   must hold at least 0.9 of its bytes over the bound, and the pick must
   beat the (G, 1) cell.
11. train_stream: a DPT-tuned loader over a token dataset (64 x 2048
   tokens) streams int32 batches through the CUDA edge into four steps of
   the phase 7 train state: the first batch equals the host batch byte for
   byte, losses are finite and fall, launches are exactly 48 ssd_scan and
   97 rmsnorm a step; one streamed step under the profiler.
12. hot_swap: the OnlineTuner's act step on the live CUDA edge: a stream
   of 16 ImageNet-crop batches starts at (2 workers, prefetch 2) and
   ``apply_params`` swaps in (4, 3) after batch 5; every delivered tensor
   equals the host batch of its position byte for byte, the positions
   cover the epoch exactly once, and the stream's second pool has the new
   params.
13. drift_retune: the OnlineTuner's decide step on the CUDA edge, through
   the flow of ``examples/torch_online_tuning.py`` (600 steps, the storage
   degraded at step 40): at least one retune and one completed hot swap,
   no search before the degradation; every delivered tensor equals the
   host batch of its position byte for byte; the params before and after,
   the mean step per phase and each search's seconds; then the degraded
   storage's steady step without the tuner at the start and at the pick,
   which must be the faster.
14. trainer: ``Trainer`` on full-width mamba2-780m (phase 7's state is
   released first) over phase 11's token data, DPT cache and checkpoints
   in a temporary directory removed at the end.  Run A trains 4 steps
   straight (DPT runs and fills the cache); B1 trains 2 steps and saves a
   blocking checkpoint (9.36 GB in ``repro``'s on-disk layout); B2 resumes
   it and trains to step 4, saving asynchronously at step 3 during step
   4's compute.  B1 and B2 tune from the cache (no trial, A's pick); B2
   starts at step 2 with every restored leaf bit-equal to B1's live state;
   B2's losses within 2e-3 of A's; launches exactly 48 ssd_scan and 97
   rmsnorm a step.  Free disk for three checkpoints is checked first.
15. kernels: one line listing every ported kernel with its launches on the
   paths above, error and times.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script then exits non-zero without that line.  It exits
non-zero at once when no CUDA device is present or when run outside a
checkout of the repository.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# full-width serving workload of phase 4
ARCH = "qwen2-0.5b"
MAX_BATCH = 8
NEW_TOKENS = 32
REQUESTS = ((512, 16), (300, 4))        # (prompt length, count)

# phase 5 tolerances: kernel path vs plain twins on the same weights,
# teacher-forced.  Both compute in fp32 inside each op and round to bf16
# at the same places; what differs is summation order, which flips the
# odd bf16 rounding and compounds over 24 layers.
MIN_COSINE = 0.999
MIN_TOP1 = 0.9
# phase 6 (mamba2) holds its kernels against the plain twins in fp32
# compute to those bounds, and in bf16 compute holds the kernel path's mean
# logit cosine to an fp32 plain reference within this margin of the plain
# bf16 path's own, which is about 0.97 for mamba2 on an NVIDIA H100 80GB
# HBM3 at 700 W (random weights at 48 layers amplify bf16 rounding,
# PERF.md section 6): a third of the plain path's own distance from 1.
BF16_MARGIN = 0.01
# the MoE phase's bf16 bound, by distance (1 - mean cosine) to the fp32
# plain reference: the kernel path's at most MOE_BF16_RATIO times the plain
# bf16 path's own, plus MOE_BF16_SLACK.  On granite the plain path sits
# 1.35e-3 to 1.46e-3 from fp32 and the kernel path 1.19e-3 to 1.29e-3
# (NVIDIA H100 80GB HBM3, 700 W), so mamba2's margin of 0.01 would pass a
# kernel path seven times farther.  The ratio leaves room for the run-to-
# run route flips of index_add's unordered atomics.  The same distance is
# read for the kernel path with one kernel's output rounded to fewer of
# bf16's 7 mantissa bits (kernel, bits); the last must fail the bound: an
# rmsnorm keeping 3 bits read 4.6e-3 against a bound of 2.2e-3, 4 bits
# 2.6e-3 and 5 bits 1.9e-3, a flash keeping 3 bits 2.5e-3 and 4 bits 1.5e-3
# (7 of every 8 logits checked are decode steps, where flash does not run)
MOE_BF16_RATIO, MOE_BF16_SLACK = 1.5, 1e-4
MOE_FAULTS = (("rmsnorm", 5), ("flash_attention", 3), ("rmsnorm", 4),
              ("rmsnorm", 3))
# phase 6's bf16 handoff on the served model: the prompt's last position
# to MIN_COSINE, the first decode step to this.  The step runs the fp32
# recurrence and GEMMs of 8 rows where the full forward runs the chunk
# scan and GEMMs of 4,104, and 48 layers compound their rounding: 0.99883
# at the lowest of 12 sequences on an NVIDIA H100 80GB HBM3 at 700 W.  A
# slot handed its neighbour's state must fall below it (checked).
SSM_BF16_DECODE_MIN_COSINE = 0.998

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores,
# fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

TOL = {"bfloat16": 2e-2, "float32": 2e-5}          # attention
TOL_NORM = {"bfloat16": 2e-2, "float32": 1e-5}     # rmsnorm, rmsnorm_residual
# ssd_scan: (rtol, atol as a fraction of max |y|).  fp32: fp32 inside
# both, but the chunk's cumsum of dt*A reaches about -180 at chunk 256 and
# is summed in another order (a warp scan against torch.cumsum): the two
# differ by ~1e-4 in absolute terms, which exp turns into ~1e-4 relative
# error in every decay.  bf16: the tensor-core kernels round each product
# operand to bf16 once (x dt exp(total - cum) in the chunk state, the
# decayed scores in the chunk scan), where the plain twin keeps them fp32;
# an output near 0 is a sum of terms each off by up to one bf16 rounding
# (2^-9 relative), so its error scales with the terms, not with itself:
# atol 4e-3 of max |y|, about one bf16 rounding of the largest output.
# Each row's ``atol_needed_of_max`` is the least atol that case needs: on
# an NVIDIA H100 80GB HBM3 at 700 W the bf16 cases needed 2.9e-4 to
# 1.13e-3 of max |y| (PERF.md section 6), so the fp32-era 2e-4 would not
# hold, and 4e-3 stands 3.5x above the worst.  The stage checks hold cum
# and the state passing, fp32 on both sides, to the fp32 pair.
TOL_SSD = {"bfloat16": (2e-2, 4e-3), "float32": (1e-3, 1e-4)}

# phase 6: full-width SSM serving workload, the same REQUESTS
SSM_ARCH = "mamba2-780m"

# phase 6b: full-width, full-depth MoE serving workload, the same REQUESTS;
# its logit checks force the first MOE_FORCED answered tokens (decode is
# host-bound at ~0.15 s a step, and eight forced runs of 32 steps would
# add ~30 s to the script)
MOE_ARCH = "granite-moe-3b-a800m"
MOE_FORCED = 8

# phase 6c: mixtral's ring cache at published widths, cut in depth; two
# prompts longer than the 4,096-token window, so the ring wraps at prefill
# and again in decode
RING_ARCH = "mixtral-8x22b"
RING_BATCH, RING_PROMPT = 2, 4608
RING_REDUCED = {
    "num_layers": "56 -> 2 (281 GB of bf16 weights do not fit one 80 GB "
                  "card)",
    "capacity_factor": "1.25 -> 8 (dropless, so that prefill + decode can "
                       "equal one full-sequence forward)"}

# phases 7-8: full-width training workload
TRAIN_ARCH = "mamba2-780m"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 4                          # timed, after one warm-up step
# phase 8 tolerances: the kernel path's loss and gradients against the
# plain twins' on the same parameters and batch.  In bf16 compute the
# activations are rounded at the same places on both paths; what differs
# is summation order inside the SSD scan and the norms, which flips the
# odd bf16 rounding and compounds over 48 layers.  The in_B / in_C
# gradients sum all 48 heads' contributions, which largely cancel, so
# single leaves there carry that noise at full size: bf16 is held on the
# loss and the mean leaf cosine, and every leaf is held in fp32 compute,
# where the two paths differ only by the scan's summation order.
MAX_LOSS_REL = 2e-3
MIN_GRAD_COSINE = 0.99

# phases 9-10: the device edge and DPT on ImageNet-crop images (224 x 224
# x 3 uint8, 154 MB raw in host RAM), global batch 64 (38.5 MB of float32
# a batch), 16 batches a stream and a DPT cell
EDGE_ITEMS, EDGE_RES, EDGE_BATCH = 1024, 224, 64
EDGE_STEPS = 16
EDGE_COPIES = 20                # pinned copies timed for the edge's bound
HOT_SWAP_AFTER = 5              # phase 12: batches before apply_params

# phase 14: the Trainer on the phase 11 token data.  Run A takes 4 steps,
# B1 2 and B2 the last 2 from B1's checkpoint; B2's losses must be A's to
# within this (the same init, batches and steps from a bit-equal restore:
# what differs is the order of atomic adds on the card).
TRAINER_STEPS = 4
TRAINER_LOSS_ATOL = 2e-3

# phase 13: the online tuner's drift flow (examples/torch_online_tuning.py),
# then the degraded steady state without the tuner, at the start and at
# the pick: DRIFT_STEADY timed steps after DRIFT_STEADY_WARMUP each
DRIFT_STEPS, DRIFT_AT, DRIFT_ITEMS = 600, 40, 4096
DRIFT_STEADY_WARMUP, DRIFT_STEADY = 8, 48


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call between CUDA events around ``iters``
    back-to-back calls: device time plus any gap the host's launches
    leave."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_busy(torch, fn):
    """Run ``fn`` once under the profiler (device activity only).
    Returns (wall seconds ending in a synchronize, summed device time of
    every kernel, memcpy and memset in seconds, key_averages)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in avgs)
    return wall, busy_us / 1e6, avgs


def device_ms(torch, fn, iters: int = 20):
    """Device time of one call: the profiler's summed kernel time over
    ``iters`` calls, without the host's launch gaps that ``time_ms`` sees.
    Returns (ms, timer).  A profiler window that records no device
    activity is retried; if none does, the time is taken with CUDA events
    instead and ``timer`` says so."""
    fn()
    for _ in range(3):
        _, busy, _ = device_busy(torch, lambda: [fn() for _ in range(iters)])
        if busy > 0:
            return busy * 1e3 / iters, "profiler"
    return time_ms(fn, iters), "events"


# device-time groups of a profile window, by kernel name: the first
# pattern a name contains decides its group
KERNEL_GROUPS = (
    ("ssd_scan", ("ssd_scan",)),
    ("flash_attention", ("flash_",)),
    ("rmsnorm (Triton)", ("rmsnorm",)),
    # sorts and top-k (MoE routing's argsort and top-k; the scatters,
    # gathers and index_add_ stay under elementwise, and moe_split
    # attributes the MoE layers' time exactly)
    ("sort and top-k", ("RadixSort", "radixSort", "topk", "TopK",
                        "bitonicSort", "sortKeyValue")),
    ("fp32 matmuls", ("f32f32", "sgemm", "gemmSN", "gemv")),
    ("bf16 matmuls", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reductions", ("reduce", "softmax", "logsumexp", "cumsum", "scan")),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset",
                                "fill", "index", "cat", "CatArray")),
)


def kernel_group(name: str) -> str:
    for group, patterns in KERNEL_GROUPS:
        if any(p in name for p in patterns):
            return group
    return "other"


def profile_phase(torch, name: str, fn, expect=()) -> dict:
    """Wall time, device busy time and idle share of one window, device
    time by kernel group, and the eight kernels that took the most device
    time in it.  Each name in ``expect`` must be part of a kernel that ran
    in the window (the main path went through it); its launches there are
    returned."""
    wall, busy, avgs = device_busy(torch, fn)
    seen = {k: sum(e.count for e in avgs if k in e.key) for k in expect}
    check(all(seen.values()), f"profile {name!r}: kernels {seen} expected")
    groups = {}
    for e in avgs:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    top = sorted(avgs, key=lambda e: -e.self_device_time_total)[:8]
    return dict(window=name, wall_ms=wall * 1e3, device_busy_ms=busy * 1e3,
                expected_kernels=seen,
                idle_share=1.0 - busy / wall,
                groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                top=[dict(kernel=e.key[:90], count=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in top])


def moe_split(torch, ll, fn) -> dict:
    """Device time inside the MoE layers of one window, split between the
    three batched expert products (``aten::bmm``) and the routing and
    dispatch around them (router product, softmax, top-k, stable argsort,
    one-hot / cumsum, slot tables, gather, gating, ``index_add``), from a
    trace that records the CPU ops too: each ``ll.moe`` call runs in a
    ``record_function`` range, and a kernel counts for the aten op that
    launched it.  The model is not instrumented; the range is added only
    for this window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    orig = ll.moe

    def traced(*args, **kwargs):
        with record_function("moe"):
            return orig(*args, **kwargs)

    ll.moe = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        ll.moe = orig
    calls, moe_us, bmm_us = 0, 0.0, 0.0

    def products(ev) -> float:
        return sum(ch.device_time_total if ch.name == "aten::bmm"
                   else products(ch) for ch in ev.cpu_children)

    for ev in prof.events():
        if ev.name == "moe" and ev.device_type == DeviceType.CPU:
            calls += 1
            moe_us += ev.device_time_total
            bmm_us += products(ev)
    check(calls > 0 and moe_us > 0,
          f"moe_split: {calls} MoE ranges with {moe_us} us of device time")
    return dict(moe_calls=calls, moe_device_ms=moe_us / 1e3,
                expert_products_ms=bmm_us / 1e3,
                routing_and_dispatch_ms=(moe_us - bmm_us) / 1e3)


def sdpa_backend(torch, fn) -> str:
    """The backend SDPA picked for ``fn``, from the kernels one call
    launches: flash, efficient (the CUTLASS memory-efficient kernel),
    cudnn or math (plain GEMMs and a softmax)."""
    _, _, avgs = device_busy(torch, fn)
    names = " ".join(e.key for e in avgs)
    for backend, pattern in (("flash", "flash_fwd"), ("efficient", "fmha"),
                             ("cudnn", "cudnn")):
        if pattern in names:
            return backend
    return "math"


def timings(torch, fns) -> dict:
    """``<name>_ms`` (device time per call, from the profiler) and
    ``<name>_event_ms`` (CUDA events around back-to-back calls, which also
    counts the gaps while the host launches) for each function."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"], out[f"{name}_timer"] = device_ms(torch, fn)
        out[f"{name}_event_ms"] = time_ms(fn)
    return out


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def atol_needed(out, ref, rtol: float) -> float:
    """The least absolute tolerance under which ``out`` passes against
    ``ref`` at relative tolerance ``rtol``."""
    a, b = out.float(), ref.float()
    return max(0.0, float(((a - b).abs() - rtol * b.abs()).max()))


def max_err(out, ref, tol: float, atol=None) -> float:
    """Largest |out - ref|; fails where it exceeds atol + tol * |ref|
    (atol defaults to tol)."""
    import torch
    a, b = out.float(), ref.float()
    check(bool(torch.isfinite(a).all()), "kernel output is not finite")
    err = (a - b).abs()
    atol = tol if atol is None else atol
    bad = err > atol + tol * b.abs()
    check(not bool(bad.any()),
          f"kernel disagrees with its plain twin: max err "
          f"{float(err.max())}, tol {tol}, atol {atol}")
    return float(err.max())


def ptxas_report(log: str) -> dict:
    """{kernel: ptxas' resource lines} from nvcc's -Xptxas -v log: each
    entry function, named name<template ints>, with its registers, static
    shared memory and spills."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            k = re.search(r"\d+((?:flash|ssd_scan)\w*?_kernel)(I\w+?E)?E",
                          name)
            if k:
                args = (["float"] if k.group(2) == "IfE"
                        else re.findall(r"Li(\d+)E", k.group(2) or ""))
                name = k.group(1) + (f"<{','.join(args)}>" if args else "")
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def dynamic_smem(_build) -> dict:
    """Dynamic shared memory each tensor-core launch asks for at the
    shapes of the main paths, from the libraries' own size functions
    (ptxas reports only static shared memory)."""
    fl, sl = _build.load("flash_attention"), _build.load("ssd_scan")
    out = {f"flash_mma_kernel<{D}>": fl.flash_attention_smem_bytes(D)
           for D in (64, 96, 128)}
    for stage, kernel in ((1, "ssd_scan_chunk_state_kernel"),
                          (3, "ssd_scan_chunk_scan_kernel")):
        out[f"{kernel} (chunk 256)"] = sl.ssd_scan_smem_bytes(stage, 256)
    check(all(v > 0 for v in out.values()), f"shared memory sizes {out}")
    return out


# --------------------------------------------------------------------------
# phase 3: kernel checks
# --------------------------------------------------------------------------
def flash_pairs(S: int, T: int, causal: bool, window: int,
                q_offset: int) -> int:
    """Visible (query, key) pairs of one (batch, head)."""
    n = 0
    for i in range(S):
        p = i + q_offset
        hi = min(T, p + 1) if causal else T
        lo = max(0, p - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def check_flash(torch, F, fa, gen, name, B, S, T, H, K, D, *, causal=True,
                window=0, q_offset=0, strided=False):
    """``strided``: q, k, v are views one element into rows of D + 2, so
    their rows are not 16-byte aligned."""
    rows = []
    pad = 2 if strided else 0

    def rand(shape, dt):
        x = torch.randn(shape[:-1] + (shape[-1] + pad,), generator=gen,
                        device="cuda").to(dt)
        return x[..., pad // 2:pad // 2 + shape[-1]]

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, k, v = (rand(shape, dt) for shape in
                   ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        err = max_err(out, ref, TOL[dtype])

        # yardstick: one SDPA call on (B,H,S,D) views with GQA
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pos_q = torch.arange(S, device="cuda")[:, None] + q_offset
        pos_k = torch.arange(T, device="cuda")[None, :]
        mask = torch.ones((S, T), dtype=torch.bool, device="cuda")
        if causal:
            mask &= pos_k <= pos_q
        if window > 0:
            mask &= pos_q - pos_k < window
        simple_causal = causal and window == 0 and q_offset == 0 and S == T
        sdpa_kw = ({"is_causal": True} if simple_causal
                   else {"attn_mask": mask})

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **sdpa_kw)

        elem = q.element_size()
        flops = 4.0 * B * H * D * flash_pairs(S, T, causal, window, q_offset)
        nbytes = elem * (2 * B * S * H * D + 2 * B * T * K * D)
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        fns = {"kernel": lambda: fa.flash_attention(q, k, v, **kw),
               "plain": lambda: fa.flash_attention_plain(q, k, v, **kw),
               "library": library}
        # SDPA has no window argument: a windowed case passes the
        # explicit boolean mask, and the row names the backend it took
        row = dict(kernel="flash_attention", case=name, dtype=dtype,
                   shape=dict(B=B, S=S, T=T, H=H, K=K, D=D, causal=causal,
                              window=window, q_offset=q_offset),
                   max_abs_err=err, tol=TOL[dtype],
                   **timings(torch, fns),
                   library_backend=sdpa_backend(torch, library),
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        emit("kernel_check", **row)
        rows.append(row)
    return rows


def check_rmsnorm(torch, F, rn, gen, name, rows_, d):
    out_rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x = torch.randn((rows_, d), generator=gen, device="cuda").to(dt)
        scale = torch.randn((d,), generator=gen, device="cuda")
        out = rn.rmsnorm(x, scale, eps=1e-6)
        torch.cuda.synchronize()
        err = max_err(out, rn.rmsnorm_plain(x, scale, 1e-6), TOL_NORM[dtype])
        scale_t = scale.to(dt)
        nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
        bound_ms, bound_by = bound(4.0 * x.numel(), nbytes, "float32")
        row = dict(kernel="rmsnorm", case=name, dtype=dtype,
                   shape=dict(rows=rows_, d=d), max_abs_err=err,
                   tol=TOL_NORM[dtype],
                   **timings(torch, {
                       "kernel": lambda: rn.rmsnorm(x, scale, eps=1e-6),
                       "plain": lambda: rn.rmsnorm_plain(x, scale, 1e-6),
                       "library": lambda: F.rms_norm(x, (d,), scale_t, 1e-6)}),
                   bound_ms=bound_ms, bound_by=bound_by,
                   flops=4.0 * x.numel(), bytes=nbytes)
        emit("kernel_check", **row)
        out_rows.append(row)
    return out_rows


def check_rmsnorm_residual(torch, rn, gen, name, rows_, d):
    out_rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x = torch.randn((rows_, d), generator=gen, device="cuda").to(dt)
        res = torch.randn((rows_, d), generator=gen, device="cuda").to(dt)
        scale = torch.randn((d,), generator=gen, device="cuda")
        y, h = rn.rmsnorm_residual(x, res, scale, eps=1e-6)
        torch.cuda.synchronize()
        y_ref, h_ref = rn.rmsnorm_residual_plain(x, res, scale, 1e-6)
        err = max(max_err(y, y_ref, TOL_NORM[dtype]),
                  max_err(h, h_ref, TOL_NORM[dtype]))
        nbytes = 4 * x.numel() * x.element_size() + scale.numel() * 4
        bound_ms, bound_by = bound(5.0 * x.numel(), nbytes, "float32")
        # no single PyTorch call adds and normalises with two outputs
        row = dict(kernel="rmsnorm_residual", case=name, dtype=dtype,
                   shape=dict(rows=rows_, d=d), max_abs_err=err,
                   tol=TOL_NORM[dtype],
                   **timings(torch, {
                       "kernel": lambda: rn.rmsnorm_residual(x, res, scale),
                       "plain": lambda: rn.rmsnorm_residual_plain(
                           x, res, scale, 1e-6)}),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   flops=5.0 * x.numel(), bytes=nbytes)
        emit("kernel_check", **row)
        out_rows.append(row)
    return out_rows


def ssd_cost(b, s, h, p, g, n, chunk, elem):
    """FLOPs the function needs per chunk (the causal triangle of C B^T
    and its product with x dt, chunk (chunk + 1) / 2 pairs of 2 (n + p)
    each, and the two state products) and the bytes of x, dt, A, B, C and
    y."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * pairs * (n + p) + 4 * chunk * n * p
    flops = float(per_chunk * b * h * (s // chunk))
    nbytes = float(elem * (2 * b * s * h * p + 2 * b * s * g * n)
                   + 4 * (b * s * h + h))
    return flops, nbytes


def ssd_inputs(torch, gen, b, s, h, p, g, n, dt_type, strided):
    """Inputs like the model's: dt = softplus(N(0,1)), A = -exp(N(0,1)/2);
    ``strided``: x, B and C are views into one (b, s, h*p + 2*g*n) tensor,
    as they are slices of the conv output in the model."""
    F = torch.nn.functional
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    if strided:
        u = torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                        device="cuda").to(dt_type)
        xs, Bm, Cm = torch.split(u, [h * p, g * n, g * n], dim=-1)
        return (xs.reshape(b, s, h, p), dt, A, Bm.reshape(b, s, g, n),
                Cm.reshape(b, s, g, n))
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dt_type)
    B = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dt_type)
    C = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dt_type)
    return x, dt, A, B, C


def check_ssd(torch, ops, ss, plain_ctx, gen, name, b, s, h, p, g, n, chunk,
              *, strided=False):
    """``ops.ssd`` (which pads a sequence that is not a multiple of the
    chunk) against the same call routed to the plain twin."""
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt_type = getattr(torch, dtype)
        x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, dt_type,
                                    strided)
        out = ops.ssd(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        with plain_ctx():
            ref = ops.ssd(x, dt, A, B, C, chunk=chunk)
        check(out.shape == x.shape and out.dtype == x.dtype,
              f"ssd_scan output {tuple(out.shape)} {out.dtype}")
        rtol, atol_of_max = TOL_SSD[dtype]
        y_max = float(ref.float().abs().max())
        err = max_err(out, ref, rtol, atol_of_max * y_max)
        c = min(chunk, s)
        s_pad = s + (-s) % c
        flops, nbytes = ssd_cost(b, s_pad, h, p, g, n, c, x.element_size())
        bound_ms, bound_by = bound(flops, nbytes, dtype)

        def plain():
            with plain_ctx():
                return ops.ssd(x, dt, A, B, C, chunk=chunk)

        fns = {"kernel": lambda: ops.ssd(x, dt, A, B, C, chunk=chunk),
               "plain": plain}
        if name == "slice":
            # the train step's backward: the plain recompute, per layer
            dy = torch.randn(x.shape, generator=gen, device="cuda").to(dt_type)
            fns["backward"] = lambda: ss.ssd_scan_backward(x, dt, A, B, C, dy,
                                                           chunk=chunk)
        # no PyTorch call computes a selective scan
        row = dict(kernel="ssd_scan", case=name, dtype=dtype,
                   shape=dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=chunk,
                              strided=strided),
                   max_abs_err=err, tol=rtol, atol=atol_of_max * y_max,
                   # what the check's atol has to be, against its limit
                   atol_needed_of_max=atol_needed(out, ref, rtol) / y_max,
                   atol_of_max=atol_of_max,
                   **timings(torch, fns),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   fp32_fma_floor_ms=flops / PEAK_FLOPS["float32"] * 1e3,
                   flops=flops, bytes=nbytes)
        emit("kernel_check", **row)
        rows.append(row)
    return rows


def check_ssd_state(torch, ops, plain_ctx, gen, name, b, s, h, p, g, n,
                    chunk, *, strided=True):
    """``ops.ssd_prefill`` (the scan kernel writing its final state too)
    against the same call routed to the plain twin: y to the scan's
    tolerance relative to max |y|, the state to the same pair relative to
    max |state| (the bf16 path's S_z rounds x dt exp(total - cum) to bf16
    once, as y's terms do), and the time against the y-only scan's on the
    same inputs."""
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt_type = getattr(torch, dtype)
        x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, dt_type,
                                    strided)
        y, state = ops.ssd_prefill(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        with plain_ctx():
            y_ref, state_ref = ops.ssd_prefill(x, dt, A, B, C, chunk=chunk)
        check(y.shape == x.shape and y.dtype == x.dtype
              and tuple(state.shape) == (b, h, p, n)
              and state.dtype == torch.float32,
              f"ssd_prefill output {tuple(y.shape)} {y.dtype}, state "
              f"{tuple(state.shape)} {state.dtype}")
        rtol, atol_of_max = TOL_SSD[dtype]
        y_max = float(y_ref.float().abs().max())
        s_max = float(state_ref.abs().max())
        err_y = max_err(y, y_ref, rtol, atol_of_max * y_max)
        err_s = max_err(state, state_ref, rtol, atol_of_max * s_max)
        c = min(chunk, s)
        s_pad = s + (-s) % c
        flops, nbytes = ssd_cost(b, s_pad, h, p, g, n, c, x.element_size())
        nbytes += 4.0 * b * h * p * n                  # the state written
        bound_ms, bound_by = bound(flops, nbytes, dtype)

        def plain():
            with plain_ctx():
                return ops.ssd_prefill(x, dt, A, B, C, chunk=chunk)

        row = dict(kernel="ssd_scan", case=name, dtype=dtype, state=True,
                   shape=dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=chunk,
                              strided=strided),
                   max_abs_err=err_y, state_max_abs_err=err_s, tol=rtol,
                   atol=atol_of_max * y_max,
                   state_atol=atol_of_max * s_max,
                   atol_needed_of_max=atol_needed(y, y_ref, rtol) / y_max,
                   state_atol_needed_of_max=atol_needed(
                       state, state_ref, rtol) / s_max,
                   atol_of_max=atol_of_max,
                   **timings(torch, {
                       "kernel": lambda: ops.ssd_prefill(x, dt, A, B, C,
                                                         chunk=chunk),
                       "y_only": lambda: ops.ssd(x, dt, A, B, C, chunk=chunk),
                       "plain": plain}),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes)
        emit("kernel_check", **row)
        rows.append(row)
    return rows


def check_ssd_stages(torch, ss, ref, gen, name, b, s, h, p, g, n, chunk,
                     *, strided=False):
    """Each bf16 stage kernel alone against its plain stage function, on
    the same inputs: stage 2 and 3 take the plain stage before's outputs,
    so a fault shows in the stage that has it.  cum and the state passing
    (the entering states and the final state) are fp32 on both sides (the
    fp32 tolerance); the states of stage 1 and
    y of stage 3 round a product operand to bf16 (the bf16 one).  Each
    stage's time is its C entry's alone, on buffers made once outside the
    timed calls (state passing works in place, which changes the values
    but not the work)."""
    x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, torch.bfloat16,
                                strided)
    cum, states = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    entering, final = ref.ssd_state_passing(states, cum)
    y = ref.ssd_chunk_scan(x, dt, B, C, cum, entering, chunk=chunk)
    k_cum, k_states = ss.run_stage("chunk_state", x, dt, A, B, C, chunk=chunk)
    k_entering, k_final = ss.run_stage("state_passing", x, dt, A, B, C,
                                       chunk=chunk, cum=cum, states=states)
    k_y = ss.run_stage("chunk_scan", x, dt, A, B, C, chunk=chunk, cum=cum,
                       states=entering)
    torch.cuda.synchronize()

    def err(out, ref_, dtype):
        rtol, atol_of_max = TOL_SSD[dtype]
        y_max = float(ref_.float().abs().max())
        return (max_err(out, ref_, rtol, atol_of_max * y_max), rtol,
                atol_needed(out, ref_, rtol) / y_max)

    # the C entries alone: scratch, a copy of stage 1's states for the
    # in-place stage 2, and contiguous cum / entering states, made once
    y_buf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    cum_buf, states_buf = ss._scratch(x, B, chunk)
    cum_c, entering_c = cum.contiguous(), entering.contiguous()
    passing_buf = states.contiguous().clone()

    def entry(stage, cum_, states_):
        return lambda: ss._call(ss.STAGES[stage], x, dt, A, B, C, y_buf,
                                cum_, states_, chunk)

    cases = {
        "chunk_state": (
            [err(k_cum, cum, "float32"), err(k_states, states, "bfloat16")],
            entry("chunk_state", cum_buf, states_buf),
            lambda: ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)),
        "state_passing": (
            [err(k_entering, entering, "float32"),
             err(k_final, final, "float32")],
            entry("state_passing", cum_c, passing_buf),
            lambda: ref.ssd_state_passing(states, cum)),
        "chunk_scan": (
            [err(k_y, y, "bfloat16")],
            entry("chunk_scan", cum_c, entering_c),
            lambda: ref.ssd_chunk_scan(x, dt, B, C, cum, entering,
                                       chunk=chunk)),
    }
    rows = []
    for stage, (errs, kernel, plain) in cases.items():
        row = dict(kernel="ssd_scan", stage=stage, case=name,
                   dtype="bfloat16",
                   shape=dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=chunk,
                              strided=strided),
                   max_abs_err=max(e for e, _, _ in errs),
                   tol=[t for _, t, _ in errs],
                   atol_needed_of_max=[a for _, _, a in errs],
                   **timings(torch, {"kernel": kernel, "plain": plain}))
        emit("ssd_stage", **row)
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# phases 5, 6 and 8: plain twins on the card
# --------------------------------------------------------------------------
@contextlib.contextmanager
def plain_kernels(ops, fa, rn, ss):
    """Route the model's kernel calls to the plain twins for the block."""
    saved = ops._fa, ops._rn, ops._ssd
    ops._fa = types.SimpleNamespace(flash_attention=fa.flash_attention_plain)
    ops._rn = types.SimpleNamespace(
        rmsnorm=lambda x, scale, *, eps: rn.rmsnorm_plain(x, scale, eps),
        rmsnorm_residual=lambda x, r, scale, *, eps:
            rn.rmsnorm_residual_plain(x, r, scale, eps))
    ops._ssd = types.SimpleNamespace(ssd_scan=ss.ssd_scan_plain,
                                     ssd_scan_state=ss.ssd_scan_state_plain)
    try:
        yield
    finally:
        ops._fa, ops._rn, ops._ssd = saved


@contextlib.contextmanager
def coarse_kernel(torch, ops, fa, rn, kernel: str, bits: int):
    """A faulty kernel for the block: the output of ``kernel``
    ("flash_attention" or "rmsnorm") rounded to nearest with ``bits``
    mantissa bits (bf16 keeps 7), as a kernel that lost precision would
    give.  The kernel still launches, and counts."""
    drop = 23 - bits

    def coarse(out):
        i = out.float().view(torch.int32)
        i = (i + (1 << (drop - 1))) & -(1 << drop)
        return i.view(torch.float32).to(out.dtype)

    saved = ops._fa, ops._rn
    if kernel == "flash_attention":
        ops._fa = types.SimpleNamespace(
            flash_attention=lambda *a, **kw: coarse(fa.flash_attention(*a,
                                                                       **kw)))
    else:
        ops._rn = types.SimpleNamespace(
            rmsnorm=lambda x, scale, *, eps: coarse(rn.rmsnorm(x, scale,
                                                               eps=eps)),
            rmsnorm_residual=rn.rmsnorm_residual)
    try:
        yield
    finally:
        ops._fa, ops._rn = saved


def forced_logits(torch, model, prompts, forced, kv_dtype=None):
    """Last-position logits of the prompt and of each teacher-forced step:
    (B, n, V) fp32, for prompts (B,S) and forced tokens (B,n), over a
    cache of ``kv_dtype`` (the model's default, bf16, if None)."""
    B, S = prompts.shape
    n = forced.shape[1]
    cache = model.init_cache(B, S + n, **(
        {} if kv_dtype is None else {"kv_dtype": kv_dtype}))
    logits, cache = model.prefill({"tokens": prompts}, cache)
    outs = [logits[:, -1].float()]
    pos = torch.full((B,), S, dtype=torch.long, device=prompts.device)
    for j in range(n - 1):
        logits, cache = model.decode_step(cache, forced[:, j:j + 1], pos)
        outs.append(logits[:, -1].float())
        pos = pos + 1
    return torch.stack(outs, dim=1)


def full_sequence_logits(torch, model, tokens, first: int):
    """Logits (B, n, V) fp32 of positions ``first`` .. S-1 of one
    full-sequence forward of ``tokens`` (B,S) through the kernels: the
    training forward, with no cache."""
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as stk
    cfg = model.cfg
    B, S = tokens.shape
    with torch.no_grad():
        x = ll.embed(model.embed, cfg, tokens)
        pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, _ = stk.run_stack(model.layers, cfg, x, positions=pos)
        h = ll.norm(model.final_norm, x[:, first:].contiguous(), cfg)
        return ll.unembed(model.embed, cfg, h).float()


def serve_path(torch, np, F, modules, arch: str) -> dict:
    """Phases 4-5 (qwen2-0.5b), 6 (mamba2-780m) and 6b (granite-moe) at
    full width: serve ``REQUESTS`` through the frontend with exact launch
    counts, profile a prefill and eight decode steps, then hold
    teacher-forced logits against the plain twins' (and, for the SSM,
    against a full-sequence forward).  Returns the launches of the serving
    run."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.models.module import init_params
    from repro_torch.serve.engine import BatchingFrontend, ServeEngine
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    from repro_torch.models import layers as ll
    cfg = get_config(arch)
    ssm = cfg.family == "ssm"
    moe = cfg.family == "moe"
    tag = {"ssm": "_ssm", "moe": "_moe"}.get(cfg.family, "")
    t0 = time.perf_counter()
    wgen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(DecoderLM.param_specs(cfg), wgen)
    model = build_model(cfg, params, device="cuda")
    del params
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    results = []

    class RecordingEngine(ServeEngine):
        def generate(self, prompts, max_new_tokens, *, seed=0):
            res = super().generate(prompts, max_new_tokens, seed=seed)
            results.append(res)
            return res

    max_len = max(p for p, _ in REQUESTS) + NEW_TOKENS + 8
    engine = RecordingEngine(model, max_batch=MAX_BATCH, max_len=max_len,
                             device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
               for plen, count in REQUESTS for _ in range(count)]
    engine.generate(np.stack(prompts[:MAX_BATCH]), 4)     # warm-up
    results.clear()

    def counts():
        return {"flash_attention": fa.flash_attention.launches,
                "rmsnorm": rn.rmsnorm.launches,
                "ssd_scan": ss.ssd_scan.launches}

    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = rn.rmsnorm.launches = 0
    ss.ssd_scan.launches = 0
    t0 = time.perf_counter()
    frontend = BatchingFrontend(engine, max_wait_s=0.05)
    try:
        reqs = [frontend.submit(p, NEW_TOKENS) for p in prompts]
        outs = [r.result.get(timeout=600) for r in reqs]
    finally:
        frontend.shutdown()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    peak_bytes = torch.cuda.max_memory_allocated()

    check(len(outs) == len(prompts), "not every request was answered")
    for o in outs:
        check(o.shape == (NEW_TOKENS,) and o.min() >= 0
              and o.max() < cfg.vocab_size, f"bad answer {o!r}")
    L = cfg.num_layers
    batches = len(results)
    steps = sum(r.steps - 1 for r in results)
    # one scan (SSM) or attention (dense) per layer and prefill; decode
    # runs the recurrence or ragged attention, no kernel; two norms a
    # layer and the final norm in every forward
    mixer = L * batches
    expect = {"flash_attention": 0 if ssm else mixer,
              "rmsnorm": (2 * L + 1) * (batches + steps),
              "ssd_scan": mixer if ssm else 0}
    decode_tokens = sum(r.tokens.shape[0] * (r.steps - 1) for r in results)
    decode_s = sum(r.decode_s for r in results)
    cache_bytes = sum(t.numel() * t.element_size() for t in
                      model.init_cache(MAX_BATCH, max_len).values())
    emit("serve" + tag, arch=cfg.name, params=cfg.param_count(),
         requests=len(outs), batches_served=frontend.batches_served,
         prefill_s=[r.prefill_s for r in results],
         decode_s=[r.decode_s for r in results],
         decode_tokens_per_s=decode_tokens / decode_s,
         wall_s=wall_s,
         tokens_per_s_end_to_end=len(outs) * NEW_TOKENS / wall_s,
         peak_mem_bytes=peak_bytes, cache_bytes_batch8=cache_bytes,
         weights_load_s=load_s, launches=launches, expected_launches=expect)
    check(launches == expect,
          f"kernel launches {launches}, the path implies {expect}")

    # where the time goes: one prefill and eight decode steps of a full
    # batch, under the profiler
    pt = torch.as_tensor(np.stack(prompts[:MAX_BATCH]), dtype=torch.long,
                         device="cuda")
    cache = model.init_cache(MAX_BATCH, max_len)
    def prefill():
        model.prefill({"tokens": pt}, cache)

    tok = pt[:, -1:]
    pos = torch.full((MAX_BATCH,), pt.shape[1], dtype=torch.long,
                     device="cuda")

    def decode_steps():
        for j in range(8):
            model.decode_step(cache, tok, pos + j)

    for window, fn, expect in (
            (f"{cfg.name} prefill 8x512", prefill,
             ("ssd_scan_state_passing_kernel",) if ssm
             else ("flash_mma_kernel",)),
            (f"{cfg.name} 8 decode steps, batch 8", decode_steps,
             ("rmsnorm",) if ssm or moe else ())):
        row = profile_phase(torch, window, fn, expect=expect)
        if moe:
            row["moe_split"] = moe_split(torch, ll, fn)
        emit("profile", **row)
    del cache

    # ---- the same prompts through the plain twins ---------------------------
    # one batch of each prompt length, forced with what the path answered
    n_short = REQUESTS[-1][1]
    batches_ = []
    for sl in (slice(0, MAX_BATCH), slice(len(prompts) - n_short, None)):
        batches_.append(tuple(
            torch.as_tensor(np.stack(a[sl]), dtype=torch.long, device="cuda")
            for a in (prompts, outs)))
    if ssm:
        ssm_logit_checks(torch, F, modules, cfg, model, batches_, counts)
        return launches
    if moe:
        moe_logit_checks(torch, F, modules, cfg, model, batches_, counts)
        return launches
    cos_all, top1_all = [], []
    for pt, ft in batches_:
        with_kernels = forced_logits(torch, model, pt, ft)
        before = counts()
        with plain_kernels(ops, fa, rn, ss):
            plain = forced_logits(torch, model, pt, ft)
        check(counts() == before, "the plain run launched a kernel")
        check(bool(torch.isfinite(with_kernels).all()), "logits not finite")
        cos_all.append(F.cosine_similarity(with_kernels, plain, dim=-1))
        top1_all.append((with_kernels.argmax(-1) == plain.argmax(-1)).float())
    cos = torch.cat([c.flatten() for c in cos_all])
    top1 = float(torch.cat([t.flatten() for t in top1_all]).mean())
    prefill_cos = float(torch.cat([c[:, 0] for c in cos_all]).min())
    emit("plain", positions=int(cos.numel()),
         cosine_min=float(cos.min()), cosine_mean=float(cos.mean()),
         prefill_cosine_min=prefill_cos, top1_agreement=top1,
         min_cosine=MIN_COSINE, min_top1=MIN_TOP1)
    check(float(cos.min()) >= MIN_COSINE,
          f"cosine {float(cos.min())} < {MIN_COSINE}")
    check(top1 >= MIN_TOP1, f"top-1 agreement {top1} < {MIN_TOP1}")
    return launches


def ssm_logit_checks(torch, F, modules, cfg, model, batches_, counts):
    """Phase 6's logit checks on the forced batches ``batches_`` [(prompts,
    forced tokens)], ``model`` being the served bf16 model.

    ``plain_ssm``: random-weight mamba2 at 48 layers amplifies rounding, so
    in bf16 compute the plain twins themselves sit far from an fp32
    reference (PERF.md section 6).  So the kernels are held against the
    plain twins in fp32 compute (the same weights; both paths fp32, they
    differ by summation order), to the qwen2 bounds; in bf16 the kernel
    path's mean cosine to the fp32 plain reference must be within
    ``BF16_MARGIN`` of the plain bf16 path's.

    ``prefill_vs_full``: fp32 prefill + decode logits (kernels) against one
    full-sequence forward of the prompt and the forced tokens (kernels),
    held at the prefill position and the first decode step, where the
    carried conv tail and state take over from the scan; later positions
    are reported (the cache rounds the conv tail to bf16, as JAX does, and
    the model amplifies that step by step).  The same handoff is held in
    bf16 on the served model, per sequence, against a bf16 full-sequence
    forward of the prompt and the first forced token: both sides run the
    bf16 stage kernels, so it holds the final state that the bf16 prefill
    hands to each slot (the prompt's last position to ``MIN_COSINE``, the
    first decode step to ``SSM_BF16_DECODE_MIN_COSINE``, which a slot
    handed its neighbour's state must fail)."""
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.models import layers as ll
    from repro_torch.models.module import init_params
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    def plain_run(m, pt, ft):
        before = counts()
        with plain_kernels(ops, fa, rn, ss):
            out = forced_logits(torch, m, pt, ft)
        check(counts() == before, "the plain run launched a kernel")
        return out

    def cos(a, b):
        return F.cosine_similarity(a, b, dim=-1)          # (B, n)

    def top1(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float()

    bf16, handoff16 = [], []
    for pt, ft in batches_:
        k16 = forced_logits(torch, model, pt, ft)
        check(bool(torch.isfinite(k16).all()), "logits not finite")
        bf16.append((k16, plain_run(model, pt, ft)))
        # the served bf16 path at the handoff: the prompt's last position
        # and the first decode step against one bf16 full-sequence forward
        # of the prompt and the first forced token, both through the
        # kernels (the three bf16 stage kernels, and in prefill the final
        # state store), held per sequence and per position
        seq = torch.cat([pt, ft[:, :1]], dim=1)
        full16 = full_sequence_logits(torch, model, seq, pt.shape[1] - 1)
        handoff16.append(cos(k16[:, :2], full16))
    # what the bf16 bound separates: the first decode step of the last
    # batch with each slot handed its neighbour's final state
    B, S = pt.shape
    cache = model.init_cache(B, S + 1)
    model.prefill({"tokens": pt}, cache)
    cache["ssm_state"].copy_(cache["ssm_state"].roll(1, dims=1))
    logits, _ = model.decode_step(
        cache, ft[:, :1], torch.full((B,), S, dtype=torch.long,
                                     device=pt.device))
    rolled = cos(logits[:, -1].float(), full16[:, 1])
    del cache
    saved = ll.COMPUTE_DTYPE
    ll.COMPUTE_DTYPE = torch.float32
    try:
        params = init_params(DecoderLM.param_specs(cfg),
                             torch.Generator(device="cuda").manual_seed(0))
        m32 = build_model(cfg, params, device="cuda")
        del params
        fp32 = []
        for pt, ft in batches_:
            seq = torch.cat([pt, ft[:, :-1]], dim=1)
            fp32.append((forced_logits(torch, m32, pt, ft),
                         plain_run(m32, pt, ft),
                         full_sequence_logits(torch, m32, seq,
                                              pt.shape[1] - 1)))
        del m32
    finally:
        ll.COMPUTE_DTYPE = saved

    def cat(xs):
        return torch.cat([x.flatten() for x in xs])

    c32 = cat([cos(k, p) for k, p, _ in fp32])
    t32 = float(cat([top1(k, p) for k, p, _ in fp32]).mean())
    k16_ref = cat([cos(k, p32) for (k, _), (_, p32, _) in zip(bf16, fp32)])
    p16_ref = cat([cos(p, p32) for (_, p), (_, p32, _) in zip(bf16, fp32)])
    c16 = cat([cos(k, p) for k, p in bf16])
    emit("plain_ssm", positions=int(c32.numel()),
         fp32_cosine_min=float(c32.min()), fp32_cosine_mean=float(c32.mean()),
         fp32_top1_agreement=t32,
         bf16_cosine_min=float(c16.min()), bf16_cosine_mean=float(c16.mean()),
         bf16_top1_agreement=float(cat([top1(k, p) for k, p in bf16]).mean()),
         bf16_kernel_to_fp32_cosine_mean=float(k16_ref.mean()),
         bf16_plain_to_fp32_cosine_mean=float(p16_ref.mean()),
         min_cosine=MIN_COSINE, min_top1=MIN_TOP1,
         bf16_margin=BF16_MARGIN)
    check(float(c32.min()) >= MIN_COSINE,
          f"fp32 cosine {float(c32.min())} < {MIN_COSINE}")
    check(t32 >= MIN_TOP1, f"fp32 top-1 agreement {t32} < {MIN_TOP1}")
    check(float(k16_ref.mean()) >= float(p16_ref.mean()) - BF16_MARGIN,
          f"bf16 kernels' mean cosine to the fp32 reference "
          f"{float(k16_ref.mean())}, the plain twins' {float(p16_ref.mean())}")

    full = torch.cat([cos(k, f) for k, _, f in fp32])     # (sequences, n)
    handoff = full[:, :2]
    h16 = torch.cat(handoff16)                            # (sequences, 2)
    emit("prefill_vs_full", positions=int(full.numel()),
         handoff_cosine_min=float(handoff.min()),
         bf16_handoff_cosine_min_by_step=[float(v) for v in h16.min(0)[0]],
         bf16_handoff_cosine_min_by_sequence=[
             float(v) for v in h16.min(1)[0]],
         bf16_min_cosine=[MIN_COSINE, SSM_BF16_DECODE_MIN_COSINE],
         bf16_neighbour_state_cosine_max=float(rolled.max()),
         cosine_mean_by_step=[float(v) for v in full.mean(0)],
         cosine_min=float(full.min()), min_cosine=MIN_COSINE,
         top1_agreement=float(cat([top1(k, f) for k, _, f in fp32]).mean()))
    check(float(handoff.min()) >= MIN_COSINE,
          f"prefill + first decode step against the full sequence: cosine "
          f"{float(handoff.min())} < {MIN_COSINE}")
    check(float(h16[:, 0].min()) >= MIN_COSINE,
          f"bf16 prefill against the bf16 full sequence: cosine "
          f"{float(h16[:, 0].min())} < {MIN_COSINE}")
    check(float(h16[:, 1].min()) >= SSM_BF16_DECODE_MIN_COSINE,
          f"bf16 first decode step against the bf16 full sequence: cosine "
          f"{float(h16[:, 1].min())} < {SSM_BF16_DECODE_MIN_COSINE}")
    check(float(rolled.max()) < SSM_BF16_DECODE_MIN_COSINE,
          f"a neighbour's state passes the bf16 decode bound: cosine "
          f"{float(rolled.max())}")


def moe_logit_checks(torch, F, modules, cfg, model, batches_, counts):
    """Phase 6b's logit checks on the forced batches ``batches_`` [(prompts,
    forced tokens)], ``model`` being the served bf16 granite-moe.

    ``plain_moe``: in fp32 compute the kernels are held against the plain
    twins to phase 5's bounds (the same weights; the two paths differ by
    summation order).  In bf16 compute a rounding difference between flash
    and its twin can move a top-8 choice in one of 32 layers, and at
    capacity 1.25 push another token out of its expert, so bf16 is held by
    distance (1 - mean cosine) to the fp32 plain reference: the kernel
    path's at most ``MOE_BF16_RATIO`` times the plain bf16 path's, plus
    ``MOE_BF16_SLACK``.  The same distance is read for the kernel path
    with each of ``MOE_FAULTS``' kernels made coarse (``coarse_kernel``),
    and the last must fail the bound.  The route
    agreement is the share of (token, k) expert choices the kernel path
    and the plain path share, layer by layer, over the prompts and the
    forced steps (the first ``MOE_FORCED`` answered tokens)."""
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.models import layers as ll
    from repro_torch.models.module import init_params
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))
    L = cfg.num_layers

    def run(m, pt, ft, plain, fault=None):
        """Forced logits and each ``_route`` call's top-k experts."""
        routes, orig = [], ll._route

        def recording(p, cfg_, xf):
            out = orig(p, cfg_, xf)
            routes.append(out[1])
            return out

        before = counts()
        ll._route = recording
        try:
            with (plain_kernels(ops, fa, rn, ss) if plain
                  else coarse_kernel(torch, ops, fa, rn, *fault)
                  if fault else contextlib.nullcontext()):
                out = forced_logits(torch, m, pt, ft)
        finally:
            ll._route = orig
        if plain:
            check(counts() == before, "the plain run launched a kernel")
        check(bool(torch.isfinite(out).all()), "logits not finite")
        check(len(routes) == L * ft.shape[1], f"{len(routes)} routings")
        return out, routes

    def agreement(a, b):
        """Per layer: the share of a's (token, k) choices that b also made
        for that token."""
        shared, total = [0.0] * L, [0] * L
        for i, (x, y) in enumerate(zip(a, b)):
            shared[i % L] += float((x[:, :, None] == y[:, None, :])
                                   .any(-1).sum())
            total[i % L] += x.numel()
        return [sh / t for sh, t in zip(shared, total)]

    def cos(a, b):
        return F.cosine_similarity(a, b, dim=-1)

    batches_ = [(pt, ft[:, :MOE_FORCED]) for pt, ft in batches_]
    runs = {}
    for i, (pt, ft) in enumerate(batches_):
        runs[("bf16", "kernel", i)] = run(model, pt, ft, False)
        runs[("bf16", "plain", i)] = run(model, pt, ft, True)
        for fault in MOE_FAULTS:
            runs[("bf16", fault, i)] = run(model, pt, ft, False, fault)
    saved = ll.COMPUTE_DTYPE
    ll.COMPUTE_DTYPE = torch.float32
    try:
        params = init_params(DecoderLM.param_specs(cfg),
                             torch.Generator(device="cuda").manual_seed(0))
        m32 = build_model(cfg, params, device="cuda")
        del params
        for i, (pt, ft) in enumerate(batches_):
            runs[("fp32", "kernel", i)] = run(m32, pt, ft, False)
            runs[("fp32", "plain", i)] = run(m32, pt, ft, True)
        del m32
    finally:
        ll.COMPUTE_DTYPE = saved
    n = len(batches_)

    def cat(f):
        return torch.cat([f(i).flatten() for i in range(n)])

    def logits(dt, path, i):
        return runs[(dt, path, i)][0]

    c32 = cat(lambda i: cos(logits("fp32", "kernel", i),
                            logits("fp32", "plain", i)))
    t32 = float(cat(lambda i: (logits("fp32", "kernel", i).argmax(-1)
                               == logits("fp32", "plain", i).argmax(-1))
                    .float()).mean())
    k16 = cat(lambda i: cos(logits("bf16", "kernel", i),
                            logits("fp32", "plain", i)))
    p16 = cat(lambda i: cos(logits("bf16", "plain", i),
                            logits("fp32", "plain", i)))
    c16 = cat(lambda i: cos(logits("bf16", "kernel", i),
                            logits("bf16", "plain", i)))
    p_dist = 1.0 - float(p16.mean())
    bound16 = MOE_BF16_RATIO * p_dist + MOE_BF16_SLACK
    k_dist = 1.0 - float(k16.mean())
    fault_dist = {
        fault: 1.0 - float(cat(lambda i: cos(logits("bf16", fault, i),
                                             logits("fp32", "plain", i)))
                           .mean())
        for fault in MOE_FAULTS}
    route = {}
    for dt in ("bf16", "fp32"):
        per_layer = [agreement(runs[(dt, "kernel", i)][1],
                               runs[(dt, "plain", i)][1]) for i in range(n)]
        layer = [min(v[j] for v in per_layer) for j in range(L)]
        route[dt] = dict(min=min(layer), mean=sum(layer) / L,
                         by_layer=[round(v, 6) for v in layer])
    emit("plain_moe", positions=int(c32.numel()),
         fp32_cosine_min=float(c32.min()), fp32_cosine_mean=float(c32.mean()),
         fp32_top1_agreement=t32,
         bf16_cosine_min=float(c16.min()), bf16_cosine_mean=float(c16.mean()),
         bf16_kernel_to_fp32_cosine_mean=float(k16.mean()),
         bf16_plain_to_fp32_cosine_mean=float(p16.mean()),
         bf16_kernel_distance=k_dist, bf16_plain_distance=p_dist,
         bf16_distance_bound=bound16,
         bf16_coarse_kernel_distance={f"{k} {b} bits": d
                                      for (k, b), d in fault_dist.items()},
         route_agreement=route, min_cosine=MIN_COSINE, min_top1=MIN_TOP1,
         bf16_ratio=MOE_BF16_RATIO, bf16_slack=MOE_BF16_SLACK)
    check(float(c32.min()) >= MIN_COSINE,
          f"fp32 cosine {float(c32.min())} < {MIN_COSINE}")
    check(t32 >= MIN_TOP1, f"fp32 top-1 agreement {t32} < {MIN_TOP1}")
    check(k_dist <= bound16,
          f"bf16 kernels' distance to the fp32 reference {k_dist} > "
          f"{bound16} (the plain twins' {p_dist})")
    kernel, bits = MOE_FAULTS[-1]
    check(fault_dist[MOE_FAULTS[-1]] > bound16,
          f"{kernel} keeping {bits} mantissa bits passes the bf16 bound: "
          f"distance {fault_dist[MOE_FAULTS[-1]]} <= {bound16}")


def ring_path(torch, np, F, modules) -> dict:
    """Phase 6c: mixtral-8x22b at published widths and depth 2 (dropless),
    served through the frontend: two prompts of ``RING_PROMPT`` tokens,
    longer than the 4,096-token window, so the K/V ring of 4,096 slots
    wraps at prefill (the roll) and again in decode; exact launches (flash
    with window 4,096 at head dim 128, L a prefill).  Then
    ``ring_vs_full``: every slot of the first layer's ring holds the K of
    the position it must (p % 4,096) after prefill and after 32 decode
    steps, which a ring holding the prompt's first 4,096 positions (what a
    prefill that does not roll keeps) fails; prefill + 32 teacher-forced
    decode steps against one full-sequence forward of the prompt and the
    forced tokens (4,640 positions), both through the kernels, in fp32
    compute over an fp32 cache at every position, and in bf16 on the
    served model at the prompt's last position and the first decode step;
    and that fp32 full forward against the same forward through the plain
    twins, which holds the windowed flash at head dim 128 and rmsnorm at
    d_model 6144 against their twins on the served inputs.
    Random weights attend nearly uniformly over a window of 4,096, so the
    logits alone barely see which positions a ring holds: the slot check
    is the one that tells a misplaced ring.  Returns the launches of the
    serving run."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as stk
    from repro_torch.models.module import init_params
    from repro_torch.serve.engine import BatchingFrontend, ServeEngine
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    base = get_config(RING_ARCH)
    cfg = dataclasses.replace(base, num_layers=2,
                              capacity_factor=float(base.num_experts))
    check(stk.use_ring_cache(cfg), "mixtral should decode over a ring")
    L, W = cfg.num_layers, cfg.sliding_window

    def load():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(DecoderLM.param_specs(cfg), gen)
        return build_model(cfg, params, device="cuda")

    t0 = time.perf_counter()
    model = load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    results = []

    class RecordingEngine(ServeEngine):
        def generate(self, prompts_, max_new_tokens, *, seed=0):
            res = super().generate(prompts_, max_new_tokens, seed=seed)
            results.append(res)
            return res

    max_len = RING_PROMPT + NEW_TOKENS + 8
    engine = RecordingEngine(model, max_batch=RING_BATCH, max_len=max_len,
                             device="cuda")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           (RING_BATCH, RING_PROMPT)).astype(np.int32)
    engine.generate(prompts, 2)                            # warm-up
    results.clear()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = rn.rmsnorm.launches = 0
    t0 = time.perf_counter()
    frontend = BatchingFrontend(engine, max_wait_s=0.05)
    try:
        reqs = [frontend.submit(p, NEW_TOKENS) for p in prompts]
        outs = [r.result.get(timeout=600) for r in reqs]
    finally:
        frontend.shutdown()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "rmsnorm": rn.rmsnorm.launches}
    batches = len(results)
    steps = sum(r.steps - 1 for r in results)
    expect = {"flash_attention": L * batches,
              "rmsnorm": (2 * L + 1) * (batches + steps)}
    slots = model.init_cache(RING_BATCH, max_len)["k"].shape[2]
    emit("serve_ring", arch=cfg.name, layers=L, window=W,
         params=cfg.param_count(), reduced=RING_REDUCED,
         requests=len(outs), prompt_tokens=RING_PROMPT,
         batches_served=frontend.batches_served, cache_slots=slots,
         prefill_s=[r.prefill_s for r in results],
         decode_s=[r.decode_s for r in results],
         decode_tokens_per_s=sum(r.tokens.shape[0] * (r.steps - 1)
                                 for r in results)
         / sum(r.decode_s for r in results),
         wall_s=wall_s, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         weights_load_s=load_s, launches=launches,
         expected_launches=expect)
    check(slots == W, f"ring of {slots} slots, the window is {W}")
    for o in outs:
        check(o.shape == (NEW_TOKENS,) and o.min() >= 0
              and o.max() < cfg.vocab_size, f"bad answer {o!r}")
    check(launches == expect,
          f"kernel launches {launches}, the path implies {expect}")

    # ---- the ring's slots, and prefill + decode against a full forward ----
    pt = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    extra = rng.integers(0, cfg.vocab_size, (RING_BATCH, 1))
    ft = torch.as_tensor(np.concatenate([np.stack(outs), extra], axis=1),
                         dtype=torch.long, device="cuda")      # (B, 33)
    S, n = RING_PROMPT, ft.shape[1]
    seq = torch.cat([pt, ft[:, :-1]], dim=1)                   # 4,640

    def cos(a, b):
        return F.cosine_similarity(a, b, dim=-1)

    def slot_cosines(cache, last: int):
        """Per-slot cosine of the first layer's cached K against the K of
        the position the slot must hold (p % W for the W positions up to
        ``last``), recomputed from the tokens: layer 0's K depends on its
        token and position alone."""
        with torch.no_grad():
            p0 = model.layers[0]
            x = ll.embed(model.embed, cfg, seq[:, :last + 1])
            pos = torch.arange(last + 1, device="cuda")[None].expand(
                RING_BATCH, -1)
            _, k, _ = ll._project_qkv(p0["attn"], cfg,
                                      ll.norm(p0["ln1"], x, cfg))
            k = ll.rotary(k, pos, cfg.rope_theta)[:, last + 1 - W:]
            slots = (torch.arange(last + 1 - W, last + 1, device="cuda")
                     % W)
            want = torch.empty_like(k)
            want[:, slots] = k
            return cos(cache["k"][0].flatten(2).float(),
                       want.flatten(2).float())                # (B, W)

    cache = model.init_cache(RING_BATCH, S + n)
    logits, cache = model.prefill({"tokens": pt}, cache)
    after_prefill = slot_cosines(cache, S - 1)
    k16 = [logits[:, -1].float()]
    pos = torch.full((RING_BATCH,), S, dtype=torch.long, device="cuda")
    for j in range(n - 1):
        logits, cache = model.decode_step(cache, ft[:, j:j + 1], pos + j)
        k16.append(logits[:, -1].float())
    after_decode = slot_cosines(cache, S + n - 2)
    # what a prefill that does not roll keeps: the prompt's first W
    # positions in slots 0..W-1
    stale = model.init_cache(RING_BATCH, S + n)
    model.prefill({"tokens": pt[:, :W]}, stale)
    stale_slots = slot_cosines(stale, S - 1)
    del cache, stale
    full16 = full_sequence_logits(torch, model, seq[:, :S + 1], S - 1)
    h16 = cos(torch.stack(k16[:2], 1), full16)                 # (B, 2)
    del model, engine
    torch.cuda.empty_cache()
    saved = ll.COMPUTE_DTYPE
    ll.COMPUTE_DTYPE = torch.float32
    try:
        m32 = load()
        k32 = forced_logits(torch, m32, pt, ft, kv_dtype=torch.float32)
        full32 = full_sequence_logits(torch, m32, seq, S - 1)
        before = (fa.flash_attention.launches, rn.rmsnorm.launches)
        with plain_kernels(ops, fa, rn, ss):
            plain32 = full_sequence_logits(torch, m32, seq, S - 1)
        check((fa.flash_attention.launches, rn.rmsnorm.launches) == before,
              "the plain run launched a kernel")
        del m32
    finally:
        ll.COMPUTE_DTYPE = saved
    c32 = cos(k32, full32)                                      # (B, 33)
    cp = cos(full32, plain32)
    tp = float((full32.argmax(-1) == plain32.argmax(-1)).float().mean())
    emit("ring_vs_full", positions=int(c32.numel()),
         full_sequence=int(seq.shape[1]),
         slot_cosine_min_after_prefill=float(after_prefill.min()),
         slot_cosine_min_after_decode=float(after_decode.min()),
         stale_ring_slot_cosine_min=float(stale_slots.min()),
         stale_ring_wrong_slot_share=float(
             (stale_slots < MIN_COSINE).float().mean()),
         fp32_cosine_min=float(c32.min()),
         fp32_cosine_min_by_step=[float(v) for v in c32.min(0)[0]],
         bf16_handoff_cosine_min_by_step=[float(v) for v in h16.min(0)[0]],
         fp32_full_kernels_vs_plain_cosine_min=float(cp.min()),
         fp32_full_kernels_vs_plain_top1_agreement=tp,
         min_cosine=MIN_COSINE, min_top1=MIN_TOP1)
    check(float(after_prefill.min()) >= MIN_COSINE
          and float(after_decode.min()) >= MIN_COSINE,
          f"ring slots: cosine {float(after_prefill.min())} after prefill, "
          f"{float(after_decode.min())} after decode < {MIN_COSINE}")
    check(float(stale_slots.min()) < MIN_COSINE,
          f"a ring of the prompt's first {W} positions passes the slot "
          f"check: cosine {float(stale_slots.min())}")
    check(float(c32.min()) >= MIN_COSINE,
          f"fp32 prefill + decode against the full sequence: cosine "
          f"{float(c32.min())} < {MIN_COSINE}")
    check(float(h16.min()) >= MIN_COSINE,
          f"bf16 handoff against the full sequence: cosine "
          f"{float(h16.min())} < {MIN_COSINE}")
    check(float(cp.min()) >= MIN_COSINE and tp >= MIN_TOP1,
          f"fp32 full forward, kernels against plain twins: cosine "
          f"{float(cp.min())}, top-1 agreement {tp}")
    return launches


def train_path(torch, np, F, modules):
    """Phases 7-8 at full width.  Returns the launches of the timed steps,
    the train state and the step function (phase 11 trains on), and the
    profiled step's idle share."""
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    cfg = get_config(TRAIN_ARCH)
    L = cfg.num_layers
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=100)
    tcfg = TrainStepConfig(remat_policy="none", optimizer=opt)
    t0 = time.perf_counter()
    state = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), tcfg,
        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state.model
    step = make_train_step(model, tcfg)
    rng = np.random.default_rng(0)
    seq = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        dtype=torch.long, device="cuda")
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def counts():
        return {"ssd_scan": ss.ssd_scan.launches,
                "rmsnorm": rn.rmsnorm.launches}

    def zero():
        ss.ssd_scan.launches = rn.rmsnorm.launches = 0
        fa.flash_attention.launches = 0

    t0 = time.perf_counter()
    state, m = step(state, batch)                      # warm-up, step 1
    losses = [float(m["loss"])]
    grad_norms = [float(m["grad_norm"])]
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    launches = counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    expect = {"ssd_scan": L * TRAIN_STEPS,
              "rmsnorm": (2 * L + 1) * TRAIN_STEPS}
    ln_v = float(np.log(cfg.vocab_size))
    emit("train", arch=cfg.name, params=cfg.param_count(),
         batch=[TRAIN_BATCH, TRAIN_SEQ], remat_policy=tcfg.remat_policy,
         init_s=init_s, warmup_step_s=warm_s, step_s=step_s,
         tokens_per_s=tokens / (sum(step_s) / len(step_s)),
         losses=losses, grad_norms=grad_norms, ln_vocab=ln_v,
         peak_mem_bytes=peak_bytes, launches=launches,
         expected_launches=expect,
         flash_attention_launches=fa.flash_attention.launches)
    check(all(np.isfinite(losses)) and all(np.isfinite(grad_norms)),
          f"non-finite loss or gradient norm: {losses} {grad_norms}")
    check(abs(losses[0] - ln_v) <= 0.1 * ln_v,
          f"first loss {losses[0]} not within 10% of ln V = {ln_v}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == expect,
          f"train launches {launches}, the path implies {expect}")
    check(fa.flash_attention.launches == 0, "mamba2 launched attention")

    prof = profile_phase(
        torch, "train step 4x2048", lambda: step(state, batch),
        expect=("ssd_scan_chunk_state_kernel",
                "ssd_scan_state_passing_kernel",
                "ssd_scan_chunk_scan_kernel"))
    emit("profile", **prof)

    # remat "full": the same loss as a plain forward on these parameters,
    # and each layer's forward launched again in the backward
    with torch.no_grad():
        fwd_loss = float(model.loss(batch, remat_policy="none")[0])
    full_step = make_train_step(
        model, TrainStepConfig(remat_policy="full", optimizer=opt))
    torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = time.perf_counter()
    state, m = full_step(state, batch)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_launches = counts()
    full_expect = {"ssd_scan": 2 * L, "rmsnorm": (2 * L + 1) + 2 * L}
    full_loss = float(m["loss"])
    emit("train_remat", remat_policy="full", loss=full_loss,
         forward_loss=fwd_loss, step_s=full_s,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=full_launches, expected_launches=full_expect)
    check(abs(full_loss - fwd_loss) <= 1e-5 * abs(fwd_loss),
          f"remat full loss {full_loss} != forward loss {fwd_loss}")
    check(full_launches == full_expect,
          f"remat launches {full_launches}, expected {full_expect}")

    # ---- 7. one loss and gradient through the plain twins ------------------
    from repro_torch.models import layers as ll
    params = state.params

    def loss_and_grads():
        for p in params.values():
            p.grad = None
        loss, _ = model.loss(batch, remat_policy="full")
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return float(loss.detach()), grads

    def cosine(a, b):
        return float(F.cosine_similarity(a.flatten(), b.flatten(), dim=0,
                                         eps=1e-30))

    saved_dtype = ll.COMPUTE_DTYPE
    for dtype in (torch.bfloat16, torch.float32):
        ll.COMPUTE_DTYPE = dtype        # the masters are cast at each use
        try:
            k_loss, k_grads = loss_and_grads()
            before = counts()
            with plain_kernels(ops, fa, rn, ss):
                p_loss, p_grads = loss_and_grads()
        finally:
            ll.COMPUTE_DTYPE = saved_dtype
        check(counts() == before, "the plain run launched a kernel")
        cosines = {k: cosine(k_grads[k], p_grads[k]) for k in k_grads}
        del k_grads, p_grads
        cos_min = min(cosines.values())
        cos_mean = sum(cosines.values()) / len(cosines)
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        every_leaf = dtype == torch.float32
        emit("train_plain", compute_dtype=str(dtype).removeprefix("torch."),
             kernel_loss=k_loss, plain_loss=p_loss, loss_rel=loss_rel,
             leaves=len(cosines), grad_cosine_min=cos_min,
             grad_cosine_mean=cos_mean,
             worst_leaves=[dict(leaf=k, cosine=cosines[k]) for k in
                           sorted(cosines, key=cosines.get)[:5]],
             max_loss_rel=MAX_LOSS_REL, min_grad_cosine=MIN_GRAD_COSINE,
             cosine_held="every leaf" if every_leaf else "mean")
        check(loss_rel <= MAX_LOSS_REL,
              f"{dtype} loss rel {loss_rel} > {MAX_LOSS_REL}")
        if every_leaf:
            bad = [k for k in cosines if cosines[k] < MIN_GRAD_COSINE]
            check(not bad, f"{dtype} gradient cosine below "
                  f"{MIN_GRAD_COSINE} for {bad[:5]}")
        else:
            check(cos_mean >= MIN_GRAD_COSINE, f"{dtype} mean gradient "
                  f"cosine {cos_mean} < {MIN_GRAD_COSINE}")
    return launches, state, step, prof["idle_share"]


def edge_dataset(tdata, latency_s: float, bandwidth: float, raw):
    """``raw`` behind a ``LatencyStorage`` (the storage the loader reads)."""
    return raw.with_storage(tdata.LatencyStorage(
        raw.storage, latency_s=latency_s, bandwidth=bandwidth))


def copy_rate(torch, nbytes: int, *, pinned: bool) -> float:
    """Bytes per second of 20 back-to-back ``non_blocking`` host-to-device
    copies of one ``nbytes`` buffer on a stream of their own, between CUDA
    events: the edge's bound (pinned) or a pageable copy's rate."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
    host.fill_(1)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.Stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        dev.copy_(host, non_blocking=True)          # warm-up
        start.record()
        for _ in range(EDGE_COPIES):
            dev.copy_(host, non_blocking=True)
        end.record()
    end.synchronize()
    return EDGE_COPIES * nbytes / (start.elapsed_time(end) / 1e3)


def device_edge_path(torch, np, tdata) -> dict:
    """Phase 9: stream ImageNet-crop batches through the CUDA edge, pageable
    and through the pinned staging ring, and hold every delivered tensor
    against the host batch of the same indices, byte for byte.  Returns
    what the dpt phase reuses."""
    t0 = time.perf_counter()
    raw = tdata.synthetic_image_dataset(EDGE_ITEMS, EDGE_RES, seed=0)
    dataset = edge_dataset(tdata, 2e-3, 400e6, raw)
    probe = tdata.DataLoader(dataset, EDGE_BATCH, seed=0, device="cuda")
    per_epoch = probe.sampler.batches_per_epoch(0)
    expect = [raw.get_batch(probe.sampler.local_indices(*divmod(k, per_epoch)))
              for k in range(EDGE_STEPS)]
    setup_s = time.perf_counter() - t0
    batch_bytes = sum(v.nbytes for v in expect[0].values())
    rate = copy_rate(torch, batch_bytes, pinned=True)
    pageable_rate = copy_rate(torch, batch_bytes, pinned=False)
    runs = []
    for zero_copy in (False, True):
        params = tdata.LoaderParams(num_workers=4, device_prefetch=2,
                                    ordered=True, zero_copy=zero_copy)
        loader = tdata.DataLoader(dataset, EDGE_BATCH, params=params,
                                  seed=0, device="cuda")
        stream = loader.stream(to_device=True)
        kept = []
        t0 = time.perf_counter()
        try:
            for _ in range(EDGE_STEPS):
                kept.append(next(stream))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            stream.close()
        pf = stream._prefetcher
        staging = pf._staging
        mismatched = [
            k for k, (got, want) in enumerate(zip(kept, expect))
            if got.keys() != want.keys() or any(
                got[f].device.type != "cuda"
                or got[f].cpu().numpy().tobytes() != want[f].tobytes()
                for f in want)]
        run = dict(zero_copy=zero_copy, batches=len(kept), wall_s=wall,
                   delivered_gbps=len(kept) * batch_bytes / wall / 1e9,
                   staging_hit_rate=pf.staging_hit_rate,
                   retired=staging.retired if staging is not None else 0,
                   mismatched_batches=mismatched)
        runs.append(run)
        del kept
        check(not mismatched, f"device edge zero_copy={zero_copy}: "
              f"batches {mismatched} differ from the host batches")
        check(run["retired"] == 0, f"staging retired {run['retired']}")
    check(runs[1]["staging_hit_rate"] is not None
          and runs[1]["staging_hit_rate"] > 0,
          f"the pinned staging ring was never reused: {runs[1]}")
    emit("device_edge", items=EDGE_ITEMS, resolution=EDGE_RES,
         global_batch=EDGE_BATCH, batch_bytes=batch_bytes,
         dataset_setup_s=setup_s, runs=runs,
         pinned_copy_gbps=rate / 1e9, pageable_copy_gbps=pageable_rate / 1e9,
         copies_timed=EDGE_COPIES)
    return dict(dataset=dataset, batch_bytes=batch_bytes, rate=rate,
                expect=expect)


class Recorded:
    """An evaluator that keeps every ``TransferStats`` it returns."""

    def __init__(self, evaluator):
        self.evaluator = evaluator
        self.stats = []

    def __call__(self, nworker, nprefetch, **kw):
        stats = self.evaluator(nworker, nprefetch, **kw)
        self.stats.append(((nworker, nprefetch), stats))
        return stats


def dpt_path(torch, tdata, core, edge) -> None:
    """Phase 10: DPT's Algorithm 1 over the real loader and the CUDA edge."""
    loader = tdata.DataLoader(edge["dataset"], EDGE_BATCH, seed=0,
                              device="cuda")
    ev = Recorded(core.LoaderEvaluator(loader, to_device=True))
    cfg = core.DPTConfig(num_cpu_cores=min(8, os.cpu_count() or 1),
                         num_devices=None, max_prefetch=4,
                         num_batches=EDGE_STEPS)
    t0 = time.perf_counter()
    result = core.DPT(ev, cfg).run()
    wall = time.perf_counter() - t0
    n_cores, g = cfg.resolve()
    trials = [dict(nworker=cell[0], nprefetch=cell[1], seconds=s.seconds,
                   bytes=s.bytes, bytes_per_second=s.bytes_per_second,
                   peak_loader_bytes=s.peak_loader_bytes,
                   least_seconds=s.bytes / edge["rate"])
              for cell, s in ev.stats]
    emit("dpt", cores=n_cores, devices=g, max_prefetch=cfg.max_prefetch,
         num_batches=cfg.num_batches, trials=trials,
         pick=[result.nworker, result.nprefetch],
         default=list(core.default_params(n_cores)),
         default_time=result.default_time,
         optimal_time=result.optimal_time,
         speedup_vs_default=result.speedup_vs_default, wall_s=wall,
         pinned_copy_gbps=edge["rate"] / 1e9)
    check(g == torch.cuda.device_count(), f"DPT read G = {g} devices")
    short = [t for t in trials if math.isfinite(t["seconds"])
             and t["seconds"] < 0.9 * t["least_seconds"]]
    check(not short, f"trial windows shorter than their copies: {short}")
    first = [t["seconds"] for t in trials
             if (t["nworker"], t["nprefetch"]) == (g, 1)]
    check(first and result.optimal_time < first[0],
          f"pick {result.optimal_time} s not below the ({g}, 1) cell "
          f"{first}")


def train_stream_path(torch, np, tdata, core, modules, state, step,
                      synthetic_idle: float) -> dict:
    """Phase 11: a DPT-tuned token stream through the CUDA edge into the
    full-width train step.  Returns the launches of the streamed steps."""
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    cfg = state.model.cfg
    L = cfg.num_layers
    raw = tdata.token_dataset(64, TRAIN_SEQ, cfg.vocab_size, seed=0)
    loader = tdata.DataLoader(edge_dataset(tdata, 1e-3, 1e9, raw),
                              TRAIN_BATCH, seed=0, device="cuda")
    t0 = time.perf_counter()
    result = core.DPT(core.LoaderEvaluator(loader, to_device=True),
                      core.DPTConfig(num_cpu_cores=min(4, os.cpu_count() or 1),
                                     num_devices=None, max_prefetch=2,
                                     num_batches=4)).run()
    tune_s = time.perf_counter() - t0
    loader.with_params(loader.params.replace(
        num_workers=result.nworker, prefetch_factor=result.nprefetch))
    s0 = loader.sampler.state
    first_expect = raw.get_batch(loader.sampler.local_indices(
        s0.epoch, s0.batch_offset))
    stream = loader.stream(to_device=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    try:
        batch = next(stream)
        check(batch["tokens"].dtype == torch.int32
              and batch["tokens"].device.type == "cuda",
              f"streamed tokens {batch['tokens'].dtype} on "
              f"{batch['tokens'].device}")
        same = batch.keys() == first_expect.keys() and all(
            batch[k].cpu().numpy().tobytes() == first_expect[k].tobytes()
            for k in first_expect)
        check(same, "the first streamed batch differs from the host batch")
        ss.ssd_scan.launches = rn.rmsnorm.launches = 0
        fa.flash_attention.launches = 0
        losses, step_s = [], []
        for i in range(TRAIN_STEPS):
            if i:
                batch = next(stream)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        launches = {"ssd_scan": ss.ssd_scan.launches,
                    "rmsnorm": rn.rmsnorm.launches}
        flash = fa.flash_attention.launches
        expect = {"ssd_scan": L * TRAIN_STEPS,
                  "rmsnorm": (2 * L + 1) * TRAIN_STEPS}
        prof = profile_phase(torch, "streamed train step 4x2048",
                             lambda: step(state, next(stream)),
                             expect=("ssd_scan_chunk_scan_kernel",))
    finally:
        stream.close()
    emit("profile", **prof)
    emit("train_stream", arch=cfg.name, batch=[TRAIN_BATCH, TRAIN_SEQ],
         items=64, tune_s=tune_s, pick=[result.nworker, result.nprefetch],
         speedup_vs_default=result.speedup_vs_default,
         tokens_dtype=str(batch["tokens"].dtype), step_s=step_s,
         tokens_per_s=tokens / (sum(step_s) / len(step_s)),
         losses=losses, launches=launches, expected_launches=expect,
         flash_attention_launches=flash, idle_share=prof["idle_share"],
         synthetic_batch_idle_share=synthetic_idle)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"streamed loss did not fall: {losses}")
    check(launches == expect,
          f"streamed launches {launches}, the path implies {expect}")
    check(flash == 0, "mamba2 launched attention")
    return launches


def hot_swap_path(torch, np, tdata, edge) -> dict:
    """Phase 12: the OnlineTuner's act step on the live CUDA edge.  A
    stream of ImageNet-crop batches starts at (2 workers, prefetch 2); after
    batch 5 ``apply_params`` swaps in (4, 3).  Every delivered tensor must
    equal the host batch of the sampler's indices for its position, byte
    for byte; the indices of the 16 positions cover one epoch exactly once;
    the stream's pools have the old and then the new params."""
    expect = edge["expect"]
    old = tdata.LoaderParams(num_workers=2, prefetch_factor=2)
    new = old.replace(num_workers=4, prefetch_factor=3)
    loader = tdata.DataLoader(edge["dataset"], EDGE_BATCH, params=old,
                              seed=0, device="cuda")
    per_epoch = loader.sampler.batches_per_epoch(0)
    indices = np.concatenate([loader.sampler.local_indices(
        *divmod(k, per_epoch)) for k in range(EDGE_STEPS)])
    # record the (workers, prefetch) of every pool the stream builds
    pools, make_pool = [], loader._pool

    def recorded_pool(*args, **kw):
        pool, monitor = make_pool(*args, **kw)
        pools.append([pool.num_workers, pool.prefetch_factor])
        return pool, monitor

    loader._pool = recorded_pool
    stream = loader.stream(to_device=True)
    kept = []
    t0 = time.perf_counter()
    try:
        for k in range(EDGE_STEPS):
            kept.append(next(stream))
            if k == HOT_SWAP_AFTER - 1:
                loader.apply_params(new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stream.close()
    mismatched = [
        k for k, (got, want) in enumerate(zip(kept, expect))
        if got.keys() != want.keys() or any(
            got[f].device.type != "cuda"
            or got[f].cpu().numpy().tobytes() != want[f].tobytes()
            for f in want)]
    del kept
    n_items = len(edge["dataset"])
    emit("hot_swap", batches=EDGE_STEPS, swap_after=HOT_SWAP_AFTER,
         old=[old.num_workers, old.prefetch_factor],
         new=[new.num_workers, new.prefetch_factor], pools=pools,
         swaps=stream.swaps, wall_s=wall, mismatched_batches=mismatched,
         indices=int(indices.size), distinct_indices=int(
             np.unique(indices).size), dataset_items=n_items)
    check(not mismatched, f"hot swap: batches {mismatched} differ from "
          "the host batches of their positions")
    check(sorted(indices.tolist()) == list(range(n_items)),
          "hot swap: the 16 positions do not cover the epoch exactly once")
    check(stream.swaps == 1, f"hot swap: {stream.swaps} swaps, expected 1")
    check(pools == [[2, 2], [4, 3]], f"hot swap: pools {pools}")
    check(loader.params == new, f"hot swap: params {loader.params}")
    return dict(wall_s=wall)


def drift_retune_path(torch, np, tdata) -> dict:
    """Phase 13: the OnlineTuner's decide step on the CUDA edge, through the
    flow of ``examples/torch_online_tuning.py``: a stream of 16 x 16 x 3
    images starts at (2 workers, prefetch 1), each batch is consumed on the
    card by a step cheaper than a batch (a reduction and a 20 ms sleep), the
    storage degrades at step 40 (latency x40, bandwidth /4), and the tuner
    must search, apply a win and complete its hot swap, and no search may
    start before the degradation.  Every delivered tensor must equal the
    host batch of its position byte for byte, and the positions' indices
    hold no item twice within an epoch.  Then the degraded steady state
    without the tuner, at the start's params and at the pick's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_online_tuning", ROOT / "examples" / "torch_online_tuning.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)

    kept = {}

    def record(k, batch):
        check(all(v.device.type == "cuda" for v in batch.values()),
              f"drift retune: batch {k} not on the card")
        kept[k] = {f: v.cpu().numpy() for f, v in batch.items()}

    t0 = time.perf_counter()
    summary = ex.run(device="cuda", steps=DRIFT_STEPS, drift_at=DRIFT_AT,
                     items=DRIFT_ITEMS, on_batch=record, verbose=False)
    wall = time.perf_counter() - t0

    def degraded_step_ms(params) -> float:
        """Mean step ms of the example's step on the degraded storage at
        fixed ``params`` (workers, prefetch), no tuner: DRIFT_STEADY steps
        after DRIFT_STEADY_WARMUP."""
        ds_, storage_ = ex.make_dataset(DRIFT_ITEMS)
        ex.degrade(storage_)
        dl = tdata.DataLoader(ds_, ex.BATCH, params=tdata.LoaderParams(
            num_workers=params[0], prefetch_factor=params[1]), seed=0,
            device="cuda")
        stream = dl.stream(to_device=True)
        try:
            for k in range(DRIFT_STEADY_WARMUP + DRIFT_STEADY):
                if k == DRIFT_STEADY_WARMUP:
                    t0_ = time.perf_counter()
                ex.consume(next(stream))
            return 1e3 * (time.perf_counter() - t0_) / DRIFT_STEADY
        finally:
            stream.close()

    # the degraded steady state with and without the retune's pick
    steady = {"start": list(ex.START),
              "start_step_ms": degraded_step_ms(ex.START),
              "pick": summary["params_after"],
              "pick_step_ms": degraded_step_ms(summary["params_after"])}
    ds, storage = ex.make_dataset(DRIFT_ITEMS)
    raw = ds.with_storage(storage.inner)
    probe = tdata.DataLoader(raw, ex.BATCH, seed=0, device="cuda")
    per_epoch = probe.sampler.batches_per_epoch(0)
    positions = [divmod(k, per_epoch) for k in range(DRIFT_STEPS)]
    mismatched = []
    for k, (epoch, off) in enumerate(positions):
        want = raw.get_batch(probe.sampler.local_indices(epoch, off))
        got = kept.get(k)
        if got is None or got.keys() != want.keys() or any(
                got[f].tobytes() != want[f].tobytes() for f in want):
            mismatched.append(k)
    repeats = 0
    for e in sorted({ep for ep, _ in positions}):
        idx = np.concatenate([probe.sampler.local_indices(ep, off)
                              for ep, off in positions if ep == e])
        repeats += int(idx.size - np.unique(idx).size)
    emit("drift_retune", **summary, wall_s=wall, items=DRIFT_ITEMS,
         batches_delivered=len(kept), mismatched_batches=mismatched,
         repeated_indices_within_epoch=repeats,
         degraded_steady_no_tuner=steady)
    early = [ev["step"] for ev in summary["searches"]
             if ev["step"] < DRIFT_AT]
    check(not early, f"drift retune: searches at steps {early}, before the "
          f"storage degraded at step {DRIFT_AT}")
    check(summary["retunes"] >= 1, "drift retune: the tuner never retuned")
    check(steady["pick_step_ms"] < steady["start_step_ms"],
          f"drift retune: the pick's degraded step {steady['pick_step_ms']}"
          f" ms is no faster than the start's {steady['start_step_ms']} ms")
    check(summary["swaps"] >= 1, "drift retune: no hot swap completed")
    check(not mismatched, f"drift retune: batches {mismatched[:8]} differ "
          "from the host batches of their positions")
    check(repeats == 0, f"drift retune: {repeats} indices repeated")
    return summary


def trainer_path(torch, np, tdata, modules) -> dict:
    """Phase 14: the Trainer at full width, full depth: startup DPT tune,
    the DPT cache, the OnlineTuner and checkpoint/restart in ``repro``'s
    on-disk layout.  Three runs: A straight (4 steps), B1 (2 steps, a
    blocking checkpoint at step 2), B2 (resumes B1's checkpoint; an async
    checkpoint at step 3 written during step 4's compute, a blocking one at
    step 4).  Returns the launches of the eight steps."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))

    cfg = get_config(TRAIN_ARCH)
    raw = tdata.token_dataset(64, TRAIN_SEQ, cfg.vocab_size, seed=0)
    dataset = edge_dataset(tdata, 1e-3, 1e9, raw)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the masters and both AdamW moments, fp32
    ckpt_bytes = 3 * 4 * cfg.param_count()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")

    def make(steps, checkpoint_dir=None):
        tc = TrainerConfig(
            total_steps=steps, log_every=1, checkpoint_every=3,
            checkpoint_dir=checkpoint_dir, seed=0, autotune=True,
            autotune_strategy="grid", autotune_budget_batches=4,
            autotune_max_prefetch=2,
            autotune_num_cpu_cores=min(4, os.cpu_count() or 1),
            dpt_cache_path=os.path.join(workdir, "dpt.json"),
            step_config=TrainStepConfig(
                remat_policy="none",
                optimizer=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                      total_steps=100)))
        loader = tdata.DataLoader(dataset, TRAIN_BATCH, seed=0,
                                  device="cuda")
        return Trainer(cfg, loader, tc, device="cuda")

    def summary(tr):
        steps = [r for r in tr.history if "loss" in r]
        ot = tr.online_tuner
        return dict(pick=[tr.loader.params.num_workers,
                          tr.loader.params.prefetch_factor],
                    tune_s=tr.tune_s, tune_trials=tr.tune_trials,
                    start_step=tr.start_step,
                    losses=[r["loss"] for r in steps],
                    step_s=[r["step_s"] for r in steps],
                    data_s=[r["data_s"] for r in steps],
                    tokens_per_s=[tokens / r["step_s"] for r in steps],
                    stall_ratio=ot.stall_ratio, retunes=ot.retunes,
                    retune_history=ot.history,
                    straggler_medians=tr.straggler.medians())

    ss.ssd_scan.launches = rn.rmsnorm.launches = 0
    fa.flash_attention.launches = 0
    try:
        # ---- A: straight, no checkpoint; DPT runs and fills the cache ----
        tr = make(TRAINER_STEPS)
        tr.run()
        a = summary(tr)
        a_params = {k: p.detach().cpu() for k, p in tr.state.params.items()}
        del tr
        torch.cuda.empty_cache()

        # ---- B1: two steps, a blocking checkpoint at step 2 ---------------
        ckdir = os.path.join(workdir, "ckpt")
        free = shutil.disk_usage(workdir).free
        if free < 3 * ckpt_bytes:
            raise RuntimeError(
                f"chip_smoke: {free / 1e9:.2f} GB free under {workdir}, the "
                f"trainer phase keeps three checkpoints of "
                f"{ckpt_bytes / 1e9:.2f} GB ({3 * ckpt_bytes / 1e9:.2f} GB)")
        b1 = make(TRAINER_STEPS // 2, ckdir)
        b1.run()
        b1_sum = summary(b1)
        on_disk = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(ckdir) for f in fs)

        # ---- B2: resume B1's checkpoint; compare before training ----------
        b2 = make(TRAINER_STEPS, ckdir)
        held = [b1.state]                # only this reference remains
        b1.state = b1.step_fn = None
        restored = {}
        restore = b2._maybe_restore

        def compare(live, got):
            pairs = [("params", live.params, got.params),
                     ("mu", live.opt.mu, got.opt.mu),
                     ("nu", live.opt.nu, got.opt.nu)]
            unequal = [f"{kind}:{k}" for kind, x, y in pairs for k in x
                       if not torch.equal(x[k], y[k])]
            return dict(leaves=sum(len(x) for _, x, _ in pairs) + 1,
                        unequal=unequal[:5], n_unequal=len(unequal),
                        step=[live.opt.step, got.opt.step])

        def restore_and_compare():
            restore()
            restored.update(compare(held[0], b2.state),
                            restore_s=b2.checkpointer.restore_s)
            held.clear()                 # B1's state leaves the card
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        b2._maybe_restore = restore_and_compare
        b2.run()
        b2_sum = summary(b2)
        peak = torch.cuda.max_memory_allocated()
        saves = b1.checkpointer.saves + b2.checkpointer.saves
        param_diff = max(
            float((p.detach() - a_params[k].to(p.device)).abs().max())
            for k, p in b2.state.params.items())
        del b1, b2, a_params
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {"ssd_scan": ss.ssd_scan.launches,
                "rmsnorm": rn.rmsnorm.launches}
    flash = fa.flash_attention.launches
    L = cfg.num_layers
    n_steps = 2 * TRAINER_STEPS           # A, then B1 and B2 between them
    expect = {"ssd_scan": L * n_steps, "rmsnorm": (2 * L + 1) * n_steps}
    loss_diff = [abs(x - y) for x, y in
                 zip(a["losses"][TRAINER_STEPS // 2:], b2_sum["losses"])]
    emit("trainer", arch=cfg.name, batch=[TRAIN_BATCH, TRAIN_SEQ],
         items=64, remat_policy="none",
         a=a, b1=b1_sum, b2=b2_sum,
         tune_s=a["tune_s"], cache_hit_tune_s=[b1_sum["tune_s"],
                                               b2_sum["tune_s"]],
         b2_step_with_async_save_s=b2_sum["step_s"][-1],
         checkpoint_gb=ckpt_bytes / 1e9, checkpoint_bytes_on_disk=on_disk,
         free_disk_gb_before_saves=free / 1e9,
         saves=[dict(r, snapshot_gbps=ckpt_bytes / r["snapshot_s"] / 1e9,
                     write_gbps=ckpt_bytes / r["write_s"] / 1e9)
                for r in saves], restore=restored,
         restore_gbps=ckpt_bytes / restored["restore_s"] / 1e9,
         loss_diff_a_b2=loss_diff, max_loss_diff=TRAINER_LOSS_ATOL,
         max_param_diff_a_b2=param_diff, peak_mem_bytes=peak,
         launches=launches, expected_launches=expect,
         flash_attention_launches=flash)
    check(a["tune_trials"] > 0, f"A did not run DPT: {a['tune_trials']}")
    for name, run in (("B1", b1_sum), ("B2", b2_sum)):
        check(run["tune_trials"] == 0 and run["pick"] == a["pick"],
              f"{name} did not tune from the cache: {run['tune_trials']} "
              f"trials, pick {run['pick']} against A's {a['pick']}")
    check(b2_sum["start_step"] == TRAINER_STEPS // 2,
          f"B2 resumed at {b2_sum['start_step']}")
    check(restored["n_unequal"] == 0
          and restored["step"] == [TRAINER_STEPS // 2] * 2,
          f"restored state differs from B1's: {restored}")
    check(all(np.isfinite(a["losses"] + b1_sum["losses"] + b2_sum["losses"])),
          "non-finite loss")
    check(len(b2_sum["losses"]) == TRAINER_STEPS // 2
          and max(loss_diff) <= TRAINER_LOSS_ATOL,
          f"B2's losses {b2_sum['losses']} against A's {a['losses']}")
    check(launches == expect,
          f"trainer launches {launches}, the path implies {expect}")
    check(flash == 0, "mamba2 launched attention")
    check(math.isfinite(param_diff), f"A - B2 params: {param_diff}")
    check([r["step"] for r in saves] == [TRAINER_STEPS // 2, 3,
                                         TRAINER_STEPS],
          f"checkpoints saved at steps {[r['step'] for r in saves]}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["REPRO_COMPUTE_DTYPE"] = "bfloat16"
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    modules = dict(ops=ops, fa=fa, rn=rn, ss=ss)

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         allow_tf32=False)

    # ---- 2. build: nvcc in the background while Triton compiles ------------
    cuda_sources = ("flash_attention", "ssd_scan")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        nvcc_job = pool.submit(_build.build, *cuda_sources)
        x = torch.randn((8, 896), device="cuda", dtype=torch.bfloat16)
        rn.rmsnorm(x, torch.ones(896, device="cuda"))
        rn.rmsnorm_residual(x, x, torch.ones(896, device="cuda"))
        torch.cuda.synchronize()
        triton_s = time.perf_counter() - t0
        libs = nvcc_job.result()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(lib.with_suffix(".log").read_text())
             for name, lib in libs.items()}
    emit("build", seconds=build_s, triton_s=triton_s,
         libraries={k: v.name for k, v in libs.items()}, ptxas=ptxas,
         dynamic_smem_bytes=dynamic_smem(_build))

    # ---- 3. kernels against their plain twins ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {"flash_attention": [], "rmsnorm": [], "rmsnorm_residual": [],
              "ssd_scan": []}
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "slice",
                                             8, 512, 512, 14, 2, 64)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "window48",
                                             8, 512, 512, 14, 2, 64,
                                             window=48)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "ragged300",
                                             4, 300, 300, 14, 2, 64)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "q_offset",
                                             8, 64, 512, 14, 2, 64,
                                             q_offset=448)
    # the tensor-core kernel's split KV loop: queries off the tile grid,
    # a window whose lower edge cuts tiles, and (ragged300 above) S not a
    # multiple of the query block
    checks["flash_attention"] += check_flash(torch, F, fa, gen,
                                             "q_offset_off_grid",
                                             8, 63, 512, 14, 2, 64,
                                             q_offset=449)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "window100",
                                             8, 512, 512, 14, 2, 64,
                                             window=100)
    # the other head dims the kernel takes: qwen3's 128, the non-causal
    # tiles of 16, and 24, which bf16 runs on the scalar kernel, as it does
    # K/V rows that are not 16-byte aligned
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "d128",
                                             2, 256, 256, 16, 8, 128)
    # phi-3-vision's head dim, 6 x 16 on the tensor-core kernel (32 heads,
    # no grouping)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "d96",
                                             2, 512, 512, 32, 32, 96)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "d16_full",
                                             2, 48, 80, 6, 2, 16,
                                             causal=False)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "d24",
                                             2, 100, 100, 4, 2, 24,
                                             window=20)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "strided",
                                             2, 128, 128, 14, 2, 64,
                                             strided=True)
    # the MoE paths' prefills: granite's 8 x 512 (24 / 8 heads of 64) and
    # mixtral's two prompts of 4,608 under its 4,096 window at head dim 128
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "granite",
                                             8, 512, 512, 24, 8, 64)
    checks["flash_attention"] += check_flash(torch, F, fa, gen,
                                             "mixtral_window", RING_BATCH,
                                             RING_PROMPT, RING_PROMPT, 48, 8,
                                             128, window=4096)
    for name, rows_ in (("prefill", 8 * 512), ("prefill300", 4 * 300),
                        ("decode", 8)):
        checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen, name, rows_, 896)
    # mixtral's norms on the ring path (d_model 6144, its own BLOCK_D):
    # prefill of two 4,608-token prompts and a decode step
    checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen, "mixtral_d6144",
                                       RING_BATCH * RING_PROMPT, 6144)
    checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen,
                                       "mixtral_decode", RING_BATCH, 6144)
    # the train path's norms: ln1 / final norm and the gate norm
    checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen, "train_d1536",
                                       TRAIN_BATCH * TRAIN_SEQ, 1536)
    checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen, "train_d3072",
                                       TRAIN_BATCH * TRAIN_SEQ, 3072)
    checks["rmsnorm_residual"] += check_rmsnorm_residual(
        torch, rn, gen, "slice", TRAIN_BATCH * TRAIN_SEQ, 1536)

    def plain_ctx():
        return plain_kernels(ops, fa, rn, ss)

    # the slice shape, as strided views of one conv output like the model's;
    # the shapes of tests/test_kernels.py (g > 1, g = h, chunk 24); and a
    # sequence that ops.ssd pads
    for name, shape, kw in (
            ("slice", (TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128, 256),
             dict(strided=True)),
            ("t1", (1, 32, 2, 8, 1, 4, 8), {}),
            ("t2_groups", (2, 64, 4, 16, 2, 8, 16), {}),
            ("t3_g_eq_h", (2, 64, 4, 16, 4, 8, 32), {}),
            ("t4_chunk24", (1, 96, 6, 8, 2, 16, 24), {}),
            ("padded300", (2, 300, 48, 64, 1, 128, 256), {}),
            # rows that are not whole 16-byte chunks (p = 12, n = 10): the
            # bf16 kernels' element-by-element loads and stores
            ("unaligned", (1, 64, 3, 12, 1, 10, 32), {})):
        checks["ssd_scan"] += check_ssd(torch, ops, ss, plain_ctx, gen, name,
                                        *shape, **kw)
    # prefill's scan with its final state: the serving batch of 8 x 512 and
    # the 4 prompts of 300 that ops.ssd_prefill pads to 512, as strided
    # views of one conv output like the model's
    for name, shape in (("serve_prefill", (8, 512, 48, 64, 1, 128, 256)),
                        ("serve_prefill300", (4, 300, 48, 64, 1, 128, 256))):
        checks["ssd_scan"] += check_ssd_state(torch, ops, plain_ctx, gen,
                                              name, *shape)
    stage_rows = []
    for name, shape, kw in (
            ("slice", (TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128, 256),
             dict(strided=True)),
            ("t4_chunk24", (1, 96, 6, 8, 2, 16, 24), {})):
        stage_rows += check_ssd_stages(torch, ss, ref, gen, name, *shape,
                                       **kw)

    # ---- 4-6c. the serving paths at full width -----------------------------
    serve_launches = serve_path(torch, np, F, modules, ARCH)
    torch.cuda.empty_cache()
    serve_ssm_launches = serve_path(torch, np, F, modules, SSM_ARCH)
    torch.cuda.empty_cache()
    serve_moe_launches = serve_path(torch, np, F, modules, MOE_ARCH)
    torch.cuda.empty_cache()
    serve_ring_launches = ring_path(torch, np, F, modules)
    torch.cuda.empty_cache()

    # ---- 7-8. the training path at full width ------------------------------
    train_launches, state, step, train_idle = train_path(torch, np, F,
                                                         modules)

    # ---- 9-11. the data plane: device edge, DPT, a tuned stream -----------
    import repro_torch.core as core
    import repro_torch.data as tdata
    edge = device_edge_path(torch, np, tdata)
    dpt_path(torch, tdata, core, edge)
    stream_launches = train_stream_path(torch, np, tdata, core, modules,
                                        state, step, train_idle)
    del state, step                # room for two 780M states in phase 14
    torch.cuda.empty_cache()

    # ---- 12-14. a hot swap and a drift retune on the live edge; the Trainer
    hot_swap_path(torch, np, tdata, edge)
    del edge
    drift_retune_path(torch, np, tdata)
    trainer_launches = trainer_path(torch, np, tdata, modules)

    # ---- 15. the kernels line ---------------------------------------------
    by_path = {
        "flash_attention": {"serve": serve_launches["flash_attention"],
                            "serve_moe": serve_moe_launches["flash_attention"],
                            "serve_ring":
                                serve_ring_launches["flash_attention"]},
        "rmsnorm": {"serve": serve_launches["rmsnorm"],
                    "serve_ssm": serve_ssm_launches["rmsnorm"],
                    "serve_moe": serve_moe_launches["rmsnorm"],
                    "serve_ring": serve_ring_launches["rmsnorm"],
                    "train": train_launches["rmsnorm"],
                    "train_stream": stream_launches["rmsnorm"],
                    "trainer": trainer_launches["rmsnorm"]},
        "rmsnorm_residual": {},      # no model calls it
        "ssd_scan": {"serve_ssm": serve_ssm_launches["ssd_scan"],
                     "train": train_launches["ssd_scan"],
                     "train_stream": stream_launches["ssd_scan"],
                     "trainer": trainer_launches["ssd_scan"]},
    }
    main_case = {"flash_attention": "slice", "rmsnorm": "prefill",
                 "rmsnorm_residual": "slice", "ssd_scan": "slice"}
    meta = {
        "flash_attention": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:106"),
        "rmsnorm": dict(
            route="triton", source="src/repro_torch/kernels/rmsnorm.py",
            replaces="src/repro/kernels/rmsnorm.py:44"),
        "rmsnorm_residual": dict(
            route="triton", source="src/repro_torch/kernels/rmsnorm.py",
            replaces="src/repro/kernels/rmsnorm.py:83"),
        "ssd_scan": dict(
            route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:77"),
    }
    kernels = []
    for name, rows_ in checks.items():
        row = next(r for r in rows_ if r["case"] == main_case[name]
                   and r["dtype"] == "bfloat16")
        kernels.append(dict(
            name=name, **meta[name], launches=sum(by_path[name].values()),
            launches_by_path=by_path[name],
            max_abs_err=max(r["max_abs_err"] for r in rows_
                            if r["dtype"] == "bfloat16"),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    # the SSD scan's three stage kernels, each timed alone (the slice
    # shape); the scan with its final state at the serving prefill shape
    by_name = {k["name"]: k for k in kernels}
    by_name["ssd_scan"]["stages_ms"] = {r["stage"]: r["kernel_ms"]
                                        for r in stage_rows
                                        if r["case"] == "slice"}
    state_row = next(r for r in checks["ssd_scan"]
                     if r["case"] == "serve_prefill"
                     and r["dtype"] == "bfloat16")
    by_name["ssd_scan"]["serve_prefill_state_ms"] = state_row["kernel_ms"]
    by_name["ssd_scan"]["serve_prefill_y_only_ms"] = state_row["y_only_ms"]
    # flash at phi-3-vision's head dim and at the MoE paths' prefills
    by_name["flash_attention"]["cases"] = {
        r["case"]: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], library_ms=r["library_ms"],
                        library_backend=r["library_backend"])
        for r in checks["flash_attention"]
        if r["case"] in ("d96", "granite", "mixtral_window")
        and r["dtype"] == "bfloat16"}
    # rmsnorm at mixtral's d_model, on the ring path
    by_name["rmsnorm"]["cases"] = {
        r["case"]: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], library_ms=r["library_ms"])
        for r in checks["rmsnorm"]
        if r["case"] in ("mixtral_d6144", "mixtral_decode")
        and r["dtype"] == "bfloat16"}
    print(json.dumps({"kernels": kernels}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
