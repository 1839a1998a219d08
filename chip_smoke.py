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
   phi-3-vision's head dim 96 (``d96``), at the MoE paths' prefills
   (``granite``; ``mixtral_window``, where SDPA takes the window as an
   explicit mask; every row names the backend SDPA picked, which takes
   no mask where none is needed), at the prefix families'
   (``hymba_global``, ``phi3v``) and at whisper's serving shapes
   (``whisper_enc`` non-causal over 1,500 frames, ``whisper_cross`` and
   ``whisper_cross_decode`` a prompt of 224 and one query row over them,
   ``whisper_self`` causal over 224); rmsnorm also at their widths
   and, with the SSD scan, at the fleet phase's 6 x 2048; the SSD scan
   also with its final state through ``ops.ssd_prefill`` at the serving
   prefill shapes (8 x 512 and 4 x 300, padded, and hymba's 8 x 640 at
   state n = 16), y and the state each held to its own tolerance and
   timed against the y-only scan; and each bf16 stage kernel of the
   SSD scan (chunk state, state passing with the final state, chunk scan)
   against its plain stage function, timed alone (``ssd_stage`` lines).
   The flash-attention backward (``flash_attention_backward`` rows, through
   ``_FlashAttention`` as the models call it) at the dense training shape
   (``train``: 4 x 2048, 14 / 2 heads of 64, causal), ``window48``,
   ``ragged300``, ``q_offset``, ``gqa1`` (H = K), ``d32`` (the example's
   smoke preset) and ``d128``: dq, dk, dv against autograd through the
   fp32 plain twin, each within 2x the bf16 plain twins' own distance plus
   1e-3 of its largest entry, and the kernels' gradients at 4 mantissa
   bits must fail that; the three launches timed together and each alone,
   beside the plain backward, SDPA's backward and the bound; an fp32 or
   unaligned input that needs a gradient must raise.
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
6d. serve_hybrid: phases 4-5 for hymba-1.5b at its published config,
   uncut (32 layers, d_model 1,600, 25 / 5 heads of 64 beside 50 SSD
   heads of 64 with state 16 in every layer, 128 meta tokens, window
   1,024 with layers 0 / 15 / 31 global): exactly 3 flash launches (the
   global layers; the windowed ones keep the meta tokens as sinks, plain
   ``ref.mha``) and 32 ssd_scan a prefill, 161 rmsnorm a forward.
   ``plain_hybrid`` holds the kernels against the plain twins as
   ``plain_moe`` does (fp32 over an fp32 K/V cache; bf16 by distance, with
   coarse kernels that must fail), and ``handoff_hybrid`` prefill +
   decode against one full-sequence forward (fp32 at every forced
   position, bf16 at the prompt's end and the first decode step).
6e. hybrid_window: two prompts of 1,536 text tokens (1,664 internal
   positions, past the window) and 32 new tokens through the engine,
   exact launches; prefill + decode against a full forward of 1,696
   positions (fp32 everywhere, bf16 at the handoff); the first windowed
   layer's attention output at the prompt and at the last step against
   an independent masked SDPA, which a mask without the sinks or with
   half the window must fail.
6f. serve_vlm: phases 4-5 for phi-3-vision-4.2b at its published config,
   uncut (32 layers, d_model 3,072, 32 heads of 96, 576 patches of 1,024
   projected in front of the text), each request with seeded patch
   embeddings passed to ``ServeEngine.generate`` as ``extra_inputs``:
   exactly 32 flash launches a prefill (8 x 1,088 positions), 65 rmsnorm
   a forward; ``plain_vlm`` and ``handoff_vlm`` as for hymba.
6g. serve_encdec: phases 4-5 for whisper-large-v3 at its published
   config, uncut (32 encoder and 32 decoder layers, d_model 1,280, 20 / 20
   heads of 64, gelu MLPs of 5,120, layernorms, 1,500 source positions),
   batch 8, 16 prompts of 224 tokens and 4 of 96, each with seeded frame
   embeddings passed to ``ServeEngine.generate`` as ``extra_inputs``:
   exactly 96 flash launches a prefill (32 encoder, 32 decoder self, 32
   cross) and 32 a decode step (the cross-attention over the cached cross
   K/V), no rmsnorm.  ``plain_encdec`` as for hymba, its bf16 control a
   coarse flash (the path has no rmsnorm), plus the encoder's output held
   apart from the logits; ``handoff_encdec`` as for hymba, where a slot
   handed its neighbour's cross K/V must fail the bf16 decode bound.
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
15. fleet_train: the fleet control plane (the scenario of
   ``benchmarks/bench_fleet.py``) with a full-width mamba2-780m ``Trainer``
   on the card as host 0, attached with ``connect_fleet``, beside two
   host-side loaders attached with ``connect_host``, over a
   ``FaultyTransport`` (seeded drops and duplicates) to a
   ``CoordinatorServer`` with a standby ``CoordinatorReplica``, a
   ``LeaderLease`` and a ``SnapshotStore``, one fleet round per card step
   on a clock the phase moves: a startup uniform consensus whose trials on
   host 0 run on the CUDA edge, pushed to every host; a straggler
   re-consensus after host 1's storage turns 25x slower, and none before;
   host 2's death, one reshard at a common barrier with its undelivered
   slices as makeup, 6-row slices to the epoch's end, then the geometry
   latch at global batch 8 and the Trainer's LR rescaled by 8/12; the
   leader's crash after the reshard, the standby's promotion with a fence
   one higher, and the old leader's command rejected by host 0's link.
   Every index of the epoch across the death is delivered exactly once
   (and not without the makeup); every card batch equals the host batch
   its samplers name, byte for byte, in the order they name it; losses
   finite and falling; exactly 48 ssd_scan and 97 rmsnorm launches a step.
   The line has the events with their rounds, each step's wall and device
   time and local batch, the peak memory and the transport's counts.
16. fleet_serve: full-width qwen2-0.5b's ``BatchingFrontend`` attached
   with ``connect_fleet(transport, loader, host="serve0")`` beside one
   host-side peer; its feature loader delivers to the card and is read
   once a served group.  The serve phase's 20 requests in three waves:
   one report a served batch, idle heartbeats, a batch-mix drift that
   makes the fleet push a cell into the feature loader while serving;
   tokens equal to the engine's without a fleet, feature batches equal
   to their host batches, launches exactly those of the prefills and
   decode steps served.
17. dp_train: the data-parallel step (``distributed/dp_shard.py``,
   ``make_train_step`` with ``dp_manual``) on full-width mamba2-780m over a
   one-rank NCCL group (a ``FileStore`` in a temporary directory), under
   ``use_rules(make_local_mesh(), rules_for("train"))``: phase 7's masters
   and batch, 2 microbatches of 2 x 2048, remat "none".  One dp step
   against the plain step over the whole batch from identical masters
   (loss, gradient norm, every leaf's update cosine), and a control
   without the deferred scale's 1/n_mb that must fail it; exactly 96
   ssd_scan and 194 rmsnorm launches a step, no flash; ``compressed_psum``
   over the step's gradients on NCCL equal to ``compress_decompress`` at
   world 1; a sharded checkpoint (published widths, 4 layers) restored
   through ``restore(shardings=)`` bit-equal.  The line has three timed
   steps (step s, tokens/s, peak memory), a profiled step's idle share, the
   collectives of a step beside those the design implies, and the plain
   step at 6 x 2048 under remat "full" (recorded, not held).  World size 1
   runs the NCCL path, not cross-rank traffic.
18. train_dense: uncut qwen2-0.5b (24 layers, d_model 896, 14 / 2 heads
   of 64, vocab 151,936) on phase 7's 4 x 2048 batch from seeded masters,
   bf16 compute: one step's loss and every gradient leaf through the flash
   forward and backward kernels against the plain twins (loss to 2e-3,
   each leaf's cosine >= 0.99 and its distance to an fp32 plain reference
   within 1.5x the plain bf16 path's + 1e-4), remat "dots" against "none",
   a backward coarsened to 2 mantissa bits that must fail the gradient
   check, exactly 24 flash forward and 24 backward launches a step at
   "none" (48 / 24 at "dots"), then timed steps (step s, tokens/s, peak
   memory) and a profiled one (idle share, device time by group).
19. trainer_dense: the ``Trainer`` on the same model, remat "dots", over
   LCG token data (``examples/torch_train_lm.py``'s ``lcg_dataset``, ids
   under 4,096): a startup DPT grid tune, 4 steps with the loss falling,
   2 steps and a blocking checkpoint, a resume whose restored state is
   bit-equal and whose steps give the straight run's losses; exact
   launches; then ``examples/torch_train_lm.py --preset smoke`` on the
   card, whose assertion that the loss fell must hold.
20. kernels: one line listing every ported kernel with its launches on the
   paths above, error and times; flash's row also carries the backward's
   launches by path, errors and times (``backward_*``).

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script then exits non-zero without that line.  It exits
non-zero at once when no CUDA device is present or when run outside a
checkout of the repository.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
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
# the bf16 bound of the MoE, hybrid and vlm phases, by distance (1 - mean
# cosine) to the fp32 plain reference: the kernel path's at most BF16_RATIO
# times the plain bf16 path's own, plus BF16_SLACK.  On granite the plain
# path sits 1.35e-3 to 1.46e-3 from fp32 and the kernel path 1.19e-3 to
# 1.29e-3 (NVIDIA H100 80GB HBM3, 700 W), so mamba2's margin of 0.01 would
# pass a kernel path seven times farther.  The ratio leaves room for the
# run-to-run route flips of index_add's unordered atomics.  The same
# distance is read for the kernel path with one kernel's output rounded to
# fewer of bf16's 7 mantissa bits (kernel, bits): the last is the
# control, which must fail the bound (the MoE and prefix families first
# read a coarse flash, to show how far flash is seen).
# Granite's control keeps 3 bits of rmsnorm (4.6e-3 against a bound of
# 2.2e-3); hymba and phi-3-vision, with more norms a layer, fail at 5 bits
# (4.9e-3 against 2.2e-3, 2.0e-3 against 1.0e-3).  Whisper runs no
# rmsnorm, and flash in every layer of a prefill and in every decode
# step's cross-attention: its control is flash at 3 bits (6.8e-4 against
# 2.6e-4; 4 bits read 2.1e-4, under), and it must also fail the bound on
# the encoder's output.  The finer readings that chose these are in
# PERF.md section 6 (NVIDIA H100 80GB HBM3, 700 W)
BF16_RATIO, BF16_SLACK = 1.5, 1e-4
FAULTS = {"moe": (("flash_attention", 3), ("rmsnorm", 3)),
          "prefix": (("flash_attention", 3), ("rmsnorm", 5)),
          "encdec": (("flash_attention", 3),)}
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

# flash_attention, against the plain twin computed in fp32 from the same
# inputs: fp32 to 2e-5 absolute and relative.  bf16: rtol 2^-8 (the
# output's one rounding, at most half an ulp) and atol a fraction of
# max |ref|.  The tensor-core kernel also rounds P to bf16 for the PV
# product: noise of about 2^-8 / sqrt(3) of the output's rms, whose
# largest value over millions of outputs (~5.5 sigma) is under 2e-3 of
# max |ref| where the rms is under a fifth of the max.  The fault the
# limit must catch is a last tile whose zero-filled keys count at score 0
# (36 of them past T = 1,500 shrink an output by up to ~1.4%, less in a
# row one key dominates, where the largest outputs sit).  It is checked
# on each non-causal case with a partial last tile (``tail_unmasked``),
# which must fail; each row records the atol it needed.  On an NVIDIA
# H100 80GB HBM3 at 700 W the bf16 rows needed at most 1.16e-3 of
# max |ref| (whisper_cross_decode) and the control 4.46e-3 (whisper_enc)
# to 0.19 (d16_full), PERF.md section 6: 2e-3 sits between.  The fp32
# rows go to the scalar flash_fwd_kernel, not the tensor-core kernel that
# serves bf16
TOL = {"bfloat16": (2 ** -8, 2e-3), "float32": (2e-5, None)}   # attention
FLASH_KEY_TILE = 64     # MMA_BK of csrc/flash_attention.cu
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
# its logit checks, and those of phases 6d and 6f, force the first
# FORCED_STEPS answered tokens (decode is host-bound at ~0.15 s a step,
# and eight forced runs of 32 steps would add ~30 s to the script)
MOE_ARCH = "granite-moe-3b-a800m"
FORCED_STEPS = 8

# phases 6d-6e: hymba-1.5b at its published config, uncut, the same
# REQUESTS; then two prompts of WINDOW_PROMPT text tokens (with its 128
# meta tokens 1,664 internal positions, past the 1,024 window)
HYBRID_ARCH = "hymba-1.5b"
WINDOW_BATCH, WINDOW_PROMPT = 2, 1536

# phase 6f: phi-3-vision-4.2b at its published config, uncut, the same
# REQUESTS, each prompt with seeded patch embeddings (576 x 1,024)
VLM_ARCH = "phi-3-vision-4.2b"

# phase 6g: whisper-large-v3 at its published config, uncut, each prompt
# with seeded frame embeddings (1,500 x 1,280).  224 is whisper's prompt
# limit, half its 448-token text context, so prompt and answer fit in it
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_REQUESTS = ((224, 16), (96, 4))

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

# phase 15: the fleet control plane with the card as host 0 (the scenario
# of benchmarks/bench_fleet.py).  Global batch 12 over three hosts, 4 rows
# of 2,048 tokens each, 20 batches to the first epoch; every host's
# storage pays FLEET_LATENCY_S an item.  host1's storage is 25x slower
# from round 2 (a batch then takes ~2.5 s against a ~1.4 s card step: a
# straggler) until the fleet's straggler re-consensus, when it recovers;
# host2 falls silent from round 5, or the round after that consensus;
# the leader crashes a round after the reshard.  The coordinator, its
# lease and the heartbeats run on a clock the phase moves on by one each
# round (one card step), and every host reads its goodput over the last
# two rounds.  The token rows draw from the first 4,096 ids, so the loss
# has somewhere to fall.
FLEET_GB, FLEET_BPE = 12, 20
FLEET_LATENCY_S = 0.05
FLEET_DEGRADE, FLEET_DEGRADE_AT = 25.0, 2
FLEET_DEATH_AT = 5
FLEET_TIMEOUT, FLEET_TTL = 2.0, 3.0
FLEET_WINDOW = 2
FLEET_CRASH_AFTER = 1
FLEET_EPOCH1_STEPS = 2
FLEET_MAX_ROUNDS = 40
FLEET_VOCAB = 4096
# phase 16: qwen2-0.5b serving as a fleet host; its feature loader reads
# ImageNet-crop-like images of 32 x 32 x 3 behind 2 ms storage, 8 a batch
FLEET_SERVE_WAVES = ((300, 4), (512, 8), (512, 8))   # (prompt, requests)
FLEET_FEATURES, FLEET_FEATURE_RES, FLEET_FEATURE_BATCH = 256, 32, 16

# phase 17: the data-parallel step (distributed/dp_shard.py) on one card,
# a one-rank NCCL group: phase 7's masters and batch, DP_MICROBATCHES
# microbatches of 2 x 2048 a step, DP_STEPS timed steps after the checked
# one.  Check 1 holds one dp step against the plain step over the whole
# batch (microbatches 1: the plain step reports its last microbatch's loss,
# the dp step the mean, and with an all-ones mask and equal microbatches
# the whole batch has the same loss and gradient as that mean) to
# MAX_LOSS_REL on the loss, DP_NORM_REL on the gradient norm and
# MIN_GRAD_COSINE on every leaf's update.  The two steps' AdamW takes eps
# DP_ADAM_EPS, as the repo's tests compare steps: with eps 1e-8 the first
# update is about sign(g) * lr, so an entry whose gradient is rounding
# noise moves by +-lr at random and the cosine counts sign flips of noise
# (in a CPU rehearsal at reduced size, gradients at a cosine of 0.9998 to
# each other gave updates at 0.968); a gradient clipped to norm 1 over
# 780M entries has an rms entry of 3.6e-5, so at 1e-4 the update follows
# the gradient.  Check 5 saves and restores a
# sharded state of mamba2 at published widths and DP_CKPT_LAYERS layers.
# Then the plain step at REMAT_BATCH x 2048 under remat "full", one warm-up
# and REMAT_STEPS timed steps (recorded, not held)
DP_MICROBATCHES, DP_STEPS = 2, 3
DP_NORM_REL = 2e-3
DP_ADAM_EPS = 1e-4
DP_CKPT_LAYERS = 4
REMAT_BATCH, REMAT_STEPS = 6, 2

# phase 3: the flash-attention backward against autograd through the fp32
# plain twin on the same bf16 inputs: each of dq, dk, dv within
# BWD_TWIN_RATIO x the bf16 plain twins' own largest distance from it
# (their backward computes in fp32 from bf16 q, k, v, dO and the bf16 o,
# and rounds its outputs to bf16) plus BWD_ATOL_OF_MAX of its largest
# entry.  The kernels round P to bf16 for the dV product and carry dS as
# a bf16 pair (hi + lo) into dK and dQ: with dS rounded once, dQ at
# window48 read 1.05 of this limit (NVIDIA H100 80GB HBM3, 700 W; PERF.md
# section 6).  The kernels' gradients rounded to BWD_CONTROL_BITS mantissa
# bits (bf16 keeps 7) must fail the limit
BWD_TWIN_RATIO, BWD_ATOL_OF_MAX, BWD_CONTROL_BITS = 2.0, 1e-3, 4

# phases 18-19: the dense LM trained at full width and depth (qwen2-0.5b:
# 24 layers, d_model 896, 14 / 2 heads of 64 with QKV bias, d_ff 4,864,
# vocab 151,936, tied embeddings) on phase 7's 4 x 2048 batch, bf16
# compute with fp32 masters.  Phase 18 holds one step's loss to
# MAX_LOSS_REL and its gradients leaf by leaf against the plain twins (see
# ``held`` in train_dense_path), a step under remat "dots" to the "none"
# step (the same loss to DOTS_LOSS_REL; every leaf's gradient cosine at
# least DOTS_MIN_COSINE: the kernels are deterministic, the embedding's
# scatter-add is not), and a backward whose outputs keep
# DENSE_CONTROL_BITS mantissa bits must fail the gradient check; then
# DENSE_STEPS timed steps.  Phase 19 runs the Trainer DENSE_TRAINER_STEPS
# steps on LCG token data whose ids stay under DENSE_LCG_VOCAB (so the
# loss has somewhere to fall in a few steps), and then
# examples/torch_train_lm.py --preset smoke for EXAMPLE_STEPS steps.  On
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6) the kernels' worst
# leaf (a key bias, whose gradient the attention backward alone feeds)
# sat at 0.89 of its distance limit, and the control at 2 bits failed 93
# of the 290 leaves
DENSE_ARCH = "qwen2-0.5b"
DOTS_LOSS_REL, DOTS_MIN_COSINE = 1e-6, 0.99999
DENSE_CONTROL_BITS = 2
DENSE_STEPS = 2
DENSE_TRAINER_STEPS = 4
DENSE_LCG_VOCAB = 4096
EXAMPLE_STEPS = 100

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
    Returns (ms, timer).  Every function timed here runs at least one
    device operation a call, so a profiler window that records fewer than
    ``iters`` (a window whose tracing started late: one window read one
    kernel of 20) is retried; if none records them all, the time is taken
    with CUDA events instead and ``timer`` says so."""
    fn()
    for _ in range(3):
        _, busy, avgs = device_busy(torch,
                                    lambda: [fn() for _ in range(iters)])
        ops = sum(e.count for e in avgs if e.self_device_time_total > 0)
        if busy > 0 and ops >= iters:
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
    for D in (32, 64, 128):          # the backward's: d32, train, d128
        out[f"flash_bwd_dkdv_kernel<{D}>"] = \
            fl.flash_attention_bwd_smem_bytes(2, D)
        out[f"flash_bwd_dq_kernel<{D}>"] = \
            fl.flash_attention_bwd_smem_bytes(4, D)
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
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        rtol, atol_of_max = TOL[dtype]
        ref_max = float(ref.abs().max())
        atol = rtol if atol_of_max is None else atol_of_max * ref_max
        err = max_err(out, ref, rtol, atol)
        control = {}
        tail = -T % FLASH_KEY_TILE
        if dtype == "bfloat16" and not causal and window == 0 and tail:
            # what a kernel whose last tile skipped the mask would give:
            # the zero-filled keys past T counted at score 0
            zk = k.new_zeros((B, tail, K, D))
            faulty = fa.flash_attention_plain(
                q.float(), torch.cat([k, zk], 1).float(),
                torch.cat([v, zk], 1).float(), **kw).to(dt)
            need = atol_needed(faulty, ref, rtol) / ref_max
            check(need > atol_of_max,
                  f"{name}: a last tile counting its {tail} zero-filled "
                  f"keys passes the bf16 limit (needs {need} of max |ref|, "
                  f"limit {atol_of_max})")
            control = dict(tail_unmasked_atol_needed_of_max=need)
            del faulty

        # yardstick: one SDPA call on (B,H,S,D) views with GQA
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_kw = sdpa_kwargs(torch, S, T, causal, window, q_offset)

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
        # the row names the backend SDPA took
        row = dict(kernel="flash_attention", case=name, dtype=dtype,
                   shape=dict(B=B, S=S, T=T, H=H, K=K, D=D, causal=causal,
                              window=window, q_offset=q_offset),
                   max_abs_err=err, rtol=rtol, atol=atol,
                   atol_needed_of_max=atol_needed(out, ref, rtol) / ref_max,
                   **control, **timings(torch, fns),
                   library_backend=sdpa_backend(torch, library),
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        emit("kernel_check", **row)
        rows.append(row)
    return rows


def sdpa_kwargs(torch, S, T, causal, window, q_offset):
    """SDPA's arguments for the same masks: none where none is needed, so
    SDPA may take its fused backends (an explicit mask keeps cuDNN and
    flash out); SDPA has no window argument, so a windowed case (or a
    causal one off the diagonal) passes the explicit boolean mask."""
    if causal and window == 0 and q_offset == 0 and S == T:
        return {"is_causal": True}
    if not causal and window == 0:
        return {}
    pos_q = torch.arange(S, device="cuda")[:, None] + q_offset
    pos_k = torch.arange(T, device="cuda")[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device="cuda")
    if causal:
        mask &= pos_k <= pos_q
    if window > 0:
        mask &= pos_q - pos_k < window
    return {"attn_mask": mask}


def raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def check_flash_backward(torch, F, fa, gen, name, B, S, T, H, K, D, *,
                         causal=True, window=0, q_offset=0):
    """The backward kernels (through ``_FlashAttention``, as the models call
    them) against autograd through the fp32 plain twin on the same bf16
    inputs, each of dq, dk, dv to 2x the bf16 plain twins' own distance
    from it plus 1e-3 of its largest entry; the kernels' gradients rounded
    to BWD_CONTROL_BITS mantissa bits must fail that limit.  Times the
    three launches together and each alone on buffers made once, the
    plain backward and SDPA's backward."""
    dt = torch.bfloat16
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, T, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves, do)
    torch.cuda.synchronize()
    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(fa.flash_attention_plain(*ref_leaves, **kw),
                              ref_leaves, do.float())
    del ref_leaves
    o_t, lse_t = fa.flash_attention_plain_lse(q, k, v, **kw)
    twin = fa.flash_attention_backward_plain(q, k, v, o_t, lse_t, do, **kw)
    grads = {}
    for gname, g, r, t in zip(("dq", "dk", "dv"), got, ref, twin):
        check(bool(torch.isfinite(g.float()).all()),
              f"flash backward {name}: {gname} is not finite")
        ref_max = float(r.abs().max())
        err = float((g.float() - r).abs().max())
        twin_err = float((t.float() - r).abs().max())
        limit = BWD_TWIN_RATIO * twin_err + BWD_ATOL_OF_MAX * ref_max
        control = float((coarsen(torch, g, BWD_CONTROL_BITS).float()
                         - r).abs().max())
        grads[gname] = dict(max_abs_err=err, twin_err=twin_err, limit=limit,
                            ref_max=ref_max, control_err=control)
        check(err <= limit, f"flash backward {name}: {gname} off by {err}, "
              f"limit {limit} (bf16 twin {twin_err}, max |ref| {ref_max})")
        check(control > limit,
              f"flash backward {name}: {gname} at {BWD_CONTROL_BITS} "
              f"mantissa bits ({control}) passes the limit {limit}")
    del got, ref, twin
    refused = {}
    if name == "train":
        # what the backward does not take raises, and nothing falls back
        q32 = q.float().requires_grad_()
        wide = torch.randn((B, S, H, D + 2), generator=gen,
                           device="cuda").to(dt).requires_grad_()
        refused = dict(
            float32=raises(lambda: fa.flash_attention(
                q32, k.float(), v.float(), **kw), NotImplementedError),
            unaligned=raises(lambda: fa.flash_attention(
                wide[..., 1:D + 1], k, v, **kw), NotImplementedError))
        check(all(refused.values()),
              f"flash backward: an input it does not take did not raise: "
              f"{refused}")
        del q32, wide

    # timings on buffers made once
    scale = D ** -0.5
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    o = fa._forward_kernel(q, k, v, causal, window, q_offset, scale, lse)
    delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    bufs = tuple(torch.empty_like(x) for x in (q, k, v))

    def kernel(which):
        return lambda: fa.backward_kernel(q, k, v, o, lse, do, **kw,
                                          which=which, delta=delta,
                                          grads=bufs)

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa_kw = sdpa_kwargs(torch, S, T, causal, window, q_offset)

    def forward():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **sdpa_kw)

    sout = forward()

    def library():
        return torch.autograd.grad(sout, (qt, kt, vt), dot,
                                   retain_graph=True)

    pairs = flash_pairs(S, T, causal, window, q_offset)
    flops = 10.0 * B * H * D * pairs            # five products, 2 FLOP each
    nbytes = 2 * (4 * B * S * H * D + 4 * B * T * K * D) + 4 * B * H * S
    bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
    fns = {"kernel": kernel(7), "preprocess": kernel(1), "dkdv": kernel(2),
           "dq": kernel(4),
           "plain": lambda: fa.flash_attention_backward_plain(
               q, k, v, o_t, lse_t, do, **kw),
           "library": library}
    row = dict(kernel="flash_attention_backward", case=name,
               dtype="bfloat16",
               shape=dict(B=B, S=S, T=T, H=H, K=K, D=D, causal=causal,
                          window=window, q_offset=q_offset),
               max_abs_err=max(g["max_abs_err"] for g in grads.values()),
               grads=grads, control_bits=BWD_CONTROL_BITS, refused=refused,
               **timings(torch, fns),
               library_backend=sdpa_backend(torch, forward),
               bound_ms=bound_ms, bound_by=bound_by, flops=flops,
               bytes=nbytes)
    emit("kernel_check", **row)
    del sout, qt, kt, vt, o_t, lse_t
    torch.cuda.empty_cache()
    return [row]


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
    """FLOPs the function needs over the ``s`` positions it is given, in
    chunks of ``chunk`` and a last partial one (per chunk of c positions:
    the causal triangle of C B^T and its product with x dt, c (c + 1) / 2
    pairs of 2 (n + p) each, and the two state products), and the bytes of
    x, dt, A, B, C and y.  The padding a wrapper adds is its own choice,
    not work the function needs, so it is not counted."""
    def per_chunk(c):
        return 2 * (c * (c + 1) // 2) * (n + p) + 4 * c * n * p

    flops = float(b * h * ((s // chunk) * per_chunk(chunk)
                           + per_chunk(s % chunk)))
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
        flops, nbytes = ssd_cost(b, s, h, p, g, n, chunk, x.element_size())
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
        flops, nbytes = ssd_cost(b, s, h, p, g, n, chunk, x.element_size())
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


def coarsen(torch, out, bits: int):
    """``out`` rounded to nearest with ``bits`` mantissa bits (bf16 keeps
    7), as a kernel that lost precision would give it."""
    drop = 23 - bits
    i = out.float().view(torch.int32)
    i = (i + (1 << (drop - 1))) & -(1 << drop)
    return i.view(torch.float32).to(out.dtype)


@contextlib.contextmanager
def coarse_kernel(torch, ops, fa, rn, kernel: str, bits: int):
    """A faulty kernel for the block: the output of ``kernel``
    ("flash_attention" or "rmsnorm") rounded by ``coarsen``.  The
    kernel still launches, and counts."""

    def coarse(out):
        return coarsen(torch, out, bits)

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


def forced_logits(torch, model, prompts, forced, kv_dtype=None,
                  extra=None):
    """Last-position logits of the prompt and of each teacher-forced step:
    (B, n, V) fp32, for prompts (B,S) and forced tokens (B,n), over a
    cache of ``kv_dtype`` (the model's default, bf16, if None); ``extra``:
    more fields of the prefill batch (a vlm's patches)."""
    B, S = prompts.shape
    n = forced.shape[1]
    cache = model.init_cache(B, S + n, **(
        {} if kv_dtype is None else {"kv_dtype": kv_dtype}))
    logits, cache = model.prefill({"tokens": prompts, **(extra or {})},
                                  cache)
    outs = [logits[:, -1].float()]
    pos = torch.full((B,), S, dtype=torch.long, device=prompts.device)
    for j in range(n - 1):
        logits, cache = model.decode_step(cache, forced[:, j:j + 1], pos)
        outs.append(logits[:, -1].float())
        pos = pos + 1
    return torch.stack(outs, dim=1)


def full_sequence_logits(torch, model, tokens, first: int, extra=None):
    """Logits (B, n, V) fp32 of text positions ``first`` .. S-1 of one
    full-sequence forward of ``tokens`` (B,S), behind the model's prefix
    (``extra``: a vlm's patches; for whisper its frames, which the
    decoder attends over), through the kernels: the training forward,
    with no cache."""
    from repro_torch.models import layers as ll
    with torch.no_grad():
        h, _ = model.final_hidden({"tokens": tokens, **(extra or {})})
        return ll.unembed(model.embed, model.cfg,
                          h[:, first:].contiguous()).float()


def seeded_model(torch, cfg):
    """``cfg``'s model on the card, its weights drawn from seed 0, in the
    compute dtype ``layers.COMPUTE_DTYPE`` holds."""
    from repro_torch.models import build_model, param_specs
    from repro_torch.models.module import init_params
    params = init_params(param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0))
    return build_model(cfg, params, device="cuda")


@contextlib.contextmanager
def fp32_model(torch, cfg):
    """The served model rebuilt from the same seed in fp32 compute, for
    the block; the caller deletes it inside the block to free it."""
    from repro_torch.models import layers as ll
    saved = ll.COMPUTE_DTYPE
    ll.COMPUTE_DTYPE = torch.float32
    try:
        yield seeded_model(torch, cfg)
    finally:
        ll.COMPUTE_DTYPE = saved
        torch.cuda.empty_cache()


def handoff(torch, F, model, prompts, forced, decoded=None, kv_dtype=None,
            extra=None):
    """Prefill + decode against one full-sequence forward: per sequence
    and position (B, n), the cosine of the logits at the prompt's last
    position and at each teacher-forced step (``forced_logits`` of
    ``prompts`` and ``forced`` (B, n), or ``decoded`` where the caller
    has them) to the same positions of one forward of the prompt (behind
    its prefix) and forced[:, :n-1], both through the kernels.  Returns
    (cosines, the full forward's logits)."""
    if decoded is None:
        decoded = forced_logits(torch, model, prompts, forced,
                                kv_dtype=kv_dtype, extra=extra)
    full = full_sequence_logits(torch, model,
                                torch.cat([prompts, forced[:, :-1]], dim=1),
                                prompts.shape[1] - 1, extra=extra)
    return F.cosine_similarity(decoded, full, dim=-1), full


def neighbour_state_logits(torch, model, prompts, forced, extra=None,
                           leaves=("ssm_state",)):
    """The first decode step's logits (B, V) fp32 after a prefill of
    ``prompts`` whose cache ``leaves`` (the final SSM states, or
    whisper's cross K/V) were each handed to the next slot: what a store
    that writes the wrong slot gives."""
    B, S = prompts.shape
    cache = model.init_cache(B, S + 1)
    model.prefill({"tokens": prompts, **(extra or {})}, cache)
    for name in leaves:
        cache[name].copy_(cache[name].roll(1, dims=1))
    logits, _ = model.decode_step(
        cache, forced[:, :1], torch.full((B,), S, dtype=torch.long,
                                         device=prompts.device))
    return logits[:, -1].float()


def hold_handoff(h32, h16, decode_min=MIN_COSINE, faulty=None):
    """The handoff bounds: fp32 prefill + decode against the full sequence
    (``h32``, every position held) to ``MIN_COSINE``; the served bf16
    model's (``h16``: the prompt's last position, the first decode step)
    to ``MIN_COSINE`` and ``decode_min``; and a faulty first decode step
    (``faulty``, per sequence) must fall below ``decode_min``."""
    check(float(h32.min()) >= MIN_COSINE,
          f"fp32 prefill + decode against the full sequence: cosine "
          f"{float(h32.min())} < {MIN_COSINE}")
    check(float(h16[:, 0].min()) >= MIN_COSINE,
          f"bf16 prefill against the bf16 full sequence: cosine "
          f"{float(h16[:, 0].min())} < {MIN_COSINE}")
    check(float(h16[:, 1].min()) >= decode_min,
          f"bf16 first decode step against the bf16 full sequence: cosine "
          f"{float(h16[:, 1].min())} < {decode_min}")
    if faulty is not None:
        check(float(faulty.max()) < decode_min,
              f"a neighbour's state passes the bf16 decode bound: cosine "
              f"{float(faulty.max())}")


def serve_path(torch, np, F, modules, arch: str,
               requests=REQUESTS) -> dict:
    """Phases 4-5 (qwen2-0.5b), 6 (mamba2-780m), 6b (granite-moe), 6d
    (hymba-1.5b), 6f (phi-3-vision-4.2b) and 6g (whisper-large-v3) at
    full width: serve ``requests`` through the frontend with exact launch
    counts, profile a prefill and eight decode steps, then hold
    teacher-forced logits against the plain twins' (and, for the SSM, the
    prefix families and whisper, against a full-sequence forward).  A vlm
    request carries seeded patch embeddings and a whisper request seeded
    frame embeddings: the frontend passes none (as ``repro``'s), so the
    engine here adds each prompt's to its ``generate`` call as
    ``extra_inputs``.  Returns the launches of the serving run."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import BatchingFrontend, ServeEngine
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    from repro_torch.models import layers as ll
    cfg = get_config(arch)
    family = cfg.family
    tag = "" if family == "dense" else "_" + family
    t0 = time.perf_counter()
    model = seeded_model(torch, cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
               for plen, count in requests for _ in range(count)]
    # the stub frontends' inputs, one per prompt: a vlm's patches,
    # whisper's frames
    stub, stubs = None, {}
    if cfg.num_patches:
        stub = ("patch_embeds", (cfg.num_patches, cfg.patch_embed_dim))
    elif cfg.encoder_layers:
        stub = ("frames", (cfg.max_source_positions, cfg.d_model))
    if stub:
        pgen = torch.Generator(device="cuda").manual_seed(1)
        stubs = {p.tobytes(): torch.randn(stub[1], generator=pgen,
                                          device="cuda") for p in prompts}

    def extra_for(rows):
        """The prefill's extra inputs for prompts ``rows`` (B, S)."""
        if not stub:
            return None
        return {stub[0]: torch.stack(
            [stubs[np.asarray(r, np.int32).tobytes()] for r in rows])}

    results = []

    class RecordingEngine(ServeEngine):
        def generate(self, prompts_, max_new_tokens, *, seed=0):
            res = super().generate(prompts_, max_new_tokens, seed=seed,
                                   extra_inputs=extra_for(prompts_))
            results.append(res)
            return res

    max_len = max(p for p, _ in requests) + NEW_TOKENS + 8
    engine = RecordingEngine(model, max_batch=MAX_BATCH, max_len=max_len,
                             device="cuda")
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
    # a prefill runs the flash kernel in every layer whose attention is
    # not ragged (all but the SSM's; hymba's three global layers: its
    # windowed layers keep the meta tokens as sinks, which go to
    # ref.mha; whisper's encoder, decoder self and cross layers) and the
    # scan in every layer with an SSM; decode runs ragged attention and
    # the recurrence, no kernel, but for whisper's cross-attention over
    # its cached cross K/V, flash in every layer.  rmsnorms a forward:
    # ln1 (and ln2 with attention) a layer, hymba's two mixing norms and
    # the SSM's gate norm, and the final norm; whisper's are layernorms
    flash_layers = {"ssm": 0, "hybrid": len(cfg.global_attn_layers),
                    "encdec": L + cfg.encoder_layers + L}.get(family, L)
    flash_step = L if family == "encdec" else 0
    norms = {"ssm": 2, "hybrid": 5, "encdec": 0}.get(family, 2) * L \
        + (family != "encdec")
    expect = {"flash_attention": flash_layers * batches + flash_step * steps,
              "rmsnorm": norms * (batches + steps),
              "ssd_scan": L * batches if cfg.ssm_state_dim else 0}
    decode_tokens = sum(r.tokens.shape[0] * (r.steps - 1) for r in results)
    decode_s = sum(r.decode_s for r in results)
    cache_bytes = sum(t.numel() * t.element_size() for t in
                      model.init_cache(MAX_BATCH, max_len).values())
    emit("serve" + tag, arch=cfg.name, params=cfg.param_count(),
         layers=L, prefix_positions=model.prefix_len,
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
    pbatch = {"tokens": pt, **(extra_for(prompts[:MAX_BATCH]) or {})}
    cache = model.init_cache(MAX_BATCH, max_len)

    def prefill():
        model.prefill(pbatch, cache)

    tok = pt[:, -1:]
    pos = torch.full((MAX_BATCH,), pt.shape[1], dtype=torch.long,
                     device="cuda")

    def decode_steps():
        for j in range(8):
            model.decode_step(cache, tok, pos + j)

    expect_prefill = (("flash_mma_kernel",) if flash_layers else ()) + (
        ("ssd_scan_state_passing_kernel",) if cfg.ssm_state_dim else ())
    prefill_tokens = pt.shape[1] + model.prefix_len
    for window, fn, expect in (
            (f"{cfg.name} prefill 8x{prefill_tokens}", prefill,
             expect_prefill),
            (f"{cfg.name} 8 decode steps, batch 8", decode_steps,
             ("flash_mma_kernel",) if flash_step
             else ("rmsnorm",) if family != "dense" else ())):
        row = profile_phase(torch, window, fn, expect=expect)
        if family == "moe":
            row["moe_split"] = moe_split(torch, ll, fn)
        emit("profile", **row)
    del cache

    # ---- the same prompts through the plain twins ---------------------------
    # one batch of each prompt length, forced with what the path answered
    n_short = requests[-1][1]
    batches_, extras = [], []
    for sl in (slice(0, MAX_BATCH), slice(len(prompts) - n_short, None)):
        batches_.append(tuple(
            torch.as_tensor(np.stack(a[sl]), dtype=torch.long, device="cuda")
            for a in (prompts, outs)))
        extras.append(extra_for(prompts[sl]))
    if family == "ssm":
        ssm_logit_checks(torch, F, modules, cfg, model, batches_, counts)
        return launches
    if family in ("moe", "hybrid", "vlm", "encdec"):
        distance_logit_checks(torch, F, modules, cfg, model, batches_,
                              counts, extras)
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
        h16, full16 = handoff(torch, F, model, pt, ft[:, :2],
                              decoded=k16[:, :2])
        handoff16.append(h16)
    # what the bf16 bound separates: the first decode step of the last
    # batch with each slot handed its neighbour's final state
    rolled = cos(neighbour_state_logits(torch, model, pt, ft), full16[:, 1])
    with fp32_model(torch, cfg) as m32:
        fp32 = []
        for pt, ft in batches_:
            k32 = forced_logits(torch, m32, pt, ft)
            fp32.append((k32, plain_run(m32, pt, ft),
                         *handoff(torch, F, m32, pt, ft, decoded=k32)))
        del m32

    def cat(xs):
        return torch.cat([x.flatten() for x in xs])

    c32 = cat([cos(k, p) for k, p, _, _ in fp32])
    t32 = float(cat([top1(k, p) for k, p, _, _ in fp32]).mean())
    k16_ref = cat([cos(k, p32) for (k, _), (_, p32, _, _) in zip(bf16, fp32)])
    p16_ref = cat([cos(p, p32) for (_, p), (_, p32, _, _) in zip(bf16, fp32)])
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

    full = torch.cat([h for _, _, h, _ in fp32])          # (sequences, n)
    handoff32 = full[:, :2]
    h16 = torch.cat(handoff16)                            # (sequences, 2)
    emit("prefill_vs_full", positions=int(full.numel()),
         handoff_cosine_min=float(handoff32.min()),
         bf16_handoff_cosine_min_by_step=[float(v) for v in h16.min(0)[0]],
         bf16_handoff_cosine_min_by_sequence=[
             float(v) for v in h16.min(1)[0]],
         bf16_min_cosine=[MIN_COSINE, SSM_BF16_DECODE_MIN_COSINE],
         bf16_neighbour_state_cosine_max=float(rolled.max()),
         cosine_mean_by_step=[float(v) for v in full.mean(0)],
         cosine_min=float(full.min()), min_cosine=MIN_COSINE,
         top1_agreement=float(cat([top1(k, f) for k, _, _, f in fp32])
                              .mean()))
    hold_handoff(handoff32, h16, SSM_BF16_DECODE_MIN_COSINE, rolled)


def distance_logit_checks(torch, F, modules, cfg, model, batches_, counts,
                          extras=None):
    """The logit checks of phases 6b (granite-moe), 6d (hymba), 6f
    (phi-3-vision) and 6g (whisper) on the forced batches ``batches_``
    [(prompts, forced tokens)], ``model`` being the served bf16 model;
    ``extras`` holds each batch's extra prefill inputs (the vlm's
    patches, whisper's frames) or is None.

    ``plain_<family>``: in fp32 compute over an fp32 K/V cache the kernels
    are held against the plain twins to phase 5's bounds (the same
    weights; the two paths differ by summation order).  In bf16 compute a
    rounding difference between a kernel and its twin compounds over 32
    random layers (and for the MoE can move a top-8 choice and at capacity
    1.25 push another token out of its expert), so bf16 is held by
    distance (1 - mean cosine) to the fp32 plain reference: the kernel
    path's at most ``BF16_RATIO`` times the plain bf16 path's, plus
    ``BF16_SLACK``.  The same distance is read for the kernel path with
    each of the family's ``FAULTS`` made coarse (``coarse_kernel``), and
    the last must fail the bound.  For the MoE the route agreement is the
    share of (token, k) expert choices the kernel path and the plain path
    share, layer by layer, over the prompts and the forced steps (the
    first ``FORCED_STEPS`` answered tokens).

    ``handoff_<family>`` (the prefix families and whisper): prefill +
    decode against one full-sequence forward of the prompt (with its
    prefix, or whisper's frames) and the forced tokens, both through the
    kernels: in fp32 at every forced position, in bf16 on the served model
    at the prompt's last position and the first decode step, each to
    ``MIN_COSINE``; for whisper a first decode step with each slot handed
    its neighbour's cross K/V (another request's frames) must fall below
    it.  Whisper's encoder output is also held apart from the logits,
    which see it weakly (random weights attend broadly over 1,500 frames:
    a neighbour's whole cross K/V moves the first step's logits only to
    ~0.9985): kernels against plain twins (fp32, to ``MIN_COSINE``) and,
    in bf16, by distance to the fp32 plain encoder (``BF16_RATIO`` times
    the plain bf16 encoder's, plus ``BF16_SLACK``), which the family's
    coarse flash must fail as it fails the logits' bound."""
    from repro_torch.models import layers as ll
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))
    L, family = cfg.num_layers, cfg.family
    moe, encdec = family == "moe", family == "encdec"
    handoffs = family in ("hybrid", "vlm", "encdec")
    faults = FAULTS["moe" if moe else "encdec" if encdec else "prefix"]
    extras = extras or [None] * len(batches_)

    def run(m, i, plain, fault=None, kv_dtype=None):
        """Forced logits of batch i and each ``_route`` call's top-k
        experts (none but for the MoE)."""
        pt, ft = batches_[i]
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
                out = forced_logits(torch, m, pt, ft, kv_dtype=kv_dtype,
                                    extra=extras[i])
        finally:
            ll._route = orig
        if plain:
            check(counts() == before, "the plain run launched a kernel")
        check(bool(torch.isfinite(out).all()), "logits not finite")
        check(len(routes) == (L * ft.shape[1] if moe else 0),
              f"{len(routes)} routings")
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

    def encoded(m, plain, fault=None):
        """The encoder's output (fp32) for the first batch's frames."""
        before = counts()
        with (plain_kernels(ops, fa, rn, ss) if plain
              else coarse_kernel(torch, ops, fa, rn, *fault) if fault
              else contextlib.nullcontext()), torch.no_grad():
            out = m.encode(extras[0]["frames"]).float()
        if plain:
            check(counts() == before, "the plain run launched a kernel")
        return out

    batches_ = [(pt, ft[:, :FORCED_STEPS]) for pt, ft in batches_]
    n = len(batches_)
    runs, h16, h32, faulty, enc = {}, [], [], [], {}
    for i in range(n):
        runs[("bf16", "kernel", i)] = run(model, i, False)
        runs[("bf16", "plain", i)] = run(model, i, True)
        for fault in faults:
            runs[("bf16", fault, i)] = run(model, i, False, fault)
        if handoffs:
            pt, ft = batches_[i]
            c16, full16 = handoff(
                torch, F, model, pt, ft[:, :2],
                decoded=runs[("bf16", "kernel", i)][0][:, :2],
                extra=extras[i])
            h16.append(c16)
        if encdec:
            # what the bf16 decode bound separates: each slot handed its
            # neighbour's cross K/V
            faulty.append(cos(neighbour_state_logits(
                torch, model, pt, ft, extra=extras[i],
                leaves=("cross_k", "cross_v")), full16[:, 1]))
    if encdec:
        enc["bf16 kernel"] = encoded(model, False)
        enc["bf16 plain"] = encoded(model, True)
        enc["bf16 coarse"] = encoded(model, False, faults[-1])
    with fp32_model(torch, cfg) as m32:
        for i in range(n):
            runs[("fp32", "kernel", i)] = run(m32, i, False,
                                              kv_dtype=torch.float32)
            runs[("fp32", "plain", i)] = run(m32, i, True,
                                             kv_dtype=torch.float32)
            if handoffs:
                pt, ft = batches_[i]
                h32.append(handoff(
                    torch, F, m32, pt, ft,
                    decoded=runs[("fp32", "kernel", i)][0],
                    extra=extras[i])[0])
        if encdec:
            enc["fp32 kernel"] = encoded(m32, False)
            enc["fp32 plain"] = encoded(m32, True)
        del m32

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
    bound16 = BF16_RATIO * p_dist + BF16_SLACK
    k_dist = 1.0 - float(k16.mean())
    fault_dist = {
        fault: 1.0 - float(cat(lambda i: cos(logits("bf16", fault, i),
                                             logits("fp32", "plain", i)))
                           .mean())
        for fault in faults}
    extra_fields = {}
    if moe:
        route = {}
        for dt in ("bf16", "fp32"):
            per_layer = [agreement(runs[(dt, "kernel", i)][1],
                                   runs[(dt, "plain", i)][1])
                         for i in range(n)]
            layer = [min(v[j] for v in per_layer) for j in range(L)]
            route[dt] = dict(min=min(layer), mean=sum(layer) / L,
                             by_layer=[round(v, 6) for v in layer])
        extra_fields["route_agreement"] = route
    if encdec:
        def enc_cos(a):
            return F.cosine_similarity(enc[a], enc["fp32 plain"], dim=-1)
        enc32 = enc_cos("fp32 kernel")
        enc_dist = {a: 1.0 - float(enc_cos(a).mean())
                    for a in ("bf16 kernel", "bf16 plain", "bf16 coarse")}
        enc_bound = BF16_RATIO * enc_dist["bf16 plain"] + BF16_SLACK
        extra_fields["encoder"] = dict(
            positions=int(enc32.numel()), fp32_cosine_min=float(enc32.min()),
            bf16_kernel_distance=enc_dist["bf16 kernel"],
            bf16_plain_distance=enc_dist["bf16 plain"],
            bf16_coarse_kernel_distance=enc_dist["bf16 coarse"],
            bf16_distance_bound=enc_bound)
    emit("plain_" + family, positions=int(c32.numel()),
         fp32_cosine_min=float(c32.min()), fp32_cosine_mean=float(c32.mean()),
         fp32_top1_agreement=t32,
         bf16_cosine_min=float(c16.min()), bf16_cosine_mean=float(c16.mean()),
         bf16_kernel_to_fp32_cosine_mean=float(k16.mean()),
         bf16_plain_to_fp32_cosine_mean=float(p16.mean()),
         bf16_kernel_distance=k_dist, bf16_plain_distance=p_dist,
         bf16_distance_bound=bound16,
         bf16_coarse_kernel_distance={f"{k} {b} bits": d
                                      for (k, b), d in fault_dist.items()},
         **extra_fields, min_cosine=MIN_COSINE, min_top1=MIN_TOP1,
         bf16_ratio=BF16_RATIO, bf16_slack=BF16_SLACK)
    check(float(c32.min()) >= MIN_COSINE,
          f"fp32 cosine {float(c32.min())} < {MIN_COSINE}")
    check(t32 >= MIN_TOP1, f"fp32 top-1 agreement {t32} < {MIN_TOP1}")
    check(k_dist <= bound16,
          f"bf16 kernels' distance to the fp32 reference {k_dist} > "
          f"{bound16} (the plain twins' {p_dist})")
    kernel, bits = faults[-1]
    check(fault_dist[faults[-1]] > bound16,
          f"{kernel} keeping {bits} mantissa bits passes the bf16 bound: "
          f"distance {fault_dist[faults[-1]]} <= {bound16}")
    if encdec:
        check(float(enc32.min()) >= MIN_COSINE,
              f"fp32 encoder output, kernels against plain twins: cosine "
              f"{float(enc32.min())} < {MIN_COSINE}")
        check(enc_dist["bf16 kernel"] <= enc_bound,
              f"bf16 encoder output's distance to the fp32 reference "
              f"{enc_dist['bf16 kernel']} > {enc_bound}")
        check(enc_dist["bf16 coarse"] > enc_bound,
              f"{kernel} keeping {bits} mantissa bits passes the bf16 "
              f"encoder bound: distance {enc_dist['bf16 coarse']} <= "
              f"{enc_bound}")
    if not handoffs:
        return
    h32, h16 = torch.cat(h32), torch.cat(h16)   # (sequences, n), (.., 2)
    faulty = torch.cat(faulty) if faulty else None
    emit("handoff_" + family, sequences=int(h32.shape[0]),
         fp32_cosine_min=float(h32.min()),
         fp32_cosine_min_by_step=[float(v) for v in h32.min(0)[0]],
         bf16_handoff_cosine_min_by_step=[float(v) for v in h16.min(0)[0]],
         **({} if faulty is None else
            {"neighbour_cross_kv_cosine_max": float(faulty.max())}),
         min_cosine=MIN_COSINE)
    hold_handoff(h32, h16, faulty=faulty)


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
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as stk
    from repro_torch.serve.engine import BatchingFrontend, ServeEngine
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    base = get_config(RING_ARCH)
    cfg = dataclasses.replace(base, num_layers=2,
                              capacity_factor=float(base.num_experts))
    check(stk.use_ring_cache(cfg), "mixtral should decode over a ring")
    L, W = cfg.num_layers, cfg.sliding_window

    t0 = time.perf_counter()
    model = seeded_model(torch, cfg)
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
    h16, _ = handoff(torch, F, model, pt, ft[:, :2],
                     decoded=torch.stack(k16[:2], 1))          # (B, 2)
    del model, engine
    torch.cuda.empty_cache()
    with fp32_model(torch, cfg) as m32:
        c32, full32 = handoff(torch, F, m32, pt, ft,
                              kv_dtype=torch.float32)          # (B, 33)
        before = (fa.flash_attention.launches, rn.rmsnorm.launches)
        with plain_kernels(ops, fa, rn, ss):
            plain32 = full_sequence_logits(torch, m32, seq, S - 1)
        check((fa.flash_attention.launches, rn.rmsnorm.launches) == before,
              "the plain run launched a kernel")
        del m32
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
    hold_handoff(c32, h16)
    check(float(cp.min()) >= MIN_COSINE and tp >= MIN_TOP1,
          f"fp32 full forward, kernels against plain twins: cosine "
          f"{float(cp.min())}, top-1 agreement {tp}")
    return launches


def hybrid_window_path(torch, np, F, modules) -> dict:
    """Phase 6e: hymba-1.5b (published config, uncut) past its window.
    Two prompts of ``WINDOW_PROMPT`` text tokens (1,664 internal
    positions with the 128 meta tokens, past the 1,024 window) and 32 new
    tokens through ``ServeEngine.generate``, with exact launches (flash on
    the 3 global layers and the scan on all 32 a prefill, rmsnorm 161 a
    forward).  The K/V cache is not a ring: the windowed layers decode
    over a full-length cache through a window mask that keeps the meta
    tokens visible as sinks.  Then: prefill + 32 teacher-forced decode
    steps against one full-sequence forward of 1,696 internal positions,
    in fp32 over an fp32 K/V cache at every position and in bf16 on the
    served model at the handoff, each to ``MIN_COSINE``.  The fp32 model
    runs the scalar scan kernel; only the bf16 handoff holds the final
    state the bf16 stage kernels hand to decode, so a slot handed its
    neighbour's state must fail its bound, and the plain twins' own bf16
    handoff is read beside it.  Then the window control.  Random weights
    attend nearly uniformly, so the logits barely see which keys a mask
    keeps: the first windowed layer's attention output at the prompt
    (1,664 queries, ``ref.mha_chunked``) and at the last decode step
    (``ref.mha`` over the cache), recorded from the fp32 run, is held
    against an independent masked SDPA with the right window and sinks
    (``MIN_COSINE`` at every row), and the same SDPA with the sinks
    dropped and with half the window must fail that bound.
    Returns the launches of the serving run."""
    from repro_torch.configs import get_config
    from repro_torch.models import stack as stk
    from repro_torch.serve.engine import ServeEngine
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    cfg = get_config(HYBRID_ARCH)
    L, W, M = cfg.num_layers, cfg.sliding_window, cfg.num_meta_tokens
    S, Bw = WINDOW_PROMPT, WINDOW_BATCH
    check(not stk.use_ring_cache(cfg), "hymba should not decode over a ring")
    check(S + M > W, f"{S} + {M} positions do not pass the window {W}")

    model = seeded_model(torch, cfg)
    max_len = S + NEW_TOKENS + 8
    engine = ServeEngine(model, max_batch=Bw, max_len=max_len,
                         device="cuda")
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (Bw, S)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = rn.rmsnorm.launches = 0
    ss.ssd_scan.launches = 0
    res = engine.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.flash_attention.launches,
                "rmsnorm": rn.rmsnorm.launches,
                "ssd_scan": ss.ssd_scan.launches}
    expect = {"flash_attention": len(cfg.global_attn_layers),
              "rmsnorm": (5 * L + 1) * res.steps, "ssd_scan": L}
    cache_slots = model.init_cache(Bw, max_len)["k"].shape[2]
    emit("hybrid_window", arch=cfg.name, window=W, sinks=M,
         prompt_tokens=S, internal_positions=S + M, cache_slots=cache_slots,
         prefill_s=res.prefill_s, decode_s=res.decode_s,
         decode_tokens_per_s=res.tokens_per_second,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, expected_launches=expect)
    check(launches == expect,
          f"kernel launches {launches}, the path implies {expect}")
    check(cache_slots == max_len + M,
          f"{cache_slots} cache slots for {max_len} + {M} positions")
    check(res.tokens.shape == (Bw, NEW_TOKENS) and res.tokens.min() >= 0
          and res.tokens.max() < cfg.vocab_size, f"bad answer {res.tokens}")

    def cos(a, b):
        return F.cosine_similarity(a, b, dim=-1)

    pt = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    extra = rng.integers(0, cfg.vocab_size, (Bw, 1))
    ft = torch.as_tensor(np.concatenate([res.tokens, extra], axis=1),
                         dtype=torch.long, device="cuda")      # (B, 33)
    n = ft.shape[1]
    seq = torch.cat([pt, ft[:, :-1]], dim=1)                   # 1,568 text
    h16, full16 = handoff(torch, F, model, pt, ft[:, :2])     # (B, 2)
    # what the bf16 decode bound separates: each slot handed its
    # neighbour's final SSM state; and the plain twins' own bf16 handoff
    rolled = cos(neighbour_state_logits(torch, model, pt, ft), full16[:, 1])
    before = (fa.flash_attention.launches, rn.rmsnorm.launches,
              ss.ssd_scan.launches)
    with plain_kernels(ops, fa, rn, ss):
        p16, _ = handoff(torch, F, model, pt, ft[:, :2])
    check((fa.flash_attention.launches, rn.rmsnorm.launches,
           ss.ssd_scan.launches) == before, "the plain run launched a kernel")
    del model, engine
    torch.cuda.empty_cache()

    # the first windowed layer's attention calls in the fp32 run
    first_windowed = stk.global_flags(cfg).index(False)
    calls, orig = [], ops.attention

    def recording(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        if kw.get("num_sink"):
            calls.append((q, k, v, kw, out))
        return out

    with fp32_model(torch, cfg) as m32:
        ops.attention = recording
        try:
            k32 = forced_logits(torch, m32, pt, ft, kv_dtype=torch.float32)
        finally:
            ops.attention = orig
        c32, _ = handoff(torch, F, m32, pt, ft, decoded=k32)    # (B, 33)
        del m32
    windowed = L - len(cfg.global_attn_layers)
    check(len(calls) == windowed * n,
          f"{len(calls)} windowed attention calls, {windowed * n} expected")
    # the first windowed layer's calls: the prompt's and the last step's
    layer_calls = calls[::windowed]
    prompt_call, step_call = layer_calls[0], layer_calls[-1]
    del calls

    def sdpa_rows(call, window, sinks):
        """Per (batch, query, head) row: the recorded output's cosine to a
        masked SDPA of the same q, k, v where query p sees key j iff
        j <= p and (p - j < window or j < sinks)."""
        q, k, v, kw, out = call
        T = k.shape[1]
        q_pos = kw.get("q_pos")
        if q_pos is None:
            q_pos = torch.arange(q.shape[1], device="cuda")[None]
        j = torch.arange(T, device="cuda")[None, None, :]
        p = q_pos[:, :, None]
        visible = (j <= p) & ((p - j < window) | (j < sinks))
        ref = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=visible[:, None], enable_gqa=True).transpose(1, 2)
        return cos(out.float(), ref.float())                  # (B, S, H)

    control = {}
    for name, call in (("prompt", prompt_call), ("last_step", step_call)):
        control[name] = {
            "right": float(sdpa_rows(call, W, M).min()),
            "no_sinks": float(sdpa_rows(call, W, 0).min()),
            "half_window": float(sdpa_rows(call, W // 2, M).min())}
    emit("hybrid_window_vs_full", positions=int(c32.numel()),
         full_sequence=int(seq.shape[1]) + M,
         fp32_cosine_min=float(c32.min()),
         fp32_cosine_min_by_step=[float(v) for v in c32.min(0)[0]],
         bf16_handoff_cosine_min_by_step=[float(v) for v in h16.min(0)[0]],
         bf16_plain_handoff_cosine_min_by_step=[
             float(v) for v in p16.min(0)[0]],
         bf16_neighbour_state_cosine_max=float(rolled.max()),
         window_layer=first_windowed,
         window_control_cosine_min=control, min_cosine=MIN_COSINE)
    hold_handoff(c32, h16, faulty=rolled)
    for name, c in control.items():
        check(c["right"] >= MIN_COSINE,
              f"{name}: windowed attention against the masked SDPA: "
              f"cosine {c['right']} < {MIN_COSINE}")
        check(c["no_sinks"] < MIN_COSINE and c["half_window"] < MIN_COSINE,
              f"{name}: a wrong mask passes the window check: {c}")
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


class _Tap:
    """The Trainer's batch iterator over a live stream, keeping a host copy
    of every batch the consumer takes (the stream stays the loader's live
    one, which the fleet agent reads)."""

    def __init__(self, stream, sink):
        self.stream, self.sink = stream, sink

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.stream)
        self.sink.append({k: (v.device.type, v.cpu().numpy())
                          for k, v in batch.items()})
        return batch

    def close(self):
        self.stream.close()


def merge_check(seq, regular, makeup):
    """Walk ``seq`` (index lists, in order) against two queues: the
    regular slices the samplers name, in order, and the makeup chunks
    dealt, in order.  Every entry must be the next of one of them.
    Returns (entries matched as regular, as makeup, the first mismatch's
    position or None)."""
    r = m = 0
    for k, idx in enumerate(seq):
        if r < len(regular) and idx == regular[r]:
            r += 1
        elif m < len(makeup) and idx == makeup[m]:
            m += 1
        else:
            return r, m, k
    return r, m, None


def fleet_train_path(torch, np, tdata, modules) -> dict:
    """Phase 15: the fleet control plane with a full-width mamba2-780m
    ``Trainer`` on the card as host 0, attached with ``connect_fleet``, and
    two host-side loaders attached with ``connect_host``, over a
    ``FaultyTransport`` (seeded drops and duplicates) to a
    ``CoordinatorServer`` with a standby ``CoordinatorReplica``, a
    ``LeaderLease`` and a ``SnapshotStore``.  host0's agent's ``observe``
    is wrapped so that every card step ends with one fleet round: the
    peers' batches and reports, the pump, the leader's tick and poll, the
    standby's watch.  Events in order: a startup consensus pushed to every
    host, a straggler re-consensus after host1 degrades, host2's death and
    one reshard with makeup, the geometry latch and the LR rescale at the
    next epoch, the leader's crash, the standby's promotion and a stale
    command rejected.  Returns the launches of the card's steps."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.cluster import FleetEvent, FleetSchedule
    from repro_torch.core.evaluators import LoaderEvaluator
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.tuning import (FaultSpec, FaultyTransport, FleetConfig,
                                    FleetCoordinator, GoodputMonitor,
                                    LeaderLease, LinkConfig, SnapshotStore,
                                    StaleLeaderError, connect_host)
    from repro_torch.tuning.fleet import CoordinatorReplica, CoordinatorServer
    from repro_torch.tuning.transport import to_wire
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    cfg = get_config(TRAIN_ARCH)
    L = cfg.num_layers
    n = FLEET_GB * FLEET_BPE
    t_phase = time.perf_counter()

    raw = tdata.token_dataset(n, TRAIN_SEQ, FLEET_VOCAB, seed=0)
    row_of = {raw.storage.read(i).tobytes(): i for i in range(n)}

    def indices(batch):
        rows_ = np.concatenate([batch["tokens"], batch["targets"][:, -1:]], 1)
        return [row_of.get(r.astype(np.int32).tobytes(), -1) for r in rows_]

    # ---- the control plane ------------------------------------------------
    clock = [0.0]
    ck = lambda: clock[0]  # noqa: E731
    transport = FaultyTransport(FaultSpec(drop=0.02, duplicate=0.02, seed=5))
    lease = LeaderLease(ttl_s=FLEET_TTL, clock=ck)
    store = SnapshotStore()
    coord = FleetCoordinator(
        config=FleetConfig(heartbeat_timeout_s=FLEET_TIMEOUT,
                           warmup_steps=2, cooldown_steps=2,
                           straggler_window=2, num_cpu_cores=2,
                           num_devices=1, max_prefetch=1,
                           retune_budget_batches=2),
        clock=ck)
    servers = [CoordinatorServer(coord, transport, owner="coord-0",
                                 lease=lease, store=store)]
    replica = CoordinatorReplica(transport, lease, store,
                                 owner="coord-standby", clock=ck)

    # ---- the hosts: host0 the Trainer on the card, host1 / host2 loaders ---
    storages = [tdata.LatencyStorage(raw.storage, latency_s=FLEET_LATENCY_S,
                                     bandwidth=1e9) for _ in range(3)]
    loaders = [tdata.DataLoader(
        raw.with_storage(storages[h]), FLEET_GB, shuffle=True, seed=0,
        host_index=h, host_count=3, device="cuda",
        params=tdata.LoaderParams(num_workers=1, prefetch_factor=1,
                                  device_prefetch=1)) for h in range(3)]
    old_sampler = copy.deepcopy(loaders[0].sampler)
    tc = trainer_mod.TrainerConfig(
        total_steps=FLEET_MAX_ROUNDS, log_every=1, seed=0, autotune=False,
        step_config=TrainStepConfig(
            remat_policy="none",
            optimizer=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                  total_steps=100)))
    tr = trainer_mod.Trainer(cfg, loaders[0], tc, host_name="host0",
                             device="cuda")
    agent = tr.connect_fleet(transport, clock=ck,
                             link_config=LinkConfig(seed=0, jitter=0.0))
    agent.monitor = GoodputMonitor(window=FLEET_WINDOW)
    peers = [connect_host(transport, f"host{h}", loaders[h],
                          evaluator=LoaderEvaluator(loaders[h],
                                                    to_device=False),
                          clock=ck, window=FLEET_WINDOW,
                          link_config=LinkConfig(seed=h, jitter=0.0))
             for h in (1, 2)]
    dealt = []                          # makeup chunks dealt to host0
    real_add_makeup = agent.add_makeup

    def add_makeup(makeup, *, op_id=None):
        dealt.extend(np.asarray(c).tolist() for c in makeup)
        return real_add_makeup(makeup, op_id=op_id)
    agent.add_makeup = add_makeup

    events, seen = [], set()             # (round, event), by the log's seq
    st = dict(round=0, healed=None, crash=None, old=None, stale=None,
              stop=None)

    def log_events():
        for e in servers[0].coord.events:
            if e["seq"] not in seen:
                seen.add(e["seq"])
                events.append((st["round"], dict(e)))

    def of_kind(kind, reason=""):
        return [(r, e) for r, e in events if e["kind"] == kind
                and str(e.get("reason", "")).startswith(reason)]

    # ---- 1. the startup consensus: host0's trials on the card's edge -------
    t0 = time.perf_counter()
    for _ in range(3):                   # a dropped trial aborts the run
        coord.request_consensus(reason="startup")
        servers[0].poll()
        log_events()
        if of_kind("consensus", "startup"):
            break
    startup_s = time.perf_counter() - t0
    cells_after_startup = [dl.params.num_workers for dl in loaders], [
        dl.params.prefetch_factor for dl in loaders]

    # ---- 2-4. the rounds: one card step and one fleet round each -----------
    schedule = FleetSchedule([
        FleetEvent(step=FLEET_DEGRADE_AT, kind="degrade", host="host1",
                   io_scale=FLEET_DEGRADE)])
    alive = {"host1", "host2"}
    streams = [p.loader.stream(to_device=False) for p in peers]
    peer_seen = {"host1": [], "host2": []}   # (indices, position or None)
    rounds_ = []
    real_observe = agent.observe

    def fleet_round(compute_s):
        st["round"] += 1
        r = st["round"]
        clock[0] += 1.0
        for ev in schedule.at(r):
            storages[1].latency_s *= ev.io_scale
        if st["healed"] is not None and r >= FLEET_DEATH_AT:
            alive.discard("host2")           # host2 falls silent
        waits = {}
        for p, s in zip(peers, streams):
            if p.host not in alive:
                continue
            before = s.position
            t1 = time.perf_counter()
            batch = next(s)
            waits[p.host] = time.perf_counter() - t1
            peer_seen[p.host].append(
                (indices(batch), before if s.position > before else None))
            # a peer steps the same model as the card in lockstep
            p.observe(data_s=waits[p.host],
                      step_s=waits[p.host] + compute_s)
        transport.pump()
        servers[0].tick()
        servers[0].poll()
        promoted = replica.tick()
        if promoted is not None:
            servers.insert(0, promoted)
        log_events()
        rounds_.append(dict(round=r, peer_wait_s=waits))
        if st["healed"] is None and of_kind("consensus", "straggler"):
            storages[1].latency_s = FLEET_LATENCY_S   # host1's recovers
            st["healed"] = r
        resh = of_kind("reshard")
        if st["crash"] is None and resh \
                and r >= resh[0][0] + FLEET_CRASH_AFTER:
            st["old"] = servers[0]
            st["old_fence"] = servers[0].fence
            servers[0].crash()
            st["crash"] = r
        if (st["stale"] is None and replica.promoted
                and agent.link.fence == servers[0].fence):
            try:
                st["old"].send("host0", "ping", {})
                st["stale"] = "accepted"
            except StaleLeaderError as e:
                st["stale"] = str(e)
            st["stale_round"] = r
        if (st["stop"] is None and st["stale"] is not None
                and agent.consumed_position() >= FLEET_BPE
                + FLEET_EPOCH1_STEPS):
            st["stop"] = r
            tr.cfg.total_steps = agent.steps     # this step is the last

    def observe(*, data_s, step_s):
        real_observe(data_s=data_s, step_s=step_s)
        fleet_round(step_s - data_s)
    agent.observe = observe

    taken = []
    real_stream = loaders[0].stream
    loaders[0].stream = lambda **kw: _Tap(real_stream(**kw), taken)
    step_events = []
    real_make = trainer_mod.make_train_step

    def make_timed(model, config):
        step = real_make(model, config)

        def timed(state, batch):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(state, batch)
            b.record()
            step_events.append((a, b))
            return out
        return timed

    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ss.ssd_scan.launches = rn.rmsnorm.launches = 0
    fa.flash_attention.launches = 0
    trainer_mod.make_train_step = make_timed
    t0 = time.perf_counter()
    try:
        tr.run()
    finally:
        trainer_mod.make_train_step = real_make
        for s in streams:
            s.close()
    run_s = time.perf_counter() - t0
    launches = {"ssd_scan": ss.ssd_scan.launches,
                "rmsnorm": rn.rmsnorm.launches}
    flash = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    device_ms = [a.elapsed_time(b) for a, b in step_events]

    # ---- what the card trained on ------------------------------------------
    steps = [r for r in tr.history if "loss" in r]
    losses = [r["loss"] for r in steps]
    seqs = [indices({k: v for k, (_, v) in b.items()}) for b in taken]
    local = [len(i) for i in seqs]
    on_card = all(d == "cuda" for b in taken for d, _ in b.values())
    unequal = [k for k, (b, idx) in enumerate(zip(taken, seqs))
               if -1 in idx or any(
                   b[f][1].tobytes() != v.tobytes()
                   for f, v in raw.get_batch(idx).items())]
    resh = of_kind("reshard")
    rr, reshard = resh[0] if resh else (None, {})
    barrier = reshard.get("barrier") or 0
    dead_consumed = (reshard.get("dead_consumed") or {}).get("host2", 0)
    new = loaders[0].sampler
    regular = ([old_sampler.local_indices(0, p).tolist()
                for p in range(barrier)]
               + [new.local_indices(0, p).tolist()
                  for p in range(barrier, FLEET_BPE)]
               + [new.local_indices(1, p).tolist()
                  for p in range(new.batches_per_epoch(1))])
    n_reg, n_makeup, bad = merge_check(seqs, regular, dealt)
    # the epoch across the death: host0's old- and new-shard slices and
    # makeup, host1's the same, host2's deliveries up to its last
    # reported position; the control leaves the makeup out
    e0 = regular[:FLEET_BPE]
    h0_regular = [i for i in seqs if i in e0]
    h0_makeup = [i for i in seqs if i in dealt]
    h1_regular = [i for i, pos in peer_seen["host1"]
                  if pos is not None and pos < FLEET_BPE]
    h1_makeup = [i for i, pos in peer_seen["host1"] if pos is None]
    h2 = [i for i, _ in peer_seen["host2"][:dead_consumed]]

    def flat(*groups):
        return sorted(x for g in groups for b in g for x in b)
    coverage = flat(h0_regular, h0_makeup, h1_regular, h1_makeup,
                    h2) == list(range(n))
    control = flat(h0_regular, h1_regular, h2) == list(range(n))
    rescales = [r for r in tr.history if r.get("event") == "lr_rescale"]
    k = next((k for k, r in enumerate(tr.history)
              if r.get("event") == "lr_rescale"), len(tr.history))
    rescale_step = sum(1 for r in tr.history[:k] if "loss" in r)
    first_e1 = next((k for k, i in enumerate(seqs)
                     if i in regular[FLEET_BPE:]), len(seqs))
    promote = of_kind("promote")
    consensus = of_kind("consensus")
    # the pinned staging ring of host0's edge across the shape changes
    pool = loaders[0]._live_stream._prefetcher._staging
    staging = dict(zero_copy=loaders[0].params.zero_copy,
                   hits=pool.hits if pool else None,
                   misses=pool.misses if pool else None,
                   retired=pool.retired if pool else None)
    stats = dict(
        sent_msgs=transport.sent_msgs, sent_bytes=transport.sent_bytes,
        kind_msgs=dict(transport.kind_msgs), dropped=transport.dropped,
        duplicated=transport.duplicated,
        report_full=[[s.report_full_msgs, s.report_full_bytes]
                     for s in servers],
        report_delta=[[s.report_delta_msgs, s.report_delta_bytes]
                      for s in servers])
    emit("fleet_train", arch=cfg.name, layers=L, seq=TRAIN_SEQ,
         global_batch=FLEET_GB, batches_epoch0=FLEET_BPE,
         storage_latency_s=FLEET_LATENCY_S, rounds=st["round"],
         card_steps=len(losses), agent_steps=agent.steps,
         startup_consensus_s=startup_s,
         cells_after_startup=cells_after_startup,
         events=to_wire([dict(round=r, **{
             k: v for k, v in e.items()
             if k in ("kind", "reason", "params", "cell_applied", "lost",
                      "barrier", "geometry_epoch", "makeup_batches",
                      "dead_consumed", "fence", "sizes", "seq")})
             for r, e in events]),
         plan=str(reshard.get("plan")), healed_round=st["healed"],
         crash_round=st["crash"], stale_round=st.get("stale_round"),
         stale=st["stale"], stop_round=st["stop"],
         fences=[st.get("old_fence"), servers[0].fence, agent.link.fence],
         link_rejected=[r["fence"] for r in agent.link.rejected],
         local_batch=local, step_s=[r["step_s"] for r in steps],
         data_s=[r["data_s"] for r in steps], device_ms=device_ms,
         lr=[r["lr"] for r in steps], losses=losses,
         lr_rescale=rescales, lr_rescale_from_step=rescale_step,
         first_epoch1_step=first_e1, peer_rounds=to_wire(rounds_),
         makeup_dealt_to_host0=len(dealt), dead_consumed=dead_consumed,
         coverage_exact=coverage, control_without_makeup_exact=control,
         merge=dict(regular=n_reg, makeup=n_makeup, mismatch_at=bad),
         bytes_unequal=unequal, staging=staging,
         mem_before_run_bytes=mem_before, peak_mem_bytes=peak, run_s=run_s,
         phase_s=time.perf_counter() - t_phase, transport=stats,
         launches=launches, expected_launches={
             "ssd_scan": L * len(losses),
             "rmsnorm": (2 * L + 1) * len(losses)},
         flash_attention_launches=flash)

    # ---- the checks ------------------------------------------------------
    check(st["stop"] is not None, f"the scenario did not finish in "
          f"{FLEET_MAX_ROUNDS} rounds: {st}")
    start = of_kind("consensus", "startup")
    check(len(start) == 1 and start[0][1]["cell_applied"],
          f"startup consensus: {start}")
    cell = list(start[0][1]["params"])
    check([list(c) for c in zip(*cells_after_startup)] == [cell] * 3,
          f"startup cell {cell} not on every host: {cells_after_startup}")
    strag = of_kind("consensus", "straggler")
    check(strag and strag[0][1]["reason"] == "straggler-divergence:host1"
          and strag[0][0] >= FLEET_DEGRADE_AT,
          f"straggler consensus: {strag}")
    before = [e for r, e in consensus if r < FLEET_DEGRADE_AT
              and e["reason"] != "startup"]
    check(not before, f"consensus before the degradation: {before}")
    check(len(resh) == 1 and reshard["reason"] == "dead"
          and reshard["lost"] == ["host2"] and rr >= FLEET_DEATH_AT
          and dead_consumed < barrier < FLEET_BPE,
          f"reshards: {[e for _, e in resh]}")
    check(reshard["geometry_epoch"] == 1
          and reshard["plan"].new_global_batch == 8
          and loaders[0].global_batch == 8
          and new.gb_for_epoch(0) == FLEET_GB and new.gb_for_epoch(1) == 8,
          f"geometry latch: {reshard}")
    tails = {6} | {len(c) for c in dealt}     # a ragged last makeup chunk
    check(local[:barrier] == [4] * barrier
          and set(local[barrier:first_e1]) <= tails
          and local[first_e1:] == [4] * (len(local) - first_e1),
          f"host0's local batches {local} (barrier {barrier})")
    check(len(rescales) == 1 and abs(rescales[0]["scale"] - 8 / 12) < 1e-12
          and abs(rescales[0]["peak_lr"] - 1e-3 * 8 / 12) < 1e-15,
          f"LR rescale: {rescales}")
    check(len(promote) == 1 and promote[0][0] > rr
          and promote[0][1]["fence"] == st["old_fence"] + 1
          and agent.link.fence == st["old_fence"] + 1,
          f"promotion: {promote}, fences {st.get('old_fence')} -> "
          f"{agent.link.fence}")
    check(str(st["stale"]).startswith("coord(fence=")
          and agent.link.rejected
          and agent.link.rejected[-1]["fence"] == st["old_fence"],
          f"the old leader's command was not rejected: {st['stale']}")
    check(on_card, "a batch host0 trained on was not on the card")
    check(not unequal, f"card batches {unequal} differ from their host "
          f"batches")
    check(bad is None and n_makeup == len(dealt) and dealt
          and n_reg == len(seqs) - n_makeup,
          f"host0's batches against its samplers: regular {n_reg}, makeup "
          f"{n_makeup} of {len(dealt)}, first mismatch at {bad}")
    check(coverage, "the epoch across the death is not covered exactly once")
    check(not control, "the tally without the makeup covers the epoch")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"loss did not fall: {losses}")
    check(agent.steps == st["round"] == len(losses) == len(taken),
          f"steps {agent.steps}, rounds {st['round']}, losses "
          f"{len(losses)}, batches {len(taken)}")
    check(launches == {"ssd_scan": L * len(losses),
                       "rmsnorm": (2 * L + 1) * len(losses)},
          f"fleet_train launches {launches} over {len(losses)} steps")
    check(flash == 0, "mamba2 launched attention")
    tr.state = tr.step_fn = None         # the next phase needs the memory
    return launches


def fleet_serve_path(torch, np, tdata, modules) -> dict:
    """Phase 16: a full-width qwen2-0.5b ``BatchingFrontend`` on the card
    attached to a fleet with ``connect_fleet(transport, loader,
    host="serve0")`` beside one host-side peer, over a ``LocalTransport``.
    Its feature loader delivers to the card and is read once per served
    group.  serve0's agent's ``observe`` (one a served batch) is wrapped to
    run the fleet round: the peer's batch and report, the pump, the tick
    and poll, then serve0's feature batch; its ``heartbeat`` (the idle
    frontend's) is counted.  A ``BatchMixMonitor`` asks the fleet for a
    re-consensus when the shape mix moves, which pushes a cell into the
    feature loader while serving.  Returns the launches of the served
    run."""
    from repro_torch.configs import get_config
    from repro_torch.core.evaluators import LoaderEvaluator
    from repro_torch.serve.engine import (BatchingFrontend, BatchMixMonitor,
                                          ServeEngine)
    from repro_torch.tuning import (FleetConfig, FleetCoordinator,
                                    LocalTransport, connect_host)
    from repro_torch.tuning.fleet import CoordinatorServer
    from repro_torch.tuning.transport import to_wire
    fa, rn = modules["fa"], modules["rn"]
    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    model = seeded_model(torch, cfg)
    rng = np.random.default_rng(0)
    by_len = {}
    for plen, count in REQUESTS:       # the serve phase's 20 prompts
        by_len.setdefault(plen, []).extend(
            rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
            for _ in range(count))
    waves = []
    for plen, count in FLEET_SERVE_WAVES:
        waves.append(by_len[plen][:count])
        by_len[plen] = by_len[plen][count:]
    results = []

    class RecordingEngine(ServeEngine):
        def generate(self, prompts_, max_new_tokens, *, seed=0):
            res = super().generate(prompts_, max_new_tokens, seed=seed)
            results.append((np.array(prompts_), res))
            return res

    max_len = max(p for p, _ in REQUESTS) + NEW_TOKENS + 8
    engine = RecordingEngine(model, max_batch=MAX_BATCH, max_len=max_len,
                             device="cuda")
    engine.generate(np.stack(waves[1][:MAX_BATCH]), 4)       # warm-up
    results.clear()

    # ---- the fleet: serve0 and one host-side peer -----------------------
    clock = [0.0]
    ck = lambda: clock[0]  # noqa: E731
    transport = LocalTransport()
    coord = FleetCoordinator(
        config=FleetConfig(heartbeat_timeout_s=30.0, warmup_steps=10_000,
                           num_cpu_cores=2, num_devices=1, max_prefetch=1,
                           retune_budget_batches=2),
        clock=ck)
    server = CoordinatorServer(coord, transport, owner="coord-0")
    ingested = []
    real_ingest = coord.ingest

    def ingest(report):
        ingested.append((report.host, report.steps))
        return real_ingest(report)
    coord.ingest = ingest
    raw = tdata.synthetic_image_dataset(FLEET_FEATURES, FLEET_FEATURE_RES,
                                        seed=0)

    def loader(h):
        return tdata.DataLoader(
            edge_dataset(tdata, 2e-3, 1e9, raw), FLEET_FEATURE_BATCH,
            shuffle=True, seed=0, host_index=h, host_count=2, device="cuda",
            params=tdata.LoaderParams(num_workers=1, prefetch_factor=1))
    peer_loader = loader(1)
    peer = connect_host(transport, "host1", peer_loader,
                        evaluator=LoaderEvaluator(peer_loader,
                                                  to_device=False),
                        clock=ck)
    features = loader(0)
    frontend = BatchingFrontend(engine, max_wait_s=0.05)
    agent = frontend.connect_fleet(transport, features, host="serve0",
                                   clock=ck)
    frontend.mix_monitor = BatchMixMonitor(
        window=1, threshold=0.3, cooldown=2,
        on_drift=lambda mix: agent.notify_drift("batch-mix"))
    stream = features.stream(to_device=True)
    peer_stream = peer_loader.stream(to_device=False)
    served, beats = [], [0]
    real_observe, real_beat = agent.observe, agent.heartbeat

    def observe(*, data_s, step_s):
        real_observe(data_s=data_s, step_s=step_s)
        clock[0] += 1.0
        next(peer_stream)
        peer.observe(data_s=0.001, step_s=step_s)
        transport.pump()
        server.tick()
        server.poll()
        # the stream is read once a served group, after the poll: a cell
        # pushed in this round swaps in at this batch's boundary
        batch = next(stream)
        served.append(dict(position=len(served),
                           cell=list(agent.param_cell()),
                           batch={k: (v.device.type, v.cpu().numpy())
                                  for k, v in batch.items()}))

    def heartbeat():
        beats[0] += 1
        real_beat()
    agent.observe, agent.heartbeat = observe, heartbeat

    fa.flash_attention.launches = rn.rmsnorm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs = []
    t0 = time.perf_counter()
    try:
        for wave in waves:
            reqs = [frontend.submit(p, NEW_TOKENS) for p in wave]
            outs += [r.result.get(timeout=600) for r in reqs]
            time.sleep(0.3)              # idle: the frontend heartbeats
    finally:
        frontend.shutdown()
        frontend._thread.join(timeout=30)
        stream.close()
        peer_stream.close()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "rmsnorm": rn.rmsnorm.launches}
    peak = torch.cuda.max_memory_allocated()

    # ---- the same groups through the engine with no fleet ---------------
    unequal = []
    for k, (prompts, res) in enumerate(list(results)):
        again = ServeEngine.generate(engine, prompts, NEW_TOKENS)
        if not np.array_equal(again.tokens, res.tokens):
            unequal.append(k)
    L = cfg.num_layers
    batches = len(results)
    steps = sum(r.steps - 1 for _, r in results)
    expect = {"flash_attention": L * batches,
              "rmsnorm": (2 * L + 1) * (batches + steps)}
    consensus = [e for e in coord.events if e["kind"] == "consensus"]
    cell = list(consensus[0]["params"]) if consensus else None
    sampler = features.sampler
    feature_unequal = [
        k for k, s in enumerate(served)
        if any(s["batch"][f][0] != "cuda"
               or s["batch"][f][1].tobytes() != v.tobytes()
               for f, v in raw.get_batch(sampler.local_indices(
                   *divmod(s["position"],
                           sampler.batches_per_epoch(0)))).items())]
    reports = [s for h, s in ingested if h == "serve0"]
    emit("fleet_serve", arch=cfg.name, requests=len(outs),
         waves=[[p, c] for p, c in FLEET_SERVE_WAVES],
         batches_served=frontend.batches_served, reports=reports,
         heartbeats=beats[0], alive=sorted(coord.registry.alive_hosts()),
         consensus=to_wire([{k: e[k] for k in ("reason", "params",
                                                "cell_applied", "hosts")}
                            for e in consensus]),
         cells_served=[s["cell"] for s in served],
         loader_cell=[features.params.num_workers,
                      features.params.prefetch_factor],
         feature_batches=len(served), feature_unequal=feature_unequal,
         tokens_unequal_to_engine=unequal, wall_s=wall_s,
         prefill_s=[r.prefill_s for _, r in results],
         decode_s=[r.decode_s for _, r in results],
         peak_mem_bytes=peak, transport=dict(
             sent_msgs=transport.sent_msgs, sent_bytes=transport.sent_bytes,
             kind_msgs=dict(transport.kind_msgs)),
         launches=launches, expected_launches=expect,
         phase_s=time.perf_counter() - t_phase)
    check(len(outs) == sum(len(w) for w in waves) and all(
        o.shape == (NEW_TOKENS,) and 0 <= o.min() and o.max() < cfg.vocab_size
        for o in outs), "not every request was answered")
    check(frontend.batches_served == len(FLEET_SERVE_WAVES) == batches,
          f"{frontend.batches_served} batches served for "
          f"{len(FLEET_SERVE_WAVES)} waves")
    check(reports == list(range(1, batches + 1)),
          f"serve0's reports {reports} for {batches} served batches")
    check(beats[0] > 0 and "serve0" in coord.registry.alive_hosts(),
          f"heartbeats {beats[0]}, alive {coord.registry.alive_hosts()}")
    check(len(consensus) == 1 and consensus[0]["reason"] == "batch-mix"
          and consensus[0]["cell_applied"],
          f"batch-mix consensus: {consensus}")
    check(cell == list(agent.param_cell()) and served[0]["cell"] != cell
          and served[-1]["cell"] == cell,
          f"pushed cell {cell}; cells while serving "
          f"{[s['cell'] for s in served]}")
    check(not unequal, f"groups {unequal} differ from the engine's tokens")
    check(len(served) == batches and not feature_unequal,
          f"feature batches {feature_unequal} differ from their host "
          f"batches ({len(served)} read)")
    check(launches == expect,
          f"fleet_serve launches {launches}, the path implies {expect}")
    del engine, model
    return launches


def dp_train_path(torch, np, modules) -> dict:
    """Phase 17: the data-parallel step on the card, over a one-rank NCCL
    group joined through a ``FileStore`` in a temporary directory (no
    network), under ``use_rules(make_local_mesh(), rules_for("train"))``:
    full-width mamba2-780m from phase 7's seeded masters and batch,
    ``dp_manual`` with DP_MICROBATCHES microbatches, remat "none", bf16
    compute.  Checks, each fatal: (1) one dp step against the plain step
    over the whole batch from identical masters (loss, gradient norm,
    every leaf's update cosine) and (2) a control without the deferred
    scale's 1/n_mb, which must fail check 1; (3) launches exactly 48
    ssd_scan and 97 rmsnorm a microbatch, no flash; (4) ``compressed_psum``
    over the step's gradients on NCCL equal to ``compress_decompress``,
    mean and error feedback, over two steps of error feedback; (5) a
    sharded checkpoint restored through ``restore(shardings=)`` bit-equal.
    Then DP_STEPS timed steps (step s, tokens/s, peak memory), one
    profiled step (idle share) and the collectives a step issues beside
    the count the design implies; and, recorded only, the plain step at
    REMAT_BATCH x 2048 under remat "full".  World size 1 runs the NCCL
    path and the sharded optimizer and restore, not cross-rank traffic.
    Returns the launches of the timed steps."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed import dp_shard, grad_compress
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step,
                                              shard_train_state)
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))

    # an earlier phase's reference cycle can hold a 9.4 GB state
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    L = cfg.num_layers
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=100,
                      eps=DP_ADAM_EPS)
    plain_cfg = TrainStepConfig(remat_policy="none", optimizer=opt)
    dp_cfg = dataclasses.replace(plain_cfg, microbatches=DP_MICROBATCHES,
                                 dp_manual=True)
    rng = np.random.default_rng(0)
    seq = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        dtype=torch.long, device="cuda")
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def masters(c=cfg, seed=0):
        return init_train_state(
            c, torch.Generator(device="cuda").manual_seed(seed), plain_cfg,
            device="cuda")

    def counts():
        return {"ssd_scan": ss.ssd_scan.launches,
                "rmsnorm": rn.rmsnorm.launches,
                "flash_attention": fa.flash_attention.launches}

    def zero():
        ss.ssd_scan.launches = rn.rmsnorm.launches = 0
        fa.flash_attention.launches = 0

    def cosine(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0, eps=1e-30))

    per_step = {"ssd_scan": L * DP_MICROBATCHES,
                "rmsnorm": (2 * L + 1) * DP_MICROBATCHES,
                "flash_attention": 0}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(workdir, "store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda:0"))
    nccl_init_s = time.perf_counter() - t0
    try:
        mesh = make_local_mesh()
        with use_rules(mesh, rules_for("train")) as ctx:
            # ---- 1. one dp step against the plain step ----------------------
            plain = masters()
            init = {k: p.detach().clone() for k, p in plain.params.items()}
            dp = masters()
            check(all(torch.equal(p, init[k])
                      for k, p in dp.params.items()),
                  "the dp and plain states' masters differ")
            dp = shard_train_state(dp, ctx)
            dp_step = make_train_step(dp.model, dp_cfg)
            check(dp_step.path == "dp_manual",
                  f"dp_manual under a mesh took the {dp_step.path} step")
            zero()
            dp_shard.collectives.clear()
            t0 = time.perf_counter()
            dp, m_dp = dp_step(dp, batch)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            first_launches = counts()
            step_collectives = dict(dp_shard.collectives)
            check(first_launches == per_step,
                  f"dp step launches {first_launches}, the path implies "
                  f"{per_step}")
            plain_step = make_train_step(plain.model, plain_cfg)
            check(plain_step.path == "plain", "the plain step is not plain")
            plain, m_plain = plain_step(plain, batch)

            def hold(state, m):
                """Check 1's failures for ``state`` after its step."""
                cos = {k: cosine(p.detach() - init[k],
                                 plain.params[k].detach() - init[k])
                       for k, p in state.params.items()}
                grad_cos = {k: cosine(v, plain.opt.mu[k])
                            for k, v in state.opt.mu.items()}
                loss_rel = abs(float(m["loss"]) - float(m_plain["loss"])) \
                    / abs(float(m_plain["loss"]))
                norm_rel = abs(float(m["grad_norm"])
                               - float(m_plain["grad_norm"])) \
                    / float(m_plain["grad_norm"])
                fails = []
                if loss_rel > MAX_LOSS_REL:
                    fails.append(f"loss rel {loss_rel}")
                if norm_rel > DP_NORM_REL:
                    fails.append(f"grad norm rel {norm_rel}")
                low = sorted(k for k in cos if cos[k] < MIN_GRAD_COSINE)
                if low:
                    fails.append(f"update cosine below {MIN_GRAD_COSINE}: "
                                 f"{low[:5]}")
                worst = sorted(cos, key=cos.get)[:5]
                return fails, dict(
                    loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                    loss_rel=loss_rel, grad_norm_rel=norm_rel,
                    update_cosine_min=min(cos.values()),
                    update_cosine_mean=sum(cos.values()) / len(cos),
                    grad_cosine_min=min(grad_cos.values()),
                    worst_leaves=[dict(leaf=k, cosine=cos[k])
                                  for k in worst])

            fails, held = hold(dp, m_dp)
            check(not fails, f"dp step against the plain step: {fails}")

            # ---- 2. the control: no 1/n_mb in the deferred scale ------------
            ctrl = shard_train_state(masters(), ctx)
            psum = dp_shard.deferred_psum
            dp_shard.deferred_psum = lambda g, plan, scale: psum(
                g, plan, scale * DP_MICROBATCHES)
            try:
                ctrl, m_ctrl = make_train_step(ctrl.model, dp_cfg)(ctrl, batch)
            finally:
                dp_shard.deferred_psum = psum
            ctrl_fails, ctrl_held = hold(ctrl, m_ctrl)
            check(ctrl_fails, "the control without 1/n_mb passed check 1")
            del ctrl, init
            gc.collect()
            torch.cuda.empty_cache()

            # ---- 3-4. timed steps; compressed_psum on the step's gradients ---
            captured = {}

            def keep(g, plan, scale):
                captured.update(psum(g, plan, scale))
                return g

            torch.cuda.reset_peak_memory_stats()
            zero()
            step_s = []
            for i in range(DP_STEPS):
                if i == DP_STEPS - 1:
                    dp_shard.deferred_psum = keep
                try:
                    t0 = time.perf_counter()
                    dp, m = dp_step(dp, batch)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                finally:
                    dp_shard.deferred_psum = psum
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
            expect = {k: v * DP_STEPS for k, v in per_step.items()}
            check(launches == expect,
                  f"dp launches {launches}, the path implies {expect}")
            prof = profile_phase(
                torch, "dp step 4x2048", lambda: dp_step(dp, batch),
                expect=("ssd_scan_chunk_scan_kernel",))
            emit("profile", **prof)

            psum_exact, psum_leaves = True, 0
            err_p = {k: torch.zeros_like(g, dtype=torch.float32)
                     for k, g in captured.items()}
            err_c = {k: e.clone() for k, e in err_p.items()}
            for _ in range(2):                     # two steps of feedback
                for k, g in captured.items():
                    mean, err_p[k] = grad_compress.compressed_psum(g,
                                                                   err_p[k])
                    ref, err_c[k] = grad_compress.compress_decompress(
                        g, err_c[k])
                    psum_exact &= bool(torch.equal(mean, ref)
                                       and torch.equal(err_p[k], err_c[k]))
                    psum_leaves += 1
            check(psum_exact, "compressed_psum at world 1 differs from "
                  "compress_decompress")
            del captured, err_p, err_c

            # the collectives of one step, against the JAX design: a gather
            # and a reduce-scatter per FSDP leaf per microbatch, one
            # all-reduce per remaining leaf per step, and one each for the
            # loss, its three metrics and the norm's sum of squares
            plan = dp.plan
            n_fsdp, n_leaves = len(plan.dims), len(dp.params)
            design = {"all_gather": DP_MICROBATCHES * n_fsdp,
                      "reduce_scatter": DP_MICROBATCHES * n_fsdp,
                      "all_reduce": (n_leaves - n_fsdp) + 5}
            check(step_collectives == design,
                  f"dp step collectives {step_collectives}, the design "
                  f"implies {design}")
            del dp
            gc.collect()
            torch.cuda.empty_cache()

            # ---- 5. a sharded checkpoint, restored with shardings= ----------
            cfg4 = dataclasses.replace(cfg, num_layers=DP_CKPT_LAYERS)
            small = shard_train_state(masters(cfg4, seed=1), ctx)
            small, _ = make_train_step(small.model, dp_cfg)(small, batch)
            ck = Checkpointer(os.path.join(workdir, "ck"))
            t0 = time.perf_counter()
            ck.save(1, small, block=True)
            save_s = time.perf_counter() - t0
            template = shard_train_state(masters(cfg4, seed=2), ctx)
            t0 = time.perf_counter()
            got, aux = ck.restore(template, shardings=template.plan)
            restore_s = time.perf_counter() - t0
            pairs = [(got.params, small.params), (got.opt.mu, small.opt.mu),
                     (got.opt.nu, small.opt.nu)]
            restored_equal = got.opt.step == small.opt.step and all(
                torch.equal(a[k].detach(), b[k].detach())
                for a, b in pairs for k in b)
            check(restored_equal and aux["step"] == 1,
                  "the sharded restore is not bit-equal")
            step_dir = os.path.join(workdir, "ck", "step_00000001")
            ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                             for f in os.listdir(step_dir))
            del small, template, got
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- remat "full" at REMAT_BATCH x 2048, recorded ---------------------
    big = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size,
                                          (REMAT_BATCH, TRAIN_SEQ + 1)),
        dtype=torch.long, device="cuda")
    big = {"tokens": big[:, :-1], "targets": big[:, 1:]}
    full_step = make_train_step(
        plain.model, dataclasses.replace(plain_cfg, remat_policy="full"))
    plain, m = full_step(plain, big)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_s, remat_losses = [], []
    for _ in range(REMAT_STEPS):
        t0 = time.perf_counter()
        plain, m = full_step(plain, big)
        torch.cuda.synchronize()
        remat_s.append(time.perf_counter() - t0)
        remat_losses.append(float(m["loss"]))
    remat_peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(remat_losses)), f"remat losses {remat_losses}")
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    emit("dp_train", arch=cfg.name, world_size=1, backend="nccl",
         mesh={"data": 1, "model": 1}, nccl_init_s=nccl_init_s,
         batch=[TRAIN_BATCH, TRAIN_SEQ], microbatches=DP_MICROBATCHES,
         remat_policy="none", path=dp_step.path,
         check1=dict(held, plain_loss=float(m_plain["loss"]),
                     plain_grad_norm=float(m_plain["grad_norm"]),
                     max_loss_rel=MAX_LOSS_REL, max_grad_norm_rel=DP_NORM_REL,
                     min_update_cosine=MIN_GRAD_COSINE),
         control_no_inv_microbatches=dict(ctrl_held, fails=ctrl_fails),
         first_step_s=first_s, first_step_launches=first_launches,
         step_s=step_s, tokens_per_s=tokens / (sum(step_s) / len(step_s)),
         idle_share=prof["idle_share"], peak_mem_bytes=peak,
         peak_gb=peak / 1e9, launches=launches, expected_launches=expect,
         collectives_per_step=step_collectives,
         collectives_design=design, fsdp_leaves=n_fsdp, leaves=n_leaves,
         compressed_psum=dict(exact=psum_exact, leaf_calls=psum_leaves),
         checkpoint=dict(layers=DP_CKPT_LAYERS, bytes=ckpt_bytes,
                         save_s=save_s, restore_s=restore_s,
                         bit_equal=restored_equal),
         remat_full=dict(batch=[REMAT_BATCH, TRAIN_SEQ], step_s=remat_s,
                         losses=remat_losses, peak_mem_bytes=remat_peak,
                         peak_gb=remat_peak / 1e9))
    return launches


@contextlib.contextmanager
def coarse_backward(fa, torch, bits: int):
    """A faulty flash backward for the block: the kernels' dq, dk and dv
    rounded to ``bits`` mantissa bits.  The kernels still launch, and
    count."""
    saved = fa.backward_kernel

    def coarse(*args, **kwargs):
        return tuple(coarsen(torch, g, bits) for g in saved(*args, **kwargs))

    fa.backward_kernel = coarse
    try:
        yield
    finally:
        fa.backward_kernel = saved


def dense_launches(fa, rn) -> dict:
    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_backward": fa.flash_attention.backward_launches,
            "rmsnorm": rn.rmsnorm.launches}


def zero_launches(fa, rn, ss) -> None:
    fa.flash_attention.launches = fa.flash_attention.backward_launches = 0
    rn.rmsnorm.launches = ss.ssd_scan.launches = 0


def dense_expect(L: int, policy: str, steps: int = 1) -> dict:
    """Launches of ``steps`` steps of a dense LM of L layers: one flash
    forward a layer and one backward, 2L + 1 norms; a remat policy other
    than "none" runs each layer's forward again in the backward."""
    again = 0 if policy == "none" else 1
    return {"flash_attention": (1 + again) * L * steps,
            "flash_attention_backward": L * steps,
            "rmsnorm": (2 * L + 1 + again * 2 * L) * steps}


def train_dense_path(torch, np, F, modules) -> dict:
    """Phase 18: full-width, full-depth qwen2-0.5b, one step's loss and
    gradients through the flash forward and backward kernels against the
    plain twins, remat "none" and "dots", a coarse-backward control, then
    timed steps and a profiled one.  Returns the launches of one step at
    each policy."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ll
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))
    cfg = get_config(DENSE_ARCH)
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
    params = state.params
    rng = np.random.default_rng(0)
    seq = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
        dtype=torch.long, device="cuda")
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def loss_and_grads(policy):
        for p in params.values():
            p.grad = None
        loss, _ = model.loss(batch, remat_policy=policy)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return float(loss.detach()), grads

    def cosine(a, b):
        return float(F.cosine_similarity(a.flatten().float(),
                                         b.flatten().float(), dim=0,
                                         eps=1e-30))

    # ---- one step's loss and gradients: kernels, remat none and dots -------
    zero_launches(fa, rn, ss)
    k_loss, k_grads = loss_and_grads("none")
    launches = {"none": dense_launches(fa, rn)}
    zero_launches(fa, rn, ss)
    d_loss, d_grads = loss_and_grads("dots")
    launches["dots"] = dense_launches(fa, rn)
    dots_cos = min(cosine(d_grads[k], k_grads[k]) for k in k_grads)
    del d_grads
    # ---- the plain twins, bf16 and fp32 compute (remat full: the plain
    # attention keeps (B, H, S, T) scores a layer) ---------------------------
    before = dense_launches(fa, rn)
    with plain_kernels(ops, fa, rn, ss):
        p_loss, p_grads = loss_and_grads("full")
        saved_dtype = ll.COMPUTE_DTYPE
        ll.COMPUTE_DTYPE = torch.float32      # the masters cast at each use
        try:
            r_loss, r_grads = loss_and_grads("full")
        finally:
            ll.COMPUTE_DTYPE = saved_dtype
    check(dense_launches(fa, rn) == before, "the plain run launched a kernel")

    def held(grads):
        """Each leaf's cosine to the plain bf16 gradient, its distance
        (1 - cosine) to the fp32 one against the plain bf16 path's, and
        the leaves that fail: a leaf that is signal in bf16 (the plain
        bf16 gradient within MIN_GRAD_COSINE of fp32) must be within
        MIN_GRAD_COSINE of the plain bf16 gradient, and every leaf's
        distance to fp32 must be at most BF16_RATIO x the plain bf16
        path's + BF16_SLACK."""
        rows, bad = {}, []
        for k in grads:
            cos_p = cosine(grads[k], p_grads[k])
            d_k = 1.0 - cosine(grads[k], r_grads[k])
            d_p = 1.0 - cosine(p_grads[k], r_grads[k])
            noise = 1.0 - d_p < MIN_GRAD_COSINE
            ok = (noise or cos_p >= MIN_GRAD_COSINE) and \
                d_k <= BF16_RATIO * d_p + BF16_SLACK
            rows[k] = dict(cosine_to_plain=cos_p, distance_to_fp32=d_k,
                           plain_distance_to_fp32=d_p, noise=noise)
            if not ok:
                bad.append(k)
        return rows, bad

    rows, bad = held(k_grads)
    del k_grads
    # ---- the control: the backward's outputs coarsened --------------------
    zero_launches(fa, rn, ss)
    with coarse_backward(fa, torch, DENSE_CONTROL_BITS):
        c_loss, c_grads = loss_and_grads("none")
    c_rows, c_bad = held(c_grads)
    del c_grads, p_grads, r_grads
    torch.cuda.empty_cache()
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    worst = sorted(rows, key=lambda k: rows[k]["distance_to_fp32"]
                   - BF16_RATIO * rows[k]["plain_distance_to_fp32"])[-5:]
    emit("train_dense_plain", arch=cfg.name, batch=[TRAIN_BATCH, TRAIN_SEQ],
         kernel_loss=k_loss, plain_loss=p_loss, fp32_loss=r_loss,
         loss_rel=loss_rel, dots_loss=d_loss, dots_min_cosine=dots_cos,
         leaves=len(rows), noise_leaves=sorted(k for k in rows
                                               if rows[k]["noise"]),
         cosine_to_plain_min=min(r["cosine_to_plain"] for r in rows.values()),
         worst_leaves={k: rows[k] for k in worst}, failing=bad,
         control_bits=DENSE_CONTROL_BITS, control_loss=c_loss,
         control_failing=c_bad[:8], control_n_failing=len(c_bad),
         control_worst={k: c_rows[k] for k in sorted(
             c_rows, key=lambda k: c_rows[k]["distance_to_fp32"]
             - BF16_RATIO * c_rows[k]["plain_distance_to_fp32"])[-3:]},
         launches=launches, expected_launches={
             p: dense_expect(L, p) for p in ("none", "dots")},
         max_loss_rel=MAX_LOSS_REL, min_grad_cosine=MIN_GRAD_COSINE,
         bf16_ratio=BF16_RATIO, bf16_slack=BF16_SLACK)
    check(loss_rel <= MAX_LOSS_REL,
          f"dense loss {k_loss} against the plain twins' {p_loss}")
    check(not bad, f"dense gradients off the plain twins / fp32: {bad[:5]}")
    check(c_bad, f"a backward at {DENSE_CONTROL_BITS} mantissa bits passes "
          f"the dense gradient check")
    check(abs(d_loss - k_loss) <= DOTS_LOSS_REL * abs(k_loss)
          and dots_cos >= DOTS_MIN_COSINE,
          f"remat dots: loss {d_loss} against {k_loss}, gradient cosine "
          f"{dots_cos}")
    for policy in ("none", "dots"):
        check(launches[policy] == dense_expect(L, policy),
              f"dense launches at {policy}: {launches[policy]}, the path "
              f"implies {dense_expect(L, policy)}")

    # ---- timed steps, a profiled one, a step under remat dots -------------
    step = make_train_step(model, tcfg)
    state, m = step(state, batch)                          # warm-up
    losses = [float(m["loss"])]
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa, rn, ss)
    step_s = []
    for _ in range(DENSE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    step_launches = dense_launches(fa, rn)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_phase(torch, "dense train step 4x2048",
                         lambda: step(state, batch),
                         expect=("flash_mma_kernel", "flash_bwd_dkdv_kernel",
                                 "flash_bwd_dq_kernel",
                                 "flash_bwd_preprocess_kernel"))
    emit("profile", **prof)
    dots_step = make_train_step(model, TrainStepConfig(remat_policy="dots",
                                                       optimizer=opt))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = dots_step(state, batch)
    torch.cuda.synchronize()
    dots_s = time.perf_counter() - t0
    dots_peak = torch.cuda.max_memory_allocated()
    losses.append(float(m["loss"]))
    emit("train_dense", arch=cfg.name, params=cfg.param_count(),
         batch=[TRAIN_BATCH, TRAIN_SEQ], remat_policy="none", init_s=init_s,
         step_s=step_s, tokens_per_s=tokens / (sum(step_s) / len(step_s)),
         losses=losses, peak_mem_bytes=peak, launches=step_launches,
         expected_launches=dense_expect(L, "none", DENSE_STEPS),
         idle_share=prof["idle_share"], groups_ms=prof["groups_ms"],
         dots_step_s=dots_s, dots_tokens_per_s=tokens / dots_s,
         dots_peak_mem_bytes=dots_peak)
    check(all(np.isfinite(losses)), f"non-finite dense loss: {losses}")
    check(losses[-1] < losses[0], f"dense loss did not fall: {losses}")
    check(step_launches == dense_expect(L, "none", DENSE_STEPS),
          f"dense step launches {step_launches}")
    del state, step, dots_step, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def trainer_dense_path(torch, np, tdata, modules) -> dict:
    """Phase 19: the Trainer on full-width qwen2-0.5b over LCG token data
    (examples/torch_train_lm.py's ``lcg_dataset``), remat "dots" (the
    Trainer's default): A trains DENSE_TRAINER_STEPS steps straight (DPT
    runs and fills the cache), B1 half of them and saves a blocking
    checkpoint, B2 resumes it; then the example's smoke preset on the
    card.  Returns the launches of the Trainer's steps."""
    import importlib.util
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))

    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = get_config(DENSE_ARCH)
    L = cfg.num_layers
    dataset = example.lcg_dataset(64, TRAIN_SEQ, DENSE_LCG_VOCAB)
    half = DENSE_TRAINER_STEPS // 2
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dense_")

    def make(steps, checkpoint_dir=None):
        tc = TrainerConfig(
            total_steps=steps, log_every=1,
            checkpoint_every=DENSE_TRAINER_STEPS + 1,
            checkpoint_dir=checkpoint_dir, seed=0, autotune=True,
            autotune_strategy="grid", autotune_budget_batches=4,
            autotune_max_prefetch=2,
            autotune_num_cpu_cores=min(4, os.cpu_count() or 1),
            dpt_cache_path=os.path.join(workdir, "dpt.json"),
            step_config=TrainStepConfig(
                remat_policy="dots",
                optimizer=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                      total_steps=100)))
        loader = tdata.DataLoader(dataset, TRAIN_BATCH, seed=0,
                                  device="cuda")
        return Trainer(cfg, loader, tc, device="cuda")

    def losses(tr):
        return [r["loss"] for r in tr.history if "loss" in r]

    zero_launches(fa, rn, ss)
    try:
        t0 = time.perf_counter()
        a = make(DENSE_TRAINER_STEPS)
        a.run()
        a_s = time.perf_counter() - t0
        a_sum = dict(pick=[a.loader.params.num_workers,
                           a.loader.params.prefetch_factor],
                     tune_s=a.tune_s, tune_trials=a.tune_trials,
                     losses=losses(a),
                     step_s=[r["step_s"] for r in a.history if "loss" in r])
        del a
        torch.cuda.empty_cache()
        ckdir = os.path.join(workdir, "ckpt")
        b1 = make(half, ckdir)
        b1.run()
        b1_trials, b1_losses = b1.tune_trials, losses(b1)
        b2 = make(DENSE_TRAINER_STEPS, ckdir)
        held = [b1.state]
        b1.state = b1.step_fn = None
        restored = {}
        restore = b2._maybe_restore

        def restore_and_compare():
            restore()
            live, got = held[0], b2.state
            pairs = [("params", live.params, got.params),
                     ("mu", live.opt.mu, got.opt.mu),
                     ("nu", live.opt.nu, got.opt.nu)]
            unequal = [f"{kind}:{k}" for kind, x, y in pairs for k in x
                       if not torch.equal(x[k], y[k])]
            restored.update(n_unequal=len(unequal), unequal=unequal[:5],
                            step=[live.opt.step, got.opt.step],
                            restore_s=b2.checkpointer.restore_s)
            held.clear()
            torch.cuda.empty_cache()

        b2._maybe_restore = restore_and_compare
        b2.run()
        b2_sum = dict(start_step=b2.start_step, tune_trials=b2.tune_trials,
                      losses=losses(b2))
        saves = b1.checkpointer.saves + b2.checkpointer.saves
        del b1, b2
        gc.collect()
        torch.cuda.empty_cache()
        launches = dense_launches(fa, rn)

        # the example's smoke preset on the card, as its users run it
        t0 = time.perf_counter()
        ex = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
             "--preset", "smoke", "--steps", str(EXAMPLE_STEPS),
             "--ckpt-dir", os.path.join(workdir, "example")],
            capture_output=True, text=True, timeout=600)
        example_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    summary = [ln for ln in ex.stdout.splitlines() if ln.startswith("loss ")]
    n_steps = DENSE_TRAINER_STEPS + half + (DENSE_TRAINER_STEPS - half)
    expect = dense_expect(L, "dots", n_steps)
    loss_diff = [abs(x - y) for x, y in
                 zip(a_sum["losses"][half:], b2_sum["losses"])]
    emit("trainer_dense", arch=cfg.name, batch=[TRAIN_BATCH, TRAIN_SEQ],
         items=64, lcg_vocab=DENSE_LCG_VOCAB, remat_policy="dots", a=a_sum,
         a_wall_s=a_s, b1=dict(tune_trials=b1_trials, losses=b1_losses),
         b2=b2_sum, restore=restored, loss_diff_a_b2=loss_diff,
         max_loss_diff=TRAINER_LOSS_ATOL,
         saves=[dict(r) for r in saves], launches=launches,
         expected_launches=expect,
         example=dict(steps=EXAMPLE_STEPS, rc=ex.returncode, s=example_s,
                      summary=summary, stderr_tail=ex.stderr[-800:]))
    check(a_sum["tune_trials"] > 0, "A did not run DPT")
    check(b1_trials == 0 and b2_sum["tune_trials"] == 0,
          f"B1 / B2 did not tune from the cache: {b1_trials}, "
          f"{b2_sum['tune_trials']} trials")
    check(all(np.isfinite(a_sum["losses"] + b1_losses + b2_sum["losses"])),
          "non-finite loss")
    check(a_sum["losses"][-1] < a_sum["losses"][0],
          f"A's loss did not fall: {a_sum['losses']}")
    check(b2_sum["start_step"] == half, f"B2 resumed at "
          f"{b2_sum['start_step']}")
    check(restored.get("n_unequal") == 0 and restored["step"] == [half] * 2,
          f"restored state differs from B1's: {restored}")
    check(len(loss_diff) == DENSE_TRAINER_STEPS - half
          and max(loss_diff) <= TRAINER_LOSS_ATOL,
          f"B2's losses {b2_sum['losses']} against A's {a_sum['losses']}")
    check(launches == expect,
          f"dense trainer launches {launches}, the path implies {expect}")
    check(ex.returncode == 0 and summary,
          f"examples/torch_train_lm.py failed: {ex.stderr[-2000:]}")
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
    # a first profiler window starts the device tracing, which can miss
    # the first kernels of the window it starts in
    device_busy(torch, lambda: torch.ones(1, device="cuda").add_(1))
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
    # the prefix families' prefills: hymba's global layers (8 x 512 text
    # behind 128 meta tokens, 25 / 5 heads of 64) and every phi-3-vision
    # layer (8 x 512 text behind 576 patches, 32 heads of 96)
    checks["flash_attention"] += check_flash(torch, F, fa, gen,
                                             "hymba_global", 8, 640, 640,
                                             25, 5, 64)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "phi3v",
                                             8, 1088, 1088, 32, 32, 96)
    # whisper's serving shapes (batch 8, 20 / 20 heads of 64): the
    # encoder's non-causal self-attention over 1,500 frames (23 whole
    # tiles of 64 and one of 28), the cross-attention of a 224-token
    # prompt and of one decode step over them, the decoder's causal
    # self-attention
    for name, S, T, causal in (("whisper_enc", 1500, 1500, False),
                               ("whisper_cross", 224, 1500, False),
                               ("whisper_cross_decode", 1, 1500, False),
                               ("whisper_self", 224, 224, True)):
        checks["flash_attention"] += check_flash(torch, F, fa, gen, name,
                                                 8, S, T, 20, 20, 64,
                                                 causal=causal)
    # the backward kernels: the dense training shape, the forward's mask
    # cases, H = K, the example's smoke preset (d 32) and head dim 128
    checks["flash_attention_backward"] = []
    for name, shape, kw in (
            ("train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64), {}),
            ("window48", (8, 512, 512, 14, 2, 64), dict(window=48)),
            ("ragged300", (4, 300, 300, 14, 2, 64), {}),
            ("q_offset", (8, 64, 512, 14, 2, 64), dict(q_offset=448)),
            ("gqa1", (4, 512, 512, 14, 14, 64), {}),
            ("d32", (8, 128, 128, 4, 2, 32), {}),
            ("d128", (2, 256, 256, 16, 8, 128), {})):
        checks["flash_attention_backward"] += check_flash_backward(
            torch, F, fa, gen, name, *shape, **kw)
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
    # the prefix families' prefill norms: hymba's d_model 1,600 (ln1, ln2,
    # the mixing norms) and its SSM gate norm over d_inner 3,200, and
    # phi-3-vision's d_model 3,072
    for name, rows_, d in (("hymba_d1600", 8 * 640, 1600),
                           ("hymba_gate_d3200", 8 * 640, 3200),
                           ("phi3v_d3072", 8 * 1088, 3072)):
        checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen, name, rows_, d)
    # the fleet phase's survivors step 6 x 2048 after the reshard, and the
    # dp phase's microbatches of 2 x 2048
    for name, d in (("fleet_d1536", 1536), ("fleet_d3072", 3072)):
        checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen, name,
                                           6 * TRAIN_SEQ, d)
    for name, d in (("dp_mb_d1536", 1536), ("dp_mb_d3072", 3072)):
        checks["rmsnorm"] += check_rmsnorm(
            torch, F, rn, gen, name,
            TRAIN_BATCH // DP_MICROBATCHES * TRAIN_SEQ, d)
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
            ("fleet6", (6, TRAIN_SEQ, 48, 64, 1, 128, 256),
             dict(strided=True)),
            ("dp_mb", (TRAIN_BATCH // DP_MICROBATCHES, TRAIN_SEQ, 48, 64, 1,
                       128, 256), dict(strided=True)),
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
    # and hymba's prefill: 8 x (128 + 512) positions, padded to 768, 50
    # heads of 64 and state n = 16, which the bf16 stage kernels pad to
    # their 128-wide tiles
    for name, shape in (("serve_prefill", (8, 512, 48, 64, 1, 128, 256)),
                        ("serve_prefill300", (4, 300, 48, 64, 1, 128, 256)),
                        ("hymba_prefill", (8, 640, 50, 64, 1, 16, 256))):
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

    # ---- 6d-6f. the prefix families at full width ---------------------------
    serve_hybrid_launches = serve_path(torch, np, F, modules, HYBRID_ARCH)
    torch.cuda.empty_cache()
    hybrid_window_launches = hybrid_window_path(torch, np, F, modules)
    torch.cuda.empty_cache()
    serve_vlm_launches = serve_path(torch, np, F, modules, VLM_ARCH)
    torch.cuda.empty_cache()

    # ---- 6g. the encdec family at full width -------------------------------
    serve_encdec_launches = serve_path(torch, np, F, modules, ENCDEC_ARCH,
                                       ENCDEC_REQUESTS)
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
    # phase 14's Trainer B and its patched restore hold each other: only
    # the collector frees its 9.36 GB state before the next 780M state
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15-16. the fleet control plane: a Trainer and a frontend as hosts
    fleet_train_launches = fleet_train_path(torch, np, tdata, modules)
    torch.cuda.empty_cache()
    fleet_serve_launches = fleet_serve_path(torch, np, tdata, modules)
    torch.cuda.empty_cache()

    # ---- 17. the data-parallel step over a one-rank NCCL group -------------
    dp_train_launches = dp_train_path(torch, np, modules)
    gc.collect()                   # the 780M states leave the card
    torch.cuda.empty_cache()

    # ---- 18-19. the dense LM trained at full width: flash's backward -------
    dense_launches_ = train_dense_path(torch, np, F, modules)
    trainer_dense_launches = trainer_dense_path(torch, np, tdata, modules)
    torch.cuda.empty_cache()

    # ---- 18. the kernels line ---------------------------------------------
    later_paths = {"serve_hybrid": serve_hybrid_launches,
                    "hybrid_window": hybrid_window_launches,
                    "serve_vlm": serve_vlm_launches,
                    "serve_encdec": serve_encdec_launches}
    by_path = {
        "flash_attention": {"serve": serve_launches["flash_attention"],
                            "serve_moe": serve_moe_launches["flash_attention"],
                            "serve_ring":
                                serve_ring_launches["flash_attention"],
                            **{k: v["flash_attention"]
                               for k, v in later_paths.items()},
                            "fleet_serve":
                                fleet_serve_launches["flash_attention"],
                            "train_dense": sum(
                                v["flash_attention"]
                                for v in dense_launches_.values()),
                            "trainer_dense":
                                trainer_dense_launches["flash_attention"]},
        "rmsnorm": {"serve": serve_launches["rmsnorm"],
                    "serve_ssm": serve_ssm_launches["rmsnorm"],
                    "serve_moe": serve_moe_launches["rmsnorm"],
                    "serve_ring": serve_ring_launches["rmsnorm"],
                    **{k: v["rmsnorm"] for k, v in later_paths.items()},
                    "train": train_launches["rmsnorm"],
                    "train_stream": stream_launches["rmsnorm"],
                    "trainer": trainer_launches["rmsnorm"],
                    "fleet_train": fleet_train_launches["rmsnorm"],
                    "fleet_serve": fleet_serve_launches["rmsnorm"],
                    "dp_train": dp_train_launches["rmsnorm"],
                    "train_dense": sum(v["rmsnorm"]
                                       for v in dense_launches_.values()),
                    "trainer_dense": trainer_dense_launches["rmsnorm"]},
        "rmsnorm_residual": {},      # no model calls it
        "ssd_scan": {"serve_ssm": serve_ssm_launches["ssd_scan"],
                     "serve_hybrid": serve_hybrid_launches["ssd_scan"],
                     "hybrid_window": hybrid_window_launches["ssd_scan"],
                     "train": train_launches["ssd_scan"],
                     "train_stream": stream_launches["ssd_scan"],
                     "trainer": trainer_launches["ssd_scan"],
                     "fleet_train": fleet_train_launches["ssd_scan"],
                     "dp_train": dp_train_launches["ssd_scan"]},
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
    backward_rows = checks.pop("flash_attention_backward")
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
    # the scan with its final state at hymba's prefill (n = 16), and the
    # fleet phase's 6 x 2048 training shape
    by_name["ssd_scan"]["cases"] = {
        r["case"]: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                        y_only_ms=r.get("y_only_ms"), bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None)
        for r in checks["ssd_scan"]
        if r["case"] in ("hymba_prefill", "fleet6", "dp_mb")
        and r["dtype"] == "bfloat16"}
    # flash at phi-3-vision's head dim, at the MoE and prefix paths'
    # prefills and at whisper's shapes
    by_name["flash_attention"]["cases"] = {
        r["case"]: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"],
                        library_backend=r["library_backend"])
        for r in checks["flash_attention"]
        if r["case"] in ("d96", "granite", "mixtral_window", "hymba_global",
                         "phi3v", "whisper_enc", "whisper_cross",
                         "whisper_cross_decode", "whisper_self")
        and r["dtype"] == "bfloat16"}
    # rmsnorm at mixtral's d_model, on the ring path, and at the prefix
    # families' widths
    by_name["rmsnorm"]["cases"] = {
        r["case"]: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"])
        for r in checks["rmsnorm"]
        if r["case"] in ("mixtral_d6144", "mixtral_decode", "hymba_d1600",
                         "hymba_gate_d3200", "phi3v_d3072", "fleet_d1536",
                         "fleet_d3072", "dp_mb_d1536", "dp_mb_d3072")
        and r["dtype"] == "bfloat16"}
    # the flash backward replaces no TPU kernel: its launches (one a
    # backward call, for its three kernels) and times ride on flash's row
    bwd_by_path = {"train_dense": sum(
        v["flash_attention_backward"] for v in dense_launches_.values()),
        "trainer_dense": trainer_dense_launches["flash_attention_backward"]}
    train_row = next(r for r in backward_rows if r["case"] == "train")
    by_name["flash_attention"].update(
        backward_source="src/repro_torch/kernels/csrc/flash_attention.cu",
        backward_replaces="no TPU counterpart (repro differentiates "
                          "src/repro/kernels/ref.py:43 mha)",
        backward_launches=sum(bwd_by_path.values()),
        backward_launches_by_path=bwd_by_path,
        backward_max_abs_err=max(r["max_abs_err"] for r in backward_rows),
        backward_ms=train_row["kernel_ms"],
        backward_plain_ms=train_row["plain_ms"],
        backward_bound_ms=train_row["bound_ms"],
        backward_bound_by=train_row["bound_by"],
        backward_library_ms=train_row["library_ms"],
        backward_cases={
            r["case"]: dict(ms=r["kernel_ms"], preprocess_ms=r["preprocess_ms"],
                            dkdv_ms=r["dkdv_ms"], dq_ms=r["dq_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            library_backend=r["library_backend"])
            for r in backward_rows})
    print(json.dumps({"kernels": kernels}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
