#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and data-loading paths and
its Trainer on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, its power limit, torch and CUDA versions; TF32 off.
2. build: compile every kernel from the checkout's sources (one nvcc per
   CUDA C++ source, flash attention, the SSD scan and its backward, all
   started together; Triton's JIT for rmsnorm and rmsnorm_residual
   meanwhile),
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
   ``whisper_self`` causal over 224), and the forward that
   ``_FlashAttention`` runs at the dense training shape (``train``: 4 x
   2048, 14 / 2 of 64, causal, o and lse, beside PyTorch's
   memory-efficient and cuDNN attention asked for their logsumexp); every
   flash row names the forward kernel that served it (``variant``:
   ``wgmma``, ``decode`` or ``scalar``, from ``forward_variant``), its
   registers and resident blocks, and a second call on the same inputs
   must give the same bits; the serving rows (``slice``, the decode rows)
   carry one call's host time; rmsnorm also at their widths
   and, with the SSD scan, at the fleet phase's 6 x 2048; the SSD scan
   also with its final state through ``ops.ssd_prefill`` at the serving
   prefill shapes (8 x 512 and 4 x 300, padded, and hymba's 8 x 640 at
   state n = 16), y and the state each held to its own tolerance and
   timed against the y-only scan; every SSD row names the kernels that
   served it (``variant``: ``wgmma`` at the models' shapes, ``mma`` at the
   test shapes, ``scalar`` for fp32, from ``ssd_scan.variant``) and a
   wgmma row's second call must give the same bits; and each bf16 kernel
   of the SSD scan against its plain stage function, timed alone
   (``ssd_stage`` lines): the wgmma state kernel (chunk state and state
   passing, the final state) and chunk scan at the slice shape and
   hymba's prefill, the mma kernels (chunk state, state passing, chunk
   scan) at ``t4_chunk24``.
   Phase 22's per-rank shapes: flash at hymba's 15 / 15 heads of 64 over
   2 x 640 (``tp_hybrid_rank``), the SSD scan at 25 heads (n 16) and 24
   heads (n 128), and the split-row rmsnorm pair (``row_sumsq``,
   ``rmsnorm_total``) at a rank's 1,024 x 1,600 of 3,200 and 1,024 x
   1,536 of 3,072, the two ranks' sums added in place of the all-reduce,
   against the plain twins and the whole row's plain rmsnorm.
   The flash-attention backward (``flash_attention_backward`` rows, through
   ``_FlashAttention`` as the models call it) at the dense training shape
   (``train``: 4 x 2048, 14 / 2 heads of 64, causal), ``window48``,
   ``ragged300``, ``q_offset``, ``gqa1`` (H = K), ``d32`` (the example's
   smoke preset), ``d128``, ``group12`` (mistral-large's 24 / 2 heads
   of 128: a dK / dV cluster of 12, past the portable 8), ``d96``
   (phi-3-vision's 32 / 32 heads of 96 over 576 patches and 512 text
   tokens), ``d16`` (tiles of 16, non-causal, S and T ragged) and the
   model axis's per-rank shapes (``tp_rank``, ``tp_big_rank``): dq, dk, dv
   against autograd through the fp32 plain twin, each within 2x the bf16
   plain twins' own distance plus 1e-3 of its largest entry, and the
   kernels' gradients at 4 mantissa bits must fail that; a second call on
   the same inputs must give the same bits; each row names the variant
   (wgmma at every head dim), the cluster size and each kernel's
   registers and shared memory; the three launches timed together and
   each alone, beside the plain backward, SDPA's backward and the bound;
   an fp32 or unaligned input that needs a gradient must raise.
   The SSD scan's backward (``ssd_scan_backward`` rows, through
   ``_SSDScan`` as the models call it; ``SSD_BWD_CASES``) at ``slice``,
   ``fleet6``, ``dp_mb``, ``tp_ssm_rank``, ``tp_hybrid_rank`` (ragged),
   ``p32_groups``, ``t4_chunk24``, ``unaligned`` and ``slice`` in fp32:
   dx, ddt, dA, dB, dC against the fp32 autograd recompute
   (``ssd_scan_backward``), each within 2x the staged twin's own distance
   plus its own ``SSD_BWD_ATOL_OF_MAX`` of its largest entry (bf16: dx,
   dB, dC 4e-3, the fp32 ddt and dA 5e-4), a 4-bit control that must
   fail for each, a second call bit-equal, the variant
   ``backward_variant`` names (wgmma, the band form, at the models'
   shapes; mma at ``t4_chunk24`` and ``unaligned``; scalar for fp32),
   each kernel's time alone, the kernels' time beside
   the plain recompute's and the bound; calls no variant takes must
   raise.  rmsnorm's backward (``rmsnorm_backward`` rows, through
   ``_RMSNorm``) at 8,192 rows of 896, 1,536 and 3,072 against its plain
   twin, a second call bit-equal, timed beside the twin, ``F.rms_norm``'s
   autograd backward and the bound.  From here on the plain backward
   twins raise on CUDA tensors (``plain_backward_refused``, in the
   model-axis ranks too): every training path runs the kernels.
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
6. serve_ssm: phases 4-5 for full-width mamba2-780m (24 of its 48 layers,
   ``SERVE_LAYERS``; d_model 1536, 48 heads of 64, state 128): prefill runs
   the SSD scan kernel with its final state, decode the recurrence over the
   conv-tail / SSD-state cache; launches exactly 24 ssd_scan a batch and 49
   rmsnorm a forward, no flash; the prefill profile must show the scan's
   kernels.  Then ``plain_ssm`` (phase 5 for this model) and
   ``prefill_vs_full``: the prefill + decode logits against one
   full-sequence forward of the prompt and the forced tokens, both through
   the kernels, to the same tolerances, in fp32 and, at the prompt's last
   position and the first decode step of every sequence, in bf16 on the
   served model.
6b. serve_moe: phases 4-5 for full-width granite-moe-3b-a800m (16 of its 32
   layers; d_model 1536, 24 / 8 heads of 64, 40 experts of 512, top 8,
   capacity 1.25): exactly 16 flash launches a prefill batch and 33 rmsnorm
   a forward; each profile line also splits the MoE layers' device time
   between routing and dispatch and the three batched expert products
   (``moe_split``).  Then ``plain_moe``: the kernels against the plain
   twins in fp32 compute to phase 5's bounds, in bf16 by distance to an
   fp32 plain reference against the plain bf16 path's own (an rmsnorm with
   a coarser output must fail that bound), and the route agreement of the
   two paths, layer by layer.
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
6f. serve_vlm: phases 4-5 for phi-3-vision-4.2b at its published widths and
   16 of its 32 layers (d_model 3,072, 32 heads of 96, 576 patches of 1,024
   projected in front of the text), each request with seeded patch
   embeddings passed to ``ServeEngine.generate`` as ``extra_inputs``:
   exactly 16 flash launches a prefill (8 x 1,088 positions), 33 rmsnorm a
   forward; ``plain_vlm`` and ``handoff_vlm`` as for hymba.
6g. serve_encdec: phases 4-5 for whisper-large-v3 at its published widths
   and 16 of its 32 encoder and 16 of its 32 decoder layers (d_model 1,280,
   20 / 20 heads of 64, gelu MLPs of 5,120, layernorms, 1,500 source
   positions), batch 8, 16 prompts of 224 tokens and 4 of 96, each with
   seeded frame embeddings passed to ``ServeEngine.generate`` as
   ``extra_inputs``: exactly 48 flash launches a prefill (16 encoder, 16
   decoder self, 16 cross) and 16 a decode step (the cross-attention over
   the cached cross K/V), no rmsnorm.  ``plain_encdec`` as for hymba, its
   bf16 control a coarse flash (the path has no rmsnorm), plus the
   encoder's output held apart from the logits; ``handoff_encdec`` as for
   hymba, where a slot handed its neighbour's cross K/V must fail the bf16
   decode bound.
7. train: mamba2-780m at its published widths and 24 of its 48 layers
   (cut to fit the time limit), bf16 compute with fp32 masters and
   AdamW moments drawn from a seeded CUDA generator, one batch of 4 x 2048
   tokens made from the seed, through ``init_train_state`` ->
   ``make_train_step`` -> ``DecoderLM.loss``.  A warm-up step, then four
   timed steps with the launch counters zeroed before and read after
   (exactly 24 ssd_scan and 49 rmsnorm launches per forward, and as many
   of their backward kernels per step; every training phase below counts
   its backward launches so); finite,
   falling losses starting near ln(vocab); step time, tokens/s and peak
   memory; one step under the profiler, which must show the SSD stage
   kernels and the backward kernels; one step with remat "full", whose
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
   byte, losses are finite and fall, launches are exactly 24 ssd_scan and
   49 rmsnorm a step; one streamed step under the profiler.
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
14. trainer: ``Trainer`` on full-width mamba2-780m at 12 of its 48 layers
   (cut to fit the time limit; phase 7's state is
   released first) over phase 11's token data, DPT cache and checkpoints
   in a temporary directory removed at the end.  Run A trains 4 steps
   straight (DPT runs and fills the cache); B1 trains 2 steps and saves a
   blocking checkpoint (3.0 GB in ``repro``'s on-disk layout); B2 resumes
   it and trains to step 4, saving asynchronously at step 3 during step
   4's compute.  B1 and B2 tune from the cache (no trial, A's pick); B2
   starts at step 2 with every restored leaf bit-equal to B1's live state;
   B2's losses within 2e-3 of A's; launches exactly 12 ssd_scan and 25
   rmsnorm a step.  Free disk for three checkpoints is checked first.
15. fleet_train: the fleet control plane (the scenario of
   ``benchmarks/bench_fleet.py``) with phase 7's mamba2-780m (24 layers)
   in a ``Trainer`` on the card as host 0, attached with ``connect_fleet``, beside two
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
   finite and falling; exactly 24 ssd_scan and 49 rmsnorm launches a step.
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
   ``make_train_step`` with ``dp_manual``) on phase 7's mamba2-780m over a
   one-rank NCCL group (a ``FileStore`` in a temporary directory), under
   ``use_rules(make_local_mesh(), rules_for("train"))``: phase 7's masters
   and batch, 2 microbatches of 2 x 2048, remat "none".  One dp step
   against the plain step over the whole batch from identical masters
   (loss, gradient norm, every leaf's update cosine), and a control
   without the deferred scale's 1/n_mb that must fail it; exactly 48
   ssd_scan and 98 rmsnorm launches a step, no flash; ``compressed_psum``
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
19. trainer_dense: the ``Trainer`` on the same model at 12 of its 24
   layers (cut to fit the time limit), remat "dots", over
   LCG token data (``examples/torch_train_lm.py``'s ``lcg_dataset``, ids
   under 4,096): a startup DPT grid tune, 4 steps with the loss falling,
   2 steps and a blocking checkpoint, a resume whose restored state is
   bit-equal and whose steps give the straight run's losses; exact
   launches; then ``examples/torch_train_lm.py --preset smoke`` on the
   card, whose assertion that the loss fell must hold.
20. tp_train: the model axis trains qwen2-0.5b at its published widths
   and 6 of its 24 layers (cut to make room for phase 23) on
   (data 1, model 4), four ranks on the one card in a gloo group (NCCL
   refuses two ranks on one device), each collective staged through host
   memory.  Each rank
   holds only its shards of the storage plan, built leaf by leaf (held
   bytes equal to the sum of its shards' sizes, no model-mapped leaf at
   its whole shape): heads padded to (2, 8), 4 / 1 a rank, its attention
   leaves gathered over the model ranks once a layer (exactly 7 x 12
   gathers a rank), the d_ff and vocabulary shards (37,984 rows) used as
   they are; one ``dp_manual`` step of 2 x 512 at remat "none" against the
   one-rank step on the same masters (loss, grad norm, every leaf's
   first-moment cosine >= 0.999, summed over the ranks' shards, or
   within 2x the bf16 noise floor of its kind of leaf, the largest
   distance over the layers between the one-rank gradients through the
   kernels and the plain twins), every leaf the ranks hold whole
   bit-equal across them, exactly 12 / 12 flash launches and 25 rmsnorm
   a rank; a control with layer 0's attention combine left out must fail.
   The step is sequence-parallel, as TRAIN_RULES' ``seq_res`` says
   (``stack.sp_split``): each layer receives its rank's block of the
   residual stream, (2, 128, 896), and the collectives a step are those
   the plan implies (``sp_plan``: 50 all-gathers and 50 reduce-scatters
   of activations over "model", the cross-entropy's two sums and one max,
   the leaf gathers, one all-reduce a partial leaf, none over the data
   axis of one, whose group of one issues nothing); a second control,
   every ``scatter_seq`` slicing without its sum, must fail too.  The
   ranks' checkpoint is restored in this process at world 1: every
   shard's checksum equal to its rank's, and a world-1 save of it writes
   the ranks' manifest.  After their step the ranks serve the same qwen2
   under SERVE_RULES (``tp_kv_serve``): a K/V cache of 1,024 slots, 256 a
   rank (``kv_seq``), prompts of 4 x 252 (decode crosses into the next
   rank's block) and 2 x 24 (ranks 1-3 see no key), 8 greedy steps
   teacher-forced with the one-rank engine's tokens, which this process
   computes first: fp32 cosine >= 0.9999 at every position and equal
   greedy tokens, bf16 within 1.5x the one-rank bf16 distance to fp32 +
   1e-4, each rank's fp32 block within 1e-4 of the largest entry of the
   one-rank cache's slots, its bytes a quarter of the whole; the partial
   softmaxes combined without their lse weights must fail.  Then
   ``ring_weight_matmul`` at (4,096, 896) x (896, 4,864) over the ranks
   against x @ w in fp32 (``ring_matmul``).  Lines: backend, how each
   rank's collectives moved their tensors (``transport.moved``: every one
   staged through the host, or the phase fails), collectives by kind,
   what each rank holds, each rank's peak memory beside the whole
   layout's; times are not speeds.
20b. tp_train_big: qwen3-1.7b at its published widths and 8 of its 28
   layers (cut to fit the time limit; 0.71 B parameters) on (data 1, model 4),
   aligned everywhere: 4 / 2 heads of 128, 1,536 d_ff columns and 37,984
   vocabulary rows a rank, no gather over the model ranks; the one-rank
   step first in this process (16.3 GB of fp32 state), then the ranks'
   step held as in phase 20, each rank's peak below the whole layout's
   state, exactly 14 / 14 flash launches and 57 rmsnorm (qk-norm's two a
   layer) a rank, sequence-parallel as phase 20 with the same collective and
   residual checks; the vocabulary-parallel lookup without its sum and
   the reduce-scatters without theirs must each fail.
21. ep_serve: the model axis serves granite-moe-3b-a800m at its
   published widths, all 40 experts, and 8 of its 32 layers (the depth
   the card's time allows beside phase 20's kv_seq check) on (data 2,
   model 2) through ``_serve_wrap`` under ``SERVE_RULES_BIG``, four ranks
   holding their bf16 shards of its storage plan (the embed dim over
   "data", gathered a layer at a time; 12 / 4 heads a rank; the 40
   experts, whose axis maps to no mesh axis, and the vocabulary of
   49,155, under the guard, whole over "model", 20 experts computed a
   rank); a prefill of 4 x 512 (2 rows a
   rank) and 8 teacher-forced decode steps against the one-rank port on
   the same weights: in fp32 compute every position's logit cosine
   >= 0.999 and top-1 >= 0.99; in bf16 each position within 0.999 or 2x
   the bf16 noise floor (the one-rank kernels against the plain twins),
   top-1 recorded, the model ranks' logits equal; the MoE combine without
   its all-reduce must fail at the prefill; exactly 8 flash launches and
   17 rmsnorm a forward a rank in bf16 (one and two a layer, one for the
   final norm).  Decode runs on a ``kv_seq``
   cache: the 520 slots the prompt and steps write, 260 a rank.
   In the same ranks, a batch the two data ranks do not divide
   (``_serve_wrap``'s "serve_replicated" path: every rank all the rows, the
   model still split): (a) the granite above, one request of 512 tokens and
   4 teacher-forced decode steps and 3 rows prefilled, an expert's capacity
   counting every row; (b) mixtral-8x22b at its published widths and 1 of
   its 56 layers, one request of 4,608 tokens (its 4,096-slot ring wraps at
   the prefill, 2,048 slots a rank) and 4 decode steps, its virtual experts
   over "model" and gathered over "data".  Each against the one-rank port
   over the same rows, as the phase holds its own run (fp32 to the first
   decode step); the data ranks' logits bit-equal (under deterministic
   algorithms: the MoE combine's ``index_add`` atomics differ run to run
   otherwise); a ``kv_shards == 2`` cache; the bytes a rank holds equal to
   its shards'; the first decode step over a rank's K/V block alone,
   without the partial-softmax combine, must fail.
22. tp_hybrid / tp_ssm: the families with an SSM under the model axis,
   two gloo ranks on (data 1, model 2) spawned once for both models:
   hymba-1.5b and mamba2-780m at their published widths and 2 layers each
   (hymba's layer 0 global, layer 1 windowed with the 128
   meta tokens as sinks).  Hymba's 25 / 5 heads pad to (5, 6), 15 a rank over 3 kv
   heads that its slots straddle (the kv heads expanded to one a slot,
   flash with groups of one); each model's SSD heads split whole (25 and
   24 a rank), the gate norm over each rank's part of the row with its
   sum of squares summed over the ranks (the split-row pair
   ``row_sumsq`` / ``rmsnorm_total``).  Each steps once on 2 x 512 under
   TRAIN_RULES on its storage plan against the one-rank step on the same
   masters (phase 20's limits; the residual whole, no ``seq_res``; the
   collectives by kind and the gathers the plan implies; bytes held equal
   to the shards'; exact launches), with two controls that must fail (the
   gate norm's sums left out; the partial SSM leaves left unsummed), then
   serves under SERVE_RULES: prefill and 8 greedy decode steps
   teacher-forced with the one-rank fp32 tokens, the SSM cache of the
   rank's heads, hymba's K/V cache in two blocks of 1,152 slots (prompts
   of 2 x 2,056, whose decode windows start past rank 0's block, which
   holds the sinks and keys outside the window, and 2 x 24, which leave
   rank 1's block empty): fp32 cosine >= 0.9999 and equal tokens, bf16
   within 1.5x the one-rank distance + 1e-4, each rank's fp32 SSM state
   within 1e-5 of its head slice's largest entry, K/V blocks within 1e-4;
   a control (hymba: no lse weights; mamba2: the norm's sums left out)
   must fail.
23. tp_vlm / tp_encdec: the vlm and encdec families under the model axis,
   two gloo ranks on (data 1, model 2) spawned once for both:
   phi-3-vision-4.2b at its published widths and 4 layers (16 / 16 heads
   of 96 a rank, every leaf aligned; its 576 patches projected whole on
   every rank and prepended to the text after the vocabulary-parallel
   lookup; the residual whole) and whisper-large-v3 at its published
   widths with 2 encoder and 2 decoder layers (10 / 10 heads of 64 a
   rank in the encoder, the decoder's self- and cross-attention; both
   stacks sequence-parallel under TRAIN_RULES: 750 of the 1,500 frames
   and 112 of the 224 tokens a rank, the encoder's output gathered whole
   once for the cross-attention).  Each steps once on its storage plan
   (the vlm 2 x (576 + 512), whisper 2 x 224 behind its frames) against
   the one-rank step on the same masters (phase 20's limits; the
   residual each layer received, the collectives by kind as
   ``ve_collective_plan`` predicts, no gather over "model", bytes held
   equal to the shards', exact launches), with a control that must fail
   (the vlm: the lookup without its sum; whisper: cross-attention's
   per-rank outputs unsummed), then serves under SERVE_RULES: prefill
   with seeded patches or frames and 8 greedy steps teacher-forced with
   the one-rank fp32 tokens over a cache cut on ``kv_seq`` (the vlm's
   1,096 slots in blocks of 548; whisper's 232 in blocks of 116 and its
   cross K/V in blocks of 750 encoder positions): fp32 cosine >= 0.9999
   and equal tokens, bf16 within 1.5x the one-rank distance + 1e-4, each
   fp32 block within 1e-4 of the one-rank cache's largest entry after
   the prefill and after the steps; an equal-weight combine (whisper: of
   the cross cache alone) must fail.
24. dryrun: the dry-run's count (``launch/dryrun.py``,
   ``roofline/counter.py``) held against the card.  Phases 4, 7 and 18
   each count one step on the model they built and warmed
   (``card_count``: qwen2-0.5b's prefill of 8 x 512, mamba2-780m's train
   step at 24 layers, the uncut qwen2-0.5b train step at 4 x 2048, remat
   "none"), their launches taken back out of the paths' counts and
   listed under ``dryrun``.  Here each is traced again on meta with the
   dry-run's machinery: total FLOPs, total traffic and each kernel's
   FLOPs, bytes and regions must be equal, each kernel's regions on the
   card must equal its launches, the dense step's FLOPs outside the
   kernels must equal its matrix products counted from the config, and
   the train steps' counted peak must be within 15% of
   ``max_memory_allocated``.  Each line prints the roofline terms from
   the H100's peaks beside the measured median step,
   ``roofline_fraction_measured`` and ``mfu``, with the card's name and
   power limit.  Then qwen2-0.5b x train_4k x single, rank 0 of 256,
   traced on meta under a fake process group (``dryrun_cell``).
25. kernels: one line listing every ported kernel with its launches on the
   paths above, error and times; flash's row also carries the backward's
   launches by path, errors and times (``backward_*``); the split-row
   pair's two kernels each have their row, with ``F.rms_norm`` over the
   whole row beside them (``whole_row_library_ms``).  Every
   ``flops``, ``bytes`` and ``bound_ms`` of phase 3's rows comes from
   ``roofline/costs.py``.

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
import re
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
# rows go to the scalar flash_fwd_kernel, not the tensor-core kernels that
# serve bf16
TOL = {"bfloat16": (2 ** -8, 2e-3), "float32": (2e-5, None)}   # attention
# keys a K / V tile of both tensor-core forward kernels (FWD_BK of
# csrc/flash_attention.cu): the zero-filled keys past T that a faulty last
# tile would count
FLASH_KEY_TILE = 64
# the partial form's lse (fp32 from either dtype's inputs, summed in
# another order than ref.mha_partial's): absolute and relative; 18 keys
# counted at score 0 past T = 750 move it by ~1e-2 (checked)
TOL_LSE = 1e-4
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
# phase 3: the SSD scan's backward kernels (through ``_SSDScan``, as the
# models call them) against the autograd recompute in fp32
# (``ssd_scan.ssd_scan_backward`` on the same inputs): each of dx, ddt, dA,
# dB, dC within BWD_TWIN_RATIO x the staged twin's own largest distance
# from it (``ref.ssd_chunked_backward``: fp32 inside, its outputs rounded
# to the input's type) plus its own SSD_BWD_ATOL_OF_MAX of its largest
# entry.  The bf16 kernels round the scores dCB to bf16 once (the states,
# the walks' scaled rows and CB o L enter as hi / lo pairs), where the
# twin keeps them fp32, so dB and dC near 0 are off by about one bf16
# rounding of the terms they sum: 4e-3 of the largest entry, the
# forward's own atol (TOL_SSD), for them and for dx; on an NVIDIA H100
# 80GB HBM3 at 700 W they read up to 4.5e-3 against limits of 7.3e-3 to
# 1.1e-2.  ddt and dA are fp32 outputs, and the twin's are fp32 too (its
# distance ~0): they read 2.6e-6 to 2.7e-5 of their largest entry there,
# and 5e-4 sits 18x above the worst; a form that rounded du's scores to
# bf16 once read ddt 8.5e-4 to 2.2e-3 (PERF.md section 6), past it.
# fp32 runs every product in fp32: 1e-4 for each.
# The kernels' gradients rounded to BWD_CONTROL_BITS mantissa bits must
# fail each limit.
SSD_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC")
SSD_BWD_ATOL_OF_MAX = {
    "bfloat16": dict(dx=4e-3, ddt=5e-4, dA=5e-4, dB=4e-3, dC=4e-3),
    "float32": dict.fromkeys(SSD_BWD_GRADS, 1e-4)}

# phase 6: full-width SSM serving workload, the same REQUESTS
SSM_ARCH = "mamba2-780m"

# phase 6b: full-width MoE serving workload, the same REQUESTS;
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

# phase 6f: phi-3-vision-4.2b at its published widths, the same
# REQUESTS, each prompt with seeded patch embeddings (576 x 1,024)
VLM_ARCH = "phi-3-vision-4.2b"

# phase 6g: whisper-large-v3 at its published widths, each prompt with
# seeded frame embeddings (1,500 x 1,280).  224 is whisper's prompt
# limit, half its 448-token text context, so prompt and answer fit in it
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_REQUESTS = ((224, 16), (96, 4))

# the serve phases' depth cuts (phase 21's serve_replicated checks added
# ~120 s to a script that ran ~930-970 s of its 1,200 s): mamba2 24
# of 48 layers, granite 16 of 32, phi-3-vision 16 of 32, whisper 16 + 16
# of 32 + 32.  Widths, requests and every check stay; the launch counts
# follow the depth.  qwen2 serves uncut, hymba too (its global layers are
# 0, 15 and 31), and so does fleet_serve's qwen2
SERVE_LAYERS = {SSM_ARCH: 24, MOE_ARCH: 16, VLM_ARCH: 16, ENCDEC_ARCH: 16}

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
# the training phases 7-8, 11, 15 and 17 run it at its published widths
# and TRAIN_LAYERS of its 48 layers (cut to fit the time limit on a slow
# host, PERF.md section 4); the serving phase keeps all 48
TRAIN_LAYERS = 24
TRAIN_STEPS = 4                          # timed, after one warm-up step
# phase 8 tolerances: the kernel path's loss and gradients against the
# plain twins' on the same parameters and batch.  In bf16 compute the
# activations are rounded at the same places on both paths; what differs
# is summation order inside the SSD scan and the norms, which flips the
# odd bf16 rounding and compounds over the layers.  The in_B / in_C
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
# its mamba2-780m at published widths and TRAINER_LAYERS of its 48 layers:
# three runs write three checkpoints of the masters and both moments and
# restore one, 9.4 GB each at full depth, and the phase took 95 s on a
# slow host (PERF.md section 4); the restart's exactness and the DPT
# cache do not depend on depth
TRAINER_LAYERS = 12

# phase 15: the fleet control plane with the card as host 0 (the scenario
# of benchmarks/bench_fleet.py).  Global batch 12 over three hosts, 4 rows
# of 2,048 tokens each, FLEET_BPE batches to the first epoch; every host's
# storage pays FLEET_LATENCY_S an item.  host1's storage is 25x slower
# from round 2 (a batch then takes ~2.5 s against a card step of ~0.7 s
# at TRAIN_LAYERS: a straggler) until the fleet's straggler re-consensus,
# when it recovers; host2 falls silent from round 5, or the round after
# that consensus; the leader crashes a round after the reshard.  The
# coordinator, its lease and the heartbeats run on a clock the phase
# moves on by one each round (one card step), and every host reads its
# goodput over the last two rounds.  The token rows draw from the first
# 4,096 ids, so the loss has somewhere to fall.
# The reshard latches the new global batch at the first epoch that no
# survivor's producer can have reached: its position plus what its
# pipeline holds (4 batches at the cell (2, 1)), and a producer runs
# about that far ahead of the rounds, so the latch is epoch 1 while the
# reshard comes by round FLEET_BPE - 8.  With a card step of ~1.4 s (48
# layers) the reshard came at round 12, or 13 on a slower host, which
# latched at epoch 2 with 20 batches; at ~0.7 s it came at round 9
# (PERF.md section 6).  26 batches leave room for either.
FLEET_GB, FLEET_BPE = 12, 26
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
# ImageNet-crop-like images of 32 x 32 x 3 behind 10 ms storage, 16 a batch.
# At 10 ms an item a second worker saves ~80 ms of a two-batch consensus
# trial, well above the host's timing noise; at 2 ms it saved ~18 ms, and a
# noisy host once measured the win under the coordinator's 5% anti-churn
# margin, so no cell was pushed.
FLEET_SERVE_WAVES = ((300, 4), (512, 8), (512, 8))   # (prompt, requests)
FLEET_FEATURES, FLEET_FEATURE_RES, FLEET_FEATURE_BATCH = 256, 32, 16
FLEET_FEATURE_LATENCY_S = 1e-2

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
# its cases, name -> ((B, S, T, H, K, D), masks): the dense training shape,
# the forward's mask cases, H = K, the example's smoke preset (d 32), head
# dim 128, mistral-large's group of 12 at head dim 128 (a cluster past
# the portable 8), phi-3-vision's head dim 96 (three 32-column swizzle
# panels a row) at its prefill of 576 patches and 512 text tokens, and head
# dim 16 non-causal with S and T off the tile.
# tests/test_torch_flash_schedule.py holds the backward's launch plan at
# these shapes on the CPU
BWD_CASES = {
    "train": ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64), {}),
    "window48": ((8, 512, 512, 14, 2, 64), dict(window=48)),
    "ragged300": ((4, 300, 300, 14, 2, 64), {}),
    "q_offset": ((8, 64, 512, 14, 2, 64), dict(q_offset=448)),
    "gqa1": ((4, 512, 512, 14, 14, 64), {}),
    "d32": ((8, 128, 128, 4, 2, 32), {}),
    "d128": ((2, 256, 256, 16, 8, 128), {}),
    "group12": ((2, 512, 512, 24, 2, 128), {}),
    "d96": ((2, 1088, 1088, 32, 32, 96), {}),
    "d16": ((2, 48, 80, 6, 2, 16), dict(causal=False)),
    # phase 20's per-rank shape: qwen2 at model 4 holds 4 / 1 heads of 64,
    # a dK / dV cluster of 4
    "tp_rank": ((2, 512, 512, 4, 1, 64), {}),
    # phase 20b's: qwen3 at model 4 holds 4 / 2 heads of 128, a cluster of 2
    "tp_big_rank": ((2, 512, 512, 4, 2, 128), {}),
    # phase 23's: phi-3-vision at model 2 holds 16 / 16 heads of 96 over
    # 576 patches and 512 text tokens; whisper 10 / 10 of 64: its
    # encoder's non-causal 1,500 x 1,500, the cross-attention's 224
    # queries over the 1,500 frames, the decoder's causal 224 x 224
    "tp_vlm_rank": ((2, 1088, 1088, 16, 16, 96), {}),
    "tp_whisper_enc_rank": ((2, 1500, 1500, 10, 10, 64),
                            dict(causal=False)),
    "tp_whisper_cross_rank": ((2, 224, 1500, 10, 10, 64),
                              dict(causal=False)),
    "tp_whisper_self_rank": ((2, 224, 224, 10, 10, 64), {}),
}

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
# phase 19's Trainer runs qwen2-0.5b at its published widths and
# DENSE_TRAINER_LAYERS of its 24 layers (cut to fit the time limit on a
# slow host): the restart's exactness and the DPT cache do not depend on
# depth; phase 18 keeps all 24
DENSE_TRAINER_LAYERS = 12
DENSE_LCG_VOCAB = 4096
EXAMPLE_STEPS = 100

# phase 13: the online tuner's drift flow (examples/torch_online_tuning.py),
# then the degraded steady state without the tuner, at the start and at
# the pick: DRIFT_STEADY timed steps after DRIFT_STEADY_WARMUP each
DRIFT_STEPS, DRIFT_AT, DRIFT_ITEMS = 600, 40, 4096
DRIFT_STEADY_WARMUP, DRIFT_STEADY = 8, 48

# phases 20-21: the model axis on the one card.  NCCL refuses two ranks on
# one device, so each phase runs its ranks as processes of their own on the
# card, joined by a gloo group through a FileStore in a temporary
# directory: every collective stages its tensor through host memory
# (transport's backend rule; each rank counts how its collectives moved
# their tensors and the phase fails unless all went through the host),
# each rank's compute runs on the card.  Their
# step and prefill times are not speeds: the ranks share one card and the
# collectives cross the host.  Phase 20 (tp_train): qwen2-0.5b at its
# published widths and TP_LAYERS of its 24 layers (the depth the card's
# time allows beside phase 23 on a slow host, PERF.md section 4) on
# (data 1, model TP_MODEL), padding plan (2, 8): 4 / 1 heads of 64 a rank
# and a vocabulary slice of 37,984 rows; one dp_manual step of TP_BATCH x
# TP_SEQ at remat "none" against the one-rank step on the same masters
# (AdamW eps DP_ADAM_EPS, as phase 17): loss to TP_LOSS_REL, grad norm to
# TP_NORM_REL, every leaf's first moment at a cosine of TP_MIN_COSINE to
# the one-rank step's, or, where bf16 rounding alone sets two one-rank
# computations of that kind of leaf further apart, within TP_FLOOR_RATIO
# x the kind's bf16 noise floor: the largest distance (1 - cosine), over
# the layers, between the one-rank gradient through the kernels and
# through the plain twins of that leaf of a layer (``wq``, ``bk``, ...).
# The key biases need it: their gradient comes only from rotary's
# modulation of a bias that softmax otherwise ignores, a small sum of
# large bf16 dK rows, and at model 4 each rank rounds its part of a kv
# head's dK to bf16 before the sum (first card run, NVIDIA H100 80GB
# HBM3, 700 W, PERF.md section 6: three key biases at 0.9987-0.9990
# against floors up to 8.1e-4, every other leaf >= 0.999; a floor taken
# leaf by leaf left one key bias at 2.1x its own).
# Every rank holds only its shards of the storage plan (each leaf's dims
# the rules map to "data" and "model", with the guard), built leaf by leaf
# from seed 0; its held bytes must equal the sum of its shards' sizes.  At
# qwen2's model 4 the attention leaves are unaligned (224 columns are 3.5
# heads, 32 half a kv head) and gathered over "model" once a layer, the
# d_ff and vocabulary shards aligned; each first moment is held by
# cosines summed over the ranks' shards, and the leaves every rank holds
# whole bit for bit.  The ranks' checkpoint is restored here at world 1:
# every shard's checksum equal to its rank's, the manifest a world-1
# save's.  Phase 20b (tp_train_big): qwen3-1.7b at its published widths
# (d_model 2,048, 16 / 8 heads of 128 with qk-norm, d_ff 6,144, tied
# vocabulary of 151,936) and BIG_LAYERS of its 28 layers (the depth the
# card's time allows beside phase 23) on (data 1, model BIG_MODEL), every
# leaf aligned: 4 / 2 heads,
# 1,536 d_ff columns and 37,984 vocabulary rows a rank, no gather over
# "model"; one dp_manual step of BIG_BATCH x BIG_SEQ at remat "none"
# against the one-rank step held as phase 20's, each rank's peak below
# the whole layout's fp32 state alone (uncut 1.72 B x 16 bytes, 27.5 GB;
# at 8 layers 0.71 B, 11.4 GB); the
# vocabulary-parallel lookup without its all-reduce must fail.
# Phase 21 (ep_serve): granite-moe-3b-a800m at its published widths and
# EP_LAYERS of its 32 layers (each rank stages every layer's data-sharded
# experts through the host at every call: 201 s for the phase uncut, PR
# 25, too long beside the kv_seq check; the depth is the cut the budget
# allows, no width or expert count is; at 4 layers its bf16 check read
# 0.9806 against a limit of 0.9883 on an NVIDIA H100 80GB HBM3 at 700 W,
# so it stays at 8) on (data EP_DATA, model
# EP_MODEL) through _serve_wrap under SERVE_RULES_BIG, its bf16 weights
# stored as the plan's shards: the embed dim over "data", gathered a layer
# at a time; heads over "model" (12 / 4 a rank); the 40 experts (no
# virtual layout: their axis maps to no mesh axis) and the vocabulary of
# 49,155 (under the guard) whole over "model", 20 experts computed a
# rank; a prefill of EP_BATCH x EP_PROMPT (EP_BATCH / EP_DATA rows a
# rank) and EP_STEPS teacher-forced decode steps against the one-rank port
# on the same weights serving each data rank's rows as a batch of their
# own (at capacity 1.25 an expert's capacity counts the tokens one data
# rank routes: the one-rank port over all four rows drops other
# assignments, min cosine 0.953 on the card).  In fp32 compute (an fp32
# K/V cache)
# every position's logit cosine at least EP_MIN_COSINE and top-1
# agreement at least EP_MIN_TOP1.  In bf16, the served dtype, a rounding
# difference compounds over 32 random layers (and can move a top-8
# choice: MoE routing is not bit-stable on the card, index_add_'s
# atomics), so each position's distance (1 - cosine) to the one-rank
# logits is held to EP_MIN_COSINE or, where larger, EP_FLOOR_RATIO x the
# bf16 noise floor: the largest distance over the positions between the
# one-rank logits through the kernels and through the plain twins.  bf16
# top-1 is recorded beside the plain twins' own, not held: over random
# weights' near-flat logits one run of the same code agreed at every
# position and the next at 17 of 18 (first card runs, NVIDIA H100 80GB
# HBM3, 700 W, PERF.md section 6: min cosine 0.99873 and 0.99870, floor
# 0.0026; fp32 min cosine 0.99999988, top-1 1.0).  The control, the MoE
# combine without its all-reduce, runs the prefill alone: each decode step
# gathers every layer's data-sharded leaves through the host as a prefill
# does.  A rank that outlives RANK_TIMEOUT_S fails the phase, and every
# rank is killed
TP_ARCH, TP_MODEL, TP_BATCH, TP_SEQ = "qwen2-0.5b", 4, 2, 512
TP_LAYERS = 6
TP_LOSS_REL, TP_NORM_REL, TP_MIN_COSINE = 2e-3, 5e-3, 0.999
TP_FLOOR_RATIO = 2.0
# the model-axis steps' second control: every reduce-scatter of the
# sequence-parallel residual a slice without its sum
SCATTER_CONTROL = "every scatter_seq slicing without its sum"
# a rank's peak with every leaf whole, at 24 layers (PERF.md)
TP_WHOLE_PEAK_GB = 14.4
# phase 3's SSD backward cases (SSD_BWD_ATOL_OF_MAX), name -> ((b, s, h,
# p, g, n, chunk), strided, dtype): the training shape, the fleet's and
# the dp phase's, phase 22's two ranks (hymba's 640 positions at chunk
# 256: a ragged end), p 32 with two groups, the test shapes (chunk 24; p
# 12, n 10), and the training shape in fp32 (the scalar kernels)
SSD_BWD_CASES = {
    "slice": ((TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128, 256), True,
              "bfloat16"),
    "fleet6": ((6, TRAIN_SEQ, 48, 64, 1, 128, 256), True, "bfloat16"),
    "dp_mb": ((TRAIN_BATCH // DP_MICROBATCHES, TRAIN_SEQ, 48, 64, 1, 128,
               256), True, "bfloat16"),
    "tp_ssm_rank": ((TP_BATCH, TP_SEQ, 24, 64, 1, 128, 256), True,
                    "bfloat16"),
    "tp_hybrid_rank": ((TP_BATCH, TP_SEQ + 128, 25, 64, 1, 16, 256), True,
                       "bfloat16"),
    "p32_groups": ((2, 512, 8, 32, 2, 64, 256), True, "bfloat16"),
    "t4_chunk24": ((1, 96, 6, 8, 2, 16, 24), False, "bfloat16"),
    "unaligned": ((1, 64, 3, 12, 1, 10, 32), False, "bfloat16"),
    "slice_fp32": ((TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128, 256), True,
                   "float32"),
}
# the norms' backward rows: (rows, d) of the train path's norms (qwen2's
# d_model, mamba2's d_model and its gate norm over d_inner)
RMSNORM_BWD_CASES = {"d896": (TRAIN_BATCH * TRAIN_SEQ, 896),
                     "d1536": (TRAIN_BATCH * TRAIN_SEQ, 1536),
                     "d3072": (TRAIN_BATCH * TRAIN_SEQ, 3072)}
RING_SHAPE = (4096, 896, 4864)          # (m, k, f) of ring_weight_matmul
BIG_ARCH, BIG_MODEL, BIG_BATCH, BIG_SEQ = "qwen3-1.7b", 4, 2, 512
BIG_LAYERS = 8
EP_ARCH, EP_DATA, EP_MODEL, EP_LAYERS = MOE_ARCH, 2, 2, 8
EP_BATCH, EP_PROMPT, EP_STEPS = 4, 512, 8
EP_MIN_COSINE, EP_MIN_TOP1, EP_FLOOR_RATIO = 0.999, 0.99, 2.0
# phase 21's serve_replicated checks, in its ranks after its own run, each
# held by its rule and constants: (a) its granite, one request of
# EP_PROMPT tokens and SOLO_STEPS teacher-forced decode steps, and
# SOLO_ROWS rows prefilled alone; (b) mixtral-8x22b at its published
# widths and SOLO_RING_LAYERS layers, one request of SOLO_RING_PROMPT
# tokens and SOLO_STEPS steps.  Both caches hold the slots the prompt and
# the steps write (516; mixtral's ring of its 4,096-token window), cut on
# kv_seq into EP_MODEL blocks.  The fp32 runs stop after the first decode
# step (SOLO_FP32_STEPS), the one whose partial softmaxes first combine a
# new key with the prefill's blocks: each call stages its fp32 leaves
# through the host (mixtral's layer of experts 2.4 GB a rank, ~10 s a
# call on the card); the bf16 runs, the served dtype, take every step
SOLO_STEPS, SOLO_ROWS = 4, 3
SOLO_FP32_STEPS = 1
SOLO_RING_LAYERS, SOLO_RING_PROMPT = 1, 4608
SOLO_RING_REDUCED = {
    "num_layers": "56 -> 1 (the one-rank reference holds the whole layer "
                  "on the card beside the four ranks' shards, in fp32 "
                  "too; the time of four ranks staging every call's "
                  "data-sharded experts through the host)"}
# phase 20's kv_seq serve check, inside its ranks after their step: its
# qwen2-0.5b under SERVE_RULES on (data 1, model TP_MODEL), its K/V cache of
# KV_MAX_LEN slots cut into blocks of KV_MAX_LEN / TP_MODEL a rank.  Each
# (rows, prompt length) of KV_PROMPTS is prefilled and decoded
# KV_STEPS - 1 greedy steps: 252 ends four slots before the first block
# boundary, so decode writes into the next rank's block; 24 leaves ranks
# 1-3 without a key throughout
KV_MAX_LEN, KV_STEPS = 1024, 9
KV_PROMPTS = ((4, 252), (2, 24))
KV_MIN_COSINE, KV_CACHE_OF_MAX = 0.9999, 1e-4
# phase 22: the families with an SSM under the model axis, two gloo ranks on
# (data 1, model SSM_TP_MODEL) for both models: hymba-1.5b (25 / 5 heads
# padded to (5, 6), 15 a rank over 3 kv heads each, straddling groups; 25
# of its 50 SSD heads a rank) and mamba2-780m (24 of 48 SSD heads), each at
# its published widths and SSM_TP_LAYERS layers (hymba's layer 0 global,
# the rest windowed with the 128 meta tokens as sinks).  Each steps once on
# TP_BATCH x TP_SEQ, held as phase 20 is, then serves under SERVE_RULES:
# (rows, prompt length) of SSM_SERVE's prompt sets, prefilled and decoded
# KV_STEPS - 1 greedy steps over a cache of the max_len text positions.
# Hymba's cache holds 128 + 2,176 = 2,304 slots, a block of 1,152 a rank:
# every decode query of the 2,056-token prompts sits past position 2,184,
# so its window of 1,024 starts past rank 0's block, which holds the sinks
# and keys outside the window; the 24-token prompts leave rank 1's block
# empty.  Each rank's fp32 SSM state is held within SSM_STATE_OF_MAX of
# the largest entry of its head slice of the one-rank state
SSM_TP_MODEL, SSM_TP_LAYERS = 2, 2
SSM_SERVE = {"tp_hybrid": (2176, ((2, 2056), (2, 24))),
             "tp_ssm": (520, ((2, 512), (2, 24)))}
SSM_STATE_OF_MAX = 1e-5
# layer 0's state is held to SSM_STATE_OF_MAX: its input is the same bits
# on both sides.  A deeper layer's input carries the layers above it, each
# summed over the ranks in another order, and its state is held to
# KV_CACHE_OF_MAX, as the K/V blocks are (mamba2's layers 1-3 after its
# prefill: 1.47e-5, first card run of this phase)
# after the decode steps each side has read its conv tail back from bf16
# (the cache's dtype whatever the compute dtype, as in repro), where an
# input one rounding apart lands a bf16 ulp (2^-8) apart: the decoded state
# and the K/V the steps wrote are held to 2^-7 of the largest entry, the
# prefill's (no bf16 on its path) to SSM_STATE_OF_MAX and KV_CACHE_OF_MAX
SSM_DECODED_OF_MAX = 2 ** -7
# phase 23: the vlm and encdec families under the model axis, two gloo
# ranks on (data 1, model VE_TP_MODEL) spawned once for both models:
# phi-3-vision-4.2b at its published widths and VE_VLM_LAYERS layers (32 /
# 32 heads of 96, 16 a rank, every leaf aligned; its 576 patches
# projected whole on every rank and prepended to the text, the residual
# whole: no seq_res behind a prefix) and whisper-large-v3 at its published
# widths with VE_ENC_LAYERS encoder and VE_DEC_LAYERS decoder layers (20 /
# 20 heads of 64, 10 a rank, self- and cross-attention split alike; both
# stacks sequence-parallel, 750 of the 1,500 frames and VE_SEQ / 2 tokens
# a rank).  Each steps once, held as phase 20 is (the vlm on TP_BATCH x
# (576 patches + TP_SEQ text), whisper on TP_BATCH x VE_SEQ behind its
# frames), then serves under SERVE_RULES: (rows, prompt length) of
# VE_SERVE with seeded patches or frames, prefilled and decoded
# KV_STEPS - 1 steps teacher-forced with the one-rank fp32 greedy tokens
# over a cache of max_len text positions cut on kv_seq: the vlm's 576 +
# 520 = 1,096 slots in blocks of 548, whisper's 232 self slots in blocks
# of 116 and its cross K/V in blocks of 750 encoder positions.  Every
# fp32 K/V block, after the prefill and after the steps, is held within
# KV_CACHE_OF_MAX of the largest entry of the one-rank cache
VE_TP_MODEL, VE_VLM_LAYERS, VE_ENC_LAYERS, VE_DEC_LAYERS = 2, 4, 2, 2
VE_SEQ = 224
# whisper's key biases' first moments, rounding noise (tp_verdict), held
# below this share of their layer's value bias's
KEY_BIAS_OF_BV = 0.1
VE_SERVE = {"tp_vlm": (520, (2, 512)), "tp_encdec": (232, (2, 224))}
# whisper's fp32 serve: its cross-attention decode combines the ranks'
# partial softmaxes over 750 encoder positions each, and the control that
# combines them with equal weights read a min cosine of 0.99975 (distance
# 2.5e-4) against the sound run's 0.9999994 (6e-7) on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 6): KV_MIN_COSINE's 1e-4 barely tells
# them apart, so whisper's fp32 logits and its control are held to a
# distance of 1e-5, between the two
VE_CROSS_MIN_COSINE = 1.0 - 1e-5
RANK_TIMEOUT_S = 420
# phase 24: the counted peak (the bytes live when the count starts plus
# the counter's peak) against torch.cuda.max_memory_allocated() of the same
# step; the counter leaves out the caching allocator's rounding and small
# copies a kernel's wrapper makes (PERF.md section 7)
DRYRUN_PEAK_REL = 0.15
# one production cell traced on meta under a fake group of 256 ranks
DRYRUN_CELL = ("qwen2-0.5b", "train_4k", "single")
DRYRUN_PREFILLS = 3             # timed prefills for the serve row


_T0 = time.perf_counter()


# the kernels' work formulas (src/repro_torch/roofline/costs.py), imported by
# main once the checkout's src is on the path
costs = None


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s``: seconds since the script started (a rank's
    lines: since the rank started), so each phase's wall time is the
    difference of two lines'."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - _T0}), flush=True)


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
    ("ssd_scan backward", ("ssd_bwd",)),
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


def profile_phase(torch, name: str, fn, expect=(), absent=()) -> dict:
    """Wall time, device busy time and idle share of one window, device
    time by kernel group, and the eight kernels that took the most device
    time in it.  Each name in ``expect`` must be part of a kernel that ran
    in the window (the main path went through it); its launches there are
    returned.  No kernel named in ``absent`` may run in it."""
    wall, busy, avgs = device_busy(torch, fn)
    seen = {k: sum(e.count for e in avgs if k in e.key) for k in expect}
    check(all(seen.values()), f"profile {name!r}: kernels {seen} expected")
    gone = {k: sum(e.count for e in avgs if k in e.key) for k in absent}
    check(not any(gone.values()),
          f"profile {name!r}: kernels {gone} ran, none expected")
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
            k = re.search(
                r"\d+((?:flash|ssd_scan|ssd_bwd)\w*?_kernel)(I\w+?E)?E", name)
            if k:
                args = (["float"] if k.group(2) == "IfE"
                        else re.findall(r"L[ib](\d+)E", k.group(2) or ""))
                name = k.group(1) + (f"<{','.join(args)}>" if args else "")
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def dynamic_smem(_build) -> dict:
    """Dynamic shared memory each tensor-core launch asks for at the
    shapes of the main paths, from the libraries' own size functions
    (ptxas reports only static shared memory)."""
    fl, sl = _build.load("flash_attention"), _build.load("ssd_scan")
    out = {f"flash_fwd_wgmma_kernel<{D},*>":
           fl.flash_attention_fwd_smem_bytes(1, D) for D in (64, 96, 128)}
    out["flash_fwd_decode_kernel<64>"] = fl.flash_attention_fwd_smem_bytes(
        2, 64)
    for D in (32, 64, 128):          # the backward's: d32, train, d128
        out[f"flash_bwd_dkdv_wgmma_kernel<{D}>"] = \
            fl.flash_attention_bwd_smem_bytes(2, D)
        out[f"flash_bwd_dq_wgmma_kernel<{D}>"] = \
            fl.flash_attention_bwd_smem_bytes(4, D)
    for stage, kernel in ((1, "ssd_scan_chunk_state_kernel"),
                          (3, "ssd_scan_chunk_scan_kernel")):
        out[f"{kernel} (chunk 256)"] = sl.ssd_scan_smem_bytes(stage, 256, 0)
    bl = _build.load("ssd_scan_bwd")
    for n in (16, 128):              # hymba's state width and mamba2's
        for stage, kernel in ((4, "ssd_scan_state_wgmma_kernel"),
                              (5, "ssd_scan_chunk_scan_wgmma_kernel")):
            out[f"{kernel}<{n}>"] = sl.ssd_scan_smem_bytes(stage, 256, n)
        out[f"ssd_bwd_chunk_wgmma_kernel<{n}>"] = bl.ssd_scan_bwd_smem_bytes(n)
    check(all(v > 0 for v in out.values()), f"shared memory sizes {out}")
    return out


# --------------------------------------------------------------------------
# phase 3: kernel checks
# --------------------------------------------------------------------------
# the flash rows whose calls serve requests: one call's host time rides on
# them (the decode rows and the serving prefill)
FLASH_HOST_ROWS = ("slice", "whisper_cross_decode",
                   "tp_whisper_cross_decode_rank")


def launched_variant(fa, before: dict) -> str:
    """The one forward kernel launched since ``before``, a copy of
    ``flash_attention.launches_by_variant``."""
    now = fa.flash_attention.launches_by_variant
    used = [k for k in now if now[k] != before[k]]
    check(len(used) == 1 and now[used[0]] == before[used[0]] + 1,
          f"flash forward launches {before} -> {now}: not one kernel")
    return used[0]


def forward_form(fa, variant: str, D: int, lse: bool = False) -> dict:
    """The forward kernel's name and what it asks of a multiprocessor
    (``lse``: the wgmma kernel that writes lse)."""
    name = {"wgmma": "flash_fwd_wgmma_kernel",
            "decode": "flash_fwd_decode_kernel",
            "scalar": "flash_fwd_kernel"}[variant]
    args = f"{D},{int(lse)}" if variant == "wgmma" else f"{D}"
    return dict(variant=variant, forward_kernel=f"{name}<{args}>",
                attributes=(None if variant == "scalar"
                            else fa.forward_attributes(variant, D, lse)))


def host_us(torch, fn, calls: int = 200, runs: int = 5) -> float:
    """One call's host time in microseconds: the least, over ``runs``, of
    ``calls`` calls made without a sync, divided by ``calls``."""
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


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
        before = dict(fa.flash_attention.launches_by_variant)
        out = fa.flash_attention(q, k, v, **kw)
        form = forward_form(fa, launched_variant(fa, before), D)
        again = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"flash {name} {dtype}: two calls on "
              f"the same inputs gave different bits")
        del again
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

        flops, nbytes = costs.flash_forward(
            B, S, T, H, K, D, causal=causal, window=window,
            q_offset=q_offset, elem=q.element_size())
        bound_ms, bound_by = costs.bound(flops, nbytes, dtype)
        fns = {"kernel": lambda: fa.flash_attention(q, k, v, **kw),
               "plain": lambda: fa.flash_attention_plain(q, k, v, **kw),
               "library": library}
        if name in FLASH_HOST_ROWS and dtype == "bfloat16":
            form["host_us"] = host_us(torch, fns["kernel"])
        # the row names the backend SDPA took
        row = dict(kernel="flash_attention", case=name, dtype=dtype,
                   shape=dict(B=B, S=S, T=T, H=H, K=K, D=D, causal=causal,
                              window=window, q_offset=q_offset),
                   **form, repeat_equal=True,
                   max_abs_err=err, rtol=rtol, atol=atol,
                   atol_needed_of_max=atol_needed(out, ref, rtol) / ref_max,
                   **control, **timings(torch, fns),
                   library_backend=sdpa_backend(torch, library),
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        emit("kernel_check", **row)
        rows.append(row)
    return rows


def check_flash_partial(torch, fa, ref, gen, name, B, S, T, H, K, D):
    """``flash_attention_partial``, the forward kernel writing o and lse
    over one block of the keys (non-causal: a rank's block of whisper's
    cross K/V cache at a decode step), against ``ref.mha_partial`` on the
    same inputs, in bf16 and fp32: out to TOL, lse to TOL_LSE.  The lse
    check must fail a kernel whose last tile counted its zero-filled keys
    (the control).  The yardstick is one call of PyTorch's
    memory-efficient attention asked for its logsumexp (the same function;
    a layout (B, H, S, D) and an lse padded to 32 rows)."""
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
        before = dict(fa.flash_attention.launches_by_variant)
        out, lse = fa.flash_attention_partial(q, k, v, causal=False)
        form = forward_form(fa, launched_variant(fa, before), D, lse=True)
        again = fa.flash_attention_partial(q, k, v, causal=False)
        torch.cuda.synchronize()
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"flash partial {name} {dtype}: two calls on the same inputs "
              f"gave different bits")
        del again
        want, want_lse = ref.mha_partial(q.float(), k.float(), v.float(),
                                         causal=False)
        rtol, atol_of_max = TOL[dtype]
        ref_max = float(want.abs().max())
        atol = rtol if atol_of_max is None else atol_of_max * ref_max
        err = max_err(out, want, rtol, atol)
        lse_err = max_err(lse, want_lse, TOL_LSE)
        tail = -T % FLASH_KEY_TILE
        zk = k.new_zeros((B, tail, K, D))
        _, faulty = ref.mha_partial(q.float(), torch.cat([k, zk], 1).float(),
                                    torch.cat([v, zk], 1).float(),
                                    causal=False)
        faulty_err = float((faulty - want_lse).abs().max())
        check(faulty_err > TOL_LSE * (1.0 + float(want_lse.abs().max())),
              f"{name}: an lse counting {tail} zero-filled keys passes "
              f"({faulty_err})")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        eff = torch.ops.aten._scaled_dot_product_efficient_attention

        def library():
            return eff(qt, kt, vt, None, True)

        flops, nbytes = costs.flash_partial(B, S, T, H, K, D, causal=False,
                                            elem=q.element_size())
        bound_ms, bound_by = costs.bound(flops, nbytes, dtype)
        fns = {"kernel": lambda: fa.flash_attention_partial(q, k, v,
                                                            causal=False),
               "plain": lambda: ref.mha_partial(q, k, v, causal=False),
               "library": library}
        if name in FLASH_HOST_ROWS and dtype == "bfloat16":
            form["host_us"] = host_us(torch, fns["kernel"])
        row = dict(kernel="flash_attention", case=name, dtype=dtype,
                   partial=True,
                   shape=dict(B=B, S=S, T=T, H=H, K=K, D=D, causal=False,
                              window=0, q_offset=0),
                   **form, repeat_equal=True,
                   max_abs_err=err, lse_max_abs_err=lse_err, rtol=rtol,
                   atol=atol, lse_tol=TOL_LSE,
                   atol_needed_of_max=atol_needed(out, want, rtol) / ref_max,
                   tail_counted_lse_err=faulty_err, **timings(torch, fns),
                   library_backend="efficient_attention (with lse)",
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        emit("kernel_check", **row)
        rows.append(row)
    return rows


def check_flash_train(torch, fa, gen, name, B, S, T, H, K, D):
    """The forward that ``_FlashAttention`` runs under a gradient (causal,
    bf16, o and lse) at the dense training shape, against the plain twin
    ``flash_attention_plain_lse`` on the same inputs in fp32: o to TOL,
    lse to TOL_LSE; a second call must give the same bits.  The
    yardsticks are one call of PyTorch's memory-efficient attention and
    one of cuDNN attention, each asked for its logsumexp (the same
    function, on (B, H, S, D) views with K and V repeated to H heads):
    ``library_ms`` is the faster."""
    dt = torch.bfloat16
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
               for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")

    def kernel():
        return fa._forward_kernel(q, k, v, True, 0, 0, None, lse)

    before = dict(fa.flash_attention.launches_by_variant)
    out = kernel()
    form = forward_form(fa, launched_variant(fa, before), D, lse=True)
    first_lse = lse.clone()
    again = kernel()
    torch.cuda.synchronize()
    check(torch.equal(out, again) and torch.equal(lse, first_lse),
          f"flash {name}: two calls on the same inputs gave different bits")
    del again, first_lse
    want, want_lse = fa.flash_attention_plain_lse(q.float(), k.float(),
                                                  v.float(), causal=True)
    rtol, atol_of_max = TOL["bfloat16"]
    ref_max = float(want.abs().max())
    atol = atol_of_max * ref_max
    err = max_err(out, want, rtol, atol)
    lse_err = max_err(lse, want_lse, TOL_LSE)
    need = atol_needed(out, want, rtol) / ref_max
    del want, want_lse
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    cudnn = torch.ops.aten._scaled_dot_product_cudnn_attention
    fns = {"kernel": kernel,
           "plain": lambda: fa.flash_attention_plain_lse(q, k, v,
                                                         causal=True),
           "efficient": lambda: eff(qt, kt, vt, None, True, is_causal=True)}
    try:
        cudnn(qt, kt, vt, None, True, 0.0, True, False)
        fns["cudnn"] = lambda: cudnn(qt, kt, vt, None, True, 0.0, True,
                                     False)
    except RuntimeError as e:  # a yardstick the card's cuDNN lacks
        print(f"chip_smoke: cuDNN attention with lse at {name}: {e}",
              file=sys.stderr)
    times = timings(torch, fns)
    libs = {k: times[f"{k}_ms"] for k in ("efficient", "cudnn")
            if f"{k}_ms" in times}
    backend = min(libs, key=libs.get)
    # the forward's FLOPs and bytes, and its fp32 lse written
    flops, nbytes = costs.flash_forward(B, S, T, H, K, D, causal=True,
                                        elem=2)
    nbytes += 4.0 * B * H * S
    bound_ms, bound_by = costs.bound(flops, nbytes, "bfloat16")
    row = dict(kernel="flash_attention", case=name, dtype="bfloat16",
               lse=True,
               shape=dict(B=B, S=S, T=T, H=H, K=K, D=D, causal=True,
                          window=0, q_offset=0),
               **form, repeat_equal=True, max_abs_err=err,
               lse_max_abs_err=lse_err, rtol=rtol, atol=atol,
               lse_tol=TOL_LSE, atol_needed_of_max=need, **times,
               library_ms=libs[backend],
               library_backend=f"{backend} attention (with lse, K / V "
                               f"repeated to {H} heads)",
               bound_ms=bound_ms, bound_by=bound_by, flops=flops,
               bytes=nbytes)
    emit("kernel_check", **row)
    del q, k, v, qt, kt, vt
    return [row]


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
    to BWD_CONTROL_BITS mantissa bits must fail that limit, and a second
    call on the same inputs must give the same bits.  The row names the
    variant that served it (wgmma at every head dim), the dK / dV
    cluster size, each kernel's registers and shared memory
    (``cudaFuncGetAttributes``) and the blocks of it the card holds at
    once (the dK / dV pass in its clusters).  Times the three launches together and
    each alone on buffers made once, the plain backward and SDPA's
    backward."""
    dt = torch.bfloat16
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, T, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    plan = fa.backward_plan(B, S, T, H, K, D, **kw)
    check(plan.variant == "wgmma",
          f"flash backward {name}: head dim {D} served by {plan.variant}")
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves, do)
    again = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                                do)
    torch.cuda.synchronize()
    repeat_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    check(repeat_equal, f"flash backward {name}: two calls on the same "
          f"inputs gave different bits")
    del again
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
    scratch = fa.backward_scratch(B, H, S, "cuda")
    bufs = tuple(torch.empty_like(x) for x in (q, k, v))

    def kernel(which):
        return lambda: fa.backward_kernel(q, k, v, o, lse, do, **kw,
                                          which=which, scratch=scratch,
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

    flops, nbytes = costs.flash_backward(B, S, T, H, K, D, **kw, elem=2)
    bound_ms, bound_by = costs.bound(flops, nbytes, "bfloat16")
    fns = {"kernel": kernel(7), "preprocess": kernel(1), "dkdv": kernel(2),
           "dq": kernel(4),
           "plain": lambda: fa.flash_attention_backward_plain(
               q, k, v, o_t, lse_t, do, **kw),
           "library": library}
    row = dict(kernel="flash_attention_backward", case=name,
               dtype="bfloat16",
               shape=dict(B=B, S=S, T=T, H=H, K=K, D=D, causal=causal,
                          window=window, q_offset=q_offset),
               variant=plan.variant, cluster=plan.cluster,
               blocks=dict(dkdv=math.prod(plan.grid_dkdv),
                           dq=math.prod(plan.grid_dq)),
               attributes=fa.backward_attributes(D, H // K),
               max_abs_err=max(g["max_abs_err"] for g in grads.values()),
               grads=grads, control_bits=BWD_CONTROL_BITS, refused=refused,
               repeat_equal=repeat_equal,
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
        flops, nbytes = costs.rmsnorm(rows_, d, elem=x.element_size(),
                                      scale_elem=scale.element_size())
        bound_ms, bound_by = costs.bound(flops, nbytes, "float32")
        row = dict(kernel="rmsnorm", case=name, dtype=dtype,
                   shape=dict(rows=rows_, d=d), max_abs_err=err,
                   tol=TOL_NORM[dtype],
                   **timings(torch, {
                       "kernel": lambda: rn.rmsnorm(x, scale, eps=1e-6),
                       "plain": lambda: rn.rmsnorm_plain(x, scale, 1e-6),
                       "library": lambda: F.rms_norm(x, (d,), scale_t, 1e-6)}),
                   bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes)
        emit("kernel_check", **row)
        out_rows.append(row)
    return out_rows


def check_rmsnorm_split(torch, F, rn, ref, gen, name, rows_, d_full, n):
    """The split-row rmsnorm pair at one model rank's part, (rows_,
    d_full / n) of rows of ``d_full`` split over ``n`` ranks, in bf16 and
    fp32: the ranks' ``row_sumsq`` added here in place of the all-reduce,
    then each part's ``rmsnorm_total``; the joined parts held against the
    plain twins (``ref.row_sumsq`` / ``ref.rmsnorm_total``) and against
    the whole row's plain rmsnorm.  Each kernel is timed alone at the
    rank's part beside its plain twin and its bound; no PyTorch call
    computes either (``library_ms`` None), and ``F.rms_norm`` over the
    whole row is timed beside them for scale.  Returns (row_sumsq rows,
    rmsnorm_total rows)."""
    out = ([], [])
    d = d_full // n
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x = torch.randn((rows_, d_full), generator=gen,
                        device="cuda").to(dt)
        scale = torch.randn((d_full,), generator=gen, device="cuda")
        parts = [x[:, i * d:(i + 1) * d] for i in range(n)]
        scales = [scale[i * d:(i + 1) * d] for i in range(n)]
        sums = [rn.row_sumsq(p) for p in parts]
        total = sum(sums)
        got = torch.cat([rn.rmsnorm_total(p, w, total, d_full, 1e-6)
                         for p, w in zip(parts, scales)], dim=-1)
        torch.cuda.synchronize()
        plain_total = sum(ref.row_sumsq(p) for p in parts)
        sum_err = max_err(sums[0], ref.row_sumsq(parts[0]), 1e-5)
        err = max_err(got, torch.cat(
            [ref.rmsnorm_total(p, w, plain_total, d_full, 1e-6)
             for p, w in zip(parts, scales)], dim=-1), TOL_NORM[dtype])
        whole_err = max_err(got, rn.rmsnorm_plain(x, scale, 1e-6),
                            TOL_NORM[dtype])
        p0, w0 = parts[0], scales[0]
        whole = timings(torch, {"library": lambda: F.rms_norm(
            x, (d_full,), scale.to(dt), 1e-6)})
        for i, (kernel, fns, flops, nbytes) in enumerate((
                ("row_sumsq", {
                    "kernel": lambda: rn.row_sumsq(p0),
                    "plain": lambda: ref.row_sumsq(p0)},
                 *costs.row_sumsq(rows_, d, elem=x.element_size())),
                ("rmsnorm_total", {
                    "kernel": lambda: rn.rmsnorm_total(p0, w0, total,
                                                       d_full, 1e-6),
                    "plain": lambda: ref.rmsnorm_total(p0, w0, total,
                                                       d_full, 1e-6)},
                 *costs.rmsnorm_total(rows_, d, elem=x.element_size(),
                                      scale_elem=w0.element_size())))):
            bound_ms, bound_by = costs.bound(flops, nbytes, "float32")
            row = dict(kernel=kernel, case=name, dtype=dtype,
                       shape=dict(rows=rows_, d=d, d_full=d_full, ranks=n),
                       max_abs_err=sum_err if i == 0 else err,
                       whole_row_err=whole_err, tol=TOL_NORM[dtype],
                       **timings(torch, fns), library_ms=None,
                       whole_row_library_ms=whole["library_ms"],
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                       bytes=nbytes)
            emit("kernel_check", **row)
            out[i].append(row)
    return out


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
        flops, nbytes = costs.rmsnorm_residual(
            rows_, d, elem=x.element_size(), scale_elem=scale.element_size())
        bound_ms, bound_by = costs.bound(flops, nbytes, "float32")
        # no single PyTorch call adds and normalises with two outputs
        row = dict(kernel="rmsnorm_residual", case=name, dtype=dtype,
                   shape=dict(rows=rows_, d=d), max_abs_err=err,
                   tol=TOL_NORM[dtype],
                   **timings(torch, {
                       "kernel": lambda: rn.rmsnorm_residual(x, res, scale),
                       "plain": lambda: rn.rmsnorm_residual_plain(
                           x, res, scale, 1e-6)}),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes)
        emit("kernel_check", **row)
        out_rows.append(row)
    return out_rows


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


def launched_ssd_variant(ss, before: dict) -> str:
    """The one SSD variant launched since ``before``, a copy of
    ``ssd_scan.launches_by_variant``."""
    now = ss.ssd_scan.launches_by_variant
    used = [k for k in now if now[k] != before[k]]
    check(len(used) == 1 and now[used[0]] == before[used[0]] + 1,
          f"ssd_scan launches {before} -> {now}: not one variant")
    return used[0]


def ssd_second_call_equal(torch, variant: str, first, call):
    """For the wgmma kernels, whether a second call gives the same bits
    (they sum in a fixed order; a race would show here); None for the
    others."""
    if variant != "wgmma":
        return None
    second = call()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, tuple) else (first,)
    seconds = second if isinstance(second, tuple) else (second,)
    same = all(bool(torch.equal(a, b)) for a, b in zip(firsts, seconds))
    check(same, "ssd_scan: a second wgmma call differs from the first")
    return same


def check_ssd(torch, ops, ss, plain_ctx, gen, name, b, s, h, p, g, n, chunk,
              *, strided=False):
    """``ops.ssd`` (which pads a sequence that is not a multiple of the
    chunk) against the same call routed to the plain twin."""
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt_type = getattr(torch, dtype)
        x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, dt_type,
                                    strided)
        before = dict(ss.ssd_scan.launches_by_variant)
        out = ops.ssd(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        variant = launched_ssd_variant(ss, before)
        same = ssd_second_call_equal(
            torch, variant, out, lambda: ops.ssd(x, dt, A, B, C, chunk=chunk))
        with plain_ctx():
            ref = ops.ssd(x, dt, A, B, C, chunk=chunk)
        check(out.shape == x.shape and out.dtype == x.dtype,
              f"ssd_scan output {tuple(out.shape)} {out.dtype}")
        rtol, atol_of_max = TOL_SSD[dtype]
        y_max = float(ref.float().abs().max())
        err = max_err(out, ref, rtol, atol_of_max * y_max)
        flops, nbytes = costs.ssd_scan(b, s, h, p, g, n, chunk,
                                       elem=x.element_size())
        bound_ms, bound_by = costs.bound(flops, nbytes, dtype)

        def plain():
            with plain_ctx():
                return ops.ssd(x, dt, A, B, C, chunk=chunk)

        fns = {"kernel": lambda: ops.ssd(x, dt, A, B, C, chunk=chunk),
               "plain": plain}
        # no PyTorch call computes a selective scan
        row = dict(kernel="ssd_scan", case=name, dtype=dtype,
                   variant=variant, second_call_bit_equal=same,
                   shape=dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=chunk,
                              strided=strided),
                   max_abs_err=err, tol=rtol, atol=atol_of_max * y_max,
                   # what the check's atol has to be, against its limit
                   atol_needed_of_max=atol_needed(out, ref, rtol) / y_max,
                   atol_of_max=atol_of_max,
                   **timings(torch, fns),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   fp32_fma_floor_ms=flops / costs.PEAK_FLOPS["float32"]
                   * 1e3,
                   flops=flops, bytes=nbytes)
        emit("kernel_check", **row)
        rows.append(row)
    return rows


def check_ssd_state(torch, ops, ss, plain_ctx, gen, name, b, s, h, p, g, n,
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
        before = dict(ss.ssd_scan.launches_by_variant)
        y, state = ops.ssd_prefill(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        variant = launched_ssd_variant(ss, before)
        same = ssd_second_call_equal(
            torch, variant, (y, state),
            lambda: ops.ssd_prefill(x, dt, A, B, C, chunk=chunk))
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
        flops, nbytes = costs.ssd_scan(b, s, h, p, g, n, chunk,
                                       elem=x.element_size(), state=True)
        bound_ms, bound_by = costs.bound(flops, nbytes, dtype)

        def plain():
            with plain_ctx():
                return ops.ssd_prefill(x, dt, A, B, C, chunk=chunk)

        row = dict(kernel="ssd_scan", case=name, dtype=dtype, state=True,
                   variant=variant, second_call_bit_equal=same,
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


# the SSD rows at test shapes (small p or n, chunks of 8 to 32, rows that
# are not whole 16-byte chunks): the mma kernels serve them; every other
# bf16 row is at a model's shapes and takes the wgmma kernels
SSD_MMA_ROWS = ("t1", "t2_groups", "t3_g_eq_h", "t4_chunk24", "unaligned")
# the CUDA kernel of each SSD stage entry, by variant (<n>: the state
# width the wgmma kernels are built for)
SSD_STAGE_KERNELS = {
    "mma": {"chunk_state": "ssd_scan_chunk_state_kernel",
            "state_passing": "ssd_scan_state_passing_kernel",
            "chunk_scan": "ssd_scan_chunk_scan_kernel"},
    "wgmma": {"state": "ssd_scan_state_wgmma_kernel<{n}>",
              "chunk_scan": "ssd_scan_chunk_scan_wgmma_kernel<{n}>"},
}


def check_ssd_stages(torch, ops, ss, ref, gen, name, b, s, h, p, g, n,
                     chunk, *, strided=False):
    """Each bf16 kernel of the variant serving these inputs
    (``ssd_scan.variant``; padded to the chunk as ``ops.ssd`` pads) alone
    against its plain stage function, on the same inputs: a later kernel
    takes the plain stages' outputs before it, so a fault shows in the
    kernel that has it.  The mma kernels: cum and the state passing (the
    entering states and the final state) are fp32 on both sides (the fp32
    tolerance); the states of stage 1 and y of stage 3 round a product
    operand to bf16 (the bf16 one).  The wgmma kernels: the state kernel's
    cum (fp32) and its entering states as pairs (``ref.ssd_state_join``)
    and final state (bf16: it rounds x dt exp(total - cum) to bf16 as stage
    1 does) against ``ref.ssd_chunk_state`` then
    ``ref.ssd_state_passing``; the chunk scan's y (bf16) from the plain
    cum and the plain states as pairs (``ref.ssd_state_split``).  Each
    kernel's time is its C entry's alone, on buffers made once outside the
    timed calls (state passing works in place, which changes the values
    but not the work)."""
    x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, torch.bfloat16,
                                strided)
    x, dt, B, C, chunk = ops._pad_to_chunk(x, dt, B, C, chunk)
    variant = ss._variant_of(x, B, C, chunk)
    cum, states = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    entering, final = ref.ssd_state_passing(states, cum)

    def err(out, ref_, dtype):
        rtol, atol_of_max = TOL_SSD[dtype]
        y_max = float(ref_.float().abs().max())
        return (max_err(out, ref_, rtol, atol_of_max * y_max), rtol,
                atol_needed(out, ref_, rtol) / y_max)

    # the C entries alone on buffers made once: scratch, a copy of stage
    # 1's states for the in-place stage 2, contiguous cum / entering states
    y_buf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    cum_buf, states_buf = ss._scratch(x, B, chunk, variant)
    cum_c = cum.contiguous()

    def entry(stage, cum_, states_):
        return lambda: ss._call(ss.STAGES[variant][stage], x, dt, A, B, C,
                                y_buf, cum_, states_, chunk)

    if variant == "wgmma":
        pairs = ref.ssd_state_split(entering)
        y = ref.ssd_chunk_scan(x, dt, B, C, cum, ref.ssd_state_join(pairs),
                               chunk=chunk)
        k_cum, k_pairs, k_final = ss.run_stage("state", x, dt, A, B, C,
                                               chunk=chunk)
        k_y = ss.run_stage("chunk_scan", x, dt, A, B, C, chunk=chunk,
                           cum=cum, states=pairs)
        torch.cuda.synchronize()

        def plain_state():
            c_, s_ = ref.ssd_chunk_state(x, dt, A, B, chunk=chunk)
            return ref.ssd_state_split(ref.ssd_state_passing(s_, c_)[0])

        pairs_c = pairs.contiguous()
        cases = {
            "state": (
                [err(k_cum, cum, "float32"),
                 err(ref.ssd_state_join(k_pairs), entering, "bfloat16"),
                 err(k_final, final, "bfloat16")],
                entry("state", cum_buf, states_buf), plain_state),
            "chunk_scan": (
                [err(k_y, y, "bfloat16")],
                entry("chunk_scan", cum_c, pairs_c),
                lambda: ref.ssd_chunk_scan(x, dt, B, C, cum,
                                           ref.ssd_state_join(pairs),
                                           chunk=chunk)),
        }
    else:
        y = ref.ssd_chunk_scan(x, dt, B, C, cum, entering, chunk=chunk)
        k_cum, k_states = ss.run_stage("chunk_state", x, dt, A, B, C,
                                       chunk=chunk)
        k_entering, k_final = ss.run_stage("state_passing", x, dt, A, B, C,
                                           chunk=chunk, cum=cum,
                                           states=states)
        k_y = ss.run_stage("chunk_scan", x, dt, A, B, C, chunk=chunk,
                           cum=cum, states=entering)
        torch.cuda.synchronize()
        entering_c = entering.contiguous()
        passing_buf = states.contiguous().clone()
        cases = {
            "chunk_state": (
                [err(k_cum, cum, "float32"),
                 err(k_states, states, "bfloat16")],
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
                   variant=variant,
                   cuda_kernel=SSD_STAGE_KERNELS[variant][stage].format(n=n),
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


def launched_bwd_variant(ss, before: dict) -> str:
    """The one SSD backward variant launched since ``before``, a copy of
    ``ssd_scan.backward_launches_by_variant``."""
    now = ss.ssd_scan.backward_launches_by_variant
    used = [k for k in now if now[k] != before[k]]
    check(len(used) == 1 and now[used[0]] == before[used[0]] + 1,
          f"ssd_scan backward launches {before} -> {now}: not one variant")
    return used[0]


def check_ssd_backward(torch, ss, ref, gen, name, b, s, h, p, g, n, chunk,
                       *, strided, dtype):
    """The SSD scan's backward kernels through ``_SSDScan`` (as the models
    call them) against the fp32 autograd recompute on the same inputs,
    each gradient to the staged twin's own distance from it
    (SSD_BWD_ATOL_OF_MAX, its own for each), a control at
    BWD_CONTROL_BITS mantissa bits that must fail, a second call that must
    give the same bits, and the variant ``backward_variant`` names
    (``wgmma`` at the models' shapes, ``mma`` at the narrow and unaligned
    ones, ``scalar`` for fp32).  Times the kernels (the
    backward's own fp32 walk for the entering states, then its d-state
    walk, chunk kernel and reduction) on inputs made once, each kernel of
    one call alone from the profiler, and the plain recompute
    (``ssd_scan_backward``); no PyTorch call computes a selective scan."""
    dt_type = getattr(torch, dtype)
    x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, g, n, dt_type,
                                strided)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dt_type)

    def through():
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
        return torch.autograd.grad(ss.ssd_scan(*leaves, chunk=chunk), leaves,
                                   dy)

    before = dict(ss.ssd_scan.backward_launches_by_variant)
    got = through()
    torch.cuda.synchronize()
    variant = launched_bwd_variant(ss, before)
    named = ss._backward_variant_of(x, B, C, dy, chunk)
    check(variant == named,
          f"ssd backward {name} {dtype}: served by {variant}, "
          f"backward_variant names {named}")
    again = through()
    torch.cuda.synchronize()
    repeat_equal = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    check(repeat_equal, f"ssd backward {name}: two calls on the same inputs "
          f"gave different bits")
    del again
    oracle = ss.ssd_scan_backward(x.float(), dt, A, B.float(), C.float(),
                                  dy.float(), chunk=chunk)
    twin = ref.ssd_chunked_backward(x, dt, A, B, C, dy, chunk=chunk)
    grads = {}
    for gname, g_, r, t in zip(SSD_BWD_GRADS, got, oracle, twin):
        check(g_.shape == r.shape and g_.dtype == t.dtype,
              f"ssd backward {name}: {gname} {tuple(g_.shape)} {g_.dtype}")
        check(bool(torch.isfinite(g_.float()).all()),
              f"ssd backward {name}: {gname} is not finite")
        ref_max = float(r.abs().max())
        err = float((g_.float() - r).abs().max())
        twin_err = float((t.float() - r).abs().max())
        limit = (BWD_TWIN_RATIO * twin_err
                 + SSD_BWD_ATOL_OF_MAX[dtype][gname] * ref_max)
        control = float((coarsen(torch, g_, BWD_CONTROL_BITS).float()
                         - r).abs().max())
        grads[gname] = dict(max_abs_err=err, twin_err=twin_err, limit=limit,
                            atol_of_max=SSD_BWD_ATOL_OF_MAX[dtype][gname],
                            ref_max=ref_max, control_err=control,
                            err_of_max=err / max(ref_max, 1e-30),
                            vs_twin=float((g_.float() - t.float()).abs()
                                          .max()))
        check(err <= limit, f"ssd backward {name} {dtype}: {gname} off by "
              f"{err}, limit {limit} (twin {twin_err}, max |ref| "
              f"{ref_max})")
        check(control > limit,
              f"ssd backward {name}: {gname} at {BWD_CONTROL_BITS} "
              f"mantissa bits ({control}) passes the limit {limit}")
    del got, oracle, twin
    refused = {}
    if name == "slice":
        # what no variant takes raises, and nothing falls back
        refused = dict(
            float16=raises(lambda: ss.backward_variant(p, n, chunk,
                                                       torch.float16),
                           NotImplementedError),
            wide_p=raises(lambda: ss.backward_variant(p + 16, n, chunk,
                                                      dt_type),
                          NotImplementedError))
        check(all(refused.values()),
              f"ssd backward: a call no variant takes did not raise: "
              f"{refused}")

    def kernel():
        return ss.backward_kernel(x, dt, A, B, C, dy, chunk=chunk)

    _, _, avgs = device_busy(torch, lambda: [kernel() for _ in range(5)])
    stages_ms = {e.key[:60]: e.self_device_time_total / 1e3 / 5
                 for e in avgs if e.self_device_time_total > 0}
    flops, nbytes = costs.ssd_scan_backward(b, s, h, p, g, n, chunk,
                                            elem=x.element_size())
    bound_ms, bound_by = costs.bound(flops, nbytes, dtype)
    row = dict(kernel="ssd_scan_backward", case=name, dtype=dtype,
               variant=variant,
               forward_variant=ss._variant_of(x, B, C, chunk),
               shape=dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=chunk,
                          strided=strided),
               max_abs_err=max(v["max_abs_err"] for v in grads.values()),
               grads=grads, control_bits=BWD_CONTROL_BITS, refused=refused,
               repeat_equal=repeat_equal, stages_ms=stages_ms,
               **timings(torch, {
                   "kernel": kernel,
                   "plain": lambda: ss.ssd_scan_backward(x, dt, A, B, C, dy,
                                                         chunk=chunk)}),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               flops=flops, bytes=nbytes)
    emit("kernel_check", **row)
    del x, dt, A, B, C, dy
    torch.cuda.empty_cache()
    return [row]


def check_rmsnorm_backward(torch, F, rn, gen, name, rows_, d):
    """rmsnorm's backward kernels through ``_RMSNorm`` (as the models call
    them) against the plain twin ``rmsnorm_backward`` on the same inputs:
    dx to TOL_NORM of the input's type and dscale, fp32 whatever that
    type (both sides sum it over every row in fp32, in another order), to
    TOL_NORM["float32"] and that of its largest entry; a second call must
    give the same bits.  Times the kernels, the twin and F.rms_norm's
    autograd backward alone (its forward made once), and the bound."""
    out_rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x = torch.randn((rows_, d), generator=gen, device="cuda").to(dt)
        scale = torch.randn((d,), generator=gen, device="cuda")
        dy = torch.randn((rows_, d), generator=gen, device="cuda").to(dt)

        def through():
            xl = x.detach().requires_grad_()
            sl = scale.detach().requires_grad_()
            return torch.autograd.grad(rn.rmsnorm(xl, sl, eps=1e-6),
                                       (xl, sl), dy)

        before = rn.rmsnorm.backward_launches
        got = through()
        torch.cuda.synchronize()
        check(rn.rmsnorm.backward_launches == before + 1,
              f"rmsnorm backward {name}: the kernels did not launch once")
        repeat_equal = all(torch.equal(a, b) for a, b in zip(got, through()))
        check(repeat_equal, f"rmsnorm backward {name}: two calls on the "
              f"same inputs gave different bits")
        twin = rn.rmsnorm_backward(x, scale, dy, 1e-6)
        tol = TOL_NORM[dtype]
        err_dx = max_err(got[0], twin[0], tol)
        tol_ds = TOL_NORM["float32"]
        ds_max = float(twin[1].float().abs().max())
        err_ds = max_err(got[1], twin[1], tol_ds, tol_ds * ds_max)
        xl = x.detach().requires_grad_()
        sl = scale.to(dt).detach().requires_grad_()
        yl = F.rms_norm(xl, (d,), sl, 1e-6)
        flops, nbytes = costs.rmsnorm_backward(
            rows_, d, elem=x.element_size(), scale_elem=scale.element_size())
        bound_ms, bound_by = costs.bound(flops, nbytes, "float32")
        row = dict(kernel="rmsnorm_backward", case=name, dtype=dtype,
                   shape=dict(rows=rows_, d=d),
                   max_abs_err=max(err_dx, err_ds), dx_err=err_dx,
                   dscale_err=err_ds, dscale_err_of_max=err_ds / ds_max,
                   tol=tol, dscale_tol=tol_ds, repeat_equal=repeat_equal,
                   blocks=rn.backward_blocks(rows_),
                   **timings(torch, {
                       "kernel": lambda: rn.backward_kernel(x, scale, dy,
                                                            1e-6),
                       "plain": lambda: rn.rmsnorm_backward(x, scale, dy,
                                                            1e-6),
                       "library": lambda: torch.autograd.grad(
                           yl, (xl, sl), dy, retain_graph=True)}),
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        emit("kernel_check", **row)
        out_rows.append(row)
        del x, dy, xl, sl, yl, got, twin
    return out_rows


@contextlib.contextmanager
def plain_backward_refused(modules, ref):
    """The plain backward twins and the autograd recompute raise on CUDA
    tensors for the block: a training path on the card runs the backward
    kernels or fails, and no route quietly gives way to a twin.  (The plain
    runs that hold the kernels against the twins, ``plain_kernels``,
    differentiate the plain forwards themselves and call none of these.)"""
    rn, ss = modules["rn"], modules["ss"]
    targets = ((rn, "rmsnorm_backward"), (ss, "ssd_scan_backward"),
               (ref, "ssd_chunked_backward"))
    saved = [getattr(mod, attr) for mod, attr in targets]

    def refuse(fn, what):
        def guarded(*args, **kwargs):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise RuntimeError(f"chip_smoke: the plain {what} ran on "
                                   f"CUDA tensors on a training path")
            return fn(*args, **kwargs)
        return guarded

    for (mod, attr), fn in zip(targets, saved):
        setattr(mod, attr, refuse(fn, attr))
    try:
        yield
    finally:
        for (mod, attr), fn in zip(targets, saved):
            setattr(mod, attr, fn)


# --------------------------------------------------------------------------
# phases 5, 6 and 8: plain twins on the card
# --------------------------------------------------------------------------
def partial_plain(fa):
    """``flash_attention_partial``'s plain twin on any device: (out fp32,
    lse (B,S,H)) from ``flash_attention_plain_lse``."""
    def plain(q, k, v, **kw):
        out, lse = fa.flash_attention_plain_lse(q, k, v, **kw)
        return out.float(), lse.float().transpose(1, 2)
    return plain


@contextlib.contextmanager
def plain_kernels(ops, fa, rn, ss):
    """Route the model's kernel calls to the plain twins for the block."""
    saved = ops._fa, ops._rn, ops._ssd
    ops._fa = types.SimpleNamespace(
        flash_attention=fa.flash_attention_plain,
        flash_attention_partial=partial_plain(fa))
    ops._rn = types.SimpleNamespace(
        rmsnorm=lambda x, scale, *, eps: rn.rmsnorm_plain(x, scale, eps),
        rmsnorm_residual=lambda x, r, scale, *, eps:
            rn.rmsnorm_residual_plain(x, r, scale, eps))
    ops._ssd = types.SimpleNamespace(ssd_scan=ss.ssd_scan_plain,
                                     ssd_scan_state=ss.ssd_scan_state_plain,
                                     takes_ragged=lambda *a: False)
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

    def coarse_partial(*a, **kw):
        out, lse = fa.flash_attention_partial(*a, **kw)
        return coarse(out), lse

    saved = ops._fa, ops._rn
    if kernel == "flash_attention":
        ops._fa = types.SimpleNamespace(
            flash_attention=lambda *a, **kw: coarse(fa.flash_attention(*a,
                                                                       **kw)),
            flash_attention_partial=coarse_partial)
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


def train_arch_config():
    """mamba2-780m at its published widths and TRAIN_LAYERS layers: the
    model of the training phases 7-8, 11, 15 and 17."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TRAIN_ARCH),
                               num_layers=TRAIN_LAYERS)


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


def serve_config(cfg):
    """``cfg`` at the serve phases' depth (``SERVE_LAYERS``; an encdec's
    encoder cut alike), or as it is."""
    import dataclasses
    n = SERVE_LAYERS.get(cfg.name)
    if n is None:
        return cfg
    return dataclasses.replace(
        cfg, num_layers=n, encoder_layers=n if cfg.encoder_layers else 0)


def serve_path(torch, np, F, modules, arch: str,
               requests=REQUESTS, counted=None) -> dict:
    """Phases 4-5 (qwen2-0.5b), 6 (mamba2-780m), 6b (granite-moe), 6d
    (hymba-1.5b), 6f (phi-3-vision-4.2b) and 6g (whisper-large-v3) at
    full width: serve ``requests`` through the frontend with exact launch
    counts, profile a prefill and eight decode steps, then hold
    teacher-forced logits against the plain twins' (and, for the SSM, the
    prefix families and whisper, against a full-sequence forward).  A vlm
    request carries seeded patch embeddings and a whisper request seeded
    frame embeddings: the frontend passes none (as ``repro``'s), so the
    engine here adds each prompt's to its ``generate`` call as
    ``extra_inputs``.  Given ``counted``, one prefill of a full batch is
    also timed and counted there for phase 24.  Returns the launches of
    the serving run."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import BatchingFrontend, ServeEngine
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    from repro_torch.models import layers as ll
    cfg = serve_config(get_config(arch))
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

    expect_prefill = (("flash_fwd_wgmma_kernel",) if flash_layers else ()) + (
        ("ssd_scan_state_wgmma_kernel", "ssd_scan_chunk_scan_wgmma_kernel")
        if cfg.ssm_state_dim else ())
    prefill_tokens = pt.shape[1] + model.prefix_len
    for window, fn, expect in (
            (f"{cfg.name} prefill 8x{prefill_tokens}", prefill,
             expect_prefill),
            (f"{cfg.name} 8 decode steps, batch 8", decode_steps,
             ("flash_fwd_decode_kernel",) if flash_step
             else ("rmsnorm",) if family != "dense" else ())):
        row = profile_phase(torch, window, fn, expect=expect)
        if family == "moe":
            row["moe_split"] = moe_split(torch, ll, fn)
        emit("profile", **row)
    if counted is not None:
        # phase 24's counted prefill of a full batch, and its time
        prefill_s = []
        for _ in range(DRYRUN_PREFILLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        del cache
        cache = model.init_cache(MAX_BATCH, max_len)
        card_count(torch, modules, counted, "serve", prefill,
                   dict(model.named_parameters()), kind="prefill", cfg=cfg,
                   rows=MAX_BATCH, seq=pt.shape[1], cache_len=max_len,
                   specs=specs_of(pbatch), step_s=prefill_s)
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

    ``plain_ssm``: random-weight mamba2 at 24-48 layers amplifies rounding, so
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


def train_path(torch, np, F, modules, counted: dict):
    """Phases 7-8 at full width, TRAIN_LAYERS deep; one step counted into
    ``counted`` for phase 24.  Returns the launches of the timed steps,
    the train state and the step function (phase 11 trains on), and the
    profiled step's idle share."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))

    cfg = train_arch_config()
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
        return ssm_train_counts(ss, rn)

    def zero():
        zero_ssm_train(fa, rn, ss)

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
    expect = ssm_train_expect(L, TRAIN_STEPS)
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
    from repro_torch.launch.dryrun import state_names
    card_count(torch, modules, counted, "train", lambda: step(state, batch),
               state_names(state), kind="train", cfg=cfg, scfg=tcfg,
               rows=TRAIN_BATCH, seq=TRAIN_SEQ, specs=specs_of(batch),
               step_s=step_s)

    prof = profile_phase(
        torch, "train step 4x2048", lambda: step(state, batch),
        expect=("ssd_scan_state_wgmma_kernel",
                "ssd_scan_chunk_scan_wgmma_kernel",
                "ssd_bwd_chunk_wgmma_kernel", "ssd_bwd_own_mma_kernel",
                "rmsnorm_bwd_kernel"),
        absent=("ssd_bwd_chunk_mma_kernel",))
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
    # the norms' and the scan's backward kernels still once each
    full_expect = dict(ssm_train_expect(L, 1), ssd_scan=2 * L,
                       rmsnorm=(2 * L + 1) + 2 * L)
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
        zero_ssm_train(fa, rn, ss)
        losses, step_s = [], []
        for i in range(TRAIN_STEPS):
            if i:
                batch = next(stream)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        launches = ssm_train_counts(ss, rn)
        flash = fa.flash_attention.launches
        expect = ssm_train_expect(L, TRAIN_STEPS)
        prof = profile_phase(torch, "streamed train step 4x2048",
                             lambda: step(state, next(stream)),
                             expect=("ssd_scan_chunk_scan_wgmma_kernel",
                                     "ssd_bwd_chunk_wgmma_kernel"),
                             absent=("ssd_bwd_chunk_mma_kernel",))
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
    """Phase 14: the Trainer at full width, TRAINER_LAYERS deep: startup
    DPT tune, the DPT cache, the OnlineTuner and checkpoint/restart in
    ``repro``'s on-disk layout.  Three runs: A straight (4 steps), B1 (2 steps, a
    blocking checkpoint at step 2), B2 (resumes B1's checkpoint; an async
    checkpoint at step 3 written during step 4's compute, a blocking one at
    step 4).  Returns the launches of the eight steps."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAINER_LAYERS)
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

    zero_ssm_train(fa, rn, ss)
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
    launches = ssm_train_counts(ss, rn)
    flash = fa.flash_attention.launches
    L = cfg.num_layers
    n_steps = 2 * TRAINER_STEPS           # A, then B1 and B2 between them
    expect = ssm_train_expect(L, n_steps)
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
    (TRAIN_LAYERS deep) ``Trainer`` on the card as host 0, attached with ``connect_fleet``, and
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
    cfg = train_arch_config()
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
    zero_ssm_train(fa, rn, ss)
    trainer_mod.make_train_step = make_timed
    t0 = time.perf_counter()
    try:
        tr.run()
    finally:
        trainer_mod.make_train_step = real_make
        for s in streams:
            s.close()
    run_s = time.perf_counter() - t0
    launches = ssm_train_counts(ss, rn)
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
         launches=launches,
         expected_launches=ssm_train_expect(L, len(losses)),
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
    check(launches == ssm_train_expect(L, len(losses)),
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
            edge_dataset(tdata, FLEET_FEATURE_LATENCY_S, 1e9, raw),
            FLEET_FEATURE_BATCH,
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
    trials = {"serve0": [], "host1": []}

    def recording(host, evaluator):
        # each consensus trial's (workers, prefetch, seconds), for the line
        def measure(nworker, nprefetch, **kw):
            stats = evaluator(nworker, nprefetch, **kw)
            trials[host].append([nworker, nprefetch, stats.seconds])
            return stats
        return measure
    agent.evaluator = recording("serve0", agent.evaluator)
    peer.evaluator = recording("host1", peer.evaluator)
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
         consensus_trials=trials,
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
          f"batch-mix consensus: {consensus}; trials {trials}")
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
    full-width mamba2-780m (TRAIN_LAYERS deep) from phase 7's seeded
    masters and batch,
    ``dp_manual`` with DP_MICROBATCHES microbatches, remat "none", bf16
    compute.  Checks, each fatal: (1) one dp step against the plain step
    over the whole batch from identical masters (loss, gradient norm,
    every leaf's update cosine) and (2) a control without the deferred
    scale's 1/n_mb, which must fail check 1; (3) launches exactly
    TRAIN_LAYERS ssd_scan and 2 TRAIN_LAYERS + 1 rmsnorm a microbatch, no
    flash; (4) ``compressed_psum``
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
    from repro_torch.distributed import dp_shard, grad_compress
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step,
                                              shard_train_state)
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))

    # an earlier phase's reference cycle can hold a 5.1 GB state
    gc.collect()
    torch.cuda.empty_cache()
    cfg = train_arch_config()
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
        return dict(ssm_train_counts(ss, rn),
                    flash_attention=fa.flash_attention.launches)

    def zero():
        zero_ssm_train(fa, rn, ss)

    def cosine(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0, eps=1e-30))

    per_step = dict(ssm_train_expect(L, DP_MICROBATCHES), flash_attention=0)
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
                expect=("ssd_scan_chunk_scan_wgmma_kernel",
                        "ssd_bwd_chunk_wgmma_kernel"),
                absent=("ssd_bwd_chunk_mma_kernel",))
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
            # loss, its three metrics and the norm's sum of squares, each
            # over a group of the world's ranks: at world 1 none is issued
            # (transport skips a group of one, as repro's psum over an
            # axis of size 1 is the identity)
            plan = dp.plan
            n_fsdp, n_leaves = len(plan.dims), len(dp.params)
            design = {"all_gather": DP_MICROBATCHES * n_fsdp,
                      "reduce_scatter": DP_MICROBATCHES * n_fsdp,
                      "all_reduce": (n_leaves - n_fsdp) + 5} \
                if torch.distributed.get_world_size() > 1 else {}
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
            "rmsnorm": rn.rmsnorm.launches,
            "rmsnorm_backward": rn.rmsnorm.backward_launches}


def zero_launches(fa, rn, ss) -> None:
    fa.flash_attention.launches = fa.flash_attention.backward_launches = 0
    rn.rmsnorm.launches = ss.ssd_scan.launches = 0
    rn.rmsnorm.backward_launches = ss.ssd_scan.backward_launches = 0
    rn.row_sumsq.launches = rn.rmsnorm_total.launches = 0


def ssm_launches(fa, rn, ss) -> dict:
    """``dense_launches`` with the SSD scan's (forward and backward) and
    the split-row rmsnorm pair's."""
    return dict(dense_launches(fa, rn), ssd_scan=ss.ssd_scan.launches,
                ssd_scan_backward=ss.ssd_scan.backward_launches,
                row_sumsq=rn.row_sumsq.launches,
                rmsnorm_total=rn.rmsnorm_total.launches)


def ssm_train_counts(ss, rn) -> dict:
    """The mamba2 phases' launches: the scan and the whole-row norm, each
    forward and backward."""
    return {"ssd_scan": ss.ssd_scan.launches,
            "rmsnorm": rn.rmsnorm.launches,
            "ssd_scan_backward": ss.ssd_scan.backward_launches,
            "rmsnorm_backward": rn.rmsnorm.backward_launches}


def ssm_train_expect(L: int, steps: int) -> dict:
    """``ssm_train_counts`` of ``steps`` mamba2 steps of L layers at remat
    "none": a scan and 2 norms a layer and the final norm, each with its
    backward kernel once."""
    return {"ssd_scan": L * steps, "rmsnorm": (2 * L + 1) * steps,
            "ssd_scan_backward": L * steps,
            "rmsnorm_backward": (2 * L + 1) * steps}


def zero_ssm_train(fa, rn, ss) -> None:
    ss.ssd_scan.launches = rn.rmsnorm.launches = 0
    ss.ssd_scan.backward_launches = rn.rmsnorm.backward_launches = 0
    fa.flash_attention.launches = 0


def dense_expect(L: int, policy: str, steps: int = 1,
                 qk_norm: bool = False) -> dict:
    """Launches of ``steps`` steps of a dense LM of L layers: one flash
    forward a layer and one backward, 2L + 1 norms (4L + 1 with qk-norm's
    two a layer) and a norm backward each; a remat policy other than
    "none" runs each layer's forward again in the backward (the norms'
    backward still once each)."""
    again = 0 if policy == "none" else 1
    per_layer = 4 if qk_norm else 2
    return {"flash_attention": (1 + again) * L * steps,
            "flash_attention_backward": L * steps,
            "rmsnorm": ((1 + again) * per_layer * L + 1) * steps,
            "rmsnorm_backward": (per_layer * L + 1) * steps}


def train_dense_path(torch, np, F, modules, counted: dict) -> dict:
    """Phase 18: full-width, full-depth qwen2-0.5b, one step's loss and
    gradients through the flash forward and backward kernels against the
    plain twins, remat "none" and "dots", a coarse-backward control, then
    timed steps (one more counted into ``counted`` for phase 24) and a
    profiled one.  Returns the launches of one step at each policy."""
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
    from repro_torch.launch.dryrun import state_names
    card_count(torch, modules, counted, "train_dense",
               lambda: step(state, batch),
               state_names(state), kind="train", cfg=cfg, scfg=tcfg,
               rows=TRAIN_BATCH, seq=TRAIN_SEQ, specs=specs_of(batch),
               step_s=step_s)
    prof = profile_phase(torch, "dense train step 4x2048",
                         lambda: step(state, batch),
                         expect=("flash_fwd_wgmma_kernel",
                                 "flash_bwd_dkdv_wgmma_kernel",
                                 "flash_bwd_dq_wgmma_kernel",
                                 "flash_bwd_preprocess_kernel",
                                 "rmsnorm_bwd_kernel"))
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
    """Phase 19: the Trainer on full-width qwen2-0.5b (DENSE_TRAINER_LAYERS
    deep) over LCG token data
    (examples/torch_train_lm.py's ``lcg_dataset``), remat "dots" (the
    Trainer's default): A trains DENSE_TRAINER_STEPS steps straight (DPT
    runs and fills the cache), B1 half of them and saves a blocking
    checkpoint, B2 resumes it; then the example's smoke preset on the
    card.  Returns the launches of the Trainer's steps."""
    import dataclasses
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
    cfg = dataclasses.replace(get_config(DENSE_ARCH),
                              num_layers=DENSE_TRAINER_LAYERS)
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


def spawn_card_ranks(phase: str, world: int, workdir: str) -> list:
    """Run ``phase``'s rank function in ``world`` processes of this script
    (``--rank``), all on the card, and wait for them: at most
    RANK_TIMEOUT_S in all; a rank that exits non-zero or the timeout kills
    every rank and fails the phase with each log's tail.  Prints the
    host's state as they start (``host_state``).  Returns each rank's
    result."""
    import pickle
    emit(f"{phase}_host", **host_state())
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"log_{phase}_r{rank}"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", phase,
             workdir, str(world), str(rank)], stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    why = None
    try:
        while why is None:
            rcs = [p.poll() for p, _ in procs]
            bad = [i for i, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                why = ", ".join(f"rank {i} rc {rcs[i]}" for i in bad)
            elif all(rc == 0 for rc in rcs):
                break
            elif time.monotonic() > deadline:
                why = f"timed out after {RANK_TIMEOUT_S} s"
            else:
                time.sleep(0.1)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if why is not None:
        tails = []
        for _, log in procs:
            with open(log.name) as f:
                tails.append(f"{log.name}:\n{f.read()[-3000:]}")
        check(False, f"{phase}: {why}\n" + "\n".join(tails))
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"res_{phase}_r{rank}.pkl"),
                  "rb") as f:
            out.append(pickle.load(f))
    return out


def rank_main(args) -> int:
    """``chip_smoke.py --rank PHASE WORKDIR WORLD RANK``: one rank of a
    model-axis phase, on the card, in a gloo group joined through a
    ``FileStore`` in WORKDIR; writes its result to
    ``WORKDIR/res_<PHASE>_r<RANK>.pkl``."""
    import pickle
    phase, workdir, world, rank = args[0], args[1], int(args[2]), \
        int(args[3])
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["REPRO_COMPUTE_DTYPE"] = "bfloat16"
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ref
    modules = dict(ops=ops, fa=fa, rn=rn, ss=ss)
    store = dist.FileStore(os.path.join(workdir, f"store_{phase}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        fn = {"tp_train": tp_train_rank, "tp_train_big": tp_train_big_rank,
              "ep_serve": ep_serve_rank, "tp_ssm": tp_ssm_rank,
              "tp_vlm_encdec": tp_vlm_encdec_rank}[phase]
        with plain_backward_refused(modules, ref):
            res = fn(torch, np, F, modules, workdir)
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"res_{phase}_r{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(path + ".tmp", path)
    return 0


def tp_arch_config():
    """qwen2-0.5b at its published widths and TP_LAYERS layers: phase
    20's model, trained and served."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TP_ARCH), num_layers=TP_LAYERS)


def big_arch_config():
    """qwen3-1.7b at its published widths and BIG_LAYERS layers: phase
    20b's model."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(BIG_ARCH), num_layers=BIG_LAYERS)


def tp_config():
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    return TrainStepConfig(remat_policy="none", optimizer=AdamWConfig(
        eps=DP_ADAM_EPS))


def tp_batch(torch, np, cfg, batch=TP_BATCH, seq=TP_SEQ):
    rng = np.random.default_rng(20)
    seq_ = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq + 1)),
                           dtype=torch.long, device="cuda")
    return {"tokens": seq_[:, :-1], "targets": seq_[:, 1:]}


def replicated_digests(state) -> dict:
    """A SHA-256 of the bytes of each parameter the storage plan does not
    split over ``"model"`` (every model rank holds it whole), to compare
    the ranks bit for bit."""
    import hashlib
    split = {k for k, dims in state.plan.dims.items()
             if any("model" in axes for axes in dims.values())}
    return {k: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
            for k, p in state.params.items() if k not in split}


@contextlib.contextmanager
def host_clock():
    """Where a rank's wall time goes on the host over the block: the
    seconds and calls of each gloo collective by kind (``all_reduce``,
    ``all_gather``, ``reduce_scatter``: the transfer and the wait for the
    slowest rank), of ``to_host`` (a staged tensor's copy into pinned host
    memory, which first waits for the card's queued work; its buffer
    included) and of ``pin`` (the pinned buffers alone), as
    ``{kind: [calls, seconds]}``, with ``wall_s`` and ``cpu_s`` (the
    process's CPU time, every thread) and the host's 1-minute load
    average after the block.  The collectives run unchanged."""
    import torch.distributed as dist

    from repro_torch.distributed import transport
    clock, real = {}, []

    def timed(owner, attr, kind):
        fn = getattr(owner, attr)
        real.append((owner, attr, fn))

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                c = clock.setdefault(kind, [0, 0.0])
                c[0] += 1
                c[1] += time.perf_counter() - t0

        setattr(owner, attr, wrapper)

    for attr, kind in (("all_reduce", "all_reduce"),
                       ("all_gather_into_tensor", "all_gather"),
                       ("reduce_scatter_tensor", "reduce_scatter")):
        timed(dist, attr, kind)
    timed(transport, "_to_host", "to_host")
    timed(transport, "_pinned", "pin")
    c0, w0 = time.process_time(), time.perf_counter()
    try:
        yield clock
    finally:
        for owner, attr, fn in real:
            setattr(owner, attr, fn)
        clock["wall_s"] = time.perf_counter() - w0
        clock["cpu_s"] = time.process_time() - c0
        clock["loadavg_1m"] = os.getloadavg()[0]


def host_state() -> dict:
    """The host as a phase starts: its 1-minute load average, the
    processes running on it, the cores this process may use, and this
    process's threads and live children (what earlier phases left
    behind)."""
    with open("/proc/stat") as f:
        running = next(int(line.split()[1]) for line in f
                       if line.startswith("procs_running"))
    with open("/proc/self/status") as f:
        threads = next(int(line.split()[1]) for line in f
                       if line.startswith("Threads:"))
    children = 0
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children") as f:
                children += len(f.read().split())
        except OSError:
            pass
    return dict(loadavg_1m=os.getloadavg()[0], procs_running=running,
                cores=len(os.sched_getaffinity(0)), threads=threads,
                children=children)


def staged_only(rank_result) -> bool:
    """Did every collective of a rank's run move its tensors through host
    memory (``transport.moved``), as the backend rule has gloo do with
    CUDA tensors, and did the run issue any?"""
    moved = rank_result["moved"]
    return moved.get("staged", 0) > 0 and moved.get("direct", 0) == 0


def checksum(torch, t) -> int:
    """A position-weighted sum of a tensor's 32-bit words, exact in
    wrapping int64: equal bits give equal sums, and a changed word changes
    the sum.  On the tensor's device, so a rank and the parent can compare
    shards of gigabytes without hashing them on the host."""
    w = t.detach().contiguous().view(-1).view(torch.int32).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) \
        % 65521 + 1
    return int((w * pos).sum())


def storage_report(torch, cfg, state) -> dict:
    """What a rank holds of a train state on the storage plan: its bytes
    (parameters and both moments, each fp32) against the sum of its
    shards' sizes from the plan's arithmetic, and the model-mapped leaves
    it holds at their whole shape (none)."""
    from repro_torch.train.train_step import param_shapes
    plan, shapes = state.plan, param_shapes(cfg)
    trees = [state.params, state.opt.mu, state.opt.nu] + (
        [state.err] if state.err is not None else [])
    held = sum(t.numel() * t.element_size() for tree in trees
               for t in tree.values())
    want = 4 * len(trees) * sum(math.prod(plan.local_shape(k, s))
                                for k, s in shapes.items())
    whole = [k for k, dims in plan.dims.items()
             if any("model" in axes for axes in dims.values())
             and tuple(state.params[k].shape) == tuple(shapes[k])]
    n_split = sum(any("model" in axes for axes in dims.values())
                  for dims in plan.dims.values())
    return dict(held_bytes=held, shard_bytes=want,
                whole_bytes=4 * len(trees) * sum(
                    math.prod(s) for s in shapes.values()),
                model_split_leaves=n_split, whole_shaped=whole[:8],
                ok=held == want and not whole)


def collective_cosines(torch, F, state, ref_mu, group):
    """Each first moment's cosine to the one-rank step's (``ref_mu``, whole
    leaves on the host, memory-mapped), without gathering a leaf: each
    rank sums a . b, a . a and b . b over its shard against the same slice
    of the reference, divided by how many ranks hold each element, and one
    all-reduce over ``group`` adds them up.  Returns the cosines and each
    leaf's (norm, the reference's norm)."""
    import torch.distributed as dist
    plan, keys = state.plan, list(state.opt.mu)
    sums = torch.empty((len(keys), 3), dtype=torch.float64)
    for i, k in enumerate(keys):
        a = state.opt.mu[k].double().flatten()
        b = plan.local(k, ref_mu[k]).to("cuda").double().flatten()
        sums[i] = torch.stack([a @ b, a @ a, b @ b]).cpu() \
            / plan.replication(k)
    dist.all_reduce(sums, group=group)
    cosines = {k: float(sums[i, 0] / torch.sqrt(sums[i, 1] * sums[i, 2])
                        .clamp_min(1e-300))
               for i, k in enumerate(keys)}
    norms = {k: (float(sums[i, 1].sqrt()), float(sums[i, 2].sqrt()))
             for i, k in enumerate(keys)}
    return cosines, norms


def tp_held(torch, F, st, m, ref_mu, floor, group) -> dict:
    """Loss, grad norm, every first moment's cosine to the one-rank step's
    and its norm beside the reference's, and the digests of the leaves
    every rank holds whole."""
    cosines, norms = collective_cosines(torch, F, st, ref_mu, group)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                digests=replicated_digests(st), cosines=cosines,
                norms=norms, floor=floor)


def tp_step_rank(torch, np, F, modules, workdir, cfg, batch, controls,
                 save_dir=None, ref_name="ref.pt", ssm=False) -> dict:
    """One rank of a model-axis training phase for ``cfg``: the state
    built on the storage plan of (data 1, model n) leaf by leaf from seed
    0, what it holds, one dp_manual step (the residual stream's tokens
    split over the model ranks where TRAIN_RULES' ``seq_res`` says so),
    the shape of the residual each layer received, the collectives by kind
    and the gathers over ``"model"`` it issued, its peak memory, its
    launches (with ``ssm`` the SSD scan's and the split norm pair's too),
    each first moment held against the one-rank step's (``ref_name``),
    then (``save_dir``) each shard's checksum and a checkpoint of the
    state, then the same step from the same masters under each of
    ``controls`` ({key: a context that leaves out one sum over the model
    ranks})."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.distributed import dp_shard, model_axis, transport
    from repro_torch.distributed.sharding_rules import (model_group,
                                                        rules_for, use_rules)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as ll
    from repro_torch.models import stack as stk
    from repro_torch.models.lm import param_specs
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.train_step import (TrainState, init_train_state,
                                              make_train_step)
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    rank, n = dist.get_rank(), dist.get_world_size()
    tcfg = dataclasses.replace(tp_config(), dp_manual=True)
    mesh = make_local_mesh(model_axis=n, device="cuda")
    group = model_group(mesh)
    ref = torch.load(os.path.join(workdir, ref_name), mmap=True)
    out = {"backend": str(dist.get_backend(group)),
           "heads": ll.rank_heads(cfg, n, rank)._asdict()
           if cfg.uses_attention else None,
           "rules": ll.leaf_rules(cfg, n)}
    if cfg.ssm_state_dim:
        out["ssm_heads"] = ll.ssm_heads(cfg, n, rank)
    with use_rules(mesh, rules_for("train")) as ctx:
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), tcfg,
            device="cuda", ctx=ctx)
        out["init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["storage"] = storage_report(torch, cfg, state)
        out["plan"] = {k: dict(d) for k, d in state.plan.dims.items()}
        step = make_train_step(state.model, tcfg)
        out["path"] = step.path
        start = {k: p.detach().clone() for k, p in state.params.items()}
        zero_launches(fa, rn, ss)
        for counter in (model_axis.collectives, dp_shard.collectives,
                        dp_shard.model_gathers, transport.moved):
            counter.clear()
        residual, real_block = set(), stk.block

        def block(p, cfg_, x, **kw):
            residual.add(tuple(x.shape))
            return real_block(p, cfg_, x, **kw)

        stk.block = block
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with host_clock() as clock:
                new, m = step(state, batch)
                torch.cuda.synchronize()
        finally:
            stk.block = real_block
        out["step_s"] = time.perf_counter() - t0
        out["step_clock"] = clock
        out["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["residual"] = sorted(residual)
        out["launches"] = ssm_launches(fa, rn, ss) if ssm \
            else dense_launches(fa, rn)
        out["collectives"] = dict(model_axis.collectives)
        out["dp_collectives"] = dict(dp_shard.collectives)
        out["model_gathers"] = dict(dp_shard.model_gathers)
        out["moved"] = dict(transport.moved)
        with ctx.manual_region(dp_shard.manual_axes(mesh)):
            seq = stk.sp_split(cfg, batch["tokens"].shape[1])
            enc_seq = stk.sp_split(cfg, batch["frames"].shape[1]) \
                if "frames" in batch else None
            out["sp"] = None if seq is None else seq.size
            out["enc_sp"] = None if enc_seq is None else enc_seq.size
            out["partial_leaves"] = len(ll.model_partial_leaves(
                cfg, param_specs(cfg), state.params, seq, enc_seq))
            out["embed_split"] = "embed.tokens" in {
                k for k, dims in state.plan.dims.items()
                if any("model" in axes for axes in dims.values())}
        out["step"] = tp_held(torch, F, new, m, ref["mu"], ref["floor"],
                              group)
        if save_dir is not None:
            from repro_torch.checkpoint import Checkpointer
            out["sums"] = {name: {k: checksum(torch, t)
                                  for k, t in tree.items()}
                           for name, tree in (("params", new.params),
                                              ("mu", new.opt.mu),
                                              ("nu", new.opt.nu))}
            t0 = time.perf_counter()
            Checkpointer(save_dir).save(1, new, aux={"ranks": n},
                                        block=True)
            out["save_s"] = time.perf_counter() - t0
        del new
        for key, ctl in controls.items():
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(start[k])
            state = TrainState(state.model, init_adamw(state.params), None,
                               state.plan)
            with ctl(), host_clock() as clock:
                state, m = step(state, batch)
                torch.cuda.synchronize()
            out[key] = tp_held(torch, F, state, m, ref["mu"], ref["floor"],
                               group)
            out[key + "_clock"] = clock
        del start
    del state, ref
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def unsummed(module, name: str, first_only: bool = False, when=None):
    """``module.name`` run without the sum over the model ranks it ends
    in: ``from_model`` the identity, and ``scatter_seq`` (under sequence
    parallelism) slicing this rank's block of its own partial output; at
    its first call only if ``first_only``, at the calls whose keywords
    pass ``when`` if given."""
    from repro_torch.distributed import model_axis
    real, real_from, real_scatter = (getattr(module, name),
                                     model_axis.from_model,
                                     model_axis.scatter_seq)
    calls = [0]

    def fn(*args, **kwargs):
        calls[0] += 1
        if first_only and calls[0] > 1 \
                or when is not None and not when(kwargs):
            return real(*args, **kwargs)
        model_axis.from_model = lambda y, s: y
        model_axis.scatter_seq = lambda y, s, summed=True: real_scatter(
            y, s, summed=False)
        try:
            return real(*args, **kwargs)
        finally:
            model_axis.from_model = real_from
            model_axis.scatter_seq = real_scatter

    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def first_combine_skipped():
    """Layer 0's attention combine left out: the first call of
    ``_attention_split`` without its sum over the model ranks (under
    sequence parallelism, its reduce-scatter a slice)."""
    from repro_torch.models import layers as ll
    return unsummed(ll, "_attention_split", first_only=True)


def lookup_unsummed():
    """The vocabulary-parallel lookup without its sum: each rank's
    embeddings hold its own rows' tokens and zeros for the rest (under
    sequence parallelism, its block of them)."""
    from repro_torch.models import layers as ll
    return unsummed(ll, "embed")


@contextlib.contextmanager
def scatter_unsummed():
    """Every ``scatter_seq`` slicing this rank's block of its own partial
    output: no reduce-scatter sums the model ranks' parts."""
    from repro_torch.distributed import model_axis
    real = model_axis.scatter_seq
    model_axis.scatter_seq = lambda y, s, summed=True: real(y, s,
                                                            summed=False)
    try:
        yield
    finally:
        model_axis.scatter_seq = real


def tp_train_rank(torch, np, F, modules, workdir) -> dict:
    """One rank of phase 20: ``tp_step_rank`` for qwen2-0.5b at TP_LAYERS
    layers (``tp_arch_config``), its
    state saved, with layer 0's attention combine left out as the
    control; then the kv_seq serve check (``kv_serve_rank``) and
    ``ring_weight_matmul``."""
    import torch.distributed as dist

    from repro_torch.distributed import model_axis
    from repro_torch.distributed.collective_matmul import ring_weight_matmul
    from repro_torch.launch.mesh import make_local_mesh
    rank, n = dist.get_rank(), dist.get_world_size()
    out = tp_step_rank(torch, np, F, modules, workdir, tp_arch_config(),
                       tp_batch(torch, np, tp_arch_config()),
                       {"control": first_combine_skipped,
                        "control_scatter": scatter_unsummed},
                       save_dir=os.path.join(workdir, "ck"))
    t0 = time.perf_counter()
    out["kv"] = kv_serve_rank(torch, np, F, dict(modules, workdir=workdir))
    out["kv"]["phase_s"] = time.perf_counter() - t0
    mesh = make_local_mesh(model_axis=n, device="cuda")
    # ring_weight_matmul over the model ranks against x @ w, fp32
    M, Kd, Fd = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((M, Kd), generator=gen, device="cuda")
    w = torch.randn((Kd, Fd), generator=gen, device="cuda")
    m_loc, f_loc = M // n, Fd // n
    xl = x[rank * m_loc:(rank + 1) * m_loc]
    wl = w[:, rank * f_loc:(rank + 1) * f_loc].contiguous()
    model_axis.collectives.clear()
    got = ring_weight_matmul(xl, wl, mesh)
    sends = model_axis.collectives["send_recv"]
    want = xl @ w
    err = float((got - want).abs().max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        ring_weight_matmul(xl, wl, mesh)
    torch.cuda.synchronize()
    out["ring"] = dict(shape=list(RING_SHAPE), max_abs_err=err,
                       ref_max=float(want.abs().max()), send_recv=sends,
                       ms=(time.perf_counter() - t0) / 3 * 1e3)
    return out


def tp_train_big_rank(torch, np, F, modules, workdir) -> dict:
    """One rank of phase 20b: ``tp_step_rank`` for qwen3-1.7b at
    BIG_LAYERS layers (``big_arch_config``), with
    the vocabulary-parallel lookup's all-reduce left out as the
    control."""
    return tp_step_rank(torch, np, F, modules, workdir, big_arch_config(),
                        tp_batch(torch, np, big_arch_config(), BIG_BATCH,
                                 BIG_SEQ), {"control": lookup_unsummed,
                                            "control_scatter":
                                                scatter_unsummed})


def one_rank_reference(torch, np, F, modules, cfg, batch, workdir,
                       name="ref.pt", ssm=False):
    """The one-rank step of a model-axis phase for ``cfg``, in the parent,
    on the seed-0 masters and ``batch``: loss, grad norm, launches (with
    ``ssm`` the SSD scan's and the split norm pair's too) and seconds, and
    to ``WORKDIR/<name>`` every leaf's first moment and the bf16 noise
    floor of its leaf (1 - cosine between the one-rank gradient through
    the kernels and through the plain twins).  Frees the state."""
    from repro_torch.train.train_step import init_train_state, make_train_step
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = tp_config()
    state = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), tcfg,
        device="cuda")
    step = make_train_step(state.model, tcfg)
    params = state.params
    with plain_kernels(ops, fa, rn, ss):
        state.model.loss(batch, remat_policy="none")[0].backward()
    plain = {k: p.grad.cpu() for k, p in params.items()}
    for p in params.values():
        p.grad = None
    zero_launches(fa, rn, ss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    launches = ssm_launches(fa, rn, ss) if ssm else dense_launches(fa, rn)
    floor = {k: 1.0 - float(F.cosine_similarity(
        v.flatten(), plain[k].to("cuda").flatten(), dim=0, eps=1e-30))
        for k, v in state.opt.mu.items()}
    del plain
    ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               launches=launches, step_s=one_s, floor=floor,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               state_gb=16 * sum(p.numel() for p in params.values()) / 1e9)
    torch.save(dict(mu={k: v.cpu() for k, v in state.opt.mu.items()},
                    floor=floor), os.path.join(workdir, name))
    del state, step, m, params
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def tp_verdict(res, ref, key, exact_zero=None) -> dict:
    """The checks the ranks' ``key`` step passes: loss, grad norm, every
    leaf's first-moment cosine (or within TP_FLOOR_RATIO x the floor of
    its kind of leaf), every leaf held whole bit-equal across the ranks.
    A leaf whose gradient is 0 in exact arithmetic (``exact_zero(name)``:
    whisper's key biases, which softmax ignores and no rotary modulates)
    is rounding noise on both sides: its cosine is not read, its first
    moment's norm is held below KEY_BIAS_OF_BV of its layer's value
    bias's in the one-rank step."""
    row = res[0][key]
    zero = [k for k in row["cosines"] if exact_zero and exact_zero(k)]
    zero_ratio = {k: row["norms"][k][0] / row["norms"][k[:-2] + "bv"][1]
                  for k in zero}
    one_ratio = {k: row["norms"][k][1] / row["norms"][k[:-2] + "bv"][1]
                 for k in zero}
    loss_rel = abs(row["loss"] - ref["loss"]) / abs(ref["loss"])
    norm_rel = abs(row["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    kind = {k: re.sub(r"^(layers|encoder)\.\d+\.", r"\1.", k)
            for k in row["floor"]}
    floor = {}
    for k, f in row["floor"].items():
        floor[kind[k]] = max(floor.get(kind[k], 0.0), f)
    limit = {k: max(1.0 - TP_MIN_COSINE, TP_FLOOR_RATIO * floor[kind[k]])
             for k in row["floor"]}
    low = {k: c for k, c in row["cosines"].items()
           if 1.0 - c > limit[k] and k not in zero_ratio}
    raised = {k: dict(cosine=row["cosines"][k], floor=floor[kind[k]])
              for k in limit if limit[k] > 1.0 - TP_MIN_COSINE
              and k not in zero_ratio
              and row["cosines"][k] < TP_MIN_COSINE}
    differ = sorted({k for r in res[1:] for k, dg in r[key]["digests"].items()
                     if dg != row["digests"][k]})
    return dict(loss_rel=loss_rel, norm_rel=norm_rel,
                min_cosine=min(c for k, c in row["cosines"].items()
                               if k not in zero_ratio),
                low_cosine=dict(sorted(low.items())[:8]),
                n_low_cosine=len(low),
                limit_raised_by_floor=dict(sorted(raised.items())[:8]),
                n_limit_raised=len(raised), ranks_differ=differ[:8],
                n_ranks_differ=len(differ),
                n_compared_whole=len(row["digests"]),
                exact_zero=dict(n=len(zero), max_of_bv=max(
                    zero_ratio.values(), default=None),
                    one_rank_max_of_bv=max(one_ratio.values(),
                                           default=None))
                if zero else None,
                ok=loss_rel <= TP_LOSS_REL and norm_rel <= TP_NORM_REL
                and not low and not differ
                and all(v <= KEY_BIAS_OF_BV for v in zero_ratio.values()))


def restore_across_sizes(torch, res, workdir, cfg) -> dict:
    """The ranks' checkpoint restored here at world 1: every leaf of the
    parameters and both moments cut as each rank's shard (the plan the
    ranks report) has that rank's checksum, and a world-1 save of the
    restored state writes the ranks' manifest."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train.train_step import init_train_state
    n = len(res)
    plan = res[0]["plan"]
    t0 = time.perf_counter()
    template = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(1), tp_config(),
        device="cuda")
    state, aux = Checkpointer(os.path.join(workdir, "ck")).restore(template)
    restore_s = time.perf_counter() - t0
    trees = {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}
    differ, compared = [], 0
    for name, tree in trees.items():
        for k, t in tree.items():
            for r in range(n):
                sl = t
                for d, axes in plan.get(k, {}).items():
                    if "model" in axes:
                        size = t.shape[d] // n
                        sl = sl.narrow(d, r * size, size)
                compared += 1
                if checksum(torch, sl) != res[r]["sums"][name][k]:
                    differ.append(f"{name}/{k}@{r}")
    t0 = time.perf_counter()
    Checkpointer(os.path.join(workdir, "ck1")).save(1, state, block=True)
    save1_s = time.perf_counter() - t0
    same_manifest = all(
        open(os.path.join(workdir, d, "step_00000001", "manifest.json"))
        .read() == open(os.path.join(workdir, "ck", "step_00000001",
                                     "manifest.json")).read()
        for d in ("ck1",))
    del state, template, trees
    gc.collect()
    torch.cuda.empty_cache()
    return dict(shards_compared=compared, shards_differ=differ[:8],
                n_shards_differ=len(differ), manifest_equal=same_manifest,
                aux=aux, restore_s=restore_s, world1_save_s=save1_s,
                ok=not differ and same_manifest and aux["ranks"] == n)


def sp_plan(cfg, r) -> dict:
    """The collectives by kind one rank's sequence-parallel step of
    ``cfg`` at remat "none" and one microbatch implies: over "model", per
    layer two regions (attention, the MLP), each an all-gather of the
    sequence in and a reduce-scatter out forward and their transposes
    backward; the lookup's reduce-scatter into the block (a table stored
    split) and its transpose; the cross-entropy's gather and transpose,
    and its two sums and one max; no other activation all-reduce.  In
    ``dp_shard``: one gather a layer of each unaligned leaf and its
    reduce-scatter, and an all-reduce of each partial leaf and of the grad
    norm (the data axis of 1 issues none)."""
    L = cfg.num_layers
    gathers = sum(r["model_gathers"].values())
    model = {"all_gather": 4 * L + 2,
             "reduce_scatter": 4 * L + 1 + int(r["embed_split"]),
             "all_reduce": 2, "all_reduce_max": 1}
    dp = {"all_gather": gathers, "reduce_scatter": gathers,
          "all_reduce": r["partial_leaves"] + 1}
    return dict(model_axis=model, dp_shard={k: v for k, v in dp.items()
                                            if v})


def tp_backend(phase, res, phase_s, keys=None) -> None:
    """The line saying how a model-axis phase's ranks talked: the backend
    of their model group and what every collective moved (by model,
    ``keys``, where one spawn trains several)."""
    r0 = res[0][keys[0]] if keys else res[0]
    moved = {k: [r[k]["moved"] for r in res] for k in keys} if keys \
        else [r["moved"] for r in res]
    emit(f"{phase}_backend", backend=r0["backend"], moved_per_rank=moved,
         ranks=len(res), phase_s=phase_s,
         note="collectives stage each tensor through host memory (gloo); "
              "the ranks share one card")


def tp_family(key, cfg, sub, ref, *, controls, expect, plan, residual, sp,
              gathers, exact_zero=None, one_expect=None, **extra) -> dict:
    """One model-axis step of ``cfg``, the ranks' results ``sub`` against
    the one-rank step ``ref``: emits ``key``'s collectives, storage and
    step lines (``extra``: the phase's own fields) and holds them.  The
    ranks ran gloo, every collective staged through the host, on the
    dp_manual path; the step passes ``tp_verdict`` (``exact_zero``: the
    leaves whose gradient is 0 in exact arithmetic) and every control of
    ``controls`` ({name: what it leaves out}) fails it; the sequence
    splits (decoder, encoder) are ``sp``; each rank's layers received
    ``residual``; its collectives by kind are ``plan(cfg, its result)``,
    its bytes held its shards', its launches ``expect`` (and the one-rank
    step's ``one_expect`` where given), its gathers over "model"
    ``gathers``.  Returns the launches summed over the ranks."""
    r0 = sub[0]
    held = {k: tp_verdict(sub, ref, k, exact_zero)
            for k in ("step", *controls)}
    emit(f"{key}_collectives", model_axis=r0["collectives"],
         dp_shard=r0["dp_collectives"], plan=plan(cfg, r0),
         model_gathers_per_rank=[r["model_gathers"] for r in sub],
         partial_leaves_summed=r0["partial_leaves"],
         sequence_split=r0["sp"], encoder_sequence_split=r0["enc_sp"],
         residual_per_rank=[r["residual"] for r in sub])
    emit(f"{key}_storage", rules=r0["rules"],
         per_rank=[r["storage"] for r in sub],
         init_peak_gb_per_rank=[r["init_peak_gb"] for r in sub])
    emit(key, arch=cfg.name, layers=cfg.num_layers,
         mesh={"data": 1, "model": len(sub)}, heads=r0["heads"],
         path=r0["path"], one_rank_loss=ref["loss"],
         one_rank_grad_norm=ref["grad_norm"], loss=r0["step"]["loss"],
         grad_norm=r0["step"]["grad_norm"], held=held["step"],
         **{c: dict(what=what, **held[c], loss=r0[c]["loss"])
            for c, what in controls.items()},
         launches_per_rank=[r["launches"] for r in sub],
         expected_launches_per_rank=expect,
         one_rank_launches=ref["launches"],
         peak_gb_per_rank=[r["peak_gb"] for r in sub],
         step_peak_gb_per_rank=[r["step_peak_gb"] for r in sub],
         one_rank_peak_gb=ref["peak_gb"], whole_state_gb=ref["state_gb"],
         step_s_per_rank=[r["step_s"] for r in sub],
         step_clock_per_rank=[r["step_clock"] for r in sub],
         **{f"{c}_clock_per_rank": [r[f"{c}_clock"] for r in sub]
            for c in controls},
         one_rank_step_s=ref["step_s"],
         timing_note="not a speed: the ranks share one card and every "
                     "collective crosses the host",
         max_loss_rel=TP_LOSS_REL, max_norm_rel=TP_NORM_REL,
         min_cosine=TP_MIN_COSINE, floor_ratio=TP_FLOOR_RATIO,
         floor_max=max(ref["floor"].values()), **extra)
    check(r0["backend"] == "gloo" and all(staged_only(r) for r in sub),
          f"{key} ran on {r0['backend']}, collectives moved "
          f"{[r['moved'] for r in sub]}")
    check(r0["path"] == "dp_manual", f"{key} took the {r0['path']} step")
    check(held["step"]["ok"], f"{key} against the one-rank step: "
          f"{held['step']}")
    for c in controls:
        check(not held[c]["ok"], f"{key}'s {c} passed: {held[c]}")
    check((r0["sp"], r0["enc_sp"]) == sp, f"{key}: sequence splits "
          f"{(r0['sp'], r0['enc_sp'])}, the rules imply {sp}")
    if one_expect is not None:
        check(ref["launches"] == one_expect, f"{key} one-rank launches "
              f"{ref['launches']}, expected {one_expect}")
    for r in sub:
        check(r["residual"] == residual, f"{key}: a layer received "
              f"{r['residual']}, not {residual}")
        got = dict(model_axis=r["collectives"], dp_shard=r["dp_collectives"])
        want = plan(cfg, r)
        check(got == want, f"{key} collectives {got}, the plan implies "
              f"{want}")
        check(r["storage"]["ok"], f"{key} storage: {r['storage']}")
        check(r["launches"] == expect, f"{key} rank launches "
              f"{r['launches']}, expected {expect}")
        check(r["model_gathers"] == gathers, f"{key} gathers over model "
              f"{r['model_gathers']}, the rules imply {gathers}")
    return {k: sum(r["launches"][k] for r in sub) for k in expect}


def tp_families(torch, np, F, modules, phase, cfgs, n, batch_of,
                kv_reference, ssm=False):
    """A model-axis phase that trains and serves several models in one
    spawn: for each of ``cfgs`` the one-rank step (on ``batch_of(cfg)``)
    and the one-rank serve reference (``kv_reference``) first, here, on
    the same seeded masters, freed before the ranks start; then ``n``
    ranks of ``phase``.  Emits the backend line; returns the ranks'
    results, the step references and the serve references."""
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix=f"{phase}_")
    refs, kv_refs = {}, {}
    try:
        for key, cfg in cfgs.items():
            refs[key] = one_rank_reference(
                torch, np, F, modules, cfg, batch_of(cfg), workdir,
                name=f"ref_{key}.pt", ssm=ssm)
            t0 = time.perf_counter()
            kv_refs[key] = kv_reference(torch, np, F, modules, workdir, key,
                                        cfg)
            kv_refs[key]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = spawn_card_ranks(phase, n, workdir)
        phase_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    tp_backend(phase, res, phase_s, list(cfgs))
    return res, refs, kv_refs


def serve_verdict(key, kv, ref, *, runs, expect, control_what,
                  limit=KV_MIN_COSINE, checks=(), **fields) -> None:
    """The serve check a model-axis phase holds its ranks' serving to
    (``kv``: each rank's runs, a row a prompt set) against the one-rank
    reference ``ref``: rank 0's fp32 logits at cosine ``limit`` or more
    at every position and their greedy tokens equal; the bf16 logits'
    distance (1 - mean cosine) to the fp32 reference within BF16_RATIO
    times the one-rank bf16 run's plus BF16_SLACK; the control below
    ``limit``; every rank's logits equal in each of ``runs``; each rank's
    bf16 launches ``expect``; and ``checks``, the phase's own (condition,
    message) pairs.  Emits ``key``_kv_serve with ``fields``."""
    import torch
    import torch.nn.functional as F

    def cosines(run, want):
        return torch.cat([F.cosine_similarity(
            r["logits"].float(), w.float(), dim=-1).flatten()
            for r, w in zip(kv[0][run]["rows"], want)])

    c32 = cosines("fp32", ref["logits32"])
    tokens_equal = all(torch.equal(r["logits"].argmax(-1), t.cpu())
                       for r, t in zip(kv[0]["fp32"]["rows"], ref["tokens"]))
    d16 = 1.0 - float(cosines("bf16", ref["logits32"]).mean())
    d16_one = 1.0 - float(torch.cat([
        F.cosine_similarity(a.float(), w.float(), dim=-1).flatten()
        for a, w in zip(ref["logits16"], ref["logits32"])]).mean())
    bound16 = BF16_RATIO * d16_one + BF16_SLACK
    ctl = float(cosines("control", ref["logits32"]).min())
    same = all(a["digest"] == b["digest"] for k in runs for r in kv[1:]
               for a, b in zip(r[k]["rows"], kv[0][k]["rows"]))
    emit(f"{key}_kv_serve", rules="SERVE_RULES",
         mesh={"data": 1, "model": len(kv)}, steps=KV_STEPS, **fields,
         fp32=dict(min_cosine=float(c32.min()), mean_cosine=float(c32.mean()),
                   greedy_tokens_equal=tokens_equal),
         bf16=dict(distance=d16, one_rank_distance=d16_one, bound=bound16),
         control=dict(what=control_what, min_cosine=ctl), ranks_equal=same,
         launches_per_rank=[r["bf16"]["launches"] for r in kv],
         expected_launches_per_rank=expect,
         seconds_per_rank={k: [r[k]["seconds"] for r in kv] for k in runs},
         build_s_per_rank={k: [r[k]["build_s"] for r in kv] for k in runs},
         clock_per_rank={k: [r[k]["clock"] for r in kv] for k in runs},
         reference_s=ref["seconds"],
         timing_note="not a speed: the ranks share one card and every "
                     "collective crosses the host",
         min_cosine_limit=limit)
    check(float(c32.min()) >= limit and tokens_equal,
          f"{key}_kv_serve fp32: min cosine {float(c32.min())}, greedy "
          f"tokens equal {tokens_equal}")
    check(d16 <= bound16, f"{key}_kv_serve bf16 distance {d16} > {bound16}")
    check(ctl < limit, f"{key}_kv_serve's control ({control_what}) passed: "
          f"min cosine {ctl}")
    check(same, f"{key}_kv_serve: the model ranks' logits differ")
    for cond, msg in checks:
        check(cond, f"{key}_kv_serve: {msg}")
    for r in kv:
        check(r["bf16"]["launches"] == expect, f"{key}_kv_serve launches "
              f"{r['bf16']['launches']}, expected {expect}")


def tp_train_path(torch, np, F, modules) -> dict:
    """Phase 20: the model axis trains qwen2-0.5b (``tp_arch_config``) over
    TP_MODEL gloo
    ranks on the card (see TP_ARCH), each rank holding its shards of the
    storage plan.  The one-rank step first, here, on the same seeded
    masters and batch; its first moments go to the ranks through a file,
    and it is freed before they start.  The ranks' checkpoint is then
    restored here at world 1.  Returns the launches of the ranks' step,
    summed over the ranks."""
    import shutil
    import tempfile

    from repro_torch.models import layers as ll
    cfg = tp_arch_config()
    L = cfg.num_layers
    workdir = tempfile.mkdtemp(prefix="tp_train_")
    try:
        ref = one_rank_reference(torch, np, F, modules, cfg,
                                 tp_batch(torch, np, cfg), workdir)
        t0 = time.perf_counter()
        kv_ref = kv_reference(torch, np, F, modules, workdir)
        kv_ref["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = spawn_card_ranks("tp_train", TP_MODEL, workdir)
        phase_s = time.perf_counter() - t0
        restored = restore_across_sizes(torch, res, workdir, cfg)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    tp_backend("tp_train", res, phase_s)
    ring = res[0]["ring"]
    emit("ring_matmul", ranks=TP_MODEL, per_rank_ms=[r["ring"]["ms"]
                                                     for r in res],
         **ring, timing_note="gloo ring steps through the host")
    expect = dense_expect(L, "none")
    launches = tp_family(
        "tp_train", cfg, res, ref,
        controls={"control": "layer 0's attention combine all-reduce left "
                             "out", "control_scatter": SCATTER_CONTROL},
        expect=expect, plan=sp_plan,
        residual=[(TP_BATCH, TP_SEQ // TP_MODEL, cfg.d_model)],
        sp=(TP_MODEL, None),
        gathers={k: L for k, r in ll.leaf_rules(cfg, TP_MODEL).items()
                 if r == "unaligned"},
        vocab_rows=-(-cfg.vocab_size // TP_MODEL), batch=[TP_BATCH, TP_SEQ],
        restore=restored, save_s_per_rank=[r["save_s"] for r in res],
        whole_layout_peak_gb_per_rank=TP_WHOLE_PEAK_GB)
    kv_verdict(res, kv_ref, cfg)
    check(restored["ok"], f"tp_train's checkpoint restored at world 1: "
          f"{restored}")
    check(all(r["ring"]["max_abs_err"] <= 1e-4 * r["ring"]["ref_max"]
              and r["ring"]["send_recv"] == TP_MODEL - 1 for r in res),
          f"ring_weight_matmul: {[r['ring'] for r in res]}")
    launches["kv_serve"] = {k: sum(r["kv"]["bf16"]["launches"][k]
                                   for r in res) for k in expect}
    return launches


def kv_verdict(res, ref, cfg) -> None:
    """Phase 20's kv_seq check against the one-rank reference
    (``kv_reference``), ``serve_verdict`` with: each rank holding a block
    of KV_MAX_LEN / n slots, its fp32 blocks within KV_CACHE_OF_MAX of the
    largest entry of the one-rank cache's slots and its bytes 1 / n of the
    whole; the launches of one prefill and KV_STEPS - 1 decode steps a
    prompt set."""
    n, L = len(res), cfg.num_layers
    kv = [r["kv"] for r in res]
    cache_err = max(row["cache_err"] / row["cache_max"]
                    for r in kv for row in r["fp32"]["rows"])
    whole = [2 * L * rows * KV_MAX_LEN * cfg.num_kv_heads * cfg.head_dim * 4
             for rows, _ in KV_PROMPTS]
    blocks_ok = all(row["kv_shards"] == n and row["block"] == KV_MAX_LEN // n
                    and row["cache_bytes"] * n == w
                    for r in kv for row, w in zip(r["fp32"]["rows"], whole))
    serve_verdict(
        "tp", kv, ref, runs=("fp32", "control", "bf16"),
        expect={"flash_attention": L * len(KV_PROMPTS),
                "flash_attention_backward": 0, "rmsnorm_backward": 0,
                "rmsnorm": (2 * L + 1) * KV_STEPS * len(KV_PROMPTS)},
        control_what="partial softmaxes averaged without their lse weights",
        checks=[(cache_err <= KV_CACHE_OF_MAX, f"a rank's fp32 K/V block "
                 f"{cache_err} of the largest entry from the one-rank "
                 f"cache"),
                (blocks_ok, f"a rank's cache is not its block of "
                 f"{KV_MAX_LEN // n} slots, 1 / {n} of the whole's bytes")],
        arch=cfg.name, prompts=[list(p) for p in KV_PROMPTS],
        slots=KV_MAX_LEN, block=KV_MAX_LEN // n, cache_err_of_max=cache_err,
        cache_bytes_per_rank=[r["fp32"]["rows"][0]["cache_bytes"]
                              for r in kv],
        whole_cache_bytes=whole[0],
        check_s_per_rank=[r["phase_s"] for r in kv],
        cache_limit=KV_CACHE_OF_MAX)


def tp_train_big_path(torch, np, F, modules) -> dict:
    """Phase 20b: qwen3-1.7b (``big_arch_config``) trained over BIG_MODEL
    gloo ranks on the card (see BIG_ARCH), every leaf aligned with its rank's work: the
    one-rank step first, here, then the ranks' step on the storage plan;
    each rank's peak below the whole layout's state alone.  Returns the
    launches of the ranks' step, summed over the ranks."""
    import shutil
    import tempfile

    from repro_torch.models import layers as ll
    cfg = big_arch_config()
    L = cfg.num_layers
    workdir = tempfile.mkdtemp(prefix="tp_train_big_")
    try:
        ref = one_rank_reference(
            torch, np, F, modules, cfg,
            tp_batch(torch, np, cfg, BIG_BATCH, BIG_SEQ), workdir)
        t0 = time.perf_counter()
        res = spawn_card_ranks("tp_train_big", BIG_MODEL, workdir)
        phase_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    tp_backend("tp_train_big", res, phase_s)
    rules = ll.leaf_rules(cfg, BIG_MODEL)
    check(set(rules.values()) == {"aligned"},
          f"tp_train_big: qwen3 at model {BIG_MODEL} is not aligned "
          f"everywhere: {rules}")
    expect = dense_expect(L, "none", qk_norm=True)
    launches = tp_family(
        "tp_train_big", cfg, res, ref,
        controls={"control": "the vocabulary-parallel lookup without its "
                             "all-reduce", "control_scatter": SCATTER_CONTROL},
        expect=expect, plan=sp_plan,
        residual=[(BIG_BATCH, BIG_SEQ // BIG_MODEL, cfg.d_model)],
        sp=(BIG_MODEL, None), gathers={}, one_expect=expect,
        vocab_rows=-(-cfg.vocab_size // BIG_MODEL),
        batch=[BIG_BATCH, BIG_SEQ], peak_limit_gb=ref["state_gb"])
    for r in res:
        check(r["peak_gb"] < ref["state_gb"],
              f"tp_train_big rank peak {r['peak_gb']} GB, the whole "
              f"layout's state alone is {ref['state_gb']} GB")
    return launches


def ep_config():
    """granite-moe-3b-a800m at its published widths, all 40 experts, and
    EP_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(EP_ARCH), num_layers=EP_LAYERS)


def ep_prompts(torch, np, cfg):
    rng = np.random.default_rng(21)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (EP_BATCH, EP_PROMPT + EP_STEPS + 1)),
                          dtype=torch.long, device="cuda")
    return seq[:, :EP_PROMPT], seq[:, EP_PROMPT:]


def ep_logits(torch, model, prompts, forced, ctx_of=None,
              kv_dtype=None, rows: int = 0, max_len: int = 0,
              with_cache: bool = False, extra=None):
    """``forced_logits`` with prefill and each decode step through
    ``_serve_wrap`` under ``ctx_of(kind)`` (the prefill and decode rules)
    when given, over a K/V cache of ``kv_dtype`` (bf16 if None) for
    ``rows`` rows (all the prompts' if 0: the wrapper cuts a rank's rows of
    the global batch, its cache holds those) and ``max_len`` positions (S
    + n if 0), made under the prefill rules: where they map ``kv_seq`` to
    the model axis and it divides the slots, this rank's block of them;
    ``extra``: more fields of the prefill batch (a vlm's patches,
    whisper's frames), cut with the rows.  Returns the logits, and with
    ``with_cache`` the cache too."""
    import contextlib as _contextlib
    from repro_torch.launch.dryrun import _serve_wrap
    B, S = prompts.shape
    n = forced.shape[1]
    with (ctx_of("prefill") if ctx_of else _contextlib.nullcontext()):
        cache = model.init_cache(rows or B, max_len or S + n,
                                 kv_dtype=kv_dtype or torch.bfloat16)

    def call(kind, fn, batch, cache):
        if ctx_of is None:
            return fn(batch, cache)
        with ctx_of(kind) as ctx:
            return _serve_wrap(model, ctx, fn)(batch, cache)

    logits, cache = call("prefill", model.prefill,
                         {"tokens": prompts, **(extra or {})}, cache)
    outs = [logits[:, -1].float()]
    pos = torch.full((B,), S, dtype=torch.long, device=prompts.device)
    for j in range(n - 1):
        logits, cache = call(
            "decode", lambda b, c: model.decode_step(c, b["tokens"],
                                                     b["positions"]),
            {"tokens": forced[:, j:j + 1], "positions": pos}, cache)
        outs.append(logits[:, -1].float())
        pos = pos + 1
    return (torch.stack(outs, dim=1), cache) if with_cache \
        else torch.stack(outs, dim=1)


def greedy_logits(torch, model, prompts, steps: int, max_len: int, kv_dtype,
                  extra=None):
    """The one-rank engine's loop: prefill (``extra``: more fields of its
    batch) and ``steps - 1`` greedy decode steps over a cache of
    ``max_len`` slots of ``kv_dtype``.  Returns the logits (B, steps, V)
    fp32, the greedy tokens (B, steps) and the cache."""
    B, S = prompts.shape
    cache = model.init_cache(B, max_len, kv_dtype=kv_dtype)
    logits, cache = model.prefill({"tokens": prompts, **(extra or {})},
                                  cache)
    outs = [logits[:, -1].float()]
    pos = torch.full((B,), S, dtype=torch.long, device=prompts.device)
    for _ in range(steps - 1):
        logits, cache = model.decode_step(cache, outs[-1].argmax(-1)[:, None],
                                          pos)
        outs.append(logits[:, -1].float())
        pos = pos + 1
    logits = torch.stack(outs, dim=1)
    return logits, logits.argmax(-1), cache


def kv_prompts(torch, np, cfg) -> list:
    rng = np.random.default_rng(22)
    return [torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                            dtype=torch.long, device="cuda")
            for shape in KV_PROMPTS]


def kv_reference(torch, np, F, modules, workdir) -> dict:
    """Phase 20's kv_seq check's reference, in the parent before the
    ranks: phase 20's qwen2-0.5b (``tp_arch_config``) on one rank from
    seed 0, each of KV_PROMPTS
    served greedily over a whole cache of KV_MAX_LEN slots in fp32 (fp32
    K/V) and teacher-forced with those tokens in bf16.  The prompts, the
    tokens and the fp32 caches go to ``WORKDIR/kv_ref.pt`` for the ranks;
    the logits are returned.  Frees the models."""
    cfg = tp_arch_config()
    prompts = kv_prompts(torch, np, cfg)
    out = {"logits32": [], "logits16": [], "tokens": [], "cache": []}
    with torch.no_grad():
        with fp32_model(torch, cfg) as m32:
            for p in prompts:
                logits, tokens, cache = greedy_logits(
                    torch, m32, p, KV_STEPS, KV_MAX_LEN, torch.float32)
                out["logits32"].append(logits.cpu())
                out["tokens"].append(tokens)
                out["cache"].append({k: cache[k].cpu() for k in ("k", "v")})
                del cache
            del m32
        model = seeded_model(torch, cfg)
        out["logits16"] = [ep_logits(torch, model, p, t,
                                     max_len=KV_MAX_LEN).cpu()
                           for p, t in zip(prompts, out["tokens"])]
        del model
    torch.save(dict(prompts=[p.cpu() for p in prompts],
                    tokens=[t.cpu() for t in out["tokens"]],
                    cache=out.pop("cache")),
               os.path.join(workdir, "kv_ref.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def unweighted_combine(out, lse, gather):
    """The control of the kv_seq check: the ranks' normalised partial
    outputs averaged over the ranks that saw a key, without the weights
    exp(lse - max) (``ops.combine_partial``'s place)."""
    import torch
    packed = gather(torch.cat([out, lse[..., None]], dim=-1))
    seen = torch.isfinite(packed[..., -1:]).to(out.dtype)
    return (seen * packed[..., :-1]).sum(0) / seen.sum(0).clamp_min(1.0)


@contextlib.contextmanager
def unweighted(cross: bool = False):
    """Every partial softmax combined without its lse weights
    (``unweighted_combine``) for the block; with ``cross`` only those of
    cross-attention's decode over the cross K/V cache (the self K/V
    blocks keep the weighted combine)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as ll
    real, real_decode = ops.combine_partial, ll.attention_decode

    def decode(*args, **kwargs):
        if kwargs.get("cross_kv") is None:
            return real_decode(*args, **kwargs)
        ops.combine_partial = unweighted_combine
        try:
            return real_decode(*args, **kwargs)
        finally:
            ops.combine_partial = real

    if cross:
        ll.attention_decode = decode
    else:
        ops.combine_partial = unweighted_combine
    try:
        yield
    finally:
        ops.combine_partial, ll.attention_decode = real, real_decode


def kv_serve_rank(torch, np, F, modules) -> dict:
    """Phase 20's kv_seq check in one of its ranks, after the step: its
    qwen2-0.5b (``tp_arch_config``) under SERVE_RULES on (data 1, model n), its weights this
    rank's shards of the storage plan drawn from seed 0, each of
    KV_PROMPTS prefilled and decoded through ``_serve_wrap`` over a cache
    of KV_MAX_LEN slots (this rank's block of them), teacher-forced with
    the one-rank greedy tokens (``kv_ref.pt``): in fp32 compute over fp32
    K/V, each fp32 block held against its slots of the one-rank cache;
    then the long prompts in fp32 with the partial softmaxes combined
    without their weights (the control); then bf16 with its launches.
    Rank 0 returns the logits, every rank their digest."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as ll
    from repro_torch.train.train_step import param_plan
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    rank, n = dist.get_rank(), dist.get_world_size()
    cfg = tp_arch_config()
    mesh = make_local_mesh(model_axis=n, device="cuda")
    workdir = modules["workdir"]
    ref = torch.load(os.path.join(workdir, "kv_ref.pt"), mmap=True)

    def ctx_of(kind):
        return use_rules(mesh, rules_for(kind))

    with ctx_of("prefill") as ctx:
        plan = param_plan(cfg, ctx)
    out = {}

    def served(model, i, dtype, held):
        """Prompt set ``i`` served: its logits' digest (and logits on rank
        0), the cache's blocks and bytes, and (``held``) its fp32 block
        against its slots of the one-rank cache."""
        logits, cache = ep_logits(
            torch, model, ref["prompts"][i].to("cuda"),
            ref["tokens"][i].to("cuda"), ctx_of,
            kv_dtype=dtype, max_len=KV_MAX_LEN, with_cache=True)
        row = dict(digest=hashlib.sha256(
            logits.cpu().numpy().tobytes()).hexdigest(),
            kv_shards=cache.kv_shards,
            cache_bytes=sum(cache[k].numel() * cache[k].element_size()
                            for k in ("k", "v")),
            block=cache["k"].shape[2])
        if rank == 0:
            row["logits"] = logits.cpu()
        if dtype == torch.float32:
            lo = rank * cache["k"].shape[2]
            err, scale = 0.0, 0.0
            for name in ("k", "v"):
                want = ref["cache"][i][name]
                mine = want[:, :, lo:lo + cache[name].shape[2]]
                err = max(err, float((cache[name] - mine.to("cuda"))
                                     .abs().max()))
                scale = max(scale, float(want.abs().max()))
            row.update(cache_err=err, cache_max=scale)
        return row

    def run(key, dtype, sets, combine=None):
        saved, real = ll.COMPUTE_DTYPE, ops.combine_partial
        ll.COMPUTE_DTYPE = dtype
        if combine is not None:
            ops.combine_partial = combine
        model = None
        try:
            t0 = time.perf_counter()
            model = sharded_serving_model(torch, cfg, plan)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            zero_launches(fa, rn, ss)
            t0 = time.perf_counter()
            with host_clock() as clock:
                rows = [served(model, i, dtype, combine is None)
                        for i in sets]
                torch.cuda.synchronize()
            out[key] = dict(rows=rows, seconds=time.perf_counter() - t0,
                            build_s=build_s, clock=clock,
                            launches=dense_launches(fa, rn))
        finally:
            ll.COMPUTE_DTYPE, ops.combine_partial = saved, real
            del model
            torch.cuda.empty_cache()

    with torch.no_grad():
        sets = range(len(KV_PROMPTS))
        run("fp32", torch.float32, sets)
        run("control", torch.float32, [0], unweighted_combine)
        run("bf16", torch.bfloat16, sets)
    del ref
    return out


def sharded_serving_model(torch, cfg, plan):
    """``seeded_model`` on the storage plan: each leaf drawn whole from
    seed 0 in turn, cut to this rank's shard and cast to the compute dtype
    at load."""
    from repro_torch.models import build_model
    from repro_torch.models.lm import init_sharded_params
    params = init_sharded_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), plan)
    return build_model(cfg, params, device="cuda", plan=plan)


def ep_serve_rank(torch, np, F, modules, workdir) -> dict:
    """One rank of phase 21: granite's prefill and decode through
    ``_serve_wrap`` under SERVE_RULES_BIG on (data EP_DATA, model
    EP_MODEL), its bf16 weights stored as the plan's shards, in bf16, the
    prefill with the MoE combine's all-reduce left out (the control), then
    in fp32 compute over an fp32 K/V cache."""
    import torch.distributed as dist

    from repro_torch.distributed import dp_shard, model_axis, transport
    from repro_torch.distributed.sharding_rules import (model_group,
                                                        rules_for, use_rules)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as ll
    from repro_torch.train.train_step import param_plan, param_shapes
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    rank = dist.get_rank()
    cfg = ep_config()
    mesh = make_local_mesh(model_axis=EP_MODEL, device="cuda")
    rows = EP_BATCH // EP_DATA

    def ctx_of(kind):
        return use_rules(mesh, rules_for(kind, big_params=True))

    with ctx_of("prefill") as ctx:
        plan = param_plan(cfg, ctx)
    model = sharded_serving_model(torch, cfg, plan)
    prompts, forced = ep_prompts(torch, np, cfg)
    out = {"backend": str(dist.get_backend(model_group(mesh))),
           "heads": ll.rank_heads(cfg, EP_MODEL, rank % EP_MODEL)._asdict(),
           "data_rank": rank // EP_MODEL,
           "held_bytes": sum(p.numel() * p.element_size()
                             for p in model.parameters()),
           "whole_bytes": sum(math.prod(s) * 2 for s in
                              param_shapes(cfg).values()),
           "split": {k: {str(d): list(a) for d, a in dims.items()}
                     for k, dims in plan.dims.items()
                     if k.startswith(("layers.0.", "embed"))}}
    with torch.no_grad():
        zero_launches(fa, rn, ss)
        for counter in (model_axis.collectives, dp_shard.collectives,
                        dp_shard.model_gathers, transport.moved):
            counter.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # a cache of the 520 slots the prompt and the steps write, which
        # the model axis of 2 divides: a block of 260 a rank
        logits, cache = ep_logits(torch, model, prompts, forced, ctx_of,
                                  rows=rows, max_len=EP_PROMPT + EP_STEPS,
                                  with_cache=True)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["kv_shards"], out["kv_block"] = cache.kv_shards, \
            cache["k"].shape[2]
        del cache
        out["launches"] = dense_launches(fa, rn)
        out["collectives"] = dict(model_axis.collectives)
        out["dp_collectives"] = dict(dp_shard.collectives)
        out["model_gathers"] = dict(dp_shard.model_gathers)
        out["moved"] = dict(transport.moved)
        real = ll._moe_ep

        def no_combine(*args, **kwargs):
            keep = model_axis.from_model
            model_axis.from_model = lambda y, s: y
            try:
                return real(*args, **kwargs)
            finally:
                model_axis.from_model = keep

        ll._moe_ep = no_combine
        try:
            # the prefill alone: every data-gathered layer of a decode step
            # costs as much host staging as a prefill's
            control = ep_logits(torch, model, prompts, forced[:, :1], ctx_of,
                                rows=rows, max_len=EP_PROMPT + EP_STEPS)
        finally:
            ll._moe_ep = real
        out["logits"] = logits.cpu().numpy()
        out["control"] = control.cpu().numpy()
        # check (a): a batch the data ranks do not divide, on this model
        t_solo = time.perf_counter()
        solo = dict(held_bytes=out["held_bytes"],
                    shard_bytes=shard_bytes(cfg, plan, torch.bfloat16),
                    whole_bytes=out["whole_bytes"])
        solo["bf16"] = solo_rank_runs(torch, np, modules, "a", model, ctx_of,
                                      torch.bfloat16, control=True)
        del model
        torch.cuda.empty_cache()
        saved = ll.COMPUTE_DTYPE
        ll.COMPUTE_DTYPE = torch.float32
        try:
            t0 = time.perf_counter()
            m32 = sharded_serving_model(torch, cfg, plan)
            out["logits32"] = ep_logits(torch, m32, prompts, forced, ctx_of,
                                        torch.float32, rows=rows,
                                        max_len=EP_PROMPT + EP_STEPS
                                        ).cpu().numpy()
            out["fp32_s"] = time.perf_counter() - t0
            solo["fp32"] = solo_rank_runs(torch, np, modules, "a", m32,
                                          ctx_of, torch.float32,
                                          control=False,
                                          steps=SOLO_FP32_STEPS)
            del m32
        finally:
            ll.COMPUTE_DTYPE = saved
            torch.cuda.empty_cache()
        solo["rank_s"] = time.perf_counter() - t_solo - out.get(
            "fp32_s", 0.0)
        # check (b): mixtral's ring at its published widths
        t0 = time.perf_counter()
        out["solo"] = {"a": solo, "b": solo_ring_rank(torch, np, modules,
                                                      mesh)}
        out["solo"]["b"]["rank_s"] = time.perf_counter() - t0
    return out


def solo_config(key: str):
    """The model of phase 21's serve_replicated check ``key``: "a" the
    phase's granite (``ep_config``), "b" mixtral-8x22b at its published
    widths and SOLO_RING_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import get_config
    if key == "a":
        return ep_config()
    return dataclasses.replace(get_config(RING_ARCH),
                               num_layers=SOLO_RING_LAYERS)


def solo_requests(torch, np, key: str, cfg) -> list:
    """[(prompts, forced tokens)] of check ``key``, seeded: (a) one
    request of EP_PROMPT tokens with SOLO_STEPS + 1 forced tokens, and
    SOLO_ROWS rows with one (prefill only); (b) one request of
    SOLO_RING_PROMPT tokens with SOLO_STEPS + 1."""
    S = EP_PROMPT if key == "a" else SOLO_RING_PROMPT
    rows = SOLO_ROWS if key == "a" else 1
    rng = np.random.default_rng(30 if key == "a" else 31)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (rows, S + SOLO_STEPS + 1)),
                          dtype=torch.long, device="cuda")
    out = [(seq[:1, :S], seq[:1, S:])]
    if key == "a":
        out.append((seq[:, :S], seq[:, S:S + 1]))
    return out


def solo_max_len(key: str) -> int:
    """The positions check ``key``'s cache is made for: those the prompt
    and the SOLO_STEPS decode steps write."""
    return (EP_PROMPT if key == "a" else SOLO_RING_PROMPT) + SOLO_STEPS


def solo_logits(torch, model, prompts, forced, ctx_of, max_len: int,
                kv_dtype=None, keep_prefill: bool = False) -> dict:
    """One request set through ``_serve_wrap`` under ``ctx_of(kind)``, all
    its rows on every rank: the prefill, then ``forced.shape[1] - 1``
    teacher-forced decode steps, over a cache of ``kv_dtype`` (bf16 if
    None) made under the prefill rules for every row (``kv_seq`` blocks).
    Returns the logits (B, steps, V) fp32, the wrapper's path at each
    call, the cache's blocks and block slots, and with ``keep_prefill`` a
    copy of the cache as the prefill left it (``solo_control``)."""
    import copy

    from repro_torch.launch.dryrun import _serve_wrap
    B, S = prompts.shape
    with ctx_of("prefill") as ctx:
        cache = model.init_cache(B, max_len,
                                 kv_dtype=kv_dtype or torch.bfloat16)
        prefill = _serve_wrap(model, ctx, model.prefill)
        logits, cache = prefill({"tokens": prompts}, cache)
    out = dict(paths=[prefill.path])
    if keep_prefill:
        out["prefill_cache"] = copy.copy(cache)
        for k in cache:
            out["prefill_cache"][k] = cache[k].clone()
    steps, cache = solo_decode(torch, model, cache, forced, ctx_of, S,
                               out["paths"])
    out.update(logits=torch.stack([logits[:, -1].float()] + steps, 1),
               kv_shards=cache.kv_shards, kv_block=cache["k"].shape[2])
    return out


def solo_decode(torch, model, cache, forced, ctx_of, S: int, paths: list):
    """``forced.shape[1] - 1`` teacher-forced decode steps from position
    ``S`` through ``_serve_wrap`` (each call's path appended to
    ``paths``): the fp32 logits of each step and the cache."""
    from repro_torch.launch.dryrun import _serve_wrap
    B = forced.shape[0]
    pos = torch.full((B,), S, dtype=torch.long, device=forced.device)
    outs = []
    for j in range(forced.shape[1] - 1):
        with ctx_of("decode") as ctx:
            step = _serve_wrap(model, ctx, lambda b, c: model.decode_step(
                c, b["tokens"], b["positions"]))
            logits, cache = step({"tokens": forced[:, j:j + 1],
                                  "positions": pos}, cache)
        paths.append(step.path)
        outs.append(logits[:, -1].float())
        pos = pos + 1
    return outs, cache


def solo_control(torch, model, cache, forced, ctx_of, S: int):
    """The control of the serve_replicated checks: the first decode step
    from the prefill's cache with each rank's K/V block alone, its
    partial softmax taken as the output (``ops.combine_partial`` left
    out)."""
    from repro_torch.kernels import ops
    real = ops.combine_partial
    ops.combine_partial = lambda part, lse, gather: part
    try:
        outs, _ = solo_decode(torch, model, cache, forced[:, :2], ctx_of, S,
                              [])
    finally:
        ops.combine_partial = real
    return torch.stack(outs, 1)


def shard_bytes(cfg, plan, dtype) -> int:
    """The bytes of a serving model's leaves on the storage plan: each
    leaf's shard (``plan.local_shape``) in ``dtype``, the leaves the port
    keeps in fp32 (``lm._FP32_LEAVES``) in fp32."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import param_shapes
    return sum(math.prod(plan.local_shape(k, s))
               * (4 if k.rsplit(".", 1)[-1] in lm._FP32_LEAVES
                  else dtype.itemsize)
               for k, s in param_shapes(cfg).items())


def solo_reference(torch, np, F, modules, key: str, model=None) -> dict:
    """The one-rank port's logits of check ``key``'s requests over all
    their rows, from seed 0, in the parent before the ranks: through the
    kernels in bf16 (``model``, the phase's own where given), through the
    plain twins, and in fp32 over an fp32 K/V cache; the bf16 noise floor
    (the largest distance between the first two over the positions), the
    launches of the kernels' run and its seconds.  Frees what it built."""
    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))
    cfg = solo_config(key)
    reqs = solo_requests(torch, np, key, cfg)
    L = solo_max_len(key)
    own = model is None
    out = {}
    t_all = time.perf_counter()
    with torch.no_grad():
        if own:
            model = seeded_model(torch, cfg)
        zero_launches(fa, rn, ss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["bf16"] = [ep_logits(torch, model, p, f, max_len=L)
                       for p, f in reqs]
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = dense_launches(fa, rn)
        with plain_kernels(ops, fa, rn, ss):
            plain = [ep_logits(torch, model, p, f, max_len=L)
                     for p, f in reqs]
        out["floor"] = max(float((1.0 - F.cosine_similarity(
            a, b, dim=-1)).max()) for a, b in zip(plain, out["bf16"]))
        out["plain_top1"] = [float((a.argmax(-1) == b.argmax(-1)).float()
                                   .mean()) for a, b in zip(plain,
                                                            out["bf16"])]
        del plain
        if own:
            del model
        model = None
        gc.collect()
        torch.cuda.empty_cache()
        with fp32_model(torch, cfg) as m32:
            out["fp32"] = [ep_logits(torch, m32, p, f[:, :SOLO_FP32_STEPS + 1],
                                     kv_dtype=torch.float32, max_len=L)
                           for p, f in reqs]
            del m32
    gc.collect()
    torch.cuda.empty_cache()
    out["total_s"] = time.perf_counter() - t_all
    return out


def solo_rank_runs(torch, np, modules, key: str, model, ctx_of, dtype,
                   control: bool, steps: int = SOLO_STEPS) -> dict:
    """Check ``key``'s requests in one rank through ``solo_logits`` on
    ``model`` (its shards of the storage plan, in ``dtype``), under
    deterministic algorithms (the MoE combine's ``index_add`` adds in
    any order through CUDA's atomics otherwise, so two runs of one rank
    differ in the last bits, let alone two data ranks): each request's
    logits, paths, blocks and the launches of these runs; with
    ``control`` then ``solo_control``'s logits of each request that
    decodes.  ``steps``: the decode steps a request takes at most.
    Deterministic algorithms would also fill every new buffer, each
    call's gathered leaves included (``fill_uninitialized_memory``): the
    check turns that off, since no output here reads unwritten memory."""
    import torch.utils.deterministic as det
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    cfg = solo_config(key)
    L = solo_max_len(key)
    reqs = [(p, f[:, :steps + 1])
            for p, f in solo_requests(torch, np, key, cfg)]
    kv_dtype = torch.float32 if dtype == torch.float32 else None
    zero_launches(fa, rn, ss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        runs = [solo_logits(torch, model, p, f, ctx_of, L, kv_dtype,
                            keep_prefill=control and f.shape[1] > 1)
                for p, f in reqs]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill
    out = dict(seconds=time.perf_counter() - t0,
               launches=dense_launches(fa, rn),
               logits=[r["logits"].cpu().numpy() for r in runs],
               paths=[r["paths"] for r in runs],
               blocks=[(r["kv_shards"], r["kv_block"]) for r in runs])
    if control:
        out["control"] = [
            solo_control(torch, model, r.pop("prefill_cache"), f, ctx_of,
                         p.shape[1]).cpu().numpy()
            for r, (p, f) in zip(runs, reqs) if f.shape[1] > 1]
    return out


def solo_ring_rank(torch, np, modules, mesh) -> dict:
    """Check (b) in one rank: mixtral (``solo_config("b")``) on the storage
    plan of SERVE_RULES_BIG on ``mesh``, its shards drawn from seed 0, in
    bf16 with the control, then in fp32; the bytes it holds beside its
    shards' and the whole model's."""
    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.models import layers as ll
    from repro_torch.train.train_step import param_plan, param_shapes
    cfg = solo_config("b")

    def ctx_of(kind):
        return use_rules(mesh, rules_for(kind, big_params=True))

    with ctx_of("prefill") as ctx:
        plan = param_plan(cfg, ctx)
    t0 = time.perf_counter()
    model = sharded_serving_model(torch, cfg, plan)
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0,
               held_bytes=sum(p.numel() * p.element_size()
                              for p in model.parameters()),
               shard_bytes=shard_bytes(cfg, plan, torch.bfloat16),
               whole_bytes=sum(math.prod(s) * 2 for s in
                               param_shapes(cfg).values()))
    out["bf16"] = solo_rank_runs(torch, np, modules, "b", model, ctx_of,
                                 torch.bfloat16, control=True)
    del model
    torch.cuda.empty_cache()
    saved = ll.COMPUTE_DTYPE
    ll.COMPUTE_DTYPE = torch.float32
    try:
        m32 = sharded_serving_model(torch, cfg, plan)
        out["fp32"] = solo_rank_runs(torch, np, modules, "b", m32, ctx_of,
                                     torch.float32, control=False,
                                     steps=SOLO_FP32_STEPS)
        del m32
    finally:
        ll.COMPUTE_DTYPE = saved
        torch.cuda.empty_cache()
    return out


def solo_verdict(torch, np, F, key: str, res, ref) -> dict:
    """Check ``key`` of phase 21's serve_replicated path against the
    one-rank reference (``solo_reference``), by the phase's rule: fp32
    cosine and top-1, bf16 distance within EP_MIN_COSINE or EP_FLOOR_RATIO
    x the noise floor; the data ranks' logits bit-equal; every call on
    ``serve_replicated``; each cache EP_MODEL blocks of its slots; the
    bytes a rank holds its shards'; the control past the limit; the
    launches exact.  Emits the check's line and returns the launches of
    its bf16 runs summed over the ranks."""
    cfg = solo_config(key)
    L = cfg.num_layers
    runs = [r["solo"][key] for r in res]
    limit = max(1.0 - EP_MIN_COSINE, EP_FLOOR_RATIO * ref["floor"])

    def agree(dtype, want, field="logits"):
        cos, top1 = [], []
        for r in runs:
            for got, w in zip(r[dtype][field], want):
                got = torch.from_numpy(got).to("cuda")
                cos.append(F.cosine_similarity(got, w, dim=-1).ravel())
                top1.append((got.argmax(-1) == w.argmax(-1)).float().ravel())
        cos, top1 = torch.cat(cos), torch.cat(top1)
        return float(cos.min()), float(cos.mean()), float(top1.mean())

    cos16 = agree("bf16", ref["bf16"])
    cos32 = agree("fp32", ref["fp32"])
    decoding = [w[:, 1:2] for w in ref["bf16"] if w.shape[1] > 1]
    c_cos = agree("bf16", decoding, "control")
    same = all(np.array_equal(a, b)
               for d in ("bf16", "fp32") for m in range(EP_MODEL)
               for r in range(EP_MODEL, len(runs), EP_MODEL)
               for a, b in zip(runs[m][d]["logits"], runs[r + m][d]["logits"]))
    paths = {p for r in runs for d in ("bf16", "fp32")
             for ps in r[d]["paths"] for p in ps}
    slots = min(solo_max_len(key), cfg.sliding_window or solo_max_len(key))
    blocks_ok = all(b == (EP_MODEL, slots // EP_MODEL)
                    for r in runs for d in ("bf16", "fp32")
                    for b in r[d]["blocks"])
    held = [(r["held_bytes"], r["shard_bytes"]) for r in runs]
    held_ok = all(h == w < r["whole_bytes"] / EP_DATA
                  for (h, w), r in zip(held, runs))
    reqs = [(int(w.shape[0]), int(w.shape[1])) for w in ref["bf16"]]
    expect = {"flash_attention": L * len(reqs),
              "flash_attention_backward": 0, "rmsnorm_backward": 0,
              "rmsnorm": (2 * L + 1) * sum(n for _, n in reqs)}
    emit("ep_serve_replicated", check=key, arch=cfg.name,
         mesh={"data": EP_DATA, "model": EP_MODEL}, rules="SERVE_RULES_BIG",
         layers=L, reduced=SOLO_RING_REDUCED if key == "b" else
         {"num_layers": f"32 -> {L} (phase 21's depth)"},
         requests=[dict(rows=b, prompt=(EP_PROMPT if key == "a"
                                        else SOLO_RING_PROMPT),
                        decode_steps=n - 1) for b, n in reqs],
         paths=sorted(paths), kv_blocks=EP_MODEL,
         kv_block_slots=slots // EP_MODEL, slots=slots,
         held_and_shard_bytes_per_rank=held,
         whole_bf16_bytes=runs[0]["whole_bytes"],
         min_cosine=cos16[0], mean_cosine=cos16[1], top1=cos16[2],
         plain_top1=ref["plain_top1"], floor=ref["floor"],
         max_distance=limit, data_ranks_equal=same,
         fp32=dict(min_cosine=cos32[0], mean_cosine=cos32[1],
                   top1=cos32[2], decode_steps=SOLO_FP32_STEPS),
         control=dict(what="each rank's K/V block alone at the first "
                           "decode step, no partial-softmax combine",
                      min_cosine=c_cos[0], mean_cosine=c_cos[1],
                      top1=c_cos[2]),
         launches_per_rank=[r["bf16"]["launches"] for r in runs],
         expected_launches_per_rank=expect,
         one_rank_launches=ref["launches"], one_rank_s=ref["seconds"],
         seconds_per_rank=[r["bf16"]["seconds"] for r in runs],
         fp32_seconds_per_rank=[r["fp32"]["seconds"] for r in runs],
         check_s_per_rank=[r["rank_s"] for r in runs],
         one_rank_reference_s=ref["total_s"],
         timing_note="not a speed: the ranks share one card and every "
                     "collective crosses the host")
    tag = f"ep_serve_replicated ({key}, {cfg.name})"
    check(paths == {"serve_replicated"}, f"{tag}: wrapper paths {paths}")
    check(blocks_ok, f"{tag}: caches "
          f"{[r[d]['blocks'] for r in runs for d in ('bf16', 'fp32')]}, "
          f"not {EP_MODEL} blocks of {slots} slots")
    check(held_ok, f"{tag}: held and shard bytes {held}")
    check(cos32[0] >= EP_MIN_COSINE and cos32[2] >= EP_MIN_TOP1,
          f"{tag} fp32 logits: min cosine {cos32[0]}, top-1 {cos32[2]}")
    check(1.0 - cos16[0] <= limit, f"{tag} bf16 logits: min cosine "
          f"{cos16[0]} (largest distance {limit})")
    check(same, f"{tag}: the data ranks' logits differ")
    check(1.0 - c_cos[0] > limit, f"{tag}'s control (a rank's K/V block "
          f"alone) passed: min cosine {c_cos[0]}")
    for r in runs:
        check(r["bf16"]["launches"] == expect, f"{tag} rank launches "
              f"{r['bf16']['launches']}, expected {expect}")
    check(ref["launches"] == expect, f"{tag} one-rank launches "
          f"{ref['launches']}, expected {expect}")
    return {k: sum(r["bf16"]["launches"][k] for r in runs) for k in expect}


def ep_serve_path(torch, np, F, modules) -> dict:
    """Phase 21: the model axis serves granite-moe-3b-a800m (EP_LAYERS
    deep, published widths) over
    EP_DATA x EP_MODEL gloo ranks on the card through ``_serve_wrap`` under
    SERVE_RULES_BIG (see EP_ARCH), against the one-rank port on the same
    seeded weights, in bf16 (and through the plain twins for the noise
    floor) and in fp32, each data rank's rows served here as a batch of
    their own (an expert's capacity counts one data rank's tokens), first,
    and freed before the ranks start.  Returns the launches of the ranks'
    bf16 run, summed over the ranks."""
    import shutil
    import tempfile

    ops, fa, rn, ss = (modules[k] for k in ("ops", "fa", "rn", "ss"))
    cfg = ep_config()
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    rows = EP_BATCH // EP_DATA

    def per_shard(model, **kw):
        """The one-rank logits of each data rank's rows served as a batch
        of their own: an expert's capacity counts the tokens one data
        rank routes, as under ``repro``'s data-sharded serving."""
        return torch.cat([ep_logits(torch, model, prompts[i:i + rows],
                                    forced[i:i + rows], **kw)
                          for i in range(0, EP_BATCH, rows)])

    with torch.no_grad():
        model = seeded_model(torch, cfg)
        prompts, forced = ep_prompts(torch, np, cfg)
        zero_launches(fa, rn, ss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = per_shard(model)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_launches = dense_launches(fa, rn)
        with plain_kernels(ops, fa, rn, ss):
            plain = per_shard(model)
        floor = float((1.0 - F.cosine_similarity(plain, ref, dim=-1)).max())
        floor_top1 = float((plain.argmax(-1) == ref.argmax(-1)).float()
                           .mean())
        del plain
        solo_ref = {"a": solo_reference(torch, np, F, modules, "a", model)}
        del model
        with fp32_model(torch, cfg) as m32:
            ref32 = per_shard(m32, kv_dtype=torch.float32)
            del m32
    gc.collect()
    torch.cuda.empty_cache()
    solo_ref["b"] = solo_reference(torch, np, F, modules, "b")
    workdir = tempfile.mkdtemp(prefix="ep_serve_")
    try:
        t0 = time.perf_counter()
        res = spawn_card_ranks("ep_serve", EP_DATA * EP_MODEL, workdir)
        phase_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def agree(key, want):
        """Every rank's logits against its rows of ``want``."""
        got = torch.cat([torch.from_numpy(r[key]).to("cuda")
                         for r in res[::EP_MODEL]])
        cos = F.cosine_similarity(got, want, dim=-1)
        top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        return cos, top1

    limit = max(1.0 - EP_MIN_COSINE, EP_FLOOR_RATIO * floor)
    cos, top1 = agree("logits", ref)
    c_cos, c_top1 = agree("control", ref[:, :1])
    cos32, top1_32 = agree("logits32", ref32)
    same = all(np.array_equal(r["logits"],
                              res[r["data_rank"] * EP_MODEL]["logits"])
               for r in res)
    order = [r["data_rank"] for r in res] == [i // EP_MODEL
                                             for i in range(len(res))]
    expect = {"flash_attention": L, "flash_attention_backward": 0,
              "rmsnorm": (2 * L + 1) * (1 + EP_STEPS), "rmsnorm_backward": 0}
    r0 = res[0]
    emit("ep_serve_backend", backend=r0["backend"], ranks=len(res),
         moved_per_rank=[r["moved"] for r in res],
         note="collectives stage each tensor through host memory (gloo); "
              "the ranks share one card")
    emit("ep_serve_collectives", model_axis=r0["collectives"],
         dp_shard=r0["dp_collectives"], model_gathers=r0["model_gathers"])
    emit("ep_serve", arch=cfg.name,
         mesh={"data": EP_DATA, "model": EP_MODEL}, rules="SERVE_RULES_BIG",
         prompts=[EP_BATCH, EP_PROMPT], rows_per_rank=rows,
         decode_steps=EP_STEPS, heads=r0["heads"],
         layer0_and_embed_storage=r0["split"],
         kv_blocks=r0["kv_shards"], kv_block_slots=r0["kv_block"],
         held_bytes_per_rank=[r["held_bytes"] for r in res],
         whole_bf16_bytes=r0["whole_bytes"],
         experts="40 experts, no virtual layout: stored whole over the "
                 "model ranks (their embed dim over data), 20 computed a "
                 "rank", vocab=cfg.vocab_size,
         vocab_padded=-(-cfg.vocab_size // EP_MODEL) * EP_MODEL,
         positions=int(cos.numel()),
         min_cosine=float(cos.min()), mean_cosine=float(cos.mean()),
         top1=top1, plain_top1=floor_top1, floor=floor,
         max_distance=limit, ranks_equal=same,
         fp32=dict(min_cosine=float(cos32.min()),
                   mean_cosine=float(cos32.mean()), top1=top1_32),
         control=dict(what="the MoE combine without its all-reduce, "
                           "at the prefill", positions=int(c_cos.numel()),
                      min_cosine=float(c_cos.min()),
                      mean_cosine=float(c_cos.mean()), top1=c_top1),
         launches_per_rank=[r["launches"] for r in res],
         expected_launches_per_rank=expect, one_rank_launches=one_launches,
         peak_gb_per_rank=[r["peak_gb"] for r in res],
         seconds_per_rank=[r["seconds"] for r in res], one_rank_s=one_s,
         phase_s=phase_s,
         timing_note="not a speed: the ranks share one card and every "
                     "collective crosses the host",
         min_cosine_limit=EP_MIN_COSINE, min_top1=EP_MIN_TOP1,
         floor_ratio=EP_FLOOR_RATIO)
    check(r0["backend"] == "gloo" and all(staged_only(r) for r in res),
          f"ep_serve ran on {r0['backend']}, collectives moved "
          f"{[r['moved'] for r in res]}")
    check(order, f"ep_serve ranks' data rows {[r['data_rank'] for r in res]}")
    slots = EP_PROMPT + EP_STEPS
    check(all(r["kv_shards"] == EP_MODEL and r["kv_block"] * EP_MODEL == slots
              for r in res),
          f"ep_serve K/V caches "
          f"{[(r['kv_shards'], r['kv_block']) for r in res]}, not blocks of "
          f"{slots} slots over {EP_MODEL} model ranks")
    check(all(r["held_bytes"] < r["whole_bytes"] / EP_DATA for r in res),
          f"ep_serve ranks hold {[r['held_bytes'] for r in res]} bytes of "
          f"{r0['whole_bytes']}")
    check(float(cos32.min()) >= EP_MIN_COSINE and top1_32 >= EP_MIN_TOP1,
          f"ep_serve fp32 logits: min cosine {float(cos32.min())}, top-1 "
          f"{top1_32}")
    check(1.0 - float(cos.min()) <= limit,
          f"ep_serve bf16 logits: min cosine {float(cos.min())} (largest "
          f"distance {limit})")
    check(same, "ep_serve: the model ranks' logits differ")
    check(1.0 - float(c_cos.min()) > limit,
          f"ep_serve's control (no combine all-reduce) passed: min cosine "
          f"{float(c_cos.min())}")
    for r in res:
        check(r["launches"] == expect, f"ep_serve rank launches "
              f"{r['launches']}, expected {expect}")
    check(one_launches == {k: EP_DATA * v for k, v in expect.items()},
          f"ep_serve one-rank launches {one_launches} over {EP_DATA} "
          f"batches, expected {expect} a batch")
    launches = {k: sum(r["launches"][k] for r in res) for k in expect}
    launches["serve_replicated"] = {
        key: solo_verdict(torch, np, F, key, res, solo_ref[key])
        for key in ("a", "b")}
    return launches


def ssm_tp_configs() -> dict:
    """{phase: config} of phase 22: hymba-1.5b and mamba2-780m at their
    published widths, SSM_TP_LAYERS layers each (hymba's layer 0
    global)."""
    import dataclasses

    from repro_torch.configs import get_config
    return {"tp_hybrid": dataclasses.replace(
                get_config(HYBRID_ARCH), num_layers=SSM_TP_LAYERS,
                global_attn_layers=(0,)),
            "tp_ssm": dataclasses.replace(get_config(SSM_ARCH),
                                          num_layers=SSM_TP_LAYERS)}


def ssm_expect(cfg, split: bool = True, steps: int = 1) -> dict:
    """Launches of ``steps`` forward passes of ``cfg`` (with a backward:
    the step at remat "none", or a serving pass of ``steps`` prefill and
    decode calls, whose flash and SSD scan launch at the prefill only; the
    caller counts those): one flash a global layer, the whole-row rmsnorm
    for ln1, the final norm and (hybrid) ln2 and the two mixing norms, the
    gate norm too unless ``split``, where it is the split pair's one
    launch each a layer."""
    L = cfg.num_layers
    per_layer = 4 if cfg.uses_attention else 1
    norms = (per_layer + (not split)) * L + 1
    return {"flash_attention": len(cfg.global_attn_layers),
            "flash_attention_backward": len(cfg.global_attn_layers),
            "rmsnorm": norms * steps, "rmsnorm_backward": norms,
            "ssd_scan": L, "ssd_scan_backward": L,
            "row_sumsq": L * steps * split,
            "rmsnorm_total": L * steps * split}


@contextlib.contextmanager
def norm_unsummed():
    """The gate norm's sums over the model ranks left out
    (``model_axis.sum_ranks`` the identity): each rank normalises its part
    of each row by its own part's sum of squares over the whole row's
    width, and so in the backward."""
    from repro_torch.distributed import model_axis
    real = model_axis.sum_ranks
    model_axis.sum_ranks = lambda x, split: x.detach().clone()
    try:
        yield
    finally:
        model_axis.sum_ranks = real


@contextlib.contextmanager
def ssm_partial_unsummed():
    """The SSM leaves a rank uses in part (``in_B``, ``in_C``, and those
    the guard left whole) left out of the once-a-step sum over the model
    ranks."""
    from repro_torch.distributed import dp_shard
    real = dp_shard.model_psum

    def model_psum(grads, names, mesh):
        return real(grads, [k for k in names if ".ssm." not in k], mesh)

    dp_shard.model_psum = model_psum
    try:
        yield
    finally:
        dp_shard.model_psum = real


@contextlib.contextmanager
def plain_ssd(ops, ss):
    """The SSD scan routed to its plain twin for the block: phase 22's fp32
    serve checks hold each rank's state to SSM_STATE_OF_MAX of the
    one-rank state, and the fp32 kernel is itself held to 1e-3 of the
    twin (TOL_SSD), so both sides scan with the twin there; the kernel's
    own fp32 path is run beside it and recorded (``fp32_kernels``)."""
    saved = ops._ssd
    ops._ssd = types.SimpleNamespace(ssd_scan=ss.ssd_scan_plain,
                                     ssd_scan_state=ss.ssd_scan_state_plain,
                                     takes_ragged=lambda *a: False)
    try:
        yield
    finally:
        ops._ssd = saved


def ssm_kv_prompts(torch, np, cfg, key) -> list:
    rng = np.random.default_rng(23)
    return [torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                            dtype=torch.long, device="cuda")
            for shape in SSM_SERVE[key][1]]


def ssm_kv_reference(torch, np, F, modules, workdir, key, cfg) -> dict:
    """Phase 22's serve reference for ``key``, in the parent before the
    ranks: ``cfg`` on one rank from seed 0, each of its SSM_SERVE prompt
    sets served greedily in fp32 (an fp32 K/V cache, the SSD scan through
    its plain twin, ``plain_ssd``) and teacher-forced with those tokens in
    bf16.  The prompts, the tokens and the fp32 caches after the prefill
    and after the decode steps go to
    ``WORKDIR/kv_<key>.pt`` for the ranks; the logits are returned."""
    max_len = SSM_SERVE[key][0]
    prompts = ssm_kv_prompts(torch, np, cfg, key)
    out = {"logits32": [], "logits16": [], "tokens": [], "cache": [],
           "prefill_cache": []}
    with torch.no_grad():
        with fp32_model(torch, cfg) as m32, \
                plain_ssd(modules["ops"], modules["ss"]):
            for p in prompts:
                logits, tokens, cache = greedy_logits(
                    torch, m32, p, KV_STEPS, max_len, torch.float32)
                out["logits32"].append(logits.cpu())
                out["tokens"].append(tokens)
                out["cache"].append({k: cache[k].cpu() for k in cache
                                     if k in ("k", "v", "ssm_state")})
                _, cache = ep_logits(torch, m32, p, tokens[:, :1],
                                     kv_dtype=torch.float32, max_len=max_len,
                                     with_cache=True)
                out["prefill_cache"].append(
                    {k: cache[k].cpu() for k in cache
                     if k in ("k", "v", "ssm_state")})
                del cache
            del m32
        model = seeded_model(torch, cfg)
        out["logits16"] = [ep_logits(torch, model, p, t,
                                     max_len=max_len).cpu()
                           for p, t in zip(prompts, out["tokens"])]
        del model
    torch.save(dict(prompts=[p.cpu() for p in prompts],
                    tokens=[t.cpu() for t in out["tokens"]],
                    cache=out.pop("cache"),
                    prefill_cache=out.pop("prefill_cache")),
               os.path.join(workdir, f"kv_{key}.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssm_serve_rank(torch, np, F, modules, workdir, key, cfg) -> dict:
    """Phase 22's serve check in one of its ranks, after the step:
    ``cfg`` under SERVE_RULES on (data 1, model n), its weights this
    rank's shards of the storage plan drawn from seed 0, each prompt set
    prefilled and decoded through ``_serve_wrap`` over a cache of the
    max_len positions (the SSM leaves of this rank's heads, the K/V this
    rank's block of the slots), teacher-forced with the one-rank greedy
    tokens (``kv_<key>.pt``): in fp32 over fp32 K/V with the plain SSD
    scan (``plain_ssd``), each fp32 SSM state and K/V block, after the
    prefill (a prefill alone) and after the decode steps, against its
    part of the one-rank cache; the same through the fp32 SSD kernel
    (``fp32_kernels``, recorded); then the first set in fp32 under the
    control (hymba: the partial softmaxes combined without their weights;
    mamba2: the gate norm's sums left out); then bf16 with its launches.
    Rank 0 returns the logits, every rank their digest."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as ll
    from repro_torch.train.train_step import param_plan
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_local_mesh(model_axis=n, device="cuda")
    max_len = SSM_SERVE[key][0]
    ref = torch.load(os.path.join(workdir, f"kv_{key}.pt"), mmap=True)
    h0, h1 = ll.ssm_heads(cfg, n, rank)

    def ctx_of(kind):
        return use_rules(mesh, rules_for(kind))

    with ctx_of("prefill") as ctx:
        plan = param_plan(cfg, ctx)
    out = {}

    def part_errs(cache, want, prefix):
        """This rank's SSM state and K/V block against its part of the
        one-rank cache ``want``: the largest error and entry of each, and
        of the state's each layer."""
        w = want["ssm_state"][:, :, h0:h1].to("cuda")
        layer_err = (cache["ssm_state"] - w).abs().flatten(1).amax(1)
        layer_max = w.abs().flatten(1).amax(1)
        row = {prefix + "state_err": float(layer_err.max()),
               prefix + "state_max": float(layer_max.max()),
               prefix + "state_of_max_by_layer":
                   (layer_err / layer_max).tolist()}
        if "k" in cache:
            lo = rank * cache["k"].shape[2]
            err, scale = 0.0, 0.0
            for name in ("k", "v"):
                w = want[name]
                mine = w[:, :, lo:lo + cache[name].shape[2]]
                err = max(err, float((cache[name] - mine.to("cuda"))
                                     .abs().max()))
                scale = max(scale, float(w.abs().max()))
            row.update({prefix + "cache_err": err, prefix + "cache_max": scale})
        return row

    def served(model, i, dtype):
        prompts, tokens = ref["prompts"][i].to("cuda"), \
            ref["tokens"][i].to("cuda")
        logits, cache = ep_logits(
            torch, model, prompts, tokens, ctx_of, kv_dtype=dtype,
            max_len=max_len, with_cache=True)
        row = dict(digest=hashlib.sha256(
            logits.cpu().numpy().tobytes()).hexdigest(),
            kv_shards=cache.kv_shards, ssm_shards=cache.ssm_shards,
            heads=list(cache["ssm_state"].shape[2:3]),
            cache_bytes=sum(t.numel() * t.element_size()
                            for t in cache.values()),
            block=cache["k"].shape[2] if "k" in cache else None)
        if rank == 0:
            row["logits"] = logits.cpu()
        if dtype == torch.float32:
            row.update(part_errs(cache, ref["cache"][i], ""))
            _, cache = ep_logits(
                torch, model, prompts, tokens[:, :1], ctx_of, kv_dtype=dtype,
                max_len=max_len, with_cache=True)
            row.update(part_errs(cache, ref["prefill_cache"][i], "prefill_"))
        return row

    def run(name, dtype, sets, control=None, plain=True):
        saved, real = ll.COMPUTE_DTYPE, ops.combine_partial
        ll.COMPUTE_DTYPE = dtype
        model = None
        try:
            t0 = time.perf_counter()
            model = sharded_serving_model(torch, cfg, plan)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            zero_launches(fa, rn, ss)
            t0 = time.perf_counter()
            with control() if control else contextlib.nullcontext(), \
                    plain_ssd(ops, ss) if plain \
                    else contextlib.nullcontext(), host_clock() as clock:
                rows = [served(model, i, dtype) for i in sets]
                torch.cuda.synchronize()
            out[name] = dict(rows=rows, seconds=time.perf_counter() - t0,
                             build_s=build_s, clock=clock,
                             launches=ssm_launches(fa, rn, ss))
        finally:
            ll.COMPUTE_DTYPE, ops.combine_partial = saved, real
            del model
            torch.cuda.empty_cache()

    with torch.no_grad():
        sets = range(len(SSM_SERVE[key][1]))
        run("fp32", torch.float32, sets)
        run("fp32_kernels", torch.float32, sets, plain=False)
        run("control", torch.float32, [0],
            unweighted if cfg.uses_attention else norm_unsummed)
        run("bf16", torch.bfloat16, sets, plain=False)
    del ref
    return out


def tp_ssm_rank(torch, np, F, modules, workdir) -> dict:
    """One rank of phase 22: for hymba, then mamba2 (``ssm_tp_configs``),
    ``tp_step_rank`` with the gate norm's sums left out and the partial
    SSM leaves left unsummed as the controls, then the serve check
    (``ssm_serve_rank``)."""
    out = {}
    for key, cfg in ssm_tp_configs().items():
        t0 = time.perf_counter()
        out[key] = tp_step_rank(
            torch, np, F, modules, workdir, cfg, tp_batch(torch, np, cfg),
            {"control": norm_unsummed,
             "control_partial": ssm_partial_unsummed},
            ref_name=f"ref_{key}.pt", ssm=True)
        out[key]["step_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[key]["kv"] = ssm_serve_rank(torch, np, F, modules, workdir, key,
                                        cfg)
        out[key]["kv_phase_s"] = time.perf_counter() - t0
        out[key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def ssm_collective_plan(cfg, r) -> dict:
    """The collectives by kind one rank's step of ``cfg`` at remat "none"
    and one microbatch implies over "model": per layer each split region
    (attention, the MLP, the SSM) an all-reduce of its input's gradient
    backward and of its output forward, the SSM's gate norm one forward
    and one backward more; the vocabulary-parallel lookup's sum (a table
    stored split); the cross-entropy's gradient sum, its two sums and one
    max.  In ``dp_shard``: one gather a layer of each unaligned leaf and
    its reduce-scatter, and an all-reduce of each partial leaf and of the
    grad norm (the data axis of 1 issues none)."""
    per_layer = 4 + 4 * cfg.uses_attention
    gathers = sum(r["model_gathers"].values())
    model = {"all_reduce": per_layer * cfg.num_layers + 3
             + int(r["embed_split"]), "all_reduce_max": 1}
    dp = {"all_gather": gathers, "reduce_scatter": gathers,
          "all_reduce": r["partial_leaves"] + 1}
    return dict(model_axis=model,
                dp_shard={k: v for k, v in dp.items() if v})


def ssm_kv_verdict(key, cfg, res, ref) -> dict:
    """Phase 22's serve check for ``key`` against the one-rank reference
    (``ssm_kv_reference``), ``serve_verdict`` with: each rank's SSM state
    (and K/V block) against its part of the one-rank cache, the caches'
    cuts, the fp32 SSD kernel's run recorded.  Returns the launches
    expected a rank."""
    import torch
    import torch.nn.functional as F
    n, L = len(res), cfg.num_layers
    kv = [r["kv"] for r in res]
    max_len, sets = SSM_SERVE[key]

    def worst(run, what, prefix=""):
        return max((row[prefix + what + "_err"] / row[prefix + what + "_max"]
                    for r in kv for row in r[run]["rows"]
                    if prefix + what + "_err" in row), default=0.0)

    state_err, cache_err = (worst("fp32", w, "prefill_")
                            for w in ("state", "cache"))
    by_layer = [max(row["prefill_state_of_max_by_layer"][i]
                    for r in kv for row in r["fp32"]["rows"])
                for i in range(L)]
    decoded_state, decoded_cache = (worst("fp32", w)
                                    for w in ("state", "cache"))
    k32 = torch.cat([F.cosine_similarity(
        r["logits"].float(), w.float(), dim=-1).flatten()
        for r, w in zip(kv[0]["fp32_kernels"]["rows"], ref["logits32"])])
    kernels32 = dict(
        min_cosine=float(k32.min()),
        prefill_state_err_of_max=worst("fp32_kernels", "state", "prefill_"),
        prefill_cache_err_of_max=worst("fp32_kernels", "cache", "prefill_"),
        state_err_of_max=worst("fp32_kernels", "state"),
        cache_err_of_max=worst("fp32_kernels", "cache"),
        note="the fp32 SSD kernel, held to 1e-3 of its plain twin "
             "(TOL_SSD), against the plain-scan reference: recorded")
    slots = max_len + cfg.num_meta_tokens
    cuts_ok = all(row["ssm_shards"] == n and (
        not cfg.uses_attention
        or row["kv_shards"] == n and row["block"] * n == slots)
        for r in kv for row in r["fp32"]["rows"])
    per_set = ssm_expect(cfg, steps=KV_STEPS)
    expect = {k: v * len(sets) for k, v in per_set.items()}
    for k in ("flash_attention_backward", "rmsnorm_backward",
              "ssd_scan_backward"):
        expect[k] = 0
    serve_verdict(
        key, kv, ref, runs=("fp32", "fp32_kernels", "control", "bf16"),
        expect=expect,
        control_what="the partial softmaxes combined without their lse "
                     "weights" if cfg.uses_attention
        else "the gate norm's sums over the ranks left out",
        checks=[
            (by_layer[0] <= SSM_STATE_OF_MAX and state_err <= KV_CACHE_OF_MAX,
             f"a rank's fp32 SSM state after the prefill, by layer, "
             f"{by_layer} of the largest entry of its head slice"),
            (cache_err <= KV_CACHE_OF_MAX, f"a rank's fp32 K/V block after "
             f"the prefill {cache_err} of the largest entry"),
            (max(decoded_state, decoded_cache) <= SSM_DECODED_OF_MAX,
             f"a rank's fp32 SSM state / K/V block after the decode steps "
             f"{decoded_state} / {decoded_cache} of the largest entry"),
            (cuts_ok, f"a rank's cache is not its heads' SSM leaves and its "
             f"block of {slots} slots")],
        arch=cfg.name, layers=L, prompts=[list(p) for p in sets],
        max_len=max_len, slots=slots,
        block=slots // n if cfg.uses_attention else None,
        ssm_heads_per_rank=[r["kv"]["fp32"]["rows"][0]["heads"]
                            for r in res],
        fp32_ssd="plain twin", fp32_kernels=kernels32,
        prefill_state_err_of_max=state_err,
        prefill_state_of_max_by_layer=by_layer,
        decoded_state_of_max_by_layer=[
            max(row["state_of_max_by_layer"][i]
                for r in kv for row in r["fp32"]["rows"])
            for i in range(L)],
        prefill_cache_err_of_max=cache_err if cfg.uses_attention else None,
        decoded_state_err_of_max=decoded_state,
        decoded_cache_err_of_max=decoded_cache if cfg.uses_attention
        else None, decoded_limit=SSM_DECODED_OF_MAX,
        cache_bytes_per_rank=[r["fp32"]["rows"][0]["cache_bytes"]
                              for r in kv],
        state_limit=dict(layer0=SSM_STATE_OF_MAX, every=KV_CACHE_OF_MAX),
        cache_limit=KV_CACHE_OF_MAX)
    return expect


def tp_ssm_path(torch, np, F, modules) -> dict:
    """Phase 22: the families with an SSM under the model axis, over
    SSM_TP_MODEL gloo ranks on the card, one spawn for both models
    (``ssm_tp_configs``, ``tp_families``).  For each, the ranks' step on
    the storage plan held as phase 20's (``tp_family``: loss, grad norm,
    every first moment's cosine or 2x the floor of its kind, whole leaves
    bit-equal across the ranks, bytes held equal to the shards', the
    collectives and gathers the plan implies, exact launches), two
    controls that must fail, and the serve check (``ssm_kv_verdict``).
    Returns the launches of the ranks' step and bf16 serving, summed over
    the ranks, by phase."""
    from repro_torch.models import layers as ll
    cfgs = ssm_tp_configs()
    n = SSM_TP_MODEL
    res, refs, kv_refs = tp_families(
        torch, np, F, modules, "tp_ssm", cfgs, n,
        lambda cfg: tp_batch(torch, np, cfg), ssm_kv_reference, ssm=True)
    launches = {}
    for key, cfg in cfgs.items():
        sub = [r[key] for r in res]
        launches[key] = tp_family(
            key, cfg, sub, refs[key],
            controls={"control": "the gate norm's sums over the ranks left "
                                 "out",
                      "control_partial": "the partial SSM leaves left out "
                                         "of the sum over the ranks"},
            expect=ssm_expect(cfg), plan=ssm_collective_plan,
            residual=[(TP_BATCH, TP_SEQ + cfg.num_meta_tokens, cfg.d_model)],
            sp=(None, None),
            gathers={k: cfg.num_layers
                     for k, rule in ll.leaf_rules(cfg, n).items()
                     if rule == "unaligned"},
            one_expect=ssm_expect(cfg, split=False),
            ssm_heads_per_rank=[r["ssm_heads"] for r in sub],
            step_phase_s_per_rank=[r["step_phase_s"] for r in sub],
            kv_phase_s_per_rank=[r["kv_phase_s"] for r in sub],
            batch=[TP_BATCH, TP_SEQ])
        serve = ssm_kv_verdict(key, cfg, sub, kv_refs[key])
        launches[key + "_serve"] = {k: sum(r["kv"]["bf16"]["launches"][k]
                                           for r in sub) for k in serve}
    return launches


def ve_tp_configs() -> dict:
    """{phase: config} of phase 23: phi-3-vision-4.2b at its published
    widths and VE_VLM_LAYERS layers, whisper-large-v3 at its published
    widths with VE_ENC_LAYERS encoder and VE_DEC_LAYERS decoder layers."""
    import dataclasses

    from repro_torch.configs import get_config
    return {"tp_vlm": dataclasses.replace(get_config(VLM_ARCH),
                                          num_layers=VE_VLM_LAYERS),
            "tp_encdec": dataclasses.replace(
                get_config(ENCDEC_ARCH), encoder_layers=VE_ENC_LAYERS,
                num_layers=VE_DEC_LAYERS)}


def ve_extra(torch, np, cfg, rows: int, seed: int) -> dict:
    """The stub frontend's input for ``rows`` rows, seeded, fp32 on the
    card: a vlm's ``patch_embeds`` (rows, 576, 1,024) or whisper's
    ``frames`` (rows, 1,500, 1,280)."""
    rng = np.random.default_rng(seed)
    if cfg.num_patches:
        key, shape = "patch_embeds", (rows, cfg.num_patches,
                                      cfg.patch_embed_dim)
    else:
        key, shape = "frames", (rows, cfg.max_source_positions, cfg.d_model)
    return {key: torch.as_tensor(rng.standard_normal(shape, np.float32),
                                 device="cuda")}


def ve_batch(torch, np, cfg) -> dict:
    """Phase 23's step batch: TP_BATCH rows of TP_SEQ text behind the
    patches (vlm) or of VE_SEQ tokens with the frames (whisper)."""
    seq = VE_SEQ if cfg.encoder_layers else TP_SEQ
    return dict(tp_batch(torch, np, cfg, TP_BATCH, seq),
                **ve_extra(torch, np, cfg, TP_BATCH, 24))


def ve_attention_calls(cfg) -> int:
    """Attention calls a forward of ``cfg`` makes: one a vlm layer;
    whisper's encoder layers one each, its decoder layers two (self and
    cross)."""
    return cfg.encoder_layers + 2 * cfg.num_layers if cfg.encoder_layers \
        else cfg.num_layers


def ve_expect(cfg, steps: int = 0) -> dict:
    """A rank's launches of one step of ``cfg`` at remat "none" (one
    flash forward and backward an attention call; the vlm's rmsnorm:
    ln1 and ln2 a layer and the final norm; whisper's layernorms are
    plain PyTorch), or with ``steps`` of a bf16 serve of one prompt set:
    flash at the prefill, and for whisper at each of the steps - 1 decode
    steps once a decoder layer, its cross-attention over this rank's block
    of the cross K/V cache (``flash_attention_partial``; decode over the
    self K/V blocks is ragged and takes the plain partial softmax); the
    norms at the prefill and at each step."""
    norms = 0 if cfg.encoder_layers else 2 * cfg.num_layers + 1
    flash = ve_attention_calls(cfg)
    if steps and cfg.encoder_layers:
        flash += cfg.num_layers * (steps - 1)
    return {"flash_attention": flash,
            "flash_attention_backward": 0 if steps else flash,
            "rmsnorm": norms * max(steps, 1),
            "rmsnorm_backward": 0 if steps else norms}


def ve_collective_plan(cfg, r) -> dict:
    """The collectives by kind one rank's step of ``cfg`` at remat "none"
    and one microbatch implies over "model".  The vlm, its residual whole:
    per layer two split regions (attention, the MLP), each an all-reduce
    of its input's gradient backward and of its output forward; the
    vocabulary-parallel lookup's sum (a table stored split); the
    cross-entropy's gradient sum, its two sums and one max.  Whisper, both
    stacks sequence-parallel: per region (an encoder layer's attention and
    MLP, a decoder layer's self-attention, cross-attention and MLP) an
    all-gather of the sequence in and a reduce-scatter out forward and
    their transposes backward; the encoder's output gathered whole once
    for the cross-attention, and the transpose; the lookup's
    reduce-scatter into the block (a table stored split) and its
    transpose; the cross-entropy's gather and transpose, its two sums and
    one max.  In ``dp_shard``: one gather a use of each unaligned leaf and
    its reduce-scatter, and an all-reduce of each partial leaf (whisper's
    layernorms' scales and biases and its MLPs' output biases on a token
    block) and of the grad norm (the data axis of 1 issues none)."""
    gathers = sum(r["model_gathers"].values())
    embed = int(r["embed_split"])
    if cfg.encoder_layers:
        regions = 2 * cfg.encoder_layers + 3 * cfg.num_layers
        model = {"all_gather": 2 * regions + 3,
                 "reduce_scatter": 2 * regions + 2 + embed,
                 "all_reduce": 2, "all_reduce_max": 1}
    else:
        model = {"all_reduce": 4 * cfg.num_layers + 3 + embed,
                 "all_reduce_max": 1}
    dp = {"all_gather": gathers, "reduce_scatter": gathers,
          "all_reduce": r["partial_leaves"] + 1}
    return dict(model_axis=model,
                dp_shard={k: v for k, v in dp.items() if v})


def ve_exact_zero(cfg):
    """Whisper's key biases (self- and cross-attention, both stacks):
    their gradient is 0 in exact arithmetic (``tp_verdict``)."""
    if not cfg.encoder_layers:
        return None
    return lambda k: k.endswith((".attn.bk", ".cross.bk"))


def cross_unsummed():
    """Cross-attention's per-rank outputs left unsummed: every call of
    ``_attention_split`` with ``kv_x`` without its sum over the model
    ranks (under sequence parallelism, its reduce-scatter a slice)."""
    from repro_torch.models import layers as ll
    return unsummed(ll, "_attention_split",
                    when=lambda kw: kw.get("kv_x") is not None)


def ve_kv_reference(torch, np, F, modules, workdir, key, cfg) -> dict:
    """Phase 23's serve reference for ``key``, in the parent before the
    ranks: ``cfg`` on one rank from seed 0, its VE_SERVE prompt set with
    seeded patches or frames served greedily in fp32 (an fp32 K/V cache)
    and teacher-forced with those tokens in bf16.  The prompts, the
    extra inputs, the tokens and the fp32 caches after the prefill and
    after the decode steps go to ``WORKDIR/kv_<key>.pt`` for the ranks;
    the logits are returned."""
    max_len, shape = VE_SERVE[key]
    rng = np.random.default_rng(25)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                              dtype=torch.long, device="cuda")
    extra = ve_extra(torch, np, cfg, shape[0], 26)
    leaves = ("k", "v", "cross_k", "cross_v")
    with torch.no_grad():
        with fp32_model(torch, cfg) as m32:
            logits32, tokens, cache = greedy_logits(
                torch, m32, prompts, KV_STEPS, max_len, torch.float32, extra)
            decoded = {k: cache[k].cpu() for k in leaves if k in cache}
            _, cache = ep_logits(torch, m32, prompts, tokens[:, :1],
                                 kv_dtype=torch.float32, max_len=max_len,
                                 with_cache=True, extra=extra)
            prefilled = {k: cache[k].cpu() for k in leaves if k in cache}
            del cache, m32
        model = seeded_model(torch, cfg)
        logits16 = ep_logits(torch, model, prompts, tokens, max_len=max_len,
                             extra=extra).cpu()
        del model
    torch.save(dict(prompts=prompts.cpu(), tokens=tokens.cpu(),
                    extra={k: v.cpu() for k, v in extra.items()},
                    cache=decoded, prefill_cache=prefilled),
               os.path.join(workdir, f"kv_{key}.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    return dict(logits32=[logits32.cpu()], logits16=[logits16],
                tokens=[tokens.cpu()])


def ve_serve_rank(torch, np, F, modules, workdir, key, cfg) -> dict:
    """Phase 23's serve check in one of its ranks, after the step:
    ``cfg`` under SERVE_RULES on (data 1, model n), its weights this
    rank's shards of the storage plan drawn from seed 0, the prompt set
    (``kv_<key>.pt``) prefilled with its patches or frames and decoded
    through ``_serve_wrap``, teacher-forced with the one-rank greedy
    tokens, over a cache whose K/V (and whisper's cross K/V) hold this
    rank's block: in fp32 over fp32 K/V, each block after the prefill (a
    prefill alone) and after the decode steps against its part of the
    one-rank cache; then in fp32 under the control (the cross cache's
    partial softmaxes, for the vlm its self K/V's, combined with equal
    weights); then bf16 with its launches.  Rank 0 returns the logits,
    every rank their digest."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.distributed.sharding_rules import rules_for, use_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as ll
    from repro_torch.train.train_step import param_plan
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_local_mesh(model_axis=n, device="cuda")
    max_len = VE_SERVE[key][0]
    ref = torch.load(os.path.join(workdir, f"kv_{key}.pt"), mmap=True)
    prompts, tokens = ref["prompts"].to("cuda"), ref["tokens"].to("cuda")
    extra = {k: v.to("cuda") for k, v in ref["extra"].items()}

    def ctx_of(kind):
        return use_rules(mesh, rules_for(kind))

    with ctx_of("prefill") as ctx:
        plan = param_plan(cfg, ctx)
    out = {}

    def block_errs(cache, want, prefix):
        """This rank's K/V blocks (self, and whisper's cross) against its
        slots of the one-rank cache: the largest error and entry."""
        row = {}
        for kind, names in (("self", ("k", "v")),
                            ("cross", ("cross_k", "cross_v"))):
            if names[0] not in cache:
                continue
            err, scale = 0.0, 0.0
            for name in names:
                blk = cache[name].shape[2]
                mine = want[name][:, :, rank * blk:(rank + 1) * blk]
                err = max(err, float((cache[name] - mine.to("cuda"))
                                     .abs().max()))
                scale = max(scale, float(want[name].abs().max()))
            row[f"{prefix}{kind}_err_of_max"] = err / scale
        return row

    def served(model, dtype):
        logits, cache = ep_logits(
            torch, model, prompts, tokens, ctx_of, kv_dtype=dtype,
            max_len=max_len, with_cache=True, extra=extra)
        row = dict(digest=hashlib.sha256(
            logits.cpu().numpy().tobytes()).hexdigest(),
            kv_shards=cache.kv_shards, cross_shards=cache.cross_shards,
            block=cache["k"].shape[2],
            cross_block=cache["cross_k"].shape[2] if "cross_k" in cache
            else None,
            cache_bytes=sum(t.numel() * t.element_size()
                            for t in cache.values()))
        if rank == 0:
            row["logits"] = logits.cpu()
        if dtype == torch.float32:
            row.update(block_errs(cache, ref["cache"], ""))
            _, cache = ep_logits(
                torch, model, prompts, tokens[:, :1], ctx_of,
                kv_dtype=dtype, max_len=max_len, with_cache=True,
                extra=extra)
            row.update(block_errs(cache, ref["prefill_cache"], "prefill_"))
        return row

    def run(name, dtype, control=None):
        saved = ll.COMPUTE_DTYPE
        ll.COMPUTE_DTYPE = dtype
        model = None
        try:
            t0 = time.perf_counter()
            model = sharded_serving_model(torch, cfg, plan)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            zero_launches(fa, rn, ss)
            t0 = time.perf_counter()
            with control() if control else contextlib.nullcontext(), \
                    host_clock() as clock:
                row = served(model, dtype)
                torch.cuda.synchronize()
            out[name] = dict(rows=[row], seconds=time.perf_counter() - t0,
                             build_s=build_s, clock=clock,
                             launches=dense_launches(fa, rn))
        finally:
            ll.COMPUTE_DTYPE = saved
            del model
            torch.cuda.empty_cache()

    with torch.no_grad():
        run("fp32", torch.float32)
        run("control", torch.float32,
            lambda: unweighted(cross=bool(cfg.encoder_layers)))
        run("bf16", torch.bfloat16)
    del ref
    return out


def tp_vlm_encdec_rank(torch, np, F, modules, workdir) -> dict:
    """One rank of phase 23: for phi-3-vision, then whisper
    (``ve_tp_configs``), ``tp_step_rank`` with its control (the vlm: the
    vocabulary-parallel lookup without its sum, before the patches are
    prepended; whisper: cross-attention's per-rank outputs left
    unsummed), then the serve check (``ve_serve_rank``)."""
    out = {}
    for key, cfg in ve_tp_configs().items():
        t0 = time.perf_counter()
        out[key] = tp_step_rank(
            torch, np, F, modules, workdir, cfg, ve_batch(torch, np, cfg),
            {"control": cross_unsummed if cfg.encoder_layers
             else lookup_unsummed}, ref_name=f"ref_{key}.pt")
        out[key]["step_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[key]["kv"] = ve_serve_rank(torch, np, F, modules, workdir, key,
                                       cfg)
        out[key]["kv_phase_s"] = time.perf_counter() - t0
        out[key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def ve_kv_verdict(key, cfg, res, ref) -> dict:
    """Phase 23's serve check for ``key`` against the one-rank reference
    (``ve_kv_reference``), ``serve_verdict`` with: each rank's K/V blocks
    (and whisper's cross blocks) against its part of the one-rank cache,
    the caches' cuts; whisper's fp32 logits and its control to
    VE_CROSS_MIN_COSINE.  Returns the launches expected a rank."""
    n = len(res)
    kv = [r["kv"] for r in res]
    max_len, shape = VE_SERVE[key]
    rows = [r["fp32"]["rows"][0] for r in kv]
    errs = {k: max(row[k] for row in rows)
            for k in rows[0] if k.endswith("_err_of_max")}
    slots = max_len + cfg.num_patches
    cuts_ok = all(row["kv_shards"] == n and row["block"] * n == slots
                  and (not cfg.encoder_layers or row["cross_shards"] == n
                       and row["cross_block"] * n
                       == cfg.max_source_positions) for row in rows)
    expect = ve_expect(cfg, steps=KV_STEPS)
    serve_verdict(
        key, kv, ref, runs=("fp32", "control", "bf16"), expect=expect,
        control_what="the cross K/V blocks' partial softmaxes combined "
                     "without their lse weights" if cfg.encoder_layers
        else "the K/V blocks' partial softmaxes combined without their lse "
             "weights",
        limit=VE_CROSS_MIN_COSINE if cfg.encoder_layers else KV_MIN_COSINE,
        checks=[(max(errs.values()) <= KV_CACHE_OF_MAX, f"a rank's fp32 K/V "
                 f"blocks against the one-rank cache {errs}"),
                (cuts_ok, f"a rank's cache is not its block of {slots} "
                 f"slots (and of the encoder positions)")],
        arch=cfg.name, layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers, prompts=list(shape),
        max_len=max_len, slots=slots, block=slots // n,
        cross_block=cfg.max_source_positions // n if cfg.encoder_layers
        else None, block_err_of_max=errs,
        cache_bytes_per_rank=[row["cache_bytes"] for row in rows],
        cache_limit=KV_CACHE_OF_MAX)
    return expect


def tp_vlm_encdec_path(torch, np, F, modules) -> dict:
    """Phase 23: the vlm and encdec families under the model axis, over
    VE_TP_MODEL gloo ranks on the card, one spawn for both models
    (``ve_tp_configs``, ``tp_families``).  For each, the ranks' step on
    the storage plan held as phase 20's (``tp_family``, the collectives
    of ``ve_collective_plan``, no gather over "model"), a control that
    must fail, and the serve check (``ve_kv_verdict``).  Returns the
    launches of the ranks' step and bf16 serving, summed over the ranks,
    by phase."""
    from repro_torch.models import layers as ll
    cfgs = ve_tp_configs()
    n = VE_TP_MODEL
    res, refs, kv_refs = tp_families(
        torch, np, F, modules, "tp_vlm_encdec", cfgs, n,
        lambda cfg: ve_batch(torch, np, cfg), ve_kv_reference)
    launches = {}
    for key, cfg in cfgs.items():
        sub = [r[key] for r in res]
        rules = ll.leaf_rules(cfg, n)
        check("unaligned" not in rules.values(), f"{key}: leaves "
              f"unaligned at model {n}: {rules}")
        if cfg.encoder_layers:
            residual = sorted({(TP_BATCH, cfg.max_source_positions // n,
                                cfg.d_model), (TP_BATCH, VE_SEQ // n,
                                               cfg.d_model)})
            sp, control = (n, n), "cross-attention's per-rank outputs " \
                                  "left unsummed"
        else:
            residual = [(TP_BATCH, cfg.num_patches + TP_SEQ, cfg.d_model)]
            sp, control = (None, None), "the vocabulary-parallel lookup " \
                                        "without its sum"
        expect = ve_expect(cfg)
        launches[key] = tp_family(
            key, cfg, sub, refs[key], controls={"control": control},
            expect=expect, plan=ve_collective_plan, residual=residual, sp=sp,
            gathers={}, exact_zero=ve_exact_zero(cfg), one_expect=expect,
            encoder_layers=cfg.encoder_layers,
            vocab_rows=-(-cfg.vocab_size // n),
            step_phase_s_per_rank=[r["step_phase_s"] for r in sub],
            kv_phase_s_per_rank=[r["kv_phase_s"] for r in sub],
            batch=[TP_BATCH, VE_SEQ if cfg.encoder_layers else TP_SEQ])
        serve = ve_kv_verdict(key, cfg, sub, kv_refs[key])
        launches[key + "_serve"] = {k: sum(r["kv"]["bf16"]["launches"][k]
                                           for r in sub) for k in serve}
    return launches


def launch_counts(modules) -> dict:
    """Every kernel launch counter, by kernel."""
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_backward": fa.flash_attention.backward_launches,
            "rmsnorm": rn.rmsnorm.launches,
            "rmsnorm_residual": rn.rmsnorm_residual.launches,
            "row_sumsq": rn.row_sumsq.launches,
            "rmsnorm_total": rn.rmsnorm_total.launches,
            "ssd_scan": ss.ssd_scan.launches,
            "rmsnorm_backward": rn.rmsnorm.backward_launches,
            "ssd_scan_backward": ss.ssd_scan.backward_launches}


def set_launch_counts(modules, counts: dict) -> None:
    fa, rn, ss = (modules[k] for k in ("fa", "rn", "ss"))
    fa.flash_attention.launches = counts["flash_attention"]
    fa.flash_attention.backward_launches = counts["flash_attention_backward"]
    rn.rmsnorm.launches = counts["rmsnorm"]
    rn.rmsnorm_residual.launches = counts["rmsnorm_residual"]
    rn.row_sumsq.launches = counts["row_sumsq"]
    rn.rmsnorm_total.launches = counts["rmsnorm_total"]
    ss.ssd_scan.launches = counts["ssd_scan"]
    rn.rmsnorm.backward_launches = counts["rmsnorm_backward"]
    ss.ssd_scan.backward_launches = counts["ssd_scan_backward"]


def card_count(torch, modules, counted: dict, key: str, fn, names: dict,
               **record) -> None:
    """Phase 24's count of one step on the card, made inside the phase
    that built and warmed its model: ``fn()`` under a
    ``roofline.counter.Counter`` (``names``: the parameters that name an
    op's scope), the bytes live before it, the card's peak over it
    (``max_memory_allocated`` after a reset) and the kernels it launched.
    Those launches are taken back out of the launch counters, so the
    paths' counts stay the paths' own; the kernels line lists them under
    ``dryrun``.  Stored in ``counted[key]`` with ``record`` (what phase 24
    needs to trace the same step on meta)."""
    from repro_torch.roofline.counter import Counter
    before = launch_counts(modules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with Counter(names) as c:
        fn()
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated()
    after = launch_counts(modules)
    set_launch_counts(modules, before)
    counted[key] = dict(counter=c, base=base, measured_peak=measured,
                       count_s=count_s,
                       launches={k: after[k] - before[k] for k in after},
                       **record)


def specs_of(batch: dict) -> dict:
    """A batch's {name: (shape, dtype)}, for the same batch on meta."""
    return {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}


def dense_matmul_flops(cfg, tokens: int) -> float:
    """The dense train step's matrix-product FLOPs from its config alone:
    2 x tokens x (each layer's q, k, v, o and SwiGLU weights, and the
    logits' d x V) forward, and twice that backward (remat "none": no
    recompute)."""
    d, L = cfg.d_model, cfg.num_layers
    attn = d * cfg.num_heads * cfg.head_dim * 2 \
        + 2 * d * cfg.num_kv_heads * cfg.head_dim
    return 6.0 * tokens * (L * (attn + 3 * d * cfg.d_ff)
                           + d * cfg.vocab_size)


def dryrun_path(torch, np, modules, counted: dict) -> dict:
    """Phase 24: the dry-run's count held against the card.  Each step
    counted in phases 4, 7 and 18 (``card_count`` into ``counted``) is
    traced again on
    meta with the dry-run's machinery (``launch/dryrun.py``: the same
    config, step config and batch shapes, the kernels' shape functions):
    total FLOPs, total traffic and each kernel's FLOPs, bytes and regions
    must be equal, and each kernel's regions on the card its launches.
    The dense step's FLOPs outside kernel regions must equal
    ``dense_matmul_flops``.  The train steps' counted peak (bytes live at
    the start plus the counter's peak) must be within DRYRUN_PEAK_REL of
    ``max_memory_allocated``.  Each row prints the roofline terms from the
    H100 constants (``roofline/analysis.py``) beside the measured median
    step, ``roofline_fraction_measured`` = step_s / measured and ``mfu`` =
    model FLOPs / (measured x 989e12), with the card's name and power
    limit (no limit is set on these).  Then one production cell,
    ``DRYRUN_CELL``, traced on meta under a fake group of 256 ranks.
    Returns the counted steps' launches by step."""
    import statistics

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as dr
    from repro_torch.roofline.analysis import PEAK_FLOPS, build_report
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    launches = {}
    for key, rec in counted.items():
        card, cfg = rec["counter"], rec["cfg"]
        B, S = rec["rows"], rec["seq"]
        t0 = time.perf_counter()
        if rec["kind"] == "train":
            meta, held, _ = dr.count_train(cfg, rec["scfg"], B, S,
                                           specs=rec["specs"])
        else:
            meta, held, _ = dr.count_serve(cfg, "prefill", B, S,
                                           specs=rec["specs"],
                                           cache_len=rec["cache_len"])
        trace_s = time.perf_counter() - t0
        cs, ms = card.summary(), meta.summary()
        regions = {k: v["regions"] for k, v in cs["kernels"].items()}
        launched = {k: v for k, v in rec["launches"].items() if v}
        # the card's kernel regions against its launch counters: the
        # partial forward is a launch of the forward kernel; each backward
        # region (flash, the SSD scan, rmsnorm) one launch of its kernels
        by_launch = dict(regions)
        by_launch["flash_attention"] = by_launch.get(
            "flash_attention", 0) + by_launch.pop(
            "flash_attention_partial", 0)
        by_launch = {k: v for k, v in by_launch.items() if v}
        launches[key] = launched
        shape = ShapeConfig(key, S, B, rec["kind"])
        report = build_report(arch=cfg.name, shape=shape, mesh_name="card",
                              chips=1, counter=card, cfg=cfg)
        measured_s = statistics.median(rec["step_s"])
        counted_peak = rec["base"] + card.peak
        peak_rel = abs(counted_peak - rec["measured_peak"]) \
            / rec["measured_peak"]
        row = dict(
            step=key, arch=cfg.name, layers=cfg.num_layers, kind=rec["kind"],
            batch=[B, S], equal_flops=cs["flops"] == ms["flops"],
            equal_traffic=cs["traffic"] == ms["traffic"],
            equal_kernels=cs["kernels"] == ms["kernels"],
            flops=cs["flops"], traffic=cs["traffic"],
            meta_flops=ms["flops"], meta_traffic=ms["traffic"],
            kernels=cs["kernels"], launches=launched,
            regions_equal_launches=by_launch == launched,
            **card.kernel_totals(),
            counted_peak_bytes=counted_peak,
            measured_peak_bytes=rec["measured_peak"], peak_rel=peak_rel,
            meta_peak_bytes=sum(held.values()) + meta.peak,
            counter_peak_bytes=card.peak, meta_counter_peak_bytes=meta.peak,
            compute_s=report.compute_s, memory_s=report.memory_s,
            step_s=report.step_s, dominant=report.dominant,
            measured_step_s=measured_s,
            roofline_fraction_measured=report.step_s / measured_s,
            mfu=report.model_flops / (measured_s * PEAK_FLOPS["bfloat16"]),
            model_flops=report.model_flops,
            useful_flops_ratio=report.useful_flops_ratio,
            count_s=rec["count_s"], meta_trace_s=trace_s, nvidia_smi=smi)
        if key == "train_dense":
            row["analytic_matmul_flops"] = dense_matmul_flops(cfg, B * S)
        if not (row["equal_flops"] and row["equal_traffic"]):
            # where the two counts part: the (caller, op) rows that differ
            diff = sorted((k for k in set(card.ops) | set(meta.ops)
                           if card.ops.get(k) != meta.ops.get(k)),
                          key=lambda k: -abs(
                              card.ops.get(k, [0, 0, 0])[2]
                              - meta.ops.get(k, [0, 0, 0])[2]))
            row["differing_ops"] = [
                dict(path=k[0], op=k[1], card=card.ops.get(k),
                     meta=meta.ops.get(k)) for k in diff[:20]]
        emit("dryrun", **row)
        check(row["equal_flops"] and row["equal_traffic"]
              and row["equal_kernels"],
              f"dryrun {key}: the card counted {cs['flops']} FLOPs, "
              f"{cs['traffic']} bytes, kernels {cs['kernels']}; meta "
              f"{ms['flops']}, {ms['traffic']}, {ms['kernels']}")
        check(row["regions_equal_launches"],
              f"dryrun {key}: kernel regions {by_launch}, launches "
              f"{launched}")
        if key == "train_dense":
            check(row["other_flops"] == row["analytic_matmul_flops"],
                  f"dryrun {key}: {row['other_flops']} FLOPs outside the "
                  f"kernels, the config implies "
                  f"{row['analytic_matmul_flops']}")
        if rec["kind"] == "train":
            check(peak_rel <= DRYRUN_PEAK_REL,
                  f"dryrun {key}: counted peak {counted_peak} against "
                  f"{rec['measured_peak']} measured ({peak_rel:.3f})")
    check(set(counted) == {"serve", "train", "train_dense"},
          f"dryrun: counted steps {sorted(counted)}")
    # one production cell, rank 0 of 256 on meta under a fake group
    t0 = time.perf_counter()
    out = dr.trace_cell(*DRYRUN_CELL)
    cell_s = time.perf_counter() - t0
    emit("dryrun_cell", cell="/".join(DRYRUN_CELL), ok=out["ok"],
         chips=out["chips"], path=out["path"], trace_s=cell_s,
         peak_per_device=out["memory"]["peak_per_device"],
         fits_hbm_80g=out["fits_hbm_80g"],
         dominant=out["roofline"]["dominant"],
         compute_s=out["roofline"]["compute_s"],
         memory_s=out["roofline"]["memory_s"],
         collective_s=out["roofline"]["collective_s"],
         collective_counts=out["roofline"]["collective_counts"],
         useful_flops_ratio=out["roofline"]["useful_flops_ratio"],
         torch=torch.__version__)
    check(out["ok"], f"dryrun cell {DRYRUN_CELL} failed")
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

    global costs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline import costs
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
    cuda_sources = ("flash_attention", "ssd_scan", "ssd_scan_bwd")
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
    # the SSD backward's band kernel holds its accumulators in registers:
    # ptxas must spill none of them
    band = {k: v for k, v in ptxas["ssd_scan_bwd"].items()
            if k.startswith("ssd_bwd_chunk_wgmma_kernel")}
    check(len(band) == 4 and all(
        re.search(r"\b0 bytes spill stores, 0 bytes spill loads", v)
        for v in band.values()), f"ssd_bwd_chunk_wgmma_kernel spills: {band}")
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
    # the model axis's per-rank shapes (phases 20-21): qwen2 at model 4
    # holds 4 / 1 heads of 64, granite at model 2 12 / 4
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "tp_rank",
                                             TP_BATCH, TP_SEQ, TP_SEQ, 4, 1,
                                             64)
    checks["flash_attention"] += check_flash(torch, F, fa, gen, "ep_rank",
                                             EP_BATCH // EP_DATA, EP_PROMPT,
                                             EP_PROMPT, 12, 4, 64)
    # phase 20b's: qwen3 at model 4 holds 4 / 2 heads of 128
    checks["flash_attention"] += check_flash(torch, F, fa, gen,
                                             "tp_big_rank", BIG_BATCH,
                                             BIG_SEQ, BIG_SEQ, 4, 2, 128)
    # phase 22's: hymba's global layer at model 2, 15 padded heads a rank
    # over its 3 kv heads expanded to one a slot (groups of one), over the
    # 128 meta tokens and 512 text tokens
    checks["flash_attention"] += check_flash(
        torch, F, fa, gen, "tp_hybrid_rank", TP_BATCH, TP_SEQ + 128,
        TP_SEQ + 128, 15, 15, 64)
    # phase 23's, as BWD_CASES' tp_vlm_rank and tp_whisper_*_rank
    for name, (shape, kw) in BWD_CASES.items():
        if name.startswith(("tp_vlm", "tp_whisper")):
            checks["flash_attention"] += check_flash(torch, F, fa, gen, name,
                                                     *shape, **kw)
    # phase 23's decode over whisper's cross K/V cache cut on kv_seq: a
    # rank's query row of 10 heads over its block of 750 encoder positions,
    # out and lse for the combine
    checks["flash_attention"] += check_flash_partial(
        torch, fa, ref, gen, "tp_whisper_cross_decode_rank", TP_BATCH, 1,
        1500 // VE_TP_MODEL, 10, 10, 64)
    # the dense training shape through the forward _FlashAttention runs
    checks["flash_attention"] += check_flash_train(
        torch, fa, gen, "train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64)
    checks["flash_attention_backward"] = []
    for name, (shape, kw) in BWD_CASES.items():
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
    # the model axis's sequence blocks (phases 20-20b): ln1 / ln2 / the
    # final norm on a rank's 2 x 512 / 4 tokens of qwen2 and qwen3
    for name, d in (("tp_seq_d896", 896), ("tp_big_seq_d2048", 2048)):
        checks["rmsnorm"] += check_rmsnorm(
            torch, F, rn, gen, name, TP_BATCH * TP_SEQ // TP_MODEL, d)
    # phase 23's: phi-3-vision's ln1 / ln2 / final norm on a rank's whole
    # residual of 2 x (576 + 512) tokens
    checks["rmsnorm"] += check_rmsnorm(torch, F, rn, gen, "tp_vlm_d3072",
                                       TP_BATCH * (576 + TP_SEQ), 3072)
    checks["rmsnorm_residual"] += check_rmsnorm_residual(
        torch, rn, gen, "slice", TRAIN_BATCH * TRAIN_SEQ, 1536)
    # phase 22's gate norm over a row split across 2 model ranks: hymba's
    # 1,600 of 3,200 and mamba2's 1,536 of 3,072, at 1,024 rows (a rank's
    # 2 x 512 tokens)
    checks["row_sumsq"], checks["rmsnorm_total"] = [], []
    for name, d_full in (("tp_hybrid", 3200), ("tp_ssm", 3072)):
        sums, totals = check_rmsnorm_split(torch, F, rn, ref, gen, name,
                                           TP_BATCH * TP_SEQ, d_full,
                                           SSM_TP_MODEL)
        checks["row_sumsq"] += sums
        checks["rmsnorm_total"] += totals

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
            # the wgmma kernels at p 32 (x's columns past p read as zeros),
            # two groups and n 64
            ("p32_groups", (2, 512, 8, 32, 2, 64, 256), dict(strided=True)),
            # rows that are not whole 16-byte chunks (p = 12, n = 10): the
            # mma kernels' element-by-element loads and stores
            ("unaligned", (1, 64, 3, 12, 1, 10, 32), {})):
        checks["ssd_scan"] += check_ssd(torch, ops, ss, plain_ctx, gen, name,
                                        *shape, **kw)
    # prefill's scan with its final state: the serving batch of 8 x 512 and
    # the 4 prompts of 300 that ops.ssd_prefill pads to 512, as strided
    # views of one conv output like the model's
    # and hymba's prefill: 8 x (128 + 512) positions, padded to 768, 50
    # heads of 64 and state n = 16, which the wgmma kernels take at its own
    # width
    for name, shape in (("serve_prefill", (8, 512, 48, 64, 1, 128, 256)),
                        ("serve_prefill300", (4, 300, 48, 64, 1, 128, 256)),
                        ("hymba_prefill", (8, 640, 50, 64, 1, 16, 256))):
        checks["ssd_scan"] += check_ssd_state(torch, ops, ss, plain_ctx, gen,
                                              name, *shape)
    # phase 22's per-rank scans at model 2: hymba's 25 of 50 heads (n 16)
    # over its 2 x (128 + 512) positions, padded to 768, and mamba2's 24 of
    # 48 (n 128) over 2 x 512, each as strided views of one conv output
    for name, shape in (("tp_hybrid_rank", (TP_BATCH, TP_SEQ + 128, 25, 64,
                                            1, 16, 256)),
                        ("tp_ssm_rank", (TP_BATCH, TP_SEQ, 24, 64, 1, 128,
                                         256))):
        checks["ssd_scan"] += check_ssd(torch, ops, ss, plain_ctx, gen, name,
                                        *shape, strided=True)
    # the model-shape rows on the wgmma kernels, the test shapes on mma
    served = {r["case"]: r["variant"] for r in checks["ssd_scan"]
              if r["dtype"] == "bfloat16"}
    check(all(v == ("mma" if k in SSD_MMA_ROWS else "wgmma")
              for k, v in served.items())
          and all(r["variant"] == "scalar" for r in checks["ssd_scan"]
                  if r["dtype"] == "float32"),
          f"SSD variants {served}")
    # each kernel alone: the wgmma kernels at the slice shape and hymba's
    # prefill (n = 16), the mma kernels at t4_chunk24
    stage_rows = []
    for name, shape, kw in (
            ("slice", (TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128, 256),
             dict(strided=True)),
            ("hymba_prefill", (8, 640, 50, 64, 1, 16, 256),
             dict(strided=True)),
            ("t4_chunk24", (1, 96, 6, 8, 2, 16, 24), {})):
        stage_rows += check_ssd_stages(torch, ops, ss, ref, gen, name,
                                       *shape, **kw)
    check([r["variant"] for r in stage_rows] ==
          ["wgmma"] * 4 + ["mma"] * 3,
          f"SSD stage kernels {[r['variant'] for r in stage_rows]}")
    # the backward kernels of the SSD scan and of rmsnorm, each against
    # its plain twin and the fp32 reference
    checks["ssd_scan_backward"] = []
    for name, (shape, strided, dtype) in SSD_BWD_CASES.items():
        checks["ssd_scan_backward"] += check_ssd_backward(
            torch, ss, ref, gen, name, *shape, strided=strided, dtype=dtype)
    checks["rmsnorm_backward"] = []
    for name, (rows_, d) in RMSNORM_BWD_CASES.items():
        checks["rmsnorm_backward"] += check_rmsnorm_backward(
            torch, F, rn, gen, name, rows_, d)

    # from here on a plain backward twin on CUDA tensors is an error
    refuse_plain = contextlib.ExitStack()
    refuse_plain.enter_context(plain_backward_refused(modules, ref))

    # ---- 4-6c. the serving paths at full width -----------------------------
    # the SSD scan's launches by variant from here on: the main paths'
    # phases, their warm-ups, profile windows and checks
    ssd_by_variant0 = dict(ss.ssd_scan.launches_by_variant)
    counted = {}                   # phase 24's counted steps
    serve_launches = serve_path(torch, np, F, modules, ARCH,
                                counted=counted)
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
                                                         modules, counted)

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
    # the collector frees its state before the next mamba2 state
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
    dense_launches_ = train_dense_path(torch, np, F, modules, counted)
    trainer_dense_launches = trainer_dense_path(torch, np, tdata, modules)
    torch.cuda.empty_cache()

    # ---- 20-21. the model axis: gloo ranks on the card ----------------------
    tp_launches = tp_train_path(torch, np, F, modules)
    torch.cuda.empty_cache()
    tp_big_launches = tp_train_big_path(torch, np, F, modules)
    torch.cuda.empty_cache()
    ep_launches = ep_serve_path(torch, np, F, modules)
    torch.cuda.empty_cache()

    # ---- 22. the families with an SSM under the model axis -----------------
    ssm_tp_launches = tp_ssm_path(torch, np, F, modules)
    torch.cuda.empty_cache()

    # ---- 23. the vlm and encdec families under the model axis -------------
    ve_tp_launches = tp_vlm_encdec_path(torch, np, F, modules)
    torch.cuda.empty_cache()

    # ---- 24. the dry-run's count against the card ---------------------------
    dryrun_launches = dryrun_path(torch, np, modules, counted)

    # ---- 25. the kernels line ---------------------------------------------
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
                                trainer_dense_launches["flash_attention"],
                            "tp_train": tp_launches["flash_attention"],
                            "tp_kv_serve":
                                tp_launches["kv_serve"]["flash_attention"],
                            "tp_train_big":
                                tp_big_launches["flash_attention"],
                            "ep_serve": ep_launches["flash_attention"],
                            **{f"ep_serve_replicated_{k}":
                               v["flash_attention"] for k, v in
                               ep_launches["serve_replicated"].items()},
                            **{k: v["flash_attention"]
                               for k, v in ssm_tp_launches.items()},
                            **{k: v["flash_attention"]
                               for k, v in ve_tp_launches.items()}},
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
                    "trainer_dense": trainer_dense_launches["rmsnorm"],
                    "tp_train": tp_launches["rmsnorm"],
                    "tp_kv_serve": tp_launches["kv_serve"]["rmsnorm"],
                    "tp_train_big": tp_big_launches["rmsnorm"],
                    "ep_serve": ep_launches["rmsnorm"],
                    **{f"ep_serve_replicated_{k}": v["rmsnorm"]
                       for k, v in ep_launches["serve_replicated"].items()},
                    **{k: v["rmsnorm"] for k, v in ssm_tp_launches.items()},
                    **{k: v["rmsnorm"] for k, v in ve_tp_launches.items()}},
        "rmsnorm_residual": {},      # no model calls it
        "ssd_scan": {"serve_ssm": serve_ssm_launches["ssd_scan"],
                     "serve_hybrid": serve_hybrid_launches["ssd_scan"],
                     "hybrid_window": hybrid_window_launches["ssd_scan"],
                     "train": train_launches["ssd_scan"],
                     "train_stream": stream_launches["ssd_scan"],
                     "trainer": trainer_launches["ssd_scan"],
                     "fleet_train": fleet_train_launches["ssd_scan"],
                     "dp_train": dp_train_launches["ssd_scan"],
                     **{k: v["ssd_scan"] for k, v in ssm_tp_launches.items()}},
        "row_sumsq": {k: v["row_sumsq"] for k, v in ssm_tp_launches.items()},
        "rmsnorm_total": {k: v["rmsnorm_total"]
                          for k, v in ssm_tp_launches.items()},
    }
    # phase 24's counted steps, on a path of their own
    for name, paths in by_path.items():
        n = sum(v.get(name, 0) for v in dryrun_launches.values())
        if n:
            paths["dryrun"] = n
    main_case = {"flash_attention": "slice", "rmsnorm": "prefill",
                 "rmsnorm_residual": "slice", "ssd_scan": "slice",
                 "row_sumsq": "tp_hybrid", "rmsnorm_total": "tp_hybrid"}
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
        # the split-row pair: the gate norm's rmsnorm over a row split
        # across the model ranks (repro's src/repro/models/ssm.py:97)
        "row_sumsq": dict(
            route="triton", source="src/repro_torch/kernels/rmsnorm.py",
            replaces="src/repro/kernels/rmsnorm.py:44"),
        "rmsnorm_total": dict(
            route="triton", source="src/repro_torch/kernels/rmsnorm.py",
            replaces="src/repro/kernels/rmsnorm.py:44"),
    }
    backward_rows = checks.pop("flash_attention_backward")
    ssd_bwd_rows = checks.pop("ssd_scan_backward")
    rms_bwd_rows = checks.pop("rmsnorm_backward")
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
    by_name["ssd_scan"]["variant"] = next(
        r["variant"] for r in checks["ssd_scan"]
        if r["case"] == "slice" and r["dtype"] == "bfloat16")
    now = ss.ssd_scan.launches_by_variant
    by_name["ssd_scan"]["launches_by_variant"] = {
        k: now[k] - ssd_by_variant0[k] for k in now}
    by_name["ssd_scan"]["launches_by_variant_script"] = dict(now)
    # each kernel alone, by case: {case: {stage: ms}} with its variant
    by_name["ssd_scan"]["stages_ms"] = {
        case: {"variant": next(r["variant"] for r in stage_rows
                               if r["case"] == case),
               **{r["stage"]: r["kernel_ms"] for r in stage_rows
                  if r["case"] == case}}
        for case in dict.fromkeys(r["case"] for r in stage_rows)}
    state_row = next(r for r in checks["ssd_scan"]
                     if r["case"] == "serve_prefill"
                     and r["dtype"] == "bfloat16")
    by_name["ssd_scan"]["serve_prefill_state_ms"] = state_row["kernel_ms"]
    by_name["ssd_scan"]["serve_prefill_y_only_ms"] = state_row["y_only_ms"]
    # the scan with its final state at hymba's prefill (n = 16), and the
    # fleet phase's 6 x 2048 training shape
    by_name["ssd_scan"]["cases"] = {
        r["case"]: dict(variant=r["variant"], ms=r["kernel_ms"],
                        plain_ms=r["plain_ms"],
                        y_only_ms=r.get("y_only_ms"), bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None)
        for r in checks["ssd_scan"]
        if r["case"] in ("hymba_prefill", "fleet6", "dp_mb", "padded300",
                         "serve_prefill", "serve_prefill300",
                         "tp_hybrid_rank", "tp_ssm_rank", "p32_groups")
        and r["dtype"] == "bfloat16"}
    # flash at phi-3-vision's head dim, at the MoE and prefix paths'
    # prefills and at whisper's shapes
    by_name["flash_attention"]["variant"] = next(
        r["variant"] for r in checks["flash_attention"]
        if r["case"] == "slice" and r["dtype"] == "bfloat16")
    by_name["flash_attention"]["launches_by_variant_script"] = dict(
        fa.flash_attention.launches_by_variant)
    by_name["flash_attention"]["cases"] = {
        r["case"]: dict(variant=r["variant"], ms=r["kernel_ms"],
                        plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"],
                        library_backend=r["library_backend"],
                        **({"host_us": r["host_us"]} if "host_us" in r
                           else {}))
        for r in checks["flash_attention"]
        if r["case"] in ("train", "d96", "granite", "mixtral_window",
                         "hymba_global",
                         "phi3v", "whisper_enc", "whisper_cross",
                         "whisper_cross_decode", "whisper_self", "tp_rank",
                         "ep_rank", "tp_big_rank", "tp_hybrid_rank",
                         "tp_vlm_rank", "tp_whisper_enc_rank",
                         "tp_whisper_cross_rank", "tp_whisper_self_rank",
                         "tp_whisper_cross_decode_rank")
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
                         "fleet_d3072", "dp_mb_d1536", "dp_mb_d3072",
                         "tp_seq_d896", "tp_big_seq_d2048", "tp_vlm_d3072")
        and r["dtype"] == "bfloat16"}
    # the flash backward replaces no TPU kernel: its launches (one a
    # backward call, for its three kernels) and times ride on flash's row
    bwd_by_path = {"train_dense": sum(
        v["flash_attention_backward"] for v in dense_launches_.values()),
        "trainer_dense": trainer_dense_launches["flash_attention_backward"],
        "tp_train": tp_launches["flash_attention_backward"],
        "tp_train_big": tp_big_launches["flash_attention_backward"],
        **{k: v["flash_attention_backward"]
           for k, v in ssm_tp_launches.items()},
        **{k: v["flash_attention_backward"]
           for k, v in ve_tp_launches.items()},
        "dryrun": sum(v.get("flash_attention_backward", 0)
                      for v in dryrun_launches.values())}
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
            r["case"]: dict(variant=r["variant"], cluster=r["cluster"],
                            ms=r["kernel_ms"], preprocess_ms=r["preprocess_ms"],
                            dkdv_ms=r["dkdv_ms"], dq_ms=r["dq_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            library_backend=r["library_backend"])
            for r in backward_rows})
    # the split pair at mamba2's width, and F.rms_norm over the whole row
    # beside each for scale (no single PyTorch call normalises a row split
    # across ranks)
    for name in ("row_sumsq", "rmsnorm_total"):
        main_row = next(r for r in checks[name] if r["case"] == "tp_hybrid"
                        and r["dtype"] == "bfloat16")
        by_name[name]["whole_row_library_ms"] = main_row[
            "whole_row_library_ms"]
        by_name[name]["cases"] = {
            r["case"]: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=None,
                            whole_row_library_ms=r["whole_row_library_ms"])
            for r in checks[name] if r["dtype"] == "bfloat16"}
    # the two backward kernels of the training paths, each a line entry of
    # its own: neither replaces a TPU kernel (repro differentiates its jnp
    # references: the SSD scan's src/repro/kernels/ref.py:172 ssd_chunked,
    # rmsnorm's src/repro/kernels/ref.py rmsnorm)
    train_paths = {"train": train_launches, "train_stream": stream_launches,
                   "trainer": trainer_launches,
                   "fleet_train": fleet_train_launches,
                   "dp_train": dp_train_launches}
    bwd_paths = {
        "ssd_scan_backward": {
            **{k: v["ssd_scan_backward"] for k, v in train_paths.items()},
            **{k: v["ssd_scan_backward"]
               for k, v in ssm_tp_launches.items()}},
        "rmsnorm_backward": {
            **{k: v["rmsnorm_backward"] for k, v in train_paths.items()},
            "train_dense": sum(v["rmsnorm_backward"]
                               for v in dense_launches_.values()),
            "trainer_dense": trainer_dense_launches["rmsnorm_backward"],
            "tp_train": tp_launches["rmsnorm_backward"],
            "tp_train_big": tp_big_launches["rmsnorm_backward"],
            **{k: v["rmsnorm_backward"] for k, v in ssm_tp_launches.items()},
            **{k: v["rmsnorm_backward"] for k, v in ve_tp_launches.items()}}}
    for name, paths in bwd_paths.items():
        n = sum(v.get(name, 0) for v in dryrun_launches.values())
        if n:
            paths["dryrun"] = n
    bwd_meta = {
        "ssd_scan_backward": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            replaces="none: src/repro/kernels/ssd_scan.py:77 has no "
                     "backward (repro differentiates "
                     "src/repro/kernels/ref.py:172 ssd_chunked)"),
        "rmsnorm_backward": dict(
            route="triton", source="src/repro_torch/kernels/rmsnorm.py",
            replaces="none: src/repro/kernels/rmsnorm.py:44 has no "
                     "backward (repro differentiates its jnp reference)")}
    for name, rows_, main in (("ssd_scan_backward", ssd_bwd_rows, "slice"),
                              ("rmsnorm_backward", rms_bwd_rows, "d1536")):
        row = next(r for r in rows_ if r["case"] == main
                   and r["dtype"] == "bfloat16")
        paths = bwd_paths[name]
        check(sum(paths.values()) > 0 and paths["train"] > 0,
              f"{name} did not launch on the main paths: {paths}")
        kernels.append(dict(
            name=name, **bwd_meta[name], launches=sum(paths.values()),
            launches_by_path=paths,
            max_abs_err=max(r["max_abs_err"] for r in rows_
                            if r["dtype"] == "bfloat16"),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row.get("library_ms"),
            cases={f"{r['case']}/{r['dtype']}": dict(
                variant=r.get("variant"), ms=r["kernel_ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r.get("library_ms"),
                **({"stages_ms": r["stages_ms"]} if "stages_ms" in r
                   else {}))
                for r in rows_}))
    by_name["ssd_scan_backward"] = kernels[-2]
    by_name["ssd_scan_backward"]["launches_by_variant_script"] = dict(
        ss.ssd_scan.backward_launches_by_variant)
    print(json.dumps({"kernels": kernels}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
