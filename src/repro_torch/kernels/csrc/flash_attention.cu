// Flash attention for Hopper (sm_90a), forward and backward, bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py ·
// flash_attention (body _kernel, wrapper flash_attention): GQA attention
// with an online softmax in fp32 across KV tiles, causal and sliding-window
// masks on absolute positions (q_offset shifts the queries), keys past T
// masked, and rows that see no key written as 0.
//
// Forward.  Three kernels, one function; flash_attention.py ·
// forward_variant chooses and the C entry launches what it is told.
//  * flash_fwd_wgmma_kernel<D>, for bf16 runs of more than 16 queries with
//    D 16, 32, 64, 96 or 128 and every row of q, k, v and o 16-byte
//    aligned: prefill and training.
//    What bounds it on an H100.  A run of queries against its keys is
//    4 S T D FLOP against 2 (S + 2 T) D bytes a head: at whisper's encoder
//    (8 x 1,500, 20 heads of 64, non-causal) ~9.2e10 FLOP and ~31 MB,
//    ~3,000 FLOP a byte, ten times the ~295 at which the bf16 tensor cores
//    become the limit, so the bound is the operations (0.0932 ms at 989
//    TFLOP/s); at the dense training shape (4 x 2,048, 14 / 2 of 64,
//    causal) 3.0e10 FLOP, 0.0304 ms.  Only wgmma reaches that rate, and
//    only if the copies stay off the threads that issue it and the
//    exponentials (one a score) run while the tensor cores do.
//    The design: Hopper's warpgroup products and TMA, built from
//    hopper_utils.cuh as the backward is.  A block of 160 threads: one
//    consumer warpgroup of 64 query rows and a producer warp whose one
//    thread issues every copy: the Q tile once, then 64-key K and V tiles
//    into two rings of two stages, each stage guarded by a full and an
//    empty mbarrier.  S = Q K^T by wgmma from shared memory (m64n64k16,
//    both K-major), the online softmax in log2 units on the fp32
//    accumulator, P rounded to bf16 in registers and fed back as the A
//    operand of O += P V (m64nDk16, V MN-major): P never touches shared
//    memory; O is divided by the sum of the rounded P, the weights P V
//    used (lse by the fp32 sum).  Tile j + 1's S product is issued with
//    tile j's P V product before tile j + 1's softmax, in two commit
//    groups, so the tensor cores run P V while the exponentials run
//    (FlashAttention-3's overlap
//    within a warpgroup); a K tile goes back to the producer as soon as
//    its S product has completed, so the next K tile is in flight a whole
//    tile ahead.  Kept from the mma.sync kernel it replaces: tiles every
//    row masks are never visited and only the tiles that cross the
//    diagonal, a window's lower edge or T take the element mask (a row's
//    keys are one interval: two compares a score, the masked ones held
//    at -inf through the exponent); causal runs are launched heaviest
//    first; O is normalised in registers, staged through the Q tile and
//    written with 16-byte stores.  New: blocks run in bands of heads whose
//    K / V fits 8 MB of the L2, so a head's K / V is read from device
//    memory about once (launched heads first, ~400 resident blocks read
//    every head's at once: 61 MB at whisper's encoder, 107 MB at
//    phi-3-vision's prefill, and re-read it from device memory).
//    Readings (tools/flash_fwd_compare.py, NVIDIA H100 80GB HBM3, 700.00
//    W, device ms, the mma.sync kernel of PR 30 in turns on the same
//    card): whisper_enc 0.3109 (0.5180; bound 0.0932), phi3v 0.2097
//    (0.3849), train with lse 0.1094 (0.1684; bound 0.0304), slice 0.0215
//    (0.0308), mixtral's window 1.1470 (2.3129).  What bounds it now: a
//    warpgroup's softmax runs between its S product and its next one, and
//    three blocks a multiprocessor do not hide it: with the softmax left
//    out (a timing probe) train took 0.0439 and whisper_enc 0.1745.
//    Measured and not kept: 128 rows a block (two consumer warpgroups
//    sharing each K / V tile, one block a multiprocessor at their
//    registers: slower in every row but a tie at whisper's encoder rank),
//    a third ring stage (no faster; one block a multiprocessor at D 128),
//    S issued two tiles ahead (a second S in registers: fewer blocks a
//    multiprocessor, slower), the row max and sum split into four chains
//    (no faster), P V on P as a bf16 pair (20-35% slower) (PERF.md
//    section 6).
//  * flash_fwd_decode_kernel<D>, the same inputs with at most 16 queries:
//    decode over whisper's cross K/V and a kv_seq rank's block of it.
//    What bounds it: one query row against T keys is 4 T D FLOP against
//    4 T D bytes, so the bytes (8 x 1 over 1,500 keys, 20 heads of 64:
//    ~61 MB, 0.0184 ms at 3.35 TB/s), and with one block a (b, head) only
//    160 blocks for 132 multiprocessors, each must keep many bytes in
//    flight.  The design: 128 threads (64 at D 96 and 128), each warp
//    walking every fourth 64-key tile with its own m, l and accumulator on
//    mma.sync m16n8k16 (one 16-row tile of queries, P V taking P as a
//    bf16 pair, hi and the rest, free where the bytes bound) and its own
//    K and V tile filled by cp.async, the next K tile in flight while P V
//    runs and the next V tile while the next S does; then the warps'
//    partial (m, l,
//    acc) are combined in shared memory in warp order, the same bits on
//    every call.  No tensor map: decode's host cost does not grow.
//    Readings (as above): whisper_cross_decode 0.0240 (0.0341 with one
//    warp of four live; bound 0.0184), a kv_seq rank's block with lse (2 x
//    1 over 750, 20 blocks for 132 multiprocessors) 0.0114 (0.0197, bound
//    0.0011: too few blocks; splitting the keys over blocks is not done).
//  * flash_fwd_kernel, for fp32, for head dims the tensor-core tiles do not
//    cover (24), and for K/V rows not 16-byte aligned (strided views):
//    scalar fp32 FMAs through shared memory, any strides.  GROUP threads
//    share a query row, each owning every GROUP-th dim of q and of the
//    accumulator; a score is the sum of their partial dots (two xor
//    shuffles), and for a given key all rows read the same shared words,
//    which the hardware broadcasts.
//
// Common design.
//  * Each block owns a run of query rows of one (b, h) and loops over KV
//    tiles itself: that loop takes the place of the TPU's sequential KV
//    grid axis and its VMEM scratch (m, l, acc live in registers here).
//  * The loop's bounds come from causal, window and q_offset, so tiles that
//    every row of the block would mask are never visited (the TPU kernel
//    skips them with pl.when).
//  * The kv head is h / (H / K): K and V are read in place, never repeated.
//  * Tensors are addressed through their (B, S, H, D) strides, so the TPU
//    wrapper's moveaxis and its padding of D to 128 and of S, T to block
//    multiples have no counterpart.
//  * m, l and the accumulator stay fp32; the output is stored in q's type.
//  * Under a gradient every form writes each row's logsumexp of the scaled
//    scores, lse = m ln 2 + ln l in natural-log units (m is kept in log2
//    units, scale_log2; in the fp32 kernel lse = m + ln l), fp32 (B, H,
//    S), -inf for a row that sees no key.  Decode over one block of a
//    cross K/V cache cut over the model ranks asks for it too, so the
//    ranks' partial softmaxes can be combined; other serving passes no
//    lse.
//
// Backward (flash_attention_bwd), bf16 on the tensor-core tiles only.
// It replaces nothing on the TPU: the JAX package has no custom_vjp and
// differentiates the plain reference, ref.mha.  FlashAttention-2's
// equations from the saved o and lse, P = exp(S scale - lse),
// dV = P^T dO, dP = dO V^T, dS = P o (dP - Di) with Di = rowsum(dO o O),
// dQ = scale dS K, dK = scale dS^T Q.
//
// What bounds it on an H100.  At the training shape (B 4, S = T 2048,
// 14 / 2 heads of 64, causal) the five matrix products over the visible
// half of the score matrix are ~7.5e10 FLOP, ~0.076 ms at 989 TFLOP/s,
// against ~65 MB of q, k, v, o, dO, dq, dk and dv (~0.019 ms at 3.35 TB/s):
// it is bound by operations.  S and dP are computed in both passes
// (FlashAttention-2's price for needing no atomics) and dS enters dK and dQ
// as a bf16 pair, so the tensor cores run nine products where the bound
// counts five; only wgmma reaches the card's full tensor-core rate, and
// only if the copies stay off the threads that issue it.
//
// Three launches, none with atomics: the same bits on every call.  Each
// pass reads a work list by block, items of (tile, first tile on the other
// side, tiles) that flash_attention.py · backward_plan builds from the
// causal, window and q_offset masks, heaviest first, so the longest blocks
// start first and no long block forms the grid's tail; the kernels keep
// only the masks of single elements on the tiles that cross the diagonal,
// a window's edge or T.
//  * flash_bwd_preprocess_kernel: Di and lse in log2 units (+inf for a row
//    that sees no key), one warp a row, into an fp32 scratch whose rows are
//    padded to whole tiles, so a tile's 64 values are one aligned copy.
//  * flash_bwd_dkdv_wgmma_kernel<D> (D 16, 32, 64, 96, 128): one block per
//    (query head, b, 64-key tile), so a block walks only its own head's
//    visible query tiles (at most 32 at the training shape, where one block
//    per kv head walked 7 heads' worth, up to 224).  S^T = K Q^T and dP^T = V dO^T
//    run as wgmma m64n64k16 from shared memory; P^T and dS^T are formed in
//    the fp32 accumulators and reused in place as register A fragments
//    (hopper_utils.cuh: the accumulator's layout is the A fragment's) for
//    dV += P^T dO and dK += dS^T Q (hi and lo), m64nDk16 with dO and Q
//    MN-major.  The GQA sum: the `group` query heads of one kv head form a
//    thread-block cluster; each member stages its fp32 dK and dV in its own
//    shared memory and, after a cluster barrier, member r sums rows
//    [64 r / group, 64 (r + 1) / group) over members 0 .. group - 1 in that
//    order through distributed shared memory, scales dK and writes bf16
//    once.  The cluster size is set at launch (cudaLaunchKernelEx), up to
//    the non-portable 16 (a group of 12 at mistral-large); a group no
//    cluster holds is refused.
//  * flash_bwd_dq_wgmma_kernel<D>: one block per (query head, b, 64-query
//    tile); S = Q K^T and dP = dO V^T from shared memory, dS (hi, lo) in
//    registers, dQ += dS K with K MN-major, dQ written once.
//  Both wgmma kernels run 160 threads: warps 0-3 are the consumer
//  warpgroup, which never issues a copy; one thread of warp 4 issues TMA
//  boxes (tensor maps encoded on the host at each call from the tensors'
//  strides; a box a panel of 64 columns and 128-byte swizzle at D 64 and
//  128, 32 columns and 64-byte at D 32 and 96, 16 and 32-byte at D 16, so
//  D 96's 192-byte rows are three panels) of the block's fixed tiles
//  once and of the walked tiles into a ring of two stages, each stage
//  guarded by a full mbarrier (the copies landed: the bytes counted by the
//  copy engine) and an empty one (the 128 consumers are done with it); a
//  dK / dV stage also brings the tile's lse2 and Di rows by bulk copy.
//  Registers decide occupancy: a dK / dV consumer holds dK, dV, S^T and
//  dP^T (4 x 32 fp32 at D 64), so two blocks share a multiprocessor at
//  up to 200 registers a thread (one at D 96 and 128); a dQ consumer holds
//  dQ, S and dP, so three do (136 registers).  Handing the producer's registers
//  to the consumers with setmaxnreg instead (a 256-thread block at 128
//  registers a thread) left the consumer compiled within the 128 and
//  spilling, and slower (PERF.md section 6).
//  Shared memory a block (bytes): dK / dV K and V tiles 2 x 128 D, a stage
//  2 x 128 D + 1,024 (Q, dO, lse2, Di), two stages, which the epilogue
//  reuses for the fp32 dK and dV (2 x 64 x (D + 4) x 4, the same size), 1 KB
//  to align tiles to the 128-byte swizzle's 1,024-byte period: 52,288 at
//  D 64, 101,440 at D 128, 76,864 at D 96, 27,712 at D 32, 15,424 at D 16;
//  dQ: Q and dO tiles plus two stages of K and V: 50,240 at D 64, 99,392
//  at D 128, 74,816 at D 96.
//  P is rounded to bf16 for the dV product, as the forward rounds P (dV's
//  largest error equals the plain twin's output rounding in every checked
//  case).  dS goes into the dK and dQ products as a pair of bf16 (hi, and
//  lo = dS - hi), two products each: rounded once, dS cost dQ up to 2.6x
//  the plain twin's error at a window of 48, where a query sums few large
//  terms (PERF.md section 6).  Every sum is fp32.  What the clusters cost:
//  a cluster needs `group` free block slots in one GPC at once, so the
//  card holds fewer dK / dV blocks than it would single ones
//  (chip_smoke.py's resident_blocks).  Not done here: a fused dQ pass (it
//  needs atomics or ordered semaphores; ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_utils.cuh"
#include "mma_utils.cuh"

namespace {

constexpr int BLOCK_Q = 64;   // query rows per block
constexpr int BLOCK_K = 32;   // keys per shared-memory tile
constexpr int GROUP = 4;      // threads per query row
constexpr int THREADS = BLOCK_Q * GROUP;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, group;  // group = H / K query heads per kv head
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal, window, q_offset;
  float* lse;  // (B, H, S) natural-log logsumexp of the scaled scores, or
               // null (serving)
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  static_assert(D % GROUP == 0, "head dim must be a multiple of GROUP");
  constexpr int PER = D / GROUP;  // dims of q / acc owned by one thread
  __shared__ float ks[BLOCK_K][D];
  __shared__ float vs[BLOCK_K][D];

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int row = threadIdx.x / GROUP;
  const int sub = threadIdx.x % GROUP;
  const int qi = blockIdx.x * BLOCK_Q + row;
  const bool q_valid = qi < p.S;
  const int q_pos = qi + p.q_offset;

  float qr[PER];
  float acc[PER];
  const T* qrow = q + b * p.q_sb + (long long)qi * p.q_ss + h * p.q_sh;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qr[i] = q_valid ? load_f(qrow + i * GROUP + sub) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;  // running max of visible scores
  float l = 0.f;        // running softmax denominator

  // keys any row of this block can see
  const int first_pos = blockIdx.x * BLOCK_Q + p.q_offset;
  const int last_pos = min(blockIdx.x * BLOCK_Q + BLOCK_Q, p.S) - 1 + p.q_offset;
  const int kv_hi = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int kv_lo = p.window > 0 ? max(0, first_pos - p.window + 1) : 0;

  const T* kbase = k + b * p.k_sb + kvh * p.k_sh;
  const T* vbase = v + b * p.v_sb + kvh * p.v_sh;

  for (int start = kv_lo; start < kv_hi; start += BLOCK_K) {
    for (int e = threadIdx.x; e < BLOCK_K * D; e += THREADS) {
      const int j = e / D;
      const int d = e % D;
      const int t = start + j;
      float kx = 0.f, vx = 0.f;
      if (t < kv_hi) {
        kx = load_f(kbase + (long long)t * p.k_st + d);
        vx = load_f(vbase + (long long)t * p.v_st + d);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float s[BLOCK_K];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) part = fmaf(qr[i], ks[j][i * GROUP + sub], part);
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int t = start + j;
      bool ok = t < kv_hi;
      if (p.causal) ok = ok && t <= q_pos;
      if (p.window > 0) ok = ok && q_pos - t < p.window;
      s[j] = ok ? part * p.scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {  // this row has seen a visible key
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BLOCK_K; ++j) {
        s[j] = expf(s[j] - m_new);  // masked scores give exp(-inf) = 0
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float a = acc[i] * alpha;
#pragma unroll
        for (int j = 0; j < BLOCK_K; ++j) a = fmaf(s[j], vs[j][i * GROUP + sub], a);
        acc[i] = a;
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (q_valid) {
    const float denom = l == 0.f ? 1.f : l;  // no visible key -> acc = 0
    T* orow = o + b * p.o_sb + (long long)qi * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < PER; ++i) store_f(orow + i * GROUP + sub, acc[i] / denom);
    // lse = ln sum_t exp(scale s_t) = m + ln l; -inf for a row that sees
    // no key
    if (p.lse != nullptr && sub == 0)
      p.lse[((long long)b * p.H + h) * p.S + qi] =
          l == 0.f ? -INFINITY : m + logf(l);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int D, dim3 grid, cudaStream_t stream) {
  switch (D) {
    case 16: flash_fwd_kernel<T, 16><<<grid, THREADS, 0, stream>>>(p); break;
    case 24: flash_fwd_kernel<T, 24><<<grid, THREADS, 0, stream>>>(p); break;
    case 32: flash_fwd_kernel<T, 32><<<grid, THREADS, 0, stream>>>(p); break;
    case 64: flash_fwd_kernel<T, 64><<<grid, THREADS, 0, stream>>>(p); break;
    case 96: flash_fwd_kernel<T, 96><<<grid, THREADS, 0, stream>>>(p); break;
    case 128: flash_fwd_kernel<T, 128><<<grid, THREADS, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward (bf16, D % 16 == 0, every row of q, k, v, o, dO, dq, dk, dv
// 16-byte aligned): a preprocess, then the dK / dV pass and the dQ pass,
// each reading its work list (flash_attention.py · backward_plan) by block
// ---------------------------------------------------------------------------
constexpr int BWD_BQ = 64;                 // query rows per tile
constexpr int BWD_BK = 64;                 // keys per tile
constexpr int PRE_WARPS = 8;               // rows per preprocess block
constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, S), the forward's
  // scratch, each (B, H, S_pad), S_pad = S rounded up to a whole tile, so a
  // tile's rows are one aligned 256-byte run: lse in log2 units (+inf for
  // a row that sees no key and for the padding, so every P of it is
  // exp2(-inf) = 0) and Di = rowsum(dO o O) (0 in the padding)
  float* lse2;
  float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, T, H, group, S_pad;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  float scale;
  int causal, window, q_offset;
};

// the forward's masks on absolute positions: key t, query position qp
__device__ __forceinline__ bool visible(const BwdParams& p, int t, int qp) {
  bool ok = t < p.T;
  if (p.causal) ok = ok && t <= qp;
  if (p.window > 0) ok = ok && qp - t < p.window;
  return ok;
}

// Di and lse2 of one row a warp, rows in (b, h, i) order over S_pad
__global__ void __launch_bounds__(32 * PRE_WARPS)
    flash_bwd_preprocess_kernel(const BwdParams p, int B, int D) {
  const long long row = (long long)blockIdx.x * PRE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * p.H * p.S_pad) return;  // the whole warp
  const int i = static_cast<int>(row % p.S_pad);
  const int bh = static_cast<int>(row / p.S_pad);
  if (i >= p.S) {
    if (lane == 0) p.lse2[row] = INFINITY, p.delta[row] = 0.f;
    return;
  }
  const int h = bh % p.H, b = bh / p.H;
  const __nv_bfloat16* o =
      p.o + b * p.o_sb + (long long)i * p.o_ss + h * p.o_sh;
  const __nv_bfloat16* d =
      p.dout + b * p.do_sb + (long long)i * p.do_ss + h * p.do_sh;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(__bfloat162float(o[c]), __bfloat162float(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float x = p.lse[(long long)bh * p.S + i];
    p.delta[row] = acc;
    p.lse2[row] = x == -INFINITY ? INFINITY : x * LOG2E;
  }
}

// ---------------------------------------------------------------------------
// dK / dV and dQ kernels (every tensor-core head dim: 16, 32, 64, 96, 128)
// ---------------------------------------------------------------------------
// Warps 0-3 (one warpgroup) consume: wgmma and the elementwise work.  Warp
// 4 produces: one thread issues every copy.  A third stage in the ring
// measured no faster (PERF.md section 6).
constexpr int WG_THREADS = 160;
constexpr int WG_STAGES = 2;  // tiles in flight in the ring

template <int D>
struct WgTile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 96 || D == 128,
                "the backward takes head dims 16, 32, 64, 96 and 128");
  // columns per TMA box: the widest swizzle panel that divides D, so
  // D 96 is three 32-column panels (64-byte rows) and D 16 one of 32 bytes
  static constexpr int PANEL = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int ROW_BYTES = 2 * PANEL;     // 128, 64 or 32
  static constexpr int PANEL_BYTES = 64 * ROW_BYTES;
  static constexpr int BYTES = 64 * D * 2;        // one 64-row tile
  // the descriptors' swizzle: 1 128-byte, 2 64-byte, 3 32-byte
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  // two blocks a multiprocessor at D <= 64, each thread up to 200
  // registers (2 x 160 x 200 of the 65,536), one block at D 96 and 128 (up
  // to 255): the consumer holds dK, dV, S^T and dP^T in registers at once
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  // the dQ block holds dQ, S and dP (no dV): three blocks a multiprocessor
  // at D <= 64 (136 registers a thread), measured against two (PERF.md
  // section 6)
  static constexpr int DQ_MIN_BLOCKS = D <= 64 ? 3 : 1;
};

// Shared memory of the dK / dV block: K and V tiles, WG_STAGES x (Q tile,
// dO tile, the tile's lse2 and Di rows, padded to 1 KB), 8 barriers' worth
// of words, 1 KB to align the base.  The epilogue stages fp32 dK and dV
// (2 x 64 rows x (D + 4) floats) over the ring, which has exactly that
// size.  D 64: 16 + 34 + 1 KB = 52,288 bytes (two blocks a multiprocessor);
// D 128: 101,440; D 96: 76,864; D 32: 27,712; D 16: 15,424.
template <int D>
constexpr int wg_dkdv_smem_bytes() {
  return 2 * WgTile<D>::BYTES + WG_STAGES * (2 * WgTile<D>::BYTES + 1024) +
         64 + 1024;
}
static_assert(WG_STAGES * (2 * WgTile<64>::BYTES + 1024) >=
                  2 * 64 * (64 + 4) * 4,
              "the ring holds the fp32 dK / dV staging");

// Shared memory of the dQ block: Q and dO tiles, WG_STAGES x (K tile, V
// tile), barriers, alignment; the epilogue stages bf16 dQ (64 x (D + 8))
// over the ring.  D 64: 50,240 bytes.
template <int D>
constexpr int wg_dq_smem_bytes() {
  return 2 * WgTile<D>::BYTES + WG_STAGES * 2 * WgTile<D>::BYTES + 64 + 1024;
}

// descriptor of K step kk (16 columns) of a K-major 64-row tile
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using W = WgTile<D>;
  constexpr int STEPS = W::PANEL / 16;  // K steps a panel
  return hop::smem_desc(
      tile + (kk / STEPS) * W::PANEL_BYTES + (kk % STEPS) * 32, 16,
      8 * W::ROW_BYTES, W::LAYOUT);
}

// descriptor of K step kk (16 rows, every column) of an MN-major tile
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using W = WgTile<D>;
  return hop::smem_desc(tile + kk * 16 * W::ROW_BYTES, W::PANEL_BYTES,
                        8 * W::ROW_BYTES, W::LAYOUT);
}

// 64 rows of one (b, head) of a tensor map into a tile: a box a panel
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int head, int row0, int b,
                                         uint32_t bar) {
  using W = WgTile<D>;
#pragma unroll
  for (int pn = 0; pn < D / W::PANEL; ++pn)
    hop::tma_load_4d(dst + pn * W::PANEL_BYTES, map, pn * W::PANEL, head,
                     row0, b, bar);
}

// One query tile against the block's 64 keys: S^T = K Q^T and dP^T =
// V dO^T (K and V the A operands, Q and dO K-major B), P^T = exp2(S^T
// scale_log2 - lse2) and dS^T = P^T o (dP^T - Di) in registers, then dV +=
// P^T dO and dK += dS^T Q with P^T and dS^T (hi + lo) as register A
// fragments and dO, Q MN-major.  Four commit groups, so the tensor cores
// run dP^T while P^T is formed and dV while dS^T is.  Thread (warp w,
// lane l) holds keys 16 w + l / 4 (+ 8) and, in each 8-query block n,
// queries 8 n + 2 (l % 4) + {0, 1}.
template <int D, bool MASK>
__device__ __forceinline__ void dkdv_step(
    const BwdParams& p, uint32_t ks, uint32_t vs, uint32_t qs, uint32_t dos,
    const float* ls, const float* ds, float (&dk)[D / 2], float (&dv)[D / 2],
    int k0, int q0, float scale_log2, int warp, int lane) {
  float st[32], dpt[32];
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::wgmma_ss(st, kmajor<D>(ks, kk), kmajor<D>(qs, kk), kk);
  hop::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::wgmma_ss(dpt, kmajor<D>(vs, kk), kmajor<D>(dos, kk), kk);
  hop::wgmma_commit();
  hop::wgmma_wait<1>();  // S^T
  hop::fence_operand(st);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tig;
    const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float pv = exp2f(st[4 * n + i] * scale_log2 - ((i & 1) ? l2.y : l2.x));
      if constexpr (MASK) {
        const int t = k0 + 16 * warp + g + 8 * (i >> 1);
        pv = visible(p, t, q0 + col + (i & 1) + p.q_offset) ? pv : 0.f;
      }
      st[4 * n + i] = pv;
    }
  }
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hop::accumulator_to_a(st, kk, pa[kk]);
  hop::fence_operand(dv);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_rs_tb(dv, pa[kk], mnmajor<D>(dos, kk), 1);
  hop::wgmma_commit();
  hop::wgmma_wait<1>();  // dP^T (dV may still run)
  hop::fence_operand(dpt);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 di = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * tig);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dpt[4 * n + i] =
          st[4 * n + i] * (dpt[4 * n + i] - ((i & 1) ? di.y : di.x));
  }
  uint32_t dh[4][4], dl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::accumulator_to_a_split(dpt, kk, dh[kk], dl[kk]);
  hop::fence_operand(dk);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hop::wgmma_rs_tb(dk, dh[kk], mnmajor<D>(qs, kk), 1);
    hop::wgmma_rs_tb(dk, dl[kk], mnmajor<D>(qs, kk), 1);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_operand(dv);
  hop::fence_operand(dk);
}

// One block per (query head, b, work item (key tile, first query tile,
// query tiles)), items heaviest first; a cluster of `group` blocks holds
// the query heads of one kv head.  The producer brings K and V once and
// the item's Q / dO / lse2 / Di tiles through a ring of WG_STAGES stages
// (TMA and bulk copies, full and empty mbarriers); the consumer warpgroup
// builds its head's dK and dV in fp32 registers.  Then each member stages
// them in its shared memory and, after a cluster barrier, member r sums
// rows [64 r / group, 64 (r + 1) / group) over members 0 .. group - 1 in
// that order through distributed shared memory, scales dK and writes bf16
// once: no atomics, the same bits on every call.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, WgTile<D>::MIN_BLOCKS)
    flash_bwd_dkdv_wgmma_kernel(const BwdParams p,
                                const int* __restrict__ items,
                                const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do) {
  using W = WgTile<D>;
  constexpr int STAGE_BYTES = 2 * W::BYTES + 1024;
  constexpr int RING = 2 * W::BYTES;
  constexpr int BARS = RING + WG_STAGES * STAGE_BYTES;
  constexpr int PITCH = D + 4;  // floats a staged row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t ks = base, vs = base + W::BYTES;
  const uint32_t kv_full = base + BARS;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * WG_STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / p.group;
  const int* item = items + 3 * blockIdx.z;
  const int k0 = item[0] * BWD_BK, qt0 = item[1], nq = item[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row_base = ((long long)b * p.H + h) * p.S_pad;

  if (tid == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      hop::mbar_init(full0 + 8 * s, 1);
      hop::mbar_init(empty0 + 8 * s, 128);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      hop::mbar_arrive_expect_tx(kv_full, 2 * W::BYTES);
      tma_tile<D>(ks, &tm_k, kvh, k0, b, kv_full);
      tma_tile<D>(vs, &tm_v, kvh, k0, b, kv_full);
      for (int it = 0; it < nq; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES)
          hop::mbar_wait(empty0 + 8 * s, (it / WG_STAGES - 1) & 1);
        const uint32_t stage = base + RING + s * STAGE_BYTES;
        const uint32_t bar = full0 + 8 * s;
        const int q0 = (qt0 + it) * BWD_BQ;
        hop::mbar_arrive_expect_tx(bar, 2 * W::BYTES + 512);
        tma_tile<D>(stage, &tm_q, h, q0, b, bar);
        tma_tile<D>(stage + W::BYTES, &tm_do, h, q0, b, bar);
        hop::bulk_load(stage + 2 * W::BYTES, p.lse2 + row_base + q0, 256, bar);
        hop::bulk_load(stage + 2 * W::BYTES + 256, p.delta + row_base + q0,
                       256, bar);
      }
    }
    __syncwarp();
    hop::cluster_sync();  // the members' dK and dV are staged
    hop::cluster_sync();  // and summed: the shared memory may go
    return;
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float scale_log2 = p.scale * LOG2E;
  hop::mbar_wait(kv_full, 0);
  for (int it = 0; it < nq; ++it) {
    const int s = it % WG_STAGES;
    hop::mbar_wait(full0 + 8 * s, (it / WG_STAGES) & 1);
    const uint32_t stage = base + RING + s * STAGE_BYTES;
    const float* ls = reinterpret_cast<const float*>(sbase + RING +
                                                     s * STAGE_BYTES +
                                                     2 * W::BYTES);
    const int q0 = (qt0 + it) * BWD_BQ;
    const int qa = q0 + p.q_offset;
    // a tile whose every (key, query) pair is visible takes no mask; rows
    // past S have P = 0 through their lse2
    const bool all = k0 + BWD_BK <= p.T && (!p.causal || k0 + 63 <= qa) &&
                     (p.window <= 0 || qa + 63 - k0 < p.window);
    if (all)
      dkdv_step<D, false>(p, ks, vs, stage, stage + W::BYTES, ls, ls + 64, dk,
                          dv, k0, q0, scale_log2, warp, lane);
    else
      dkdv_step<D, true>(p, ks, vs, stage, stage + W::BYTES, ls, ls + 64, dk,
                         dv, k0, q0, scale_log2, warp, lane);
    hop::mbar_arrive(empty0 + 8 * s);
  }

  // stage fp32 dK and dV over the ring, once every consumer is done with it
  hop::bar_sync(1, 128);
  float* staged = reinterpret_cast<float*>(sbase + RING);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = (16 * warp + g + 8 * half) * PITCH + 8 * n + 2 * tig;
      *reinterpret_cast<float2*>(staged + off) =
          make_float2(dk[4 * n + 2 * half], dk[4 * n + 2 * half + 1]);
      *reinterpret_cast<float2*>(staged + 64 * PITCH + off) =
          make_float2(dv[4 * n + 2 * half], dv[4 * n + 2 * half + 1]);
    }
  }
  hop::cluster_sync();
  // this member's rows, summed over the members in rank order
  const int G = p.group;
  const int rank = static_cast<int>(hop::cluster_rank());
  const int r0 = rank * BWD_BK / G, r1 = (rank + 1) * BWD_BK / G;
  constexpr int C4 = D / 4;  // 4-float chunks a row
  const int n_mine = (r1 - r0) * C4;
  for (int e = tid; e < 2 * n_mine; e += 128) {
    const int dv_half = e >= n_mine;
    const int rr = r0 + (e - dv_half * n_mine) / C4;
    const int c = (e - dv_half * n_mine) % C4;
    const uint32_t off =
        base + RING + ((dv_half * 64 + rr) * PITCH + 4 * c) * 4;
    float4 acc = hop::ld_cluster_f4(hop::map_rank(off, 0));
#pragma unroll 4
    for (int m = 1; m < G; ++m) {
      const float4 x = hop::ld_cluster_f4(hop::map_rank(off, m));
      acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
    }
    const int t = k0 + rr;
    if (t < p.T) {
      const float f = dv_half ? 1.f : p.scale;
      __nv_bfloat16* dst =
          dv_half ? p.dv + b * p.dv_sb + (long long)t * p.dv_st + kvh * p.dv_sh
                  : p.dk + b * p.dk_sb + (long long)t * p.dk_st + kvh * p.dk_sh;
      *reinterpret_cast<uint2*>(dst + 4 * c) =
          make_uint2(hop::pack_bf16(acc.x * f, acc.y * f),
                     hop::pack_bf16(acc.z * f, acc.w * f));
    }
  }
  hop::cluster_sync();
}

// One key tile against the block's 64 query rows: S = Q K^T and dP =
// dO V^T (Q and dO the A operands, K and V K-major B), P and dS = P o
// (dP - Di) in registers, dQ += dS K with dS (hi + lo) as register A
// fragments and K MN-major.  Thread (warp w, lane l) holds query rows
// 16 w + l / 4 (+ 8), keys 8 n + 2 (l % 4) + {0, 1} of block n.
template <int D, bool MASK>
__device__ __forceinline__ void dq_step(
    const BwdParams& p, uint32_t qs, uint32_t dos, uint32_t ks, uint32_t vs,
    float (&dq)[D / 2], const float (&lse2)[2], const float (&di)[2], int k0,
    int q0, float scale_log2, int warp, int lane) {
  float sc[32], dp[32];
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::wgmma_ss(sc, kmajor<D>(qs, kk), kmajor<D>(ks, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::wgmma_ss(dp, kmajor<D>(dos, kk), kmajor<D>(vs, kk), kk);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_operand(sc);
  hop::fence_operand(dp);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * n + i, half = i >> 1;
      float pv = exp2f(sc[r] * scale_log2 - lse2[half]);
      if constexpr (MASK) {
        const int t = k0 + 8 * n + 2 * tig + (i & 1);
        const int qp = q0 + 16 * warp + g + 8 * half + p.q_offset;
        pv = visible(p, t, qp) ? pv : 0.f;
      }
      sc[r] = pv * (dp[r] - di[half]);
    }
  }
  uint32_t dh[4][4], dl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::accumulator_to_a_split(sc, kk, dh[kk], dl[kk]);
  hop::fence_operand(dq);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hop::wgmma_rs_tb(dq, dh[kk], mnmajor<D>(ks, kk), 1);
    hop::wgmma_rs_tb(dq, dl[kk], mnmajor<D>(ks, kk), 1);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_operand(dq);
}

// One block per (query head, b, work item (query tile, first key tile,
// key tiles)), items heaviest first.  The producer brings Q and dO once
// and the item's K / V tiles through the ring; the consumer warpgroup
// builds dQ in fp32 registers and writes it once, scaled, as bf16.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, WgTile<D>::DQ_MIN_BLOCKS)
    flash_bwd_dq_wgmma_kernel(const BwdParams p,
                              const int* __restrict__ items,
                              const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do) {
  using W = WgTile<D>;
  constexpr int STAGE_BYTES = 2 * W::BYTES;
  constexpr int RING = 2 * W::BYTES;
  constexpr int BARS = RING + WG_STAGES * STAGE_BYTES;
  constexpr int PITCH = D + 8;  // bf16 a staged row
  static_assert(64 * PITCH * 2 <= WG_STAGES * STAGE_BYTES,
                "the ring holds the bf16 dQ staging");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t qs = base, dos = base + W::BYTES;
  const uint32_t q_full = base + BARS;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * WG_STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / p.group;
  const int* item = items + 3 * blockIdx.z;
  const int q0 = item[0] * BWD_BQ, kt0 = item[1], nk = item[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      hop::mbar_init(full0 + 8 * s, 1);
      hop::mbar_init(empty0 + 8 * s, 128);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      hop::mbar_arrive_expect_tx(q_full, 2 * W::BYTES);
      tma_tile<D>(qs, &tm_q, h, q0, b, q_full);
      tma_tile<D>(dos, &tm_do, h, q0, b, q_full);
      for (int it = 0; it < nk; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES)
          hop::mbar_wait(empty0 + 8 * s, (it / WG_STAGES - 1) & 1);
        const uint32_t stage = base + RING + s * STAGE_BYTES;
        const uint32_t bar = full0 + 8 * s;
        const int k0 = (kt0 + it) * BWD_BK;
        hop::mbar_arrive_expect_tx(bar, 2 * W::BYTES);
        tma_tile<D>(stage, &tm_k, kvh, k0, b, bar);
        tma_tile<D>(stage + W::BYTES, &tm_v, kvh, k0, b, bar);
      }
    }
    return;
  }

  const int g = lane >> 2, tig = lane & 3;
  const long long row = ((long long)b * p.H + h) * p.S_pad + q0 + 16 * warp + g;
  const float lse2[2] = {p.lse2[row], p.lse2[row + 8]};
  const float di[2] = {p.delta[row], p.delta[row + 8]};
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float scale_log2 = p.scale * LOG2E;
  const int qa = q0 + p.q_offset;
  hop::mbar_wait(q_full, 0);
  for (int it = 0; it < nk; ++it) {
    const int s = it % WG_STAGES;
    hop::mbar_wait(full0 + 8 * s, (it / WG_STAGES) & 1);
    const uint32_t stage = base + RING + s * STAGE_BYTES;
    const int k0 = (kt0 + it) * BWD_BK;
    const bool all = k0 + BWD_BK <= p.T && (!p.causal || k0 + 63 <= qa) &&
                     (p.window <= 0 || qa + 63 - k0 < p.window);
    if (all)
      dq_step<D, false>(p, qs, dos, stage, stage + W::BYTES, dq, lse2, di, k0,
                        q0, scale_log2, warp, lane);
    else
      dq_step<D, true>(p, qs, dos, stage, stage + W::BYTES, dq, lse2, di, k0,
                       q0, scale_log2, warp, lane);
    hop::mbar_arrive(empty0 + 8 * s);
  }

  // dQ times scale, staged as bf16 over the ring, then 16-byte stores
  hop::bar_sync(1, 128);
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(sbase + RING);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = (16 * warp + g + 8 * half) * PITCH + 8 * n + 2 * tig;
      *reinterpret_cast<uint32_t*>(staged + off) =
          hop::pack_bf16(dq[4 * n + 2 * half] * p.scale,
                         dq[4 * n + 2 * half + 1] * p.scale);
    }
  }
  hop::bar_sync(1, 128);
  constexpr int CPR = D / 8;
  __nv_bfloat16* dqg = p.dq + b * p.dq_sb + (long long)q0 * p.dq_ss + h * p.dq_sh;
  for (int e = tid; e < BWD_BQ * CPR; e += 128) {
    const int r = e / CPR, ch = e % CPR;
    if (q0 + r < p.S)
      *reinterpret_cast<uint4*>(dqg + r * p.dq_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(staged + r * PITCH + ch * 8);
  }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores (bf16, D 16, 32, 64, 96 or 128, every row of
// q, k, v and o 16-byte aligned): flash_fwd_wgmma_kernel for runs of more
// than DEC_ROWS queries, flash_fwd_decode_kernel for up to DEC_ROWS
// ---------------------------------------------------------------------------
constexpr int FWD_BK = 64;      // keys per K / V tile, both forms
// stages of the K ring and of the V ring.  A K tile is free once its S
// product has completed, early in its iteration, a V tile once its P V
// product has; a third stage measured no faster (PERF.md section 6)
constexpr int FWD_STAGES = 2;
// consumer warpgroups of 64 query rows a wgmma block (160 threads with the
// producer warp), measured against two (288 threads, 128 rows)
constexpr int FWD_WG = 1;
constexpr int FWD_ROWS = 64 * FWD_WG;            // query rows a block
// K and V bytes of the heads whose blocks run together: a sixth of the
// 50 MB L2, so a head's K / V is read from device memory about once
constexpr long long FWD_BAND_BYTES = 8ll << 20;
constexpr int FWD_THREADS = 128 * FWD_WG + 32;
constexpr int DEC_ROWS = 16;    // query rows of a decode block: one m16 tile
constexpr float LN2 = 0.6931471805599453f;

// blocks a multiprocessor the wgmma kernel is compiled for: the consumer
// holds O (D / 2 fp32), S (32) and P (16 bf16 pairs) in registers
template <int D>
constexpr int fwd_min_blocks() {
  return FWD_WG == 1 ? (D <= 64 ? 3 : 2) : 1;
}

// Shared memory of the wgmma block: FWD_WG Q tiles, the K and V rings, 9
// barriers in 128 bytes, 1 KB to align the base.  D 64: 42,112 bytes
// (three blocks a multiprocessor); D 128: 83,072 (two).
template <int D>
constexpr int fwd_wgmma_smem_bytes() {
  return (FWD_WG + 2 * FWD_STAGES) * WgTile<D>::BYTES + 128 + 1024;
}

// byte offset of the 2-byte column col (even) of row r in a 64-row tile as
// TMA writes it (hopper_utils.cuh): its panel, the row, and the 16-byte
// chunk swizzled by the panel's row length
template <int D>
__device__ __forceinline__ int swizzled(int r, int col) {
  using W = WgTile<D>;
  const int chunk = (col % W::PANEL) / 8;
  const int sw = W::ROW_BYTES == 128  ? r % 8
                 : W::ROW_BYTES == 64 ? (r / 2) % 4
                                      : (r / 4) % 2;
  return (col / W::PANEL) * W::PANEL_BYTES + r * W::ROW_BYTES +
         (chunk ^ sw) * 16 + (col % 8) * 2;
}

// 2^x on the multi-function unit alone; a result below 2^-126 flushes to 0,
// which the bf16 P it becomes would not hold either
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64-key tile of S in place, in log2 units: the rows'
// running max m (and, LSE, their fp32 sum l) updated from the raw scores, s
// leaves as P = 2^(s scale_log2 - m) (unnormalised), alpha the factor the
// accumulator and the rounded sum take.  The scale enters once, in the
// exponent's FMA, so the row's largest scaled score is its largest raw one
// times scale_log2 (UP: scale_log2 > 0) or its smallest (a negative scale).
// MASK: a row sees the keys of one interval (its window's lower edge, the
// causal diagonal, T), two compares a score; a masked score is held at the far
// end, which the exponent's FMA turns into -inf and 2^-inf into 0.  Thread
// (warp w, lane l) of the warpgroup holds the rows at absolute positions qp[0]
// and qp[1] and, in each 8-key block n, keys start + 8 n + 2 (l % 4) + {0, 1}.
template <bool MASK, bool UP, bool LSE>
__device__ __forceinline__ void fwd_softmax(const Params& p, float (&s)[32],
                                            float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], int start,
                                            const int (&qp)[2],
                                            float scale_log2, int tig) {
  constexpr float NONE = UP ? -INFINITY : INFINITY;  // no visible score
  int lo[2], hi[2];  // MASK: the row's keys, from this thread's first key
  if constexpr (MASK) {
    const int t0 = start + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo[r] = p.window > 0 ? qp[r] - p.window + 1 - t0 : -1;
      hi[r] = (p.causal ? min(p.T, qp[r] + 1) : p.T) - t0;
    }
  }
  float ext[2] = {NONE, NONE};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = (j >> 1) & 1;
    float v = s[j];
    if constexpr (MASK) {
      const int k = 8 * (j / 4) + (j & 1);
      v = k >= lo[r] && k < hi[r] ? v : NONE;
      s[j] = v;
    }
    ext[r] = UP ? fmaxf(ext[r], v) : fminf(ext[r], v);
  }
  float nbase[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int d = 1; d <= 2; d *= 2) {
      const float o = __shfl_xor_sync(0xffffffffu, ext[r], d);
      ext[r] = UP ? fmaxf(ext[r], o) : fminf(ext[r], o);
    }
    const float mx = ext[r] == NONE ? -INFINITY : ext[r] * scale_log2;
    const float m_new = fmaxf(m[r], mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;  // none visible yet
    alpha[r] = ex2(m[r] - base);
    m[r] = m_new;
    if constexpr (LSE) l[r] *= alpha[r];
    nbase[r] = -base;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = (j >> 1) & 1;
    s[j] = ex2(fmaf(s[j], scale_log2, nbase[r]));
    if constexpr (LSE) l[r] += s[j];
  }
}

// P of one tile (fwd_softmax's s) rounded to bf16 as the A fragments of P V,
// two scores a register (the accumulator's layout is the A fragment's), and the
// rounded values added to the rows' sum lr: O is divided by lr, the sum of the
// very weights P V used (lse takes the fp32 sum l, which only a launch that
// writes lse keeps).  Divided by l, the served hymba's bf16 decode handoff
// read 0.99891 in cosine, under chip_smoke.py's 0.999 (PERF.md section 6).
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&pa)[4][4],
                                       float (&lr)[2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 8 * kk + 2 * i;
      const __nv_bfloat162 h = __floats2bfloat162_rn(s[j], s[j + 1]);
      pa[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      const float2 hf = __bfloat1622float2(h);
      lr[i & 1] += hf.x + hf.y;
    }
  }
}

// One block per (b, query head, run of FWD_ROWS query rows), in bands of
// heads whose K / V the L2 holds, causal runs heaviest first in a band.
// Warps 0 .. 4 FWD_WG - 1 are the consumer warpgroups, 64 rows each; one
// thread of the last warp, the producer, issues every copy: the block's Q
// tiles once, then K and V tiles by TMA into a K ring and a V ring of
// FWD_STAGES each, each stage guarded by a full mbarrier (the copy engine
// counted its bytes) and an empty one (every consumer is done with it).  A
// warpgroup walks the tiles its rows see: S = Q K^T by wgmma from shared
// memory, the online softmax on the fp32 accumulator, P rounded to bf16 in
// registers (the accumulator's layout is the A fragment's), O += P V by
// wgmma with P from registers and V MN-major.  Tile j + 1's S product and
// tile j's P V product are issued together (two commit groups) before tile
// j + 1's softmax, so the tensor cores run P V while the exponentials run.
// A K tile is released once its S product has completed, a V tile once
// its P V product has, so the producer brings tile j + 2's K while tile
// j + 1 is computed.
template <int D, bool LSE>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks<D>())
    flash_fwd_wgmma_kernel(const Params p, int band,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v) {
  using W = WgTile<D>;
  constexpr int ST = FWD_STAGES;
  constexpr int KRING = FWD_WG * W::BYTES;
  constexpr int VRING = KRING + ST * W::BYTES;
  constexpr int BARS = VRING + ST * W::BYTES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t q_full = base + BARS;
  const uint32_t k_full0 = q_full + 8, k_empty0 = k_full0 + 8 * ST;
  const uint32_t v_full0 = k_empty0 + 8 * ST, v_empty0 = v_full0 + 8 * ST;

  // blocks run band by band, `band` (b, head) pairs whose K / V the L2
  // holds at once; within a band query blocks are launched in turn for
  // each of its heads, causal ones heaviest (most KV tiles) first
  const int nq = (p.S + FWD_ROWS - 1) / FWD_ROWS;
  const int band0 = blockIdx.x / (nq * band) * band;
  const int heads = min(band, gridDim.x / nq - band0);  // the last: fewer
  const int r = blockIdx.x - band0 * nq;
  const int qi = r / heads, bh = band0 + r % heads;
  const int qb = p.causal ? nq - 1 - qi : qi;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / p.group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_block0 = qb * FWD_ROWS;
  // warpgroups with a row below S; only their Q tiles are brought
  const int live = min(FWD_WG, (p.S - q_block0 + 63) / 64);

  // keys any row of this block can see, in whole tiles
  const int first_pos = q_block0 + p.q_offset;
  const int last_pos = min(q_block0 + FWD_ROWS, p.S) - 1 + p.q_offset;
  const int kv_hi = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int kv_lo = p.window > 0 ? max(0, first_pos - p.window + 1) : 0;
  const int t_first = kv_lo / FWD_BK * FWD_BK;
  const int ntiles =
      kv_hi > t_first ? (kv_hi - t_first + FWD_BK - 1) / FWD_BK : 0;

  if (tid == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(k_full0 + 8 * s, 1);
      hop::mbar_init(k_empty0 + 8 * s, 128 * FWD_WG);
      hop::mbar_init(v_full0 + 8 * s, 1);
      hop::mbar_init(v_empty0 + 8 * s, 128 * FWD_WG);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * FWD_WG) {  // producer
    if (lane == 0) {
      hop::prefetch_map(&tm_q);
      hop::prefetch_map(&tm_k);
      hop::prefetch_map(&tm_v);
      hop::mbar_arrive_expect_tx(q_full, live * W::BYTES);
      for (int w = 0; w < live; ++w)
        tma_tile<D>(base + w * W::BYTES, &tm_q, h, q_block0 + 64 * w, b,
                    q_full);
      // keys past T arrive as zeros
      for (int it = 0; it < ntiles; ++it) {
        const int t0 = t_first + it * FWD_BK;
        const int s = it % ST, parity = (it / ST - 1) & 1;
        if (it >= ST) hop::mbar_wait(k_empty0 + 8 * s, parity);
        hop::mbar_arrive_expect_tx(k_full0 + 8 * s, W::BYTES);
        tma_tile<D>(base + KRING + s * W::BYTES, &tm_k, kvh, t0, b,
                    k_full0 + 8 * s);
        if (it >= ST) hop::mbar_wait(v_empty0 + 8 * s, parity);
        hop::mbar_arrive_expect_tx(v_full0 + 8 * s, W::BYTES);
        tma_tile<D>(base + VRING + s * W::BYTES, &tm_v, kvh, t0, b,
                    v_full0 + 8 * s);
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4, g = lane >> 2, tig = lane & 3;
  const int row0 = q_block0 + 64 * wg;  // this warpgroup's first query row
  const uint32_t qs = base + wg * W::BYTES;
  const bool wg_live = wg < live;
  const int wg_first = row0 + p.q_offset;
  const int wg_last = min(row0 + 63, p.S - 1) + p.q_offset;
  // the tiles [it_lo, it_hi) of the block's that this warpgroup's rows see
  int it_lo = 0, it_hi = 0;
  if (wg_live) {
    const int lo = p.window > 0 ? max(0, wg_first - p.window + 1) : 0;
    const int hi = p.causal ? min(p.T, wg_last + 1) : p.T;
    if (hi > lo) {
      it_lo = (lo - t_first) / FWD_BK;
      it_hi = (hi - 1 - t_first) / FWD_BK + 1;
    }
  }
  const int qp[2] = {row0 + 16 * wl + g + p.q_offset,
                     row0 + 16 * wl + g + 8 + p.q_offset};
  // a zero scale weighs every visible score the same; so does the least
  // normal one, which keeps a masked score's exponent at -inf
  const float scale_log2 =
      p.scale == 0.f ? FLT_MIN : p.scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32];
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l[2] = {0.f, 0.f};   // LSE: this thread's part of the fp32 row sum
  float lr[2] = {0.f, 0.f};  // this thread's part of the rounded row sum
  float alpha[2];
  uint32_t pa[4][4];         // P of the last tile as bf16 A fragments

  auto wait_k = [&](int it) {
    hop::mbar_wait(k_full0 + 8 * (it % ST), (it / ST) & 1);
  };
  auto wait_v = [&](int it) {
    hop::mbar_wait(v_full0 + 8 * (it % ST), (it / ST) & 1);
  };
  auto release_k = [&](int it) { hop::mbar_arrive(k_empty0 + 8 * (it % ST)); };
  auto release_v = [&](int it) { hop::mbar_arrive(v_empty0 + 8 * (it % ST)); };
  // S = Q K^T of tile it, issued as one commit group
  auto scores = [&](int it) {
    const uint32_t ks = base + KRING + (it % ST) * W::BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::wgmma_ss(s, kmajor<D>(qs, kk), kmajor<D>(ks, kk), kk);
    hop::wgmma_commit();
  };
  // O += P V of tile it, issued as one commit group
  auto pv = [&](int it) {
    const uint32_t vs = base + VRING + (it % ST) * W::BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_rs_tb(acc, pa[kk], mnmajor<D>(vs, kk), 1);
    hop::wgmma_commit();
  };
  // the softmax of tile it, the element mask only on a tile that some row
  // of this warpgroup does not see whole (the diagonal, a window's lower
  // edge, T)
  const bool up = scale_log2 > 0.f;
  auto softmax = [&](int it) {
    const int start = t_first + it * FWD_BK;
    const bool full = start + FWD_BK <= p.T &&
                      (!p.causal || start + FWD_BK - 1 <= wg_first) &&
                      (p.window <= 0 || wg_last - start < p.window);
    if (full && up)
      fwd_softmax<false, true, LSE>(p, s, m, l, alpha, start, qp,
                                    scale_log2, tig);
    else if (up)
      fwd_softmax<true, true, LSE>(p, s, m, l, alpha, start, qp, scale_log2,
                                   tig);
    else if (full)
      fwd_softmax<false, false, LSE>(p, s, m, l, alpha, start, qp,
                                     scale_log2, tig);
    else
      fwd_softmax<true, false, LSE>(p, s, m, l, alpha, start, qp,
                                    scale_log2, tig);
  };

  hop::mbar_wait(q_full, 0);
  int it = 0;
  for (; it < it_lo; ++it) {  // tiles no row of this warpgroup sees
    wait_k(it), release_k(it), wait_v(it), release_v(it);
  }
  if (it_lo < it_hi) {
    wait_k(it_lo);
    hop::wgmma_fence();
    scores(it_lo);
    hop::wgmma_wait<0>();
    hop::fence_operand(s);
    release_k(it_lo);
    softmax(it_lo);  // O is still 0: alpha is not needed
    pack_p(s, pa, lr);
    for (it = it_lo + 1; it < it_hi; ++it) {
      wait_k(it);
      wait_v(it - 1);
      hop::fence_operand(acc);
      hop::wgmma_fence();
      scores(it);
      pv(it - 1);
      hop::wgmma_wait<1>();  // S of tile it (P V of tile it - 1 may run)
      hop::fence_operand(s);
      release_k(it);
      softmax(it);
      hop::wgmma_wait<0>();
      hop::fence_operand(acc);
      release_v(it - 1);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
      lr[0] *= alpha[0];
      lr[1] *= alpha[1];
      pack_p(s, pa, lr);
    }
    wait_v(it_hi - 1);
    hop::fence_operand(acc);
    hop::wgmma_fence();
    pv(it_hi - 1);
    hop::wgmma_wait<0>();
    hop::fence_operand(acc);
    release_v(it_hi - 1);
    it = it_hi;
  }
  for (; it < ntiles; ++it) {
    wait_k(it), release_k(it), wait_v(it), release_v(it);
  }
  if (!wg_live) return;

  // normalise in registers by the rounded sum; lse = m ln 2 + ln l (m in
  // log2 units), -inf for a row that sees no key
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 1);
    lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 2);
    inv[r] = lr[r] == 0.f ? 0.f : 1.f / lr[r];  // no visible key -> 0
  }
  if constexpr (LSE) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = qp[r] - p.q_offset;
      if (tig == 0 && row < p.S)
        p.lse[((long long)b * p.H + h) * p.S + row] =
            l[r] == 0.f ? -INFINITY : m[r] * LN2 + logf(l[r]);
    }
  }
  // stage bf16 O in this warpgroup's Q tile (no product reads it any
  // more), swizzled as the tile, then 16-byte stores of whole rows
  unsigned char* ot = sbase + wg * W::BYTES;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(
          ot + swizzled<D>(16 * wl + g + 8 * r, 8 * n + 2 * tig)) =
          hop::pack_bf16(acc[4 * n + 2 * r] * inv[r],
                         acc[4 * n + 2 * r + 1] * inv[r]);
  }
  hop::bar_sync(1 + wg, 128);
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      (long long)row0 * p.o_ss + h * p.o_sh;
  for (int e = tid - 128 * wg; e < 64 * CPR; e += 128) {
    const int r = e / CPR, ch = e % CPR;
    if (row0 + r < p.S)
      *reinterpret_cast<uint4*>(og + r * p.o_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(ot + swizzled<D>(r, ch * 8));
  }
}

// The decode form: one block per (b, query head), at most DEC_ROWS query
// rows, one m16 tile of mma.sync (bf16 in, fp32 accumulate).  Warp w walks
// key tiles w, w + WARPS, ..., with its own m, l and accumulator and its
// own K tile and V tile, filled by cp.async: the K tile of its next key
// tile is in flight while it runs P V on this one, and the V tile while it
// runs the next S.  Then the warps' partial (m, l, acc) are combined in
// shared memory in warp order: the same bits on every call.
template <int D>
struct DecTile {
  // warps a block: each holds a K and a V tile of 64 keys, so the block's
  // shared memory stays under 70 KB (three blocks a multiprocessor)
  static constexpr int WARPS = D <= 64 ? 4 : 2;
  static constexpr int TILE = FWD_BK * D;  // elements of one K or V tile
  static constexpr int PITCH = D + 4;      // floats a staged accumulator row
};

// Shared memory of the decode block: the Q tile and each warp's K and V
// tiles; the combine reuses it for the warps' accumulators, m and l.  D 64:
// 67,584 bytes.
template <int D>
constexpr int fwd_decode_smem_bytes() {
  using DT = DecTile<D>;
  constexpr int tiles = (DEC_ROWS * D + DT::WARPS * 2 * DT::TILE) * 2;
  constexpr int combine = DT::WARPS * DEC_ROWS * (DT::PITCH + 2) * 4;
  return tiles > combine ? tiles : combine;
}

// S = Q K^T of one 64-key tile for the decode block's rows (one warp),
// masked (MASK only), and the online softmax in log2 units: s leaves as
// P, acc takes the factor of the new running max.  Lane l holds rows l / 4
// and l / 4 + 8, keys 8 nb + 2 (l % 4) + {0, 1} of block nb.
template <int D, bool MASK>
__device__ __forceinline__ void dec_scores(
    const Params& p, const __nv_bfloat16* ks, const uint32_t (&qf)[D / 16][4],
    float (&s)[FWD_BK / 8][4], float (&acc)[D / 8][4], float (&m)[2],
    float (&l)[2], int start, float scale_log2, int lane) {
  constexpr int NB_S = FWD_BK / 8;  // 8-key column blocks of S
  const int g = lane >> 2, tig = lane & 3;
  const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb)
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < NB_S; nb += 2) {
      // keys nb*8 .. nb*8+15, dims kk*16 .. kk*16+15: two B fragments
      uint32_t bf[4];
      mma::ldmatrix_x4(bf, ks + mma::tile_off<D>(nb * 8 + r8 + (mi >> 1) * 8,
                                                 2 * kk + (mi & 1)));
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
      mma::mma_16816(s[nb], qf[kk], b0);
      mma::mma_16816(s[nb + 1], qf[kk], b1);
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = s[nb][i] * scale_log2;
      if constexpr (MASK) {
        const int t = start + nb * 8 + tig * 2 + (i & 1);
        const int qp = g + (i >> 1) * 8 + p.q_offset;
        bool ok = t < p.T;
        if (p.causal) ok = ok && t <= qp;
        if (p.window > 0) ok = ok && qp - t < p.window;
        v = ok ? v : -INFINITY;
      }
      s[nb][i] = v;
      mx[i >> 1] = fmaxf(mx[i >> 1], v);
    }
  }
  float alpha[2], base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    base[r] = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet
    alpha[r] = exp2f(m[r] - base[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nb][i] = exp2f(s[nb][i] - base[i >> 1]);  // masked -> 0
      l[i >> 1] += s[nb][i];
    }
  }
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    acc[nb][0] *= alpha[0];
    acc[nb][1] *= alpha[0];
    acc[nb][2] *= alpha[1];
    acc[nb][3] *= alpha[1];
  }
}

// O += P V of one 64-key tile: two adjacent 8-key blocks of S are one A
// fragment, taken as a bf16 pair (hi, and lo the rest: ~16 of P's
// mantissa bits) as the wgmma form takes it; V is read as stored
// ([key][dim]) through ldmatrix.trans
template <int D>
__device__ __forceinline__ void dec_pv(const __nv_bfloat16* vs,
                                       const float (&s)[FWD_BK / 8][4],
                                       float (&acc)[D / 8][4], int lane) {
  const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < FWD_BK / 16; ++kk) {
    const float c[8] = {s[2 * kk][0],     s[2 * kk][1],
                        s[2 * kk][2],     s[2 * kk][3],
                        s[2 * kk + 1][0], s[2 * kk + 1][1],
                        s[2 * kk + 1][2], s[2 * kk + 1][3]};
    uint32_t hi[4], lo[4];
    hop::accumulator_to_a_split(c, 0, hi, lo);
#pragma unroll
    for (int nb = 0; nb < D / 8; nb += 2) {
      uint32_t bf[4];
      mma::ldmatrix_x4_trans(
          bf,
          vs + mma::tile_off<D>(kk * 16 + r8 + (mi & 1) * 8, nb + (mi >> 1)));
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
      mma::mma_16816(acc[nb], hi, b0);
      mma::mma_16816(acc[nb + 1], hi, b1);
      mma::mma_16816(acc[nb], lo, b0);
      mma::mma_16816(acc[nb + 1], lo, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * DecTile<D>::WARPS, 3)
    flash_fwd_decode_kernel(const Params p) {
  using DT = DecTile<D>;
  constexpr int NW = DT::WARPS, CPR = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r8 = lane & 7, mi = lane >> 3, g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* ks = qs + DEC_ROWS * D + warp * 2 * DT::TILE;
  __nv_bfloat16* vs = ks + DT::TILE;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / p.group;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // keys any row can see, in whole tiles; warp w takes tiles w, w + NW, ..
  const int first_pos = p.q_offset;
  const int last_pos = p.S - 1 + p.q_offset;
  const int kv_hi = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int kv_lo = p.window > 0 ? max(0, first_pos - p.window + 1) : 0;
  const int t_first = kv_lo / FWD_BK * FWD_BK;
  const int ntiles =
      kv_hi > t_first ? (kv_hi - t_first + FWD_BK - 1) / FWD_BK : 0;
  const int mine = warp < ntiles ? (ntiles - warp + NW - 1) / NW : 0;
  auto tile_start = [&](int i) { return t_first + (warp + i * NW) * FWD_BK; };
  // keys past T are zero-filled, never read
  auto load = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                  long long stride, int i) {
    const int t0 = tile_start(i);
    mma::load_tile<FWD_BK, D>(dst, src + (long long)t0 * stride, stride,
                              p.T - t0, D, true, lane, 32);
  };

  // commit groups: (Q, K tile 0), (V tile 0), then per tile the next K
  // tile and the next V tile (empty past the last), so wait<1> always
  // means "the tile about to be read landed"
  mma::load_tile<DEC_ROWS, D>(qs, q + b * p.q_sb + h * p.q_sh, p.q_ss, p.S,
                              D, true, tid, 32 * NW);
  if (mine > 0) load(ks, kbase, p.k_st, 0);
  mma::cp_async_commit();
  if (mine > 0) load(vs, vbase, p.v_st, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();
  __syncthreads();  // every thread's part of Q landed

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma::ldmatrix_x4(qf[kk], qs + mma::tile_off<D>(r8 + (mi & 1) * 8,
                                                   2 * kk + (mi >> 1)));
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  const float scale_log2 = p.scale * LOG2E;

  for (int i = 0; i < mine; ++i) {
    if (i > 0) mma::cp_async_wait<1>();  // K tile i (V tile i may fly)
    __syncwarp();
    const int start = tile_start(i);
    // the element mask only on a tile some row does not see whole
    const bool full = start + FWD_BK <= p.T &&
                      (!p.causal || start + FWD_BK - 1 <= first_pos) &&
                      (p.window <= 0 || last_pos - start < p.window);
    float s[FWD_BK / 8][4];
    if (full)
      dec_scores<D, false>(p, ks, qf, s, acc, m, l, start, scale_log2, lane);
    else
      dec_scores<D, true>(p, ks, qf, s, acc, m, l, start, scale_log2, lane);
    __syncwarp();  // every lane is done with the K tile
    if (i + 1 < mine) load(ks, kbase, p.k_st, i + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // V tile i
    __syncwarp();
    dec_pv<D>(vs, s, acc, lane);
    __syncwarp();  // and with the V tile
    if (i + 1 < mine) load(vs, vbase, p.v_st, i + 1);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<0>();

  // the combine, over the tiles' shared memory once every warp is done
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem_raw);  // [NW][16][PITCH]
  float* ms = part + NW * DEC_ROWS * DT::PITCH;      // [NW][16]
  float* ls = ms + NW * DEC_ROWS;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(
          part + (warp * DEC_ROWS + g + 8 * r) * DT::PITCH + nb * 8 +
          2 * tig) = make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ms[warp * DEC_ROWS + g + 8 * r] = m[r];
      ls[warp * DEC_ROWS + g + 8 * r] = l[r];
    }
  }
  __syncthreads();
  // row `row`, 8 columns a thread: O = sum_w 2^(m_w - M) acc_w / L with
  // L = sum_w 2^(m_w - M) l_w, warps in order; lse = M ln 2 + ln L
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  for (int e = tid; e < p.S * CPR; e += 32 * NW) {
    const int row = e / CPR, ch = e % CPR;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, ms[w * DEC_ROWS + row]);
    float wt[NW], L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = ms[w * DEC_ROWS + row];
      wt[w] = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      L += wt[w] * ls[w * DEC_ROWS + row];
    }
    const float inv = L == 0.f ? 0.f : 1.f / L;  // no visible key -> 0
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* src = part + (w * DEC_ROWS + row) * DT::PITCH + ch * 8;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      out[0] += wt[w] * lo.x, out[1] += wt[w] * lo.y;
      out[2] += wt[w] * lo.z, out[3] += wt[w] * lo.w;
      out[4] += wt[w] * hi.x, out[5] += wt[w] * hi.y;
      out[6] += wt[w] * hi.z, out[7] += wt[w] * hi.w;
    }
    *reinterpret_cast<uint4*>(o + b * p.o_sb + (long long)row * p.o_ss +
                              h * p.o_sh + ch * 8) =
        make_uint4(mma::pack_bf16(out[0] * inv, out[1] * inv),
                   mma::pack_bf16(out[2] * inv, out[3] * inv),
                   mma::pack_bf16(out[4] * inv, out[5] * inv),
                   mma::pack_bf16(out[6] * inv, out[7] * inv));
    if (p.lse != nullptr && ch == 0)
      p.lse[((long long)b * p.H + h) * p.S + row] =
          L == 0.f ? -INFINITY : mx * LN2 + logf(L);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
// what the C entry returns besides a CUDA error
constexpr int ERR_CLUSTER = -2;  // no cluster of `group` blocks fits the card
constexpr int ERR_MAP = -3;      // a TMA tensor map could not be encoded

struct Work {
  const int* dkdv_items;  // (n_dkdv, 3) int32 on the card
  int n_dkdv;
  const int* dq_items;    // (n_dq, 3)
  int n_dq;
};

cudaError_t launch_preprocess(const BwdParams& p, int B, int D,
                              cudaStream_t stream) {
  const long long rows = (long long)B * p.H * p.S_pad;
  flash_bwd_preprocess_kernel<<<(rows + PRE_WARPS - 1) / PRE_WARPS,
                                32 * PRE_WARPS, 0, stream>>>(p, B, D);
  return cudaGetLastError();
}

// whether a cluster of g dK / dV blocks fits on the card, asked once per
// (head dim, g)
template <int D>
bool cluster_fits(const cudaLaunchConfig_t& cfg, int g) {
  static int known[17];  // 0 not asked, 1 fits, -1 does not
  if (g < 1 || g > 16) return false;
  if (known[g] == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, flash_bwd_dkdv_wgmma_kernel<D>, &cfg);
    known[g] = err == cudaSuccess && n > 0 ? 1 : -1;
    cudaGetLastError();  // a refused query leaves no error behind
  }
  return known[g] > 0;
}

template <int D>
int launch_bwd_wgmma(const BwdParams& p, int B, int which, const Work& w,
                     cudaStream_t stream) {
  using W = WgTile<D>;
  cudaError_t err = cudaSuccess;
  if (which & 1 && (err = launch_preprocess(p, B, D, stream)) != cudaSuccess)
    return err;
  if (!(which & 6)) return cudaSuccess;
  // the maps are encoded at each call from the tensors' own strides
  const int K = p.H / p.group;
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::bshd_map(&mq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh,
                     W::PANEL, BWD_BQ) ||
      !hop::bshd_map(&mk, p.k, B, p.T, K, D, p.k_sb, p.k_st, p.k_sh,
                     W::PANEL, BWD_BK) ||
      !hop::bshd_map(&mv, p.v, B, p.T, K, D, p.v_sb, p.v_st, p.v_sh,
                     W::PANEL, BWD_BK) ||
      !hop::bshd_map(&mdo, p.dout, B, p.S, p.H, D, p.do_sb, p.do_ss,
                     p.do_sh, W::PANEL, BWD_BQ))
    return ERR_MAP;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(WG_THREADS);
  cfg.stream = stream;
  if (which & 2 && w.n_dkdv > 0) {
    constexpr int smem = wg_dkdv_smem_bytes<D>();
    auto kernel = flash_bwd_dkdv_wgmma_kernel<D>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess && p.group > 8)  // past the portable 8
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = p.group;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.H, B, w.n_dkdv);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    if (!cluster_fits<D>(cfg, p.group)) return ERR_CLUSTER;
    err = cudaLaunchKernelEx(&cfg, kernel, p, w.dkdv_items, mq, mk, mv, mdo);
    if (err != cudaSuccess) return err;
  }
  if (which & 4 && w.n_dq > 0) {
    constexpr int smem = wg_dq_smem_bytes<D>();
    auto kernel = flash_bwd_dq_wgmma_kernel<D>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(p.H, B, w.n_dq);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = nullptr;
    cfg.numAttrs = 0;
    err = cudaLaunchKernelEx(&cfg, kernel, p, w.dq_items, mq, mk, mv, mdo);
  }
  return err;
}

int launch_bwd(const BwdParams& p, int B, int D, int which, const Work& w,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bwd_wgmma<16>(p, B, which, w, stream);
    case 32: return launch_bwd_wgmma<32>(p, B, which, w, stream);
    case 64: return launch_bwd_wgmma<64>(p, B, which, w, stream);
    case 96: return launch_bwd_wgmma<96>(p, B, which, w, stream);
    case 128: return launch_bwd_wgmma<128>(p, B, which, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dynamic shared memory and the kernel of a backward pass (2 dK / dV,
// 4 dQ) at head dim D
int bwd_kernel(int pass, int D, const void** fn) {
  switch (D * 8 + pass) {
#define BWD_WG(d)                                                        \
  case d * 8 + 2:                                                        \
    *fn = reinterpret_cast<const void*>(flash_bwd_dkdv_wgmma_kernel<d>); \
    return wg_dkdv_smem_bytes<d>();                                      \
  case d * 8 + 4:                                                        \
    *fn = reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<d>);   \
    return wg_dq_smem_bytes<d>();
    BWD_WG(16) BWD_WG(32) BWD_WG(64) BWD_WG(96) BWD_WG(128)
#undef BWD_WG
    default:
      *fn = nullptr;
      return -1;
  }
}

// the forward's kernels, by the codes of flash_attention.py ·
// FORWARD_VARIANTS: flash_fwd_kernel (fp32, head dim 24, unaligned rows),
// flash_fwd_wgmma_kernel (bf16, S > DEC_ROWS), flash_fwd_decode_kernel
// (bf16, S <= DEC_ROWS)
constexpr int FWD_SCALAR = 0;
constexpr int FWD_WGMMA = 1;
constexpr int FWD_DECODE = 2;

// a kernel's dynamic shared memory limit, raised once per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int D>
int launch_fwd_wgmma(const Params& p, int B, int K, cudaStream_t stream) {
  using W = WgTile<D>;
  // the maps are encoded at each call from the tensors' own strides; boxes
  // of 64 rows (a warpgroup's queries, a tile's keys)
  CUtensorMap mq, mk, mv;
  if (!hop::bshd_map(&mq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh,
                     W::PANEL, 64) ||
      !hop::bshd_map(&mk, p.k, B, p.T, K, D, p.k_sb, p.k_st, p.k_sh,
                     W::PANEL, FWD_BK) ||
      !hop::bshd_map(&mv, p.v, B, p.T, K, D, p.v_sb, p.v_st, p.v_sh,
                     W::PANEL, FWD_BK))
    return ERR_MAP;
  // the kernel that keeps the fp32 row sum for lse, or the one that does
  // not need it
  constexpr int smem = fwd_wgmma_smem_bytes<D>();
  const bool lse = p.lse != nullptr;
  static bool ready[2] = {false, false};
  const cudaError_t err =
      lse ? allow_smem(flash_fwd_wgmma_kernel<D, true>, smem, ready[1])
          : allow_smem(flash_fwd_wgmma_kernel<D, false>, smem, ready[0]);
  if (err != cudaSuccess) return err;
  // (b, head) pairs a band: as many as keep FWD_BAND_BYTES of K and V (a
  // kv head's 4 T D bytes, shared by `group` query heads)
  const long long kv_bytes = 4LL * p.T * D;
  const long long fit = FWD_BAND_BYTES * p.group / kv_bytes;
  const int band = static_cast<int>(
      std::min<long long>(B * p.H, std::max<long long>(1, fit)));
  const int nq = (p.S + FWD_ROWS - 1) / FWD_ROWS;
  if (lse)
    flash_fwd_wgmma_kernel<D, true><<<nq * B * p.H, FWD_THREADS, smem,
                                      stream>>>(p, band, mq, mk, mv);
  else
    flash_fwd_wgmma_kernel<D, false><<<nq * B * p.H, FWD_THREADS, smem,
                                       stream>>>(p, band, mq, mk, mv);
  return cudaGetLastError();
}

template <int D>
int launch_fwd_decode(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = fwd_decode_smem_bytes<D>();
  static bool ready = false;
  const cudaError_t err = allow_smem(flash_fwd_decode_kernel<D>, smem, ready);
  if (err != cudaSuccess) return err;
  flash_fwd_decode_kernel<D><<<B * p.H, 32 * DecTile<D>::WARPS, smem,
                               stream>>>(p);
  return cudaGetLastError();
}

// the tensor-core forward of `variant` at head dim D
int launch_fwd(const Params& p, int B, int K, int D, int variant,
               cudaStream_t stream) {
  if (variant == FWD_WGMMA) {
    switch (D) {
      case 16: return launch_fwd_wgmma<16>(p, B, K, stream);
      case 32: return launch_fwd_wgmma<32>(p, B, K, stream);
      case 64: return launch_fwd_wgmma<64>(p, B, K, stream);
      case 96: return launch_fwd_wgmma<96>(p, B, K, stream);
      case 128: return launch_fwd_wgmma<128>(p, B, K, stream);
    }
  } else if (variant == FWD_DECODE) {
    switch (D) {
      case 16: return launch_fwd_decode<16>(p, B, stream);
      case 32: return launch_fwd_decode<32>(p, B, stream);
      case 64: return launch_fwd_decode<64>(p, B, stream);
      case 96: return launch_fwd_decode<96>(p, B, stream);
      case 128: return launch_fwd_decode<128>(p, B, stream);
    }
  }
  return cudaErrorInvalidValue;
}

// dynamic shared memory, kernel and threads of a tensor-core forward form
// at head dim D (lse: the wgmma kernel that writes it)
int fwd_kernel(int variant, int D, bool lse, const void** fn, int* threads) {
  switch (D * 4 + variant) {
#define FWD_TC(d)                                                       \
  case d * 4 + FWD_WGMMA:                                               \
    *fn = lse ? reinterpret_cast<const void*>(                          \
                    flash_fwd_wgmma_kernel<d, true>)                    \
              : reinterpret_cast<const void*>(                          \
                    flash_fwd_wgmma_kernel<d, false>);                  \
    *threads = FWD_THREADS;                                             \
    return fwd_wgmma_smem_bytes<d>();                                   \
  case d * 4 + FWD_DECODE:                                              \
    *fn = reinterpret_cast<const void*>(flash_fwd_decode_kernel<d>);    \
    *threads = 32 * DecTile<d>::WARPS;                                  \
    return fwd_decode_smem_bytes<d>();
    FWD_TC(16) FWD_TC(32) FWD_TC(64) FWD_TC(96) FWD_TC(128)
#undef FWD_TC
    default:
      *fn = nullptr;
      return -1;
  }
}

}  // namespace


// Dynamic shared memory of one launch of a tensor-core forward form at head
// dim D in bytes (variant 1 flash_fwd_wgmma_kernel, 2
// flash_fwd_decode_kernel), -1 for a form or head dim that has none.
extern "C" int flash_attention_fwd_smem_bytes(int variant, int D) {
  const void* fn;
  int threads;
  return fwd_kernel(variant, D, false, &fn, &threads);
}

// What the compiled kernel of a tensor-core forward form (variant 1, 2) at
// head dim D (lse: the one that writes lse) asks of a multiprocessor,
// from cudaFuncGetAttributes: out[0]
// registers a thread, out[1] static shared memory, out[2] the dynamic
// shared memory of its launch, out[3] local memory a thread (spills), and
// out[4] how many of its blocks the card holds at once.  Returns the CUDA
// error (0 on success).
extern "C" int flash_attention_fwd_attributes(int variant, int D, int lse,
                                              int* out) {
  const void* fn;
  int threads;
  const int smem = fwd_kernel(variant, D, lse != 0, &fn, &threads);
  if (smem < 0) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(a.localSizeBytes);
  int dev = 0, sms = 0, n = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                           smem)) !=
          cudaSuccess)
    return err;
  out[4] = n * sms;
  return cudaSuccess;
}

// q: (B,S,H,D), k and v: (B,T,K,D), o: (B,S,H,D), each with unit stride in
// D and the other strides given in elements.  dtype: 0 = float32,
// 1 = bfloat16.  lse: null, or a contiguous fp32 (B,H,S) that receives
// each row's natural-log logsumexp of the scaled visible scores (-inf for
// a row that sees no key).  variant: the kernel to launch, as
// flash_attention.py · forward_variant chose it: 0 flash_fwd_kernel, 1
// flash_fwd_wgmma_kernel, 2 flash_fwd_decode_kernel.  The tensor-core forms
// take bf16, D 16, 32, 64, 96 or 128, T >= 1 and every row of q, k, v and
// o 16-byte aligned, decode at most 16 query rows; a call its variant does
// not take is refused, never sent to another kernel.  Returns the CUDA
// error of the launch (0 on success), -3 if a tensor map cannot be
// encoded.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int K, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int window,
    int q_offset, void* lse, int variant, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    o,    S,     T,      H,      H / K,
                 q_sb, q_ss, q_sh, k_sb, k_st,  k_sh,   v_sb,   v_st,
                 v_sh, o_sb, o_ss, o_sh, scale, causal, window, q_offset,
                 static_cast<float*>(lse)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == FWD_SCALAR) {
    const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, B * H);
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == 1)
      err = launch<__nv_bfloat16>(p, D, grid, st);
    else if (dtype == 0)
      err = launch<float>(p, D, grid, st);
    return static_cast<int>(err);
  }
  const bool aligned = mma::aligned16(q, q_sb, q_ss, q_sh) &&
                       mma::aligned16(k, k_sb, k_st, k_sh) &&
                       mma::aligned16(v, v_sb, v_st, v_sh) &&
                       mma::aligned16(o, o_sb, o_ss, o_sh);
  if (dtype != 1 || T <= 0 || !aligned ||
      (variant == FWD_DECODE && S > DEC_ROWS))
    return cudaErrorInvalidValue;
  return launch_fwd(p, B, K, D, variant, st);
}

// Dynamic shared memory of one backward launch in bytes at head dim D: pass
// 2 the dK / dV kernel, pass 4 the dQ kernel of the variant that serves D;
// -1 otherwise.
extern "C" int flash_attention_bwd_smem_bytes(int pass, int D) {
  const void* fn;
  return bwd_kernel(pass, D, &fn);
}

// What the compiled kernel of a backward pass (1 the preprocess, 2 dK / dV,
// 4 dQ) at head dim D asks of a multiprocessor, from
// cudaFuncGetAttributes: out[0] registers a thread (at launch), out[1]
// static shared memory, out[2] the dynamic shared memory of its launch,
// out[3] local memory a thread (spills), and out[4] how many of its blocks
// the card holds at once (cudaOccupancy*: the dK / dV pass in clusters of
// `group`).
// Returns the CUDA error (0 on success).
extern "C" int flash_attention_bwd_attributes(int pass, int D, int group,
                                              int* out) {
  const void* fn = reinterpret_cast<const void*>(flash_bwd_preprocess_kernel);
  int smem = 0, threads = 32 * PRE_WARPS;
  if (pass != 1) {
    if ((smem = bwd_kernel(pass, D, &fn)) < 0) return cudaErrorInvalidValue;
    threads = WG_THREADS;
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(a.localSizeBytes);
  int dev = 0, sms = 0, n = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (pass == 2) {
    if (group > 8)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = group;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(group, 1, 1);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    out[4] = n * group;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                        smem);
    out[4] = n * sms;
  }
  return err;
}

// The backward of flash_attention_fwd's tensor-core path: q, k, v, o as
// there, dout (B,S,H,D) the output's gradient, lse the forward's (B,H,S),
// scratch an fp32 (2, B, H, S_pad) buffer (S_pad = S rounded up to 64), dq
// (B,S,H,D), dk and dv (B,T,K,D); all bf16 but lse and scratch, every row
// 16-byte aligned, strides in elements.  The work lists come from
// flash_attention.py · backward_plan as int32 (n, 3) tables on the card:
// dK / dV items (key tile, first query tile, query tiles), dQ items (query
// tile, first key tile, key tiles), heaviest first; the dK / dV pass runs
// in clusters of `cluster` = H / K blocks.  which: 7 runs the three
// passes (1 the preprocess, 2 dK / dV, 4 dQ; one alone is for timing).
// Returns the CUDA error of the launches (0 on success), -2 if no cluster
// of H / K blocks fits the card, -3 if a tensor map cannot be encoded.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int K, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dq_sb, long long dq_ss,
    long long dq_sh, long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh, float scale,
    int causal, int window, int q_offset, int which, const void* dkdv_items,
    int n_dkdv, const void* dq_items, int n_dq, int cluster, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      D % 16 != 0 || B > 65535 || which <= 0 || which > 7 ||
      n_dkdv > 65535 || n_dq > 65535 || cluster != H / K)
    return cudaErrorInvalidValue;
  if (!(mma::aligned16(q, q_sb, q_ss, q_sh) &&
        mma::aligned16(k, k_sb, k_st, k_sh) &&
        mma::aligned16(v, v_sb, v_st, v_sh) &&
        mma::aligned16(o, o_sb, o_ss, o_sh) &&
        mma::aligned16(dout, do_sb, do_ss, do_sh) &&
        mma::aligned16(dq, dq_sb, dq_ss, dq_sh) &&
        mma::aligned16(dk, dk_sb, dk_st, dk_sh) &&
        mma::aligned16(dv, dv_sb, dv_st, dv_sh)))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  BwdParams p{};
  p.q = static_cast<const bf*>(q);
  p.k = static_cast<const bf*>(k);
  p.v = static_cast<const bf*>(v);
  p.o = static_cast<const bf*>(o);
  p.dout = static_cast<const bf*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.S_pad = (S + BWD_BQ - 1) / BWD_BQ * BWD_BQ;
  p.lse2 = static_cast<float*>(scratch);
  p.delta = p.lse2 + (long long)B * H * p.S_pad;
  p.dq = static_cast<bf*>(dq);
  p.dk = static_cast<bf*>(dk);
  p.dv = static_cast<bf*>(dv);
  p.S = S, p.T = T, p.H = H, p.group = H / K;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_st = k_st, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_st = v_st, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh;
  p.do_sb = do_sb, p.do_ss = do_ss, p.do_sh = do_sh;
  p.dq_sb = dq_sb, p.dq_ss = dq_ss, p.dq_sh = dq_sh;
  p.dk_sb = dk_sb, p.dk_st = dk_st, p.dk_sh = dk_sh;
  p.dv_sb = dv_sb, p.dv_st = dv_st, p.dv_sh = dv_sh;
  p.scale = scale, p.causal = causal, p.window = window;
  p.q_offset = q_offset;
  const Work w{static_cast<const int*>(dkdv_items), n_dkdv,
               static_cast<const int*>(dq_items), n_dq};
  return launch_bwd(p, B, D, which, w, static_cast<cudaStream_t>(stream));
}
