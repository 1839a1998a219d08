// Flash attention for Hopper (sm_90a), forward and backward, bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py ·
// flash_attention (body _kernel, wrapper flash_attention): GQA attention
// with an online softmax in fp32 across KV tiles, causal and sliding-window
// masks on absolute positions (q_offset shifts the queries), keys past T
// masked, and rows that see no key written as 0.
//
// What bounds it on an H100.  At the serving shapes (B=8, S=T=512, H=14,
// K=2, D=64, causal, bf16) the work is ~3.8 GFLOP against ~17 MB of q, k,
// v and o: about 225 FLOP per byte, just under the ~295 at which the bf16
// tensor cores become the limit, so the bound is the bytes (~5 us at
// 3.35 TB/s).  Reaching it needs the tensor cores and tiles that read each
// K/V byte from device memory about once per query block.
//
// Two kernels, one function:
//  * flash_mma_kernel, for bf16 with D a multiple of 16 and every row of
//    q, k, v and o 16-byte aligned (the serving path), with
//    FlashAttention-2's techniques on mma.sync m16n8k16 (bf16 in, fp32
//    accumulate).  The first version of this kernel loaded K/V with
//    plain loads between two barriers, transposed V by hand, read Q in
//    2-byte pairs and fragments with 32-bit shared loads, masked every
//    element of every tile, stored 2 bytes at a time and launched causal
//    blocks lightest first: 0.0730 ms at the serving shape, 3.7x SDPA.
//    What it does now, against each of those:
//    - K/V tiles of 64 keys go through a ring of two shared-memory stages
//      filled by cp.async.cg 16-byte copies (commit / wait groups): tile
//      j + 1 is in flight while tile j is computed.  Q is staged once
//      through the same copies.  Keys past T are zero-filled.
//    - Shared tiles are stored as they arrive, rows XOR-swizzled by 16-byte
//      chunk (mma_utils.cuh), no padding; fragments come from ldmatrix.x4
//      for Q and K and ldmatrix.x4.trans for V, so V is never transposed.
//    - Each warp owns 16 query rows; S = Q K^T stays in registers and is
//      reused in place as the A operand of P V, so P never touches shared
//      memory.
//    - The KV loop is split per warp: a tile that no row of the warp masks
//      runs with no mask code; only the tiles that cross the causal
//      diagonal, the window's lower edge or T take it; a tile every row
//      masks is skipped.
//    - Causal grids launch the heaviest query blocks first (grid y counts
//      down), so the longest blocks do not form the grid's tail.
//    - O is normalised in registers, staged through the Q tile and written
//      with 16-byte stores.
//    BLOCK_Q is 64 (4 warps of 16 rows), measured against 128 (8 warps)
//    at the serving shape, and the ring has two stages, measured against
//    three (PERF.md section 6 has both readings).  At the serving shape on
//    an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 0.0306 ms, against
//    0.0730 ms before, SDPA's 0.0199 ms and a bound of 0.0050 ms.  Not done
//    here: wgmma, TMA and warp specialisation (ROADMAP Queue 2).
//  * flash_fwd_kernel, for fp32, for head dims the mma tiles do not cover
//    (24), and for K/V rows not 16-byte aligned (strided views): scalar
//    fp32 FMAs through shared memory, any strides.  GROUP threads
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
//  * Under a gradient the tensor-core kernel also writes each row's
//    logsumexp of the scaled scores, lse = m ln 2 + ln l in natural-log
//    units (m is kept in log2 units, scale_log2), fp32 (B, H, S), -inf for
//    a row that sees no key.  Decode over one block of a cross K/V cache
//    cut over the model ranks asks both kernels for it (lse = m + ln l in
//    the fp32 kernel, whose m is in natural units), so the ranks' partial
//    softmaxes can be combined; other serving passes no lse.
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
#include <math.h>
#include <stdint.h>

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
// tensor-core path (bf16, D % 16 == 0, every row of q, k, v, o 16-byte
// aligned)
// ---------------------------------------------------------------------------
constexpr int MMA_BK = 64;      // keys per K / V tile
// K / V tiles in flight.  A third stage lost to two at the serving shape
// (PERF.md section 6): it costs shared memory and registers, and a block
// of 64 rows visits at most 8 tiles.
constexpr int MMA_STAGES = 2;
// 4 warps of 16 query rows: BLOCK_Q 64.  8 warps (128 rows) lost at the
// serving shape (PERF.md section 6): half as many blocks leave a ragged
// last wave on 132 SMs, and a causal block carries twice the diagonal.
constexpr int MMA_WARPS = 4;
constexpr int MMA_BQ = 16 * MMA_WARPS;    // query rows per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;

template <int D>
constexpr int mma_smem_bytes() {
  return (MMA_BQ * D + MMA_STAGES * 2 * MMA_BK * D) * 2;
}

// One K / V tile for one warp's 16 query rows: S = Q K^T, mask (MASK only),
// online softmax in log2 units, O += P V with P reused from registers as
// the A operand.  Lane l holds rows g = l/4 and g + 8 of the warp.
template <int D, bool MASK>
__device__ __forceinline__ void flash_tile(
    const Params& p, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
    const uint32_t (&qf)[D / 16][4], float (&acc)[D / 8][4], float (&m)[2],
    float (&l)[2], int start, int row0, float scale_log2, int lane) {
  constexpr int NB_S = MMA_BK / 8;  // 8-key column blocks of S
  constexpr int NB_O = D / 8;       // 8-dim column blocks of O
  const int g = lane >> 2, tig = lane & 3;
  const int r8 = lane & 7, mi = lane >> 3;

  float s[NB_S][4];
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb)
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < NB_S; nb += 2) {
      // keys nb*8 .. nb*8+15, dims kk*16 .. kk*16+15: two B fragments
      uint32_t b[4];
      mma::ldmatrix_x4(b, ks + mma::tile_off<D>(nb * 8 + r8 + (mi >> 1) * 8,
                                                2 * kk + (mi & 1)));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
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
        const int qp = row0 + g + (i >> 1) * 8 + p.q_offset;
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
  for (int nb = 0; nb < NB_O; ++nb) {
    acc[nb][0] *= alpha[0];
    acc[nb][1] *= alpha[0];
    acc[nb][2] *= alpha[1];
    acc[nb][3] *= alpha[1];
  }
  // O += P V: two adjacent 8-key blocks of S are one A fragment; V is read
  // as stored ([key][dim]) through ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < MMA_BK / 16; ++kk) {
    const uint32_t af[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nb = 0; nb < NB_O; nb += 2) {
      uint32_t b[4];
      mma::ldmatrix_x4_trans(
          b, vs + mma::tile_off<D>(kk * 16 + r8 + (mi & 1) * 8, nb + (mi >> 1)));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma::mma_16816(acc[nb], af, b0);
      mma::mma_16816(acc[nb + 1], af, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_mma_kernel(const Params p) {
  static_assert(D % 16 == 0, "tensor-core path needs D % 16 == 0");
  constexpr int BQ = MMA_BQ;
  constexpr int THREADS = MMA_THREADS;
  constexpr int TILE = MMA_BK * D;  // elements of one K or V tile
  constexpr int NB_O = D / 8;
  constexpr int CPR = D / 8;        // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Q tile (BQ x D), reused for O; then MMA_STAGES x (K tile, V tile)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + BQ * D;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);

  // causal: the heaviest query blocks (most KV tiles) are launched first
  const int qb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / p.group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r8 = lane & 7, mi = lane >> 3, g = lane >> 2, tig = lane & 3;
  const int q_block0 = qb * BQ;
  const int row0 = q_block0 + warp * 16;  // this warp's first query row

  const __nv_bfloat16* qg =
      q + b * p.q_sb + (long long)q_block0 * p.q_ss + h * p.q_sh;
  const __nv_bfloat16* kbase = k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = v + b * p.v_sb + kvh * p.v_sh;

  // keys any row of this block can see, in whole tiles
  const int first_pos = q_block0 + p.q_offset;
  const int last_pos = min(q_block0 + BQ, p.S) - 1 + p.q_offset;
  const int kv_hi = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int kv_lo = p.window > 0 ? max(0, first_pos - p.window + 1) : 0;
  const int t_first = kv_lo / MMA_BK * MMA_BK;
  const int ntiles =
      kv_hi > t_first ? (kv_hi - t_first + MMA_BK - 1) / MMA_BK : 0;

  // keys past T are zero-filled, never read
  auto load_kv = [&](int tile, int stage) {
    const int t0 = t_first + tile * MMA_BK;
    __nv_bfloat16* ks = kvs + stage * 2 * TILE;
    mma::load_tile<MMA_BK, D>(ks, kbase + (long long)t0 * p.k_st, p.k_st,
                              p.T - t0, D, true, tid, THREADS);
    mma::load_tile<MMA_BK, D>(ks + TILE, vbase + (long long)t0 * p.v_st,
                              p.v_st, p.T - t0, D, true, tid, THREADS);
  };

  // groups in flight: Q, then K / V tiles 0 .. MMA_STAGES - 2; every step
  // commits one group (empty past the last tile), so wait<MMA_STAGES - 1>
  // always means "this tile landed"
  mma::load_tile<BQ, D>(qs, qg, p.q_ss, p.S - q_block0, D, true, tid, THREADS);
  mma::cp_async_commit();
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s, s);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<MMA_STAGES - 1>();
  __syncthreads();

  uint32_t qf[D / 16][4];  // this warp's Q fragments, kept for every tile
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma::ldmatrix_x4(qf[kk], qs + mma::tile_off<D>(warp * 16 + r8 + (mi & 1) * 8,
                                                   2 * kk + (mi >> 1)));

  float acc[NB_O][4];
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  const float scale_log2 = p.scale * 1.4426950408889634f;

  const bool warp_live = row0 < p.S;
  const int warp_first = row0 + p.q_offset;
  const int warp_last = min(row0 + 15, p.S - 1) + p.q_offset;

  for (int it = 0; it < ntiles; ++it) {
    // tiles it + 1 .. are copied while tile it is computed
    const int next = it + MMA_STAGES - 1;
    if (next < ntiles) load_kv(next, next % MMA_STAGES);
    mma::cp_async_commit();
    mma::cp_async_wait<MMA_STAGES - 1>();
    __syncthreads();
    const int start = t_first + it * MMA_BK;
    const __nv_bfloat16* ks = kvs + (it % MMA_STAGES) * 2 * TILE;
    if (warp_live) {
      // a tile every row of this warp masks contributes nothing; only the
      // tiles that cross the diagonal, the window's lower edge or T take
      // the mask
      const bool skip =
          (p.causal && start > warp_last) ||
          (p.window > 0 && start + MMA_BK - 1 <= warp_first - p.window);
      const bool full =
          start + MMA_BK <= p.T &&
          (!p.causal || start + MMA_BK - 1 <= warp_first) &&
          (p.window <= 0 || warp_last - start < p.window);
      if (!skip && full)
        flash_tile<D, false>(p, ks, ks + TILE, qf, acc, m, l, start, row0,
                             scale_log2, lane);
      else if (!skip)
        flash_tile<D, true>(p, ks, ks + TILE, qf, acc, m, l, start, row0,
                            scale_log2, lane);
    }
    __syncthreads();  // this stage is refilled MMA_STAGES tiles on
  }
  mma::cp_async_wait<0>();

  // normalise in registers, stage this warp's rows of O in its own rows of
  // the Q tile (read by no other warp), then 16-byte stores of whole rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];  // no visible key -> 0
  }
  // lse = ln sum_t exp(scale s_t) = m ln 2 + ln l, m kept in log2 units;
  // -inf for a row that sees no key
  if (p.lse != nullptr && tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < p.S)
        p.lse[((long long)b * p.H + h) * p.S + row] =
            l[r] == 0.f ? -INFINITY : m[r] * 0.6931471805599453f + logf(l[r]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int col = nb * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(qs + mma::tile_off<D>(row, col / 8) +
                                   col % 8) =
          mma::pack_bf16(acc[nb][2 * r] * inv[r], acc[nb][2 * r + 1] * inv[r]);
    }
  }
  __syncthreads();
  __nv_bfloat16* og = o + b * p.o_sb + (long long)q_block0 * p.o_ss + h * p.o_sh;
  for (int e = tid; e < BQ * CPR; e += THREADS) {
    const int r = e / CPR, ch = e % CPR;
    if (q_block0 + r < p.S)
      *reinterpret_cast<uint4*>(og + r * p.o_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + mma::tile_off<D>(r, ch));
  }
}

template <int D>
cudaError_t launch_mma_t(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.S + MMA_BQ - 1) / MMA_BQ);
  flash_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_mma(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma_t<16>(p, B, stream);
    case 32: return launch_mma_t<32>(p, B, stream);
    case 64: return launch_mma_t<64>(p, B, stream);
    case 96: return launch_mma_t<96>(p, B, stream);
    case 128: return launch_mma_t<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
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

}  // namespace


// Dynamic shared memory of one flash_mma_kernel<D> launch in bytes, -1 for
// a head dim the tensor-core path does not take.
extern "C" int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 16: return mma_smem_bytes<16>();
    case 32: return mma_smem_bytes<32>();
    case 64: return mma_smem_bytes<64>();
    case 96: return mma_smem_bytes<96>();
    case 128: return mma_smem_bytes<128>();
    default: return -1;
  }
}

// q: (B,S,H,D), k and v: (B,T,K,D), o: (B,S,H,D), each with unit stride in
// D and the other strides given in elements.  dtype: 0 = float32,
// 1 = bfloat16.  lse: null, or a contiguous fp32 (B,H,S) that receives
// each row's natural-log logsumexp of the scaled visible scores (-inf for
// a row that sees no key).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int K, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int window,
    int q_offset, void* lse, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    o,    S,     T,      H,      H / K,
                 q_sb, q_ss, q_sh, k_sb, k_st,  k_sh,   v_sb,   v_st,
                 v_sh, o_sb, o_ss, o_sh, scale, causal, window, q_offset,
                 static_cast<float*>(lse)};
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const bool tiles16 = D % 16 == 0 && mma::aligned16(q, q_sb, q_ss, q_sh) &&
                       mma::aligned16(k, k_sb, k_st, k_sh) &&
                       mma::aligned16(v, v_sb, v_st, v_sh) &&
                       mma::aligned16(o, o_sb, o_ss, o_sh);
  if (dtype == 1 && tiles16)
    err = launch_mma(p, B, D, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(p, D, grid, st);
  else if (dtype == 0)
    err = launch<float>(p, D, grid, st);
  return static_cast<int>(err);
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
