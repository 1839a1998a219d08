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
//    a row that sees no key; serving passes no lse and writes none.
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
// it is bound by operations, so the products must run on the tensor cores
// and nothing of size S x T may reach device memory.
//
// Three launches, none with atomics, so the result is deterministic:
//  * flash_bwd_preprocess_kernel: Di, one warp a row, into an fp32
//    scratch (B, H, S).
//  * flash_bwd_dkdv_kernel<D>: one block per (b, kv head, 64-key tile).
//    K_j and V_j stay in shared memory; the block walks every query head
//    of the GQA group and every query tile that the causal, window and
//    q_offset masks let see tile j (the forward's masks on absolute
//    positions), Q / dO / lse / Di through a two-stage cp.async ring.  Each
//    warp owns 16 keys: S^T = K Q^T and dP^T = V dO^T on mma.sync
//    m16n8k16, P^T recomputed from lse, then dV += P^T dO and
//    dK += dS^T Q with P^T and dS^T reused from registers as A operands
//    and dO and Q read through ldmatrix.trans.  The group's sum stays in
//    fp32 registers and dK, dV are written once.
//  * flash_bwd_dq_kernel<D>: one block per (b, head, 64-query tile),
//    walking key tiles as the forward does (same ring, same skip and
//    mask split); dS from S = Q K^T and dP = dO V^T, dQ += dS K, written
//    once.
//  P is rounded to bf16 for the dV product, as the forward rounds P (dV's
//  largest error equals the plain twin's output rounding in every checked
//  case).  dS goes into the dK and dQ products as a pair of bf16 (hi, and
//  lo = dS - hi), two mma.sync each: rounded once, dS cost dQ up to 2.6x
//  the plain twin's error at a window of 48, where a query sums few large
//  terms (PERF.md section 6).  Every sum is fp32.  S and dP are computed
//  twice (once per pass): FlashAttention-2's cost for needing no atomics.
//  So the tensor cores run nine products where the bound counts five.  Not done
//  here: wgmma, TMA and a fused dQ pass (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
               // null (serving); written by flash_mma_kernel only
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
// 16-byte aligned): FlashAttention-2's three passes
// ---------------------------------------------------------------------------
constexpr int BWD_BQ = 64;                 // query rows per tile
constexpr int BWD_BK = 64;                 // keys per tile
constexpr int BWD_WARPS = 4;               // 16 rows (dq) or keys (dk/dv) each
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int PRE_WARPS = 8;               // rows per preprocess block
constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, S), the forward's
  float* delta;      // (B, H, S) scratch: rowsum(dO o O)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, T, H, group;
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

// (a, b) as a pair of packed bf16 pairs: hi = bf16(a, b), lo = bf16 of
// what hi leaves over, so hi + lo carries ~16 of fp32's mantissa bits
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = mma::pack_bf16(a - hf.x, b - hf.y);
}

// the A fragment of 16 x 16 from the C fragments of two adjacent 8-column
// blocks c0, c1, as hi and lo halves (split_bf16)
__device__ __forceinline__ void split_a_fragment(const float (&c0)[4],
                                                 const float (&c1)[4],
                                                 uint32_t (&hi)[4],
                                                 uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// the lse of a row in log2 units, for exp2f(s * scale_log2 - lse2): a row
// that sees no key (lse -inf) or lies past S gets +inf, so every P of it
// is exp2(-inf) = 0
__device__ __forceinline__ float lse_log2(const BwdParams& p, long long idx,
                                          bool valid) {
  if (!valid) return INFINITY;
  const float x = p.lse[idx];
  return x == -INFINITY ? INFINITY : x * LOG2E;
}

// Di = rowsum(dO o O) in fp32, one warp a row, rows in (b, h, i) order
__global__ void __launch_bounds__(32 * PRE_WARPS)
    flash_bwd_preprocess_kernel(const BwdParams p, int B, int D) {
  const long long row = (long long)blockIdx.x * PRE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * p.H * p.S) return;  // the whole warp
  const int i = static_cast<int>(row % p.S);
  const int bh = static_cast<int>(row / p.S);
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
  if (lane == 0) p.delta[row] = acc;
}

template <int D>
constexpr int bwd_dkdv_smem_bytes() {
  // K and V tiles, MMA_STAGES x (Q tile, dO tile), MMA_STAGES x (lse2, Di)
  return (2 * BWD_BK * D + MMA_STAGES * 2 * BWD_BQ * D) * 2 +
         MMA_STAGES * 2 * BWD_BQ * 4;
}

template <int D>
constexpr int bwd_dq_smem_bytes() {
  // Q and dO tiles, MMA_STAGES x (K tile, V tile)
  return (2 * BWD_BQ * D + MMA_STAGES * 2 * BWD_BK * D) * 2;
}

// One query tile for one warp's 16 keys (rows warp*16 .. +15 of the K / V
// tiles, absolute keys w0 ..): S^T = K Q^T and dP^T = V dO^T, P^T =
// exp2(S^T scale_log2 - lse2), dS^T = P^T o (dP^T - Di); dV += P^T dO and
// dK += dS^T Q with P^T and dS^T reused from registers as A operands.
// Lane l holds keys g = l/4 and g + 8 of the warp, queries 2 * (l % 4) +
// {0, 1} of each 8-query block.
template <int D, bool MASK>
__device__ __forceinline__ void dkdv_tile(
    const BwdParams& p, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
    const __nv_bfloat16* qs, const __nv_bfloat16* dos, const float* ls,
    const float* ds, float (&dk)[D / 8][4], float (&dv)[D / 8][4], int w0,
    int q0, float scale_log2, int warp, int lane) {
  constexpr int NB_S = BWD_BQ / 8;  // 8-query column blocks of S^T
  constexpr int NB_O = D / 8;       // 8-dim column blocks of dK, dV
  const int g = lane >> 2, tig = lane & 3;
  const int r8 = lane & 7, mi = lane >> 3;

  float s[NB_S][4], dp[NB_S][4];
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t kf[4], vf[4];
    const int a_off =
        mma::tile_off<D>(warp * 16 + r8 + (mi & 1) * 8, 2 * kk + (mi >> 1));
    mma::ldmatrix_x4(kf, ks + a_off);
    mma::ldmatrix_x4(vf, vs + a_off);
#pragma unroll
    for (int nb = 0; nb < NB_S; nb += 2) {
      // queries nb*8 .. nb*8+15, dims kk*16 .. kk*16+15: two B fragments
      const int b_off =
          mma::tile_off<D>(nb * 8 + r8 + (mi >> 1) * 8, 2 * kk + (mi & 1));
      uint32_t b[4];
      mma::ldmatrix_x4(b, qs + b_off);
      const uint32_t q0f[2] = {b[0], b[1]}, q1f[2] = {b[2], b[3]};
      mma::mma_16816(s[nb], kf, q0f);
      mma::mma_16816(s[nb + 1], kf, q1f);
      mma::ldmatrix_x4(b, dos + b_off);
      const uint32_t d0f[2] = {b[0], b[1]}, d1f[2] = {b[2], b[3]};
      mma::mma_16816(dp[nb], vf, d0f);
      mma::mma_16816(dp[nb + 1], vf, d1f);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = nb * 8 + tig * 2 + (i & 1);
      float pv = exp2f(s[nb][i] * scale_log2 - ls[col]);
      if constexpr (MASK) {
        const int t = w0 + g + (i >> 1) * 8;
        const int qp = q0 + col + p.q_offset;
        bool ok = t < p.T;
        if (p.causal) ok = ok && t <= qp;
        if (p.window > 0) ok = ok && qp - t < p.window;
        pv = ok ? pv : 0.f;
      }
      s[nb][i] = pv;
      dp[nb][i] = pv * (dp[nb][i] - ds[col]);
    }
  }
  // dV += P^T dO, dK += dS^T Q: two adjacent 8-query blocks are one A
  // fragment (dS^T as hi + lo); dO and Q are read as stored
  // ([query][dim]) through ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < BWD_BQ / 16; ++kk) {
    const uint32_t pa[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    uint32_t da[4], dl[4];
    split_a_fragment(dp[2 * kk], dp[2 * kk + 1], da, dl);
#pragma unroll
    for (int nb = 0; nb < NB_O; nb += 2) {
      const int b_off =
          mma::tile_off<D>(kk * 16 + r8 + (mi & 1) * 8, nb + (mi >> 1));
      uint32_t b[4];
      mma::ldmatrix_x4_trans(b, dos + b_off);
      const uint32_t d0f[2] = {b[0], b[1]}, d1f[2] = {b[2], b[3]};
      mma::mma_16816(dv[nb], pa, d0f);
      mma::mma_16816(dv[nb + 1], pa, d1f);
      mma::ldmatrix_x4_trans(b, qs + b_off);
      const uint32_t q0f[2] = {b[0], b[1]}, q1f[2] = {b[2], b[3]};
      mma::mma_16816(dk[nb], da, q0f);
      mma::mma_16816(dk[nb], dl, q0f);
      mma::mma_16816(dk[nb + 1], da, q1f);
      mma::mma_16816(dk[nb + 1], dl, q1f);
    }
  }
}

// One block per (b, kv head, 64-key tile): K_j and V_j stay in shared
// memory while the block walks the query tiles of every query head of the
// group that the masks let see the tile, Q / dO / lse / Di through a ring
// of MMA_STAGES stages; dK and dV (the GQA sum over the group included)
// build up in registers and are written once.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkdv_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "tensor-core path needs D % 16 == 0");
  constexpr int TILE = BWD_BQ * D;  // elements of one Q or dO tile
  constexpr int NB_O = D / 8;
  constexpr int CPR = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BWD_BK * D;
  __nv_bfloat16* ring = vs + BWD_BK * D;
  float* fring = reinterpret_cast<float*>(ring + MMA_STAGES * 2 * TILE);

  const int K = p.H / p.group;
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int k0 = blockIdx.y * BWD_BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;

  // the queries that see a key of this tile, in whole tiles
  const int k_last = min(k0 + BWD_BK, p.T) - 1;
  const int i_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int i_hi =
      p.window > 0 ? min(p.S, k_last + p.window - p.q_offset) : p.S;
  const int q_first = i_lo / BWD_BQ * BWD_BQ;
  const int nqt =
      i_hi > q_first ? (i_hi - q_first + BWD_BQ - 1) / BWD_BQ : 0;
  const int n_it = p.group * nqt;  // (query head, query tile) pairs

  const __nv_bfloat16* kg =
      p.k + b * p.k_sb + (long long)k0 * p.k_st + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      p.v + b * p.v_sb + (long long)k0 * p.v_st + kvh * p.v_sh;
  auto load_q = [&](int it, int stage) {
    const int h = kvh * p.group + it / nqt;
    const int q0 = q_first + (it % nqt) * BWD_BQ;
    __nv_bfloat16* qs = ring + stage * 2 * TILE;
    mma::load_tile<BWD_BQ, D>(
        qs, p.q + b * p.q_sb + (long long)q0 * p.q_ss + h * p.q_sh, p.q_ss,
        p.S - q0, D, true, tid, BWD_THREADS);
    mma::load_tile<BWD_BQ, D>(
        qs + TILE,
        p.dout + b * p.do_sb + (long long)q0 * p.do_ss + h * p.do_sh,
        p.do_ss, p.S - q0, D, true, tid, BWD_THREADS);
    float* ls = fring + stage * 2 * BWD_BQ;
    for (int r = tid; r < BWD_BQ; r += BWD_THREADS) {
      const long long idx = ((long long)b * p.H + h) * p.S + q0 + r;
      const bool valid = q0 + r < p.S;
      ls[r] = lse_log2(p, idx, valid);
      ls[BWD_BQ + r] = valid ? p.delta[idx] : 0.f;
    }
  };

  // group 0: K, V and the first stage; every step commits one group
  // (empty past the last), so wait<1> means "this stage landed"
  mma::load_tile<BWD_BK, D>(ks, kg, p.k_st, p.T - k0, D, true, tid,
                            BWD_THREADS);
  mma::load_tile<BWD_BK, D>(vs, vg, p.v_st, p.T - k0, D, true, tid,
                            BWD_THREADS);
  if (n_it > 0) load_q(0, 0);
  mma::cp_async_commit();

  float dk[NB_O][4], dv[NB_O][4];
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nb][i] = dv[nb][i] = 0.f;
  const float scale_log2 = p.scale * LOG2E;
  const int w0 = k0 + warp * 16;  // this warp's first key
  const int w_last = min(w0 + 15, p.T - 1);

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q(it + 1, (it + 1) % MMA_STAGES);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_first + (it % nqt) * BWD_BQ;
    const __nv_bfloat16* qs = ring + (it % MMA_STAGES) * 2 * TILE;
    const float* ls = fring + (it % MMA_STAGES) * 2 * BWD_BQ;
    if (w0 < p.T) {
      // a tile whose every (key, query) pair of this warp is masked adds
      // nothing; only the tiles that cross the diagonal, the window's edge
      // or T take the mask (rows past S have P = 0 through their lse)
      const int qa = q0 + p.q_offset;
      const int qz = min(q0 + BWD_BQ, p.S) - 1 + p.q_offset;
      const bool skip = (p.causal && qz < w0) ||
                        (p.window > 0 && qa - w_last >= p.window);
      const bool full = w0 + 16 <= p.T && (!p.causal || qa >= w0 + 15) &&
                        (p.window <= 0 || qz - w0 < p.window);
      if (!skip && full)
        dkdv_tile<D, false>(p, ks, vs, qs, qs + TILE, ls, ls + BWD_BQ, dk, dv,
                            w0, q0, scale_log2, warp, lane);
      else if (!skip)
        dkdv_tile<D, true>(p, ks, vs, qs, qs + TILE, ls, ls + BWD_BQ, dk, dv,
                           w0, q0, scale_log2, warp, lane);
    }
    __syncthreads();  // this stage is refilled MMA_STAGES tiles on
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // stage this warp's rows of dK (times scale) and dV in its own rows of
  // the K and V tiles (read by no other warp), then 16-byte stores; a key
  // no query sees gets 0
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int col = nb * 8 + tig * 2;
      const int off = mma::tile_off<D>(row, col / 8) + col % 8;
      *reinterpret_cast<uint32_t*>(ks + off) = mma::pack_bf16(
          dk[nb][2 * r] * p.scale, dk[nb][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vs + off) =
          mma::pack_bf16(dv[nb][2 * r], dv[nb][2 * r + 1]);
    }
  }
  __syncthreads();
  __nv_bfloat16* dkg =
      p.dk + b * p.dk_sb + (long long)k0 * p.dk_st + kvh * p.dk_sh;
  __nv_bfloat16* dvg =
      p.dv + b * p.dv_sb + (long long)k0 * p.dv_st + kvh * p.dv_sh;
  for (int e = tid; e < BWD_BK * CPR; e += BWD_THREADS) {
    const int r = e / CPR, ch = e % CPR;
    if (k0 + r < p.T) {
      const int off = mma::tile_off<D>(r, ch);
      *reinterpret_cast<uint4*>(dkg + r * p.dk_st + ch * 8) =
          *reinterpret_cast<const uint4*>(ks + off);
      *reinterpret_cast<uint4*>(dvg + r * p.dv_st + ch * 8) =
          *reinterpret_cast<const uint4*>(vs + off);
    }
  }
}

// One key tile for one warp's 16 query rows: S = Q K^T and dP = dO V^T,
// P = exp2(S scale_log2 - lse2), dS = P o (dP - Di), dQ += dS K with dS
// reused from registers as the A operand and K read through
// ldmatrix.trans.
template <int D, bool MASK>
__device__ __forceinline__ void dq_tile(
    const BwdParams& p, const __nv_bfloat16* qs, const __nv_bfloat16* dos,
    const __nv_bfloat16* ks, const __nv_bfloat16* vs, float (&acc)[D / 8][4],
    const float (&lse2)[2], const float (&di)[2], int start, int row0,
    float scale_log2, int warp, int lane) {
  constexpr int NB_S = BWD_BK / 8;  // 8-key column blocks of S
  constexpr int NB_O = D / 8;
  const int g = lane >> 2, tig = lane & 3;
  const int r8 = lane & 7, mi = lane >> 3;

  float s[NB_S][4], dp[NB_S][4];
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4], df[4];
    const int a_off =
        mma::tile_off<D>(warp * 16 + r8 + (mi & 1) * 8, 2 * kk + (mi >> 1));
    mma::ldmatrix_x4(qf, qs + a_off);
    mma::ldmatrix_x4(df, dos + a_off);
#pragma unroll
    for (int nb = 0; nb < NB_S; nb += 2) {
      const int b_off =
          mma::tile_off<D>(nb * 8 + r8 + (mi >> 1) * 8, 2 * kk + (mi & 1));
      uint32_t b[4];
      mma::ldmatrix_x4(b, ks + b_off);
      const uint32_t k0f[2] = {b[0], b[1]}, k1f[2] = {b[2], b[3]};
      mma::mma_16816(s[nb], qf, k0f);
      mma::mma_16816(s[nb + 1], qf, k1f);
      mma::ldmatrix_x4(b, vs + b_off);
      const uint32_t v0f[2] = {b[0], b[1]}, v1f[2] = {b[2], b[3]};
      mma::mma_16816(dp[nb], df, v0f);
      mma::mma_16816(dp[nb + 1], df, v1f);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      float pv = exp2f(s[nb][i] * scale_log2 - lse2[r]);
      if constexpr (MASK) {
        const int t = start + nb * 8 + tig * 2 + (i & 1);
        const int qp = row0 + g + r * 8 + p.q_offset;
        bool ok = t < p.T;
        if (p.causal) ok = ok && t <= qp;
        if (p.window > 0) ok = ok && qp - t < p.window;
        pv = ok ? pv : 0.f;
      }
      s[nb][i] = pv * (dp[nb][i] - di[r]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < BWD_BK / 16; ++kk) {
    uint32_t af[4], al[4];  // dS as hi + lo
    split_a_fragment(s[2 * kk], s[2 * kk + 1], af, al);
#pragma unroll
    for (int nb = 0; nb < NB_O; nb += 2) {
      uint32_t b[4];
      mma::ldmatrix_x4_trans(
          b, ks + mma::tile_off<D>(kk * 16 + r8 + (mi & 1) * 8, nb + (mi >> 1)));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma::mma_16816(acc[nb], af, b0);
      mma::mma_16816(acc[nb], al, b0);
      mma::mma_16816(acc[nb + 1], af, b1);
      mma::mma_16816(acc[nb + 1], al, b1);
    }
  }
}

// One block per (b, head, 64-query tile), walking the key tiles the masks
// let it see as the forward does, K / V through the same two-stage ring;
// Q and dO stay in shared memory, dQ in registers, written once.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "tensor-core path needs D % 16 == 0");
  constexpr int TILE = BWD_BK * D;  // elements of one K or V tile
  constexpr int NB_O = D / 8;
  constexpr int CPR = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BWD_BQ * D;
  __nv_bfloat16* kvs = dos + BWD_BQ * D;

  // causal: the heaviest query blocks (most KV tiles) are launched first
  const int qb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / p.group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int q_block0 = qb * BWD_BQ;
  const int row0 = q_block0 + warp * 16;

  const __nv_bfloat16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
  const int first_pos = q_block0 + p.q_offset;
  const int last_pos = min(q_block0 + BWD_BQ, p.S) - 1 + p.q_offset;
  const int kv_hi = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int kv_lo = p.window > 0 ? max(0, first_pos - p.window + 1) : 0;
  const int t_first = kv_lo / BWD_BK * BWD_BK;
  const int ntiles =
      kv_hi > t_first ? (kv_hi - t_first + BWD_BK - 1) / BWD_BK : 0;

  auto load_kv = [&](int tile, int stage) {
    const int t0 = t_first + tile * BWD_BK;
    __nv_bfloat16* ks = kvs + stage * 2 * TILE;
    mma::load_tile<BWD_BK, D>(ks, kbase + (long long)t0 * p.k_st, p.k_st,
                              p.T - t0, D, true, tid, BWD_THREADS);
    mma::load_tile<BWD_BK, D>(ks + TILE, vbase + (long long)t0 * p.v_st,
                              p.v_st, p.T - t0, D, true, tid, BWD_THREADS);
  };

  // group 0: Q, dO and K / V tile 0; every step commits one group
  mma::load_tile<BWD_BQ, D>(
      qs, p.q + b * p.q_sb + (long long)q_block0 * p.q_ss + h * p.q_sh,
      p.q_ss, p.S - q_block0, D, true, tid, BWD_THREADS);
  mma::load_tile<BWD_BQ, D>(
      dos, p.dout + b * p.do_sb + (long long)q_block0 * p.do_ss + h * p.do_sh,
      p.do_ss, p.S - q_block0, D, true, tid, BWD_THREADS);
  if (ntiles > 0) load_kv(0, 0);
  mma::cp_async_commit();

  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const long long idx = ((long long)b * p.H + h) * p.S + row;
    lse2[r] = lse_log2(p, idx, row < p.S);
    di[r] = row < p.S ? p.delta[idx] : 0.f;
  }
  float acc[NB_O][4];
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  const float scale_log2 = p.scale * LOG2E;
  const bool warp_live = row0 < p.S;
  const int warp_first = row0 + p.q_offset;
  const int warp_last = min(row0 + 15, p.S - 1) + p.q_offset;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1, (it + 1) % MMA_STAGES);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const int start = t_first + it * BWD_BK;
    const __nv_bfloat16* ks = kvs + (it % MMA_STAGES) * 2 * TILE;
    if (warp_live) {
      const bool skip =
          (p.causal && start > warp_last) ||
          (p.window > 0 && start + BWD_BK - 1 <= warp_first - p.window);
      const bool full =
          start + BWD_BK <= p.T &&
          (!p.causal || start + BWD_BK - 1 <= warp_first) &&
          (p.window <= 0 || warp_last - start < p.window);
      if (!skip && full)
        dq_tile<D, false>(p, qs, dos, ks, ks + TILE, acc, lse2, di, start,
                          row0, scale_log2, warp, lane);
      else if (!skip)
        dq_tile<D, true>(p, qs, dos, ks, ks + TILE, acc, lse2, di, start,
                         row0, scale_log2, warp, lane);
    }
    __syncthreads();
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // dQ times scale, staged in this warp's own rows of the Q tile
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int col = nb * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(qs + mma::tile_off<D>(row, col / 8) +
                                   col % 8) =
          mma::pack_bf16(acc[nb][2 * r] * p.scale,
                         acc[nb][2 * r + 1] * p.scale);
    }
  }
  __syncthreads();
  __nv_bfloat16* dqg =
      p.dq + b * p.dq_sb + (long long)q_block0 * p.dq_ss + h * p.dq_sh;
  for (int e = tid; e < BWD_BQ * CPR; e += BWD_THREADS) {
    const int r = e / CPR, ch = e % CPR;
    if (q_block0 + r < p.S)
      *reinterpret_cast<uint4*>(dqg + r * p.dq_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + mma::tile_off<D>(r, ch));
  }
}

// which: bit 0 the preprocess, bit 1 dK / dV, bit 2 dQ (7 is the
// backward; one pass alone is for timing, over a delta an earlier call
// wrote)
template <int D>
cudaError_t launch_bwd_t(const BwdParams& p, int B, int which,
                         cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (which & 1) {
    const long long rows = (long long)B * p.H * p.S;
    flash_bwd_preprocess_kernel<<<(rows + PRE_WARPS - 1) / PRE_WARPS,
                                  32 * PRE_WARPS, 0, stream>>>(p, B, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (which & 2) {
    constexpr int smem = bwd_dkdv_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * (p.H / p.group), (p.T + BWD_BK - 1) / BWD_BK);
    flash_bwd_dkdv_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (which & 4) {
    constexpr int smem = bwd_dq_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * p.H, (p.S + BWD_BQ - 1) / BWD_BQ);
    flash_bwd_dq_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

cudaError_t launch_bwd(const BwdParams& p, int B, int D, int which,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bwd_t<16>(p, B, which, stream);
    case 32: return launch_bwd_t<32>(p, B, which, stream);
    case 64: return launch_bwd_t<64>(p, B, which, stream);
    case 96: return launch_bwd_t<96>(p, B, which, stream);
    case 128: return launch_bwd_t<128>(p, B, which, stream);
    default: return cudaErrorInvalidValue;
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
// a row that sees no key); only the tensor-core path writes it, so an lse
// with any other input is refused.  Returns the CUDA error of the launch
// (0 on success).
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
  else if (lse != nullptr)  // only the tensor-core kernel writes lse
    err = cudaErrorInvalidValue;
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(p, D, grid, st);
  else if (dtype == 0)
    err = launch<float>(p, D, grid, st);
  return static_cast<int>(err);
}

// Dynamic shared memory of one backward launch in bytes: pass 2 is
// flash_bwd_dkdv_kernel<D>, pass 4 flash_bwd_dq_kernel<D>; -1 otherwise.
extern "C" int flash_attention_bwd_smem_bytes(int pass, int D) {
  switch (D * 8 + pass) {
#define BWD_SMEM(d)                                   \
  case d * 8 + 2: return bwd_dkdv_smem_bytes<d>();    \
  case d * 8 + 4: return bwd_dq_smem_bytes<d>();
    BWD_SMEM(16) BWD_SMEM(32) BWD_SMEM(64) BWD_SMEM(96) BWD_SMEM(128)
#undef BWD_SMEM
    default: return -1;
  }
}

// The backward of flash_attention_fwd's tensor-core path: q, k, v, o as
// there, dout (B,S,H,D) the output's gradient, lse the forward's (B,H,S),
// delta an fp32 (B,H,S) scratch, dq (B,S,H,D), dk and dv (B,T,K,D); all
// bf16 but lse and delta, every row 16-byte aligned, D % 16 == 0, strides
// in elements.  which: 7 runs the three passes (1 the preprocess, 2 dK /
// dV, 4 dQ; one alone is for timing).  Returns the CUDA error of the
// launches (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int K, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dq_sb, long long dq_ss,
    long long dq_sh, long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh, float scale,
    int causal, int window, int q_offset, int which, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      D % 16 != 0 || B * H > 65535 || which <= 0 || which > 7)
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
  p.delta = static_cast<float*>(delta);
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
  return static_cast<int>(
      launch_bwd(p, B, D, which, static_cast<cudaStream_t>(stream)));
}
