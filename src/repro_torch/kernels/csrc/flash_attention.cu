// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
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
// 1 = bfloat16.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int K, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int window,
    int q_offset, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    o,    S,     T,      H,      H / K,
                 q_sb, q_ss, q_sh, k_sb, k_st,  k_sh,   v_sb,   v_st,
                 v_sh, o_sb, o_ss, o_sh, scale, causal, window, q_offset};
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
