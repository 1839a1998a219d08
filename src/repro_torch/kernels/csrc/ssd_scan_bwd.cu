// The Mamba2 SSD chunked scan's backward for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces no TPU kernel: repro/kernels/ssd_scan.py · ssd_scan has no
// backward, and the JAX package differentiates its jnp reference; the
// plain alternative, autograd through the chunked form in fp32
// (ssd_scan.py · ssd_scan_backward), stays as an oracle for the checks.
// The arithmetic is ref.py's staged closed form
// (ssd_state_passing_bwd, ssd_chunk_bwd, ssd_cum_bwd).  Per (b, h) and
// chunk z, with cum the in-chunk inclusive cumsum of dt A, total =
// cum[-1], u = x dt, in_z the entering state, L_ij = exp(cum_i - cum_j)
// for j <= i (masked before the exp), CB = C B^T, G = dy u^T, dCB = G o L
// and M = dCB o CB:
//   dS_z  = d in_{z+1}; d in_z = exp(total) d in_{z+1}
//                                + sum_i exp(cum_i) dy_i (x) C_i
//   du    = (CB o L)^T dy + exp(total - cum) o (B dS^T); dx = du dt
//   dC    = dCB B + exp(cum) o (dy in_z)
//   dB    = dCB^T C + exp(total - cum) o (u dS)
//   d cum = rowsum(M) - colsum(M) + C . (exp(cum) dy in_z)
//           - B . (exp(total - cum) u dS), and on the last row d total
//           = sum_j B_j . (exp(total - cum_j) u_j dS) + exp(total)
//           <in_z, dS>
//   d a   = the reverse in-chunk cumsum of d cum; ddt = du . x + A d a;
//           dA = sum dt d a
//
// Three variants, one entry (ssd_scan_bwd); ssd_scan.py · backward_variant
// chooses and the entry launches what it is told, refusing what the
// variant does not take (never another kernel, never the twin):
//
// bf16 at the models' shapes (variant 2, "wgmma": p a multiple of 16, n
// 16, 32, 64 or 128 unpadded, a chunk a multiple of 64 up to 256, x, dy,
// B and C 16-byte aligned):
//  * the two state walks of the mma variant (below), whose passes write
//    the states in place as hi / lo bf16 pairs, the layout TMA reads;
//  * ssd_bwd_chunk_wgmma_kernel<n>, the chunk stage in band form: one
//    block per (b, chunk, band of W heads of one group; ssd_scan.py ·
//    backward_band: W 4, 2 or 1, whichever leaves the fewest waves of head
//    work on the card, 4 at mamba2-780m's 4 x 2048; a ragged last band
//    where W does not divide the group's heads, no band across groups), a
//    consumer warpgroup on wgmma
//    and a producer warp bringing C, B, x, dy and the state pairs by TMA
//    into mbarrier rings (hopper_utils.cuh).  A row side per 64-row query
//    block I and a column side per key block J, each computing C B^T once
//    for the band at each block pair, each head's G = dy x^T and dCB = G
//    o L in fp32 registers, and the band's sum of dCB in fp32 before it
//    meets B (dC_I) or C (dB_J), rounded to bf16 once: per causal pair and
//    head 8p + 8n / W FLOP units (G twice, du's product as a hi / lo pair,
//    C B^T twice, dC and dB once, each of the last three a band's), half
//    of the mma kernel's 8p + 8n at W = 4.  The column side keeps its
//    chunk column of C B^T in shared memory for du's products, head by
//    head.  dB and dC leave as one fp32 partial a band, (b, s, bands, n);
//  * ssd_bwd_reduce_kernel: the bands of each group summed in order.
//
// bf16 at the other shapes (variant 1, "mma": the test shapes' chunk of
// 24 and p 12 / n 10, unaligned views, chunks above 256; wgmma takes
// 64-row tiles and 16-element K steps, TMA 16-byte rows and bases, and
// the band kernel's shared memory a chunk column of C B^T up to 256; p
// padded to 64 and n to NT, the narrowest of 16, 32, 64, 128 at least n):
//  * the two state walks, each ssd_bwd_own_mma_kernel<NT, FWD>, one block
//    per (b, h, chunk) of four warps, then ssd_bwd_pass_kernel<FWD>, one
//    thread per (b, h, p, n): the forward walk's own additions (x o dt
//    exp(total - cum))^T B and, in place in chunk order, the entering
//    states in_z (fp32 scratch); the backward walk's (dy o exp(cum))^T C
//    and, from the last chunk to the first, dS_z = d in with d in <- d in
//    exp(total_z) + own_z.  The own kernels' products run on mma.sync with
//    the scaled rows as hi / lo bf16 pairs (two products each); the
//    passes keep eight chunks' loads in flight;
//  * ssd_bwd_chunk_mma_kernel<NT>, one block per (b, h, chunk) of four
//    warps, each 16 rows of a 64-row sub-block, on mma.sync m16n8k16 with
//    fp32 accumulators: the row side (per query block I: dC_I = dCB B +
//    exp(cum) dy in_z and rowsum(M) into d cum) and the column side (per
//    key block J: du_J, so dx and du . x, dB_J, colsum(M) and the state
//    terms), the key tiles copied by cp.async in a ring of two; C B^T and
//    G = dy x^T are computed once in each side (rows i, then rows j), so
//    every accumulator stays in registers and the scores feed the next
//    products from registers as A fragments (dCB rounded to bf16 once, CB
//    o L as a hi / lo pair for du's product); dt_j scales the products'
//    columns or rows in fp32 (u = x dt is never formed); the states enter
//    as hi / lo bf16 pairs (two products each); the decays are ex2.approx
//    of cum in log2 units.
//    Then the reverse cumsum of d cum in the block, ddt and the block's
//    dA partial (finish_chunk).
//  * ssd_bwd_reduce_kernel<bf16>: dB and dC summed over the heads of each
//    group in head order (the chunk kernel leaves them per head, fp32 (b,
//    s, h, n)), dA over (b, chunk) in order.
//
// fp32 (variant 0, "scalar"): the same stages in register-tiled scalar
// FMAs (a thread owns a 4 x 4 or 4 x 8 tile of each product), fp32
// throughout:
//  * ssd_bwd_state_kernel<T>, one block per (b, h): the entering states by
//    a walk of the chunks in order (the forward's scalar kernel keeps them
//    in shared memory and writes none), then the d-states by a walk from
//    last to first, the (p, n) state in registers;
//  * ssd_bwd_chunk_kernel<T>, one block per (b, h, chunk): the chunk
//    kernel's two sides and finish_chunk, as above;
//  * ssd_bwd_reduce_kernel<T>.
//
// No atomics anywhere: every sum is taken in a fixed order, and a second
// call gives the same bits.  A sequence that is not a multiple of the
// chunk is taken as the forward takes it: rows past s read as zeros and
// dt there as 0, and no gradient is written past s.
//
// What bounds it on an H100: at mamba2-780m's training shape (4 x 2048, h
// 48, p 64, g 1, n 128, chunk 256, bf16) the backward needs 46 GFLOP
// (roofline/costs.py · ssd_scan_backward: the causal halves of G and
// (C B^T o L)^T dy per head, of C B^T, dCB B and dCB^T C once per group on
// the heads' summed dCB, five state products per head) against 0.163 GB
// of inputs and gradients: bytes, 0.0485 ms at HBM's rate (the FLOPs
// 0.046 ms on the tensor cores).  Measured (tools/kernel_compare.py
// --kernel ssd_bwd, device ms in turns against the mma kernels, the
// previous form of these shapes' backward, in parentheses, on one
// NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md section 6): slice 1.048 and
// 1.068 (1.446, 1.438): the band chunk kernel 0.671-0.675 (0.977-0.982),
// the reduction of the band partials 0.040 (0.142-0.143), the walks 0.117
// + 0.118 with their pair-writing passes 0.053 + 0.041; fleet6 1.655
// (2.117), dp_mb 0.552 (0.729), tp_ssm_rank 0.136 (0.177), tp_hybrid_rank
// 0.096-0.098 (0.096), p32_groups 0.079 (0.095).  What bounds the band
// kernel now: one consumer warpgroup a multiprocessor (230,576 bytes of
// shared memory at n 128, 248 registers, no spills) that waits on each
// head's products before their decays run, so its time follows the heads
// a block, not the band: at slice bands of 4, 2 and 1 take 0.674, 0.705
// and 0.665 ms (the band's gain is the reduction: 0.040 against 0.142).
// A second G accumulator, to overlap the next head's product with this
// head's decays, made ptxas spill at n 128 and ran slower: not kept.  The
// mma kernels keep their readings (chip_smoke.py: t4_chunk24 0.025 ms,
// unaligned 0.026).
//
// Precision.  The entering states are computed again here, in fp32 (a
// first version read the forward's, whose bf16 operands left dA off by
// up to 4.6e-3 of its largest entry; 1e-5 to 4e-5 now), the d-states'
// dy exp(cum) and du's scores enter as hi / lo pairs (ddt, a difference
// of large sums, was off by up to 3e-3 of its largest entry with the
// scores rounded once; 5e-5 now).  dB and dC keep the scores dCB rounded
// to bf16 once (the wgmma kernel the band's sum of them): 2.3e-3 to 4.6e-3
// of their largest entry, about twice their own rounding to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_utils.cuh"
#include "mma_utils.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int TILE = 64;       // rows of a query or key sub-block
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int MAX_CHUNK = 512;
constexpr int SP = TILE + 1;   // row stride of a 64 x 64 fp32 tile
constexpr int BWD_SCALAR = 0;
constexpr int BWD_MMA = 1;
constexpr int BWD_WGMMA = 2;

struct BwdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  float* states;         // (b, h, chunks, P, N): the entering states in_z
  float* dS;             // (b, h, chunks, P, N)
  void* dx;              // (b, S, H, P) contiguous, x's type
  float* ddt;            // (b, S, H) contiguous
  float* dB_part;        // (b, S, parts, N) fp32: a head's (scalar, mma) or
  float* dC_part;        // a band's (wgmma)
  float* dA_part;        // (b, chunks, H)
  float* tot;            // (b, H, chunks): exp(total) (bf16 d-state)
  void* dB;              // (b, S, G, N) contiguous, B's type
  void* dC;
  float* dA;             // (H,)
  int Bn, S, H, P, G, N, chunk, nc;
  int band;              // heads of a band (wgmma), 1 otherwise
  int parts;             // dB / dC partials of a (b, t): H, or G x bands
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long dy_sb, dy_ss, dy_sh;
  // rows start on 16-byte boundaries and are whole 16-byte chunks: the
  // mma kernel copies their tiles by cp.async, else element by element
  int vec_x, vec_dy, vec_bc;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the sum over the 16 lanes of a half-warp (the threads of one ty)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the sum over the block, in a fixed order; every thread gets it.  red:
// 8 floats of shared memory
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// cum of the chunk starting at t0 (rows past S: dt 0) into s_cum[0, c):
// warp 0, each lane a run of rows, then a shuffle scan of the runs
__device__ __forceinline__ void chunk_cum(float* s_cum, const float* dtg,
                                          long long dt_ss, long long t0,
                                          int c, int S, float a_h) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int per = (c + 31) / 32;
    const int lo = min(c, tid * per), hi = min(c, lo + per);
    float run = 0.f;
    for (int r = lo; r < hi; ++r) {
      if (t0 + r < S) run += dtg[(t0 + r) * dt_ss] * a_h;
      s_cum[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) before = 0.f;
    for (int r = lo; r < hi; ++r) s_cum[r] += before;
  }
  __syncthreads();
}

// rows [r0, r0 + TILE) of the chunk at t0 of an (s, n) operand into a
// TILE x ld fp32 tile, each row scaled by scale[r] (if given); zero past
// the chunk's end or S
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long rs, long long t0, int r0,
                                          int c, int S, int n,
                                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < TILE * n; e += THREADS) {
    const int r = e / n, k = e - r * n;
    const long long t = t0 + r0 + r;
    float v = 0.f;
    if (r0 + r < c && t < S) {
      v = load_f(src + t * rs + k);
      if (scale != nullptr) v *= scale[r0 + r];
    }
    dst[r * ld + k] = v;
  }
}

// ---------------------------------------------------------------------------
// the scalar variant's state walks: the entering states, then the
// d-states, one block per (b, h)

size_t state_smem(int N, int chunk) {
  return sizeof(float) * ((size_t)TILE * (N + 1) + TILE * (MAX_P + 1) +
                          2 * ((chunk + TILE - 1) / TILE * TILE));
}

// One walk over the chunks (forward: in_z; reverse: dS_z), the (p, n)
// state in registers, rows ty + 16a, columns tx + 16q.  Each chunk's
// addition is sum_j wgt_j v_j (x) m_j, v from `vsrc` (x or dy, p wide),
// m from `msrc` (B or C, n wide): forward wgt = dt_j exp(total - cum_j),
// reverse wgt = exp(cum_j).
template <typename T, bool REVERSE>
__device__ void state_walk(const BwdParams& p, float* out, const T* vsrc,
                           long long v_ss, const T* msrc, long long m_ss,
                           const float* dtg, float a_h, float* s_m,
                           float* s_v, float* s_cum, float* s_w) {
  const int P = p.P, N = p.N, c = p.chunk, NS = N + 1, VS = MAX_P + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float st[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) st[a][q] = 0.f;
  int pr[4], nc_[8];
#pragma unroll
  for (int a = 0; a < 4; ++a) pr[a] = min(ty + 16 * a, P - 1);
#pragma unroll
  for (int q = 0; q < 8; ++q) nc_[q] = min(tx + 16 * q, N - 1);

  for (int zi = 0; zi < p.nc; ++zi) {
    const int z = REVERSE ? p.nc - 1 - zi : zi;
    const long long t0 = (long long)z * c;
    chunk_cum(s_cum, dtg, p.dt_ss, t0, c, p.S, a_h);
    const float total = s_cum[c - 1];
    for (int r = tid; r < c; r += THREADS) {
      const long long t = t0 + r;
      s_w[r] = REVERSE ? expf(s_cum[r])
                       : (t < p.S ? dtg[t * p.dt_ss] : 0.f) *
                             expf(total - s_cum[r]);
    }
    // the state entering this step of the walk
    float* o = out + ((long long)blockIdx.x * p.nc + z) * P * N;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = ty + 16 * a, col = tx + 16 * q;
        if (row < P && col < N) o[row * N + col] = st[a][q];
      }
    float add[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) add[a][q] = 0.f;
    for (int r0 = 0; r0 < c; r0 += TILE) {
      __syncthreads();
      load_rows(s_v, VS, vsrc, v_ss, t0, r0, c, p.S, P, s_w);
      load_rows(s_m, NS, msrc, m_ss, t0, r0, c, p.S, N);
      __syncthreads();
      const int kr = min(TILE, c - r0);
      for (int r = 0; r < kr; ++r) {
        float vv[4], mv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) vv[a] = s_v[r * VS + pr[a]];
#pragma unroll
        for (int q = 0; q < 8; ++q) mv[q] = s_m[r * NS + nc_[q]];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            add[a][q] = fmaf(vv[a], mv[q], add[a][q]);
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) st[a][q] = st[a][q] * decay + add[a][q];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_state_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int N = p.N, c = p.chunk;
  const int cpad = (c + TILE - 1) / TILE * TILE;
  float* s_m = smem;                        // TILE x (N + 1)
  float* s_v = s_m + TILE * (N + 1);        // TILE x (MAX_P + 1)
  float* s_cum = s_v + TILE * (MAX_P + 1);  // cpad
  float* s_w = s_cum + cpad;                // cpad
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int grp = h / (p.H / p.G);
  const float a_h = p.A[h];
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* cg = static_cast<const T*>(p.C) + b * p.C_sb + grp * p.C_sg;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* bg = static_cast<const T*>(p.B) + b * p.B_sb + grp * p.B_sg;
  state_walk<T, false>(p, p.states, xg, p.x_ss, bg, p.B_ss, dtg, a_h, s_m,
                       s_v, s_cum, s_w);
  state_walk<T, true>(p, p.dS, dyg, p.dy_ss, cg, p.C_ss, dtg, a_h, s_m, s_v,
                      s_cum, s_w);
}

// The end of a chunk block: d total onto the last row of d cum, d a by the
// in-chunk reverse cumsum (warp 0, runs of rows, a shuffle scan of their
// totals), ddt = du . x + A d a for the rows before S, and the block's dA
// partial, sum dt d a.
__device__ __forceinline__ void finish_chunk(const BwdParams& p,
                                             const float* s_dt, float* s_dcum,
                                             const float* s_ddt, float* s_red,
                                             float dtotal, long long t0, int c,
                                             int b, int h, int z, float a_h) {
  const int tid = threadIdx.x;
  if (tid == 0) s_dcum[c - 1] += dtotal;
  __syncthreads();
  if (tid < 32) {
    const int per = (c + 31) / 32;
    const int lo = min(c, tid * per), hi = min(c, lo + per);
    float run = 0.f;
    for (int r = hi - 1; r >= lo; --r) {
      run += s_dcum[r];
      s_dcum[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, off);
      if (tid + off < 32) incl += v;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (tid == 31) after = 0.f;
    for (int r = lo; r < hi; ++r) s_dcum[r] += after;
  }
  __syncthreads();
  float da_dt = 0.f;
  for (int r = tid; r < c; r += blockDim.x) {
    const long long t = t0 + r;
    if (t < p.S) {
      p.ddt[(b * (long long)p.S + t) * p.H + h] = s_ddt[r] + a_h * s_dcum[r];
      da_dt = fmaf(s_dt[r], s_dcum[r], da_dt);
    }
  }
  const float dA = block_sum(da_dt, s_red);
  if (tid == 0) p.dA_part[((long long)b * p.nc + z) * p.H + h] = dA;
}

// ---------------------------------------------------------------------------
// the chunk kernel, one block per (b, h, chunk)

size_t chunk_smem(int P, int N, int chunk) {
  const int cpad = (chunk + TILE - 1) / TILE * TILE;
  return sizeof(float) * ((size_t)P * (N + 1)        // in_z, then dS
                          + 2 * TILE * (N + 1)       // C / B tiles
                          + 2 * TILE * (MAX_P + 1)   // dy / u tiles
                          + 2 * TILE * SP            // two 64 x 64 tiles
                          + 4 * cpad + 8);           // cum, dt, dcum, red
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, c = p.chunk, NS = N + 1, VS = MAX_P + 1;
  const int cpad = (c + TILE - 1) / TILE * TILE;
  float* s_st = smem;                  // P x NS: in_z, then dS_z
  float* s_r1 = s_st + P * NS;         // TILE x NS
  float* s_k1 = s_r1 + TILE * NS;      // TILE x NS
  float* s_r2 = s_k1 + TILE * NS;      // TILE x VS
  float* s_k2 = s_r2 + TILE * VS;      // TILE x VS
  float* s_m = s_k2 + TILE * VS;       // TILE x SP
  float* s_m2 = s_m + TILE * SP;       // TILE x SP
  float* s_cum = s_m2 + TILE * SP;     // cpad
  float* s_dt = s_cum + cpad;          // cpad
  float* s_dcum = s_dt + cpad;         // cpad
  float* s_ddt = s_dcum + cpad;        // cpad: du . x
  float* s_red = s_ddt + cpad;         // 8

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, z = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, grp = h / (p.H / p.G);
  const long long t0 = (long long)z * c;
  const float a_h = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.B) + b * p.B_sb + grp * p.B_sg;
  const T* cg = static_cast<const T*>(p.C) + b * p.C_sb + grp * p.C_sg;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const long long sz = ((long long)bh * p.nc + z) * P * N;

  chunk_cum(s_cum, dtg, p.dt_ss, t0, c, p.S, a_h);
  for (int r = tid; r < cpad; r += THREADS) {
    const long long t = t0 + r;
    s_dt[r] = (r < c && t < p.S) ? dtg[t * p.dt_ss] : 0.f;
    s_dcum[r] = 0.f;
  }
  const float total = s_cum[c - 1];
  // in_z into s_st
  for (int e = tid; e < P * N; e += THREADS) {
    const int r = e / N, k = e - r * N;
    s_st[r * NS + k] = p.states[sz + e];
  }
  __syncthreads();

  int pc[4], nc_[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) pc[q] = min(tx + 16 * q, P - 1);
#pragma unroll
  for (int q = 0; q < 8; ++q) nc_[q] = min(tx + 16 * q, N - 1);
  const int nblk = cpad / TILE;

  // ---- the row side: per query block I, dC and rowsum(M) + inter ------
  for (int I = 0; I < nblk; ++I) {
    const int i0 = I * TILE;
    __syncthreads();
    load_rows(s_r1, NS, cg, p.C_ss, t0, i0, c, p.S, N);
    load_rows(s_r2, VS, dyg, p.dy_ss, t0, i0, c, p.S, P);
    __syncthreads();
    // dC_inter = exp(cum_i) (dy_i in_z), and its row dot with C_i
    float dc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) dc[a][q] = 0.f;
    for (int k = 0; k < P; ++k) {
      float dv[4], sv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = s_r2[(ty + 16 * a) * VS + k];
#pragma unroll
      for (int q = 0; q < 8; ++q) sv[q] = s_st[k * NS + nc_[q]];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) dc[a][q] = fmaf(dv[a], sv[q], dc[a][q]);
    }
    float rm[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      const float e = i < c ? expf(s_cum[i]) : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        dc[a][q] *= e;
        if (tx + 16 * q < N) dot = fmaf(s_r1[(ty + 16 * a) * NS + tx + 16 * q],
                                        dc[a][q], dot);
      }
      rm[a] = dot;
    }
    for (int J = 0; J <= I; ++J) {
      const int j0 = J * TILE;
      __syncthreads();
      load_rows(s_k1, NS, bg, p.B_ss, t0, j0, c, p.S, N);
      load_rows(s_k2, VS, xg, p.x_ss, t0, j0, c, p.S, P, s_dt);
      __syncthreads();
      float cb[4][4] = {}, gg[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = s_r1[(ty + 16 * a) * NS + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = s_k1[(tx + 16 * q) * NS + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) cb[a][q] = fmaf(cv[a], bv[q], cb[a][q]);
      }
      for (int k = 0; k < P; ++k) {
        float dv[4], uv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = s_r2[(ty + 16 * a) * VS + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) uv[q] = s_k2[(tx + 16 * q) * VS + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) gg[a][q] = fmaf(dv[a], uv[q], gg[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx + 16 * q;
          const float dcb = (j <= i && i < c)
                                ? gg[a][q] * expf(s_cum[i] - s_cum[j])
                                : 0.f;
          rm[a] = fmaf(dcb, cb[a][q], rm[a]);
          s_m[(ty + 16 * a) * SP + tx + 16 * q] = dcb;
        }
      }
      __syncthreads();
      const int kr = min(TILE, c - j0);
      for (int r = 0; r < kr; ++r) {
        float mv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = s_m[(ty + 16 * a) * SP + r];
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = s_k1[r * NS + nc_[q]];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q) dc[a][q] = fmaf(mv[a], bv[q], dc[a][q]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float s = half_warp_sum(rm[a]);
      const int i = i0 + ty + 16 * a;
      if (tx == 0 && i < c) s_dcum[i] += s;
      const long long t = t0 + i;
      if (i < c && t < p.S) {
        float* o = p.dC_part + ((b * (long long)p.S + t) * p.H + h) * N;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (tx + 16 * q < N) o[tx + 16 * q] = dc[a][q];
      }
    }
  }

  // ---- dS_z into s_st, and exp(total) <in_z, dS_z> ------------------------
  __syncthreads();
  float pass = 0.f;
  for (int e = tid; e < P * N; e += THREADS) {
    const int r = e / N, k = e - r * N;
    const float d = p.dS[sz + e];
    pass = fmaf(s_st[r * NS + k], d, pass);
    s_st[r * NS + k] = d;
  }
  const float passing = expf(total) * block_sum(pass, s_red);
  float dtotal_part = 0.f;

  // ---- the column side: per key block J, du, dB, colsum(M), state terms --
  for (int J = 0; J < nblk; ++J) {
    const int j0 = J * TILE;
    __syncthreads();
    load_rows(s_r1, NS, bg, p.B_ss, t0, j0, c, p.S, N);
    load_rows(s_r2, VS, xg, p.x_ss, t0, j0, c, p.S, P, s_dt);
    __syncthreads();
    // state terms: du = w (B dS^T), dB = w (u dS), rows j = ty + 16a
    float du[4][4] = {}, db[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) db[a][q] = 0.f;
    for (int k = 0; k < N; ++k) {
      float bv[4], sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = s_r1[(ty + 16 * a) * NS + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = s_st[pc[q] * NS + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) du[a][q] = fmaf(bv[a], sv[q], du[a][q]);
    }
    for (int k = 0; k < P; ++k) {
      float uv[4], sv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) uv[a] = s_r2[(ty + 16 * a) * VS + k];
#pragma unroll
      for (int q = 0; q < 8; ++q) sv[q] = s_st[k * NS + nc_[q]];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) db[a][q] = fmaf(uv[a], sv[q], db[a][q]);
    }
    // sb: B . dB_state on the row (it enters d cum negated and d total
    // as it is); cm: colsum(M), summed over the query blocks below
    float sb[4], cm[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      const float w = j < c ? expf(total - s_cum[j]) : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) du[a][q] *= w;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        db[a][q] *= w;
        if (tx + 16 * q < N)
          dot = fmaf(s_r1[(ty + 16 * a) * NS + tx + 16 * q], db[a][q], dot);
      }
      sb[a] = dot;
      cm[a] = 0.f;
    }
    for (int I = J; I < nblk; ++I) {
      const int i0 = I * TILE;
      __syncthreads();
      load_rows(s_k1, NS, cg, p.C_ss, t0, i0, c, p.S, N);
      load_rows(s_k2, VS, dyg, p.dy_ss, t0, i0, c, p.S, P);
      __syncthreads();
      // transposed tiles: rows j = ty + 16a, columns i = tx + 16q
      float cb[4][4] = {}, gg[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float bv[4], cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = s_r1[(ty + 16 * a) * NS + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) cv[q] = s_k1[(tx + 16 * q) * NS + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) cb[a][q] = fmaf(bv[a], cv[q], cb[a][q]);
      }
      for (int k = 0; k < P; ++k) {
        float uv[4], dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) uv[a] = s_r2[(ty + 16 * a) * VS + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) dv[q] = s_k2[(tx + 16 * q) * VS + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) gg[a][q] = fmaf(uv[a], dv[q], gg[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + ty + 16 * a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + tx + 16 * q;
          const float l = (j <= i && i < c) ? expf(s_cum[i] - s_cum[j]) : 0.f;
          const float dcb = gg[a][q] * l;
          cm[a] = fmaf(dcb, cb[a][q], cm[a]);
          s_m[(ty + 16 * a) * SP + tx + 16 * q] = cb[a][q] * l;
          s_m2[(ty + 16 * a) * SP + tx + 16 * q] = dcb;
        }
      }
      __syncthreads();
      const int kr = min(TILE, c - i0);
      for (int r = 0; r < kr; ++r) {
        float pv[4], mv[4], dv[4], cv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = s_m[(ty + 16 * a) * SP + r];
          mv[a] = s_m2[(ty + 16 * a) * SP + r];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dv[q] = s_k2[r * VS + pc[q]];
#pragma unroll
        for (int q = 0; q < 8; ++q) cv[q] = s_k1[r * NS + nc_[q]];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int q = 0; q < 4; ++q) du[a][q] = fmaf(pv[a], dv[q], du[a][q]);
#pragma unroll
          for (int q = 0; q < 8; ++q) db[a][q] = fmaf(mv[a], cv[q], db[a][q]);
        }
      }
    }
    // the key block's rows: dx = du dt, du . x, dB, and d cum's column
    // and state terms
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      const long long t = t0 + j;
      const bool ok = j < c && t < p.S;
      float dxx = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = tx + 16 * q;
        if (ok && col < P)
          dxx = fmaf(du[a][q], load_f(xg + t * p.x_ss + col), dxx);
      }
      dxx = half_warp_sum(dxx);
      const float sbs = half_warp_sum(sb[a]);
      const float cms = half_warp_sum(cm[a]);
      if (tx == 0 && j < c) {
        s_dcum[j] -= sbs + cms;
        s_ddt[j] = dxx;
        dtotal_part += sbs;
      }
      if (ok) {
        T* o = static_cast<T*>(p.dx) +
               ((b * (long long)p.S + t) * p.H + h) * P;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (tx + 16 * q < P) store_f(o + tx + 16 * q, du[a][q] * s_dt[j]);
        float* ob = p.dB_part + ((b * (long long)p.S + t) * p.H + h) * N;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (tx + 16 * q < N) ob[tx + 16 * q] = db[a][q];
      }
    }
  }

  finish_chunk(p, s_dt, s_dcum, s_ddt, s_red,
               block_sum(dtotal_part, s_red) + passing, t0, c, b, h, z, a_h);
}

// ---------------------------------------------------------------------------
// bf16: the chunk kernel on mma.sync m16n8k16, one block per (b, h, chunk)
// of four warps, each warp 16 rows of a 64-row sub-block.  Operands are
// bf16 tiles in shared memory (x, dy, B, C as given, each p padded to 64
// and n to NT with zeros), read by ldmatrix; the fp32 products' scores are
// fed back from registers as A fragments (dCB rounded to bf16 once, CB o L
// as a hi / lo pair); the states enter as hi / lo bf16 pairs (two products
// each), so they keep ~16 of fp32's mantissa bits.  u = x dt is never
// formed: dt_j scales the products' columns or rows in fp32.

constexpr int MT_THREADS = 128;
constexpr int PT = 64;        // p, zero-padded
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the multi-function unit (ex2.approx, ~2 ulp): the decays of the
// mma kernels, whose products round their operands to bf16 anyway
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[NJ] += A (16 rows from arow of a row-major tile of KC columns) *
// B^T, B a tile stored [n][k] (KC columns): NJ n8-tiles of its rows
template <int KC, int NJ>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[NJ][4],
                                            const __nv_bfloat16* As, int arow,
                                            const __nv_bfloat16* Bs,
                                            int lane) {
  const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    uint32_t a[4];
    mma::ldmatrix_x4(a, As + mma::tile_off<KC>(arow + r8 + (mi & 1) * 8,
                                               2 * kk + (mi >> 1)));
#pragma unroll
    for (int nb = 0; nb < NJ; nb += 2) {
      uint32_t bb[4];
      mma::ldmatrix_x4(bb, Bs + mma::tile_off<KC>(nb * 8 + r8 + (mi >> 1) * 8,
                                                  2 * kk + (mi & 1)));
      const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
      mma::mma_16816(acc[nb], a, b0);
      mma::mma_16816(acc[nb + 1], a, b1);
    }
  }
}

// acc[NJ] += A (16 rows from arow of a row-major tile of KC columns) * B,
// B a tile stored [k][n] (NC columns) read through ldmatrix.trans
template <int KC, int NC, int NJ>
__device__ __forceinline__ void mma_rows_kn(float (&acc)[NJ][4],
                                            const __nv_bfloat16* As, int arow,
                                            const __nv_bfloat16* Bs,
                                            int lane) {
  const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    uint32_t a[4];
    mma::ldmatrix_x4(a, As + mma::tile_off<KC>(arow + r8 + (mi & 1) * 8,
                                               2 * kk + (mi >> 1)));
#pragma unroll
    for (int nb = 0; nb < NJ; nb += 2) {
      uint32_t bb[4];
      mma::ldmatrix_x4_trans(
          bb, Bs + mma::tile_off<NC>(kk * 16 + r8 + (mi & 1) * 8,
                                     nb + (mi >> 1)));
      const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
      mma::mma_16816(acc[nb], a, b0);
      mma::mma_16816(acc[nb + 1], a, b1);
    }
  }
}

// acc[NJ] += S * B, S the warp's 16 x 64 fp32 scores (8 n8-tiles) rounded
// to bf16 as A fragments, B a 64-row tile stored [k][n] (NC columns)
template <int NC, int NJ>
__device__ __forceinline__ void mma_scores_kn(float (&acc)[NJ][4],
                                              const float (&sc)[8][4],
                                              const __nv_bfloat16* Bs,
                                              int lane) {
  const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float(&s0)[4] = sc[2 * kk];
    const float(&s1)[4] = sc[2 * kk + 1];
    const uint32_t a[4] = {mma::pack_bf16(s0[0], s0[1]),
                           mma::pack_bf16(s0[2], s0[3]),
                           mma::pack_bf16(s1[0], s1[1]),
                           mma::pack_bf16(s1[2], s1[3])};
#pragma unroll
    for (int nb = 0; nb < NJ; nb += 2) {
      uint32_t bb[4];
      mma::ldmatrix_x4_trans(
          bb, Bs + mma::tile_off<NC>(kk * 16 + r8 + (mi & 1) * 8,
                                     nb + (mi >> 1)));
      const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
      mma::mma_16816(acc[nb], a, b0);
      mma::mma_16816(acc[nb + 1], a, b1);
    }
  }
}

// mma_scores_kn with the scores as a hi / lo bf16 pair (two products):
// du's product, so that ddt = du . x, a difference of large sums, keeps
// ~16 bits of each score
template <int NC, int NJ>
__device__ __forceinline__ void mma_scores_kn_pair(float (&acc)[NJ][4],
                                                   const float (&sc)[8][4],
                                                   const __nv_bfloat16* Bs,
                                                   int lane) {
  const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4], al[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* v = sc[2 * kk + (q >> 1)] + 2 * (q & 1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
      const float2 hf = __bfloat1622float2(hi);
      a[q] = *reinterpret_cast<const uint32_t*>(&hi);
      al[q] = mma::pack_bf16(v[0] - hf.x, v[1] - hf.y);
    }
#pragma unroll
    for (int nb = 0; nb < NJ; nb += 2) {
      uint32_t bb[4];
      mma::ldmatrix_x4_trans(
          bb, Bs + mma::tile_off<NC>(kk * 16 + r8 + (mi & 1) * 8,
                                     nb + (mi >> 1)));
      const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
      mma::mma_16816(acc[nb], a, b0);
      mma::mma_16816(acc[nb + 1], a, b1);
      mma::mma_16816(acc[nb], al, b0);
      mma::mma_16816(acc[nb + 1], al, b1);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int i = 0; i < NJ; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// element (r, col) of a swizzled tile of COLS columns, as fp32
template <int COLS>
__device__ __forceinline__ float tile_at(const __nv_bfloat16* t, int r,
                                         int col) {
  return __bfloat162float(t[mma::tile_off<COLS>(r, col >> 3) + (col & 7)]);
}

template <int NT>
size_t chunk_mma_smem(int chunk) {
  const int cpad = (chunk + TILE - 1) / TILE * TILE;
  return sizeof(__nv_bfloat16) * (5 * TILE * NT + 3 * TILE * PT) +
         sizeof(float) * (4 * cpad + 8);
}

// the block's 64-row tile of an (s, cols) bf16 operand at rows [r0, r0 +
// 64) of the chunk at t0, zero past the chunk, S and cols
template <int COLS>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long rs,
                                      long long t0, int r0, int c, int S,
                                      int cols, bool vec) {
  const long long first = t0 + r0;
  const int rows = max(0, (int)min((long long)min(TILE, c - r0),
                                   (long long)S - first));
  mma::load_tile<TILE, COLS>(dst, src + first * rs, rs, rows, cols, vec,
                             threadIdx.x, MT_THREADS);
}

template <int NT>
__global__ void __launch_bounds__(MT_THREADS, 2)
    ssd_bwd_chunk_mma_kernel(BwdParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* R1 = reinterpret_cast<bf16*>(smem_raw);   // TILE x NT: C_I or B_J
  bf16* K1r = R1 + TILE * NT;                     // 2 x TILE x NT: B_J or C_I
  bf16* SH = K1r + 2 * TILE * NT;                 // PT x NT: state, hi
  bf16* SL = SH + TILE * NT;                      // PT x NT: state, lo
  bf16* R2 = SL + TILE * NT;                      // TILE x PT: dy_I or x_J
  bf16* K2r = R2 + TILE * PT;                     // 2 x TILE x PT: x_J or dy_I
  const int P = p.P, N = p.N, c = p.chunk;
  const int cpad = (c + TILE - 1) / TILE * TILE;
  float* s_cum = reinterpret_cast<float*>(K2r + 2 * TILE * PT);
  float* s_dt = s_cum + cpad;
  float* s_dcum = s_dt + cpad;
  float* s_ddt = s_dcum + cpad;
  float* s_red = s_ddt + cpad;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, wr = warp * 16;
  const int bh = blockIdx.x, z = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, grp = h / (p.H / p.G);
  const long long t0 = (long long)z * c;
  const float a_h = p.A[h];
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const bf16* bg = static_cast<const bf16*>(p.B) + b * p.B_sb + grp * p.B_sg;
  const bf16* cg = static_cast<const bf16*>(p.C) + b * p.C_sb + grp * p.C_sg;
  const bf16* dyg = static_cast<const bf16*>(p.dy) + b * p.dy_sb +
                    h * p.dy_sh;
  const long long sz = ((long long)bh * p.nc + z) * P * N;
  const bool vec_x = p.vec_x, vec_dy = p.vec_dy, vec_bc = p.vec_bc;

  chunk_cum(s_cum, dtg, p.dt_ss, t0, c, p.S, a_h);
  // cum in log2 units from here on: every decay is one ex2.approx
  for (int r = tid; r < cpad; r += MT_THREADS) {
    const long long t = t0 + r;
    s_dt[r] = (r < c && t < p.S) ? dtg[t * p.dt_ss] : 0.f;
    s_dcum[r] = 0.f;
    s_ddt[r] = 0.f;
    if (r < c) s_cum[r] *= LOG2E;
  }
  __syncthreads();
  const float total = s_cum[c - 1];
  // in_z as hi / lo pairs, zero past P and N
  for (int e = tid; e < PT * NT; e += MT_THREADS) {
    const int r = e / NT, k = e - r * NT;
    const float v = (r < P && k < N) ? p.states[sz + r * N + k] : 0.f;
    const bf16 hi = __float2bfloat16(v);
    const bf16 lo = __float2bfloat16(v - __bfloat162float(hi));
    const int off = mma::tile_off<NT>(r, k >> 3) + (k & 7);
    SH[off] = hi;
    SL[off] = lo;
  }
  __syncthreads();
  const int nblk = cpad / TILE;

  // ---- the row side: per query block I, dC and rowsum(M) + inter ---------
  // the key tiles ride a ring of two: tile J + 1 is copied while tile J's
  // products run
  for (int I = 0; I < nblk; ++I) {
    const int i0 = I * TILE;
    const int ri[2] = {i0 + wr + g, i0 + wr + g + 8};
    float dc[NT / 8][4];
    float rm[2] = {0.f, 0.f};
    __syncthreads();
    stage<NT>(R1, cg, p.C_ss, t0, i0, c, p.S, N, vec_bc);
    stage<PT>(R2, dyg, p.dy_ss, t0, i0, c, p.S, P, vec_dy);
    stage<NT>(K1r, bg, p.B_ss, t0, 0, c, p.S, N, vec_bc);
    stage<PT>(K2r, xg, p.x_ss, t0, 0, c, p.S, P, vec_x);
    mma::cp_async_commit();
    for (int J = 0; J <= I; ++J) {
      const int j0 = J * TILE;
      const bf16* K1 = K1r + (J & 1) * TILE * NT;
      const bf16* K2 = K2r + (J & 1) * TILE * PT;
      if (J < I) {
        stage<NT>(K1r + ((J + 1) & 1) * TILE * NT, bg, p.B_ss, t0, j0 + TILE,
                  c, p.S, N, vec_bc);
        stage<PT>(K2r + ((J + 1) & 1) * TILE * PT, xg, p.x_ss, t0, j0 + TILE,
                  c, p.S, P, vec_x);
        mma::cp_async_commit();
        mma::cp_async_wait<1>();
      } else {
        mma::cp_async_wait<0>();
      }
      __syncthreads();
      if (J == 0) {
        // dC_inter = exp(cum_i) (dy_i in_z), and its row dot with C_i
        zero(dc);
        mma_rows_kn<PT, NT>(dc, R2, wr, SH, lane);
        mma_rows_kn<PT, NT>(dc, R2, wr, SL, lane);
        const float e0 = ri[0] < c ? exp2_approx(s_cum[ri[0]]) : 0.f;
        const float e1 = ri[1] < c ? exp2_approx(s_cum[ri[1]]) : 0.f;
#pragma unroll
        for (int nb = 0; nb < NT / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nb * 8 + 2 * tig + (e & 1);
            dc[nb][e] *= (e < 2) ? e0 : e1;
            rm[e >> 1] +=
                dc[nb][e] * tile_at<NT>(R1, wr + g + (e >> 1) * 8, col);
          }
      }
      float cb[8][4], gg[8][4];
      zero(cb);
      zero(gg);
      mma_rows_nk<NT, 8>(cb, R1, wr, K1, lane);
      mma_rows_nk<PT, 8>(gg, R2, wr, K2, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ri[e >> 1], j = j0 + nb * 8 + 2 * tig + (e & 1);
          const float dcb = (j <= i && i < c)
                                ? gg[nb][e] * s_dt[j] *
                                      exp2_approx(s_cum[i] - s_cum[j])
                                : 0.f;
          rm[e >> 1] += dcb * cb[nb][e];
          gg[nb][e] = dcb;
        }
      mma_scores_kn<NT, NT / 8>(dc, gg, K1, lane);
      __syncthreads();   // tile J's buffer is refilled next
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rm[r] += __shfl_xor_sync(0xffffffffu, rm[r], 1);
      rm[r] += __shfl_xor_sync(0xffffffffu, rm[r], 2);
      const int i = ri[r];
      if (tig == 0 && i < c) s_dcum[i] += rm[r];
      const long long t = t0 + i;
      if (i < c && t < p.S) {
        float* o = p.dC_part + ((b * (long long)p.S + t) * p.H + h) * N;
#pragma unroll
        for (int nb = 0; nb < NT / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nb * 8 + 2 * tig + e;
            if (col < N) o[col] = dc[nb][2 * r + e];
          }
      }
    }
  }

  // ---- dS_z as hi / lo pairs, and exp(total) <in_z, dS_z> ----------------
  __syncthreads();
  float pass = 0.f;
  for (int e = tid; e < PT * NT; e += MT_THREADS) {
    const int r = e / NT, k = e - r * NT;
    const int off = mma::tile_off<NT>(r, k >> 3) + (k & 7);
    const float d = (r < P && k < N) ? p.dS[sz + r * N + k] : 0.f;
    pass = fmaf(__bfloat162float(SH[off]) + __bfloat162float(SL[off]), d,
                pass);
    const bf16 hi = __float2bfloat16(d);
    SH[off] = hi;
    SL[off] = __float2bfloat16(d - __bfloat162float(hi));
  }
  const float passing = exp2_approx(total) * block_sum(pass, s_red);
  float dtotal_part = 0.f;

  // ---- the column side: per key block J, du, dB, colsum(M), state terms --
  for (int J = 0; J < nblk; ++J) {
    const int j0 = J * TILE;
    const int rj[2] = {j0 + wr + g, j0 + wr + g + 8};
    float du[8][4], db[NT / 8][4];
    float sb[2] = {0.f, 0.f}, cm[2] = {0.f, 0.f};
    __syncthreads();
    stage<NT>(R1, bg, p.B_ss, t0, j0, c, p.S, N, vec_bc);
    stage<PT>(R2, xg, p.x_ss, t0, j0, c, p.S, P, vec_x);
    stage<NT>(K1r, cg, p.C_ss, t0, j0, c, p.S, N, vec_bc);
    stage<PT>(K2r, dyg, p.dy_ss, t0, j0, c, p.S, P, vec_dy);
    mma::cp_async_commit();
    for (int I = J; I < nblk; ++I) {
      const int i0 = I * TILE;
      const bf16* K1 = K1r + ((I - J) & 1) * TILE * NT;
      const bf16* K2 = K2r + ((I - J) & 1) * TILE * PT;
      if (I + 1 < nblk) {
        stage<NT>(K1r + ((I - J + 1) & 1) * TILE * NT, cg, p.C_ss, t0,
                  i0 + TILE, c, p.S, N, vec_bc);
        stage<PT>(K2r + ((I - J + 1) & 1) * TILE * PT, dyg, p.dy_ss, t0,
                  i0 + TILE, c, p.S, P, vec_dy);
        mma::cp_async_commit();
        mma::cp_async_wait<1>();
      } else {
        mma::cp_async_wait<0>();
      }
      __syncthreads();
      if (I == J) {
        // state terms: du = w (B dS^T), dB = w dt (x dS)
        zero(du);
        zero(db);
        mma_rows_nk<NT, 8>(du, R1, wr, SH, lane);
        mma_rows_nk<NT, 8>(du, R1, wr, SL, lane);
        mma_rows_kn<PT, NT>(db, R2, wr, SH, lane);
        mma_rows_kn<PT, NT>(db, R2, wr, SL, lane);
        float w[2], wd[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          w[r] = rj[r] < c ? exp2_approx(total - s_cum[rj[r]]) : 0.f;
          wd[r] = rj[r] < c ? w[r] * s_dt[rj[r]] : 0.f;
        }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) du[nb][e] *= w[e >> 1];
#pragma unroll
        for (int nb = 0; nb < NT / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nb * 8 + 2 * tig + (e & 1);
            db[nb][e] *= wd[e >> 1];
            sb[e >> 1] +=
                db[nb][e] * tile_at<NT>(R1, wr + g + (e >> 1) * 8, col);
          }
      }
      // transposed tiles: rows j, columns i
      float cb[8][4], gg[8][4];
      zero(cb);
      zero(gg);
      mma_rows_nk<NT, 8>(cb, R1, wr, K1, lane);
      mma_rows_nk<PT, 8>(gg, R2, wr, K2, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = rj[e >> 1], i = i0 + nb * 8 + 2 * tig + (e & 1);
          const float l =
              (j <= i && i < c) ? exp2_approx(s_cum[i] - s_cum[j]) : 0.f;
          const float dcb = gg[nb][e] * s_dt[j] * l;
          cm[e >> 1] += dcb * cb[nb][e];
          cb[nb][e] *= l;
          gg[nb][e] = dcb;
        }
      mma_scores_kn_pair<PT, 8>(du, cb, K2, lane);
      mma_scores_kn<NT, NT / 8>(db, gg, K1, lane);
      __syncthreads();   // tile I's buffer is refilled next
    }
    // the key block's rows: dx = du dt, du . x, dB, d cum's column and
    // state terms
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = rj[r];
      const long long t = t0 + j;
      const bool ok = j < c && t < p.S;
      float dxx = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nb * 8 + 2 * tig + e;
          dxx += du[nb][2 * r + e] * tile_at<PT>(R2, wr + g + r * 8, col);
        }
      float v[3] = {dxx, sb[r], cm[r]};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 1);
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 2);
      }
      if (tig == 0 && j < c) {
        s_dcum[j] -= v[1] + v[2];
        s_ddt[j] = v[0];
        dtotal_part += v[1];
      }
      if (ok) {
        const float dtj = s_dt[j];
        bf16* o = static_cast<bf16*>(p.dx) +
                  ((b * (long long)p.S + t) * p.H + h) * P;
        float* ob = p.dB_part + ((b * (long long)p.S + t) * p.H + h) * N;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nb * 8 + 2 * tig + e;
            if (col < P) o[col] = __float2bfloat16(du[nb][2 * r + e] * dtj);
          }
#pragma unroll
        for (int nb = 0; nb < NT / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nb * 8 + 2 * tig + e;
            if (col < N) ob[col] = db[nb][2 * r + e];
          }
      }
    }
  }
  finish_chunk(p, s_dt, s_dcum, s_ddt, s_red,
               block_sum(dtotal_part, s_red) + passing, t0, c, b, h, z, a_h);
}

// The state walks (bf16), each in two kernels so that every chunk is a
// block of its own: ssd_bwd_own_mma_kernel<NT, FWD>, grid (b*h, chunks)
// of four warps, each 16 rows p of the chunk's own addition in its fp32
// accumulators: forward (x o dt exp(total - cum))^T B, backward (dy o
// exp(cum))^T C (the rows copied as they are, scaled in shared memory and
// split into a hi / lo bf16 pair, read through ldmatrix.trans as the A
// operand; B or C read as stored), written to the states or the dS
// scratch (and, forward, exp(total) to tot (b, h, chunks)); then
// ssd_bwd_pass_kernel<FWD>, one thread per (b, h, p, n), in place over the
// scratch: forward in_z in chunk order, backward dS_z = d in from the last
// chunk to the first.  (One block walking each (b, h) left the card with
// b*h blocks: 0.54 ms for the d-state at the training shape, against 0.74
// ms for the scalar walk; these two kernels 0.117 + 0.039.)
template <int NT>
size_t own_mma_smem(int chunk) {
  const int cpad = (chunk + TILE - 1) / TILE * TILE;
  return sizeof(__nv_bfloat16) * (TILE * NT + 2 * TILE * PT) +
         sizeof(float) * cpad;
}

template <int NT, bool FWD>
__global__ void __launch_bounds__(MT_THREADS)
    ssd_bwd_own_mma_kernel(BwdParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);   // TILE x NT
  bf16* Ds = Cs + TILE * NT;                      // TILE x PT: dy exp(cum)
  bf16* Dl = Ds + TILE * PT;                      // what Ds leaves over
  float* s_cum = reinterpret_cast<float*>(Dl + TILE * PT);
  const int P = p.P, N = p.N, c = p.chunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, wr = warp * 16;
  const int r8 = lane & 7, mi = lane >> 3;
  const int bh = blockIdx.x, z = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, grp = h / (p.H / p.G);
  const long long t0 = (long long)z * c;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  // the forward's walk: x dt exp(total - cum) and B; the backward's: dy
  // exp(cum) and C
  const bf16* mg = FWD ? static_cast<const bf16*>(p.B) + b * p.B_sb +
                             grp * p.B_sg
                       : static_cast<const bf16*>(p.C) + b * p.C_sb +
                             grp * p.C_sg;
  const long long m_ss = FWD ? p.B_ss : p.C_ss;
  const bf16* vg = FWD ? static_cast<const bf16*>(p.x) + b * p.x_sb +
                             h * p.x_sh
                       : static_cast<const bf16*>(p.dy) + b * p.dy_sb +
                             h * p.dy_sh;
  const long long v_ss = FWD ? p.x_ss : p.dy_ss;
  chunk_cum(s_cum, dtg, p.dt_ss, t0, c, p.S, p.A[h]);
  const float total = s_cum[c - 1];
  float acc[NT / 8][4];
  zero(acc);
  __syncthreads();
  for (int r = tid; r < c; r += MT_THREADS) {
    const long long t = t0 + r;
    s_cum[r] = FWD ? (t < p.S ? dtg[t * p.dt_ss] : 0.f) *
                         expf(total - s_cum[r])
                   : expf(s_cum[r]);
  }
  for (int r0 = 0; r0 < c; r0 += TILE) {
    __syncthreads();
    stage<NT>(Cs, mg, m_ss, t0, r0, c, p.S, N, p.vec_bc);
    stage<PT>(Ds, vg, v_ss, t0, r0, c, p.S, P,
              FWD ? p.vec_x : p.vec_dy);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    // dy o exp(cum) in place as a hi / lo bf16 pair (rows past the chunk
    // and S are zeros already): the d-states keep ~16 bits, which dA's
    // sums need
    for (int e = tid; e < TILE * PT; e += MT_THREADS) {
      const int r = e / PT, k = e - r * PT;
      const int off = mma::tile_off<PT>(r, k >> 3) + (k & 7);
      const float v = r0 + r < c
                          ? __bfloat162float(Ds[off]) * s_cum[r0 + r] : 0.f;
      const bf16 hi = __float2bfloat16(v);
      Ds[off] = hi;
      Dl[off] = __float2bfloat16(v - __bfloat162float(hi));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a[4], al[4];
      const int at = mma::tile_off<PT>(kk * 16 + r8 + (mi >> 1) * 8,
                                       wr / 8 + (mi & 1));
      mma::ldmatrix_x4_trans(a, Ds + at);
      mma::ldmatrix_x4_trans(al, Dl + at);
#pragma unroll
      for (int nb = 0; nb < NT / 8; nb += 2) {
        uint32_t bb[4];
        mma::ldmatrix_x4_trans(
            bb, Cs + mma::tile_off<NT>(kk * 16 + r8 + (mi & 1) * 8,
                                       nb + (mi >> 1)));
        const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        mma::mma_16816(acc[nb], a, b0);
        mma::mma_16816(acc[nb + 1], a, b1);
        mma::mma_16816(acc[nb], al, b0);
        mma::mma_16816(acc[nb + 1], al, b1);
      }
    }
  }
  float* o = (FWD ? p.states : p.dS) + ((long long)bh * p.nc + z) * P * N;
#pragma unroll
  for (int nb = 0; nb < NT / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wr + g + (e >> 1) * 8, col = nb * 8 + 2 * tig + (e & 1);
      if (row < P && col < N) o[row * N + col] = acc[nb][e];
    }
  if (FWD && tid == 0) p.tot[(long long)bh * p.nc + z] = expf(total);
}

// PAIRS (the wgmma variant): each chunk's state is written in place as a
// hi / lo bf16 pair, (P, 2, N) in the bytes of its (P, N) fp32, the layout
// the chunk kernel's TMA map reads.  Row r of the pair spans the bytes of
// row r of the fp32 state, and a block holds whole rows (P N is a multiple
// of THREADS there), so the block reads a batch's chunks before it writes
// their pairs.
template <bool FWD, bool PAIRS>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_pass_kernel(BwdParams p) {
  const long long pn = (long long)p.P * p.N;
  const long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
  const bool live = e < (long long)p.Bn * p.H * pn;
  if (!PAIRS && !live) return;
  const long long bh = live ? e / pn : 0, k = live ? e - bh * pn : 0;
  float* __restrict__ st = (FWD ? p.states : p.dS) + bh * p.nc * pn + k;
  __nv_bfloat16* __restrict__ pr =
      reinterpret_cast<__nv_bfloat16*>(FWD ? p.states : p.dS) +
      bh * p.nc * pn * 2 + (k / p.N) * 2 * p.N + k % p.N;
  const float* __restrict__ tot = p.tot + bh * p.nc;
  constexpr int BATCH = 8;   // chunks whose loads are in flight together
  float carry = 0.f;
  for (int i0 = 0; i0 < p.nc; i0 += BATCH) {
    float own[BATCH], t[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int z = FWD ? i0 + i : p.nc - 1 - i0 - i;
      const bool ok = live && i0 + i < p.nc;
      own[i] = ok ? st[z * pn] : 0.f;
      t[i] = ok ? tot[z] : 0.f;
    }
    if (PAIRS) __syncthreads();
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int z = FWD ? i0 + i : p.nc - 1 - i0 - i;
      if (live && i0 + i < p.nc) {
        if (PAIRS) {
          const __nv_bfloat16 hi = __float2bfloat16(carry);
          pr[z * pn * 2] = hi;
          pr[z * pn * 2 + p.N] = __float2bfloat16(carry - __bfloat162float(hi));
        } else {
          st[z * pn] = carry;
        }
        carry = fmaf(carry, t[i], own[i]);
      }
    }
  }
}

// dB and dC: the partials of each group (its heads, or its bands) summed
// in order, in B's type; dA: the (b, chunk) partials summed in order.  One
// thread an element.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(BwdParams p) {
  const long long total = (long long)p.Bn * p.S * p.G * p.N;
  const int rep = p.parts / p.G;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * THREADS) {
    const int k = e % p.N;
    const long long rest = e / p.N;
    const int g = rest % p.G;
    const long long bt = rest / p.G;        // b * S + t
    const float* sb = p.dB_part + (bt * p.parts + g * rep) * p.N + k;
    const float* sc = p.dC_part + (bt * p.parts + g * rep) * p.N + k;
    float vb = 0.f, vc = 0.f;
    for (int r = 0; r < rep; ++r) {
      vb += sb[(long long)r * p.N];
      vc += sc[(long long)r * p.N];
    }
    store_f(static_cast<T*>(p.dB) + e, vb);
    store_f(static_cast<T*>(p.dC) + e, vc);
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < p.H; hh += THREADS) {
      float v = 0.f;
      for (long long i = 0; i < (long long)p.Bn * p.nc; ++i)
        v += p.dA_part[i * p.H + hh];
      p.dA[hh] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at the models' shapes (variant 2, "wgmma"): the chunk stage in band
// form, on wgmma fed by TMA (the header says why and how).

constexpr int WB_TILE = 64;        // rows of a query or key block
constexpr int WB_THREADS = 160;    // one consumer warpgroup, one producer warp
// heads a block takes at most (ssd_scan.py · backward_band chooses the band)
constexpr int WB_MAX_BAND = 4;
// the column side keeps a chunk column of C B^T in fp32 (64 KB at 256)
constexpr int WB_MAX_CHUNK = 256;
// n the kernels are built for (hymba's 16, mamba2's 128), never padded
constexpr int WB_WIDTHS[] = {16, 32, 64, 128};
constexpr int ERR_MAP = -3;   // a TMA tensor map could not be encoded

constexpr int round1k(int a) { return (a + 1023) / 1024 * 1024; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of a block: the home rows (C_I or B_J, then the band's dy
// or x tiles of the same 64 rows), a ring of two stages (a 64-row block of
// the other side, a head's state pair, or a head's dy tiles of a chunk
// column), the column side's
// C B^T cache (fp32, each thread's accumulator fragment in order, so its
// reads and writes are conflict free), cum, dt, d cum and du . x of the
// band's heads, the barriers, 1 KB to align the base to the 128-byte
// swizzle's period.  n 128: 230,576 bytes, one block a multiprocessor.
template <int N>
struct WbLayout {
  using Ct = hop::Tile64<N>;
  using Xt = hop::Tile64<64>;
  static constexpr int ROWS = round1k(Ct::BYTES + WB_MAX_BAND * Xt::BYTES);
  static constexpr int STAGE = round1k(imax(ROWS, 2 * Ct::BYTES));
  static constexpr int RING = ROWS;
  static constexpr int CACHE = RING + 2 * STAGE;
  static constexpr int ARRAYS =
      CACHE + (WB_MAX_CHUNK / WB_TILE) * 32 * 128 * 4;
  static constexpr int BARS =
      ARRAYS + 4 * (4 * WB_MAX_BAND * WB_MAX_CHUNK + 32);
  static constexpr int SMEM = BARS + 8 * 6 + 1024;
};

__device__ __forceinline__ float2 tile_pair(const unsigned char* tile,
                                            int off) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + off));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The chunk stage of the wgmma variant: one block per (b, chunk, band of
// `band` heads of one group), 160 threads, one consumer warpgroup (rows 16
// w + l / 4 and + 8 of every 64-row product) and a producer warp whose one
// thread brings every tile by TMA: the home rows through their own full /
// empty barriers, the rest through a ring of two stages, in the order the
// consumer takes them.  Rows past S read as zeros and dt there is 0.
//
// Row side, per query block I (home: C_I and the band's dy_I):
//   per head, dC_I += 2^cum_i (dy in)          (in as a hi / lo pair)
//             d cum_i += C_i . that
//   per key block J <= I (B_J and the band's x_J from the ring):
//     CB = C_I B_J^T once; per head G = dy_I x_J^T, dCB = G dt_j L (masked
//     on the diagonal), d cum_i += rowsum(dCB o CB), SdCB += dCB (fp32);
//     then dC_I += bf16(SdCB) B_J (A from registers).
// Column side, per key block J (home: B_J and the band's x_J):
//   per query block I >= J: CB^T = B_J C_I^T once, kept in the cache; per
//     head G^T = x_J dy_I^T, dCB^T, d cum_j -= colsum, SdCB^T += dCB^T;
//     dB_J += bf16(SdCB^T) C_I;
//   per head: dB_J += (2^(total - cum_j) dt_j) o (x_J dS), du = 2^(total -
//     cum_j) B_J dS^T (dS as a pair), d cum_j -= B_j . (2^(..) dt x dS) =
//     dt_j x_j . du_j; then per I >= J du += (CB^T o L^T) dy_I, the cached
//     scores decayed for the head as a hi / lo pair; dx = du dt, du . x.
// Then per head (a warp each) the reverse cumsum of d cum, ddt and the dA
// partial, as finish_chunk.  dB and dC leave as the band's fp32 partials.
// Every product waits for its result before its registers are read or
// written again, and every A fragment is packed before its product issues.
template <int N>
__global__ void __launch_bounds__(WB_THREADS, 1)
    ssd_bwd_chunk_wgmma_kernel(const BwdParams p,
                               const __grid_constant__ CUtensorMap tm_x,
                               const __grid_constant__ CUtensorMap tm_dy,
                               const __grid_constant__ CUtensorMap tm_b,
                               const __grid_constant__ CUtensorMap tm_c,
                               const __grid_constant__ CUtensorMap tm_in,
                               const __grid_constant__ CUtensorMap tm_ds) {
  using L = WbLayout<N>;
  using Ct = hop::Tile64<N>;
  using Xt = hop::Tile64<64>;
  constexpr int MB = WB_MAX_BAND, MC = WB_MAX_CHUNK, XB = Xt::BYTES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  float* s_cache = reinterpret_cast<float*>(sbase + L::CACHE);
  float* s_cum = reinterpret_cast<float*>(sbase + L::ARRAYS);  // log2 units
  float* s_dt = s_cum + MB * MC;
  float* s_dcum = s_dt + MB * MC;
  float* s_ddt = s_dcum + MB * MC;   // du . x
  float* s_red = s_ddt + MB * MC;    // 32
  const uint32_t hfull = base + L::BARS, hempty = hfull + 8,
                 full0 = hfull + 16, empty0 = full0 + 16;

  const int c = p.chunk, nq = c / WB_TILE;
  const int hpg = p.H / p.G, bpg = (hpg + p.band - 1) / p.band;
  long long rest = blockIdx.x;
  const int band = static_cast<int>(rest % bpg);
  rest /= bpg;
  const int grp = static_cast<int>(rest % p.G);
  rest /= p.G;
  const int z = static_cast<int>(rest % p.nc);
  const int b = static_cast<int>(rest / p.nc);
  const int h0 = grp * hpg + band * p.band;
  const int kh = min(p.band, hpg - band * p.band);
  const int part = grp * bpg + band, parts = p.G * bpg;
  const int t0 = z * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t rows_bytes = Ct::BYTES + kh * XB;

  if (tid == 0) {
    hop::mbar_init(hfull, 1);
    hop::mbar_init(hempty, 128);
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(full0 + 8 * s, 1);
      hop::mbar_init(empty0 + 8 * s, 128);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      hop::prefetch_map(&tm_x);
      hop::prefetch_map(&tm_dy);
      hop::prefetch_map(&tm_b);
      hop::prefetch_map(&tm_c);
      hop::prefetch_map(&tm_in);
      hop::prefetch_map(&tm_ds);
      int it = 0, hu = 0;
      uint32_t bar = 0;
      auto ring = [&](uint32_t bytes) {
        const int s = it & 1;
        if (it >= 2) hop::mbar_wait(empty0 + 8 * s, ((it >> 1) - 1) & 1);
        ++it;
        bar = full0 + 8 * s;
        hop::mbar_arrive_expect_tx(bar, bytes);
        return base + L::RING + s * L::STAGE;
      };
      auto home = [&]() {
        if (hu >= 1) hop::mbar_wait(hempty, (hu - 1) & 1);
        ++hu;
        bar = hfull;
        hop::mbar_arrive_expect_tx(bar, rows_bytes);
        return base;
      };
      // block blk's rows: the group's tile of mg, the band's tiles of mh
      auto rows = [&](uint32_t dst, const CUtensorMap* mg,
                      const CUtensorMap* mh, int blk) {
        const int row = t0 + blk * WB_TILE;
        Ct::load(dst, mg, grp, row, b, bar);
        for (int k = 0; k < kh; ++k)
          Xt::load(dst + Ct::BYTES + k * XB, mh, h0 + k, row, b, bar);
      };
      // head k's state pair (hi, lo) of this chunk
      auto pair = [&](uint32_t dst, const CUtensorMap* m, int k) {
        const int pr = (b * p.H + h0 + k) * p.nc + z;
        Ct::load(dst, m, 0, 0, pr, bar);
        Ct::load(dst + Ct::BYTES, m, 1, 0, pr, bar);
      };
      for (int I = 0; I < nq; ++I) {
        rows(home(), &tm_c, &tm_dy, I);
        for (int k = 0; k < kh; ++k) pair(ring(2 * Ct::BYTES), &tm_in, k);
        for (int J = 0; J <= I; ++J) rows(ring(rows_bytes), &tm_b, &tm_x, J);
      }
      for (int J = 0; J < nq; ++J) {
        rows(home(), &tm_b, &tm_x, J);
        for (int I = J; I < nq; ++I) rows(ring(rows_bytes), &tm_c, &tm_dy, I);
        for (int k = 0; k < kh; ++k) {
          pair(ring(2 * Ct::BYTES), &tm_ds, k);
          if (J == 0) pair(ring(2 * Ct::BYTES), &tm_in, k);
          // head k's dy of every query block I >= J, one item
          const uint32_t d = ring((nq - J) * XB);
          for (int I = J; I < nq; ++I)
            Xt::load(d + (I - J) * XB, &tm_dy, h0 + k, t0 + I * WB_TILE, b,
                     bar);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, tig = lane & 3;
  const int il[2] = {16 * warp + g, 16 * warp + g + 8};

  // cum (log2 units) and dt of the band's heads: warp k scans head k's
  // chunk as chunk_cum does, so the walks' cum and this one agree
  if (warp < kh) {
    const int hd = h0 + warp;
    const float a_h = p.A[hd];
    const float* dtg = p.dt + b * p.dt_sb + hd * p.dt_sh;
    float* cum = s_cum + warp * MC;
    float* dtk = s_dt + warp * MC;
    const int per = c / 32, lo = lane * per;
    float run = 0.f;
    for (int r = lo; r < lo + per; ++r) {
      const float d = t0 + r < p.S ? dtg[(long long)(t0 + r) * p.dt_ss] : 0.f;
      dtk[r] = d;
      if (t0 + r < p.S) run += d * a_h;
      cum[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
    for (int r = lo; r < lo + per; ++r) cum[r] = (cum[r] + before) * LOG2E;
  }
  hop::bar_sync(1, 128);

  int cit = 0, chu = 0;
  auto acquire = [&]() {
    const int s = cit & 1;
    hop::mbar_wait(full0 + 8 * s, (cit >> 1) & 1);
    return cit++;
  };
  auto stage_of = [&](int it) {
    return base + L::RING + (it & 1) * L::STAGE;
  };
  auto release = [&](int it) { hop::mbar_arrive(empty0 + 8 * (it & 1)); };
  auto home_wait = [&]() {
    hop::mbar_wait(hfull, chu & 1);
    ++chu;
  };

  float dtot[MB], pass[MB];   // per head: sum of B_j . (..), <in, dS>
#pragma unroll
  for (int k = 0; k < MB; ++k) dtot[k] = pass[k] = 0.f;

  // ---- the row side --------------------------------------------------------
  for (int I = 0; I < nq; ++I) {
    home_wait();
    const uint32_t hC = base, hD = base + Ct::BYTES;
    float dC[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dC[e] = 0.f;
    float rm[MB][2];
#pragma unroll
    for (int k = 0; k < MB; ++k) rm[k][0] = rm[k][1] = 0.f;

    // the entering states' terms, head by head
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      if (k >= kh) continue;
      const int it = acquire();
      const uint32_t st = stage_of(it);
      float tt[N / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_tb(tt, Xt::kmajor(hD + k * XB, kk), Ct::mnmajor(st, kk),
                         kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_tb(tt, Xt::kmajor(hD + k * XB, kk),
                         Ct::mnmajor(st + Ct::BYTES, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_operand(tt);
      release(it);
      const float* cum = s_cum + k * MC + I * WB_TILE;
      const float e2[2] = {hop::ex2(cum[il[0]]), hop::ex2(cum[il[1]])};
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 cv =
              tile_pair(sbase, Ct::offset(il[r], 8 * nb + 2 * tig));
          const float v0 = tt[4 * nb + 2 * r] * e2[r];
          const float v1 = tt[4 * nb + 2 * r + 1] * e2[r];
          rm[k][r] += v0 * cv.x + v1 * cv.y;
          dC[4 * nb + 2 * r] += v0;
          dC[4 * nb + 2 * r + 1] += v1;
        }
    }

    for (int J = 0; J <= I; ++J) {
      const int it = acquire();
      const uint32_t vs = stage_of(it);   // B_J, then the band's x_J
      const bool diag = J == I;
      float cb[32], sd[32], gg[32];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hop::wgmma_ss(cb, Ct::kmajor(hC, kk), Ct::kmajor(vs, kk), kk);
      hop::wgmma_commit();
#pragma unroll
      for (int e = 0; e < 32; ++e) sd[e] = 0.f;
#pragma unroll
      for (int k = 0; k < MB; ++k) {
        if (k >= kh) continue;
        // G = dy_I x_J^T of head k (with C B^T, for the first)
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss(gg, Xt::kmajor(hD + k * XB, kk),
                        Xt::kmajor(vs + Ct::BYTES + k * XB, kk), kk);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_operand(cb);
        hop::fence_operand(gg);
        const float* cum = s_cum + k * MC;
        const float* cj_ = cum + J * WB_TILE;
        const float* dj_ = s_dt + k * MC + J * WB_TILE;
        const float ci[2] = {cum[I * WB_TILE + il[0]],
                             cum[I * WB_TILE + il[1]]};
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int jl = 8 * nb + 2 * tig;
          const float2 cj = *reinterpret_cast<const float2*>(cj_ + jl);
          const float2 dj = *reinterpret_cast<const float2*>(dj_ + jl);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float v0 = gg[4 * nb + 2 * r] * dj.x * hop::ex2(ci[r] - cj.x);
            float v1 = gg[4 * nb + 2 * r + 1] * dj.y * hop::ex2(ci[r] - cj.y);
            if (diag) {
              v0 = jl <= il[r] ? v0 : 0.f;
              v1 = jl + 1 <= il[r] ? v1 : 0.f;
            }
            rm[k][r] += v0 * cb[4 * nb + 2 * r] + v1 * cb[4 * nb + 2 * r + 1];
            sd[4 * nb + 2 * r] += v0;
            sd[4 * nb + 2 * r + 1] += v1;
          }
        }
      }
      // dC_I += bf16(the band's dCB) B_J
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::accumulator_to_a(sd, kk, a[kk]);
      hop::fence_operand(dC);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs_tb(dC, a[kk], Ct::mnmajor(vs, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_operand(dC);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::fence_operand(a[kk]);
      release(it);
    }

#pragma unroll
    for (int k = 0; k < MB; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(rm[k][r]);
        if (k < kh && tig == 0) s_dcum[k * MC + I * WB_TILE + il[r]] = v;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + I * WB_TILE + il[r];
      if (t < p.S) {
        float* o = p.dC_part + (((long long)b * p.S + t) * parts + part) * N;
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb)
          *reinterpret_cast<float2*>(o + 8 * nb + 2 * tig) =
              make_float2(dC[4 * nb + 2 * r], dC[4 * nb + 2 * r + 1]);
      }
    }
    hop::mbar_arrive(hempty);
  }

  // ---- the column side -----------------------------------------------------
  for (int J = 0; J < nq; ++J) {
    home_wait();
    const uint32_t hB = base, hX = base + Ct::BYTES;
    const unsigned char* sX = sbase + Ct::BYTES;
    float dB[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dB[e] = 0.f;
    float cm[MB][2];
#pragma unroll
    for (int k = 0; k < MB; ++k) cm[k][0] = cm[k][1] = 0.f;

    for (int I = J; I < nq; ++I) {
      const int it = acquire();
      const uint32_t vs = stage_of(it);   // C_I, then the band's dy_I
      const bool diag = I == J;
      float cb[32], sd[32], gg[32];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hop::wgmma_ss(cb, Ct::kmajor(hB, kk), Ct::kmajor(vs, kk), kk);
      hop::wgmma_commit();
#pragma unroll
      for (int e = 0; e < 32; ++e) sd[e] = 0.f;
#pragma unroll
      for (int k = 0; k < MB; ++k) {
        if (k >= kh) continue;
        // G^T = x_J dy_I^T of head k (with C B^T, for the first)
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss(gg, Xt::kmajor(hX + k * XB, kk),
                        Xt::kmajor(vs + Ct::BYTES + k * XB, kk), kk);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_operand(cb);
        hop::fence_operand(gg);
        if (k == 0) {
          float* cache = s_cache + (I - J) * 32 * 128 + tid;
#pragma unroll
          for (int e = 0; e < 32; ++e) cache[e * 128] = cb[e];
        }
        const float* cum = s_cum + k * MC;
        const float* ci_ = cum + I * WB_TILE;
        const float cj[2] = {cum[J * WB_TILE + il[0]],
                             cum[J * WB_TILE + il[1]]};
        const float dj[2] = {s_dt[k * MC + J * WB_TILE + il[0]],
                             s_dt[k * MC + J * WB_TILE + il[1]]};
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int jl = 8 * nb + 2 * tig;   // query rows i of the columns
          const float2 ci = *reinterpret_cast<const float2*>(ci_ + jl);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float v0 = gg[4 * nb + 2 * r] * dj[r] * hop::ex2(ci.x - cj[r]);
            float v1 = gg[4 * nb + 2 * r + 1] * dj[r] * hop::ex2(ci.y - cj[r]);
            if (diag) {
              v0 = jl >= il[r] ? v0 : 0.f;
              v1 = jl + 1 >= il[r] ? v1 : 0.f;
            }
            cm[k][r] += v0 * cb[4 * nb + 2 * r] + v1 * cb[4 * nb + 2 * r + 1];
            sd[4 * nb + 2 * r] += v0;
            sd[4 * nb + 2 * r + 1] += v1;
          }
        }
      }

      // dB_J += bf16(the band's dCB^T) C_I
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::accumulator_to_a(sd, kk, a[kk]);
      hop::fence_operand(dB);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs_tb(dB, a[kk], Ct::mnmajor(vs, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_operand(dB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::fence_operand(a[kk]);
      release(it);
    }

    // head by head: the state terms, then du over the query blocks
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      if (k >= kh) continue;
      const int hd = h0 + k;
      const uint32_t hXk = hX + k * XB;
      const unsigned char* xk = sX + k * XB;
      const float* cum = s_cum + k * MC;
      const float cj[2] = {cum[J * WB_TILE + il[0]], cum[J * WB_TILE + il[1]]};
      const float dj[2] = {s_dt[k * MC + J * WB_TILE + il[0]],
                           s_dt[k * MC + J * WB_TILE + il[1]]};
      const float total = cum[c - 1];
      const float w[2] = {hop::ex2(total - cj[0]), hop::ex2(total - cj[1])};
      const int its = acquire();
      const uint32_t st = stage_of(its);   // dS_z of head k, hi then lo
      if (J == 0) {
        // <in_z, dS_z>, from both pairs
        const int iti = acquire();
        const unsigned char* si = sbase + (stage_of(iti) - base);
        const unsigned char* sd_ = sbase + (st - base);
        float acc = 0.f;
        for (int e = tid; e < WB_TILE * N / 2; e += 128) {
          const int r = e / (N / 2), col = 2 * (e % (N / 2));
          const int off = Ct::offset(r, col);
          const float2 ih = tile_pair(si, off);
          const float2 il2 = tile_pair(si, off + Ct::BYTES);
          const float2 dh = tile_pair(sd_, off);
          const float2 dl = tile_pair(sd_, off + Ct::BYTES);
          acc += (ih.x + il2.x) * (dh.x + dl.x) + (ih.y + il2.y) * (dh.y + dl.y);
        }
        pass[k] = acc;
        release(iti);
      }
      {
        float tt[N / 2];   // x_J dS
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss_tb(tt, Xt::kmajor(hXk, kk), Ct::mnmajor(st, kk), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss_tb(tt, Xt::kmajor(hXk, kk),
                           Ct::mnmajor(st + Ct::BYTES, kk), 1);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_operand(tt);
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float wd = w[r] * dj[r];
            dB[4 * nb + 2 * r] += wd * tt[4 * nb + 2 * r];
            dB[4 * nb + 2 * r + 1] += wd * tt[4 * nb + 2 * r + 1];
          }
      }
      float du[32];   // rows j, columns p
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hop::wgmma_ss(du, Ct::kmajor(hB, kk), Ct::kmajor(st, kk), kk);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hop::wgmma_ss(du, Ct::kmajor(hB, kk), Ct::kmajor(st + Ct::BYTES, kk),
                      1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_operand(du);
      release(its);
      float sb[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 xv = tile_pair(xk, Xt::offset(il[r], 8 * nb + 2 * tig));
          du[4 * nb + 2 * r] *= w[r];
          du[4 * nb + 2 * r + 1] *= w[r];
          sb[r] += du[4 * nb + 2 * r] * xv.x + du[4 * nb + 2 * r + 1] * xv.y;
        }
      sb[0] *= dj[0];
      sb[1] *= dj[1];
      dtot[k] += sb[0] + sb[1];

      const int ity = acquire();   // head k's dy_I for I >= J
      for (int I = J; I < nq; ++I) {
        const uint32_t ys = stage_of(ity) + (I - J) * XB;
        const float* cache = s_cache + (I - J) * 32 * 128 + tid;
        const float* ci_ = cum + I * WB_TILE;
        const bool diag = I == J;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int nb = 2 * kk + (q >> 1), r = q & 1, e = 4 * nb + 2 * r;
            const int jl = 8 * nb + 2 * tig;
            const float2 ci = *reinterpret_cast<const float2*>(ci_ + jl);
            float v0 = cache[e * 128] * hop::ex2(ci.x - cj[r]);
            float v1 = cache[(e + 1) * 128] * hop::ex2(ci.y - cj[r]);
            if (diag) {
              v0 = jl >= il[r] ? v0 : 0.f;
              v1 = jl + 1 >= il[r] ? v1 : 0.f;
            }
            const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
            const float2 hf = __bfloat1622float2(hv);
            ah[kk][q] = *reinterpret_cast<const uint32_t*>(&hv);
            al[kk][q] = hop::pack_bf16(v0 - hf.x, v1 - hf.y);
          }
        hop::fence_operand(du);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hop::wgmma_rs_tb(du, ah[kk], Xt::mnmajor(ys, kk), 1);
          hop::wgmma_rs_tb(du, al[kk], Xt::mnmajor(ys, kk), 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_operand(du);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hop::fence_operand(ah[kk]);
          hop::fence_operand(al[kk]);
        }
      }
      release(ity);

      // the head's key rows: dx = du dt, du . x, d cum's column terms
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jl = J * WB_TILE + il[r];
        const int t = t0 + jl;
        float dxx = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 xv = tile_pair(xk, Xt::offset(il[r], 8 * nb + 2 * tig));
          dxx += du[4 * nb + 2 * r] * xv.x + du[4 * nb + 2 * r + 1] * xv.y;
        }
        if (t < p.S) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.dx) +
                             (((long long)b * p.S + t) * p.H + hd) * p.P;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int col = 8 * nb + 2 * tig;
            if (col < p.P)
              *reinterpret_cast<uint32_t*>(o + col) =
                  hop::pack_bf16(du[4 * nb + 2 * r] * dj[r],
                                 du[4 * nb + 2 * r + 1] * dj[r]);
          }
        }
        dxx = quad_sum(dxx);
        const float sbs = quad_sum(sb[r]), cms = quad_sum(cm[k][r]);
        if (tig == 0) {
          s_dcum[k * MC + jl] -= sbs + cms;
          s_ddt[k * MC + jl] = dxx;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + J * WB_TILE + il[r];
      if (t < p.S) {
        float* o = p.dB_part + (((long long)b * p.S + t) * parts + part) * N;
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb)
          *reinterpret_cast<float2*>(o + 8 * nb + 2 * tig) =
              make_float2(dB[4 * nb + 2 * r], dB[4 * nb + 2 * r + 1]);
      }
    }
    hop::mbar_arrive(hempty);
  }

  // ---- per head: d total, the reverse cumsum, ddt and the dA partial ------
#pragma unroll
  for (int k = 0; k < MB; ++k) {
    float v = dtot[k], q = pass[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      s_red[k * 4 + warp] = v;
      s_red[16 + k * 4 + warp] = q;
    }
  }
  hop::bar_sync(1, 128);
  if (warp >= kh) return;
  const int k = warp, hd = h0 + k;
  float* dc = s_dcum + k * MC;
  const float* dtk = s_dt + k * MC;
  const float* ddk = s_ddt + k * MC;
  if (lane == 0) {
    const float* rv = s_red + k * 4;
    const float passing =
        hop::ex2(s_cum[k * MC + c - 1]) * (rv[16] + rv[17] + rv[18] + rv[19]);
    dc[c - 1] += (rv[0] + rv[1] + rv[2] + rv[3]) + passing;
  }
  __syncwarp();
  const int per = c / 32, lo = lane * per;
  float run = 0.f;
  for (int r = lo + per - 1; r >= lo; --r) {
    run += dc[r];
    dc[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  float after = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) after = 0.f;
  for (int r = lo; r < lo + per; ++r) dc[r] += after;
  __syncwarp();
  const float a_h = p.A[hd];
  float da = 0.f;
  for (int r = lane; r < c; r += 32) {
    const int t = t0 + r;
    if (t < p.S) {
      p.ddt[((long long)b * p.S + t) * p.H + hd] = ddk[r] + a_h * dc[r];
      da = fmaf(dtk[r], dc[r], da);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    da += __shfl_xor_sync(0xffffffffu, da, off);
  if (lane == 0) p.dA_part[((long long)b * p.nc + z) * p.H + hd] = da;
}

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t smem) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch_reduce(const BwdParams& p, cudaStream_t st) {
  const long long elems = (long long)p.Bn * p.S * p.G * p.N;
  const int blocks = static_cast<int>(
      elems / THREADS + 1 < 8192 ? elems / THREADS + 1 : 8192);
  ssd_bwd_reduce_kernel<T><<<blocks, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_state(const BwdParams& p, cudaStream_t st) {
  const size_t s1 = state_smem(p.N, p.chunk);
  cudaError_t err = set_smem(ssd_bwd_state_kernel<T>, s1);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<T><<<p.Bn * p.H, THREADS, s1, st>>>(p);
  return cudaGetLastError();
}

// the scalar variant (fp32): state, chunk and reduction kernels
template <typename T>
cudaError_t launch_scalar(const BwdParams& p, cudaStream_t st) {
  cudaError_t err = launch_state<T>(p, st);
  if (err != cudaSuccess) return err;
  const size_t s2 = chunk_smem(p.P, p.N, p.chunk);
  err = set_smem(ssd_bwd_chunk_kernel<T>, s2);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T><<<dim3(p.Bn * p.H, p.nc), THREADS, s2, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<T>(p, st);
}

// one walk of the bf16 variants: each chunk's own addition, then the pass
// (the wgmma variant's writes the states as bf16 pairs: PAIRS)
template <int NT, bool FWD, bool PAIRS>
cudaError_t launch_walk(const BwdParams& p, cudaStream_t st) {
  const size_t s1 = own_mma_smem<NT>(p.chunk);
  cudaError_t err = set_smem(ssd_bwd_own_mma_kernel<NT, FWD>, s1);
  if (err != cudaSuccess) return err;
  ssd_bwd_own_mma_kernel<NT, FWD>
      <<<dim3(p.Bn * p.H, p.nc), MT_THREADS, s1, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long states = (long long)p.Bn * p.H * p.P * p.N;
  ssd_bwd_pass_kernel<FWD, PAIRS>
      <<<static_cast<int>((states + THREADS - 1) / THREADS), THREADS, 0,
         st>>>(p);
  return cudaGetLastError();
}

// the mma variant (bf16): the mma walks and chunk kernel of the narrowest
// width NT >= n
template <int NT>
cudaError_t launch_mma_n(const BwdParams& p, cudaStream_t st) {
  cudaError_t err = launch_walk<NT, true, false>(p, st);
  if (err != cudaSuccess) return err;
  err = launch_walk<NT, false, false>(p, st);
  if (err != cudaSuccess) return err;
  const size_t smem = chunk_mma_smem<NT>(p.chunk);
  err = set_smem(ssd_bwd_chunk_mma_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_mma_kernel<NT>
      <<<dim3(p.Bn * p.H, p.nc), MT_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_mma(const BwdParams& p, cudaStream_t st) {
  cudaError_t err = p.N <= 16   ? launch_mma_n<16>(p, st)
        : p.N <= 32 ? launch_mma_n<32>(p, st)
        : p.N <= 64 ? launch_mma_n<64>(p, st)
                    : launch_mma_n<128>(p, st);
  if (err != cudaSuccess) return err;
  return launch_reduce<__nv_bfloat16>(p, st);
}

// the wgmma variant (bf16 at the models' shapes): the walks with their
// states as bf16 pairs, the band chunk kernel, the reduction of the bands.
// The tensor maps are encoded at each call from the tensors' own strides,
// boxes of 64 rows: x and dy (b, s, h, p) one 64-column box (columns past p
// read as zeros), B and C (b, s, g, n) by the panels of n, the pairs (b h
// chunks, p, {hi, lo}, n) as (pair, p, hi or lo, n), rows past p zeros.
template <int N>
int launch_wgmma_n(const BwdParams& p, cudaStream_t st) {
  using Ct = hop::Tile64<N>;
  const int hpg = p.H / p.G, bpg = (hpg + p.band - 1) / p.band;
  const long long pairs = (long long)p.Bn * p.H * p.nc;
  const long long blocks = (long long)p.Bn * p.nc * p.G * bpg;
  if (pairs > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mdy, mb, mc, mi, ms;
  if (!hop::bshd_map(&mx, p.x, p.Bn, p.S, p.H, p.P, p.x_sb, p.x_ss, p.x_sh,
                     64, WB_TILE) ||
      !hop::bshd_map(&mdy, p.dy, p.Bn, p.S, p.H, p.P, p.dy_sb, p.dy_ss,
                     p.dy_sh, 64, WB_TILE) ||
      !hop::bshd_map(&mb, p.B, p.Bn, p.S, p.G, N, p.B_sb, p.B_ss, p.B_sg,
                     Ct::PANEL, WB_TILE) ||
      !hop::bshd_map(&mc, p.C, p.Bn, p.S, p.G, N, p.C_sb, p.C_ss, p.C_sg,
                     Ct::PANEL, WB_TILE) ||
      !hop::bshd_map(&mi, p.states, static_cast<int>(pairs), p.P, 2, N,
                     2LL * p.P * N, 2LL * N, N, Ct::PANEL, WB_TILE) ||
      !hop::bshd_map(&ms, p.dS, static_cast<int>(pairs), p.P, 2, N,
                     2LL * p.P * N, 2LL * N, N, Ct::PANEL, WB_TILE))
    return ERR_MAP;
  cudaError_t err = launch_walk<N, true, true>(p, st);
  if (err != cudaSuccess) return err;
  err = launch_walk<N, false, true>(p, st);
  if (err != cudaSuccess) return err;
  constexpr int smem = WbLayout<N>::SMEM;
  static bool ready = false;
  if (!ready) {
    if ((err = set_smem(ssd_bwd_chunk_wgmma_kernel<N>, smem)) != cudaSuccess)
      return err;
    ready = true;
  }
  ssd_bwd_chunk_wgmma_kernel<N><<<static_cast<unsigned>(blocks), WB_THREADS,
                                  smem, st>>>(p, mx, mdy, mb, mc, mi, ms);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce<__nv_bfloat16>(p, st);
}

// what the wgmma variant takes: bf16 (checked by the caller), p a multiple
// of 16 up to 64, n one of WB_WIDTHS, a chunk a multiple of WB_TILE up to
// WB_MAX_CHUNK, a band of 1 to WB_MAX_BAND heads of one group, and every
// base and stride of x, dy, B and C 16-byte aligned (TMA's rule)
bool wgmma_takes(const BwdParams& p) {
  bool width = false;
  for (int w : WB_WIDTHS) width = width || p.N == w;
  return width && p.P % 16 == 0 && p.chunk % WB_TILE == 0 &&
         p.chunk <= WB_MAX_CHUNK && p.band >= 1 && p.band <= WB_MAX_BAND &&
         p.band <= p.H / p.G && p.vec_x && p.vec_dy && p.vec_bc &&
         reinterpret_cast<uintptr_t>(p.states) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.dS) % 16 == 0;
}

int launch_wgmma(const BwdParams& p, cudaStream_t st) {
  if (!wgmma_takes(p)) return cudaErrorInvalidValue;
  switch (p.N) {
    case 16: return launch_wgmma_n<16>(p, st);
    case 32: return launch_wgmma_n<32>(p, st);
    case 64: return launch_wgmma_n<64>(p, st);
    case 128: return launch_wgmma_n<128>(p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC); dt, A and
// ddt, dA are float32.  Strides are in elements; the last dimension of x,
// B, C and dy is contiguous; the outputs dx (b, S, H, P), ddt (b, S, H),
// dB, dC (b, S, G, N) are contiguous.  variant: as ssd_scan.py ·
// backward_variant chose it; 0 the scalar kernels (fp32), 1 the mma
// kernels (bf16), 2 the wgmma kernels (bf16; p a multiple of 16, n 16, 32,
// 64 or 128, a chunk a multiple of 64 up to 256, x, dy, B and C 16-byte
// aligned), whose chunk kernel takes bands of `band` heads of a group
// (ssd_scan.py · backward_band; the other variants take 1).  Scratch the
// caller allocates, fp32: states and dS (b, h, chunks, P, N; the wgmma
// variant's walks leave them as bf16 pairs in the same bytes), dB_part and
// dC_part (b, S, parts, N), parts H for the scalar and mma kernels (a
// partial a head) and G x ceil(H / G / band) for wgmma (a partial a band),
// dA_part (b, chunks, H), and for bf16 tot (b, h, chunks).  S need not be
// a multiple of the chunk: chunks = ceil(S / chunk), and the rows past S
// read as zeros.  Returns a cudaError_t (0 on success), -3 if a tensor map
// cannot be encoded.
extern "C" int ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy,
    void* states, void* dS, void* dx, void* ddt, void* dB_part,
    void* dC_part, void* dA_part, void* tot, void* dB, void* dC, void* dA,
    int dtype,
    int B, int S, int H, int P, int G, int N, int chunk, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg, long long dy_sb,
    long long dy_ss, long long dy_sh, void* stream, int variant, int band) {
  const bool bf16 = variant == BWD_MMA || variant == BWD_WGMMA;
  if ((variant != BWD_SCALAR && variant != BWD_MMA && variant != BWD_WGMMA) ||
      (bf16 && (dtype != 1 || tot == nullptr)) ||
      (variant == BWD_SCALAR && dtype != 0) ||
      (variant != BWD_WGMMA && band != 1) ||
      states == nullptr || dS == nullptr ||
      B <= 0 || S <= 0 || H <= 0 || G <= 0 || band <= 0 ||
      H % G != 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      chunk <= 0 || chunk > MAX_CHUNK || (dtype != 0 && dtype != 1) ||
      (long long)B * H > 0x7fffffffLL || (S + chunk - 1) / chunk > 65535)
    return cudaErrorInvalidValue;
  const int parts = variant == BWD_WGMMA
                        ? G * ((H / G + band - 1) / band) : H;
  BwdParams p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
              Bm, Cm, dy, static_cast<float*>(states),
              static_cast<float*>(dS), dx, static_cast<float*>(ddt),
              static_cast<float*>(dB_part), static_cast<float*>(dC_part),
              static_cast<float*>(dA_part), static_cast<float*>(tot), dB, dC,
              static_cast<float*>(dA),
              B, S, H, P, G, N, chunk, (S + chunk - 1) / chunk, band, parts,
              x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, B_sg,
              C_sb, C_ss, C_sg, dy_sb, dy_ss, dy_sh,
              dtype == 1 && mma::aligned16(x, x_sb, x_ss, x_sh) && P % 8 == 0,
              dtype == 1 && mma::aligned16(dy, dy_sb, dy_ss, dy_sh) &&
                  P % 8 == 0,
              dtype == 1 && mma::aligned16(Bm, B_sb, B_ss, B_sg) &&
                  mma::aligned16(Cm, C_sb, C_ss, C_sg) && N % 8 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == BWD_WGMMA) return launch_wgmma(p, st);
  const cudaError_t err =
      variant == BWD_MMA ? launch_mma(p, st) : launch_scalar<float>(p, st);
  return static_cast<int>(err);
}

// Dynamic shared memory in bytes of one block of the wgmma variant's chunk
// kernel, ssd_bwd_chunk_wgmma_kernel<n>; -1 for an n it is not built for.
extern "C" int ssd_scan_bwd_smem_bytes(int n) {
  switch (n) {
    case 16: return WbLayout<16>::SMEM;
    case 32: return WbLayout<32>::SMEM;
    case 64: return WbLayout<64>::SMEM;
    case 128: return WbLayout<128>::SMEM;
    default: return -1;
  }
}
