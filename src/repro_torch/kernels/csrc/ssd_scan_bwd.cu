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
// Two variants, one entry (ssd_scan_bwd); ssd_scan.py · backward_variant
// chooses and the entry launches what it is told, refusing what the
// variant does not take (never another kernel, never the twin):
//
// bf16 (variant 1, "mma", every shape the forward takes; p padded to 64
// and n to NT, the narrowest of 16, 32, 64, 128 at least n):
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
// --kernel ssd_bwd and chip_smoke.py's ssd_scan_backward rows, device ms,
// NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md section 6): 1.433-1.438,
// about 30x that bound, of it the chunk kernel 0.968, the two walks 0.118
// + 0.117 with their passes 0.048 + 0.039, the reduction of the per-head
// partials (402 MB of fp32, at HBM's rate) 0.146; the plain recompute it
// replaces took 17.43-17.47.  fleet6 2.12 (25.90), dp_mb 0.729 (8.99),
// hymba's tp_hybrid_rank 0.096 (1.41).  What bounds it now: the chunk
// kernel holds 255 registers a thread at n 128 (60 bytes spilled), so two
// blocks of four warps share a multiprocessor, too few to hide its
// mma.sync chains and ldmatrix loads; it computes C B^T and G once per
// side and dCB B, dCB^T C per head: 8n + 8p FLOPs a causal pair and head
// (du's product a hi / lo pair) against the 4p + 6n / h the cost counts;
// and it writes dB and dC per head for the reduction to sum.  The fp32
// kernels take 9.16 ms (FMA units: 0.686 ms bound; the plain recompute in
// fp32 16.63).
//
// Precision.  The entering states are computed again here, in fp32 (a
// first version read the forward's, whose bf16 operands left dA off by
// up to 4.6e-3 of its largest entry; 1e-5 to 4e-5 now), the d-states'
// dy exp(cum) and du's scores enter as hi / lo pairs (ddt, a difference
// of large sums, was off by up to 3e-3 of its largest entry with the
// scores rounded once; 5e-5 now).  dB and dC keep the scores dCB rounded
// to bf16 once: 2.3e-3 to 4.6e-3 of their largest entry, about twice
// their own rounding to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  float* dB_part;        // (b, S, H, N) fp32
  float* dC_part;
  float* dA_part;        // (b, chunks, H)
  float* tot;            // (b, H, chunks): exp(total) (bf16 d-state)
  void* dB;              // (b, S, G, N) contiguous, B's type
  void* dC;
  float* dA;             // (H,)
  int Bn, S, H, P, G, N, chunk, nc;
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

template <bool FWD>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_pass_kernel(BwdParams p) {
  const long long pn = (long long)p.P * p.N;
  const long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (e >= (long long)p.Bn * p.H * pn) return;
  const long long bh = e / pn, k = e - bh * pn;
  float* __restrict__ st = (FWD ? p.states : p.dS) + bh * p.nc * pn + k;
  const float* __restrict__ tot = p.tot + bh * p.nc;
  constexpr int BATCH = 8;   // chunks whose loads are in flight together
  float carry = 0.f;
  for (int i0 = 0; i0 < p.nc; i0 += BATCH) {
    float own[BATCH], t[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int z = FWD ? i0 + i : p.nc - 1 - i0 - i;
      const bool ok = i0 + i < p.nc;
      own[i] = ok ? st[z * pn] : 0.f;
      t[i] = ok ? tot[z] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int z = FWD ? i0 + i : p.nc - 1 - i0 - i;
      if (i0 + i < p.nc) {
        st[z * pn] = carry;
        carry = fmaf(carry, t[i], own[i]);
      }
    }
  }
}

// dB and dC: the heads of each group summed in head order, in B's type;
// dA: the (b, chunk) partials summed in order.  One thread an element.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(BwdParams p) {
  const long long total = (long long)p.Bn * p.S * p.G * p.N;
  const int rep = p.H / p.G;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * THREADS) {
    const int k = e % p.N;
    const long long rest = e / p.N;
    const int g = rest % p.G;
    const long long bt = rest / p.G;        // b * S + t
    const float* sb = p.dB_part + (bt * p.H + g * rep) * p.N + k;
    const float* sc = p.dC_part + (bt * p.H + g * rep) * p.N + k;
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

// the mma variant (bf16): the mma d-state and chunk kernels of the
// narrowest width NT >= n, the reduction
// one walk of the mma variant: each chunk's own addition, then the pass
template <int NT, bool FWD>
cudaError_t launch_walk(const BwdParams& p, cudaStream_t st) {
  const size_t s1 = own_mma_smem<NT>(p.chunk);
  cudaError_t err = set_smem(ssd_bwd_own_mma_kernel<NT, FWD>, s1);
  if (err != cudaSuccess) return err;
  ssd_bwd_own_mma_kernel<NT, FWD>
      <<<dim3(p.Bn * p.H, p.nc), MT_THREADS, s1, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long states = (long long)p.Bn * p.H * p.P * p.N;
  ssd_bwd_pass_kernel<FWD>
      <<<static_cast<int>((states + THREADS - 1) / THREADS), THREADS, 0,
         st>>>(p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mma_n(const BwdParams& p, cudaStream_t st) {
  cudaError_t err = launch_walk<NT, true>(p, st);
  if (err != cudaSuccess) return err;
  err = launch_walk<NT, false>(p, st);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC); dt, A and
// ddt, dA are float32.  Strides are in elements; the last dimension of x,
// B, C and dy is contiguous; the outputs dx (b, S, H, P), ddt (b, S, H),
// dB, dC (b, S, G, N) are contiguous.  variant: as ssd_scan.py ·
// backward_variant chose it; 0 the scalar kernels (fp32), 1 the mma
// kernels (bf16).  Scratch the caller allocates, fp32: states and dS
// (b, h, chunks, P, N), dB_part and dC_part (b, S, H, N), dA_part (b,
// chunks, H), and for the mma kernels tot (b, h, chunks).  S need not be
// a multiple of the chunk: chunks = ceil(S / chunk), and the rows past S
// read as zeros.  Returns a cudaError_t (0 on success).
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
    long long dy_ss, long long dy_sh, void* stream, int variant) {
  if ((variant != BWD_SCALAR && variant != BWD_MMA) ||
      (variant == BWD_MMA && (dtype != 1 || tot == nullptr)) ||
      (variant == BWD_SCALAR && dtype != 0) ||
      states == nullptr || dS == nullptr ||
      B <= 0 || S <= 0 || H <= 0 || G <= 0 ||
      H % G != 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      chunk <= 0 || chunk > MAX_CHUNK || (dtype != 0 && dtype != 1) ||
      (long long)B * H > 0x7fffffffLL || (S + chunk - 1) / chunk > 65535)
    return cudaErrorInvalidValue;
  BwdParams p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
              Bm, Cm, dy, static_cast<float*>(states),
              static_cast<float*>(dS), dx, static_cast<float*>(ddt),
              static_cast<float*>(dB_part), static_cast<float*>(dC_part),
              static_cast<float*>(dA_part), static_cast<float*>(tot), dB, dC,
              static_cast<float*>(dA),
              B, S, H, P, G, N, chunk, (S + chunk - 1) / chunk,
              x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, B_sg,
              C_sb, C_ss, C_sg, dy_sb, dy_ss, dy_sh,
              dtype == 1 && mma::aligned16(x, x_sb, x_ss, x_sh) && P % 8 == 0,
              dtype == 1 && mma::aligned16(dy, dy_sb, dy_ss, dy_sh) &&
                  P % 8 == 0,
              dtype == 1 && mma::aligned16(Bm, B_sb, B_ss, B_sg) &&
                  mma::aligned16(Cm, C_sb, C_ss, C_sg) && N % 8 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      variant == BWD_MMA ? launch_mma(p, st) : launch_scalar<float>(p, st);
  return static_cast<int>(err);
}
