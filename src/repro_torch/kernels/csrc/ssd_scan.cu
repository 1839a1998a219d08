// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py · ssd_scan (body
// _kernel, wrapper ssd_scan).  Per (batch, head) and per chunk of c steps:
//   cum     = inclusive cumsum(dt * A)              (c,)
//   y_intra = ((C B^T) o L) (x dt),  L[i,j] = exp(cum_i - cum_j), j <= i
//   y_inter = (C o exp(cum)) state^T
//   state  <- state exp(cum_last) + (x dt)^T (B o exp(cum_last - cum))
// with the (p, n) state in fp32, carried from chunk to chunk.  When the
// caller passes a final_state buffer (b, h, p, n) fp32, the state after the
// last chunk is stored there too: prefill hands it to the decode
// recurrence.  The TPU kernel returns y only (the JAX package's prefill
// takes its jnp chunked path for the state); here every path writes it
// from what it already holds, at the cost of one (p, n) store per (b, h).
//
// What bounds it on an H100.  At mamba2-780m's training shape (b=4,
// s=2048, h=48, p=64, g=1, n=128, chunk 256, bf16) the function needs
// about 32.3 GFLOP (the causal triangle of each chunk's scores and the two
// state products) against about 106 MB of x, dt, B, C and y: above the
// ~295 FLOP per byte at which bf16 tensor cores become the limit, so the
// bound is the operations, ~0.033 ms at 989 TFLOP/s.  Only wgmma reaches
// that rate.  The chunked algorithm also moves a (b, h, chunks, p, n)
// state scratch (50.3 MB here) between its stages, and at hymba's n = 16
// a kernel that pads its tiles to n = 128 does 8x the function's work.
//
// Three variants, one function (ssd_scan_fwd); ssd_scan.py · variant
// chooses and the C entry launches what it is told:
//
// bf16 at the models' shapes (variant 2, p a multiple of 16, n 16, 32, 64
// or 128, a chunk a multiple of 64, x, B, C and y 16-byte aligned): two
// kernels of Hopper's warpgroup products fed by TMA, each a consumer
// warpgroup and a producer warp whose one thread issues every copy into
// an mbarrier ring (hopper_utils.cuh), tiles as wide as the state:
//  * ssd_scan_state_wgmma_kernel<n>, one block per (b, h): chunk state and
//    state passing in one.  The block walks its chunks in order with the
//    fp32 state in its wgmma accumulator: state <- state exp(total) + (x o
//    dt exp(total - cum))^T B over the chunk's 64-row sub-blocks, A from
//    registers (ldmatrix.trans of the x sub-block, scaled in fp32, rounded
//    to bf16 once), B MN-major; the state entering each chunk is staged as
//    a hi / lo bf16 pair in the chunk scan's tile layout and written by
//    one TMA store while the chunk's products run.  The mma kernels'
//    state scratch made three trips (stage 1 wrote it, stage 2 read and
//    wrote it, stage 3 read it); here it makes one write and one read.
//  * ssd_scan_chunk_scan_wgmma_kernel<n>, one block per (b, chunk, group,
//    WQ_HEADS heads, 64 query rows), a chunk's blocks side by side and
//    heaviest first: y = 2^cum_i C (hi + lo)^T (the pair loaded by TMA as
//    stored, two products), then per key tile S = C B^T once for the
//    block's heads (it depends on the group alone; every model here has g
//    = 1), each head's decay dt_j 2^(cum_i - cum_j) applied to its own copy
//    in fp32 registers by selection on the diagonal, rounded to bf16 once
//    and fed back as the A operand of P x (x MN-major); the next tile's S
//    is issued with the heads' products.
//  The rows past s of a sequence that is not a multiple of the chunk read
//  as zeros and dt there as 0, the arithmetic of padding, so ops does not
//  copy x, B, C and dt to pad them (hymba's prefill pads 640 rows to 768).
//  Readings (tools/kernel_compare.py --kernel ssd, device ms, NVIDIA H100
//  80GB HBM3 at 700.00 W, the mma kernels of PR 31 in turns on the same
//  card; PERF.md section 6): slice 0.1509 and 0.1467 (0.3305; state kernel
//  0.0459, chunk scan 0.1043 against 0.0624 + 0.0499 + 0.2260), fleet6
//  0.2388 (0.4903), hymba_prefill with its state 0.0747 (0.3014; state
//  0.0220, chunk scan 0.0635), serve_prefill 0.0861 (0.1745),
//  tp_hybrid_rank 0.0171 (0.0616).  What bounds it now: the chunk scan
//  (70% of the slice time) alternates its warpgroup between the decays'
//  fp32 work and the products, with two blocks a multiprocessor to overlap
//  them, and reads the state pairs and the key tiles once per 64 query
//  rows from L2.  Deeper rings where two blocks still fit (n <= 64: four
//  state stages, three chunk-scan stages) took hymba_prefill from 0.0799
//  to 0.0747 (the n 128 kernels keep two each).
//  Measured and not kept (slice, the same card and tool): the
//  next tile's decays computed while this tile's products run (0.2078
//  against 0.1708 before the TMA store), one head a block (0.1861 against
//  0.1509), a third chunk-scan stage at n 128 (one block a
//  multiprocessor, 0.2523), exp2f for the decays (0.1764 against
//  ex2.approx 0.1708), four state stages at n 128 (one block a
//  multiprocessor: that kernel 0.0527 against 0.0462), the pairs stored
//  from registers 16 bytes a thread after a quad transpose (that kernel
//  0.0622 against 0.0455 by TMA) or 4 bytes a thread (0.0851).  Writing
//  one head's A fragments while another head's product ran gave wrong
//  sums on the card, so every head's scores are packed before any
//  product of the tile is issued.
//
// bf16 at the other shapes (variant 1: small p or n, chunks of 8 to 32,
// rows that are not whole 16-byte chunks): the three stages of the Mamba2
// paper's chunked algorithm (arXiv:2405.21060) on mma.sync m16n8k16, tiles
// zero-padded to p = 64 and n = 128, so every shape the wrapper takes
// (p <= 64, n <= 128, any chunk <= 512, including 24 and 8) runs here:
//  * ssd_scan_chunk_state_kernel, grid (b*h, chunks): the chunk's cum by a
//    block scan (all warps), written to an fp32 scratch (b, h, chunks, c),
//    and its own state addition S_z = (x o dt exp(total - cum))^T B, a
//    (p x c)(c x n) product over 64-row sub-blocks, written to an fp32
//    scratch (b, h, chunks, p, n).
//  * ssd_scan_state_passing_kernel: per state element, in chunk order,
//    in_0 = 0 and in_z = in_{z-1} exp(total_{z-1}) + S_{z-1}, in place over
//    the scratch: elementwise and bytes-bound.
//  * ssd_scan_chunk_scan_kernel, one block per (b*h, chunk, pair of 64-row
//    query blocks), a chunk's blocks side by side, heaviest first:
//    y_i = exp(cum_i) C_i in_z^T
//    + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j, each warp 16
//    query rows; key blocks at or below the diagonal only.
//  Shared tiles are XOR-swizzled (mma_utils.cuh) and read by ldmatrix;
//  tiles of views whose rows are 16-byte aligned are copied by cp.async 16
//  bytes at a time, two deep, and others element by element.  At the
//  training shape these took 0.3271 ms (chunk state 0.0618, state passing
//  0.0487, chunk scan 0.2239; PR 30), against 4.4703 ms for the first,
//  scalar version.
//
// Numerics, both bf16 variants: fp32 accumulation, each product operand
// rounded to bf16 once: dt_j exp(total - cum_j) is folded into x before
// the chunk state rounds it; dt_j exp(cum_i - cum_j) into the fp32 score
// before it is rounded (as flash rounds P) and reused from registers as
// the A operand; the carried fp32 state enters the chunk scan as a hi / lo
// pair of bf16 (two passes), so chunks keep its precision.  The wrapper
// allocates the scratch (cum and the states: 50.3 MB at the training
// shape, fp32 states or as many bytes of bf16 pairs); the kernels allocate
// nothing.
//
// fp32: ssd_scan_kernel<float>, the first version, unchanged:
//  * grid = b * h blocks of 256 threads.  Each block owns one (b, h) and
//    loops over the chunks itself, in order: that loop takes the place of
//    the TPU's sequential ("arbitrary") chunk grid axis, and the state
//    lives in shared memory (p x (n+1) fp32, 33 KB at p=64, n=128) where
//    the TPU kept it in VMEM scratch.
//  * A 256 x 256 fp32 score tile (256 KB) does not fit the 227 KB a block
//    may use, so the chunk is cut into 64-row query and key sub-blocks and
//    only the key blocks at or below the diagonal are visited, as in flash
//    attention.  cum is kept for the whole chunk, so every sub-block reads
//    its rows' decay at their own offsets.
//  * The causal mask selects: L[i,j] is 0 unless j <= i, and exp is only
//    taken of cum_i - cum_j <= 0 (dt >= 0 and A < 0).  For j > i the
//    difference is large and positive and exp overflows: multiplying by a
//    0/1 mask would give inf * 0 = NaN.
//  * The B/C group of head h is h / (h / g).  x, B and C are read in place
//    through their strides (in the model they are slices of the conv
//    output, so strided views), one element at a time, so rows need no
//    alignment; the TPU wrapper's moveaxis copies have no counterpart.
//  * Products are register-tiled scalar FMAs: each thread owns a 4 x 4 tile
//    of scores and of y (rows ty + 16a, columns tx + 16b) and a 4 x 8 tile
//    of the new state; shared rows are padded so the reads of one warp
//    fall on distinct banks or broadcast.  The new state is summed while
//    the last query block visits every key block, so B and x are read
//    from device memory only for the sub-block pairs.
//  * Everything inside is fp32; y is stored in x's type.
//
// Shapes taken by variants 0 and 1: p <= 64, n <= 128, any chunk up to 512
// (including ones that are not a power of two, whose last sub-block is
// partly masked), s a multiple of the chunk (ops.ssd pads), h a multiple
// of g.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_utils.cuh"
#include "mma_utils.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int TILE = 64;       // rows of a query or key sub-block
constexpr int MAX_P = 64;      // 4 column groups of 16 per thread
constexpr int MAX_N = 128;     // 8 state column groups of 16 per thread
constexpr int MAX_CHUNK = 512;
constexpr int SP = TILE + 16;  // score row stride: the two half-warps of a
                               // store land on disjoint banks

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* final_state;  // (b, h, P, N) or null
  int S, H, P, G, N, chunk;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + TILE) of a (s, n) operand into a TILE x (n+1) tile,
// zero past the chunk's end
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int t0,
                                          int r0, int c, int n) {
  const int ns = n + 1;
  for (int e = threadIdx.x; e < TILE * n; e += THREADS) {
    const int r = e / n, k = e - r * n;
    dst[r * ns + k] =
        r0 + r < c ? load_f(src + (long long)(t0 + r0 + r) * row_stride + k)
                   : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Params p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, c = p.chunk, NS = N + 1;
  float* s_state = smem;              // P x NS
  float* s_c = s_state + P * NS;      // TILE x NS   C rows of a query block
  float* s_b = s_c + TILE * NS;       // TILE x NS   B rows of a key block
  float* s_x = s_b + TILE * NS;       // TILE x P    (x dt) rows of a key block
  float* s_s = s_x + TILE * P;        // TILE x SP   masked, decayed scores
  float* s_cum = s_s + TILE * SP;     // c, padded to whole sub-blocks

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int grp = h / (p.H / p.G);
  const float a_h = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.B) + b * p.B_sb + grp * p.B_sg;
  const T* cg = static_cast<const T*>(p.C) + b * p.C_sb + grp * p.C_sg;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  // columns this thread reads; those past P or N are clamped to a valid
  // column and their results never stored
  int pc[4], nc[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) pc[q] = min(tx + 16 * q, P - 1);
#pragma unroll
  for (int q = 0; q < 8; ++q) nc[q] = min(tx + 16 * q, N - 1);
  int pr[4];  // state rows of this thread's share of the update
#pragma unroll
  for (int q = 0; q < 4; ++q) pr[q] = min(ty + 16 * q, P - 1);

  for (int e = tid; e < P * NS; e += THREADS) s_state[e] = 0.f;

  const int nq = (c + TILE - 1) / TILE;
  for (int t0 = 0; t0 < p.S; t0 += c) {
    // cum of this chunk: warp 0, each lane a run of rows, then a shuffle
    // scan over the runs' totals
    if (tid < 32) {
      const int per = (c + 31) / 32;
      const int lo = min(c, tid * per), hi = min(c, lo + per);
      float run = 0.f;
      for (int r = lo; r < hi; ++r) {
        run += dtg[(long long)(t0 + r) * p.dt_ss] * a_h;
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
    const float total = s_cum[c - 1];

    float ns[4][8];  // this chunk's addition to state rows ty+16a, cols tx+16b
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) ns[a][q] = 0.f;

    for (int qb = 0; qb < nq; ++qb) {
      const int i0 = qb * TILE;
      load_rows(s_c, cg, p.C_ss, t0, i0, c, N);
      __syncthreads();

      // y_inter: exp(cum_i) * C_i . state^T
      float acc[4][4];
      {
        float t[4][4] = {};
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[4], sv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = s_c[(ty + 16 * a) * NS + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) sv[q] = s_state[pc[q] * NS + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) t[a][q] = fmaf(cv[a], sv[q], t[a][q]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          const float e = i < c ? expf(s_cum[i]) : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = e * t[a][q];
        }
      }

      const bool last = qb == nq - 1;
      for (int kb = 0; kb <= qb; ++kb) {
        const int j0 = kb * TILE;
        const int kr = min(TILE, c - j0);
        __syncthreads();  // the previous key block's tiles are consumed
        load_rows(s_b, bg, p.B_ss, t0, j0, c, N);
        for (int e = tid; e < TILE * P; e += THREADS) {
          const int r = e / P, q = e - r * P;
          const long long t = t0 + j0 + r;
          s_x[e] = j0 + r < c ? load_f(xg + t * p.x_ss + q) * dtg[t * p.dt_ss]
                              : 0.f;
        }
        __syncthreads();

        // scores of the (qb, kb) pair, decayed, masked by selection
        {
          float sc[4][4] = {};
#pragma unroll 4
          for (int k = 0; k < N; ++k) {
            float cv[4], bv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) cv[a] = s_c[(ty + 16 * a) * NS + k];
#pragma unroll
            for (int q = 0; q < 4; ++q) bv[q] = s_b[(tx + 16 * q) * NS + k];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                sc[a][q] = fmaf(cv[a], bv[q], sc[a][q]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + ty + 16 * a;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = j0 + tx + 16 * q;
              s_s[(ty + 16 * a) * SP + tx + 16 * q] =
                  (j <= i && i < c) ? sc[a][q] * expf(s_cum[i] - s_cum[j])
                                    : 0.f;
            }
          }
        }

        // the last query block visits every key block: add this block's
        // rows to the new state, (x dt)^T (B o exp(total - cum))
        if (last) {
          for (int r = 0; r < kr; ++r) {
            const float w = expf(total - s_cum[j0 + r]);
            float xv[4], bv[8];
#pragma unroll
            for (int a = 0; a < 4; ++a) xv[a] = s_x[r * P + pr[a]] * w;
#pragma unroll
            for (int q = 0; q < 8; ++q) bv[q] = s_b[r * NS + nc[q]];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 8; ++q)
                ns[a][q] = fmaf(xv[a], bv[q], ns[a][q]);
          }
        }
        __syncthreads();  // the score tile is complete

        for (int r = 0; r < kr; ++r) {
          float sv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = s_s[(ty + 16 * a) * SP + r];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = s_x[r * P + pc[q]];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[a][q] = fmaf(sv[a], xv[q], acc[a][q]);
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = tx + 16 * q;
          if (i < c && col < P)
            store_f(yg + (long long)(t0 + i) * p.y_ss + col, acc[a][q]);
        }
      }
      __syncthreads();  // s_c is consumed before the next query block
    }

    // state <- state exp(total) + this chunk's addition (own entries only;
    // every read of the old state in this chunk is behind a barrier)
    const float decay = expf(total);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = ty + 16 * a;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = tx + 16 * q;
        if (row < P && col < N)
          s_state[row * NS + col] = s_state[row * NS + col] * decay + ns[a][q];
      }
    }
    __syncthreads();
  }
  // the state after the last chunk (complete behind the barrier above)
  if (p.final_state != nullptr) {
    float* fs = p.final_state + (long long)blockIdx.x * P * N;
    for (int e = tid; e < P * N; e += THREADS) {
      const int r = e / N, k = e - r * N;
      fs[e] = s_state[r * NS + k];
    }
  }
}

size_t smem_bytes(int P, int N, int chunk) {
  // cum is padded to whole sub-blocks: rows past the chunk are never
  // read, but stay inside the allocation
  const int cum = (chunk + TILE - 1) / TILE * TILE;
  return sizeof(float) * ((size_t)P * (N + 1) + 2 * TILE * (N + 1) +
                          TILE * P + TILE * SP + cum);
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(p.P, p.N, p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<B * p.H, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the three stages of the Mamba2 chunked algorithm on mma.sync
// ---------------------------------------------------------------------------
constexpr int SUB = 64;    // rows of a chunk's sub-block (query or key block)
constexpr int PT = 64;     // p, zero-padded to the tiles
constexpr int NT = 128;    // n, zero-padded to the tiles
constexpr int CS_THREADS = 256;  // chunk_state: 8 warps
constexpr int CS_STAGES = 2;  // sub-blocks in flight
constexpr int SP_THREADS = 256;  // state_passing
// Measured at the training shape on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md section 6):
//  * chunk_state blocks per SM the registers must allow: 4 (64 registers)
//    took 0.062 ms against 0.068 ms for 1 (105 registers);
//  * 64-row query blocks per chunk_scan block: 2 (8 warps, held to 128
//    registers so two blocks fit an SM) took 0.225 ms against 0.320 ms for
//    1, since a chunk's state, B and x are then read from L2 by half as
//    many blocks.
constexpr int CS_MINB = 4;
constexpr int CQ_QPC = 2;
constexpr int CQ_THREADS = 128 * CQ_QPC;  // 4 warps of 16 rows a query block
constexpr int CQ_MINB = 2;
constexpr float LOG2E = 1.4426950408889634f;

struct StageParams {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  __nv_bfloat16* y;
  float* cum;     // (b, h, chunks, chunk): inclusive cumsum of dt * A
  float* states;  // (b, h, chunks, P, N): S_z from stage 1, in_z after 2
  float* final_state;  // (b, h, P, N) or null: written by stage 2
  int S, H, P, G, N, chunk, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long y_sb, y_ss, y_sh;
  // rows start on 16-byte boundaries (and widths are whole chunks): copy by
  // cp.async / store 16 bytes at a time, else element by element
  int vec_x, vec_bc, vec_y, vec_state;
};

__host__ __device__ __forceinline__ int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Stage 1, grid (b*h, chunks): cum of the chunk by a block scan (written to
// the scratch), then S_z = (x o dt exp(total - cum))^T B, a (p x c)(c x n)
// product on mma.sync over 64-row sub-blocks copied by cp.async two deep.
// x is rounded to bf16 once, after dt_j exp(total - cum_j) is folded in.
__global__ void __launch_bounds__(CS_THREADS, CS_MINB)
    ssd_scan_chunk_state_kernel(const StageParams p) {
  constexpr int XT = SUB * PT, BT = SUB * NT;  // elements of one stage's tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int c = p.chunk, cpad = round_up(c, SUB);
  float* s_cum = reinterpret_cast<float*>(st + CS_STAGES * (XT + BT));
  float* s_w = s_cum + cpad;   // dt_j exp(total - cum_j), 0 past the chunk
  float* s_red = s_w + cpad;   // warp totals of the scan

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r8 = lane & 7, mi = lane >> 3, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, z = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, grp = h / (p.H / p.G);
  const long long t0 = (long long)z * c;
  const __nv_bfloat16* xg = p.x + b * p.x_sb + t0 * p.x_ss + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + t0 * p.dt_ss + h * p.dt_sh;
  const __nv_bfloat16* bg = p.B + b * p.B_sb + t0 * p.B_ss + grp * p.B_sg;

  auto load_sub = [&](int sb, int stage) {
    const int r0 = sb * SUB;
    __nv_bfloat16* xs = st + stage * (XT + BT);
    mma::load_tile<SUB, PT>(xs, xg + r0 * p.x_ss, p.x_ss, c - r0, p.P,
                            p.vec_x, tid, CS_THREADS);
    mma::load_tile<SUB, NT>(xs + XT, bg + r0 * p.B_ss, p.B_ss, c - r0, p.N,
                            p.vec_bc, tid, CS_THREADS);
  };
  const int nsub = cpad / SUB;
  // a ring of CS_STAGES sub-blocks; every step commits one group (empty
  // past the chunk), so wait<CS_STAGES - 1> always means "this one landed"
  for (int s = 0; s < CS_STAGES - 1; ++s) {
    if (s < nsub) load_sub(s, s);
    mma::cp_async_commit();
  }

  // cum: each thread sums a run of consecutive rows, a shuffle scan over the
  // lanes and one over the warps' totals give each run its offset
  {
    const float a_h = p.A[h];
    const int per = (c + CS_THREADS - 1) / CS_THREADS;
    const int lo = min(c, tid * per), hi = min(c, lo + per);
    float run = 0.f;
    for (int r = lo; r < hi; ++r) run += dtg[r * p.dt_ss] * a_h;
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_red[warp] = incl;
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before += s_red[w];
    float* cum_out = p.cum + ((long long)bh * p.nc + z) * c;
    for (int r = lo; r < hi; ++r) {
      before += dtg[r * p.dt_ss] * a_h;
      s_cum[r] = before;
      cum_out[r] = before;
    }
    __syncthreads();
    const float total = s_cum[c - 1];
    for (int r = tid; r < cpad; r += CS_THREADS)
      s_w[r] = r < c ? dtg[r * p.dt_ss] * __expf(total - s_cum[r]) : 0.f;
  }

  // warp w: state rows 16 (w % 4) .. +15, columns 64 (w / 4) .. +63
  const int mt = warp & 3, n0 = (warp >> 2) * 64;
  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

  for (int sb = 0; sb < nsub; ++sb) {
    const int next = sb + CS_STAGES - 1;
    if (next < nsub) load_sub(next, next % CS_STAGES);
    mma::cp_async_commit();
    mma::cp_async_wait<CS_STAGES - 1>();
    __syncthreads();
    __nv_bfloat16* xs = st + (sb % CS_STAGES) * (XT + BT);
    const __nv_bfloat16* bs = xs + XT;
    // x~ = bf16(x dt_j exp(total - cum_j)), in place, 8 values a step
    for (int e = tid; e < SUB * PT / 8; e += CS_THREADS) {
      const int r = e / (PT / 8), ch = e % (PT / 8);
      uint4* ptr = reinterpret_cast<uint4*>(xs + mma::tile_off<PT>(r, ch));
      uint4 v = *ptr;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
      const float w = s_w[sb * SUB + r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        h2[i] = __floats2bfloat162_rn(f.x * w, f.y * w);
      }
      *ptr = v;
    }
    __syncthreads();
    // S += x~^T B: A = x~^T and B both read as stored ([j][.]) through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk) {
      uint32_t a[4];
      mma::ldmatrix_x4_trans(
          a, xs + mma::tile_off<PT>(kk * 16 + r8 + (mi >> 1) * 8,
                                    2 * mt + (mi & 1)));
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t bb[4];
        mma::ldmatrix_x4_trans(
            bb, bs + mma::tile_off<NT>(kk * 16 + r8 + (mi & 1) * 8,
                                       n0 / 8 + nb + (mi >> 1)));
        const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        mma::mma_16816(acc[nb], a, b0);
        mma::mma_16816(acc[nb + 1], a, b1);
      }
    }
    __syncthreads();  // this stage is refilled CS_STAGES sub-blocks on
  }

  // pairs of columns as one 8-byte store where N is even (the rows of a
  // warp's store then fill whole 32-byte sectors)
  float* out = p.states + ((long long)bh * p.nc + z) * p.P * p.N;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = mt * 16 + g + r * 8;
      const int col = n0 + nb * 8 + tig * 2;
      if (row >= p.P || col >= p.N) continue;
      float* o = out + row * p.N + col;
      if (p.N % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
      } else {
        o[0] = acc[nb][2 * r];
        if (col + 1 < p.N) o[1] = acc[nb][2 * r + 1];
      }
    }
  }
}

// Stage 2, grid (b*h, ceil(P*N / (4 * SP_THREADS))): in place over the
// scratch, per state element in chunk order, in_0 = 0 and
// in_z = in_{z-1} exp(total_{z-1}) + S_{z-1}.  Elementwise, bytes-bound:
// each thread owns 4 consecutive elements and loads SP_BATCH chunks' worth
// before it stores any, so the loads of a batch are in flight together.
// After the last chunk run[] holds in_{nc-1} exp(total_{nc-1}) + S_{nc-1},
// the final state, which the in-place overwrite leaves nowhere else: it is
// stored to final_state when the caller asks for it.
constexpr int SP_BATCH = 8;
__global__ void __launch_bounds__(SP_THREADS)
    ssd_scan_state_passing_kernel(const StageParams p) {
  const int bh = blockIdx.x;
  const long long PN = (long long)p.P * p.N;
  const long long e0 = ((long long)blockIdx.y * SP_THREADS + threadIdx.x) * 4;
  if (e0 >= PN) return;
  const float* __restrict__ cum = p.cum + (long long)bh * p.nc * p.chunk;
  float* __restrict__ base = p.states + (long long)bh * p.nc * PN + e0;
  const int n = (int)min(4LL, PN - e0);
  const bool vec = PN % 4 == 0;  // then every 4-float group is aligned
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  for (int z0 = 0; z0 < p.nc; z0 += SP_BATCH) {
    float s[SP_BATCH][4], decay[SP_BATCH];
#pragma unroll
    for (int k = 0; k < SP_BATCH; ++k) {
      if (z0 + k >= p.nc) break;
      const float* ptr = base + (z0 + k) * PN;
      decay[k] = __expf(cum[(long long)(z0 + k) * p.chunk + p.chunk - 1]);
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(ptr);
        s[k][0] = v.x, s[k][1] = v.y, s[k][2] = v.z, s[k][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[k][i] = i < n ? ptr[i] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < SP_BATCH; ++k) {
      if (z0 + k >= p.nc) break;
      float* ptr = base + (z0 + k) * PN;
      if (vec) {
        *reinterpret_cast<float4*>(ptr) =
            make_float4(run[0], run[1], run[2], run[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < n) ptr[i] = run[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) run[i] = run[i] * decay[k] + s[k][i];
    }
  }
  if (p.final_state != nullptr) {
    float* out = p.final_state + (long long)bh * PN + e0;
    if (vec && reinterpret_cast<uintptr_t>(p.final_state) % 16 == 0) {
      *reinterpret_cast<float4*>(out) =
          make_float4(run[0], run[1], run[2], run[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n) out[i] = run[i];
    }
  }
}

// chunk_scan's shared memory: stage 0 (B_j, x_j), then a region that holds
// the fp32 entering state and later stage 1, then C of the block's query
// rows, then cum (log2 units) and dt of the chunk
constexpr int CQ_STAGE = SUB * NT + SUB * PT;          // bf16 elements
constexpr int CQ_STATE_BYTES = PT * NT * 4;            // >= one stage
static_assert(CQ_STATE_BYTES >= CQ_STAGE * 2, "stage 1 fits the state");

size_t chunk_scan_smem(int chunk) {
  return CQ_STAGE * 2 + CQ_STATE_BYTES + CQ_QPC * SUB * NT * 2 +
         2 * sizeof(float) * round_up(chunk, SUB);
}

// float2 slot of state element (row, col pair n2) in shared memory: XOR by
// row, so the 8 rows of a B fragment fall on 4 distinct bank groups
__device__ __forceinline__ int state_slot(int row, int n2) {
  return row * (NT / 2) + (n2 ^ ((row & 3) << 2));
}

// Stage 3: one block per (b*h, chunk, CQ_QPC query blocks of 64 rows); the
// blocks of a chunk are launched side by side, heaviest first, so that the
// chunk's state, B and x are read from device memory about once:
//   y_i = exp(cum_i) C_i in_z^T + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
// on mma.sync.  Each warp owns 16 query rows (4 warps a query block).  The
// fp32 entering state is split into a hi / lo pair of bf16 (two mma
// passes); the scores take dt_j exp(cum_i - cum_j) in fp32 before their one
// rounding to bf16 and are reused from registers as the A operand of P x.
// Key blocks at or below the diagonal only; the diagonal block masks by
// selection, so exp is only taken of cum_i - cum_j <= 0.
__global__ void __launch_bounds__(CQ_THREADS, CQ_MINB)
    ssd_scan_chunk_scan_kernel(const StageParams p) {
  constexpr int ROWS = CQ_QPC * SUB;  // query rows of the block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* region = smem_raw + CQ_STAGE * 2;
  __nv_bfloat16* stage1 = reinterpret_cast<__nv_bfloat16*>(region);
  float2* s_state = reinterpret_cast<float2*>(region);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(region + CQ_STATE_BYTES);
  const int c = p.chunk, cpad = round_up(c, SUB);
  float* s_cum = reinterpret_cast<float*>(cs + ROWS * NT);
  float* s_dt = s_cum + cpad;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r8 = lane & 7, mi = lane >> 3, g = lane >> 2, tig = lane & 3;
  const int nqb = cpad / SUB;
  const int nblk = (nqb + CQ_QPC - 1) / CQ_QPC;
  const long long chunk_id = blockIdx.x / nblk;  // bh * nc + z
  const int blk = nblk - 1 - blockIdx.x % nblk;  // most key blocks first
  const int bh = chunk_id / p.nc, z = chunk_id % p.nc;
  const int i0 = blk * ROWS;
  const int my_qb = blk * CQ_QPC + warp / 4;  // this warp's query block
  const int last_kb = min(nqb - 1, blk * CQ_QPC + CQ_QPC - 1);
  const int b = bh / p.H, h = bh % p.H, grp = h / (p.H / p.G);
  const long long t0 = (long long)z * c;
  const __nv_bfloat16* xg = p.x + b * p.x_sb + t0 * p.x_ss + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + t0 * p.dt_ss + h * p.dt_sh;
  const __nv_bfloat16* bg = p.B + b * p.B_sb + t0 * p.B_ss + grp * p.B_sg;
  const __nv_bfloat16* cg = p.C + b * p.C_sb + t0 * p.C_ss + grp * p.C_sg;

  auto load_keys = [&](int kb, __nv_bfloat16* dst) {
    const int j0 = kb * SUB;
    mma::load_tile<SUB, NT>(dst, bg + j0 * p.B_ss, p.B_ss, c - j0, p.N,
                            p.vec_bc, tid, CQ_THREADS);
    mma::load_tile<SUB, PT>(dst + SUB * NT, xg + j0 * p.x_ss, p.x_ss,
                            c - j0, p.P, p.vec_x, tid, CQ_THREADS);
  };

  // two groups: C of the query rows and the entering state, then key
  // block 0, which lands while the state's product runs
  mma::load_tile<ROWS, NT>(cs, cg + i0 * p.C_ss, p.C_ss, c - i0, p.N,
                           p.vec_bc, tid, CQ_THREADS);
  {
    const float* sg = p.states + chunk_id * p.P * p.N;
    for (int e = tid; e < PT * NT / 4; e += CQ_THREADS) {
      const int row = e / (NT / 4), q4 = e % (NT / 4);  // 4 floats = 2 slots
      float2* d = s_state + state_slot(row, 2 * q4);
      const bool ok = row < p.P && 4 * q4 < p.N;
      if (p.vec_state) {
        mma::cp_async16(d, ok ? sg + row * p.N + 4 * q4 : sg, ok ? 16 : 0);
      } else {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 4 * q4 + i;
          v[i] = row < p.P && col < p.N ? sg[row * p.N + col] : 0.f;
        }
        d[0] = make_float2(v[0], v[1]);
        d[1] = make_float2(v[2], v[3]);
      }
    }
  }
  mma::cp_async_commit();
  load_keys(0, stage0);
  mma::cp_async_commit();
  {
    const float* cum = p.cum + chunk_id * c;
    const float total = cum[c - 1];
    for (int r = tid; r < cpad; r += CQ_THREADS) {
      // past the chunk: cum = total (every decay stays <= 1), dt = 0
      s_cum[r] = (r < c ? cum[r] : total) * LOG2E;
      s_dt[r] = r < c ? dtg[r * p.dt_ss] : 0.f;
    }
  }
  mma::cp_async_wait<1>();
  __syncthreads();

  // this warp's C rows as A fragments, read from the tile each time they
  // are used (which keeps 32 registers free)
  auto c_frag = [&](uint32_t (&a)[4], int kk) {
    mma::ldmatrix_x4(a, cs + mma::tile_off<NT>(warp * 16 + r8 + (mi & 1) * 8,
                                               2 * kk + (mi >> 1)));
  };
  const int ri[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  const float cum_i[2] = {s_cum[min(ri[0], cpad - 1)],
                          s_cum[min(ri[1], cpad - 1)]};
  const bool live = my_qb < nqb;

  // y = exp(cum_i) C_i (hi + lo)^T
  float acc[PT / 8][4];
#pragma unroll
  for (int pt = 0; pt < PT / 8; ++pt) acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
  if (live) {
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
      uint32_t cf[4];
      c_frag(cf, kk);
#pragma unroll
      for (int pt = 0; pt < PT / 8; ++pt) {
        const int row = pt * 8 + g;
        const float2 v0 = s_state[state_slot(row, kk * 8 + tig)];
        const float2 v1 = s_state[state_slot(row, kk * 8 + 4 + tig)];
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(v0.x, v0.y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(v1.x, v1.y);
        const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
        const uint32_t hi[2] = {*reinterpret_cast<const uint32_t*>(&h0),
                                *reinterpret_cast<const uint32_t*>(&h1)};
        const uint32_t lo[2] = {mma::pack_bf16(v0.x - f0.x, v0.y - f0.y),
                                mma::pack_bf16(v1.x - f1.x, v1.y - f1.y)};
        mma::mma_16816(acc[pt], cf, hi);
        mma::mma_16816(acc[pt], cf, lo);
      }
    }
    const float e0 = exp2f(cum_i[0]), e1 = exp2f(cum_i[1]);
#pragma unroll
    for (int pt = 0; pt < PT / 8; ++pt) {
      acc[pt][0] *= e0;
      acc[pt][1] *= e0;
      acc[pt][2] *= e1;
      acc[pt][3] *= e1;
    }
  }
  __syncthreads();  // the state's region becomes stage 1

  for (int kb = 0; kb <= last_kb; ++kb) {
    if (kb + 1 <= last_kb) {
      load_keys(kb + 1, ((kb + 1) & 1) ? stage1 : stage0);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (live && kb <= my_qb) {
      const __nv_bfloat16* bs = (kb & 1) ? stage1 : stage0;
      const __nv_bfloat16* xs = bs + SUB * NT;
      const int j0 = kb * SUB;

      // scores C_i . B_j, 64 keys
      float s[SUB / 8][4];
#pragma unroll
      for (int nb = 0; nb < SUB / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) {
        uint32_t cf[4];
        c_frag(cf, kk);
#pragma unroll
        for (int nb = 0; nb < SUB / 8; nb += 2) {
          uint32_t bb[4];
          mma::ldmatrix_x4(bb, bs + mma::tile_off<NT>(nb * 8 + r8 + (mi >> 1) * 8,
                                                      2 * kk + (mi & 1)));
          const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
          mma::mma_16816(s[nb], cf, b0);
          mma::mma_16816(s[nb + 1], cf, b1);
        }
      }
      // times dt_j exp(cum_i - cum_j), masked by selection on the diagonal
      const bool diag = kb == my_qb;
#pragma unroll
      for (int nb = 0; nb < SUB / 8; ++nb) {
        const int jl = nb * 8 + tig * 2;
        const float2 cj = *reinterpret_cast<const float2*>(s_cum + j0 + jl);
        const float2 dj = *reinterpret_cast<const float2*>(s_dt + j0 + jl);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const float cjv = (i & 1) ? cj.y : cj.x;
          const float djv = (i & 1) ? dj.y : dj.x;
          const bool ok = !diag || j0 + jl + (i & 1) <= ri[r];
          s[nb][i] = ok ? s[nb][i] * djv * exp2f(cum_i[r] - cjv) : 0.f;
        }
      }
      // y += P x_j, P from registers, x_j read as stored through .trans
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {
        const uint32_t af[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int pt = 0; pt < PT / 8; pt += 2) {
          uint32_t bb[4];
          mma::ldmatrix_x4_trans(
              bb, xs + mma::tile_off<PT>(kk * 16 + r8 + (mi & 1) * 8, pt + (mi >> 1)));
          const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
          mma::mma_16816(acc[pt], af, b0);
          mma::mma_16816(acc[pt + 1], af, b1);
        }
      }
    }
    __syncthreads();  // this stage is refilled two key blocks on
  }

  // y through shared memory (the C tile, no longer read), then whole rows
#pragma unroll
  for (int pt = 0; pt < PT / 8; ++pt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int col = pt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(cs + mma::tile_off<PT>(row, col / 8) + col % 8) =
          mma::pack_bf16(acc[pt][2 * r], acc[pt][2 * r + 1]);
    }
  }
  __syncthreads();
  __nv_bfloat16* yg = p.y + b * p.y_sb + (t0 + i0) * p.y_ss + h * p.y_sh;
  const int rows = min(ROWS, c - i0);
  for (int e = tid; e < ROWS * PT / 8; e += CQ_THREADS) {
    const int r = e / (PT / 8), ch = e % (PT / 8);
    if (r >= rows || ch * 8 >= p.P) continue;
    const __nv_bfloat16* src = cs + mma::tile_off<PT>(r, ch);
    if (p.vec_y) {
      *reinterpret_cast<uint4*>(yg + r * p.y_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && ch * 8 + i < p.P; ++i)
        yg[r * p.y_ss + ch * 8 + i] = src[i];
    }
  }
}

size_t chunk_state_smem(int chunk) {
  return CS_STAGES * (SUB * PT + SUB * NT) * 2 +
         sizeof(float) * (2 * round_up(chunk, SUB) + CS_THREADS / 32);
}

// stages: bit 0 chunk_state, bit 1 state_passing, bit 2 chunk_scan
cudaError_t launch_stages(const StageParams& p, int B, int stages,
                          cudaStream_t st) {
  cudaError_t err;
  if (stages & 1) {
    const size_t smem = chunk_state_smem(p.chunk);
    err = cudaFuncSetAttribute(ssd_scan_chunk_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ssd_scan_chunk_state_kernel<<<dim3(B * p.H, p.nc), CS_THREADS, smem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 2) {
    const int per_block = 4 * SP_THREADS;
    const dim3 grid(B * p.H, (p.P * p.N + per_block - 1) / per_block);
    ssd_scan_state_passing_kernel<<<grid, SP_THREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 4) {
    const size_t smem = chunk_scan_smem(p.chunk);
    err = cudaFuncSetAttribute(ssd_scan_chunk_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int nqb = (p.chunk + SUB - 1) / SUB;
    const long long blocks =
        (long long)B * p.H * p.nc * ((nqb + CQ_QPC - 1) / CQ_QPC);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    ssd_scan_chunk_scan_kernel<<<static_cast<unsigned>(blocks), CQ_THREADS,
                                 smem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA: the kernels of ssd_scan.py · variant "wgmma"
// ---------------------------------------------------------------------------
// The variants, by the codes of ssd_scan.py · VARIANTS: ssd_scan_kernel
// <float> (fp32), the three mma.sync stage kernels above (bf16 shapes the
// wgmma kernels do not take), the two wgmma kernels below
constexpr int SSD_SCALAR = 0;
constexpr int SSD_MMA = 1;
constexpr int SSD_WGMMA = 2;
constexpr int ERR_MAP = -3;   // a TMA tensor map could not be encoded
// n the wgmma kernels are built for (hymba's 16, mamba2's 128); a tile is
// as wide as the state, never padded
constexpr int WG_WIDTHS[] = {16, 32, 64, 128};
constexpr int WG_TILE = 64;     // rows of a sub-block; chunk % WG_TILE == 0
constexpr int WG_THREADS = 160;  // one consumer warpgroup, one producer warp
// Knobs, measured at the model's shapes on an NVIDIA H100 80GB HBM3 at
// 700 W (the header; PERF.md section 6):
//  * WS_STAGES: the state kernel's ring of (x, B) sub-blocks in flight at
//    n 128 (2: two blocks a multiprocessor; 4 held one and lost), and
//    WS_STAGES_NARROW at n <= 64, whose tiles leave room for 4 with two
//    blocks (hymba's n 16: faster);
//  * WQ_STAGES: the chunk scan's ring of items (a head's entering state,
//    or a key tile's B and x) in flight at n 128 (2; 3 held one block and
//    lost), and WQ_STAGES_NARROW at n <= 64 (3, two blocks; hymba's n 16:
//    faster);
//  * WQ_HEADS: heads of one B/C group a chunk-scan block takes, sharing
//    its C tile, each B tile and each score tile C B^T (2; 1 and 4 were
//    slower).
constexpr int WS_STAGES = 2;
constexpr int WS_STAGES_NARROW = 4;
constexpr int WQ_STAGES = 2;
constexpr int WQ_STAGES_NARROW = 3;
constexpr int WQ_HEADS = 2;
template <int N>
constexpr int ws_stages() { return N <= 64 ? WS_STAGES_NARROW : WS_STAGES; }
template <int N>
constexpr int wq_stages() { return N <= 64 ? WQ_STAGES_NARROW : WQ_STAGES; }

constexpr int round1k(int a) { return (a + 1023) / 1024 * 1024; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of the state kernel: the ring of (x sub-block, B
// sub-block), the entering state's hi and lo tiles staged for their TMA
// store, cum and the weights of a chunk, the scan's warp totals, the ring's
// barriers, 1 KB to align the base to the 128-byte swizzle's period.  n
// 128 (two stages): 87,088 bytes, two blocks a multiprocessor; n 16 (four):
// 50,256.
template <int N>
struct WsLayout {
  static constexpr int ST = ws_stages<N>();
  static constexpr int STAGE = hop::Tile64<64>::BYTES + hop::Tile64<N>::BYTES;
  static constexpr int PAIRS = ST * STAGE;
  static constexpr int CUM = PAIRS + 2 * hop::Tile64<N>::BYTES;
  static constexpr int BARS = CUM + 4 * (2 * MAX_CHUNK + 4);
  static constexpr int SMEM = BARS + 8 * 2 * ST + 1024;
};

// Shared memory of the chunk-scan block: the query rows' C tile, a ring of
// WQ_STAGES items (a head's entering state as its hi and lo tiles, or a key
// tile's B and the heads' x), cum (log2 units) and dt of the heads, the
// barriers, 1 KB of alignment.  n 128 (two stages): 91,176 bytes, two
// blocks a multiprocessor; n 16 (three): 66,616.
template <int N>
struct WqLayout {
  using Ct = hop::Tile64<N>;
  static constexpr int ST = wq_stages<N>();
  static constexpr int KEYS = Ct::BYTES + WQ_HEADS * hop::Tile64<64>::BYTES;
  static constexpr int STAGE = round1k(imax(KEYS, 2 * Ct::BYTES));
  static constexpr int RING = Ct::BYTES;
  static constexpr int CUM = RING + ST * STAGE;
  static constexpr int BARS = CUM + 4 * 2 * WQ_HEADS * MAX_CHUNK;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * ST) + 1024;
  static_assert(STAGE >= WQ_HEADS * hop::Tile64<64>::BYTES,
                "the ring's first stage holds the heads' y tiles");
};

// a bf16 pair times (w.x, w.y), rounded to bf16 once
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float2 w) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return hop::pack_bf16(f.x * w.x, f.y * w.y);
}

// The state kernel: chunk state and state passing in one, one block per
// (b, h) walking its chunks in order, the fp32 (p, n) state held in the
// consumer warpgroup's wgmma accumulator the whole way.  For chunk z: cum
// by a block scan (written to the scratch for the chunk scan), the
// weights w_j = dt_j exp(total - cum_j); the state entering the chunk as a
// hi / lo bf16 pair, staged in shared memory as the chunk scan's tiles and
// written by one TMA store while the chunk's products run (the stores
// from registers took half the kernel's time); then state <- state
// exp(total) + (x o w)^T B by wgmma: A = (x o w)^T from registers
// (ldmatrix.trans out of the x sub-block, times w in fp32, rounded to
// bf16 once), B = the B sub-block MN-major, K = the chunk's rows, 64 a
// sub-block.  One thread of the producer warp brings the (x, B) sub-blocks
// of every chunk by TMA into a ring of ws_stages<n>(), each stage guarded by a
// full and an empty mbarrier; rows past S read as zeros, and dt = 0 there,
// so a sequence that is not a multiple of the chunk needs no padding.
// After the last chunk the state is the final state, stored in fp32 when
// the caller asks for it.  Rows p past P are zeros (x's columns past P
// read as zeros) and are not stored.
template <int N>
__global__ void __launch_bounds__(WG_THREADS, 2)
    ssd_scan_state_wgmma_kernel(const StageParams p,
                                const __grid_constant__ CUtensorMap tm_x,
                                const __grid_constant__ CUtensorMap tm_b,
                                const __grid_constant__ CUtensorMap tm_s) {
  using L = WsLayout<N>;
  using X = hop::Tile64<64>;
  using Bt = hop::Tile64<N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  unsigned char* s_pairs = sbase + L::PAIRS;  // hi tile, then lo tile
  float* s_cum = reinterpret_cast<float*>(sbase + L::CUM);
  float* s_w = s_cum + MAX_CHUNK;
  float* s_red = s_w + MAX_CHUNK;
  const uint32_t full0 = base + L::BARS, empty0 = full0 + 8 * L::ST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int grp = h / (p.H / p.G);
  const int c = p.chunk, subs = c / WG_TILE, items = p.nc * subs;

  if (tid == 0) {
    for (int s = 0; s < L::ST; ++s) {
      hop::mbar_init(full0 + 8 * s, 1);
      hop::mbar_init(empty0 + 8 * s, 128);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: sub-block `it` is rows 64 it .. 64 it + 63
    if (lane == 0) {
      hop::prefetch_map(&tm_x);
      hop::prefetch_map(&tm_b);
      for (int it = 0; it < items; ++it) {
        const int s = it % L::ST;
        if (it >= L::ST)
          hop::mbar_wait(empty0 + 8 * s, (it / L::ST - 1) & 1);
        const uint32_t dst = base + s * L::STAGE, bar = full0 + 8 * s;
        hop::mbar_arrive_expect_tx(bar, L::STAGE);
        X::load(dst, &tm_x, h, it * WG_TILE, b, bar);
        Bt::load(dst + X::BYTES, &tm_b, grp, it * WG_TILE, b, bar);
      }
    }
    return;
  }

  const int g = lane >> 2, tig = lane & 3;
  const float a_h = p.A[h];
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  float* cum_g = p.cum + (long long)bh * p.nc * c;
  // each thread sums a run of consecutive rows of the chunk, at most 4
  const int per = (c + 127) / 128;
  const int lo = min(c, tid * per), hi = min(c, lo + per);
  float dtv[4];
  auto load_dt = [&](int z) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = z * c + lo + k;
      dtv[k] = lo + k < hi && t < p.S ? dtg[(long long)t * p.dt_ss] : 0.f;
    }
  };
  load_dt(0);
  // the lane's row and 16-byte chunk of the x sub-block for ldmatrix.trans:
  // matrices (p 0-7, j 0-7), (p 8-15, j 0-7), (p 0-7, j 8-15), (p 8-15,
  // j 8-15) of this warp's 16 rows of p give the A fragment of (x o w)^T
  const int mi = lane >> 3;
  const int xrow = (lane & 7) + ((mi >> 1) & 1) * 8;
  const int xchunk = 2 * warp + (mi & 1);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int z = 0; z < p.nc; ++z) {
    // the previous chunk's pairs have left the staging tiles
    if (tid == 0) hop::bulk_wait_read<0>();
    // cum: a thread's run, a shuffle scan over the lanes and the warps'
    // totals give each run its offset
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lo + k < hi) run += dtv[k] * a_h;
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_red[warp] = incl;
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
    hop::bar_sync(1, 128);
    for (int w = 0; w < warp; ++w) before += s_red[w];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (lo + k < hi) {
        before += dtv[k] * a_h;
        s_cum[lo + k] = before;
        cum_g[(long long)z * c + lo + k] = before;
      }
    }
    hop::bar_sync(1, 128);
    const float total = s_cum[c - 1];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lo + k < hi) s_w[lo + k] = dtv[k] * __expf(total - s_cum[lo + k]);
    if (z + 1 < p.nc) load_dt(z + 1);

    // the state entering chunk z (the previous chunk's products have
    // completed) as hi and the rest, rows 16 warp + g (+ 8), staged as
    // the chunk scan's tiles and stored by TMA (rows past P are dropped)
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v0 = acc[4 * nb + 2 * r], v1 = acc[4 * nb + 2 * r + 1];
        const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(hv);
        const int off = Bt::offset(16 * warp + g + 8 * r, 8 * nb + 2 * tig);
        *reinterpret_cast<__nv_bfloat162*>(s_pairs + off) = hv;
        *reinterpret_cast<uint32_t*>(s_pairs + Bt::BYTES + off) =
            hop::pack_bf16(v0 - hf.x, v1 - hf.y);
      }
    }
    hop::fence_proxy_async();
    const float decay = __expf(total);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] *= decay;
    hop::bar_sync(1, 128);  // the chunk's weights and pairs are complete
    if (tid == 0) {
      const int pair = bh * p.nc + z;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int pn = 0; pn < N / Bt::PANEL; ++pn)
          hop::tma_store_4d(&tm_s, hop::smem_u32(s_pairs + half * Bt::BYTES +
                                                 pn * Bt::PANEL_BYTES),
                            pn * Bt::PANEL, half, 0, pair);
      hop::bulk_commit();
    }

    for (int t = 0; t < subs; ++t) {
      const int it = z * subs + t, s = it % L::ST;
      hop::mbar_wait(full0 + 8 * s, (it / L::ST) & 1);
      const unsigned char* xs = sbase + s * L::STAGE;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = 16 * kk + xrow;
        mma::ldmatrix_x4_trans(a[kk], xs + j * X::ROW_BYTES +
                                          ((xchunk ^ (j & 7)) << 4));
        const int jw = t * WG_TILE + 16 * kk + 2 * tig;
        const float2 w0 = *reinterpret_cast<const float2*>(s_w + jw);
        const float2 w1 = *reinterpret_cast<const float2*>(s_w + jw + 8);
        a[kk][0] = scale_bf16x2(a[kk][0], w0);
        a[kk][1] = scale_bf16x2(a[kk][1], w0);
        a[kk][2] = scale_bf16x2(a[kk][2], w1);
        a[kk][3] = scale_bf16x2(a[kk][3], w1);
      }
      const uint32_t bs = base + s * L::STAGE + X::BYTES;
      hop::fence_operand(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs_tb(acc, a[kk], Bt::mnmajor(bs, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_operand(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::fence_operand(a[kk]);
      hop::mbar_arrive(empty0 + 8 * s);
    }
  }
  if (tid == 0) hop::bulk_wait_read<0>();  // before the block's memory goes

  if (p.final_state != nullptr) {
    float* fs = p.final_state + (long long)bh * p.P * N;
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r, col = 8 * nb + 2 * tig;
        if (row < p.P)
          *reinterpret_cast<float2*>(fs + row * N + col) =
              make_float2(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
      }
    }
  }
}

// The chunk scan on wgmma: one block per (b, chunk, B/C group, WQ_HEADS
// heads of the group, 64 query rows), a chunk's query blocks side by side
// and heaviest (most key tiles) first, so the chunk's states, B and x are
// read from device memory about once.  One thread of the producer warp
// brings the query rows' C tile once, then through a ring of wq_stages<n>():
// each head's entering state (its hi and lo tiles, as the state kernel
// stored them), then each key tile at or below the diagonal (B and every
// head's x).  The consumer warpgroup, rows 16 w + l / 4 (+ 8):
//   y_h = 2^cum_i C (hi_h + lo_h)^T            (two wgmma passes, fp32)
//       + sum_j (C B_j^T o dt_j 2^(cum_i - cum_j)) x_{h,j}
// where C B_j^T is computed once for all the block's heads (it depends on
// the group alone), and each head's decay is applied to its own copy in
// fp32 registers, by selection on the diagonal (2^ only of cum_i - cum_j <=
// 0 matters there), rounded to bf16 once and fed back as the A operand of
// the product with x (MN-major).  The next key tile's C B^T is issued as
// soon as the last head's scores are packed, so it runs with the heads'
// products.  y is staged through the ring (every item consumed) and
// written in 16-byte rows; columns past P are zeros and not stored.
template <int N>
__global__ void __launch_bounds__(WG_THREADS, WQ_HEADS <= 2 ? 2 : 1)
    ssd_scan_chunk_scan_wgmma_kernel(const StageParams p,
                                     const __grid_constant__ CUtensorMap tm_x,
                                     const __grid_constant__ CUtensorMap tm_b,
                                     const __grid_constant__ CUtensorMap tm_c,
                                     const __grid_constant__ CUtensorMap tm_s) {
  using L = WqLayout<N>;
  using X = hop::Tile64<64>;
  using Ct = hop::Tile64<N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  float* s_cum = reinterpret_cast<float*>(sbase + L::CUM);  // log2 units
  float* s_dt = s_cum + WQ_HEADS * MAX_CHUNK;
  const uint32_t c_full = base + L::BARS, full0 = c_full + 8,
                 empty0 = full0 + 8 * L::ST;

  const int c = p.chunk, nqb = c / WG_TILE;
  const int hpg = p.H / p.G, hblocks = (hpg + WQ_HEADS - 1) / WQ_HEADS;
  long long rest = blockIdx.x;
  const int qi = static_cast<int>(rest % nqb);
  rest /= nqb;
  const int hb = static_cast<int>(rest % hblocks);
  rest /= hblocks;
  const int grp = static_cast<int>(rest % p.G);
  rest /= p.G;
  const int z = static_cast<int>(rest % p.nc);
  const int b = static_cast<int>(rest / p.nc);
  const int qb = nqb - 1 - qi;  // most key tiles first
  const int h0 = grp * hpg + hb * WQ_HEADS;
  const int kh = min(WQ_HEADS, hpg - hb * WQ_HEADS);
  const int nk = qb + 1;        // key tiles at or below the diagonal
  const int t0 = z * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a sequence that is not a multiple of the chunk: query rows past S have
  // no output (their keys and states read as zeros, dt as 0)
  if (t0 + qb * WG_TILE >= p.S) return;

  if (tid == 0) {
    hop::mbar_init(c_full, 1);
    for (int s = 0; s < L::ST; ++s) {
      hop::mbar_init(full0 + 8 * s, 1);
      hop::mbar_init(empty0 + 8 * s, 128);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: item it < kh a head's state, then key tiles
    if (lane == 0) {
      hop::prefetch_map(&tm_x);
      hop::prefetch_map(&tm_b);
      hop::prefetch_map(&tm_c);
      hop::prefetch_map(&tm_s);
      hop::mbar_arrive_expect_tx(c_full, Ct::BYTES);
      Ct::load(base, &tm_c, grp, t0 + qb * WG_TILE, b, c_full);
      for (int it = 0; it < kh + nk; ++it) {
        const int s = it % L::ST;
        if (it >= L::ST)
          hop::mbar_wait(empty0 + 8 * s, (it / L::ST - 1) & 1);
        const uint32_t dst = base + L::RING + s * L::STAGE,
                       bar = full0 + 8 * s;
        if (it < kh) {
          hop::mbar_arrive_expect_tx(bar, 2 * Ct::BYTES);
          const int pair = (b * p.H + h0 + it) * p.nc + z;
          Ct::load(dst, &tm_s, 0, 0, pair, bar);
          Ct::load(dst + Ct::BYTES, &tm_s, 1, 0, pair, bar);
        } else {
          const int row = t0 + (it - kh) * WG_TILE;
          hop::mbar_arrive_expect_tx(bar, Ct::BYTES + kh * X::BYTES);
          Ct::load(dst, &tm_b, grp, row, b, bar);
          for (int hh = 0; hh < kh; ++hh)
            X::load(dst + Ct::BYTES + hh * X::BYTES, &tm_x, h0 + hh, row, b,
                    bar);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, tig = lane & 3;
  // cum (log2 units) and dt of the block's heads at the keys it visits
  const int rows = nk * WG_TILE;
  for (int e = tid; e < kh * rows; e += 128) {
    const int hh = e / rows, r = e - hh * rows, hd = h0 + hh;
    s_cum[hh * MAX_CHUNK + r] =
        p.cum[((long long)(b * p.H + hd) * p.nc + z) * c + r] * LOG2E;
    s_dt[hh * MAX_CHUNK + r] =
        t0 + r < p.S
            ? p.dt[b * p.dt_sb + (long long)(t0 + r) * p.dt_ss + hd * p.dt_sh]
            : 0.f;
  }
  hop::bar_sync(1, 128);
  const int il[2] = {16 * warp + g, 16 * warp + g + 8};  // query rows
  float cum_i[WQ_HEADS][2];
#pragma unroll
  for (int hh = 0; hh < WQ_HEADS; ++hh)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      cum_i[hh][r] =
          hh < kh ? s_cum[hh * MAX_CHUNK + qb * WG_TILE + il[r]] : 0.f;

  auto stage = [&](int it) {
    return base + L::RING + (it % L::ST) * L::STAGE;
  };
  auto wait_full = [&](int it) {
    hop::mbar_wait(full0 + 8 * (it % L::ST), (it / L::ST) & 1);
  };
  auto release = [&](int it) { hop::mbar_arrive(empty0 + 8 * (it % L::ST)); };

  float acc[WQ_HEADS][32];
#pragma unroll
  for (int hh = 0; hh < WQ_HEADS; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;
  hop::mbar_wait(c_full, 0);

  // y = 2^cum_i C (hi + lo)^T, each head's state an item of the ring
#pragma unroll
  for (int hh = 0; hh < WQ_HEADS; ++hh) {
    if (hh >= kh) continue;
    wait_full(hh);
    const uint32_t st = stage(hh);
    hop::fence_operand(acc[hh]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hop::wgmma_ss(acc[hh], Ct::kmajor(base, kk), Ct::kmajor(st, kk), kk);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hop::wgmma_ss(acc[hh], Ct::kmajor(base, kk),
                    Ct::kmajor(st + Ct::BYTES, kk), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_operand(acc[hh]);
    release(hh);
    const float e0 = exp2f(cum_i[hh][0]), e1 = exp2f(cum_i[hh][1]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[hh][4 * n] *= e0;
      acc[hh][4 * n + 1] *= e0;
      acc[hh][4 * n + 2] *= e1;
      acc[hh][4 * n + 3] *= e1;
    }
  }

  // + the key tiles: S = C B^T once, then each head's decayed copy times x.
  // Every head's scores are decayed and packed first, then the heads'
  // products and the next tile's C B^T are issued back to back: no
  // register is written while a product that reads registers runs (a
  // head's packing while the previous head's product ran gave wrong sums
  // on the card)
  float s[32];
  auto scores = [&](int kt) {
    const uint32_t st = stage(kh + kt);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hop::wgmma_ss(s, Ct::kmajor(base, kk), Ct::kmajor(st, kk), kk);
  };
  // the heads' scores as A fragments, kept live until the wait after their
  // products (fence_operand)
  uint32_t pa[WQ_HEADS][4][4];
#pragma unroll
  for (int hh = 0; hh < WQ_HEADS; ++hh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) pa[hh][kk][q] = 0u;
  auto fence_all = [&]() {
    hop::fence_operand(s);
#pragma unroll
    for (int hh = 0; hh < WQ_HEADS; ++hh) {
      hop::fence_operand(acc[hh]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::fence_operand(pa[hh][kk]);
    }
  };
  // each head's decayed scores of key tile kt, from s, as A fragments
  auto decay = [&](int kt, uint32_t (&out)[WQ_HEADS][4][4]) {
    const bool diag = kt == qb;
    const int j0 = kt * WG_TILE;
#pragma unroll
    for (int hh = 0; hh < WQ_HEADS; ++hh) {
      if (hh >= kh) continue;
      const float* cj_ = s_cum + hh * MAX_CHUNK + j0;
      const float* dj_ = s_dt + hh * MAX_CHUNK + j0;
      // out[kk][q]: row q & 1, 8-column block 2 kk + q / 2 (the
      // accumulator's layout is the A fragment's)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = 2 * kk + (q >> 1), r = q & 1;
          const int jl = 8 * n + 2 * tig;
          const float2 cj = *reinterpret_cast<const float2*>(cj_ + jl);
          const float2 dj = *reinterpret_cast<const float2*>(dj_ + jl);
          float v0 = s[4 * n + 2 * r] * dj.x * hop::ex2(cum_i[hh][r] - cj.x);
          float v1 =
              s[4 * n + 2 * r + 1] * dj.y * hop::ex2(cum_i[hh][r] - cj.y);
          if (diag) {
            v0 = jl <= il[r] ? v0 : 0.f;
            v1 = jl + 1 <= il[r] ? v1 : 0.f;
          }
          out[hh][kk][q] = hop::pack_bf16(v0, v1);
        }
      }
    }
  };
  // the heads' products of key tile kt from the fragments `in`
  auto products = [&](int kt, const uint32_t (&in)[WQ_HEADS][4][4]) {
    const uint32_t xs = stage(kh + kt) + Ct::BYTES;
#pragma unroll
    for (int hh = 0; hh < WQ_HEADS; ++hh) {
      if (hh >= kh) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs_tb(acc[hh], in[hh][kk],
                         X::mnmajor(xs + hh * X::BYTES, kk), 1);
    }
  };
  wait_full(kh);
  hop::wgmma_fence();
  scores(0);
  hop::wgmma_commit();
  for (int kt = 0; kt < nk; ++kt) {
    hop::wgmma_wait<0>();  // S of tile kt, and the products of tile kt - 1
    fence_all();
    if (kt > 0) release(kh + kt - 1);
    decay(kt, pa);
    if (kt + 1 < nk) wait_full(kh + kt + 1);
    hop::wgmma_fence();
    products(kt, pa);
    if (kt + 1 < nk) scores(kt + 1);
    hop::wgmma_commit();
  }
  hop::wgmma_wait<0>();
  fence_all();
  release(kh + nk - 1);

  // y through the ring's first stage (every item has landed and been
  // read), then 16-byte stores of whole rows
  // every warp's products have read the ring before it is written
  unsigned char* ys = sbase + L::RING;
  hop::bar_sync(1, 128);
#pragma unroll
  for (int hh = 0; hh < WQ_HEADS; ++hh) {
    if (hh >= kh) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(ys + hh * X::BYTES +
                                     X::offset(il[r], 8 * n + 2 * tig)) =
            hop::pack_bf16(acc[hh][4 * n + 2 * r], acc[hh][4 * n + 2 * r + 1]);
  }
  hop::bar_sync(1, 128);
  const int pch = p.P / 8;  // 16-byte chunks of a row of y
  for (int e = tid; e < kh * WG_TILE * 8; e += 128) {
    const int hh = e / (WG_TILE * 8), r = (e / 8) % WG_TILE, ch = e % 8;
    if (ch >= pch || t0 + qb * WG_TILE + r >= p.S) continue;
    __nv_bfloat16* yg = p.y + b * p.y_sb +
                        (long long)(t0 + qb * WG_TILE + r) * p.y_ss +
                        (long long)(h0 + hh) * p.y_sh + ch * 8;
    *reinterpret_cast<uint4*>(yg) =
        *reinterpret_cast<const uint4*>(ys + hh * X::BYTES + X::offset(r, ch * 8));
  }
}

// a kernel's dynamic shared memory limit, raised once per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// stages: bit 0 the state kernel, bit 1 the chunk scan.  The tensor maps
// are encoded at each call from the tensors' own strides, boxes of 64 rows:
// x (b, s, h, p) one 64-column box (columns past p read as zeros), B and C
// (b, s, g, n) by the panels of n, and the pairs scratch (b h chunks, p,
// {hi, lo}, n) as (pair, p, hi or lo, n), whose rows past p read as zeros.
template <int N>
int launch_wgmma(const StageParams& p, int B, int stages, cudaStream_t st) {
  using Ct = hop::Tile64<N>;
  const long long pairs = (long long)B * p.H * p.nc;
  const int nqb = p.chunk / WG_TILE, hpg = p.H / p.G;
  const long long blocks = (long long)B * p.nc * p.G *
                           ((hpg + WQ_HEADS - 1) / WQ_HEADS) * nqb;
  if (pairs > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mb, mc, ms;
  if (!hop::bshd_map(&mx, p.x, B, p.S, p.H, p.P, p.x_sb, p.x_ss, p.x_sh, 64,
                     WG_TILE) ||
      !hop::bshd_map(&mb, p.B, B, p.S, p.G, N, p.B_sb, p.B_ss, p.B_sg,
                     Ct::PANEL, WG_TILE) ||
      !hop::bshd_map(&mc, p.C, B, p.S, p.G, N, p.C_sb, p.C_ss, p.C_sg,
                     Ct::PANEL, WG_TILE) ||
      !hop::bshd_map(&ms, p.states, static_cast<int>(pairs), p.P, 2, N,
                     2LL * p.P * N, 2LL * N, N, Ct::PANEL, WG_TILE))
    return ERR_MAP;
  cudaError_t err;
  if (stages & 1) {
    constexpr int smem = WsLayout<N>::SMEM;
    static bool ready = false;
    if ((err = allow_smem(ssd_scan_state_wgmma_kernel<N>, smem, ready)) !=
        cudaSuccess)
      return err;
    ssd_scan_state_wgmma_kernel<N><<<static_cast<unsigned>(pairs / p.nc),
                                     WG_THREADS, smem, st>>>(p, mx, mb, ms);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 2) {
    constexpr int smem = WqLayout<N>::SMEM;
    static bool ready = false;
    if ((err = allow_smem(ssd_scan_chunk_scan_wgmma_kernel<N>, smem,
                          ready)) != cudaSuccess)
      return err;
    ssd_scan_chunk_scan_wgmma_kernel<N><<<static_cast<unsigned>(blocks),
                                          WG_THREADS, smem, st>>>(p, mx, mb,
                                                                  mc, ms);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// what the wgmma kernels take: bf16 (checked by the caller), p a multiple
// of 16 up to 64, n one of WG_WIDTHS, a chunk a multiple of WG_TILE, and
// every base and stride of x, B, C and y 16-byte aligned (TMA's rule)
bool wgmma_takes(const StageParams& p) {
  bool width = false;
  for (int w : WG_WIDTHS) width = width || p.N == w;
  return width && p.P % 16 == 0 && p.P <= MAX_P && p.chunk % WG_TILE == 0 &&
         p.vec_x && p.vec_bc && p.vec_y &&
         reinterpret_cast<uintptr_t>(p.states) % 16 == 0;
}

int launch_wgmma_n(const StageParams& p, int B, int stages, cudaStream_t st) {
  if (!wgmma_takes(p)) return cudaErrorInvalidValue;
  switch (p.N) {
    case 16: return launch_wgmma<16>(p, B, stages, st);
    case 32: return launch_wgmma<32>(p, B, stages, st);
    case 64: return launch_wgmma<64>(p, B, stages, st);
    case 128: return launch_wgmma<128>(p, B, stages, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

namespace {

// One variant's kernels from the arguments of ssd_scan_fwd: SSD_SCALAR
// ssd_scan_kernel<float> (fp32, stages 7), SSD_MMA the mma.sync stage
// kernels of `stages` (see launch_stages), SSD_WGMMA the wgmma kernels of
// `stages` (see launch_wgmma).  A call the variant does not take is
// refused, never sent to another kernel.
int run(int variant, int stages, const void* x, const void* dt,
        const void* A, const void* Bm, const void* Cm, void* y, void* cum,
        void* states, void* final_state, int dtype, int B, int S, int H,
        int P, int G, int N, int chunk,
        long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
        long long dt_ss, long long dt_sh, long long B_sb, long long B_ss,
        long long B_sg, long long C_sb, long long C_ss, long long C_sg,
        long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > MAX_P || N <= 0 || N > MAX_N || chunk <= 0 || chunk > MAX_CHUNK ||
      (S % chunk != 0 && variant != SSD_WGMMA) ||
      (long long)B * H > 0x7fffffffLL || (S + chunk - 1) / chunk > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == SSD_SCALAR) {
    if (dtype != 0 || stages != 7) return cudaErrorInvalidValue;
    const Params p{x,    static_cast<const float*>(dt),
                   static_cast<const float*>(A), Bm, Cm, y,
                   static_cast<float*>(final_state),
                   S,    H, P, G, N, chunk,
                   x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                   B_sb, B_ss, B_sg, C_sb, C_ss, C_sg,
                   y_sb, y_ss, y_sh};
    return static_cast<int>(launch<float>(p, B, st));
  }
  if (dtype != 1 || cum == nullptr || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  using mma::aligned16;
  StageParams p{static_cast<const __nv_bfloat16*>(x),
                static_cast<const float*>(dt),
                static_cast<const float*>(A),
                static_cast<const __nv_bfloat16*>(Bm),
                static_cast<const __nv_bfloat16*>(Cm),
                static_cast<__nv_bfloat16*>(y),
                static_cast<float*>(cum),
                static_cast<float*>(states),
                static_cast<float*>(final_state),
                S, H, P, G, N, chunk, (S + chunk - 1) / chunk,
                x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                B_sb, B_ss, B_sg, C_sb, C_ss, C_sg,
                y_sb, y_ss, y_sh,
                aligned16(x, x_sb, x_ss, x_sh) && P % 8 == 0,
                aligned16(Bm, B_sb, B_ss, B_sg) &&
                    aligned16(Cm, C_sb, C_ss, C_sg) && N % 8 == 0,
                aligned16(y, y_sb, y_ss, y_sh) && P % 8 == 0,
                reinterpret_cast<uintptr_t>(states) % 16 == 0 && N % 4 == 0};
  if (variant == SSD_MMA)
    return static_cast<int>(launch_stages(p, B, stages, st));
  if (variant == SSD_WGMMA) return launch_wgmma_n(p, B, stages, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory in bytes of one launch of a bf16 kernel at this
// chunk and n: stage 1 ssd_scan_chunk_state_kernel, 2
// ssd_scan_state_passing_kernel, 3 ssd_scan_chunk_scan_kernel (the mma
// variant, whose sizes follow the chunk), 4 ssd_scan_state_wgmma_kernel<n>,
// 5 ssd_scan_chunk_scan_wgmma_kernel<n> (the wgmma variant, whose sizes
// follow n); -1 for another stage or an n the wgmma kernels are not built
// for.
extern "C" int ssd_scan_smem_bytes(int stage, int chunk, int n) {
  switch (stage * 1000 + (stage >= 4 ? n : 0)) {
    case 1000: return static_cast<int>(chunk_state_smem(chunk));
    case 2000: return 0;
    case 3000: return static_cast<int>(chunk_scan_smem(chunk));
#define WG_SMEM(w)                         \
  case 4000 + w: return WsLayout<w>::SMEM; \
  case 5000 + w: return WqLayout<w>::SMEM;
    WG_SMEM(16) WG_SMEM(32) WG_SMEM(64) WG_SMEM(128)
#undef WG_SMEM
    default: return -1;
  }
}

#define SSD_ARGS                                                             \
  const void *x, const void *dt, const void *A, const void *Bm,              \
      const void *Cm, void *y, void *cum, void *states, void *final_state,   \
      int dtype, int B, int S, int H, int P, int G, int N, int chunk,        \
      long long x_sb,                                                        \
      long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,      \
      long long dt_sh, long long B_sb, long long B_ss, long long B_sg,       \
      long long C_sb, long long C_ss, long long C_sg, long long y_sb,        \
      long long y_ss, long long y_sh, void *stream
#define SSD_PASS                                                             \
  x, dt, A, Bm, Cm, y, cum, states, final_state, dtype, B, S, H, P, G, N,   \
      chunk, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, B_sg, C_sb,  \
      C_ss, C_sg, y_sb, y_ss, y_sh, stream

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and A are float32.
// Strides are in elements; the last dimension of x, B, C and y is
// contiguous.  variant: the kernels to launch, as ssd_scan.py · variant
// chose them: 0 ssd_scan_kernel<float> (fp32), 1 the three mma.sync stage
// kernels, 2 ssd_scan_state_wgmma_kernel<n> then
// ssd_scan_chunk_scan_wgmma_kernel<n> (bf16, p a multiple of 16, n 16, 32,
// 64 or 128, a chunk a multiple of 64, every base and stride of x, B, C
// and y 16-byte aligned, and S any length: the rows past it read as zeros
// and dt as 0, the arithmetic of padding to the chunk; the other
// variants take S a multiple of the chunk).  chunks = ceil(S / chunk).
// cum (b, h, chunks, chunk) fp32 and states are
// scratch the caller allocates for bf16 (null for fp32): variant 1 states
// (b, h, chunks, p, n) fp32, variant 2 the entering states as bf16 pairs
// (b, h, chunks, p, 2, n), hi then lo.  final_state (b, h, p, n),
// contiguous fp32, receives the state after the last chunk, or is null
// when the caller needs y only.  Returns a cudaError_t (0 on success), -3
// if a tensor map cannot be encoded.
extern "C" int ssd_scan_fwd(SSD_ARGS, int variant) {
  return run(variant, variant == SSD_WGMMA ? 3 : 7, SSD_PASS);
}

// Each kernel alone (bf16 only), with the same arguments, so that a check
// can hold each against its plain stage function.  The mma variant:
//   chunk_state reads x, dt, A, B and writes cum and states (S_z);
//   state_passing turns states (S_z) into the entering states in place,
//     reading cum, and writes final_state if it is not null;
//   chunk_scan reads x, dt, B, C, cum and the entering states, writes y.
// The wgmma variant:
//   state_wgmma reads x, dt, A, B and writes cum, the entering states as
//     bf16 pairs, and final_state if it is not null;
//   chunk_scan_wgmma reads x, dt, B, C, cum and the pairs, writes y.
extern "C" int ssd_scan_chunk_state_fwd(SSD_ARGS) {
  return run(SSD_MMA, 1, SSD_PASS);
}
extern "C" int ssd_scan_state_passing_fwd(SSD_ARGS) {
  return run(SSD_MMA, 2, SSD_PASS);
}
extern "C" int ssd_scan_chunk_scan_fwd(SSD_ARGS) {
  return run(SSD_MMA, 4, SSD_PASS);
}
extern "C" int ssd_scan_state_wgmma_fwd(SSD_ARGS) {
  return run(SSD_WGMMA, 1, SSD_PASS);
}
extern "C" int ssd_scan_chunk_scan_wgmma_fwd(SSD_ARGS) {
  return run(SSD_WGMMA, 2, SSD_PASS);
}
