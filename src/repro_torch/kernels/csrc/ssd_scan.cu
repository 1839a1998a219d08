// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py · ssd_scan (body
// _kernel, wrapper ssd_scan).  Per (batch, head) and per chunk of c steps:
//   cum     = inclusive cumsum(dt * A)              (c,)
//   y_intra = ((C B^T) o L) (x dt),  L[i,j] = exp(cum_i - cum_j), j <= i
//   y_inter = (C o exp(cum)) state^T
//   state  <- state exp(cum_last) + (x dt)^T (B o exp(cum_last - cum))
// with the (p, n) state in fp32, carried from chunk to chunk.  y only: the
// final state is not returned, as on the TPU.
//
// What bounds it on an H100.  At mamba2-780m's training shape (b=4,
// s=2048, h=48, p=64, g=1, n=128, chunk 256, bf16) the four products come
// to about 51.5 GFLOP against about 106 MB of x, dt, B, C and y, about 490
// FLOP per byte: above the ~295 at which bf16 tensor cores become the
// limit, so the bound is the operations, ~52 us at 989 TFLOP/s.  This
// first kernel computes on the CUDA cores in fp32, as the TPU kernel does
// inside, so its own floor is ~0.77 ms (51.5 GFLOP at 67 TFLOP/s); moving
// the products to mma.sync / wgmma and splitting the scan into the chunk-
// state, state-passing and chunk-scan kernels of the Mamba2 paper
// (arXiv:2405.21060) is later work.
//
// Design.
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
// Shapes taken: p <= 64, n <= 128, any chunk up to 512 (including ones that
// are not a power of two, whose last sub-block is partly masked), s a
// multiple of the chunk (ops.ssd pads), h a multiple of g.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and A are float32.
// Strides are in elements; the last dimension of x, B, C and y is
// contiguous.  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, int dtype, int B, int S, int H, int P, int G,
    int N, int chunk, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long B_sb,
    long long B_ss, long long B_sg, long long C_sb, long long C_ss,
    long long C_sg, long long y_sb, long long y_ss, long long y_sh,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > MAX_P || N <= 0 || N > MAX_N || chunk <= 0 || chunk > MAX_CHUNK ||
      S % chunk != 0 || (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Params p{x,    static_cast<const float*>(dt),
                 static_cast<const float*>(A), Bm, Cm, y,
                 S,    H, P, G, N, chunk,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                 B_sb, B_ss, B_sg, C_sb, C_ss, C_sg,
                 y_sb, y_ss, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, B, st));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
