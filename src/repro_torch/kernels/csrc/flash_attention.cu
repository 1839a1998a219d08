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
//  * flash_mma_kernel, for bf16 with D a multiple of 16 and K/V rows
//    16-byte aligned (the serving path): products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate).  Each warp owns 16 query rows; S = Q K^T stays in
//    registers and is reused in place as the A operand of P V (the FA2
//    layout), so P never touches shared memory.  K and V tiles (64 keys)
//    are staged in shared memory with 16-byte loads, V transposed, rows
//    padded by 8 elements so the fragment loads hit 32 distinct banks.  Loads are not overlapped with
//    the products; cp.async / TMA pipelining, wgmma and warp
//    specialisation are later work.
//  * flash_fwd_kernel, for fp32, for head dims the mma tiles do not cover
//    (24), and for K/V rows not 16-byte aligned (strided views): scalar
//    fp32 FMAs through shared memory, any strides.  GROUP threads
//    share a query row, each owning every GROUP-th dim of q and of the
//    accumulator; a score is the sum of their partial dots (two xor
//    shuffles), and for a given key all rows read the same shared words,
//    which the hardware broadcasts.
//
// Common design.
//  * grid = (ceil(S / 64), B * H).  Each block owns 64 query rows of one
//    (b, h) and loops over KV tiles itself: that loop takes the place of
//    the TPU's sequential KV grid axis and its VMEM scratch (m, l, acc live
//    in registers here).
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
    case 128: flash_fwd_kernel<T, 128><<<grid, THREADS, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// tensor-core path (bf16, D % 16 == 0)
// ---------------------------------------------------------------------------
constexpr int MMA_BQ = 64;   // query rows per block: 4 warps x 16
constexpr int MMA_BK = 64;   // keys per shared-memory tile
constexpr int MMA_THREADS = 128;

// c += a * b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 fp32.  Lane l holds rows l/4 and l/4 + 8, columns 2*(l%4) + {0,1}.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 of a row as one A/B register (0 past the end)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row,
                                              bool valid, int col) {
  if (!valid) return 0u;
  __nv_bfloat162 v;
  v.x = row[col];
  v.y = row[col + 1];
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_mma_kernel(const Params p) {
  static_assert(D % 16 == 0, "tensor-core path needs D % 16 == 0");
  constexpr int KP = D + 8;        // padded shared row of K (elements)
  constexpr int VP = MMA_BK + 8;   // padded shared row of V^T
  constexpr int NB_S = MMA_BK / 8; // 8-key column blocks of S
  constexpr int NB_O = D / 8;      // 8-dim column blocks of O
  __shared__ __align__(16) __nv_bfloat16 ks[MMA_BK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const int q0 = blockIdx.x * MMA_BQ + warp * 16;  // this warp's first row
  const int row[2] = {q0 + g, q0 + g + 8};
  const bool row_ok[2] = {row[0] < p.S, row[1] < p.S};

  // Q fragments for every 16-wide slice of D, loaded once
  uint32_t qf[D / 16][4];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qrow[r] = q + b * p.q_sb + (long long)(row_ok[r] ? row[r] : 0) * p.q_ss + h * p.q_sh;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = load_pair(qrow[0], row_ok[0], kk * 16 + tig * 2);
    qf[kk][1] = load_pair(qrow[1], row_ok[1], kk * 16 + tig * 2);
    qf[kk][2] = load_pair(qrow[0], row_ok[0], kk * 16 + 8 + tig * 2);
    qf[kk][3] = load_pair(qrow[1], row_ok[1], kk * 16 + 8 + tig * 2);
  }

  float acc[NB_O][4];
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  const float scale_log2 = p.scale * 1.4426950408889634f;

  const int first_pos = blockIdx.x * MMA_BQ + p.q_offset;
  const int last_pos = min(blockIdx.x * MMA_BQ + MMA_BQ, p.S) - 1 + p.q_offset;
  const int kv_hi = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int kv_lo = p.window > 0 ? max(0, first_pos - p.window + 1) : 0;
  const int warp_first = q0 + p.q_offset;
  const int warp_last = min(q0 + 15, p.S - 1) + p.q_offset;

  const __nv_bfloat16* kbase = k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = v + b * p.v_sb + kvh * p.v_sh;

  for (int start = kv_lo; start < kv_hi; start += MMA_BK) {
    __syncthreads();  // the previous tile is no longer read
    constexpr int VEC = 8;  // bf16 per 16-byte load (rows are 16-byte aligned)
    for (int e = threadIdx.x; e < MMA_BK * D / VEC; e += MMA_THREADS) {
      const int j = e / (D / VEC);
      const int d = (e % (D / VEC)) * VEC;
      const int t = start + j;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (t < kv_hi) {
        kx = *reinterpret_cast<const uint4*>(kbase + (long long)t * p.k_st + d);
        vx = *reinterpret_cast<const uint4*>(vbase + (long long)t * p.v_st + d);
      }
      *reinterpret_cast<uint4*>(ks + j * KP + d) = kx;
      const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vt[(d + i) * VP + j] = vv[i];
    }
    __syncthreads();

    // a tile every row of this warp masks contributes nothing
    bool skip = q0 >= p.S;
    if (p.causal) skip = skip || start > warp_last;
    if (p.window > 0) skip = skip || start + MMA_BK - 1 <= warp_first - p.window;
    if (skip) continue;

    float s[NB_S][4];
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = ks + (nb * 8 + g) * KP + kk * 16 + tig * 2;
        const uint32_t bf[2] = {smem_pair(kr), smem_pair(kr + 8)};
        mma_16816(s[nb], qf[kk], bf);
      }
    }

    // mask, scale to log2 units, row max over the 4 lanes of a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int t = start + nb * 8 + tig * 2 + (i & 1);
        const int qp = row[r] + p.q_offset;
        bool ok = t < kv_hi;
        if (p.causal) ok = ok && t <= qp;
        if (p.window > 0) ok = ok && qp - t < p.window;
        s[nb][i] = ok ? s[nb][i] * scale_log2 : -INFINITY;
        mx[r] = fmaxf(mx[r], s[nb][i]);
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
    // O += P V: two adjacent 8-key blocks of S are one A fragment
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      const uint32_t af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nb = 0; nb < NB_O; ++nb) {
        const __nv_bfloat16* vr = vt + (nb * 8 + g) * VP + kk * 16 + tig * 2;
        const uint32_t bf[2] = {smem_pair(vr), smem_pair(vr + 8)};
        mma_16816(acc[nb], af, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 1.f : l[r];  // no visible key -> acc = 0
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    __nv_bfloat16* orow = o + b * p.o_sb + (long long)row[r] * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb) {
      orow[nb * 8 + tig * 2] = __float2bfloat16(acc[nb][2 * r] / l[r]);
      orow[nb * 8 + tig * 2 + 1] = __float2bfloat16(acc[nb][2 * r + 1] / l[r]);
    }
  }
}

// every row of a (B, T, K, D) view starts on a 16-byte boundary
bool aligned16(const void* ptr, long long sb, long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         st % 8 == 0 && sh % 8 == 0;
}

cudaError_t launch_mma(const Params& p, int B, int D, cudaStream_t stream) {
  const dim3 grid((p.S + MMA_BQ - 1) / MMA_BQ, B * p.H);
  switch (D) {
    case 16: flash_mma_kernel<16><<<grid, MMA_THREADS, 0, stream>>>(p); break;
    case 32: flash_mma_kernel<32><<<grid, MMA_THREADS, 0, stream>>>(p); break;
    case 64: flash_mma_kernel<64><<<grid, MMA_THREADS, 0, stream>>>(p); break;
    case 128: flash_mma_kernel<128><<<grid, MMA_THREADS, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

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
  const bool tiles16 = D % 16 == 0 && aligned16(k, k_sb, k_st, k_sh) &&
                       aligned16(v, v_sb, v_st, v_sh);
  if (dtype == 1 && tiles16)
    err = launch_mma(p, B, D, st);  // tensor cores
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(p, D, grid, st);
  else if (dtype == 0)
    err = launch<float>(p, D, grid, st);
  return static_cast<int>(err);
}
