// GraphSAGE UPDATE for Hopper (sm_90a), float32 throughout, forward and
// the elementwise part of its backward.
//
//   forward   out = drop_p(act(agg @ Wn + self @ Ws + b))           (kernel C)
//   backward  dZ  = dL/dZ for Z = agg @ Wn + self @ Ws + b,
//             db  = sum over rows of dZ                             (kernel D)
//
// drop_p keeps position (row, col) iff u(row, col, seed) >= p, with u the
// u32 mix hash of repro/models/gnn/common.py:hash_uniform on the GLOBAL
// row and column, and divides a kept value by (1 - p).  The backward draws
// no mask it stored: with ReLU, out > 0 holds exactly where the position
// was kept and Z > 0, so dZ = out > 0 ? g / (1-p) : 0; without ReLU the
// keep mask is hashed again.  The weight and input gradients (agg^T dZ,
// self^T dZ, dZ Wn^T, dZ Ws^T) are plain matrix products left to
// torch.matmul, as the reference left them to XLA's autodiff.  act
// (ReLU) keeps a NaN, as torch.relu does; NaN > 0 is false, so its dZ is
// 0 there, as in the plain version.
//
// Replaces the TPU kernel repro/kernels/update_fused.py:fused_update
// (forward only there: the reference trains through its jnp path, whose
// gradient kernel D reproduces).
//
// Bound on the H100 (3.35 TB/s; 495 TFLOP/s TF32 and 67 TFLOP/s float32
// outside the tensor cores, dense): the forward's two products do
// 4*N*C*K operations, 23 GFLOP at layer 0 of the paper's GraphSAGE
// (N=176,000, C=128, K=256), and move 2*N*C + N*K floats (0.36 GB,
// 0.107 ms).  On the CUDA cores that is bound by operations (0.34 ms at
// FFMA peak).  C takes the tensor cores instead, float32-accurate by the
// 3xTF32 split (a = a_hi + a_lo with both parts TF32; a*b is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with float32 accumulation, the
// a_lo*b_lo term below float32's rounding): three TF32 products, 12*N*C*K
// operations at 495 TFLOP/s, 0.14 ms at layer 0, so close to the byte
// bound there.  Plain TF32 (one product) keeps ~3 decimal digits and is
// not used: the reference is float32.  D moves g, out and dZ (3*N*K
// floats) and computes next to nothing: bound by bytes.
//
// Design of C (3xTF32 on mma.sync; the split, the mma and the staging
// helpers are in tf32x3.cuh, shared with kernel A):
//  - a block computes a BM x 64 output tile with warps of 32 x 32 each
//    (2 x 4 m16n8k8 tiles): 128 x 64 with 8 warps, or 32 x 64 with 2 warps
//    where the large tile would leave SMs idle (the last layer, N ~ 1,000,
//    K = 172); the wrapper picks the tile from N, K and the SM count.  The
//    grid walks the columns fastest, so the K / 64 blocks of a row tile
//    run together and read its input rows once from memory;
//  - the block walks both products as one sequence of 2 * ceil(C / 32)
//    steps (agg/Wn, then self/Ws), each staging a [BM, 32] input tile and
//    a [32, 64] weight tile by cp.async into a double buffer: the next
//    step's copies fly while one is multiplied; 16-byte copies where C
//    and K are multiples of 4 and the bases are aligned, 4-byte ones
//    otherwise, zero-filled past N, C and K;
//  - the shared tiles are padded (rows of 36 and 72 floats) so that every
//    fragment read is free of bank conflicts; each fragment element is
//    split into its hi and lo TF32 parts in registers and fed to three
//    mma.sync per tile; each step's products are summed apart and added
//    to the running sums on the CUDA cores (the tensor cores' own adds
//    truncate, and over C = 1,024 their error came to 1e-4 relative on
//    the card);
//  - one accumulator set in registers: when the first product is done
//    its sums go to shared memory and the second product reuses the
//    registers, so a thread needs under 128 registers and two blocks
//    share an SM (the first version, with both sets live, ran one);
//  - the products are summed with the bias in the reference's order
//    (accn + accs + b), then ReLU and the dropout in registers before one
//    store (two floats at a time where K is even); a kept value is
//    multiplied by 1 / (1 - p) rather than divided (within an ulp).
//  D, one launch: the wrapper picks a stripe count from N and the SM
//     count (update_fused.bwd_stripes: two blocks per SM at large N, all
//     resident at once, so no ragged last wave).  A block's threads own
//     float4 column units (scalar ones where K % 4 != 0 or a base is not
//     16-byte aligned), several threads per unit striding the stripe's
//     rows with 8 rows' loads in flight; dZ is written as it is made and
//     its column sums go to partial[stripe].  The last block to finish
//     (a ticket taken after __threadfence) sums the partials in stripe
//     order and re-zeroes the ticket, which the wrapper keeps per device
//     and stream: db is deterministic, no float atomics and no second
//     launch.
// What paces C is the instruction stream around the products (the
// splits, the staging, the epilogue), not the tensor cores: a trial with
// wgmma (A split in registers, W split into K-major hi/lo planes in
// shared memory) gave the same values and was no faster.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;      // threads of a backward stripe block
constexpr int ROWS_IN_FLIGHT = 8; // rows a backward thread loads at once
constexpr int SUMS_IN_FLIGHT = 16;  // stripe partials the last block loads

// kernel C's tiling
constexpr int BK = 32;            // depth of one staged step
constexpr int BN = 64;            // output columns per block
constexpr int STAGES = 2;         // cp.async ring depth (double buffer)
constexpr int WM = 32, WN = 32;   // output tile of one warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp
constexpr int A_LD = BK + 4;      // padded row of a staged input tile
constexpr int B_LD = BN + 8;      // padded row of a staged weight tile

__device__ __forceinline__ float hash_u01(uint32_t row, uint32_t col,
                                          uint32_t seed) {
  uint32_t h = (row * 0x85EBCA6Bu) ^ (col * 0xC2B2AE35u) ^ seed;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return (float)(h >> 8) / 16777216.0f;
}

// Stage step s: A[m0:m0+BM, k0:k0+BK] and B[k0:k0+BK, n0:n0+BN] of the
// product s / KT into As [BM][A_LD] and Bs [BK][B_LD].
template <int BM, int NTHREADS, int VW>
__device__ __forceinline__ void load_step(
    float* As, float* Bs, const float* __restrict__ agg,
    const float* __restrict__ self_h, const float* __restrict__ wn,
    const float* __restrict__ ws, int s, int KT, int m0, int n0, int N,
    int C, int K) {
  const bool second = s >= KT;
  const float* A = second ? self_h : agg;
  const float* B = second ? ws : wn;
  const int k0 = (second ? s - KT : s) * BK;
  constexpr int AC = BK / VW, BC = BN / VW;     // copies per row
  for (int e = threadIdx.x; e < BM * AC; e += NTHREADS) {
    const int r = e / AC, c = (e - r * AC) * VW;
    const int m = m0 + r, k = k0 + c;
    const bool p = m < N && k < C;
    cp_async<VW * 4>(As + r * A_LD + c, p ? A + (size_t)m * C + k : A, p);
  }
  for (int e = threadIdx.x; e < BK * BC; e += NTHREADS) {
    const int r = e / BC, c = (e - r * BC) * VW;
    const int k = k0 + r, n = n0 + c;
    const bool p = k < C && n < K;
    cp_async<VW * 4>(Bs + r * B_LD + c, p ? B + (size_t)k * K + n : B, p);
  }
}

template <int BM, int WARPS_M, int VW>
__global__ void __launch_bounds__(WARPS_M * (BN / WN) * 32, 2)
update_fwd_kernel(const float* __restrict__ agg,
                  const float* __restrict__ self_h,
                  const float* __restrict__ wn, const float* __restrict__ ws,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int N, int C, int K, int relu, float p, float keep_div,
                  uint32_t seed) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int STAGE = BM * A_LD + BK * B_LD;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // the first product's sums wait here, [(i * NT + j) * 4 + e][thread],
  // while the second product runs in the same registers
  float* stash = smem + STAGES * STAGE;
  // x walks the output columns: the K / 64 blocks of one row tile run
  // side by side and read its input rows from L2 after the first
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * WM, wn_ = (warp % WARPS_N) * WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  const int KT = (C + BK - 1) / BK;
  const int T = 2 * KT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T) {
      float* st = smem + s * STAGE;
      load_step<BM, NTHREADS, VW>(st, st + BM * A_LD, agg, self_h, wn, ws, s,
                                  KT, m0, n0, N, C, K);
    }
    cp_async_commit();
  }
  for (int s = 0; s < T; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = s + STAGES - 1;
    if (nx < T) {
      float* st = smem + (nx % STAGES) * STAGE;
      load_step<BM, NTHREADS, VW>(st, st + BM * A_LD, agg, self_h, wn, ws,
                                  nx, KT, m0, n0, N, C, K);
    }
    cp_async_commit();
    const float* As = smem + (s % STAGES) * STAGE;
    mma_step<MT, NT, BK>(As, A_LD, As + BM * A_LD, B_LD, acc, wm, wn_,
                         lane);
    if (s == KT - 1) {            // agg @ Wn done: stash it, start self @ Ws
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            stash[((i * NT + j) * 4 + e) * NTHREADS + threadIdx.x] =
                acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  float accn[MT][NT][4];
  const float(&accs)[MT][NT][4] = acc;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accn[i][j][e] = stash[((i * NT + j) * 4 + e) * NTHREADS + threadIdx.x];
      }
    }
  }

  // epilogue: accumulator e of tile (i, j) is row g + 8 (e / 2), column
  // 2 t + (e % 2) of the tile
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (K % 2) == 0;
  // a kept value is scaled by the reciprocal of keep_div, rounded once:
  // within an ulp of the division the plain version does, at a fraction
  // of its cost (a float32 division is a subroutine; dividing every
  // output made the epilogue a fifth of the kernel's time at layer 0)
  const float inv_keep = 1.f / keep_div;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + 16 * i + g + 8 * half;
      if (m >= N) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn_ + 8 * j + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n + e;
          float x = 0.f;
          if (col < K) {
            x = accn[i][j][2 * half + e] + accs[i][j][2 * half + e]
                + bias[col];
            // torch.relu's clamp_min on the card: NaN stays NaN
            if (relu) x = isnan(x) ? x : fmaxf(x, 0.f);
            if (p > 0.f) {
              x = hash_u01((uint32_t)m, (uint32_t)col, seed) >= p
                      ? x * inv_keep
                      : 0.f;
            }
          }
          v[e] = x;
        }
        float* dst = out + (size_t)m * K + n;
        if (pairs && n + 1 < K) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          if (n < K) dst[0] = v[0];
          if (n + 1 < K) dst[1] = v[1];
        }
      }
    }
  }
}

template <int BM, int WARPS_M, int VW>
int launch_fwd(const float* agg, const float* self_h, const float* wn,
               const float* ws, const float* bias, float* out, int N, int C,
               int K, int relu, float p, float keep_div, uint32_t seed,
               cudaStream_t stream) {
  constexpr int NTHREADS = WARPS_M * (BN / WN) * 32;
  constexpr size_t SMEM = ((size_t)STAGES * (BM * A_LD + BK * B_LD)
                           + (size_t)NTHREADS * MT * NT * 4) * sizeof(float);
  static bool attr_set = false;       // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        update_fwd_kernel<BM, WARPS_M, VW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((K + BN - 1) / BN, (N + BM - 1) / BM);
  update_fwd_kernel<BM, WARPS_M, VW><<<grid, NTHREADS, SMEM, stream>>>(
      agg, self_h, wn, ws, bias, out, N, C, K, relu, p, keep_div, seed);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// The columns a backward thread owns: units of VW floats, CU of them per
// pass of the block (VW = 4 where K % 4 == 0 and the tensors are 16-byte
// aligned), and TR threads per unit striding the rows.
template <int VW>
struct Units {
  int U, CU, TR, cu, tr;
  __device__ __forceinline__ Units(int K) {
    U = K / VW;
    CU = min(U, THREADS);
    TR = THREADS / CU;
    cu = threadIdx.x % CU;
    tr = threadIdx.x / CU;
  }
};

template <int VW> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T ld(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T ldcg(const float* p) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void st(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float& at(T& v, int e) {
    return (&v.x)[e];
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T ld(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T ldcg(const float* p) {
    return __ldcg(p);
  }
  static __device__ __forceinline__ void st(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float& at(T& v, int) { return v; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};

// dZ of one element: the true division g / keep_div, as the plain version
// divides (a reciprocal would differ in the last bit).
__device__ __forceinline__ float dz_of(float gv, float ov, uint32_t r,
                                       uint32_t c, int relu, float p,
                                       float keep_div, uint32_t seed) {
  if (relu) return ov > 0.f ? (p > 0.f ? gv / keep_div : gv) : 0.f;
  if (p > 0.f) return hash_u01(r, c, seed) >= p ? gv / keep_div : 0.f;
  return gv;
}

// Kernel D.  Block b owns rows [b * rows, (b + 1) * rows): it writes their
// dZ and its column sums into partial[b]; the last block to finish (a
// ticket taken after __threadfence) sums the stripes' partials in stripe
// order into db and sets the ticket back to 0 for the next launch.  Every
// sum is taken in an order fixed by N, K and the grid: db is
// deterministic, with no float atomics.
template <int VW>
__global__ void __launch_bounds__(THREADS)
update_bwd_kernel(const float* __restrict__ g, const float* __restrict__ out,
                  float* __restrict__ dz, float* __restrict__ db,
                  float* __restrict__ partial, unsigned* __restrict__ ticket,
                  int N, int K, int rows, int relu, float p, float keep_div,
                  uint32_t seed) {
  using V = Vec<VW>;
  using T = typename V::T;
  __shared__ T red[THREADS];
  __shared__ bool last;
  const Units<VW> u(K);
  const bool on = u.tr < u.TR;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, N);
  const int step = u.TR * ROWS_IN_FLIGHT;
  for (int c0 = 0; c0 < u.U; c0 += u.CU) {
    const int c = c0 + u.cu;
    const bool col = on && c < u.U;
    T sum = V::zero();
    if (col) {
      for (int rb = r0 + u.tr; rb < r1; rb += step) {
        T gv[ROWS_IN_FLIGHT], ov[ROWS_IN_FLIGHT];
#pragma unroll
        for (int k = 0; k < ROWS_IN_FLIGHT; ++k) {
          const int r = rb + k * u.TR;
          if (r < r1) {
            const size_t at = (size_t)r * K + (size_t)c * VW;
            gv[k] = V::ld(g + at);
            ov[k] = relu ? V::ld(out + at) : V::zero();
          }
        }
#pragma unroll
        for (int k = 0; k < ROWS_IN_FLIGHT; ++k) {
          const int r = rb + k * u.TR;
          if (r < r1) {
            T d;
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              V::at(d, e) = dz_of(V::at(gv[k], e), V::at(ov[k], e),
                                  (uint32_t)r, (uint32_t)(c * VW + e), relu,
                                  p, keep_div, seed);
            }
            V::st(dz + (size_t)r * K + (size_t)c * VW, d);
            V::add(sum, d);
          }
        }
      }
    }
    // the stripe's column sums: the TR row lanes of a unit, in order
    red[threadIdx.x] = sum;
    __syncthreads();
    if (col && u.tr == 0) {
      T s = red[u.cu];
      for (int i = 1; i < u.TR; ++i) V::add(s, red[i * u.CU + u.cu]);
      V::st(partial + (size_t)blockIdx.x * K + (size_t)c * VW, s);
    }
    __syncthreads();
  }

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: db = the stripes' partials summed in stripe order,
  // lane tr of a unit taking stripes tr, tr + TR, ... (SUMS_IN_FLIGHT
  // loads at once), then the lanes in order
  const int S = gridDim.x;
  for (int c0 = 0; c0 < u.U; c0 += u.CU) {
    const int c = c0 + u.cu;
    const bool col = on && c < u.U;
    T sum = V::zero();
    if (col) {
      for (int sb = u.tr; sb < S; sb += u.TR * SUMS_IN_FLIGHT) {
        T v[SUMS_IN_FLIGHT];
#pragma unroll
        for (int k = 0; k < SUMS_IN_FLIGHT; ++k) {
          const int st = sb + k * u.TR;
          v[k] = st < S ? V::ldcg(partial + (size_t)st * K + (size_t)c * VW)
                        : V::zero();
        }
#pragma unroll
        for (int k = 0; k < SUMS_IN_FLIGHT; ++k) {
          if (sb + k * u.TR < S) V::add(sum, v[k]);
        }
      }
    }
    red[threadIdx.x] = sum;
    __syncthreads();
    if (col && u.tr == 0) {
      T s = red[u.cu];
      for (int i = 1; i < u.TR; ++i) V::add(s, red[i * u.CU + u.cu]);
      V::st(db + (size_t)c * VW, s);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

// Kernel C.  keep_div = (float)(1 - p), computed by the caller; `tile`
// picks the block tile: 1 for 128 x 64 (8 warps), 0 for 32 x 64 (2 warps).
extern "C" int update_fused_fwd(const void* agg, const void* self_h,
                                const void* wn, const void* ws,
                                const void* bias, void* out, int N, int C,
                                int K, int relu, float p, float keep_div,
                                uint32_t seed, int tile, void* stream) {
  const bool vec = C % 4 == 0 && K % 4 == 0 && aligned16(agg)
                   && aligned16(self_h) && aligned16(wn) && aligned16(ws);
  const float *a = (const float*)agg, *sh = (const float*)self_h,
              *n_ = (const float*)wn, *s_ = (const float*)ws,
              *b = (const float*)bias;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (tile) {
    return vec ? launch_fwd<128, 4, 4>(a, sh, n_, s_, b, o, N, C, K, relu, p,
                                       keep_div, seed, st)
               : launch_fwd<128, 4, 1>(a, sh, n_, s_, b, o, N, C, K, relu, p,
                                       keep_div, seed, st);
  }
  return vec ? launch_fwd<32, 1, 4>(a, sh, n_, s_, b, o, N, C, K, relu, p,
                                    keep_div, seed, st)
             : launch_fwd<32, 1, 1>(a, sh, n_, s_, b, o, N, C, K, relu, p,
                                    keep_div, seed, st);
}

// Kernel D, one launch.  `partial` is scratch of `stripes` * K floats;
// `ticket` one unsigned that is 0 before the launch (the launch leaves it
// 0); `out` is read only with relu (may be null without).
extern "C" int update_fused_bwd(const void* g, const void* out, void* dz,
                                void* db, void* partial, void* ticket, int N,
                                int K, int relu, float p, float keep_div,
                                uint32_t seed, int stripes, void* stream) {
  const bool vec = K % 4 == 0 && aligned16(g) && aligned16(dz)
                   && aligned16(partial) && aligned16(db)
                   && (!relu || aligned16(out));
  const int rows = (N + stripes - 1) / stripes;
  const int grid = (N + rows - 1) / rows;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    update_bwd_kernel<4><<<grid, THREADS, 0, st>>>(
        (const float*)g, (const float*)out, (float*)dz, (float*)db,
        (float*)partial, (unsigned*)ticket, N, K, rows, relu, p, keep_div,
        seed);
  } else {
    update_bwd_kernel<1><<<grid, THREADS, 0, st>>>(
        (const float*)g, (const float*)out, (float*)dz, (float*)db,
        (float*)partial, (unsigned*)ticket, N, K, rows, relu, p, keep_div,
        seed);
  }
  return (int)cudaGetLastError();
}
