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
// torch.matmul, as the reference left them to XLA's autodiff.
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
// Design of C (3xTF32 on mma.sync):
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
//  D: pass 1, one thread per column and a block per 128-row stripe,
//     writes dZ and the stripe's column sums (coalesced along the row);
//     pass 2, one block per column, sums the stripes in a fixed order and
//     a fixed shared-memory tree: db is deterministic, no atomics.
// What paces C is the instruction stream around the products (the
// splits, the staging, the epilogue), not the tensor cores: a trial with
// wgmma (A split in registers, W split into K-major hi/lo planes in
// shared memory) gave the same values and was no faster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 128;           // rows per stripe in the backward
constexpr int THREADS = 256;      // threads of a backward stripe block
constexpr int RED = 256;          // threads of the column reduction

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (4 or 16) bytes, or that many zeros when !pred.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool pred) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(pred ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(pred ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away: add half
// of the 13 dropped bits, then drop them), lo the exact remainder, whose
// own low 13 bits the tensor cores ignore.  Two integer ops and a
// subtract: cvt.rna.tf32.f32 issues at the conversion rate, and the split
// runs for every fragment element.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// acc += the warp's [WM, WN] tile of As @ Bs over one staged step.  The
// tensor cores add into their float32 accumulator by truncation, so over
// a long sum (3 * C / 8 mma) the error grows with the number of adds; the
// step's products are summed in a fresh accumulator and added to acc on
// the CUDA cores, rounded to nearest.
__device__ __forceinline__ void mma_step(const float* As, const float* Bs,
                                         float (&acc)[MT][NT][4], int wm,
                                         int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* a = As + (wm + 16 * i + g) * A_LD + kk + t;
      split_tf32(a[0], ah[i][0], al[i][0]);
      split_tf32(a[8 * A_LD], ah[i][1], al[i][1]);
      split_tf32(a[4], ah[i][2], al[i][2]);
      split_tf32(a[8 * A_LD + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = Bs + (kk + t) * B_LD + wn + 8 * j + g;
      split_tf32(b[0], bh[j][0], bl[j][0]);
      split_tf32(b[4 * B_LD], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_tf32(part[i][j], al[i], bh[j]);
        mma_tf32(part[i][j], ah[i], bl[j]);
        mma_tf32(part[i][j], ah[i], bh[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
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
    mma_step(As, As + BM * A_LD, acc, wm, wn_, lane);
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
            if (relu) x = fmaxf(x, 0.f);
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

__global__ void __launch_bounds__(THREADS)
update_bwd_stripes_kernel(const float* __restrict__ g,
                          const float* __restrict__ out,
                          float* __restrict__ dz, float* __restrict__ partial,
                          int N, int K, int relu, float p, float keep_div,
                          uint32_t seed) {
  const int n = blockIdx.y * THREADS + threadIdx.x;
  if (n >= K) return;
  const int r0 = blockIdx.x * RB;
  const int r1 = min(r0 + RB, N);
  float colsum = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t at = (size_t)r * K + n;
    const float gv = g[at];
    float d;
    if (relu) {
      d = out[at] > 0.f ? (p > 0.f ? gv / keep_div : gv) : 0.f;
    } else if (p > 0.f) {
      d = hash_u01((uint32_t)r, (uint32_t)n, seed) >= p ? gv / keep_div : 0.f;
    } else {
      d = gv;
    }
    dz[at] = d;
    colsum += d;
  }
  partial[(size_t)blockIdx.x * K + n] = colsum;
}

__global__ void __launch_bounds__(RED)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ db,
                  int stripes, int K) {
  __shared__ float s[RED];
  const int n = blockIdx.x;
  float v = 0.f;
  for (int i = threadIdx.x; i < stripes; i += RED) v += partial[(size_t)i * K + n];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = RED / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) db[n] = s[0];
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

// Kernel D.  `partial` is scratch of ceil(N / 128) * K floats; `out` is
// read only with relu (may be null without).
extern "C" int update_fused_bwd(const void* g, const void* out, void* dz,
                                void* db, void* partial, int N, int K,
                                int relu, float p, float keep_div,
                                uint32_t seed, void* stream) {
  const int stripes = (N + RB - 1) / RB;
  const dim3 grid(stripes, (K + THREADS - 1) / THREADS);
  update_bwd_stripes_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)out, (float*)dz, (float*)partial, N, K,
      relu, p, keep_div, seed);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum_kernel<<<K, RED, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)db, stripes, K);
  return (int)cudaGetLastError();
}
