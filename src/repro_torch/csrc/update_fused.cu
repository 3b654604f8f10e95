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
// Bound on the H100 (67 TFLOP/s float32 outside the tensor cores,
// 3.35 TB/s): the forward's two products do 4*N*C*K operations, 23 GFLOP
// at layer 0 of the paper's GraphSAGE (N=176,000, C=128, K=256), 0.34 ms;
// it moves 2*N*C + N*K floats (0.36 GB, 0.11 ms).  So C is bound by
// float32 operations at every layer of the main path.  D moves g, out
// and dZ (3*N*K floats) and computes next to nothing: bound by bytes.
// No TF32: the reference is float32.
//
// Design (first version, right before fast):
//  C: one block of 256 threads per 64x64 output tile.  Both products walk
//     C in steps of 16: the block stages a 64x16 input tile (transposed)
//     and a 16x64 weight tile in shared memory, and each thread keeps a
//     4x4 register tile per product, rows and columns strided by 16 so
//     the shared reads are broadcasts or conflict-free.  The two products
//     stay in separate accumulators and are summed with the bias in the
//     reference's order, then ReLU and the dropout are applied in
//     registers before the single store.  Ragged N, C and K are masked.
//  D: pass 1, one thread per column and a block per 128-row stripe,
//     writes dZ and the stripe's column sums (coalesced along the row);
//     pass 2, one block per column, sums the stripes in a fixed order and
//     a fixed shared-memory tree: db is deterministic, no atomics.
// wgmma/TMA tiling is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // output rows per block
constexpr int BN = 64;            // output columns per block
constexpr int BK = 16;            // depth of one staged step
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int TM = 4;             // rows per thread (stride 16)
constexpr int TN = 4;             // columns per thread (stride 16)
constexpr int RB = 128;           // rows per stripe in the backward
constexpr int RED = 256;          // threads of the column reduction

__device__ __forceinline__ float hash_u01(uint32_t row, uint32_t col,
                                          uint32_t seed) {
  uint32_t h = (row * 0x85EBCA6Bu) ^ (col * 0xC2B2AE35u) ^ seed;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return (float)(h >> 8) / 16777216.0f;
}

// acc += A[m0:m0+BM, :] @ B[:, n0:n0+BN] through the shared tiles.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, const float* __restrict__ B,
    float (*As)[BM + 1], float (*Bs)[BN], float (&acc)[TM][TN], int m0,
    int n0, int N, int C, int K) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int k0 = 0; k0 < C; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e - r * BK;
      const int m = m0 + r;
      const int k = k0 + c;
      As[c][r] = (m < N && k < C) ? A[(size_t)m * C + k] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e - r * BN;
      const int k = k0 + r;
      const int n = n0 + c;
      Bs[r][c] = (k < C && n < K) ? B[(size_t)k * K + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
update_fwd_kernel(const float* __restrict__ agg,
                  const float* __restrict__ self_h,
                  const float* __restrict__ wn, const float* __restrict__ ws,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int N, int C, int K, int relu, float p, float keep_div,
                  uint32_t seed) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float accn[TM][TN], accs[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accn[i][j] = 0.f;
      accs[i][j] = 0.f;
    }
  }
  tile_product(agg, wn, As, Bs, accn, m0, n0, N, C, K);
  tile_product(self_h, ws, As, Bs, accs, m0, n0, N, C, K);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= K) continue;
      float v = accn[i][j] + accs[i][j] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      if (p > 0.f) {
        v = hash_u01((uint32_t)m, (uint32_t)n, seed) >= p ? v / keep_div
                                                          : 0.f;
      }
      out[(size_t)m * K + n] = v;
    }
  }
}

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

// Kernel C.  keep_div = (float)(1 - p), computed by the caller.
extern "C" int update_fused_fwd(const void* agg, const void* self_h,
                                const void* wn, const void* ws,
                                const void* bias, void* out, int N, int C,
                                int K, int relu, float p, float keep_div,
                                uint32_t seed, void* stream) {
  const dim3 grid((N + BM - 1) / BM, (K + BN - 1) / BN);
  update_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)agg, (const float*)self_h, (const float*)wn,
      (const float*)ws, (const float*)bias, (float*)out, N, C, K, relu, p,
      keep_div, seed);
  return (int)cudaGetLastError();
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
