// Fused GraphSAGE serve layer for Hopper (sm_90a), float32 throughout.
//
//   out[m] = act( mean_{j : nbr[m,j] >= 0 && valid[nbr[m,j]]} h[nbr[m,j]] @ Wn
//                 + h[self_row(m)] @ Ws + b )
//
// self_row(m) = m (the serve blocks' dst-prefix invariant) or, when
// self_idx is given, clamp(self_idx[m], 0, N-1) (offline chunks).
//
// Replaces the TPU kernel repro/kernels/serve_fused.py:fused_serve_layer
// (one pallas_call per serve layer).
//
// Bound on the H100 (989/67 TFLOP/s, 3.35 TB/s): the two products do
// 4*M*D*K float32 operations, about 1.48 GFLOP at layer 0 of the
// graphsage-papers100m serve step (M=11264, D=128, K=256), 22 us at the
// 67 TFLOP/s of non-tensor-core float32; the gather reads at most
// M*f*D*4 bytes (28.8 MB there, 8.6 us).  So layer 0, which takes most of
// the step, is bound by float32 operations; the output layer (M=64) moves
// more bytes than it computes.  chip_smoke.py computes each bound from the
// data it runs.
//
// Design (first version, right before fast): one block of 256 threads per
// tile of BM=16 dst rows by BN=256 output columns.
//   1. The block gathers its rows' masked neighbor means and self rows into
//      shared memory (2*BM*D floats, 32 KB at D=256), summing the f
//      neighbors in slot order; neighboring threads read neighboring
//      columns of a row, so the row gathers are coalesced.
//   2. Each thread keeps a 4x4 register tile of both products, walking D
//      with Wn/Ws rows read straight from global memory (coalesced across
//      the columns; Wn and Ws stay in L2) and the staged rows read from
//      shared memory as warp-wide broadcasts.  The two products are kept
//      apart and summed with the bias at the end, in the order of the
//      reference ``agg@Wn + self@Ws + b``.
// Columns past K (K=172 at the output layer) and rows past M are masked.
// wgmma/TMA tiling is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;            // dst rows per block
constexpr int TX = 64;            // threads along the output columns
constexpr int TY = 4;             // threads along the rows
constexpr int TM = BM / TY;       // rows per thread
constexpr int TN = 4;             // columns per thread (strided by TX)
constexpr int BN = TX * TN;       // output columns per block
constexpr int THREADS = TX * TY;

__global__ void __launch_bounds__(THREADS)
serve_fused_layer_kernel(const float* __restrict__ h,
                         const int32_t* __restrict__ nbr,
                         const bool* __restrict__ valid,
                         const float* __restrict__ wn,
                         const float* __restrict__ ws,
                         const float* __restrict__ bias,
                         const int32_t* __restrict__ self_idx,
                         float* __restrict__ out,
                         int N, int M, int f, int D, int K, int relu) {
  extern __shared__ float smem[];
  float* agg_s = smem;             // [BM][D] masked neighbor means
  float* self_s = smem + BM * D;   // [BM][D] self rows
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // 1. gather: element e = (row r, column d) of the block's row tile
  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const int m = m0 + r;
    float a = 0.f, sv = 0.f;
    if (m < M) {
      const int32_t* row = nbr + (size_t)m * f;
      float sum = 0.f, cnt = 0.f;
      for (int j = 0; j < f; ++j) {
        const int idx = min(row[j], N - 1);
        if (idx >= 0 && valid[idx]) {
          sum += h[(size_t)idx * D + d];
          cnt += 1.f;
        }
      }
      a = sum / fmaxf(cnt, 1.f);
      const int srow = self_idx ? min(max(self_idx[m], 0), N - 1) : m;
      sv = h[(size_t)srow * D + d];
    }
    agg_s[e] = a;
    self_s[e] = sv;
  }
  __syncthreads();

  // 2. both products over D, a TM x TN register tile per thread
  const int tx = tid % TX;
  const int ty = tid / TX;
  float accn[TM][TN], accs[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accn[i][j] = 0.f;
      accs[i][j] = 0.f;
    }
  }
  bool col_ok[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) col_ok[j] = n0 + tx + j * TX < K;

#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float wnv[TN], wsv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const size_t w_off = (size_t)d * K + n0 + tx + j * TX;
      wnv[j] = col_ok[j] ? __ldg(wn + w_off) : 0.f;
      wsv[j] = col_ok[j] ? __ldg(ws + w_off) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a = agg_s[(ty * TM + i) * D + d];
      const float s = self_s[(ty * TM + i) * D + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        accn[i][j] = fmaf(a, wnv[j], accn[i][j]);
        accs[i][j] = fmaf(s, wsv[j], accs[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (!col_ok[j]) continue;
      const int n = n0 + tx + j * TX;
      float v = accn[i][j] + accs[i][j] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      out[(size_t)m * K + n] = v;
    }
  }
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  self_idx may be null.
extern "C" int serve_fused_layer(const void* h, const void* nbr,
                                 const void* valid, const void* wn,
                                 const void* ws, const void* bias,
                                 const void* self_idx, void* out, int N,
                                 int M, int f, int D, int K, int relu,
                                 void* stream) {
  const size_t smem = 2 * (size_t)BM * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        serve_fused_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((M + BM - 1) / BM, (K + BN - 1) / BN);
  serve_fused_layer_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const int32_t*)nbr, (const bool*)valid,
      (const float*)wn, (const float*)ws, (const float*)bias,
      (const int32_t*)self_idx, (float*)out, N, M, f, D, K, relu);
  return (int)cudaGetLastError();
}
