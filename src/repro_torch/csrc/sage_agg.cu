// GraphSAGE AGG for Hopper (sm_90a), float32, forward and backward.
//
//   forward   mean[m] = sum_{j in J(m)} h[nbr[m,j]] / max(|J(m)|, 1),
//             cnt[m]  = |J(m)|,   J(m) = { j : nbr[m,j] >= 0 && valid[nbr[m,j]] }
//                                                                   (kernel E)
//   backward  dh[nbr[m,j]] += g[m] / max(cnt[m], 1)  for j in J(m),
//             nbr[m,j] < N                                          (kernel F)
//
// The sums run in slot order from 0, as the Pallas kernel's grid does, and
// the mean is a true division.  In the forward an index past the last row
// is clamped to it, as jnp's gather clamps; the backward drops it, as the
// gather's gradient (a scatter) drops out-of-range indices.
//
// Replaces the TPU kernel repro/kernels/sage_agg.py:sage_agg (forward,
// whose (s, c) outputs are kernel E's sum and count); kernel F is its
// gradient with respect to h, which the reference takes by XLA's autodiff
// of gather_neighbors + masked_mean.
//
// Bound on the H100 (3.35 TB/s): bytes.  E reads each included neighbor
// row once (at most M*f*D*4 bytes, 0.45 GB at layer 0 of the paper's
// GraphSAGE: 176,000 x 5 x 128) and writes M*D floats; it adds one float
// per byte read.  F reads g and writes dh (N*D floats, zeroed by the
// caller) and adds as many floats as E reads.
//
// Design (first version, right before fast), as kernel A's gather: one
// warp per dst row, 8 rows per block.  Every lane counts the row's
// included slots (the index row is one cached line); then each lane owns
// float4 columns (scalar columns where D % 4 != 0 or a base is not 16-byte
// aligned) and walks the slots in order.  F scatters with float
// atomicAdd, so its sums come in a run-dependent order: it is held to a
// tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // dst rows per block

__device__ __forceinline__ bool included(const int32_t* row, int j, int N,
                                         const bool* valid, int* idx) {
  const int i = min(row[j], N - 1);
  *idx = i;
  return i >= 0 && valid[i];
}

__global__ void __launch_bounds__(WARPS * 32)
sage_agg_fwd_kernel(const float* __restrict__ h,
                    const int32_t* __restrict__ nbr,
                    const bool* __restrict__ valid, float* __restrict__ mean,
                    float* __restrict__ cnt, int N, int M, int f, int D,
                    int vec) {
  const int m = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;             // uniform across the warp
  const int32_t* row = nbr + (size_t)m * f;
  float c = 0.f;
  int idx;
  for (int j = 0; j < f; ++j) c += included(row, j, N, valid, &idx) ? 1.f : 0.f;
  if (lane == 0) cnt[m] = c;
  const float denom = fmaxf(c, 1.f);
  if (vec) {
    const int D4 = D / 4;
    const float4* h4 = reinterpret_cast<const float4*>(h);
    float4* out4 = reinterpret_cast<float4*>(mean + (size_t)m * D);
    for (int q = lane; q < D4; q += 32) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < f; ++j) {
        if (!included(row, j, N, valid, &idx)) continue;
        const float4 v = h4[(size_t)idx * D4 + q];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      out4[q] = make_float4(s.x / denom, s.y / denom, s.z / denom,
                            s.w / denom);
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      float s = 0.f;
      for (int j = 0; j < f; ++j) {
        if (included(row, j, N, valid, &idx)) s += h[(size_t)idx * D + d];
      }
      mean[(size_t)m * D + d] = s / denom;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
sage_agg_bwd_kernel(const float* __restrict__ g,
                    const int32_t* __restrict__ nbr,
                    const bool* __restrict__ valid,
                    const float* __restrict__ cnt, float* __restrict__ dh,
                    int N, int M, int f, int D) {
  const int m = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const int32_t* row = nbr + (size_t)m * f;
  const float denom = fmaxf(cnt[m], 1.f);
  const float* grow = g + (size_t)m * D;
  int idx;
  for (int j = 0; j < f; ++j) {
    if (row[j] >= N || !included(row, j, N, valid, &idx)) continue;
    float* dst = dh + (size_t)idx * D;
    for (int d = lane; d < D; d += 32) atomicAdd(dst + d, grow[d] / denom);
  }
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

// Kernel E.
extern "C" int sage_agg_fwd(const void* h, const void* nbr, const void* valid,
                            void* mean, void* cnt, int N, int M, int f, int D,
                            void* stream) {
  const int vec = (D % 4 == 0) && ((uintptr_t)h % 16 == 0)
                  && ((uintptr_t)mean % 16 == 0);
  const int blocks = (M + WARPS - 1) / WARPS;
  sage_agg_fwd_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const int32_t*)nbr, (const bool*)valid, (float*)mean,
      (float*)cnt, N, M, f, D, vec);
  return (int)cudaGetLastError();
}

// Kernel F.  `dh` [N, D] must be zero (the caller allocates it zeroed).
extern "C" int sage_agg_bwd(const void* g, const void* nbr, const void* valid,
                            const void* cnt, void* dh, int N, int M, int f,
                            int D, void* stream) {
  const int blocks = (M + WARPS - 1) / WARPS;
  sage_agg_bwd_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int32_t*)nbr, (const bool*)valid,
      (const float*)cnt, (float*)dh, N, M, f, D);
  return (int)cudaGetLastError();
}
