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
// Design of E, kernel A's gather (serve_fused.cu) without its products.
// The first design (one warp per dst row, every lane walking the row's
// slots twice, each slot a chain of index, flag and row loads) stayed at
// 2.9x its bound at layer 0 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  Now
// a warp owns `rows` dst rows and one slice of `slice` columns (a
// multiple of 128) of them; the wrapper picks both from M, f, D and the
// SM count (sage_agg.agg_form): rows enough that their slots fill one
// 32-slot chunk where the rows alone give the card work enough, fewer
// rows and then more slices where they do not (layer 2's 1,000 rows).  A
// warp's rows are spread over the M rows (rows rt, rt + RT, ..., RT =
// ceil(M / rows)): the minibatch lists its live rows first and pads with
// -1, and so every warp gets a share of them.  For each 32-slot chunk of
// its rows' slots, lane j loads slot j's index and then its valid flag
// (all loads of a chunk independent), and a ballot compacts the included
// slots, in row and slot order, into the warp's list in shared memory.
// The warp then walks the list with 8 row loads in flight before the
// adds (float4 along D, 4 rows of two column groups where the slice is
// 64 float4 wide; float where D % 4 != 0 or a base is not 16-byte
// aligned), each added into the running sum of its row in registers;
// when the list moves on to a later row, the sum is divided by its count
// and stored.  So each column's sum is taken in slot order from 0 and
// divided by the count with a true division, as before: E's mean and
// count are bit-equal to the first design's.  What paces it: at layers 0
// and 1 the bytes (the mean rows written, most of them zero rows of the
// padding, and the rows gathered), within 1.6x of the bound; at layer 2
// the launch (PERF.md).
//
// F scatters with float atomicAdd (one warp per dst row, 8 rows per
// block), so its sums come in a run-dependent order: it is held to a
// tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // dst rows per block (F), warps (E)
constexpr unsigned FULL = 0xffffffffu;
constexpr int IN_FLIGHT = 8;      // loads of h a lane has in flight (E)

__device__ __forceinline__ bool included(const int32_t* row, int j, int N,
                                         const bool* valid, int* idx) {
  const int i = min(row[j], N - 1);
  *idx = i;
  return i >= 0 && valid[i];
}

template <int VW> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T ld(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(T& a, const T& v) {
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  static __device__ __forceinline__ void st_div(float* p, const T& a,
                                                float c) {
    *reinterpret_cast<float4*>(p) =
        make_float4(a.x / c, a.y / c, a.z / c, a.w / c);
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T ld(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(T& a, const T& v) { a += v; }
  static __device__ __forceinline__ void st_div(float* p, const T& a,
                                                float c) {
    *p = a / c;
  }
};

// Kernel E.  Warp w owns dst rows rt + i RT (rt = w / slices, i < rows)
// and columns [c0, c0 + slice) (c0 = (w % slices) * slice); a lane takes
// vectors lane + 32 q, q < Q, of each pass of 32 Q VW columns.
template <int VW, int Q>
__global__ void __launch_bounds__(WARPS * 32)
sage_agg_fwd_kernel(const float* __restrict__ h,
                    const int32_t* __restrict__ nbr,
                    const bool* __restrict__ valid, float* __restrict__ mean,
                    float* __restrict__ cnt, int N, int M, int f, int D,
                    int rows, int slice, int slices) {
  using V = Vec<VW>;
  constexpr int E = IN_FLIGHT / Q;              // list entries in flight
  __shared__ int2 lists[WARPS][32];
  const int w = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int RT = (M + rows - 1) / rows;         // row sets
  const int rt = w / slices;
  if (rt >= RT) return;                         // uniform across the warp
  // the warp's rows: rt + i RT, i < nrows
  const int nrows = (M - 1 - rt) / RT + 1;
  const int c0 = (w - rt * slices) * slice;
  const int c1 = min(D, c0 + slice);
  const bool count_out = c0 == 0 && lane == 0;
  int2* list = lists[threadIdx.x / 32];
  const int n_slots = nrows * f;
  // one pass at least, so that the counts are written where D == 0
  for (int p0 = c0; p0 == c0 || p0 < c1; p0 += 32 * Q * VW) {
    bool on[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) on[q] = p0 + (lane + 32 * q) * VW < c1;
    typename V::T acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = V::zero();
    float c = 0.f;
    int r = 0;                                  // the row being summed
    // the row r is complete: store its mean (and count)
    auto flush = [&]() {
      const float denom = fmaxf(c, 1.f);
      float* out = mean + (size_t)(rt + r * RT) * D + p0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (on[q]) V::st_div(out + (lane + 32 * q) * VW, acc[q], denom);
        acc[q] = V::zero();
      }
      if (count_out && p0 == c0) cnt[rt + r * RT] = c;
      c = 0.f;
      ++r;
    };
    for (int j0 = 0; j0 < n_slots; j0 += 32) {
      const int j = j0 + lane;
      const int i = j / f;                      // the slot's row, j - i f
      const int src = j < n_slots
          ? min(nbr[(size_t)(rt + i * RT) * f + (j - i * f)], N - 1) : -1;
      const bool in = src >= 0 && valid[src];
      const unsigned b = __ballot_sync(FULL, in);
      if (in) list[__popc(b & ((1u << lane) - 1u))] = make_int2(i, src);
      __syncwarp();
      const int n = __popc(b);
      for (int n0 = 0; n0 < n; n0 += E) {
        typename V::T v[E][Q];
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (n0 + k < n) {
            const float* row = h + (size_t)list[n0 + k].y * D + p0;
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (on[q]) v[k][q] = V::ld(row + (lane + 32 * q) * VW);
          }
        }
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (n0 + k < n) {
            const int rk = list[n0 + k].x;
            while (r < rk) flush();
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (on[q]) V::add(acc[q], v[k][q]);
            c += 1.f;
          }
        }
      }
      __syncwarp();
    }
    while (r < nrows) flush();
  }
}

template <int VW>
void launch_fwd(const float* h, const int32_t* nbr, const bool* valid,
                float* mean, float* cnt, int N, int M, int f, int D,
                int rows, int slice, cudaStream_t stream) {
  const int slices = D > slice ? (D + slice - 1) / slice : 1;
  const long long warps = (long long)((M + rows - 1) / rows) * slices;
  const int blocks = (int)((warps + WARPS - 1) / WARPS);
  if (slice > 32 * VW) {
    sage_agg_fwd_kernel<VW, 2><<<blocks, WARPS * 32, 0, stream>>>(
        h, nbr, valid, mean, cnt, N, M, f, D, rows, slice, slices);
  } else {
    sage_agg_fwd_kernel<VW, 1><<<blocks, WARPS * 32, 0, stream>>>(
        h, nbr, valid, mean, cnt, N, M, f, D, rows, slice, slices);
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

// Kernel E.  `rows` dst rows and `slice` columns (a positive multiple of
// 128) per warp (sage_agg.agg_form).
extern "C" int sage_agg_fwd(const void* h, const void* nbr, const void* valid,
                            void* mean, void* cnt, int N, int M, int f, int D,
                            int rows, int slice, void* stream) {
  if (rows < 1 || slice < 128 || slice % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = (D % 4 == 0) && ((uintptr_t)h % 16 == 0)
                   && ((uintptr_t)mean % 16 == 0);
  if (vec) {
    launch_fwd<4>((const float*)h, (const int32_t*)nbr, (const bool*)valid,
                  (float*)mean, (float*)cnt, N, M, f, D, rows, slice,
                  (cudaStream_t)stream);
  } else {
    launch_fwd<1>((const float*)h, (const int32_t*)nbr, (const bool*)valid,
                  (float*)mean, (float*)cnt, N, M, f, D, rows, slice,
                  (cudaStream_t)stream);
  }
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
