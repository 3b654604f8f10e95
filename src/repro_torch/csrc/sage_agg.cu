// GraphSAGE AGG for Hopper (sm_90a), float32, forward and backward.
//
//   forward   mean[m] = sum_{j in J(m)} h[nbr[m,j]] / max(|J(m)|, 1),
//             cnt[m]  = |J(m)|,   J(m) = { j : nbr[m,j] >= 0 && valid[nbr[m,j]] }
//                                                                   (kernel E)
//   backward  dh[i] = sum_{(m,j) in T(i)} g[m] / max(cnt[m], 1),
//             T(i) = { (m,j) : nbr[m,j] == i < N && valid[i] }       (kernel F)
//
// The sums run in slot order from 0, as the Pallas kernel's grid does, and
// the mean is a true division.  In the forward an index past the last row
// is clamped to it, as jnp's gather clamps; the backward drops it, as the
// gather's gradient (a scatter) drops out-of-range indices.  An excluded
// slot of the forward still adds its (clamped) row times 0, as the plain
// version's h * mask does: nothing for a finite row, NaN for a non-finite
// one (a pad reads row 0; a run of pads is read once).  The backward
// leaves excluded slots out: there the plain version's 0 * g is NaN where
// g is, and kernel F's dh is not (only a step the NaN guard skips has a
// non-finite g).
//
// Replaces the TPU kernel repro/kernels/sage_agg.py:sage_agg (forward,
// whose (s, c) outputs are kernel E's sum and count); kernel F is its
// gradient with respect to h, which the reference takes by XLA's autodiff
// of gather_neighbors + masked_mean.
//
// Bound on the H100 (3.35 TB/s): bytes.  E reads each included neighbor
// row once (at most M*f*D*4 bytes, 0.45 GB at layer 0 of the paper's
// GraphSAGE: 176,000 x 5 x 128) and writes M*D floats; it adds one float
// per byte read.  F reads g, cnt and the transposed index and writes dh
// (N*D floats) and adds as many floats as E reads.
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
// Design of F: a gather by source row in a fixed order, not a scatter.
// The forward builds the transposed index T (kernels/slot_index.py: the
// kept slots of each source row in ascending m*f + j, an integer sort,
// slot_index.cuh); a warp owns one source row (all its columns, float4
// along D where D % 4 == 0 and the bases are 16-byte aligned) and walks
// its slots in order, lane j loading slot j's id and count of a 32-slot
// chunk, then 8 rows of g in flight before the adds, each a true
// division by max(cnt, 1) then an add into the running sum from 0.0.  So
// each dh[i] is the CPU plain version's index_add_ (which adds the same
// quotients in the same order) bit for bit, and the same on every run.
// A row of more than CHUNK (128) slots is cut into chunks of 128, each a
// warp's; the last chunk of the row to finish (a ticket) adds their
// partial sums in chunk order, so a hub stays the same from run to run
// but is not the plain version's one-by-one sum.  No float atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "slot_index.cuh"

namespace {

constexpr int WARPS = 8;          // warps per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int IN_FLIGHT = 8;      // row loads a lane has in flight

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
  // a += 0 * v: nothing for a finite v, NaN for a non-finite one
  static __device__ __forceinline__ void add_zero(T& a, const T& v) {
    a.x = __fadd_rn(a.x, __fmul_rn(0.f, v.x));
    a.y = __fadd_rn(a.y, __fmul_rn(0.f, v.y));
    a.z = __fadd_rn(a.z, __fmul_rn(0.f, v.z));
    a.w = __fadd_rn(a.w, __fmul_rn(0.f, v.w));
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
  static __device__ __forceinline__ void add_zero(T& a, const T& v) {
    a = __fadd_rn(a, __fmul_rn(0.f, v));
  }
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
      // excluded slots are listed as ~(their clamped row) and add 0 times
      // it (a non-finite value there makes the mean NaN, as the plain
      // version's h * 0 does); of a run of pads, which all read row 0,
      // only the first
      const int prev = __shfl_up_sync(FULL, src, 1);
      const bool listed = j < n_slots
          && (src >= 0 || j - i * f == 0 || lane == 0 || prev >= 0);
      const unsigned b = __ballot_sync(FULL, listed);
      if (listed)
        list[__popc(b & ((1u << lane) - 1u))] =
            make_int2(i, in ? src : ~max(src, 0));
      __syncwarp();
      const int n = __popc(b);
      for (int n0 = 0; n0 < n; n0 += E) {
        typename V::T v[E][Q];
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (n0 + k < n) {
            const int s = list[n0 + k].y;
            const float* row = h + (size_t)(s >= 0 ? s : ~s) * D + p0;
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
            if (list[n0 + k].y >= 0) {
#pragma unroll
              for (int q = 0; q < Q; ++q)
                if (on[q]) V::add(acc[q], v[k][q]);
              c += 1.f;
            } else {
#pragma unroll
              for (int q = 0; q < Q; ++q)
                if (on[q]) V::add_zero(acc[q], v[k][q]);
            }
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

template <int VW> struct Quot;
template <> struct Quot<4> {
  static __device__ __forceinline__ void add(float4& a, const float4& v,
                                             float c) {
    a.x += v.x / c;
    a.y += v.y / c;
    a.z += v.z / c;
    a.w += v.w / c;
  }
  static __device__ __forceinline__ float4 ld_cg(const float* p) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void st(float* p, const float4& a) {
    *reinterpret_cast<float4*>(p) = a;
  }
};
template <> struct Quot<1> {
  static __device__ __forceinline__ void add(float& a, float v, float c) {
    a += v / c;
  }
  static __device__ __forceinline__ float ld_cg(const float* p) {
    return __ldcg(p);
  }
  static __device__ __forceinline__ void st(float* p, float a) { *p = a; }
};

// Kernel F.  Warp w is unit w of the transposed index (slot_index.cuh):
// a source row of at most CHUNK slots, or one chunk of a longer row.
template <int VW, int Q>
__global__ void __launch_bounds__(WARPS * 32)
sage_agg_bwd_kernel(const float* __restrict__ g, const float* __restrict__ cnt,
                    const int32_t* __restrict__ off,
                    const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ lbase, float* part,
                    int* ticket, float* __restrict__ dh, int N, int f,
                    int D) {
  using V = Vec<VW>;
  using P = Quot<VW>;
  constexpr int E = IN_FLIGHT / Q;              // rows in flight
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  slot_index::Unit t;
  if (!slot_index::unit_of(w, off, lbase, N, &t)) return;
  const bool whole = t.nch == 1;
  float* out = whole ? dh + (size_t)t.row * D
                     : part + (size_t)(t.lb + t.chunk) * D;
  for (int p0 = 0; p0 < D; p0 += 32 * Q * VW) {
    bool on[Q];
    typename V::T acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      on[q] = p0 + (lane + 32 * q) * VW < D;
      acc[q] = V::zero();
    }
    for (int k0 = t.a; k0 < t.b; k0 += 32) {
      const int n = min(32, t.b - k0);
      int m_l = 0;
      float c_l = 1.f;
      if (lane < n) {
        m_l = slots[k0 + lane] / f;
        c_l = fmaxf(cnt[m_l], 1.f);
      }
      for (int e0 = 0; e0 < n; e0 += E) {
        typename V::T v[E][Q];
        float c[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int m = __shfl_sync(FULL, m_l, (e0 + e) & 31);
          c[e] = __shfl_sync(FULL, c_l, (e0 + e) & 31);
          if (e0 + e < n) {
            const float* row = g + (size_t)m * D + p0;
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (on[q]) v[e][q] = V::ld(row + (lane + 32 * q) * VW);
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e0 + e < n) {
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (on[q]) P::add(acc[q], v[e][q], c[e]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (on[q]) P::st(out + p0 + (lane + 32 * q) * VW, acc[q]);
  }
  if (whole || !slot_index::last_chunk(t, ticket, lane)) return;
  // the row's last chunk: its partials in chunk order, from 0.0
  float* dst = dh + (size_t)t.row * D;
  for (int p0 = 0; p0 < D; p0 += 32 * Q * VW) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int col = p0 + (lane + 32 * q) * VW;
      if (col >= D) continue;
      typename V::T acc = V::zero();
      for (int c = 0; c < t.nch; ++c)
        V::add(acc, P::ld_cg(part + (size_t)(t.lb + c) * D + col));
      P::st(dst + col, acc);
    }
  }
}

template <int VW>
void launch_bwd(const float* g, const float* cnt, const int32_t* off,
                const int32_t* slots, const int32_t* lbase, float* part,
                int* ticket, float* dh, int N, int f, int D, int lbound,
                cudaStream_t stream) {
  const long long units = (long long)N + lbound;
  const int blocks = (int)((units + WARPS - 1) / WARPS);
  if (D > 32 * VW) {
    sage_agg_bwd_kernel<VW, 2><<<blocks, WARPS * 32, 0, stream>>>(
        g, cnt, off, slots, lbase, part, ticket, dh, N, f, D);
  } else {
    sage_agg_bwd_kernel<VW, 1><<<blocks, WARPS * 32, 0, stream>>>(
        g, cnt, off, slots, lbase, part, ticket, dh, N, f, D);
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

// Kernel F.  `off` [N + 1], `slots` [M * f] and `lbase` [N + 1] are the
// transposed index (slot_index.cuh), `lbound` its bound on long chunks;
// `part` [lbound, D] is scratch and `ticket` [lbound] must be zero.  Every
// row of `dh` [N, D] is written.
extern "C" int sage_agg_bwd(const void* g, const void* cnt, const void* off,
                            const void* slots, const void* lbase, void* part,
                            void* ticket, void* dh, int N, int f, int D,
                            int lbound, void* stream) {
  if (N < 1 || D < 1 || f < 1 || lbound < 0) return (int)cudaErrorInvalidValue;
  const bool vec = (D % 4 == 0) && ((uintptr_t)g % 16 == 0)
                   && ((uintptr_t)dh % 16 == 0) && ((uintptr_t)part % 16 == 0);
  if (vec) {
    launch_bwd<4>((const float*)g, (const float*)cnt, (const int32_t*)off,
                  (const int32_t*)slots, (const int32_t*)lbase, (float*)part,
                  (int*)ticket, (float*)dh, N, f, D, lbound,
                  (cudaStream_t)stream);
  } else {
    launch_bwd<1>((const float*)g, (const float*)cnt, (const int32_t*)off,
                  (const int32_t*)slots, (const int32_t*)lbase, (float*)part,
                  (int*)ticket, (float*)dh, N, f, D, lbound,
                  (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
