// Fused GraphSAGE serve layer for Hopper (sm_90a), float32 in and out.
//
//   out[m] = act( mean_{j : nbr[m,j] >= 0 && valid[nbr[m,j]]} h[nbr[m,j]] @ Wn
//                 + h[self_row(m)] @ Ws + b )
//
// self_row(m) = m (the serve blocks' dst-prefix invariant) or, when
// self_idx is given, clamp(self_idx[m], 0, N-1) (offline chunks).  A
// neighbor index past N-1 reads row N-1, as jnp's gather clamps.  NaN
// flows as in the plain version: an excluded slot adds its (clamped) row
// times 0 (NaN where that row is not finite; a pad reads row 0, a run of
// pads once), and act (ReLU) keeps a NaN.  An infinite (or near FLT_MAX)
// input gives the float32 product's +-inf: an output the 3xTF32 products
// leave NaN is recomputed by FFMA from the gathered tiles
// (tf32x3.cuh: plain_out), which finite inputs never reach.
//
// Replaces the TPU kernel repro/kernels/serve_fused.py:fused_serve_layer
// (one pallas_call per serve layer).
//
// Bound on the H100 (3.35 TB/s; 495 TFLOP/s TF32 on the tensor cores, 67
// TFLOP/s float32 outside them): the gather reads each included h row
// once (at most M*f*D*4 bytes, 28.8 MB at layer 0 of the
// graphsage-papers100m serve step, M=11264, f=5, D=128: 8.6 us); the two
// products are 4*M*D*K operations, done here as three TF32 products each
// (12*M*D*K, 4.4 GFLOP there: 9 us), where float32 FFMA would need 22 us.
// So the serve layer is bound by bytes and tensor-core operations about
// equally at layer 0, by bytes at the output layer (M=64) and on the
// offline chunks (f=77).  chip_smoke.py computes each bound from the data
// it runs.
//
// Design.  A block of 8 warps owns a tile of BM dst rows (64, 32 or 16)
// and either all of the output's 64-column tiles (large M: each row is
// gathered once per launch) or one of them (small M: the grid then covers
// the SMs, and the few rows are gathered once per column tile).  The
// wrapper picks the form from M, K, D and the SM count
// (serve_fused.serve_tile).  Blocks walk the columns fastest, so the
// column tiles of one row tile run together and share its rows in L2.
//  1. Gather, by warps: a warp takes 4 of its rows at a time.  For each
//     32-slot chunk of the fanout, lane j loads slot j's index and valid
//     flag of the 4 rows (all loads independent; a -1 pad loads no flag),
//     and a ballot per row compacts the included slots, in slot order,
//     into the warp's list; the 4 self rows follow.  The warp then walks
//     the list 8 loads at a time (float4 along D, or float where D % 4 !=
//     0 or h is not 16-byte aligned; 8 rows, or 4 rows of two column
//     groups where a row is more than 32 loads wide), all in flight
//     before the adds, and adds each
//     into the row's sum in a shared [BM, D] tile (a self row is stored
//     into a second tile).  The sum of a row is taken in slot order
//     and divided by its count, as the plain version does.  Both tiles
//     are zero past D and past M, and padded to rows of DK + 4 floats (DK
//     = D rounded up to 32) so that the fragment reads below are free of
//     bank conflicts.
//  2. Products on the tensor cores, 3xTF32 (tf32x3.cuh, as kernel C):
//     the A operand is read from the gathered tiles; [32, 64] tiles of Wn
//     and then Ws stream through a cp.async double buffer (the first one
//     is issued before the gather), 16-byte copies where K % 4 == 0 and
//     the weights are aligned.  The first product's sums wait in shared
//     memory while the second runs in the same registers; the epilogue
//     adds them in the reference's order (accn + accs + b), then ReLU, and
//     stores two floats at a time where K is even.
// Columns past K (K=172 at the output layer) and rows past M are masked.
// What paces it on the H100: at serve layer 0 the products, whose
// instruction stream (the 3xTF32 splits beside the mma) paces them as it
// paces kernel C; on the offline chunks (77 slots) the gather's chain of
// dependent loads (index, valid flag, rows).  More loads in flight (16)
// or a deeper weight ring (3, 4 stages) was tried: the first spilled
// registers under the two-blocks-per-SM bound and was slower, the second
// gained 1% or lost.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BN = 64;            // output columns per column tile
constexpr int BK = 32;            // depth of one staged weight tile
constexpr int B_LD = BN + 8;      // padded row of a staged weight tile
constexpr int RG = 4;             // rows a warp indexes at once
constexpr int LIST = RG * 32 + RG;  // a warp's gather list: slots, self rows
constexpr int IN_FLIGHT = 8;      // loads of h a lane has in flight
constexpr int SELF = 1 << 30;     // list flag: the entry is a self row
constexpr int ZERO = 1 << 29;     // list flag: an excluded slot, added x 0

constexpr int STAGES = 2;         // cp.async ring depth (double buffer)

template <int VW> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T ld(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void st(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void add(float* p, T v) {
    float4 a = *reinterpret_cast<float4*>(p);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
    *reinterpret_cast<float4*>(p) = a;
  }
  // += 0 * v: nothing for a finite v, NaN for a non-finite one
  static __device__ __forceinline__ void add_zero(float* p, T v) {
    float4 a = *reinterpret_cast<float4*>(p);
    a.x = __fadd_rn(a.x, __fmul_rn(0.f, v.x));
    a.y = __fadd_rn(a.y, __fmul_rn(0.f, v.y));
    a.z = __fadd_rn(a.z, __fmul_rn(0.f, v.z));
    a.w = __fadd_rn(a.w, __fmul_rn(0.f, v.w));
    *reinterpret_cast<float4*>(p) = a;
  }
  static __device__ __forceinline__ void div(float* p, float c) {
    float4 a = *reinterpret_cast<float4*>(p);
    a.x = a.x / c;
    a.y = a.y / c;
    a.z = a.z / c;
    a.w = a.w / c;
    *reinterpret_cast<float4*>(p) = a;
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T ld(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void st(float* p, T v) { *p = v; }
  static __device__ __forceinline__ void add(float* p, T v) { *p += v; }
  static __device__ __forceinline__ void add_zero(float* p, T v) {
    *p = __fadd_rn(*p, __fmul_rn(0.f, v));
  }
  static __device__ __forceinline__ void div(float* p, float c) {
    *p = *p / c;
  }
};

__host__ __device__ __forceinline__ int padded_depth(int D) {
  return (D + BK - 1) / BK * BK;
}

// Shared memory of a block, in floats: the two gathered tiles, the weight
// ring, and one region that holds the warps' gather lists during the
// gather and the first product's stash during the products.
__host__ __device__ __forceinline__ size_t union_floats(int BM) {
  const size_t stash = (size_t)BM * BN;
  const size_t lists = WARPS * LIST * sizeof(int2) / sizeof(float);
  return stash > lists ? stash : lists;
}

__host__ __forceinline__ size_t smem_bytes(int BM, int D) {
  return (2 * (size_t)BM * (padded_depth(D) + 4)
          + (size_t)STAGES * BK * B_LD + union_floats(BM))
         * sizeof(float);
}

// Stage weight step s of the block's sequence: product s % T / KT (Wn,
// then Ws), rows [kt * BK, +BK) and columns [n0, n0 + BN) of it.
template <int VW>
__device__ __forceinline__ void load_w(float* Bs, const float* __restrict__ wn,
                                       const float* __restrict__ ws, int s,
                                       int KT, int ct0, int D, int K) {
  const int T = 2 * KT;
  const int u = s % T;
  const bool second = u >= KT;
  const float* B = second ? ws : wn;
  const int k0 = (second ? u - KT : u) * BK;
  const int n0 = (ct0 + s / T) * BN;
  constexpr int BC = BN / VW;                  // copies per row
  for (int e = threadIdx.x; e < BK * BC; e += THREADS) {
    const int r = e / BC, c = (e - r * BC) * VW;
    const int k = k0 + r, n = n0 + c;
    const bool p = k < D && n < K;
    cp_async<VW * 4>(Bs + r * B_LD + c, p ? B + (size_t)k * K + n : B, p);
  }
}

// Add (or, for a self row, store) the listed rows of h into the tiles:
// lane columns q0 and (if Q == 2) q0 + 32, E listed rows at a time, all
// E * Q loads issued before their adds.
template <int VW, int E, int Q>
__device__ __forceinline__ void gather_cols(const int2* list, int n,
                                            const float* __restrict__ h,
                                            float* agg_s, float* self_s,
                                            int a_ld, int r0, int D, int q0) {
  using V = Vec<VW>;
  const int DV = D / VW;
  bool on[Q];
#pragma unroll
  for (int c = 0; c < Q; ++c) on[c] = q0 + 32 * c < DV;
  for (int n0 = 0; n0 < n; n0 += E) {
    typename V::T v[E][Q];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (n0 + k < n) {
        const float* row = h + (size_t)list[n0 + k].y * D;
#pragma unroll
        for (int c = 0; c < Q; ++c)
          if (on[c]) v[k][c] = V::ld(row + (q0 + 32 * c) * VW);
      }
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (n0 + k < n) {
        const int code = list[n0 + k].x;
        const int row = (r0 + (code & (RG - 1))) * a_ld;
#pragma unroll
        for (int c = 0; c < Q; ++c) {
          if (!on[c]) continue;
          float* dst = (code & SELF ? self_s : agg_s) + row
                       + (q0 + 32 * c) * VW;
          if (code & SELF) {
            V::st(dst, v[k][c]);
          } else if (code & ZERO) {
            V::add_zero(dst, v[k][c]);
          } else {
            V::add(dst, v[k][c]);
          }
        }
      }
    }
  }
}

template <int VW>
__device__ __forceinline__ void gather_list(const int2* list, int n,
                                            const float* __restrict__ h,
                                            float* agg_s, float* self_s,
                                            int a_ld, int r0, int D,
                                            int lane) {
  if (D / VW <= 32) {
    gather_cols<VW, IN_FLIGHT, 1>(list, n, h, agg_s, self_s, a_ld, r0, D,
                                  lane);
  } else {
    for (int q0 = lane; q0 < D / VW; q0 += 64)
      gather_cols<VW, IN_FLIGHT / 2, 2>(list, n, h, agg_s, self_s, a_ld, r0,
                                        D, q0);
  }
}

// The outputs of a warp's [16 MT, 8 NT] fragment (tile rows from wm,
// columns from c0) that came out NaN, recomputed: the plain float32 value
// (tf32x3.cuh: plain_out) from the gathered tiles, then ReLU.  Not
// inlined: it runs only where an input is infinite.
template <int MT, int NT>
__device__ __noinline__ void fix_fragment(
    const float* agg_s, const float* self_s, int a_ld,
    const float* __restrict__ wn, const float* __restrict__ ws,
    const float* __restrict__ bias, float* out, int M, int D, int K, int m0,
    int wm, int c0, int lane, int relu) {
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < MT; ++i) {
    for (int half = 0; half < 2; ++half) {
      const int r = wm + 16 * i + g + 8 * half;
      const int m = m0 + r;
      if (m >= M) continue;
      for (int j = 0; j < NT; ++j) {
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * t + e;
          if (col >= K || !isnan(out[(size_t)m * K + col])) continue;
          float x = plain_out(agg_s + r * a_ld, self_s + r * a_ld, wn, ws,
                              bias, D, K, col);
          if (relu) x = isnan(x) ? x : fmaxf(x, 0.f);
          out[(size_t)m * K + col] = x;
        }
      }
    }
  }
}

template <int BM, int WARPS_M, int VW>
__global__ void __launch_bounds__(THREADS, 2)
serve_fused_layer_kernel(const float* __restrict__ h,
                         const int32_t* __restrict__ nbr,
                         const bool* __restrict__ valid,
                         const float* __restrict__ wn,
                         const float* __restrict__ ws,
                         const float* __restrict__ bias,
                         const int32_t* __restrict__ self_idx,
                         float* __restrict__ out, int N, int M, int f, int D,
                         int K, int relu, int col_tiles) {
  constexpr int WARPS_N = WARPS / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int RPW = BM / WARPS;               // rows per warp
  constexpr int RGN = RPW < RG ? RPW : RG;      // rows indexed at once
  static_assert(MT >= 1 && NT >= 1 && RPW >= 1, "tile too small");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int a_ld = padded_depth(D) + 4;
  float* agg_s = smem;                          // [BM][a_ld] neighbor means
  float* self_s = agg_s + BM * a_ld;            // [BM][a_ld] self rows
  float* wbuf = self_s + BM * a_ld;             // [STAGES][BK][B_LD]
  // the first product's sums wait here, [(i * NT + j) * 4 + e][thread],
  // while the second product runs in the same registers; the gather's
  // lists use the same room before
  float* stash = wbuf + STAGES * BK * B_LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int2* list = reinterpret_cast<int2*>(stash) + warp * LIST;

  const int KT64 = (K + BN - 1) / BN;
  const int col_blocks = (KT64 + col_tiles - 1) / col_tiles;
  const int rt = blockIdx.x / col_blocks;
  const int ct0 = (blockIdx.x - rt * col_blocks) * col_tiles;
  const int ct1 = min(ct0 + col_tiles, KT64);
  const int m0 = rt * BM;
  const int KT = (D + BK - 1) / BK;
  const int S = (ct1 - ct0) * 2 * KT;           // weight steps of the block

  // the first weight tiles fly while the rows are gathered
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < S) load_w<VW>(wbuf + s * BK * B_LD, wn, ws, s, KT, ct0, D, K);
    cp_async_commit();
  }

  // 1. gather
  for (int e = threadIdx.x; e < 2 * BM * a_ld / 4; e += THREADS)
    smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int r0 = warp * RPW; r0 < (warp + 1) * RPW; r0 += RGN) {
    float cnt[RGN];
    int self_row[RGN];
#pragma unroll
    for (int r = 0; r < RGN; ++r) {
      const int m = m0 + r0 + r;
      cnt[r] = 0.f;
      self_row[r] = m >= M ? -1
                    : self_idx ? min(max(self_idx[m], 0), N - 1) : m;
    }
    // one chunk at least: the self rows ride on the first
    for (int j0 = 0; j0 < max(f, 1); j0 += 32) {
      const int j = j0 + lane;
      int src[RGN];
      bool in[RGN];
#pragma unroll
      for (int r = 0; r < RGN; ++r) {
        const int m = m0 + r0 + r;
        src[r] = m < M && j < f ? min(nbr[(size_t)m * f + j], N - 1) : -1;
      }
#pragma unroll
      for (int r = 0; r < RGN; ++r) in[r] = src[r] >= 0 && valid[src[r]];
      int n = 0;
#pragma unroll
      for (int r = 0; r < RGN; ++r) {
        // excluded slots are listed too, their clamped row added times 0
        // (a non-finite value there makes the mean NaN, as the plain
        // version's h * 0 does); of a run of pads, which all read row 0,
        // only the first
        const int prev = __shfl_up_sync(0xffffffffu, src[r], 1);
        const bool listed = m0 + r0 + r < M && j < f
            && (src[r] >= 0 || j == 0 || lane == 0 || prev >= 0);
        const unsigned b = __ballot_sync(0xffffffffu, listed);
        if (listed)
          list[n + __popc(b & ((1u << lane) - 1u))] =
              in[r] ? make_int2(r, src[r]) : make_int2(r | ZERO,
                                                       max(src[r], 0));
        n += __popc(b);
        cnt[r] += (float)__popc(__ballot_sync(0xffffffffu, in[r]));
      }
      if (j0 == 0) {
#pragma unroll
        for (int r = 0; r < RGN; ++r) {
          if (self_row[r] >= 0) {
            if (lane == 0) list[n] = make_int2(r | SELF, self_row[r]);
            ++n;
          }
        }
      }
      __syncwarp();
      gather_list<VW>(list, n, h, agg_s, self_s, a_ld, r0, D, lane);
      __syncwarp();
    }
    // the mean: each lane divides the columns it summed
#pragma unroll
    for (int r = 0; r < RGN; ++r) {
      const float c = fmaxf(cnt[r], 1.f);
      for (int q = lane; q < D / VW; q += 32)
        Vec<VW>::div(agg_s + (r0 + r) * a_ld + q * VW, c);
    }
  }
  // 2. both products, column tile by column tile
  const int wm = (warp / WARPS_N) * WM, wn_ = (warp % WARPS_N) * WN;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  const int T = 2 * KT;
  for (int s = 0; s < S; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = s + STAGES - 1;
    if (nx < S)
      load_w<VW>(wbuf + (nx % STAGES) * BK * B_LD, wn, ws, nx, KT, ct0, D, K);
    cp_async_commit();
    const int u = s % T;
    const bool second = u >= KT;
    const float* As = (second ? self_s : agg_s) + (second ? u - KT : u) * BK;
    mma_step<MT, NT, BK>(As, a_ld, wbuf + (s % STAGES) * BK * B_LD, B_LD, acc,
                         wm, wn_, lane);
    if (u == KT - 1) {            // agg @ Wn done: stash it, start self @ Ws
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            stash[((i * NT + j) * 4 + e) * THREADS + threadIdx.x] =
                acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
        }
      }
    }
    if (u == T - 1) {             // epilogue of column tile ct0 + s / T
      const int n0 = (ct0 + s / T) * BN;
      const bool pairs = (K % 2) == 0;
      bool nan_seen = false;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wm + 16 * i + g + 8 * half;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = n0 + wn_ + 8 * j + 2 * t;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n + e;
              const float an =
                  stash[((i * NT + j) * 4 + 2 * half + e) * THREADS
                        + threadIdx.x];
              float x = 0.f;
              if (col < K) {
                x = an + acc[i][j][2 * half + e] + bias[col];
                nan_seen |= isnan(x);
                // torch.relu's clamp_min on the card: NaN stays NaN
                if (relu) x = isnan(x) ? x : fmaxf(x, 0.f);
              }
              v[e] = x;
            }
            if (m < M) {
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
      // an infinite input leaves the 3xTF32 sums NaN: those outputs
      // again, in float32 FFMA from the gathered tiles
      if (nan_seen)
        fix_fragment<MT, NT>(agg_s, self_s, a_ld, wn, ws, bias, out, M, D, K,
                             m0, wm, n0 + wn_, lane, relu);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int BM, int WARPS_M, int VW>
int launch(const float* h, const int32_t* nbr, const bool* valid,
           const float* wn, const float* ws, const float* bias,
           const int32_t* self_idx, float* out, int N, int M, int f, int D,
           int K, int relu, int col_tiles, cudaStream_t stream) {
  static bool attr_set = false;       // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        serve_fused_layer_kernel<BM, WARPS_M, VW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int KT64 = (K + BN - 1) / BN;
  const int col_blocks = (KT64 + col_tiles - 1) / col_tiles;
  const int grid = (M + BM - 1) / BM * col_blocks;
  serve_fused_layer_kernel<BM, WARPS_M, VW>
      <<<grid, THREADS, smem_bytes(BM, D), stream>>>(
          h, nbr, valid, wn, ws, bias, self_idx, out, N, M, f, D, K, relu,
          col_tiles);
  return (int)cudaGetLastError();
}

template <int VW>
int launch_form(int bm, const float* h, const int32_t* nbr, const bool* valid,
                const float* wn, const float* ws, const float* bias,
                const int32_t* self_idx, float* out, int N, int M, int f,
                int D, int K, int relu, int col_tiles, cudaStream_t stream) {
  switch (bm) {
    case 64:
      return launch<64, 2, VW>(h, nbr, valid, wn, ws, bias, self_idx, out, N,
                               M, f, D, K, relu, col_tiles, stream);
    case 32:
      return launch<32, 2, VW>(h, nbr, valid, wn, ws, bias, self_idx, out, N,
                               M, f, D, K, relu, col_tiles, stream);
    case 16:
      return launch<16, 1, VW>(h, nbr, valid, wn, ws, bias, self_idx, out, N,
                               M, f, D, K, relu, col_tiles, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  self_idx may be null.  `bm`
// (64, 32 or 16) and `col_tiles` (64-column tiles per block) are the form
// serve_fused.serve_tile picks.
extern "C" int serve_fused_layer(const void* h, const void* nbr,
                                 const void* valid, const void* wn,
                                 const void* ws, const void* bias,
                                 const void* self_idx, void* out, int N,
                                 int M, int f, int D, int K, int relu, int bm,
                                 int col_tiles, void* stream) {
  const bool vec = D % 4 == 0 && K % 4 == 0 && aligned16(h) && aligned16(wn)
                   && aligned16(ws);
  const float *h_ = (const float*)h, *wn_ = (const float*)wn,
              *ws_ = (const float*)ws, *b_ = (const float*)bias;
  const int32_t *nbr_ = (const int32_t*)nbr, *si = (const int32_t*)self_idx;
  const bool* v_ = (const bool*)valid;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch_form<4>(bm, h_, nbr_, v_, wn_, ws_, b_, si, (float*)out,
                              N, M, f, D, K, relu, col_tiles, st)
             : launch_form<1>(bm, h_, nbr_, v_, wn_, ws_, b_, si, (float*)out,
                              N, M, f, D, K, relu, col_tiles, st);
}

// Bytes of dynamic shared memory a block of `bm` rows takes at depth D
// (what the wrapper checks against the card's limit).
extern "C" int serve_fused_smem(int bm, int D) {
  return (int)smem_bytes(bm, D);
}
