// GAT AGG for Hopper (sm_90a), float32: the edge softmax and the
// alpha-weighted sum of neighbor rows (kernel G), and its gradient with
// respect to z, e_u and e_v (kernel H).
//
//   s[m,j,h]   = e_u[i_j, h] + e_v[d, h],  i_j = min(nbr[m,j], N-1),
//                d = m, or clamp(dst[m], 0, Nev-1) when dst is given
//   slot j of row m is included when nbr[m,j] >= 0 and valid[i_j]
//   l          = s >= 0 ? s : 0.2 s                              (LeakyReLU)
//   alpha      = exp(l - max_j l) / max(sum_j exp(l - max_j l), 1e-20)
//                over the included slots, 0 elsewhere
//   out[m,h,:] = sum_j alpha[m,j,h] z[i_j,h,:]                       (kernel G)
//
//   da[m,j,h]  = <g[m,h,:], z[i_j,h,:]>
//   dl         = alpha (da - sum_j alpha da),  ds = s >= 0 ? dl : 0.2 dl
//   dz[i_j]   += alpha g[m],  de_u[i_j,h] += ds,  de_v[d,h] += sum_j ds
//                                                                  (kernel H)
//
// A row whose every slot is excluded gives zeros and no gradient.  The
// index clamp is jnp's gather clamp (as kernel E's); as in the gradient
// of that gather, a slot whose index is past N scatters nothing into dz
// and de_u (its ds still counts in de_v).
//
// Replaces the TPU kernel repro/kernels/gat_edge.py:gat_edge (reached
// through repro/kernels/ops.py:gat_edge_aggregate, which gathers the
// neighbor tensors with XLA first).  Kernel H is its gradient, which the
// reference takes by XLA's autodiff of the jnp path (the Pallas kernel
// cannot be differentiated).
//
// Bound on the H100 (3.35 TB/s): bytes.  G reads each included neighbor's
// z row once (M*f*H*dh*4 bytes at most: 3.6 GB at layer 0 of the paper's
// GAT, 176,000 x 5 x 1,024) and writes M*H*dh floats; it does two flops
// per element read.  H reads the same rows and g, and scatters as many
// floats into dz as G reads.
//
// Design of G.  The bound is the gather of z rows, so the design keeps
// many of them in flight and reads everything else once:
//  - work unit = (dst row, column part); one warp per unit, 8 per block.
//    A row's H*dh columns are cut into parts of `cw` vector columns (a
//    multiple of 32, one per lane per pass); the wrapper picks cw from M
//    and H*dh so that M * parts warps fill the card (64 per SM, its most
//    resident warps): one part per row ("row") at training shapes, down
//    to 32 vector columns ("split") at serving shapes of 64-2,048 rows,
//    where one warp per row would leave most SMs idle.  Every part
//    computes its row's softmax itself (it costs f*H e_u reads against
//    f*cw*16 bytes of z);
//  - the softmax in one pass over e_u: the lanes take the (slot, head)
//    pairs, each reading its e_u[i_j, h] once, all reads independent, and
//    write the logit into the warp's shared memory; the per-head max and
//    floored sum then come from shared memory (lanes stride the slots, a
//    butterfly each), and alpha replaces the logit in place;
//  - the gather walks the included slots in order (a ballot compacts
//    them; at training layer 0 most slots are halos the HEC missed),
//    eight at a time (then 4, 2, 1): their neighbours' float4 (or float)
//    loads are issued before the FMAs; alpha and the clamped source come
//    from shared memory (broadcasts).
// The float4 form needs dh % 4 == 0 and 16-byte aligned z and out; the
// scalar form takes the rest.  Rows whose f*H pairs do not fit the warp's
// shared memory (fanouts in the hundreds) take the first version's
// chunked kernel ("chunked", the same arithmetic): the softmax's max and
// sum per head over all slots, then alpha chunk by chunk of FC slots.
//
// Design of H (first version, right before fast), as kernel E's: one
// warp per dst row, up to 8 rows per block, nothing carried between
// blocks.  The reference pre-gathers z[nbr] ([M, f, H*dh], 3.6 GB per
// rank at layer 0); here each warp gathers its row's neighbors itself,
// so no such tensor exists.  The fanout f is not bounded, so nothing is
// sized by f: the warp first takes the max and the sum of the softmax per
// head over all slots (lanes stride the slots, then a butterfly), then
// walks the fanout in chunks of FC slots, computing the chunk's
// alpha[FC][H] and clamped indices into its shared memory.  H stores da
// for every slot (scratch [M, f, H] from the caller) in a first pass,
// since the softmax's gradient needs sum_j alpha da before any ds; its
// scatters are float atomics (float4 ones on sm_90), so dz, de_u and
// (with dst) de_v are summed in a run-dependent order and held to a
// tolerance.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FC = 32;            // fanout slots per chunk
constexpr int MAX_WARPS = 8;      // dst rows per block
constexpr int SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float leaky(float s) {
  return s >= 0.f ? s : 0.2f * s;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The clamped source of slot j, or -1 when the slot is excluded.
__device__ __forceinline__ int slot_src(const int32_t* row, int j, int N,
                                        const bool* valid) {
  const int i = min(row[j], N - 1);
  return (i >= 0 && valid[i]) ? i : -1;
}

// Per-warp shared memory: ev[H], mx[H], den[H], then `extra` more [H]
// arrays, alpha[FC * H], and the chunk's sources idx[FC].
struct WarpSmem {
  float* ev;
  float* mx;
  float* den;
  float* extra;
  float* alpha;
  int* idx;
};

__host__ __device__ __forceinline__ int warp_smem_floats(int H, int extra) {
  return (3 + extra) * H + FC * H + FC;
}

__device__ __forceinline__ WarpSmem warp_smem(float* smem, int w, int H,
                                              int extra) {
  float* base = smem + (size_t)w * warp_smem_floats(H, extra);
  WarpSmem s;
  s.ev = base;
  s.mx = base + H;
  s.den = base + 2 * H;
  s.extra = base + 3 * H;
  s.alpha = base + (3 + extra) * H;
  s.idx = reinterpret_cast<int*>(s.alpha + FC * H);
  return s;
}

// e_v of the row into smem, then the softmax's max and floored sum per
// head over all included slots.
__device__ void softmax_stats(const WarpSmem& sm, const int32_t* row, int f,
                              int N, const bool* valid, const float* eu,
                              const float* ev, int d, int H, int lane) {
  for (int h = lane; h < H; h += 32) sm.ev[h] = ev[(size_t)d * H + h];
  __syncwarp();
  for (int h = 0; h < H; ++h) {
    const float evh = sm.ev[h];
    float m = -INFINITY;
    for (int j = lane; j < f; j += 32) {
      const int i = slot_src(row, j, N, valid);
      if (i >= 0) m = fmaxf(m, leaky(eu[(size_t)i * H + h] + evh));
    }
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < f; j += 32) {
      const int i = slot_src(row, j, N, valid);
      if (i >= 0) s += expf(leaky(eu[(size_t)i * H + h] + evh) - m);
    }
    s = warp_sum(s);
    if (lane == 0) {
      sm.mx[h] = m;
      sm.den[h] = fmaxf(s, 1e-20f);
    }
  }
  __syncwarp();
}

// alpha[j][h] and idx[j] of the chunk's nc slots from c0.
__device__ __forceinline__ void fill_chunk(const WarpSmem& sm,
                                           const int32_t* row, int c0, int nc,
                                           int N, const bool* valid,
                                           const float* eu, int H, int lane) {
  for (int p = lane; p < nc * H; p += 32) {
    const int j = p / H, h = p - j * H;
    const int i = slot_src(row, c0 + j, N, valid);
    sm.alpha[p] = i >= 0
        ? expf(leaky(eu[(size_t)i * H + h] + sm.ev[h]) - sm.mx[h]) / sm.den[h]
        : 0.f;
    if (h == 0) sm.idx[j] = i;
  }
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int W = 1;
  __device__ static float zero() { return 0.f; }
  __device__ static void fma(float& acc, float a, float v) { acc += a * v; }
  __device__ static float scale(float a, float v) { return a * v; }
  __device__ static float dot(float a, float b) { return a * b; }
  __device__ static void atomic_add(float* p, float v) { atomicAdd(p, v); }
};
template <>
struct Vec<float4> {
  static constexpr int W = 4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void fma(float4& acc, float a, float4 v) {
    acc.x += a * v.x;
    acc.y += a * v.y;
    acc.z += a * v.z;
    acc.w += a * v.w;
  }
  __device__ static float4 scale(float a, float4 v) {
    return make_float4(a * v.x, a * v.y, a * v.z, a * v.w);
  }
  __device__ static float dot(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  __device__ static void atomic_add(float4* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(p, v);
#else
    float* q = reinterpret_cast<float*>(p);
    atomicAdd(q, v.x);
    atomicAdd(q + 1, v.y);
    atomicAdd(q + 2, v.z);
    atomicAdd(q + 3, v.w);
#endif
  }
};

// Kernel G's one-pass form.  Per warp, shared memory holds lg[f*H] (the
// logits, then alpha), idx[f] (clamped sources, -1 when excluded), the
// included slots in order cs[f], mx[H] and den[H]: fast_smem_floats(f, H)
// floats.
__host__ __device__ __forceinline__ int fast_smem_floats(int f, int H) {
  return ((f * H + 2 * f + 2 * H) + 3) / 4 * 4;
}

// acc += the U included slots cs[n..n+U) of column q: the U neighbours'
// loads are all issued before the first FMA.
template <int U, typename T>
__device__ __forceinline__ void gather_slots(T& acc, const T* __restrict__ z,
                                             const float* lg, const int* idx,
                                             const int* cs, int n, int H,
                                             int h, int HDV, int q, bool on) {
  T v[U];
  float a[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = cs[n + u];
    a[u] = lg[j * H + h];
    v[u] = on ? z[(size_t)idx[j] * HDV + q] : Vec<T>::zero();
  }
#pragma unroll
  for (int u = 0; u < U; ++u) Vec<T>::fma(acc, a[u], v[u]);
}

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gat_fwd_kernel(const T* __restrict__ z, const float* __restrict__ eu,
               const float* __restrict__ ev, const int32_t* __restrict__ nbr,
               const bool* __restrict__ valid, const int32_t* __restrict__ dst,
               T* __restrict__ out, int N, int Nev, int M, int f, int H,
               int dh, int cw, int parts) {
  extern __shared__ float smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long unit = (long long)blockIdx.x * MAX_WARPS + w;
  if (unit >= (long long)M * parts) return;      // uniform across the warp
  const int m = (int)(unit / parts);
  const int part = (int)(unit - (long long)m * parts);
  float* lg = smem + (size_t)w * fast_smem_floats(f, H);
  int* idx = reinterpret_cast<int*>(lg + f * H);
  int* cs = idx + f;
  float* mx = lg + f * H + 2 * f;
  float* den = mx + H;
  const int d = dst ? min(max(dst[m], 0), Nev - 1) : m;
  const int32_t* row = nbr + (size_t)m * f;
  const float* evrow = ev + (size_t)d * H;

  // the logits: one e_u read per (slot, head) pair, all independent (the
  // loop unrolled, so that several pairs' reads are in flight at once)
#pragma unroll 4
  for (int p = lane; p < f * H; p += 32) {
    const int j = p / H, h = p - j * H;
    const int i = slot_src(row, j, N, valid);
    lg[p] = i >= 0 ? leaky(eu[(size_t)i * H + h] + evrow[h]) : -INFINITY;
    if (h == 0) idx[j] = i;
  }
  __syncwarp();
  for (int h = 0; h < H; ++h) {
    float mh = -INFINITY;
    for (int j = lane; j < f; j += 32) mh = fmaxf(mh, lg[j * H + h]);
    mh = warp_max(mh);
    float sh = 0.f;
    for (int j = lane; j < f; j += 32) {
      const float l = lg[j * H + h];
      if (l != -INFINITY) sh += expf(l - mh);
    }
    sh = warp_sum(sh);
    if (lane == 0) {
      mx[h] = mh;
      den[h] = fmaxf(sh, 1e-20f);
    }
  }
  __syncwarp();
  for (int p = lane; p < f * H; p += 32) {
    const int h = p % H;
    const float l = lg[p];
    lg[p] = l != -INFINITY ? expf(l - mx[h]) / den[h] : 0.f;
  }
  // the included slots, in order: the gather skips the rest (at training
  // layer 0 most slots are halos the HEC missed)
  int nv = 0;
  for (int j0 = 0; j0 < f; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < f && idx[j] >= 0;
    const unsigned b = __ballot_sync(0xffffffffu, in);
    if (in) cs[nv + __popc(b & ((1u << lane) - 1u))] = j;
    nv += __popc(b);
  }
  __syncwarp();

  // the gather: columns [part * cw, part * cw + cw) of the row
  const int dhv = dh / Vec<T>::W, HDV = H * dhv;
  const int q1 = min(part * cw + cw, HDV);
  for (int qb = part * cw; qb < q1; qb += 32) {
    const int q = qb + lane;
    const bool on = q < q1;
    const int h = on ? q / dhv : 0;
    T acc = Vec<T>::zero();
    int n = 0;
    for (; n + 8 <= nv; n += 8)
      gather_slots<8>(acc, z, lg, idx, cs, n, H, h, HDV, q, on);
    if (n + 4 <= nv) {
      gather_slots<4>(acc, z, lg, idx, cs, n, H, h, HDV, q, on);
      n += 4;
    }
    if (n + 2 <= nv) {
      gather_slots<2>(acc, z, lg, idx, cs, n, H, h, HDV, q, on);
      n += 2;
    }
    if (n < nv) gather_slots<1>(acc, z, lg, idx, cs, n, H, h, HDV, q, on);
    if (on) out[(size_t)m * HDV + q] = acc;
  }
}

// Kernel G's chunked form, for rows whose pairs do not fit the one-pass
// form's shared memory.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gat_fwd_chunked_kernel(const T* __restrict__ z, const float* __restrict__ eu,
                       const float* __restrict__ ev,
                       const int32_t* __restrict__ nbr,
                       const bool* __restrict__ valid,
                       const int32_t* __restrict__ dst, T* __restrict__ out,
                       int N, int Nev, int M, int f, int H, int dh,
                       int warps) {
  extern __shared__ float smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * warps + w;
  if (m >= M) return;             // uniform across the warp
  const WarpSmem sm = warp_smem(smem, w, H, 0);
  const int d = dst ? min(max(dst[m], 0), Nev - 1) : m;
  const int32_t* row = nbr + (size_t)m * f;
  softmax_stats(sm, row, f, N, valid, eu, ev, d, H, lane);
  const int dhv = dh / Vec<T>::W, HDV = H * dhv;
  for (int qb = 0; qb < HDV; qb += 32) {
    const int q = qb + lane;
    const int h = q < HDV ? q / dhv : 0;
    T acc = Vec<T>::zero();
    for (int c0 = 0; c0 < f; c0 += FC) {
      const int nc = min(FC, f - c0);
      if (qb == 0 || f > FC) {
        __syncwarp();
        fill_chunk(sm, row, c0, nc, N, valid, eu, H, lane);
        __syncwarp();
      }
      if (q < HDV) {
        for (int j = 0; j < nc; ++j) {
          const int i = sm.idx[j];
          if (i < 0) continue;
          Vec<T>::fma(acc, sm.alpha[j * H + h], z[(size_t)i * HDV + q]);
        }
      }
    }
    if (q < HDV) out[(size_t)m * HDV + q] = acc;
  }
}

// Kernel H.  extra arrays: tsum[H] (sum_j alpha da), dsum[H] (sum_j ds).
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gat_bwd_kernel(const T* __restrict__ g, const T* __restrict__ z,
               const float* __restrict__ eu, const float* __restrict__ ev,
               const int32_t* __restrict__ nbr, const bool* __restrict__ valid,
               const int32_t* __restrict__ dst, float* __restrict__ da,
               T* __restrict__ dz, float* __restrict__ deu,
               float* __restrict__ dev, int N, int Nev, int M, int f, int H,
               int dh, int warps) {
  extern __shared__ float smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * warps + w;
  if (m >= M) return;
  const WarpSmem sm = warp_smem(smem, w, H, 2);
  float* tsum = sm.extra;
  float* dsum = sm.extra + H;
  const int d = dst ? min(max(dst[m], 0), Nev - 1) : m;
  const int32_t* row = nbr + (size_t)m * f;
  for (int h = lane; h < H; h += 32) {
    tsum[h] = 0.f;
    dsum[h] = 0.f;
  }
  softmax_stats(sm, row, f, N, valid, eu, ev, d, H, lane);
  const int dhv = dh / Vec<T>::W, HDV = H * dhv;
  const T* grow = g + (size_t)m * HDV;
  float* darow = da + (size_t)m * f * H;
  // pass 1: da of every included slot, and sum_j alpha da per head
  for (int c0 = 0; c0 < f; c0 += FC) {
    const int nc = min(FC, f - c0);
    __syncwarp();
    fill_chunk(sm, row, c0, nc, N, valid, eu, H, lane);
    __syncwarp();
    for (int j = 0; j < nc; ++j) {
      const int i = sm.idx[j];
      if (i < 0) continue;        // uniform: read from shared memory
      const T* zrow = z + (size_t)i * HDV;
      for (int h = 0; h < H; ++h) {
        float part = 0.f;
        for (int q = h * dhv + lane; q < (h + 1) * dhv; q += 32)
          part += Vec<T>::dot(grow[q], zrow[q]);
        part = warp_sum(part);
        if (lane == 0) {
          darow[(size_t)(c0 + j) * H + h] = part;
          tsum[h] += sm.alpha[j * H + h] * part;
        }
      }
    }
  }
  // pass 2: ds into de_u and the row's de_v sum, alpha g into dz
  for (int c0 = 0; c0 < f; c0 += FC) {
    const int nc = min(FC, f - c0);
    __syncwarp();
    fill_chunk(sm, row, c0, nc, N, valid, eu, H, lane);
    __syncwarp();
    for (int p = lane; p < nc * H; p += 32) {
      const int j = p / H, h = p - j * H;
      const int i = sm.idx[j];
      if (i < 0) continue;
      const float s = eu[(size_t)i * H + h] + sm.ev[h];
      const float dl = sm.alpha[p] * (darow[(size_t)(c0 + j) * H + h] - tsum[h]);
      const float ds = s >= 0.f ? dl : 0.2f * dl;
      if (row[c0 + j] < N) atomicAdd(deu + (size_t)i * H + h, ds);
      atomicAdd(dsum + h, ds);
    }
    for (int j = 0; j < nc; ++j) {
      const int i = sm.idx[j];
      if (i < 0 || row[c0 + j] >= N) continue;    // uniform across the warp
      T* dzrow = dz + (size_t)i * HDV;
      for (int q = lane; q < HDV; q += 32)
        Vec<T>::atomic_add(dzrow + q,
                           Vec<T>::scale(sm.alpha[j * H + q / dhv], grow[q]));
    }
  }
  __syncwarp();
  for (int h = lane; h < H; h += 32) {
    if (dst) atomicAdd(dev + (size_t)d * H + h, dsum[h]);
    else dev[(size_t)m * H + h] = dsum[h];
  }
}

// Rows per block so that their shared memory fits in 48 KB; 0 if one
// row's does not.
int rows_per_block(int H, int extra) {
  const int per_warp = warp_smem_floats(H, extra) * (int)sizeof(float);
  int warps = MAX_WARPS;
  while (warps > 0 && warps * per_warp > SMEM_LIMIT) warps /= 2;
  return warps;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue when a block's shared memory (which grows with H,
// and with f in G's one-pass form) exceeds 48 KB or the operands do not
// suit the form asked for.  `dst` may be null.

// Kernel G.  out [M, H*dh].  `cw` is the column part in vector columns
// (float4 where `vec`, else float; a multiple of 32), or 0 for the
// chunked form; `vec` must be 0 unless dh % 4 == 0 and z and out are
// 16-byte aligned.
extern "C" int gat_edge_fwd(const void* z, const void* eu, const void* ev,
                            const void* nbr, const void* valid,
                            const void* dst, void* out, int N, int Nev, int M,
                            int f, int H, int dh, int cw, int vec,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec && (dh % 4 != 0 || !aligned16(z) || !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  if (cw > 0) {
    const size_t smem = (size_t)MAX_WARPS * fast_smem_floats(f, H)
                        * sizeof(float);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const int hdv = H * (vec ? dh / 4 : dh);
    const int parts = (hdv + cw - 1) / cw;
    const long long units = (long long)M * parts;
    const int blocks = (int)((units + MAX_WARPS - 1) / MAX_WARPS);
    if (vec) {
      gat_fwd_kernel<float4><<<blocks, MAX_WARPS * 32, smem, s>>>(
          (const float4*)z, (const float*)eu, (const float*)ev,
          (const int32_t*)nbr, (const bool*)valid, (const int32_t*)dst,
          (float4*)out, N, Nev, M, f, H, dh, cw, parts);
    } else {
      gat_fwd_kernel<float><<<blocks, MAX_WARPS * 32, smem, s>>>(
          (const float*)z, (const float*)eu, (const float*)ev,
          (const int32_t*)nbr, (const bool*)valid, (const int32_t*)dst,
          (float*)out, N, Nev, M, f, H, dh, cw, parts);
    }
    return (int)cudaGetLastError();
  }
  const int warps = rows_per_block(H, 0);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (M + warps - 1) / warps;
  const size_t smem = (size_t)warps * warp_smem_floats(H, 0) * sizeof(float);
  if (vec) {
    gat_fwd_chunked_kernel<float4><<<blocks, warps * 32, smem, s>>>(
        (const float4*)z, (const float*)eu, (const float*)ev,
        (const int32_t*)nbr, (const bool*)valid, (const int32_t*)dst,
        (float4*)out, N, Nev, M, f, H, dh, warps);
  } else {
    gat_fwd_chunked_kernel<float><<<blocks, warps * 32, smem, s>>>(
        (const float*)z, (const float*)eu, (const float*)ev,
        (const int32_t*)nbr, (const bool*)valid, (const int32_t*)dst,
        (float*)out, N, Nev, M, f, H, dh, warps);
  }
  return (int)cudaGetLastError();
}

// Kernel H.  `da` [M, f, H] is scratch; `dz` [N, H*dh], `deu` [N, H] and
// `dev` [Nev, H] must be zero (the caller allocates them zeroed).
extern "C" int gat_edge_bwd(const void* g, const void* z, const void* eu,
                            const void* ev, const void* nbr, const void* valid,
                            const void* dst, void* da, void* dz, void* deu,
                            void* dev, int N, int Nev, int M, int f, int H,
                            int dh, void* stream) {
  const int warps = rows_per_block(H, 2);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (M + warps - 1) / warps;
  const size_t smem = (size_t)warps * warp_smem_floats(H, 2) * sizeof(float);
  const bool vec = dh % 4 == 0 && aligned16(g) && aligned16(z)
                   && aligned16(dz);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    gat_bwd_kernel<float4><<<blocks, warps * 32, smem, s>>>(
        (const float4*)g, (const float4*)z, (const float*)eu,
        (const float*)ev, (const int32_t*)nbr, (const bool*)valid,
        (const int32_t*)dst, (float*)da, (float4*)dz, (float*)deu,
        (float*)dev, N, Nev, M, f, H, dh, warps);
  } else {
    gat_bwd_kernel<float><<<blocks, warps * 32, smem, s>>>(
        (const float*)g, (const float*)z, (const float*)eu, (const float*)ev,
        (const int32_t*)nbr, (const bool*)valid, (const int32_t*)dst,
        (float*)da, (float*)dz, (float*)deu, (float*)dev, N, Nev, M, f, H, dh,
        warps);
  }
  return (int)cudaGetLastError();
}
