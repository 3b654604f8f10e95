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
//   dz[i]      = sum_{(m,j) in T(i)} alpha[m,j,h] g[m,h,:],
//   de_u[i,h]  = sum_{(m,j) in T(i)} ds[m,j,h],
//   de_v[d,h]  = sum_{m : d(m) = d} sum_j ds[m,j,h]                (kernel H)
//   T(i)       = { (m,j) : nbr[m,j] == i < N && valid[i] }
//
// A row whose every slot is excluded gives zeros and no gradient.  NaN
// flows as in the plain version: the max and the floor of the sum keep a
// NaN, and G adds an excluded slot's (clamped) z row times its alpha of 0,
// NaN where that row is not finite (a pad reads row 0; a run of pads is
// read once).  H's sums leave the masked slots out; the reference's
// autodiff adds alpha * g there with alpha 0 (and nothing to de_u and the
// softmax, whose masking is a select), so H writes the NaN that 0 * g
// gives where g is not finite (below); a finite g changes no bit.  The
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
// per element read.  H reads the same rows, g, e_u, e_v and the
// transposed index, writes dz, de_u and de_v, and writes and reads its
// scratch (alpha and ds per slot and head) once.
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
// Design of H: two passes in a fixed order, no float atomics.  The
// forward builds the transposed index T of nbr (kernels/slot_index.py,
// slot_index.cuh: the kept slots of each source row in ascending m*f + j)
// and, when dst is given, of dst.
//  - H1, a warp per dst row (up to 8 rows a block; the reference
//    pre-gathers z[nbr], [M, f, H*dh], 3.6 GB per rank at layer 0, and
//    here each warp gathers its row's neighbours itself).  The fanout is
//    not bounded, so nothing is sized by f: the warp takes the softmax's
//    max and sum per head over all slots (lanes stride the slots, then a
//    butterfly), then walks the fanout in chunks of FC slots with the
//    chunk's alpha[FC][H] and clamped sources in its shared memory.  Pass
//    1 stores da of every included slot (scratch [M, f, H]) and sums
//    sum_j alpha da per head in slot order (lane 0); pass 2 overwrites da
//    with ds, stores alpha beside it and sums the row's ds per head in
//    slot order, one lane a head, into de_v[m] (or, with dst, the row's
//    scratch sum).
//  - H2, a warp per source row of T (or per chunk of CHUNK slots of a
//    hub row, the chunks' partials added in chunk order by the row's last
//    chunk): dz[i] = sum alpha g[m] over the row's slots in order from
//    0.0 (float4 along H*dh, 8 rows in flight, products rounded before
//    the add, as the plain version's), de_u[i] = sum ds in order; with
//    dst, one more unit per e_v row sums its rows' scratch sums through
//    the transpose of dst, in ascending m.
// So H gives the same bits on every run.
//  - 0 * g at the masked slots, with few extra bytes on finite inputs:
//    H1 raises a flag for a row with a masked slot inside [0, N) where
//    pass 1's da of an included slot is not finite (g[m] may not be), or,
//    for a row with no included slot, where g[m], read then, is not; a
//    follow-up kernel, launched as H2's programmatic dependent so that
//    its launch hides behind H2's tail (a count of H2's finished blocks
//    cost up to 13%: one atomic a block on one word), then writes NaN at
//    those slots' rows, only when the flag is up.  A written NaN does
//    not depend on the order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_index.cuh"

namespace {

constexpr int FC = 32;            // fanout slots per chunk
constexpr int MAX_WARPS = 8;      // dst rows per block
constexpr int SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float leaky(float s) {
  return s >= 0.f ? s : 0.2f * s;
}

// max and the denominator's floor as the plain version's amax and
// clamp_min take them: a NaN wins (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

__device__ __forceinline__ float floor_den(float s) {
  return isnan(s) ? s : fmaxf(s, 1e-20f);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// The clamped source of slot j, or ~(its row as the plain version's
// gather clamps it, a pad reading row 0) when the slot is excluded.  The
// forward adds an excluded slot's z row times its alpha of 0: that adds
// nothing to a finite sum and makes a non-finite value NaN, as the plain
// version's 0 * z does.
__device__ __forceinline__ int slot_code(const int32_t* row, int j, int N,
                                         const bool* valid) {
  const int i = min(row[j], N - 1);
  return (i >= 0 && valid[i]) ? i : ~max(i, 0);
}

__device__ __forceinline__ int code_row(int c) { return c >= 0 ? c : ~c; }

// A masked slot whose index is inside [0, N) (a pad, index -1, is row
// 0): its gradient adds 0 * g at that row, as the reference's autodiff
// does (jnp's scatter drops an index past N, so nothing is added there).
__device__ __forceinline__ bool masked_in_range(int i, int N,
                                                const bool* valid) {
  return i < N && !(i >= 0 && valid[i]);
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
      if (i >= 0) m = max_nan(m, leaky(eu[(size_t)i * H + h] + evh));
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
      sm.den[h] = floor_den(s);
    }
  }
  __syncwarp();
}

// alpha[j][h] and idx[j] (slot_code) of the chunk's nc slots from c0.
__device__ __forceinline__ void fill_chunk(const WarpSmem& sm,
                                           const int32_t* row, int c0, int nc,
                                           int N, const bool* valid,
                                           const float* eu, int H, int lane) {
  for (int p = lane; p < nc * H; p += 32) {
    const int j = p / H, h = p - j * H;
    const int i = slot_code(row, c0 + j, N, valid);
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
  __device__ static float dot(float a, float b) { return a * b; }
  __device__ static void mul_add(float& acc, float a, float v) {
    acc = __fadd_rn(acc, __fmul_rn(a, v));
  }
  __device__ static void add(float& acc, float v) { acc += v; }
  __device__ static float ld_cg(const float* p) { return __ldcg(p); }
  __device__ static bool finite(float v) { return isfinite(v); }
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
  __device__ static float dot(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  __device__ static void mul_add(float4& acc, float a, float4 v) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(a, v.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(a, v.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(a, v.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(a, v.w));
  }
  __device__ static void add(float4& acc, float4 v) {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __device__ static float4 ld_cg(const float4* p) { return __ldcg(p); }
  __device__ static bool finite(float4 v) {
    return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
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
    v[u] = on ? z[(size_t)code_row(idx[j]) * HDV + q] : Vec<T>::zero();
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
    const int i = slot_code(row, j, N, valid);
    lg[p] = i >= 0 ? leaky(eu[(size_t)i * H + h] + evrow[h]) : -INFINITY;
    if (h == 0) idx[j] = i;
  }
  __syncwarp();
  for (int h = 0; h < H; ++h) {
    float mh = -INFINITY;
    for (int j = lane; j < f; j += 32) mh = max_nan(mh, lg[j * H + h]);
    mh = warp_max(mh);
    float sh = 0.f;
    for (int j = lane; j < f; j += 32) {
      const float l = lg[j * H + h];
      if (l != -INFINITY) sh += expf(l - mh);
    }
    sh = warp_sum(sh);
    if (lane == 0) {
      mx[h] = mh;
      den[h] = floor_den(sh);
    }
  }
  __syncwarp();
  for (int p = lane; p < f * H; p += 32) {
    const int h = p % H;
    const float l = lg[p];
    lg[p] = l != -INFINITY ? expf(l - mx[h]) / den[h] : 0.f;
  }
  // the slots to gather, in order: the included ones, and the excluded
  // ones with their alpha of 0 (a non-finite row there makes the sum NaN,
  // as the plain version's 0 * z does); of the pads, which all read row
  // 0, only the first of a run
  int nv = 0;
  for (int j0 = 0; j0 < f; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < f && (idx[j] >= 0 || row[j] >= 0 || j == 0
                              || row[j - 1] >= 0);
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
        // every slot: an excluded one adds its row times an alpha of 0
        for (int j = 0; j < nc; ++j)
          Vec<T>::fma(acc, sm.alpha[j * H + h],
                      z[(size_t)code_row(sm.idx[j]) * HDV + q]);
      }
    }
    if (q < HDV) out[(size_t)m * HDV + q] = acc;
  }
}

// Kernel H1 (a warp per dst row).  extra arrays: tsum[H] (sum_j alpha
// da), dsum[H] (sum_j ds; entry h only ever touched by lane h % 32).  A
// row with a masked slot inside [0, N) raises *flag, for the follow-up,
// where a da of its included slots is not finite (g[m] may not be) or,
// with no included slot, where its g row, read here, is not.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gat_bwd_rows_kernel(const T* __restrict__ g, const T* __restrict__ z,
                    const float* __restrict__ eu, const float* __restrict__ ev,
                    const int32_t* __restrict__ nbr,
                    const bool* __restrict__ valid,
                    const int32_t* __restrict__ dst, float* __restrict__ ds,
                    float* __restrict__ alpha, float* __restrict__ rowsum,
                    float* __restrict__ dev, int* flag, int N, int Nev, int M,
                    int f, int H, int dh, int warps) {
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
  float* dsrow = ds + (size_t)m * f * H;
  float* arow = alpha + (size_t)m * f * H;
  // pass 1: da of every included slot, and sum_j alpha da per head (a da
  // that is not finite flags a g row that may not be)
  bool included = false, nf = false;
  for (int c0 = 0; c0 < f; c0 += FC) {
    const int nc = min(FC, f - c0);
    __syncwarp();
    fill_chunk(sm, row, c0, nc, N, valid, eu, H, lane);
    __syncwarp();
    for (int j = 0; j < nc; ++j) {
      const int i = sm.idx[j];
      if (i < 0) continue;        // uniform: read from shared memory
      included = true;
      const T* zrow = z + (size_t)i * HDV;
      for (int h = 0; h < H; ++h) {
        float part = 0.f;
        for (int q = h * dhv + lane; q < (h + 1) * dhv; q += 32)
          part += Vec<T>::dot(grow[q], zrow[q]);
        part = warp_sum(part);
        nf |= !isfinite(part);
        if (lane == 0) {
          dsrow[(size_t)(c0 + j) * H + h] = part;
          tsum[h] += sm.alpha[j * H + h] * part;
        }
      }
    }
  }
  // a masked slot inside [0, N) adds 0 * g[m] (H's follow-up): raise the
  // flag where g[m] may not be finite, as pass 1's da saw it through the
  // included slots; a row with none reads g[m] here
  bool masked = false;
  for (int j0 = 0; j0 < f && !masked; j0 += 32) {
    const int j = j0 + lane;
    masked = __any_sync(0xffffffffu, j < f && masked_in_range(row[j], N,
                                                              valid));
  }
  if (masked) {
    if (!included)
      for (int q = lane; q < HDV; q += 32) nf |= !Vec<T>::finite(grow[q]);
    slot_index::raise_if(nf, flag, lane);
  }
  // pass 2: ds over da and alpha beside it for every included slot, and
  // the row's sum of ds per head, each head's in slot order by one lane
  for (int c0 = 0; c0 < f; c0 += FC) {
    const int nc = min(FC, f - c0);
    __syncwarp();
    fill_chunk(sm, row, c0, nc, N, valid, eu, H, lane);
    __syncwarp();
    for (int h = lane; h < H; h += 32) {
      float acc = dsum[h];
      for (int j = 0; j < nc; ++j) {
        const int i = sm.idx[j];
        if (i < 0) continue;
        const size_t p = (size_t)(c0 + j) * H + h;
        const float s = eu[(size_t)i * H + h] + sm.ev[h];
        const float a = sm.alpha[j * H + h];
        const float dl = a * (dsrow[p] - tsum[h]);
        const float dsv = s >= 0.f ? dl : 0.2f * dl;
        dsrow[p] = dsv;
        arow[p] = a;
        acc += dsv;
      }
      dsum[h] = acc;
    }
  }
  __syncwarp();
  float* out = dst ? rowsum : dev;
  for (int h = lane; h < H; h += 32) out[(size_t)m * H + h] = dsum[h];
}

// Kernel H2's unit w: unit w of the transposed index of nbr (a source
// row of at most CHUNK slots, or one chunk of a longer row) for dz and
// de_u; with dst, units past them take one e_v row each.  A partial row
// of `part` holds H*dh floats of dz, then H of de_u, padded to a multiple
// of 4 floats.
template <typename T, int Q>
__device__ __forceinline__ void h_unit(
    long long w, int lane, const T* __restrict__ g,
    const float* __restrict__ ds, const float* __restrict__ alpha,
    const int32_t* __restrict__ off, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ lbase, const int32_t* __restrict__ voff,
    const int32_t* __restrict__ vrows, const float* __restrict__ rowsum,
    float* part, int* ticket, T* __restrict__ dz, float* __restrict__ deu,
    float* __restrict__ dev, int N, int Nev, int f, int H, int dh,
    int lbound) {
  constexpr int E = 8 / Q;                      // rows in flight
  if (w >= (long long)N + lbound) {
    // de_v through the transpose of dst: row d's rows in ascending m
    const long long d = w - N - lbound;
    if (!voff || d >= Nev) return;
    for (int h = lane; h < H; h += 32) {
      float acc = 0.f;
      for (int k = voff[d]; k < voff[d + 1]; ++k)
        acc += rowsum[(size_t)vrows[k] * H + h];
      dev[(size_t)d * H + h] = acc;
    }
    return;
  }
  slot_index::Unit t;
  if (!slot_index::unit_of(w, off, lbase, N, &t)) return;
  const int dhv = dh / Vec<T>::W, HDV = H * dhv, HD = H * dh;
  const int W = HD + (H + 3) / 4 * 4;           // floats per partial row
  const bool whole = t.nch == 1;
  float* pout = part + (size_t)(t.lb + t.chunk) * W;
  T* zout = whole ? dz + (size_t)t.row * HDV : reinterpret_cast<T*>(pout);
  float* uout = whole ? deu + (size_t)t.row * H : pout + HD;
  for (int q0 = 0; q0 < HDV; q0 += 32 * Q) {
    bool on[Q];
    int hq[Q];
    T acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int col = q0 + lane + 32 * q;
      on[q] = col < HDV;
      hq[q] = on[q] ? col / dhv : 0;
      acc[q] = Vec<T>::zero();
    }
    for (int k0 = t.a; k0 < t.b; k0 += 32) {
      const int n = min(32, t.b - k0);
      const int s_l = lane < n ? slots[k0 + lane] : 0;
      for (int e0 = 0; e0 < n; e0 += E) {
        T v[E][Q];
        float a[E][Q];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int s = __shfl_sync(0xffffffffu, s_l, (e0 + e) & 31);
          if (e0 + e < n) {
            const T* grow = g + (size_t)(s / f) * HDV + q0 + lane;
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              if (on[q]) {
                v[e][q] = grow[32 * q];
                a[e][q] = alpha[(size_t)s * H + hq[q]];
              }
            }
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e0 + e < n) {
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (on[q]) Vec<T>::mul_add(acc[q], a[e][q], v[e][q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (on[q]) zout[q0 + lane + 32 * q] = acc[q];
  }
  for (int h = lane; h < H; h += 32) {
    float acc = 0.f;
    for (int k = t.a; k < t.b; ++k) acc += ds[(size_t)slots[k] * H + h];
    uout[h] = acc;
  }
  if (whole || !slot_index::last_chunk(t, ticket, lane)) return;
  // the row's last chunk: its partials in chunk order, from 0.0
  const float* p0 = part + (size_t)t.lb * W;
  T* zrow = dz + (size_t)t.row * HDV;
  for (int q = lane; q < HDV; q += 32) {
    T acc = Vec<T>::zero();
    for (int c = 0; c < t.nch; ++c)
      Vec<T>::add(acc, Vec<T>::ld_cg(
          reinterpret_cast<const T*>(p0 + (size_t)c * W) + q));
    zrow[q] = acc;
  }
  for (int h = lane; h < H; h += 32) {
    float acc = 0.f;
    for (int c = 0; c < t.nch; ++c)
      acc += __ldcg(p0 + (size_t)c * W + HD + h);
    deu[(size_t)t.row * H + h] = acc;
  }
}

// Kernel H's follow-up, when H1 raised the flag: the reference's
// autodiff adds alpha * g[m] at a masked slot's row too, with alpha 0
// there, so 0 * g[m, h, e]: NaN where g is not finite (a pad reads row 0;
// an index past N adds nothing).  Launched after H2 as its programmatic
// dependent (slot_index.cuh): it waits for H2, reads the flag and, when
// it is down (every finite step), stops; else warp by warp over the dst
// rows, slow and rare (only a step with a non-finite gradient gets
// there).
__global__ void __launch_bounds__(MAX_WARPS * 32)
gat_fix_kernel(const float* __restrict__ g, const int32_t* __restrict__ nbr,
               const bool* __restrict__ valid, const int* flag, float* dz,
               int N, int M, int f, int HD) {
  slot_index::wait_primary();
  if (*reinterpret_cast<const volatile int*>(flag) == 0) return;
  const int lane = threadIdx.x % 32;
  const float nan = __int_as_float(0x7fffffff);
  const int warps = gridDim.x * MAX_WARPS;
  for (int m = blockIdx.x * MAX_WARPS + threadIdx.x / 32; m < M;
       m += warps) {
    bool nf = false;
    for (int q = lane; q < HD; q += 32) nf |= !isfinite(g[(size_t)m * HD + q]);
    if (!__any_sync(0xffffffffu, nf)) continue;
    for (int j = 0; j < f; ++j) {
      const int i = nbr[(size_t)m * f + j];
      if (!masked_in_range(i, N, valid)) continue;
      float* row = dz + (size_t)max(i, 0) * HD;
      for (int q = lane; q < HD; q += 32)
        if (!isfinite(g[(size_t)m * HD + q])) row[q] = nan;
    }
  }
}

// Kernel H2: the units of h_unit (gat_fix_kernel follows).  ticket
// [lbound + 1]: the long rows' tickets, then H1's flag.
template <typename T, int Q>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gat_bwd_src_kernel(const T* __restrict__ g, const float* __restrict__ ds,
                   const float* __restrict__ alpha,
                   const int32_t* __restrict__ off,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ lbase,
                   const int32_t* __restrict__ voff,
                   const int32_t* __restrict__ vrows,
                   const float* __restrict__ rowsum,
                   const int32_t* __restrict__ nbr,
                   const bool* __restrict__ valid, float* part, int* ticket,
                   T* __restrict__ dz, float* __restrict__ deu,
                   float* __restrict__ dev, int N, int Nev, int M, int f,
                   int H, int dh, int lbound) {
  slot_index::launch_dependents();
  const long long w = (long long)blockIdx.x * MAX_WARPS + threadIdx.x / 32;
  h_unit<T, Q>(w, threadIdx.x % 32, g, ds, alpha, off, slots, lbase, voff,
               vrows, rowsum, part, ticket, dz, deu, dev, N, Nev, f, H, dh,
               lbound);
}

template <typename T>
void launch_src(const void* g, const void* ds, const void* alpha,
                const void* off, const void* slots, const void* lbase,
                const void* voff, const void* vrows, const void* rowsum,
                const void* nbr, const void* valid, void* part, void* ticket,
                void* dz, void* deu, void* dev, int N, int Nev, int M, int f,
                int H, int dh, int lbound, cudaStream_t s) {
  const long long units = (long long)N + lbound + (voff ? Nev : 0);
  const int blocks = (int)((units + MAX_WARPS - 1) / MAX_WARPS);
  const int HDV = H * (dh / Vec<T>::W);
#define SRC_ARGS                                                           \
  (const T*)g, (const float*)ds, (const float*)alpha, (const int32_t*)off, \
      (const int32_t*)slots, (const int32_t*)lbase, (const int32_t*)voff,  \
      (const int32_t*)vrows, (const float*)rowsum, (const int32_t*)nbr,    \
      (const bool*)valid, (float*)part, (int*)ticket, (T*)dz, (float*)deu, \
      (float*)dev, N, Nev, M, f, H, dh, lbound
  if (HDV > 32) {
    gat_bwd_src_kernel<T, 2><<<blocks, MAX_WARPS * 32, 0, s>>>(SRC_ARGS);
  } else {
    gat_bwd_src_kernel<T, 1><<<blocks, MAX_WARPS * 32, 0, s>>>(SRC_ARGS);
  }
#undef SRC_ARGS
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

// Kernel H, its two launches.  `ds` and `alpha` [M, f, H] are scratch,
// `rowsum` [M, H] too where `dst` is given (else null); `off` [N + 1],
// `slots` [M * f] and `lbase` [N + 1] are the transposed index of nbr
// (slot_index.cuh) and `lbound` its bound on long chunks, `part`
// [lbound, H*dh + H rounded up to a multiple of 4] scratch and `ticket`
// [lbound + 1] zero; `voff` [Nev + 1] and `vrows` [M] the transpose of
// dst (null without dst).  Three launches: H1, H2 and the follow-up.
// Every row of
// `dz` [N, H*dh] and `deu` [N, H] is written; `dev` [Nev, H] must be zero
// without dst (rows past M stay so), and is written whole with it.
extern "C" int gat_edge_bwd(const void* g, const void* z, const void* eu,
                            const void* ev, const void* nbr, const void* valid,
                            const void* dst, void* ds, void* alpha,
                            void* rowsum, const void* off, const void* slots,
                            const void* lbase, const void* voff,
                            const void* vrows, void* part, void* ticket,
                            void* dz, void* deu, void* dev, int N, int Nev,
                            int M, int f, int H, int dh, int lbound,
                            void* stream) {
  const int warps = rows_per_block(H, 2);
  if (warps == 0 || N < 1 || lbound < 0 || (dst && (!rowsum || !voff)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (M + warps - 1) / warps;
  const size_t smem = (size_t)warps * warp_smem_floats(H, 2) * sizeof(float);
  const bool vec = dh % 4 == 0 && aligned16(g) && aligned16(z)
                   && aligned16(dz) && aligned16(part) && H * dh % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    gat_bwd_rows_kernel<float4><<<blocks, warps * 32, smem, s>>>(
        (const float4*)g, (const float4*)z, (const float*)eu,
        (const float*)ev, (const int32_t*)nbr, (const bool*)valid,
        (const int32_t*)dst, (float*)ds, (float*)alpha, (float*)rowsum,
        (float*)dev, (int*)ticket + lbound, N, Nev, M, f, H, dh, warps);
  } else {
    gat_bwd_rows_kernel<float><<<blocks, warps * 32, smem, s>>>(
        (const float*)g, (const float*)z, (const float*)eu, (const float*)ev,
        (const int32_t*)nbr, (const bool*)valid, (const int32_t*)dst,
        (float*)ds, (float*)alpha, (float*)rowsum, (float*)dev,
        (int*)ticket + lbound, N, Nev, M, f, H, dh, warps);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (vec) {
    launch_src<float4>(g, ds, alpha, off, slots, lbase, voff, vrows, rowsum,
                       nbr, valid, part, ticket, dz, deu, dev, N, Nev, M, f,
                       H, dh, lbound, s);
  } else {
    launch_src<float>(g, ds, alpha, off, slots, lbase, voff, vrows, rowsum,
                      nbr, valid, part, ticket, dz, deu, dev, N, Nev, M, f, H,
                      dh, lbound, s);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)slot_index::launch_dependent(
      gat_fix_kernel, slot_index::FIX_BLOCKS, MAX_WARPS * 32, s,
      (const float*)g, (const int32_t*)nbr, (const bool*)valid,
      (const int*)ticket + lbound, (float*)dz, N, M, f, H * dh);
}
