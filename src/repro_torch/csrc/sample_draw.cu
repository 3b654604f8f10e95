// The fanout draw of one sampling layer for Hopper (sm_90a): kernel I.
//
//   out[r, :] = the neighbors of cur[r] picked for the next layer, int32,
//               -1 padded, for every frontier row r of cur [n]
//
// A row that is -1, a halo (>= num_solid) or not allowed (allow[r] == 0)
// draws nothing.  A row with deg <= f takes its whole CSR range in order.
// A larger row keeps the f candidates with the smallest selection keys,
// in ascending (key, slot) order, where the key of slot j of row r with
// neighbor vid is, by policy:
//
//   0 uniform  hash(r, j)
//   1 labor    hash(vid, 0)
//   2 cv       hash(vid, 0) / max(wtab[vid], 1e-6)   (IEEE division)
//
// and hash is the repo's u32 mix hash -> [0, 1) (models/gnn/common.py).
//
// Replaces the TPU kernel repro/kernels/sample_draw.py:sample_keys_kernel
// (the keys), and fuses into it what repro/kernels/sample_draw.py:
// draw_neighbors_device does around it in XLA: the CSR expansion to a
// dense [n, W] candidate matrix, the take-all override for deg <= f and
// the lax.top_k selection.  No [n, W] matrix is written.  Bit for bit the
// reference: lax.top_k puts equal keys lower slot first, and here the warp
// compares (key bits << 32) | slot, which orders as (key, slot) because
// the keys are non-negative floats and no two packed values are equal.
//
// Bound on the H100 (3.35 TB/s): bytes.  Per row cur, allow, two indptr
// words and the f outputs; per candidate of a larger row its index (and
// its weight under cv), about 12 MB at training layer 0 (176,000 rows,
// degree about 10), a few microseconds: the kernel is launch-bound, and
// the work it moves is the host's.
//
// Design (first version, right before fast): one warp per row, 8 rows per
// block.  A take-all row is copied by the lanes in turn.  A larger row
// takes f rounds; in each, every lane computes the keys of its slots
// (lane + 32k < deg) with native u32 arithmetic, keeps the least packed
// value above the previous round's pick, and a butterfly of shuffles
// gives the warp's least.  The picks rise strictly from round to round,
// so nothing needs to remember which slots were taken.  Keys are
// recomputed each round (f <= 15 on the paper's fanouts; the candidates
// stay in L1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                  // rows per block
constexpr uint32_t MIX1 = 0x85EBCA6Bu;
constexpr uint32_t MIX2 = 0xC2B2AE35u;

__device__ __forceinline__ float hash_u01(uint32_t a, uint32_t b,
                                          uint32_t seed) {
  uint32_t h = (a * MIX1) ^ (b * MIX2) ^ seed;
  h ^= h >> 15;
  h *= MIX1;
  h ^= h >> 13;
  return (float)(h >> 8) / 16777216.0f;
}

__global__ void __launch_bounds__(WARPS * 32)
sample_draw_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const float* __restrict__ wtab,
                   const int32_t* __restrict__ cur,
                   const uint8_t* __restrict__ allow,
                   int32_t* __restrict__ out, int n, int f, int num_solid,
                   int n_w, uint32_t seed, int policy) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;                   // uniform across the warp
  const int v = cur[row];
  const bool valid = v >= 0 && v < num_solid &&
                     (allow == nullptr || allow[row] != 0);
  const int start = valid ? indptr[v] : 0;
  const int deg = valid ? indptr[v + 1] - start : 0;
  const int32_t* nbr = indices + start;
  int32_t* o = out + (size_t)row * f;
  if (deg <= f) {
    for (int j = lane; j < f; j += 32) o[j] = j < deg ? nbr[j] : -1;
    return;
  }
  unsigned long long last = 0;
  for (int t = 0; t < f; ++t) {
    unsigned long long best = ~0ull;
    for (int j = lane; j < deg; j += 32) {
      const int32_t vid = nbr[j];
      float key;
      if (policy == 0) {
        key = hash_u01((uint32_t)row, (uint32_t)j, seed);
      } else {
        key = hash_u01((uint32_t)max(vid, 0), 0u, seed);
        if (policy == 2)
          key = __fdiv_rn(key, fmaxf(wtab[min(max(vid, 0), n_w - 1)], 1e-6f));
      }
      const unsigned long long p =
          ((unsigned long long)__float_as_uint(key) << 32) | (uint32_t)j;
      if ((t == 0 || p > last) && p < best) best = p;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other < best ? other : best;
    }
    last = best;
    if (lane == 0) o[t] = nbr[(uint32_t)(best & 0xffffffffull)];
  }
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  `allow` may be null.
extern "C" int sample_draw(const void* indptr, const void* indices,
                           const void* wtab, const void* cur,
                           const void* allow, void* out, int n, int f,
                           int num_solid, int n_w, unsigned int seed,
                           int policy, void* stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  sample_draw_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const float*)wtab,
      (const int32_t*)cur, (const uint8_t*)allow, (int32_t*)out, n, f,
      num_solid, n_w, (uint32_t)seed, policy);
  return (int)cudaGetLastError();
}
