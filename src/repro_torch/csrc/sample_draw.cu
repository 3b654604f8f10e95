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
// reference: lax.top_k puts equal keys lower slot first, and every
// selection here orders by (key, slot) too, comparing the keys' bits,
// which order as the non-negative floats do.
//
// Bound on the H100 (3.35 TB/s): bytes.  Per row cur, allow, two indptr
// words and the f outputs; per candidate of a larger row its index (and
// its weight under cv): 5 MB at training layer 0 (176,000 rows, 729,393
// candidates), 1.5 us, under a launch.  The first design (one warp per
// row, the keys recomputed in each of f rounds of a 64-bit butterfly)
// took 0.0365 ms there, and its selection rows set the pace at every
// layer (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design.  The frontier's rows come in tiles of `group` consecutive rows
// (1 to 32; sample_draw.draw_group picks the fewest at which the tiles
// number 96 a SM at most).  A block of 8 warps takes 8 tiles spread over
// the frontier (tile warp * gridDim.x + blockIdx.x): the frontier lists
// its vertices first and pads with -1, so a block sees a share of the
// live rows wherever it sits.
//  1. Triage: lane i of a warp loads its tile's row i: cur, allow and
//     both indptr words, all in flight at once (a row outside the solids
//     reads row 0's and drops them).  A ballot gives the rows with deg >
//     f.
//  2. The tile's empty and take-all rows are written in one pass over its
//     [group, f] outputs, contiguous in out: neighbouring lanes store
//     neighbouring words.  The selection rows go to the block's queue in
//     shared memory.
//  3. After a barrier the block's warps share out the queue, a row to a
//     warp.  A row of deg <= 32 K (K = 1, 2, 4) has K candidates to a lane
//     (slot lane + 32 k), each key computed once and kept in registers;
//     then f rounds of a warp minimum over 32-bit keys (redux.sync, and a
//     second one over the slots of the lanes that hold the least key, so
//     ties go to the lower slot) each store the least candidate left and
//     drop it.  A row wider than 128 takes f rounds that recompute its
//     keys (the first design's), since it cannot stay in registers.
// The queue spreads the selection rows, which the first 15% of training
// layer 0's rows hold, over the whole grid; keys computed once and the
// 32-bit minimum cut the instructions of a row about fourfold.  What
// paces it on the H100: the latency of each row's chain (cur, indptr,
// indices, wtab) and the launch; at layer 0 also its 11,000 warps, 1.3
// waves of blocks that each wait at the barrier for their slowest warp
// (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                  // warps per block
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;  // an absent candidate
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

struct Draw {
  const int32_t* __restrict__ indices;
  const float* __restrict__ wtab;
  int32_t* __restrict__ out;
  int f, n_w, policy;
  uint32_t seed;

  // The key bits of slot j of row `row`, neighbor vid (non-negative
  // floats: their bits order as they do).
  __device__ __forceinline__ uint32_t key(int row, int j, int32_t vid) const {
    float k;
    if (policy == 0) {
      k = hash_u01((uint32_t)row, (uint32_t)j, seed);
    } else {
      k = hash_u01((uint32_t)max(vid, 0), 0u, seed);
      if (policy == 2)
        k = __fdiv_rn(k, fmaxf(wtab[min(max(vid, 0), n_w - 1)], 1e-6f));
    }
    return __float_as_uint(k);
  }
  // The packed (key bits << 32) | j.
  __device__ __forceinline__ unsigned long long packed(int row, int j,
                                                       int32_t vid) const {
    return ((unsigned long long)key(row, j, vid) << 32) | (uint32_t)j;
  }
};

// f rounds of a warp minimum of 32-bit keys (redux.sync) over one row's
// candidates, K to a lane (slot lane + 32 k; an absent one holds ~0):
// each round stores the least (key, slot) left and drops it.
template <int K>
__device__ __forceinline__ void min_rounds(const Draw& d, int row,
                                           uint32_t (&key)[K],
                                           const int32_t (&vid)[K],
                                           int lane) {
  int32_t* o = d.out + (size_t)row * d.f;
  for (int t = 0; t < d.f; ++t) {
    // the lane's least: the least key, the lower slot on a tie
    uint32_t lk = key[0];
    int lkk = 0;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (key[k] < lk) {
        lk = key[k];
        lkk = k;
      }
    }
    const uint32_t m = __reduce_min_sync(FULL, lk);
    // of the lanes whose least key is m, the one with the least slot
    bool win;
    if (K == 1) {
      win = lane == __ffs(__ballot_sync(FULL, lk == m)) - 1;
    } else {
      const uint32_t slot = (uint32_t)(lane + 32 * lkk);
      win = __reduce_min_sync(FULL, lk == m ? slot : ~0u) == slot;
    }
    if (win) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == lkk) {
          o[t] = vid[k];
          key[k] = ~0u;
        }
      }
    }
  }
}

// One row of deg <= 32 K candidates, K to a lane, by the whole warp.
template <int K>
__device__ __forceinline__ void select_min(const Draw& d, int row,
                                           const int32_t* nbr, int deg,
                                           int lane) {
  int32_t vid[K];
  uint32_t key[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    vid[k] = j < deg ? nbr[j] : 0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    key[k] = j < deg ? d.key(row, j, vid[k]) : ~0u;
  }
  min_rounds<K>(d, row, key, vid, lane);
}

// One row of any width: f rounds, each the least packed value above the
// last round's (the keys are computed again in every round).
__device__ __forceinline__ void select_rounds(const Draw& d, int row,
                                              const int32_t* nbr, int deg,
                                              int lane) {
  unsigned long long last = 0;
  for (int t = 0; t < d.f; ++t) {
    unsigned long long best = NONE;
    for (int j = lane; j < deg; j += 32) {
      const unsigned long long p = d.packed(row, j, nbr[j]);
      if ((t == 0 || p > last) && p < best) best = p;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, best, off);
      best = o < best ? o : best;
    }
    last = best;
    if (lane == 0)
      d.out[(size_t)row * d.f + t] = nbr[(uint32_t)(best & 0xffffffffull)];
  }
}

__global__ void __launch_bounds__(WARPS * 32)
sample_draw_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ cur,
                   const uint8_t* __restrict__ allow, Draw d, int n,
                   int num_solid, int group) {
  __shared__ int4 queue[WARPS * 32];      // (row, start, deg) to select
  __shared__ int queued;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = d.f;
  const int T = (n + group - 1) / group;  // tiles of `group` rows
  const int t = warp * gridDim.x + blockIdx.x;  // this warp's tile
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();
  if (t < T) {                            // uniform across the warp
    const int base = t * group;
    const int rows = min(group, n - base);
    // 1. triage: lane i takes row base + i
    int start = 0, deg = 0;
    if (lane < rows) {
      const int r = base + lane;
      const int v = cur[r];
      const bool allowed = allow == nullptr || allow[r] != 0;
      const bool solid = v >= 0 && v < num_solid;
      const int vs = solid ? v : 0;
      const int s = indptr[vs], e = indptr[vs + 1];
      if (solid && allowed) {
        start = s;
        deg = e - s;
      }
    }
    const unsigned todo = __ballot_sync(FULL, deg > f);
    // 2. the tile's empty and take-all rows, [rows, f] contiguous in out
    if (__popc(todo) < rows) {
      int32_t* tile = d.out + (size_t)base * f;
      const int total = rows * f;
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int e = e0 + lane;
        const int i = min(e / f, rows - 1);
        const int s_i = __shfl_sync(FULL, start, i);
        const int d_i = __shfl_sync(FULL, deg, i);
        if (e < total && d_i <= f) {
          const int c = e - i * f;
          tile[e] = c < d_i ? d.indices[s_i + c] : -1;
        }
      }
    }
    // the selection rows go to the block's queue
    if (todo) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&queued, __popc(todo));
      at = __shfl_sync(FULL, at, 0);
      if (todo >> lane & 1u)
        queue[at + __popc(todo & ((1u << lane) - 1u))] =
            make_int4(base + lane, start, deg, 0);
    }
  }
  __syncthreads();
  // 3. the block's selection rows, shared out over its warps
  const int total = queued;
  for (int q = warp; q < total; q += WARPS) {
    const int4 e = queue[q];
    const int32_t* nbr = d.indices + e.y;
    if (e.z <= 32) {
      select_min<1>(d, e.x, nbr, e.z, lane);
    } else if (e.z <= 64) {
      select_min<2>(d, e.x, nbr, e.z, lane);
    } else if (e.z <= 128) {
      select_min<4>(d, e.x, nbr, e.z, lane);
    } else {
      select_rounds(d, e.x, nbr, e.z, lane);
    }
  }
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  `allow` may be null;
// `group` (1 to 32) is the rows of a warp's tile.
extern "C" int sample_draw(const void* indptr, const void* indices,
                           const void* wtab, const void* cur,
                           const void* allow, void* out, int n, int f,
                           int num_solid, int n_w, unsigned int seed,
                           int policy, int group, void* stream) {
  if (group < 1 || group > 32) return (int)cudaErrorInvalidValue;
  const Draw d{(const int32_t*)indices, (const float*)wtab, (int32_t*)out, f,
               n_w, policy, (uint32_t)seed};
  const int tiles = (n + group - 1) / group;
  const int blocks = (tiles + WARPS - 1) / WARPS;
  sample_draw_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)cur, (const uint8_t*)allow, d,
      n, num_solid, group);
  return (int)cudaGetLastError();
}
