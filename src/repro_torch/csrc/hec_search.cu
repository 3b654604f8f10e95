// Fused HEC probe + load (HECSearch + HECLoad) for Hopper (sm_90a): kernel
// B (hec_lookup, one cache) and, below, kernel J (hec_probe, the batched
// probe of R stacked caches packed as a cache fetch's response).
//
// Per probe i with vid v = vids[i]:
//   set   = ((uint32)v * 0x9E3779B1 >> 8) % nsets      (Fibonacci set hash)
//   way   = lowest w with tags[set, w] == v, 0 if none
//   hit   = some way matches && v >= 0
//   emb   = values[set, way, :] on a hit, zeros on a miss
// All four outputs are bit-exact to repro/cache/hec.py:hec_search +
// hec_load + the miss mask (a copy, no arithmetic on the values).
//
// Replaces the TPU kernel repro/kernels/hec_search.py:hec_search_kernel
// together with the HECLoad gather that repro/cache/hec.py:hec_lookup
// composes around it.
//
// Bound on the H100 (3.35 TB/s): bytes, since the probe does no
// arithmetic to speak of.  Per probe it reads one tag row (ways*4 bytes)
// and, on a hit, one value row (d*4 bytes), and writes 9 + d*4 bytes; at
// d=256 the emb rows are nearly all of it.
//
// Design: one warp per probe.  Each lane compares one way (ways <= 32),
// __ballot_sync gives the match mask and __ffs its lowest way, and the warp
// then copies the value row (float4 when aligned) or writes zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // probes per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
hec_lookup_kernel(const int32_t* __restrict__ tags,
                  const float* __restrict__ values,
                  const int32_t* __restrict__ vids, bool* __restrict__ hit,
                  int32_t* __restrict__ set_out, int32_t* __restrict__ way_out,
                  float* __restrict__ emb, int n, int nsets, int ways, int d) {
  const int i = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n) return;             // uniform across the warp
  const int32_t vid = vids[i];
  const uint32_t hsh = ((uint32_t)vid * 0x9E3779B1u) >> 8;
  const int s = (int)(hsh % (uint32_t)nsets);
  const bool match = lane < ways && tags[(size_t)s * ways + lane] == vid;
  const unsigned mask = __ballot_sync(FULL, match);
  const int w = mask ? __ffs(mask) - 1 : 0;
  const bool ht = mask != 0 && vid >= 0;
  if (lane == 0) {
    hit[i] = ht;
    set_out[i] = s;
    way_out[i] = w;
  }
  const float* src = values + ((size_t)s * ways + w) * d;
  float* dst = emb + (size_t)i * d;
  if ((d & 3) == 0 && ((uintptr_t)src & 15) == 0 && ((uintptr_t)dst & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = lane; c < d / 4; c += 32) dst4[c] = ht ? src4[c] : zero;
  } else {
    for (int c = lane; c < d; c += 32) dst[c] = ht ? src[c] : 0.f;
  }
}

// Kernel J: the batched probe of R stacked responder caches, written
// straight into the response buffer of a serve-side cache fetch.
//
// Probe i of the flattened [R, B, n] vids belongs to responder r = i /
// (B * n) and reads that responder's tags [r, nsets, ways] and values
// [r, nsets, ways, d].  Its output row out[i, 0:d+1] is the value row of
// the lowest matching way (zeros on a miss: bit-exact to hec_lookup
// above) and, in column d, 1.0 if the probe hit and alive[r] holds (a dead
// responder answers nothing; alive == nullptr means every rank is alive),
// else 0.0.  That is the reference's hec_probe followed by its
// concatenate of the values and the ok flag (repro/comm/engine.py
// cache_fetch), in one pass: no [.., d] tensor is copied again.
//
// Replaces the TPU kernel repro/kernels/hec_search.py:hec_search_batched
// (with the value gather of hec_probe around it).
//
// Bound: bytes.  Per probe one tag row (ways*4) and the vid in, on a hit
// one value row (d*4) in, and (d+1)*4 bytes out.
//
// Design: as hec_lookup_kernel, one warp per probe, a lane per way and
// __ballot_sync; the row is copied lane-strided.  Output rows are d+1
// floats wide, so they are not 16-byte aligned and the copy stays scalar
// (each warp store is still one contiguous 128-byte run).
__global__ void __launch_bounds__(WARPS * 32)
hec_probe_kernel(const int32_t* __restrict__ tags,
                 const float* __restrict__ values,
                 const int32_t* __restrict__ vids,
                 const bool* __restrict__ alive, float* __restrict__ out,
                 long long total, long long per_rank, int nsets, int ways,
                 int d) {
  const long long i = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= total) return;         // uniform across the warp
  const long long r = i / per_rank;
  const int32_t vid = vids[i];
  const uint32_t hsh = ((uint32_t)vid * 0x9E3779B1u) >> 8;
  const int s = (int)(hsh % (uint32_t)nsets);
  const size_t set_base = ((size_t)r * nsets + s) * ways;
  const bool match = lane < ways && tags[set_base + lane] == vid;
  const unsigned mask = __ballot_sync(FULL, match);
  const int w = mask ? __ffs(mask) - 1 : 0;
  const bool ht = mask != 0 && vid >= 0;
  const bool ok = ht && (alive == nullptr || alive[r]);
  const float* src = values + (set_base + w) * d;
  float* dst = out + (size_t)i * (d + 1);
  for (int c = lane; c < d; c += 32) dst[c] = ht ? src[c] : 0.f;
  if (lane == 0) dst[d] = ok ? 1.f : 0.f;
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).  Need ways <= 32.
extern "C" int hec_probe(const void* tags, const void* values,
                         const void* vids, const void* alive, void* out,
                         long long ranks, long long per_rank, int nsets,
                         int ways, int d, void* stream) {
  const long long total = ranks * per_rank;
  const long long blocks = (total + WARPS - 1) / WARPS;
  hec_probe_kernel<<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tags, (const float*)values, (const int32_t*)vids,
      (const bool*)alive, (float*)out, total, per_rank, nsets, ways, d);
  return (int)cudaGetLastError();
}

extern "C" int hec_lookup(const void* tags, const void* values,
                          const void* vids, void* hit, void* set_out,
                          void* way_out, void* emb, int n, int nsets,
                          int ways, int d, void* stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  hec_lookup_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tags, (const float*)values, (const int32_t*)vids,
      (bool*)hit, (int32_t*)set_out, (int32_t*)way_out, (float*)emb, n,
      nsets, ways, d);
  return (int)cudaGetLastError();
}
