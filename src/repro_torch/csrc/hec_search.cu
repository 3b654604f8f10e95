// Fused HEC probe + load (HECSearch + HECLoad) for Hopper (sm_90a).
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

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  Needs ways <= 32.
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
