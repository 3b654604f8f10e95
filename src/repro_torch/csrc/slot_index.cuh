// The transposed slot index that kernels F and H read in their backward:
// for each source row i, the slots s = m * f + j with nbr[m, j] == i that
// the gradient keeps (0 <= nbr < N and valid), in ascending s, as CSR
// (offsets [N + 1], slots [M * f]).  It is built in the forward by
// kernels/slot_index.py (an integer sort, so the same whatever the launch
// order) and holds no float.
//
// A gather through it sums each source row's slots in ascending s from
// 0.0, so its result does not depend on the launch.  A hub row would keep
// one warp busy for thousands of slots, so a row of more than CHUNK slots
// is cut into chunks of CHUNK: each chunk is a unit of its own, writes
// its partial sum to scratch, and the last of the row's chunks to finish
// (a ticket per row) adds the partials in chunk order from 0.0.  lbase
// [N + 1] is the exclusive sum of the long rows' chunk counts, so the
// long rows' chunks are numbered lbase[i] .. lbase[i + 1] - 1.
//
// Units: u < N is row u when it has at most CHUNK slots (else none);
// u = N + l is chunk l of the long rows, for l < lbase[N].  A launch
// covers N + lbound units, lbound >= lbase[N] from the host (twice the
// slots over CHUNK: a row of L > CHUNK slots has fewer than 2 L / CHUNK
// chunks), so the host never reads lbase.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace slot_index {

constexpr int CHUNK = 128;        // kernels/slot_index.py:CHUNK

struct Unit {
  int row;        // the source row
  int a, b;       // its slot range [a, b) in slots[]
  int chunk;      // the chunk of a long row (0 for a short row)
  int nch;        // the row's chunk count (1 for a short row)
  int lb;         // lbase[row]: the first chunk's scratch row and ticket
};

// The unit u, or false when u has no work (a long row's short-row unit,
// or past the last chunk).  Every lane of a warp gets the same answer.
__device__ __forceinline__ bool unit_of(long long u, const int32_t* off,
                                        const int32_t* lbase, int N,
                                        Unit* t) {
  if (u < N) {
    const int i = (int)u;
    const int a = off[i], b = off[i + 1];
    if (b - a > CHUNK) return false;
    *t = Unit{i, a, b, 0, 1, 0};
    return true;
  }
  const int l = (int)(u - N);
  if (l >= lbase[N]) return false;
  int lo = 0, hi = N;             // lbase[lo] <= l < lbase[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (lbase[mid] <= l) lo = mid;
    else hi = mid;
  }
  const int lb = lbase[lo];
  const int c = l - lb;
  const int a0 = off[lo], b0 = off[lo + 1];
  *t = Unit{lo, a0 + c * CHUNK, min(b0, a0 + (c + 1) * CHUNK), c,
            lbase[lo + 1] - lb, lb};
  return true;
}

// After a long row's chunk stored its partial: true in the warp that
// finished the row's last chunk (it then adds the partials).  Every lane
// calls it.
__device__ __forceinline__ bool last_chunk(const Unit& t, int* ticket,
                                           int lane) {
  __threadfence();
  int last = 0;
  if (lane == 0) last = atomicAdd(ticket + t.lb, 1) == t.nch - 1;
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last) __threadfence();
  return last != 0;
}

// Programmatic dependent launch (sm_90): a kernel that calls
// launch_dependents() lets the next kernel of its stream, launched with
// cudaLaunchAttributeProgrammaticStreamSerialization, start once every
// block of this one has started; that kernel's wait_primary() returns
// when this one has finished and its writes are visible.  So a small
// follow-up kernel's launch hides behind the tail of the first.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

constexpr int FIX_BLOCKS = 32;    // blocks of a follow-up kernel

// Launch `kernel` on `stream` as a programmatic dependent of the kernel
// launched before it there.
template <typename... KArgs, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(KArgs...), int blocks,
                                    int threads, cudaStream_t stream,
                                    Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Raise `flag` (zero before the launch) when any lane's `bad` holds.
// Every lane calls it.
__device__ __forceinline__ void raise_if(bool bad, int* flag, int lane) {
  if (__any_sync(0xffffffffu, bad) && lane == 0) atomicExch(flag, 1);
}

}  // namespace slot_index
