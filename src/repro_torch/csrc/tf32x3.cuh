// Float32-accurate products on Hopper's tensor cores (3xTF32 on
// mma.sync), and the cp.async staging that feeds them.  Shared by kernel
// C (csrc/update_fused.cu) and kernel A (csrc/serve_fused.cu).
//
// x = hi + lo with both parts TF32; a*b is taken as a_lo*b_hi + a_hi*b_lo
// + a_hi*b_hi with float32 accumulation (the a_lo*b_lo term is below
// float32's rounding): three m16n8k8 TF32 products per tile.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (4 or 16) bytes, or that many zeros when !pred.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool pred) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(pred ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(pred ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away: add half
// of the 13 dropped bits, then drop them), lo the exact remainder, whose
// own low 13 bits the tensor cores ignore.  Two integer ops and a
// subtract: cvt.rna.tf32.f32 issues at the conversion rate, and the split
// runs for every fragment element.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += the warp's [16 MT, 8 NT] tile of As @ Bs over one staged step of
// depth BK: As row-major with rows of a_ld floats (the warp's rows from
// wm), Bs row-major with rows of b_ld floats (its columns from wn).  The
// tensor cores add into their float32 accumulator by truncation, so over
// a long sum (3 * C / 8 mma) the error grows with the number of adds; the
// step's products are summed in a fresh accumulator and added to acc on
// the CUDA cores, rounded to nearest.  With a_ld = 4 and b_ld = 8 (mod
// 32) every fragment read is free of bank conflicts.
template <int MT, int NT, int BK>
__device__ __forceinline__ void mma_step(const float* As, int a_ld,
                                         const float* Bs, int b_ld,
                                         float (&acc)[MT][NT][4], int wm,
                                         int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* a = As + (wm + 16 * i + g) * a_ld + kk + t;
      split_tf32(a[0], ah[i][0], al[i][0]);
      split_tf32(a[8 * a_ld], ah[i][1], al[i][1]);
      split_tf32(a[4], ah[i][2], al[i][2]);
      split_tf32(a[8 * a_ld + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = Bs + (kk + t) * b_ld + wn + 8 * j + g;
      split_tf32(b[0], bh[j][0], bl[j][0]);
      split_tf32(b[4 * b_ld], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_tf32(part[i][j], al[i], bh[j]);
        mma_tf32(part[i][j], ah[i], bl[j]);
        mma_tf32(part[i][j], ah[i], bh[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }
}
