// Device helpers shared by the port's kernels: bf16 packing, the mma.sync
// m16n8k16 product, and a deterministic column sum.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t):
//   A (16x16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                         a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same cols);
//   B (16x8, column-major): b0 (rows 2t, 2t+1 of col g), b1 (rows 2t+8, 2t+9);
//   C (16x8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_halves(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 out.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kColumnSumWarps = 8;

// out[c] = sum over r of part[r * cols + c], fp32, in an order fixed by the
// shape alone: warp w sums rows w, w + 8, ... of 32 columns, then warp 0
// adds the eight partial sums in warp order.  Reruns give the same bits,
// which float atomics would not.
__global__ void __launch_bounds__(32 * kColumnSumWarps)
column_sum_kernel(const float* __restrict__ part, int rows, int cols, float* __restrict__ out) {
  __shared__ float partial[kColumnSumWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (col < cols) {
    for (int r = warp; r < rows; r += kColumnSumWarps) acc += part[static_cast<long>(r) * cols + col];
  }
  partial[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kColumnSumWarps; ++w) total += partial[w][lane];
    out[col] = total;
  }
}

inline cudaError_t launch_column_sum(const float* part, int rows, int cols, float* out,
                                     cudaStream_t stream) {
  column_sum_kernel<<<(cols + 31) / 32, 32 * kColumnSumWarps, 0, stream>>>(part, rows, cols, out);
  return cudaGetLastError();
}

}  // namespace
