// The register-tiled fp32 SGEMM that fc1_gelu_f32.cu and ln_linear_f32.cu
// share: C = A . W^T over (M, K) rows of A and (N, K) rows of W, both
// K-major in memory, on the CUDA cores (FFMA, fp32 accumulation; no TF32,
// no split into bf16 terms: wgmma has no fp32 operand type).
//
//   * A block of 256 threads computes a 128 x 128 tile of C, each thread an
//     8 x 8 sub-tile (two 4-row by two 4-column groups, so that its reads of
//     shared memory are 16-byte and the tile's stores are too), in 64
//     registers of accumulators.
//   * A k-step of 8 is one 16-byte piece a thread of each operand, staged
//     through registers and stored transposed ([k][row]) into one of two
//     shared buffers while the other buffer's step is multiplied: one
//     barrier a step.  `load_a(row, k)` returns A's piece (row, k .. k + 3)
//     as the caller defines it (x itself, or x normalised as it is staged);
//     rows past M stage zeros and are never stored.
//   * `epilogue(row, col, acc)` receives the fp32 sums of C's columns
//     col .. col + 3 of each row below M (N is a multiple of 8, so a group
//     of 4 is whole or wholly past N).
// Each output is the FFMA chain over k in ascending order, so reruns give
// the same bits.  K is a multiple of 8.
#pragma once

#include "common.cuh"

namespace {

constexpr int kSgemmBM = 128;
constexpr int kSgemmBN = 128;
constexpr int kSgemmBK = 8;
constexpr int kSgemmThreads = 256;

template <class LoadA, class Epilogue>
__device__ __forceinline__ void sgemm_f32_tile(LoadA load_a, const float* __restrict__ w, int M,
                                               int K, int N, Epilogue epilogue) {
  __shared__ __align__(16) float s_a[2][kSgemmBK][kSgemmBM];
  __shared__ __align__(16) float s_b[2][kSgemmBK][kSgemmBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kSgemmBM;
  const int n0 = blockIdx.x * kSgemmBN;

  // The loader: row tid / 2 of each tile, k offsets (tid % 2) * 4 .. + 3.
  const int l_row = tid >> 1;
  const int l_k = (tid & 1) * 4;
  const bool a_ok = m0 + l_row < M;
  const bool b_ok = n0 + l_row < N;
  const int a_row = a_ok ? m0 + l_row : 0;
  const float* b_src = w + static_cast<long>(b_ok ? n0 + l_row : 0) * K + l_k;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a_next = a_ok ? load_a(a_row, l_k) : zero;
  float4 b_next = b_ok ? *reinterpret_cast<const float4*>(b_src) : zero;

  auto stage = [&](int buf) {
    s_a[buf][l_k + 0][l_row] = a_next.x;
    s_a[buf][l_k + 1][l_row] = a_next.y;
    s_a[buf][l_k + 2][l_row] = a_next.z;
    s_a[buf][l_k + 3][l_row] = a_next.w;
    s_b[buf][l_k + 0][l_row] = b_next.x;
    s_b[buf][l_k + 1][l_row] = b_next.y;
    s_b[buf][l_k + 2][l_row] = b_next.z;
    s_b[buf][l_k + 3][l_row] = b_next.w;
  };

  // The thread's outputs: rows r0 + {0..3} and r0 + 64 + {0..3}, columns
  // c0 + {0..3} and c0 + 64 + {0..3} of the tile.
  const int r0 = (tid / 16) * 4;
  const int c0 = (tid % 16) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  stage(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kSgemmBK) {
    const bool more = k0 + kSgemmBK < K;
    if (more) {
      a_next = a_ok ? load_a(a_row, k0 + kSgemmBK + l_k) : zero;
      b_next = b_ok ? *reinterpret_cast<const float4*>(b_src + k0 + kSgemmBK) : zero;
    }
#pragma unroll
    for (int kk = 0; kk < kSgemmBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&s_a[buf][kk][r0]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&s_a[buf][kk][r0 + 64]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&s_b[buf][kk][c0]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&s_b[buf][kk][c0 + 64]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + r0 + (i & 3) + (i >> 2) * 64;
    if (row >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + c0 + half * 64;
      if (col >= N) continue;
      epilogue(row, col, make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                                     acc[i][4 * half + 2], acc[i][4 * half + 3]));
    }
  }
}

}  // namespace
