// The product of two row-major bf16 matrices over their shared row index,
//   out[i, j] = sum over rows r of a[r, i] * b[r, j]   (a^T . b, fp32),
// as a weight gradient needs it (attn_proj.cu: dW = dy^T O; attention_block.cu:
// dW = x^T dqkv).  The sum runs over every row of the batch and the port uses
// no float atomics, so a block owns one 64 x 64 tile of `out` over one slice
// of the rows and writes its partial; column_sum_kernel (common.cuh) then
// adds the slices in order: the same bits on every run.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTpThreads = 128;
constexpr int kTpStages = 3;
constexpr int kTpTile = 64;
constexpr int kTpRows = 64;  // rows of the reduction per step
constexpr int kTpLd = kTpTile + 8;
constexpr int kTpStageElems = 2 * kTpRows * kTpLd;  // an a tile and a b tile
constexpr size_t kTpSmemBytes = kTpStages * kTpStageElems * sizeof(bf16);

// a: (M, lda) and b: (M, ldb) bf16; part: (slices, I, J) fp32 with I, J the
// column counts covered by the grid (J / 64, I / 64, slices).  Both operands
// have the reduction index running down their rows, so both fragments are
// read transposed (ldmatrix.trans).
__global__ void __launch_bounds__(kTpThreads)
transposed_product_kernel(const bf16* __restrict__ a, int lda, const bf16* __restrict__ b, int ldb,
                          float* __restrict__ part, int M, int rows_per_slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  const int j0 = blockIdx.x * kTpTile;  // b's columns: out's columns
  const int i0 = blockIdx.y * kTpTile;  // a's columns: out's rows
  const int J = gridDim.x * kTpTile;
  const int I = gridDim.y * kTpTile;
  const int r_begin = blockIdx.z * rows_per_slice;
  const int r_end = min(M, r_begin + rows_per_slice);
  const int steps = r_end > r_begin ? (r_end - r_begin + kTpRows - 1) / kTpRows : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  auto load = [&](int step) {
    bf16* t_a = s + (step % kTpStages) * kTpStageElems;
    bf16* t_b = t_a + kTpRows * kTpLd;
    const int row0 = r_begin + step * kTpRows;
    for (int i = threadIdx.x; i < kTpRows * (kTpTile / 8); i += kTpThreads) {
      const int r = i / (kTpTile / 8);
      const int c = (i % (kTpTile / 8)) * 8;
      const int row = row0 + r;
      const bool ok = row < r_end;
      cp_async_16(t_a + r * kTpLd + c, ok ? a + static_cast<long>(row) * lda + i0 + c : a,
                  ok ? 16 : 0);
      cp_async_16(t_b + r * kTpLd + c, ok ? b + static_cast<long>(row) * ldb + j0 + c : b,
                  ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
#pragma unroll
  for (int st = 0; st < kTpStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kTpStages - 2>();
    __syncthreads();
    const int next = step + kTpStages - 1;
    if (next < steps) load(next);
    cp_async_commit();
    const bf16* t_a = s + (step % kTpStages) * kTpStageElems;
    const bf16* t_b = t_a + kTpRows * kTpLd;
    const int m8 = lane / 8;  // which 8x8 matrix this lane addresses
#pragma unroll
    for (int kk = 0; kk < kTpRows; kk += 16) {
      uint32_t fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4_trans(fa[i], t_a + (kk + (m8 >> 1) * 8 + (lane % 8)) * kTpLd + wm + i * 16 +
                                     (m8 & 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, t_b + (kk + (m8 & 1) * 8 + (lane % 8)) * kTpLd + wn + j * 8 +
                                  (m8 >> 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][j], fa[i], fb[0], fb[1]);
          mma_16816(acc[i][j + 1], fa[i], fb[2], fb[3]);
        }
      }
    }
  }
  float* dst = part + static_cast<long>(blockIdx.z) * I * J;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i0 + wm + i * 16 + g + 8 * half;
        const int col = j0 + wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst + static_cast<long>(row) * J + col) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
}

// out (I, J) fp32 = a^T . b over M rows, through `part` (slices, I, J) fp32
// scratch; I and J multiples of 64, lda and ldb multiples of 8.
inline cudaError_t launch_transposed_product(const bf16* a, int lda, const bf16* b, int ldb,
                                             float* part, float* out, int M, int I, int J,
                                             int slices, cudaStream_t stream) {
  if (slices < 1 || I % kTpTile != 0 || J % kTpTile != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(transposed_product_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTpSmemBytes));
  if (err != cudaSuccess) return err;
  const int per_slice = ((M + slices - 1) / slices + kTpRows - 1) / kTpRows * kTpRows;
  transposed_product_kernel<<<dim3(J / kTpTile, I / kTpTile, slices), kTpThreads, kTpSmemBytes,
                              stream>>>(a, lda, b, ldb, part, M, per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sum(part, slices, I * J, out, stream);
}

}  // namespace
