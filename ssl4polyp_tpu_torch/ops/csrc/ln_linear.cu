// LayerNorm folded into the linear that follows it:
// out = LN(x) . W^T + b, with m = (x - mean) * rsqrt(var + eps) * s + t.
//
// Replaces: ssl4polyp_tpu/ops/ln_linear.py::_ln_linear_kernel (ln_linear),
// which the JAX package runs for each block's norm1 + QKV projection under
// qkv_ln_fusion.  Like the TPU kernel it takes the statistics in fp32 over
// whole rows, rounds the normalised row m to bf16 once, accumulates the
// product in fp32, adds the bias in fp32 and rounds once.  The backward is
// plain torch, as the JAX package leaves it to XLA.
//
// What bounds it on the H100: at the fine-tune shape (M = 12,608, K = 768,
// N = 2304) the product is 44.6 GFLOP against about 65 MB of bf16 traffic:
// the tensor cores.  What the fusion saves is the normalised stream's HBM
// round trip (2 x 19 MB).
//
// The design: LayerNorm needs complete rows, so a block owns 96 whole rows
// of x and walks every column of the output.  The rows are loaded once into
// shared memory (cp.async, ragged rows zero-filled) and normalised there in
// place; 12,608 rows are 132 blocks, one wave on the H100's 132 SMs, so each
// row's statistics are taken once.  W then streams through a three-stage
// cp.async ring of 128 x 64 tiles, one ring across all the N tiles, and each
// of the 8 warps accumulates a 48 x 32 sub-tile with mma.sync m16n8k16 (bf16
// in, fp32 accumulate), as in the fc1 kernel.  After the last K step of an N
// tile the epilogue adds b in fp32, rounds once and stores from the
// registers (two bf16 a thread, 16 contiguous bytes a row per quad).
#include "common.cuh"

namespace {

constexpr int kBM = 96;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kLdW = kBK + 8;  // padded shared row of a W tile
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kTileW = kBN * kLdW;
constexpr int kWarpM = 48;     // rows per warp: 3 m16 tiles; warps as 2 x 4
constexpr int kMT = kWarpM / 16;

size_t ln_linear_smem_bytes(int K) {
  return (static_cast<size_t>(kBM) * (K + 8) + kStages * kTileW) * sizeof(bf16);
}

__global__ void __launch_bounds__(kThreads)
ln_linear_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_t, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int K, int N,
                 float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_x = K + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // kBM rows of K, normalised in place
  bf16* ws = xs + kBM * ld_x;                // kStages W tiles

  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / 4) * kWarpM;  // warp's rows in the block
  const int wn = (warp % 4) * 32;      // warp's columns in the N tile
  const int k_steps = K / kBK;
  const int total = ((N + kBN - 1) / kBN) * k_steps;  // steps of the one W ring

  auto load_w = [&](int step) {  // step -> rows n0 .. n0 + 127, columns k0 .. k0 + 63 of W
    bf16* dst = ws + (step % kStages) * kTileW;
    const int n0 = (step / k_steps) * kBN;
    const int k0 = (step % k_steps) * kBK;
    for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      const bool ok = n0 + r < N;
      cp_async_16(dst + r * kLdW + c, ok ? w + static_cast<long>(n0 + r) * K + k0 + c : w,
                  ok ? 16 : 0);
    }
  };

  // cp.async groups, oldest first: {x rows, W step 0}, {W step 1}, then one
  // per step of the main loop (empty past the end).
  for (int i = threadIdx.x; i < kBM * (K / 8); i += kThreads) {
    const int r = i / (K / 8);
    const int c = (i % (K / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async_16(xs + r * ld_x + c, ok ? x + static_cast<long>(m0 + r) * K + c : x, ok ? 16 : 0);
  }
  load_w(0);
  cp_async_commit();
  if (total > 1) load_w(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  layernorm_rows_in_place(xs, ld_x, kBM, K, ln_s, ln_t, eps);

  const int a_row = wm + (lane % 16);
  const int a_col = (lane / 16) * 8;
  const int b_row = wn + (lane / 16) * 8 + (lane % 8);
  const int b_col = ((lane / 8) % 2) * 8;
  float acc[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int step = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // W step `step` is in (and, at step 0, the rows are normalised)
    if (step + kStages - 1 < total) load_w(step + kStages - 1);
    cp_async_commit();
    const bf16* tile = ws + (step % kStages) * kTileW;
    const int k0 = (step % k_steps) * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) ldmatrix_x4(a[i], xs + (a_row + i * 16) * ld_x + k0 + kk + a_col);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, tile + (b_row + j * 8) * kLdW + kk + b_col);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma_16816(acc[i][j], a[i], b[0], b[1]);
          mma_16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (step % k_steps != k_steps - 1) continue;

    // The N tile is complete: + b in fp32, one rounding, out of the registers.
    const int n0 = (step / k_steps) * kBN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      const bool col_ok = col < N;  // N is a multiple of 8, so col + 1 < N too
      const float b0 = col_ok ? __bfloat162float(bias[col]) : 0.0f;
      const float b1 = col_ok ? __bfloat162float(bias[col + 1]) : 0.0f;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm + i * 16 + g + 8 * half;
          if (col_ok && row < M)
            *reinterpret_cast<uint32_t*>(out + static_cast<long>(row) * N + col) =
                pack_floats(acc[i][j][2 * half] + b0, acc[i][j][2 * half + 1] + b1);
          acc[i][j][2 * half] = acc[i][j][2 * half + 1] = 0.0f;
        }
    }
  }
}

}  // namespace

// x: (M, K) bf16; ln_s, ln_t: (K,) fp32; w: (N, K) bf16; bias: (N,) bf16;
// out: (M, N) bf16.  K is a multiple of 64 up to 768, N a multiple of 8.
// Returns the launch's CUDA error.
extern "C" int ssl4polyp_ln_linear_fwd(const void* x, const void* ln_s, const void* ln_t,
                                       const void* w, const void* bias, void* out, int M, int K,
                                       int N, float eps, void* stream) {
  const size_t bytes = ln_linear_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      ln_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_linear_kernel<<<(M + kBM - 1) / kBM, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_t), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, K, N, eps);
  return static_cast<int>(cudaGetLastError());
}
