// The transformer MLP's first linear with its exact-erf GELU:
// y = gelu(x . w^T + b), and optionally h = x . w^T + b.
//
// Replaces: ssl4polyp_tpu/ops/mlp.py::_fc1_kernel (fc1_gelu).  Like the TPU
// kernel it writes the pre-activation h, rounded once to bf16, as the
// backward's residual when the caller asks for it (a non-null h); inference
// passes null and writes y only.  The backward is plain torch, as the JAX
// package leaves it to XLA.
//
// What bounds it on the H100: at the eval path's shape (M = 64*197 = 12,608,
// K = 768, NF = 3072) the product is 59.5 GFLOP against about 102 MB of
// bf16 traffic, some 590 FLOP per byte, well above the ~295 of the H100's
// data sheet ridge: it is bound by the tensor cores.  The GELU epilogue is
// free when fused, and it is what the fusion saves: in eval h never goes to
// HBM and back; in training it is written once for the backward.
//
// The simple design: a classic tiled GEMM on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate).  A block of 8 warps owns a 128x128 tile of y and walks
// K in steps of 64 through a three-stage cp.async ring in shared memory
// (rows padded by 8 elements, so that the ldmatrix reads are free of bank
// conflicts; the ragged M and NF edges are zero-filled by cp.async's source
// size).  Each warp accumulates a 64x32 sub-tile in registers, reading its
// fragments with ldmatrix.  The epilogue adds the bias in fp32, applies
// 0.5*h*(1+erf(h/sqrt(2))) with CUDA's erff to the fp32 h, rounds once to
// bf16 and stores (and stores h rounded to bf16 when asked).
// Both operands are K-contiguous (x row-major, w in torch's (out, in)
// layout), which is the layout mma.sync's row.col form wants.  On the H100
// this main loop, and not the GELU epilogue, holds the kernel under cuBLAS's
// wgmma GEMMs (PERF.md); wgmma with TMA loads is the later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarpN = 32;         // columns per warp; 8 warps as 2 x 4
constexpr int kBM = 128;
constexpr int kBN = 4 * kWarpN;
constexpr int kBK = 64;
constexpr int kLd = kBK + 8;  // padded smem row, in elements
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kTileA = kBM * kLd;
constexpr int kTileB = kBN * kLd;
constexpr size_t kSmemBytes = kStages * (kTileA + kTileB) * sizeof(bf16);

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives its mma fragment of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte global -> shared copy; copies `bytes` (0 or 16) and zero-fills the rest.
__device__ __forceinline__ void cp_async_16(bf16* dst, const bf16* src, int bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// Loads rows [row0, row0 + ROWS) x columns [k0, k0 + kBK) of a row-major
// (rows, K) matrix into a padded smem tile.
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows, int K,
                                          int row0, int k0) {
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8);
    const int c = (i % (kBK / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < rows && k0 + c < K;
    const bf16* p = ok ? src + static_cast<long>(row) * K + k0 + c : src;
    cp_async_16(dst + r * kLd + c, p, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
fc1_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ h, bf16* __restrict__ y,
                int M, int K, int NF) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);  // kStages tiles of x
  bf16* s_b = s_a + kStages * kTileA;         // kStages tiles of w

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / 4) * 64;  // warp's row offset in the tile
  const int wn = (warp % 4) * kWarpN;  // warp's column offset in the tile
  // ldmatrix row addresses: A as (rows 0-7 | 8-15) x (k 0-7 | 8-15); B as
  // (n-tile j, k 0-7), (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15).
  const int a_row = wm + (lane % 16);
  const int a_col = (lane / 16) * 8;
  const int b_row = wn + (lane / 16) * 8 + (lane % 8);
  const int b_col = ((lane / 8) % 2) * 8;

  constexpr int kNT = kWarpN / 8;  // n-tiles of 8 per warp
  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  const int steps = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_tile<kBM>(s_a + s * kTileA, x, M, K, m0, s * kBK);
      load_tile<kBN>(s_b + s * kTileB, w, NF, K, n0, s * kBK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // tile `step` is in; every warp is done with the slot refilled next
    const int next = step + kStages - 1;
    if (next < steps) {
      load_tile<kBM>(s_a + (next % kStages) * kTileA, x, M, K, m0, next * kBK);
      load_tile<kBN>(s_b + (next % kStages) * kTileB, w, NF, K, n0, next * kBK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const bf16* tile_a = s_a + (step % kStages) * kTileA;
    const bf16* tile_b = s_b + (step % kStages) * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], tile_a + (a_row + i * 16) * kLd + kk + a_col);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, tile_b + (b_row + j * 8) * kLd + kk + b_col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_16816(acc[i][j], a[i], b[0], b[1]);
          mma_16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= NF) continue;
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + g + 8 * half;
        if (row >= M) continue;
        const float h0 = acc[i][j][2 * half] + b0;
        const float h1 = acc[i][j][2 * half + 1] + b1;
        const long at = static_cast<long>(row) * NF + col;
        if (h != nullptr) *reinterpret_cast<uint32_t*>(h + at) = pack_floats(h0, h1);
        *reinterpret_cast<uint32_t*>(y + at) = pack_floats(gelu_erf(h0), gelu_erf(h1));
      }
    }
  }
}

}  // namespace

// x: (M, K) bf16; w: (NF, K) bf16; bias: (NF,) bf16; h (or null) and y:
// (M, NF) bf16.  K and NF are multiples of 8.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_fc1_gelu_fwd(const void* x, const void* w, const void* bias, void* h,
                                      void* y, int M, int K, int NF, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fc1_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((NF + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fc1_gelu_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(h), static_cast<bf16*>(y), M, K, NF);
  return static_cast<int>(cudaGetLastError());
}
