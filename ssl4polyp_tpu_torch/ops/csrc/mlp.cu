// The transformer MLP's kernels.  First, fc1 with its exact-erf GELU:
// y = gelu(x . w^T + b), and optionally h = x . w^T + b; second (below), the
// whole MLP in one kernel, fc1 + GELU + fc2, optionally behind a LayerNorm
// prologue and with the block's residual folded in.
//
// fc1+GELU replaces: ssl4polyp_tpu/ops/mlp.py::_fc1_kernel (fc1_gelu).  Like the TPU
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
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `step` is in; every warp is done with the slot refilled next
    const int next = step + kStages - 1;
    if (next < steps) {
      load_tile<kBM>(s_a + (next % kStages) * kTileA, x, M, K, m0, next * kBK);
      load_tile<kBN>(s_b + (next % kStages) * kTileB, w, NF, K, n0, next * kBK);
    }
    cp_async_commit();
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


// ---------------------------------------------------------------------------
// fc1 + GELU + fc2 in one kernel:
//   h = x . W1^T + b1 (fp32, written in bf16 when h is not null),
//   g = gelu(h) in fp32, rounded to bf16 and kept in shared memory,
//   out = sum over NF of g . W2^T in fp32, + b2, rounded once;
// with a LayerNorm prologue (ln_s not null) x is first replaced, in shared
// memory, by m = LN(x) * s + t rounded to bf16, and the epilogue adds the
// residual: out = (x + acc) + b2, in fp32, rounded once.
//
// Replaces: ssl4polyp_tpu/ops/mlp.py::_mlp_kernel (mlp_fused) and
// _mlp_ln_kernel (mlp_ln_fused).  The backwards are plain torch, as the JAX
// package leaves them to XLA.
//
// What bounds it on the H100: at the fine-tune shape (M = 64*197 = 12,608,
// K = 768, NF = 3072) the two products are 119 GFLOP; what the fusion saves
// is g's HBM round trip (2 x 77 MB).  The fp32 output accumulator (rows x K)
// lives across the whole NF loop, so a block can own few rows: 32 rows of
// 768 fp32 values are 96 registers a thread over 256 threads.  Every block
// therefore streams all of W1 and W2 (9.4 MB at K 768) through L2 for its
// 32 rows, about 3.7 GB of L2 reads per call: the L2 bandwidth, not the
// tensor cores, bounds this design.  wgmma with larger row tiles (the
// accumulator split over a cluster's blocks) is the later work.
//
// The design: one block of 8 warps owns 32 rows of x, resident in shared
// memory (normalised there for the LN variant).  It walks NF in tiles of 32
// hidden features.  fc1 (warp tile 16 x 8, mma.sync m16n8k16, fp32
// accumulate) reads the tile's 32 rows of W1 from shared memory; the
// epilogue adds b1, stages h and g in shared memory and stores the h tile in
// 16-byte rows.  fc2 (warp tile 32 rows x K/8 columns) adds g . W2tile^T
// into the register accumulator.  The W1 tile for step j + 1 loads (cp.async)
// while fc2 of step j runs, and the W2 tile for step j + 1 while fc1 of
// step j + 1 runs.  At the end the accumulator is staged in fp32 through
// shared memory, and the epilogue adds b2 (and x) and stores 16-byte rows.
// No atomics: each output element is summed by one thread in a fixed
// order, so reruns give the same bits.
// ---------------------------------------------------------------------------

constexpr int kFRows = 32;          // rows of x per block
constexpr int kFTile = 32;          // hidden features per step of the NF loop
constexpr int kFLd = kFTile + 8;    // padded shared row of the W2, h and g tiles
constexpr int kFThreads = 256;

template <int K>
constexpr size_t mlp_fused_smem_bytes() {
  return static_cast<size_t>(kFRows * (K + 8)   // x rows (normalised for the LN variant)
                             + kFTile * (K + 8)  // the W1 tile: 32 rows of K
                             + K * kFLd          // the W2 tile: K rows of 32
                             + 2 * kFRows * kFLd)  // the h and g tiles
         * sizeof(bf16);
}

template <int K, bool LN>
__global__ void __launch_bounds__(kFThreads)
mlp_fused_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_t, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, bf16* __restrict__ h, bf16* __restrict__ out,
                 int M, int NF, float eps) {
  constexpr int kLdX = K + 8;
  constexpr int kLdS = K + 4;     // fp32 staging row of the output
  constexpr int kWarpCols = K / 8;  // fc2 output columns per warp
  constexpr int kNT = kWarpCols / 8;  // n8 tiles per warp in fc2
  static_assert(K % 128 == 0, "K must be a multiple of 128");
  static_assert(kFRows * kLdS * sizeof(float) <= (kFTile * kLdX + K * kFLd) * sizeof(bf16),
                "the fp32 output stage must fit where the weight tiles were");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = xs + kFRows * kLdX;
  bf16* w2s = w1s + kFTile * kLdX;
  bf16* hs = w2s + K * kFLd;
  bf16* gs = hs + kFRows * kFLd;
  float* stage = reinterpret_cast<float*>(w1s);  // after the NF loop only

  const int m0 = blockIdx.x * kFRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  auto load_x = [&]() {
    for (int i = threadIdx.x; i < kFRows * (K / 8); i += kFThreads) {
      const int r = i / (K / 8);
      const int c = (i % (K / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async_16(xs + r * kLdX + c, ok ? x + static_cast<long>(m0 + r) * K + c : x, ok ? 16 : 0);
    }
  };
  auto load_w1 = [&](int f0) {  // rows f0 .. f0 + 31 of W1 (NF, K)
    for (int i = threadIdx.x; i < kFTile * (K / 8); i += kFThreads) {
      const int r = i / (K / 8);
      const int c = (i % (K / 8)) * 8;
      cp_async_16(w1s + r * kLdX + c, w1 + static_cast<long>(f0 + r) * K + c, 16);
    }
  };
  auto load_w2 = [&](int f0) {  // columns f0 .. f0 + 31 of W2 (K, NF)
    for (int i = threadIdx.x; i < K * (kFTile / 8); i += kFThreads) {
      const int r = i / (kFTile / 8);
      const int c = (i % (kFTile / 8)) * 8;
      cp_async_16(w2s + r * kFLd + c, w2 + static_cast<long>(r) * NF + f0 + c, 16);
    }
  };

  // cp.async groups, oldest first: {x, W1 tile 0}, {W2 tile 0}; then in step
  // j: {W1 tile j + 1} after fc1, {W2 tile j + 1} after fc2 (empty past the end).
  load_x();
  load_w1(0);
  cp_async_commit();
  load_w2(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (LN) {
    layernorm_rows_in_place(xs, kLdX, kFRows, K, ln_s, ln_t, eps);
    __syncthreads();
  }

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.0f;

  // fc1 warp tile: rows (warp / 4) * 16 .. + 15, tile features (warp % 4) * 8 .. + 7.
  const int h_row = (warp / 4) * 16;
  const int h_col = (warp % 4) * 8;
  const int a_row = h_row + (lane % 16);
  const int a_col = (lane / 16) * 8;
  const int b1_row = h_col + (lane % 8);
  const int b1_col = ((lane / 8) % 2) * 8;
  // fc2 warp tile: all 32 rows, output columns warp * K/8 .. + K/8 - 1.
  const int wn = warp * kWarpCols;
  const int b2_row = wn + (lane / 16) * 8 + (lane % 8);
  const int b2_col = ((lane / 8) % 2) * 8;

  const int tiles = NF / kFTile;
  for (int j = 0; j < tiles; ++j) {
    const int f0 = j * kFTile;
    float hacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t a[4], b[2];
      ldmatrix_x4(a, xs + a_row * kLdX + kk + a_col);
      ldmatrix_x2(b, w1s + b1_row * kLdX + kk + b1_col);
      mma_16816(hacc, a, b[0], b[1]);
    }
    __syncthreads();  // every warp is done with the W1 tile
    if (j + 1 < tiles) load_w1(f0 + kFTile);
    cp_async_commit();

    const int col = h_col + 2 * t;
    const float bias0 = __bfloat162float(b1[f0 + col]);
    const float bias1 = __bfloat162float(b1[f0 + col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = h_row + g + 8 * half;
      const float h0 = hacc[2 * half] + bias0;
      const float h1 = hacc[2 * half + 1] + bias1;
      *reinterpret_cast<uint32_t*>(hs + row * kFLd + col) = pack_floats(h0, h1);
      *reinterpret_cast<uint32_t*>(gs + row * kFLd + col) = pack_floats(gelu_erf(h0), gelu_erf(h1));
    }
    cp_async_wait<1>();  // the W2 tile j (the W1 tile j + 1 may still be in flight)
    __syncthreads();     // h, g and the W2 tile are complete

    if (h != nullptr && threadIdx.x < kFRows * (kFTile / 8)) {  // 32 rows of 64 bytes
      const int r = threadIdx.x / (kFTile / 8);
      const int c = (threadIdx.x % (kFTile / 8)) * 8;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(h + static_cast<long>(m0 + r) * NF + f0 + c) =
            *reinterpret_cast<const uint4*>(hs + r * kFLd + c);
    }
#pragma unroll
    for (int kk = 0; kk < kFTile; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], gs + (i * 16 + (lane % 16)) * kFLd + kk + a_col);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, w2s + (b2_row + n * 8) * kFLd + kk + b2_col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][n], a[i], b[0], b[1]);
          mma_16816(acc[i][n + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the W2 tile, h and g
    if (j + 1 < tiles) load_w2(f0 + kFTile);
    cp_async_commit();
    cp_async_wait<1>();  // the W1 tile j + 1
    __syncthreads();
  }

  // The fp32 accumulator through shared memory, then 16-byte rows out.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i * 16 + g + 8 * half;
        *reinterpret_cast<float2*>(stage + row * kLdS + wn + n * 8 + 2 * t) =
            make_float2(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
      }
  __syncthreads();
  for (int i = threadIdx.x; i < kFRows * (K / 8); i += kFThreads) {
    const int r = i / (K / 8);
    const int c = (i % (K / 8)) * 8;
    if (m0 + r >= M) continue;
    const float4 lo = *reinterpret_cast<const float4*>(stage + r * kLdS + c);
    const float4 hi = *reinterpret_cast<const float4*>(stage + r * kLdS + c + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const uint4 bq = *reinterpret_cast<const uint4*>(b2 + c);
    const bf16* bv = reinterpret_cast<const bf16*>(&bq);
    const long at = static_cast<long>(m0 + r) * K + c;
    if (LN) {
      const uint4 xq = *reinterpret_cast<const uint4*>(x + at);
      const bf16* xv = reinterpret_cast<const bf16*>(&xq);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(xv[e]) + v[e];
    }
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[e] = pack_floats(v[2 * e] + __bfloat162float(bv[2 * e]),
                          v[2 * e + 1] + __bfloat162float(bv[2 * e + 1]));
    *reinterpret_cast<uint4*>(out + at) = o;
  }
}

template <int K, bool LN>
cudaError_t launch_mlp_fused(const bf16* x, const float* ln_s, const float* ln_t, const bf16* w1,
                             const bf16* b1, const bf16* w2, const bf16* b2, bf16* h, bf16* out,
                             int M, int NF, float eps, cudaStream_t stream) {
  constexpr size_t bytes = mlp_fused_smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(mlp_fused_kernel<K, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  mlp_fused_kernel<K, LN><<<(M + kFRows - 1) / kFRows, kFThreads, bytes, stream>>>(
      x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t dispatch_mlp_fused(int K, const bf16* x, const float* ln_s, const float* ln_t,
                               const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                               bf16* h, bf16* out, int M, int NF, float eps, cudaStream_t stream) {
  switch (K) {
    case 512: return launch_mlp_fused<512, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, stream);
    case 768: return launch_mlp_fused<768, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, stream);
    default: return cudaErrorInvalidValue;
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

// x: (M, K) bf16; ln_s, ln_t: (K,) fp32, or both null for no LayerNorm
// prologue (and no residual); w1: (NF, K), b1: (NF,), w2: (K, NF), b2: (K,)
// bf16; h (or null): (M, NF) bf16; out: (M, K) bf16.  K is 512 or 768 (the
// MAE decoder's and ViT-B's widths) and NF a multiple of 32.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_mlp_fused_fwd(const void* x, const void* ln_s, const void* ln_t,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* h, void* out, int M, int K, int NF,
                                       float eps, void* stream) {
  const auto* xb = static_cast<const bf16*>(x);
  const auto* s = static_cast<const float*>(ln_s);
  const auto* t = static_cast<const float*>(ln_t);
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* b1b = static_cast<const bf16*>(b1);
  const auto* w2b = static_cast<const bf16*>(w2);
  const auto* b2b = static_cast<const bf16*>(b2);
  auto* hb = static_cast<bf16*>(h);
  auto* ob = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      s == nullptr
          ? dispatch_mlp_fused<false>(K, xb, s, t, w1b, b1b, w2b, b2b, hb, ob, M, NF, eps, st)
          : dispatch_mlp_fused<true>(K, xb, s, t, w1b, b1b, w2b, b2b, hb, ob, M, NF, eps, st);
  return static_cast<int>(err);
}
