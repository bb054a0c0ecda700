// LayerNorm over the last axis of a bf16 (M, D) activation, forward and
// backward, with fp32 statistics and fp32 affine parameters.
//
// Replaces: ssl4polyp_tpu/ops/layernorm.py::_fwd_kernel and _bwd_kernel (the
// 3-D variants), _fwd2_kernel and _bwd2_kernel (the 2-D variants), and so
// layernorm_fused_view too: LayerNorm does not depend on the order of the
// rows, so one kernel over M rows covers every shape.
//
// What bounds it on the H100: a few FLOPs per element against 4 (forward) or
// 6 (backward) bytes of bf16 traffic per element: HBM bandwidth.  The design
// reads each row once and writes once: one warp owns a row, holds it in
// registers (D / 32 values a lane), and takes the two-pass fp32 mean and
// variance from registers with warp shuffles, as the TPU kernel takes them
// from VMEM.  Loads and stores are 16 bytes a lane.
//
// The backward recomputes the statistics (nothing but x is saved), writes dx
// in bf16 and sums dscale = sum(dy * xhat) and dbias = sum(dy) over every row
// in fp32.  The TPU kernel carried those sums across its sequential grid; here
// blocks run in parallel, so each block of 16 rows writes its partial sums
// (its warps added in warp order) and column_sum_kernel adds the partials in
// block order: the result does not depend on scheduling.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBwdRowsPerWarp = 2;
constexpr int kBwdRows = kWarps * kBwdRowsPerWarp;  // rows per backward block

// Loads lane's chunks (chunk c = lane + 32 i covers columns 8c .. 8c+7) of a
// bf16 row into fp32 registers; chunks past D are zero.
template <int CHUNKS>
__device__ __forceinline__ void load_row(float (&v)[CHUNKS][8], const bf16* row, int D, int lane) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    uint4 chunk = make_uint4(0, 0, 0, 0);
    if (c < D) chunk = *reinterpret_cast<const uint4*>(row + c);
    const bf16* e = reinterpret_cast<const bf16*>(&chunk);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = __bfloat162float(e[j]);
  }
}

template <int CHUNKS>
__device__ __forceinline__ void store_row(bf16* row, const float (&v)[CHUNKS][8], int D, int lane) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= D) continue;
    uint4 chunk;
    uint32_t* p = reinterpret_cast<uint32_t*>(&chunk);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = pack_floats(v[i][2 * j], v[i][2 * j + 1]);
    *reinterpret_cast<uint4*>(row + c) = chunk;
  }
}

template <int CHUNKS>
__device__ __forceinline__ void load_params(float (&v)[CHUNKS][8], const float* p, int D, int lane) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (c < D) {
      lo = *reinterpret_cast<const float4*>(p + c);
      hi = *reinterpret_cast<const float4*>(p + c + 4);
    }
    v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = lo.z; v[i][3] = lo.w;
    v[i][4] = hi.x; v[i][5] = hi.y; v[i][6] = hi.z; v[i][7] = hi.w;
  }
}

// Two-pass fp32 statistics of a row held in registers: mean, then the mean
// of the squared deviations (the TPU kernel's order).  Chunks past D hold
// zeros and are left out of the second sum.
template <int CHUNKS>
__device__ __forceinline__ void row_stats(const float (&v)[CHUNKS][8], int D, int lane, float eps,
                                          float& mean, float& rstd) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[i][j];
  mean = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if ((lane + 32 * i) * 8 >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = v[i][j] - mean;
      sq += d * d;
    }
  }
  rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
}

template <int CHUNKS>
__global__ void __launch_bounds__(32 * kWarps)
layernorm_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ weight,
                     const float* __restrict__ bias, bf16* __restrict__ y, int M, int D, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= M) return;  // no barrier in this kernel
  float v[CHUNKS][8];
  load_row<CHUNKS>(v, x + static_cast<long>(row) * D, D, lane);
  float mean, rstd;
  row_stats<CHUNKS>(v, D, lane, eps, mean, rstd);
  float w[CHUNKS][8], b[CHUNKS][8];
  load_params<CHUNKS>(w, weight, D, lane);
  load_params<CHUNKS>(b, bias, D, lane);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = (v[i][j] - mean) * rstd * w[i][j] + b[i][j];
  store_row<CHUNKS>(y + static_cast<long>(row) * D, v, D, lane);
}

// part: (gridDim.x, 2, D) fp32; row blk holds this block's [dscale | dbias].
// dres (or null) is added to dx in fp32 before its one rounding: the
// gradient of a residual folded into the consumer (mlp_ln_fused).
template <int CHUNKS>
__global__ void __launch_bounds__(32 * kWarps)
layernorm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const bf16* __restrict__ dres, const float* __restrict__ weight,
                     bf16* __restrict__ dx, float* __restrict__ part, int M, int D, float eps) {
  extern __shared__ __align__(16) float s_acc[];  // [2][D]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float w[CHUNKS][8];
  load_params<CHUNKS>(w, weight, D, lane);
  float acc_s[CHUNKS][8], acc_b[CHUNKS][8];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_s[i][j] = acc_b[i][j] = 0.0f;

#pragma unroll
  for (int k = 0; k < kBwdRowsPerWarp; ++k) {
    const int row = blockIdx.x * kBwdRows + k * kWarps + warp;
    if (row >= M) break;
    float v[CHUNKS][8], g[CHUNKS][8];
    load_row<CHUNKS>(v, x + static_cast<long>(row) * D, D, lane);
    load_row<CHUNKS>(g, dy + static_cast<long>(row) * D, D, lane);
    float mean, rstd;
    row_stats<CHUNKS>(v, D, lane, eps, mean, rstd);
    // v <- xhat, then dxhat = dy * w; m1 = mean(dxhat), m2 = mean(dxhat * xhat).
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = (v[i][j] - mean) * rstd;
        const float dxhat = g[i][j] * w[i][j];
        m1 += dxhat;
        m2 += dxhat * v[i][j];
      }
    m1 = warp_sum(m1) / static_cast<float>(D);
    m2 = warp_sum(m2) / static_cast<float>(D);
    float out[CHUNKS][8];
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[i][j] = rstd * (g[i][j] * w[i][j] - m1 - v[i][j] * m2);
        acc_s[i][j] += g[i][j] * v[i][j];
        acc_b[i][j] += g[i][j];
      }
    if (dres != nullptr) {
      load_row<CHUNKS>(g, dres + static_cast<long>(row) * D, D, lane);
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) out[i][j] += g[i][j];
    }
    store_row<CHUNKS>(dx + static_cast<long>(row) * D, out, D, lane);
  }

  // The block's partial sums: warps add theirs in warp order.
  for (int turn = 0; turn < kWarps; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int c = (lane + 32 * i) * 8;
        if (c >= D) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s_acc[c + j] = turn == 0 ? acc_s[i][j] : s_acc[c + j] + acc_s[i][j];
          s_acc[D + c + j] = turn == 0 ? acc_b[i][j] : s_acc[D + c + j] + acc_b[i][j];
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<long>(blockIdx.x) * 2 * D;
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) out[c] = s_acc[c];
}

template <int CHUNKS>
cudaError_t launch_fwd(const bf16* x, const float* w, const float* b, bf16* y, int M, int D,
                       float eps, cudaStream_t stream) {
  layernorm_fwd_kernel<CHUNKS><<<(M + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
      x, w, b, y, M, D, eps);
  return cudaGetLastError();
}

template <int CHUNKS>
cudaError_t launch_bwd(const bf16* x, const bf16* dy, const bf16* dres, const float* w, bf16* dx,
                       float* part, float* dparams, int M, int D, float eps,
                       cudaStream_t stream) {
  const int blocks = (M + kBwdRows - 1) / kBwdRows;
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  layernorm_bwd_kernel<CHUNKS><<<blocks, 32 * kWarps, smem, stream>>>(x, dy, dres, w, dx, part, M,
                                                                        D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sum(part, blocks, 2 * D, dparams, stream);
}

// Calls fn with std::integral_constant<int, CHUNKS>, the number of 8-element
// chunks a lane holds for rows of D columns (D <= 32 * 8 * 8 = 2048).
template <typename Fn>
cudaError_t dispatch_chunks(int D, Fn fn) {
  switch ((D + 255) / 256) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (M, D) bf16; weight, bias: (D,) fp32; D a multiple of 8, at most
// 2048.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_layernorm_fwd(const void* x, const void* weight, const void* bias,
                                       void* y, int M, int D, float eps, void* stream) {
  if (M < 1 || D < 8 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_chunks(D, [&](auto chunks) {
    return launch_fwd<decltype(chunks)::value>(
        static_cast<const bf16*>(x), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<bf16*>(y), M, D, eps,
        static_cast<cudaStream_t>(stream));
  }));
}

// x, dy, dx and dres (or null): (M, D) bf16; weight: (D,) fp32; part:
// (ceil(M / 16), 2, D) fp32 scratch; dparams: (2, D) fp32, [dweight | dbias]
// summed over all M rows.  Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_layernorm_bwd(const void* x, const void* dy, const void* dres,
                                       const void* weight, void* dx, void* part, void* dparams,
                                       int M, int D, float eps, void* stream) {
  if (M < 1 || D < 8 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_chunks(D, [&](auto chunks) {
    return launch_bwd<decltype(chunks)::value>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
        static_cast<const bf16*>(dres), static_cast<const float*>(weight),
        static_cast<bf16*>(dx), static_cast<float*>(part), static_cast<float*>(dparams), M, D,
        eps, static_cast<cudaStream_t>(stream));
  }));
}
