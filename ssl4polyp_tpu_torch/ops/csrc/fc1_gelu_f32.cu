// fc1 + exact-erf GELU in fp32: h = x . W^T + b, y = gelu(h), for the runs
// that compute in fp32 (`amp: false`, PretrainSettings.precision "fp32").
//
// Replaces: ssl4polyp_tpu/ops/mlp.py::_fc1_gelu_kernel (fc1_gelu) at
// compute_dtype float32, where the TPU kernel multiplies and accumulates in
// fp32.  The bf16 kernel (mlp.cu) runs on wgmma, which has no fp32 operand
// type, so this is a plain SIMT product: FFMA on the CUDA cores, fp32
// accumulation, no TF32 and no split into bf16 terms.
//
// What bounds it on the H100: at the classifier's shape (12608 x 768 x 3072)
// a call is 59.5 GFLOP against 0.2 GB of traffic (x, W, b in; h and y out),
// 0.89 ms at the 67 TFLOP/s fp32 rate: operations.  The design is the
// classic register-tiled SGEMM:
//   * A block of 256 threads computes a 128 x 128 tile of h, each thread an
//     8 x 8 sub-tile (two 4-row by two 4-column groups, so that its reads of
//     shared memory are 16-byte and the tile's stores are too), in 64
//     registers of accumulators.
//   * Both operands are K-major in memory (x rows, W rows).  A k-step of 8 is
//     one 16-byte load a thread from each, staged through registers and
//     stored transposed ([k][row]) into one of two shared buffers while the
//     other buffer's step is multiplied: one barrier a step.
//   * The epilogue adds b, writes h when asked (the backward's residual) and
//     y = 0.5 h (1 + erf(h / sqrt 2)) with erff, 16 bytes at a time.
// Each output is the fp32 FFMA chain over k in ascending order, so reruns
// give the same bits.  K is a multiple of 8, NF a multiple of 8 (the
// wrapper checks both); rows past M and columns past NF are masked.
#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 2)
fc1_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ h, float* __restrict__ y,
                    int M, int K, int NF) {
  __shared__ __align__(16) float s_a[2][kBK][kBM];
  __shared__ __align__(16) float s_b[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // The loader: row tid / 2 of each tile, k offsets (tid % 2) * 4 .. + 3.
  const int l_row = tid >> 1;
  const int l_k = (tid & 1) * 4;
  const bool a_ok = m0 + l_row < M;
  const bool b_ok = n0 + l_row < NF;
  const float* a_src = x + static_cast<long>(a_ok ? m0 + l_row : 0) * K + l_k;
  const float* b_src = w + static_cast<long>(b_ok ? n0 + l_row : 0) * K + l_k;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a_next = a_ok ? *reinterpret_cast<const float4*>(a_src) : zero;
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
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) {
      a_next = a_ok ? *reinterpret_cast<const float4*>(a_src + k0 + kBK) : zero;
      b_next = b_ok ? *reinterpret_cast<const float4*>(b_src + k0 + kBK) : zero;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
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
      if (col >= NF) continue;  // NF % 8 == 0: the group of 4 is whole
      const float4 bias = *reinterpret_cast<const float4*>(b + col);
      const float4 pre = make_float4(acc[i][4 * half] + bias.x, acc[i][4 * half + 1] + bias.y,
                                     acc[i][4 * half + 2] + bias.z, acc[i][4 * half + 3] + bias.w);
      const long at = static_cast<long>(row) * NF + col;
      if (h != nullptr) *reinterpret_cast<float4*>(h + at) = pre;
      *reinterpret_cast<float4*>(y + at) = make_float4(gelu_erf(pre.x), gelu_erf(pre.y),
                                                       gelu_erf(pre.z), gelu_erf(pre.w));
    }
  }
}

}  // namespace

// x: (M, K) fp32; w: (NF, K) fp32 (torch's (out, in) layout); b: (NF,) fp32;
// y: (M, NF) fp32; h: (M, NF) fp32 or null.  K and NF multiples of 8, every
// pointer 16-byte aligned.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_fc1_gelu_fwd_f32(const void* x, const void* w, const void* b, void* h,
                                          void* y, int M, int K, int NF, void* stream) {
  if (M < 1 || K < 8 || NF < 8 || K % 8 || NF % 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((NF + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fc1_gelu_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(h), static_cast<float*>(y), M, K, NF);
  return static_cast<int>(cudaGetLastError());
}
