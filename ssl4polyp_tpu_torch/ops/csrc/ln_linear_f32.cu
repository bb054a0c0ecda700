// LayerNorm folded into the linear that follows it, in fp32:
// out = LN(x; s, t) . W^T + b, for the runs that compute in fp32 (`amp:
// false`, PretrainSettings.precision "fp32") under `qkv_ln_fusion`.
//
// Replaces: ssl4polyp_tpu/ops/ln_linear.py::_ln_linear_kernel (ln_linear) at
// compute_dtype float32, where every cast of the TPU kernel is a no-op: the
// statistics, the normalised row m = (x - mean) * rstd * s + t, the product
// and the bias add are all fp32, nothing rounded between them.  The bf16
// kernel (ln_linear.cu) runs on wgmma, which has no fp32 operand type, so
// this is a plain SIMT product: FFMA on the CUDA cores, no TF32 and no split
// into bf16 terms.
//
// What bounds it on the H100: at the classifier's QKV shape (12608 x 768 ->
// 2304) a call is 44.6 GFLOP against 0.17 GB of traffic (x, W, b in; the
// output out), 0.666 ms at the 67 TFLOP/s fp32 rate; at the MAE decoder's
// (12608 x 512 -> 1536) 19.8 GFLOP, 0.296 ms: operations.  Two launches:
//   1. The row statistics, one warp a row: x's row into registers (16-byte
//      pieces, at most 6 a lane), the mean, then the mean of (x - mean)^2
//      over the same registers (two passes, as the TPU kernel takes them),
//      rstd = rsqrt(var + eps); (mean, rstd) into the (M, 2) fp32 scratch the
//      wrapper allocates.  12608 x 768 reads 38.7 MB: about 12 us at HBM's
//      rate.
//   2. The register-tiled SGEMM of sgemm_f32.cuh (128 x 128 tiles, 8 x 8
//      outputs a thread), whose A loader turns each staged 16-byte piece of
//      x into m with its row's statistics and s, t of its columns before the
//      piece goes to shared memory; the epilogue adds b.  The normalised row
//      never goes to HBM.
// Each output is one FFMA chain over k in ascending order, so reruns give
// the same bits.  K is a multiple of 64 up to 768, N a multiple of 8 (the
// wrapper checks both); rows past M and columns past N are masked.
#include "sgemm_f32.cuh"

namespace {

constexpr int kStatsRows = 8;  // rows (warps) a statistics block
constexpr int kMaxPieces = 6;  // 16-byte pieces a lane holds: K <= 768 = 6 x 128

__global__ void __launch_bounds__(32 * kStatsRows)
ln_stats_f32_kernel(const float* __restrict__ x, float* __restrict__ stats, int M, int K,
                    float eps) {
  const int row = blockIdx.x * kStatsRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + static_cast<long>(row) * K;
  float4 v[kMaxPieces];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPieces; ++i) {
    const int c = 4 * lane + 128 * i;
    v[i] = c < K ? *reinterpret_cast<const float4*>(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(sum) / static_cast<float>(K);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPieces; ++i) {
    if (4 * lane + 128 * i >= K) continue;
    const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
    sq += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(K) + eps);
  if (lane == 0) *reinterpret_cast<float2*>(stats + 2 * static_cast<long>(row)) =
      make_float2(mean, rstd);
}

__global__ void __launch_bounds__(kSgemmThreads, 2)
ln_linear_f32_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ t, const float* __restrict__ stats,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, int M, int K, int N) {
  auto load_m = [&](int row, int k) {
    const float4 v = *reinterpret_cast<const float4*>(x + static_cast<long>(row) * K + k);
    const float2 st = *reinterpret_cast<const float2*>(stats + 2 * static_cast<long>(row));
    const float4 sc = *reinterpret_cast<const float4*>(s + k);
    const float4 sh = *reinterpret_cast<const float4*>(t + k);
    return make_float4((v.x - st.x) * st.y * sc.x + sh.x, (v.y - st.x) * st.y * sc.y + sh.y,
                       (v.z - st.x) * st.y * sc.z + sh.z, (v.w - st.x) * st.y * sc.w + sh.w);
  };
  sgemm_f32_tile(KMajor<decltype(load_m)>{load_m, M}, k_major(RowLoad{w, K}, N), 0, K,
                 [&](int row, int col, float4 acc) {
    const float4 bias = *reinterpret_cast<const float4*>(b + col);
    *reinterpret_cast<float4*>(out + static_cast<long>(row) * N + col) =
        make_float4(acc.x + bias.x, acc.y + bias.y, acc.z + bias.z, acc.w + bias.w);
  });
}

}  // namespace

// x: (M, K) fp32; ln_s, ln_t: (K,) fp32; w: (N, K) fp32 (torch's (out, in)
// layout); b: (N,) fp32; stats: (M, 2) fp32 scratch; out: (M, N) fp32.  K a
// multiple of 64 up to 768, N a multiple of 8, every pointer 16-byte
// aligned.  Returns the first launch error.
extern "C" int ssl4polyp_ln_linear_fwd_f32(const void* x, const void* ln_s, const void* ln_t,
                                           const void* w, const void* b, void* stats, void* out,
                                           int M, int K, int N, float eps, void* stream) {
  if (M < 1 || K < 64 || K % 64 || K > 128 * kMaxPieces || N < 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  ln_stats_f32_kernel<<<(M + kStatsRows - 1) / kStatsRows, 32 * kStatsRows, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(stats), M, K, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kSgemmBN - 1) / kSgemmBN, (M + kSgemmBM - 1) / kSgemmBM);
  ln_linear_f32_kernel<<<grid, kSgemmThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_t), static_cast<const float*>(stats),
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(out), M, K,
      N);
  return static_cast<int>(cudaGetLastError());
}
