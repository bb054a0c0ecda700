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
// classic register-tiled SGEMM of sgemm_f32.cuh (128 x 128 tiles, 8 x 8
// outputs a thread, k-steps of 8 through two shared buffers); the epilogue
// adds b, writes h when asked (the backward's residual) and y = 0.5 h (1 +
// erf(h / sqrt 2)) with erff, 16 bytes at a time.  Reruns give the same
// bits.  K is a multiple of 8, NF a multiple of 8 (the wrapper checks both);
// rows past M and columns past NF are masked.
#include "sgemm_f32.cuh"

namespace {

__global__ void __launch_bounds__(kSgemmThreads, 2)
fc1_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ h, float* __restrict__ y,
                    int M, int K, int NF) {
  sgemm_f32_tile(k_major(RowLoad{x, K}, M), k_major(RowLoad{w, K}, NF), 0, K,
                 [&](int row, int col, float4 acc) {
    const float4 bias = *reinterpret_cast<const float4*>(b + col);
    const float4 pre = make_float4(acc.x + bias.x, acc.y + bias.y, acc.z + bias.z,
                                   acc.w + bias.w);
    const long at = static_cast<long>(row) * NF + col;
    if (h != nullptr) *reinterpret_cast<float4*>(h + at) = pre;
    *reinterpret_cast<float4*>(y + at) = make_float4(gelu_erf(pre.x), gelu_erf(pre.y),
                                                     gelu_erf(pre.z), gelu_erf(pre.w));
  });
}

}  // namespace

// x: (M, K) fp32; w: (NF, K) fp32 (torch's (out, in) layout); b: (NF,) fp32;
// y: (M, NF) fp32; h: (M, NF) fp32 or null.  K and NF multiples of 8, every
// pointer 16-byte aligned.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_fc1_gelu_fwd_f32(const void* x, const void* w, const void* b, void* h,
                                          void* y, int M, int K, int NF, void* stream) {
  if (M < 1 || K < 8 || NF < 8 || K % 8 || NF % 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((NF + kSgemmBN - 1) / kSgemmBN, (M + kSgemmBM - 1) / kSgemmBM);
  fc1_gelu_f32_kernel<<<grid, kSgemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(h), static_cast<float*>(y), M, K, NF);
  return static_cast<int>(cudaGetLastError());
}
