// Attention with the output projection folded in, in fp32, forward and
// backward, for the runs that compute in fp32 (`amp: false`,
// PretrainSettings.precision "fp32") under BENCH_ATTN_PROJ=1.
//
// Replaces: ssl4polyp_tpu/ops/attn_proj.py::_fwd_kernel and _bwd_kernel
// (fused_attention_proj) at compute dtype float32, where every cast of the
// TPU kernels is a no-op: y = O . W + b with O the attention core's output;
// dO = dy . W^T, dW = O^T dy and db = sum of dy in fp32 over every row of the
// batch, then the attention backward on dO.  W is torch's (out, in) here.
// The bf16 kernel (attn_proj.cu) runs on wgmma, which has no fp32 operand
// type, so this is a plain SIMT design: every product an FFMA on fp32
// operands, fp32 accumulation, no TF32 and no split into bf16 terms.
//
// What bounds it on the H100: at the classifier's shape (B 64, N 197, 12
// heads of 64, D 768) the forward is 22.5 GFLOP (the attention core 7.6, the
// projection 14.9) against 0.19 GB of compulsory traffic, 0.336 ms at the 67
// TFLOP/s fp32 rate; the backward 48.8 GFLOP (the attention backward 19.1,
// dO and dW 14.9 each), 0.73 ms: operations.  So it is built from the two
// fp32 pieces that keep the FFMA units busiest, launch after launch on the
// stream (no kernel holds the (B, N, D) core output in shared memory: at
// 128-row tiles the projection reads each row of O once from L2 or HBM, 39
// MB, about 12 us of the 0.34 ms):
//   * Forward: the fp32 attention forward (qkv_attention_f32.cu) writes O and,
//     when a backward will follow, each row's log-sum-exp, which autograd
//     saves; then the SGEMM of sgemm_f32.cuh computes y = O . W^T + b (W
//     K-major as it lies, b added in the epilogue after the sum).
//   * Backward: dO = dy . W on the SGEMM (W the MN-major operand); dW = dy^T O
//     on its split-K form (both operands MN-major), slices of the 12,608 rows
//     summed in slice order; db = the column sums of dy over 64-row chunks,
//     then the chunks' sums in order; then the fp32 attention backward on dO
//     from the saved O and log-sum-exp (no recompute: with forward_first the
//     attention forward runs first into the same buffers, for a caller
//     without them).
// No atomics anywhere: reruns give the same bits.  Head dims 32 and 64, any
// N and any number of heads.
#include "qkv_attention_f32.cuh"
#include "sgemm_f32.cuh"

namespace {

constexpr int kDbRows = 64;     // rows of dy a partial column sum takes
constexpr int kDbThreads = 128;

// part[c][col] = sum of dy[r][col] over rows r of chunk c, r ascending.
__global__ void __launch_bounds__(kDbThreads)
column_partial_f32_kernel(const float* __restrict__ dy, int rows, int cols,
                          float* __restrict__ part) {
  const int col = blockIdx.x * kDbThreads + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * kDbRows, r1 = min(rows, r0 + kDbRows);
  float acc = 0.0f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) acc += dy[static_cast<long>(r) * cols + col];
  part[static_cast<long>(blockIdx.y) * cols + col] = acc;
}

bool shape_ok(int B, int N, int H, int head_dim, int n_valid) {
  return B >= 1 && N >= 1 && H >= 1 && (head_dim == 32 || head_dim == 64) && n_valid >= 1 &&
         n_valid <= N && static_cast<long>(B) * N < (1L << 31);
}

}  // namespace

// The slices the fp32 weight gradients' split-K product takes for a (rows,
// cols) gradient summed over K rows of the batch (attn_proj_f32.cu and
// attention_block_f32.cu): the wrapper sizes its (slices, rows, cols) fp32
// scratch with it.  Returns a count >= 1, or minus a CUDA error.
extern "C" int ssl4polyp_sgemm_f32_slices(int rows, int cols, int K) {
  int slices = 0;
  const cudaError_t err = sgemm_f32_slices(rows, cols, K, &slices);
  return err == cudaSuccess ? slices : -static_cast<int>(err);
}

// qkv: (B, N, 3D) fp32, the bias added; w: (D, D) fp32, torch's (out, in);
// b: (D,) fp32; o: (B, N, D) fp32, the core output (scratch, or kept for the
// backward); lse: (B, H, N) fp32, each row's log-sum-exp, or null; y: (B, N,
// D) fp32.  D = H * head_dim, hd 32 or 64, 1 <= n_valid <= N; scale: the
// fp32 1/sqrt(hd).  Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_attn_proj_fwd_f32(const void* qkv, const void* w, const void* b,
                                           void* o, void* lse, void* y, int B, int N, int H,
                                           int head_dim, int n_valid, float scale,
                                           void* stream) {
  if (!shape_ok(B, N, H, head_dim, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = ssl4polyp_qkv_attention_fwd_f32(qkv, nullptr, o, lse, B, N, H, head_dim,
                                                  n_valid, scale, stream);
  if (err) return err;
  const int M = B * N, D = H * head_dim;
  return static_cast<int>(launch_sgemm_f32(
      k_major(RowLoad{static_cast<const float*>(o), D}, M),
      k_major(RowLoad{static_cast<const float*>(w), D}, D), static_cast<const float*>(b),
      static_cast<float*>(y), D, static_cast<cudaStream_t>(stream)));
}

// qkv, w as for the forward; dy: (B, N, D) fp32; o, lse: the forward's core
// output and log-sum-exp, or with forward_first scratch that the attention
// forward fills first; delta: (B, H, N) fp32 scratch; d_o: (B, N, D) fp32
// scratch (dO); dqkv: (B, N, 3D) fp32; dw_part: (slices, D, D) fp32 scratch
// (null with one slice), slices from ssl4polyp_sgemm_f32_slices(D, D, B * N);
// dw: (D, D) fp32, (out, in); db_part: (ceil(B * N / 64), D) fp32 scratch;
// db: (D,) fp32.  Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_attn_proj_bwd_f32(const void* qkv, const void* w, const void* dy,
                                           void* o, void* lse, void* delta, void* d_o, void* dqkv,
                                           void* dw_part, void* dw, void* db_part, void* db,
                                           int B, int N, int H, int head_dim, int n_valid,
                                           float scale, int slices, int forward_first,
                                           void* stream) {
  if (!shape_ok(B, N, H, head_dim, n_valid) || slices < 1 || slices > kSgemmMaxSlices ||
      (slices > 1 && dw_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int M = B * N, D = H * head_dim;
  const float* g = static_cast<const float*>(dy);
  int err = 0;
  if (forward_first) {
    err = ssl4polyp_qkv_attention_fwd_f32(qkv, nullptr, o, lse, B, N, H, head_dim, n_valid,
                                          scale, stream);
    if (err) return err;
  }
  // dO[m][i] = sum over o of dy[m][o] W[o][i]: W read as its transpose.
  err = launch_sgemm_f32(k_major(RowLoad{g, D}, M),
                         MNMajor{static_cast<const float*>(w), D, D}, nullptr,
                         static_cast<float*>(d_o), D, st);
  if (err) return err;
  // dW[o][i] = sum over m of dy[m][o] O[m][i], split over the rows m.
  err = launch_sgemm_f32_split(MNMajor{g, D, D}, MNMajor{static_cast<const float*>(o), D, D},
                               static_cast<float*>(dw_part), static_cast<float*>(dw), M, slices,
                               st);
  if (err) return err;
  const int chunks = (M + kDbRows - 1) / kDbRows;
  column_partial_f32_kernel<<<dim3((D + kDbThreads - 1) / kDbThreads, chunks), kDbThreads, 0,
                              st>>>(g, M, D, static_cast<float*>(db_part));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = static_cast<int>(launch_column_sum<32>(static_cast<const float*>(db_part), chunks, D,
                                               static_cast<float*>(db), st));
  if (err) return err;
  return ssl4polyp_qkv_attention_bwd_f32(qkv, nullptr, d_o, o, lse, delta, dqkv, nullptr, nullptr,
                                         0, B, N, H, head_dim, n_valid, scale, 0, 0, stream);
}
