// The QKV projection and the attention core in fp32, forward and backward:
// fused_qkvproj_attention for the runs that compute in fp32 (`amp: false`,
// PretrainSettings.precision "fp32").
//
// Replaces: ssl4polyp_tpu/ops/attention_block.py::_fwd_kernel and
// _bwd_kernel (fused_qkvproj_attention) at compute dtype float32, where
// every cast of the TPU kernels is a no-op: qkv = x . w + b with w (Din, 3D)
// in the JAX package's (in, out) layout, then the attention core; the
// backward recomputes qkv, runs the attention backward with the scale inside
// dS (attention_block.py:103), then dx = dqkv . w^T, dw = x^T dqkv and db =
// the sum of dqkv in fp32 over every row of the batch.  The bf16 kernel
// (attention_block.cu) runs on wgmma, which has no fp32 operand type, so
// this is a plain SIMT design: every product an FFMA on fp32 operands, fp32
// accumulation, no TF32 and no split into bf16 terms.
//
// What bounds it on the H100: at the classifier's shape (B 64, N 197, Din
// 768, 12 heads of 64) the forward is 52.2 GFLOP (the projection 44.6, the
// attention core 7.6), 0.78 ms at the 67 TFLOP/s fp32 rate; the backward
// 152.9 GFLOP (the recomputed projection, dx and dw 44.6 each, the attention
// backward 19.1), 2.28 ms: operations.  So it is built from the two fp32
// pieces that keep the FFMA units busiest, launch after launch on the
// stream, with the (B, N, 3D) qkv in a scratch of device memory (116 MB at
// that shape, written once and read once a direction: about 70 us of HBM
// time against the products' 0.67 ms each):
//   * Forward: qkv = x . w on the SGEMM of sgemm_f32.cuh, w the MN-major
//     operand as it lies; then the fp32 attention forward
//     (qkv_attention_f32.cu) with b as its bias, which adds it to each
//     staged tile as the plain version's x . w + b does (in fp32 the sum is
//     the same either way); with `lse` it writes each row's log-sum-exp,
//     which autograd saves with the output.
//   * Backward: qkv = x . w again; the fp32 attention backward in its
//     scaled_ds mode with b as its bias, from the saved output and
//     log-sum-exp, whose dbias (the sum of dqkv over every row) is db; dx =
//     dqkv . w^T on the SGEMM (w K-major as it lies); dw = x^T dqkv on its
//     split-K form (both operands MN-major), slices of the 12,608 rows summed
//     in slice order.  With forward_first the attention forward runs first,
//     for a caller without the output and log-sum-exp.
// No atomics anywhere: reruns give the same bits.  Head dims 32 and 64, any
// N; Din a multiple of 64 (the wrapper checks).
#include "qkv_attention_f32.cuh"
#include "sgemm_f32.cuh"

namespace {

constexpr int kAttentionTile = 64;  // qkv_attention_f32.cu's rows a dbias partial covers

bool shape_ok(int B, int N, int d_in, int H, int head_dim, int n_valid) {
  return B >= 1 && N >= 1 && H >= 1 && (head_dim == 32 || head_dim == 64) && n_valid >= 1 &&
         n_valid <= N && d_in >= 8 && d_in % 8 == 0 && static_cast<long>(B) * N < (1L << 31);
}

// qkv = x . w: x (M, Din) rows, w (Din, 3D) read as its transpose.
cudaError_t project(const void* x, const void* w, void* qkv, int M, int d_in, int three_d,
                    cudaStream_t stream) {
  return launch_sgemm_f32(k_major(RowLoad{static_cast<const float*>(x), d_in}, M),
                          MNMajor{static_cast<const float*>(w), three_d, three_d}, nullptr,
                          static_cast<float*>(qkv), d_in, stream);
}

}  // namespace

// x: (B, N, Din) fp32; w: (Din, 3D) fp32, (in, out); b: (3D,) fp32; qkv: (B,
// N, 3D) fp32 scratch; out: (B, N, D) fp32; lse: (B, H, N) fp32, each row's
// log-sum-exp for the backward, or null.  D = H * head_dim, hd 32 or 64,
// Din a multiple of 8, 1 <= n_valid <= N; scale: the fp32 1/sqrt(hd).
// Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_qkvproj_attention_fwd_f32(const void* x, const void* w, const void* b,
                                                   void* qkv, void* out, void* lse, int B, int N,
                                                   int d_in, int H, int head_dim, int n_valid,
                                                   float scale, void* stream) {
  if (!shape_ok(B, N, d_in, H, head_dim, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = static_cast<int>(
      project(x, w, qkv, B * N, d_in, 3 * H * head_dim, static_cast<cudaStream_t>(stream)));
  if (err) return err;
  return ssl4polyp_qkv_attention_fwd_f32(qkv, b, out, lse, B, N, H, head_dim, n_valid, scale,
                                         stream);
}

// x, w, b as for the forward; dout: (B, N, D) fp32; out, lse: the forward's
// output and log-sum-exp, or with forward_first scratch that the attention
// forward fills first; qkv: (B, N, 3D) fp32 scratch; delta: (B, H, N) fp32
// scratch; dqkv: (B, N, 3D) fp32 scratch; db_part: (B * ceil(N / 64), 3D)
// fp32 scratch; db: (3D,) fp32; dx: (B, N, Din) fp32; dw_part: (slices, Din,
// 3D) fp32 scratch (null with one slice), slices from
// ssl4polyp_sgemm_f32_slices(Din, 3D, B * N); dw: (Din, 3D) fp32.  Returns the
// first failing launch's CUDA error.
extern "C" int ssl4polyp_qkvproj_attention_bwd_f32(
    const void* x, const void* w, const void* b, const void* dout, void* out, void* lse,
    void* qkv, void* delta, void* dqkv, void* db_part, void* db, void* dx, void* dw_part, void* dw,
    int B, int N, int d_in, int H, int head_dim, int n_valid, float scale, int slices,
    int forward_first, void* stream) {
  if (!shape_ok(B, N, d_in, H, head_dim, n_valid) || slices < 1 || slices > kSgemmMaxSlices ||
      (slices > 1 && dw_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int M = B * N, three_d = 3 * H * head_dim;
  int err = static_cast<int>(project(x, w, qkv, M, d_in, three_d, st));
  if (err) return err;
  err = ssl4polyp_qkv_attention_bwd_f32(
      qkv, b, dout, out, lse, delta, dqkv, db_part, db,
      B * ((N + kAttentionTile - 1) / kAttentionTile), B, N, H, head_dim, n_valid, scale, 1,
      forward_first, stream);
  if (err) return err;
  const float* g = static_cast<const float*>(dqkv);
  // dx[m][i] = sum over j of dqkv[m][j] w[i][j]: both K-major as they lie.
  err = static_cast<int>(launch_sgemm_f32(
      k_major(RowLoad{g, three_d}, M),
      k_major(RowLoad{static_cast<const float*>(w), three_d}, d_in), nullptr,
      static_cast<float*>(dx), three_d, st));
  if (err) return err;
  // dw[i][j] = sum over m of x[m][i] dqkv[m][j], split over the rows m.
  return static_cast<int>(launch_sgemm_f32_split(
      MNMajor{static_cast<const float*>(x), d_in, d_in}, MNMajor{g, three_d, three_d},
      static_cast<float*>(dw_part), static_cast<float*>(dw), M, slices, st));
}
