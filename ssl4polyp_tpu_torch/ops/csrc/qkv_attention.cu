// Attention straight from the fused QKV projection, forward and backward.
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel and _bwd_kernel
// (fused_qkv_attention), and ::_fwd_bias_kernel and _bwd_bias_kernel
// (fused_qkv_bias_attention); the optional bias argument covers the second.
// The backward's design is described above qkv_attention_bwd_kernel and
// attention_core.cuh's attention_backward_tiles.
//
// What bounds it on the H100: at the eval path's shape (B 64, N 197, 12 heads
// of 64) a call is 7.6 GFLOP against 78 MB of compulsory traffic (QKV in,
// output out), about 100 FLOP per byte, below the ~295 of the H100's data
// sheet ridge: the floor is HBM traffic.  At ViT lengths (N <= 256)
// one (batch, head) pair's keys and values fit in shared memory, so the
// (N, N) scores never leave the SM.  The TPU kernel stacked heads to
// amortise its fixed per-dot overhead; here every block simply owns one
// (batch, head, 64-query tile) and the 132 SMs run thousands of such blocks.
// Each query tile re-reads its head's K and V (from L2 after the first), and
// the staging loads (eight 16-byte chunks in flight per thread, since the
// bias add keeps them from being cp.async copies) are not overlapped with
// the products: this simple form is bound by load latency more than by
// either roofline.
//
// The simple design: one block of 4 warps per (query tile of 64 rows, head,
// batch row).  The block copies the head's Q tile, all of K and all of V
// from the (B, N, 3D) input into shared memory (adding the bias and folding
// the 1/sqrt(hd) scale into Q in bf16, as the TPU kernel does), zero-padding
// keys to a multiple of 16.  Each warp then owns 16 query rows: it forms the
// whole score row in registers with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), masks keys >= valid_len to -inf, optionally rounds the
// scores to bf16, takes an exact softmax over the full row (no online
// rescaling is needed because the row is whole), rounds the weights to bf16
// and multiplies by V with mma.sync.  The score fragments are reused as the
// A operand of the second product without leaving registers.  Later work:
// ldmatrix, cp.async or TMA loads, and wgmma.
#include "attention_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTileRows = 16 * kWarps;  // query rows per block

// NKT: key tiles of 16; the kernel takes N <= 16 * NKT.
template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kWarps)
qkv_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                     bf16* __restrict__ out, int N, int H, int n_valid, float scale,
                     int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kTileRows * kLd;
  bf16* s_v = s_k + kPad * kLd;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int D = H * HD;
  const long ld = 3L * D;
  const bf16* base = qkv + static_cast<long>(b) * N * ld + h * HD;
  const bf16* bias_q = bias == nullptr ? nullptr : bias + h * HD;
  const bf16* bias_k = bias == nullptr ? nullptr : bias + D + h * HD;
  const bf16* bias_v = bias == nullptr ? nullptr : bias + 2 * D + h * HD;
  stage_rows<HD>(s_q, kTileRows, base, q0, N, ld, bias_q, scale, true);
  stage_rows<HD>(s_k, kPad, base + D, 0, N, ld, bias_k, 1.0f, false);
  stage_rows<HD>(s_v, kPad, base + 2 * D, 0, N, ld, bias_v, 1.0f, false);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = warp * 16;
  if (q0 + r0 >= N) return;  // no barrier follows

  float o[HD / 8][4];
  attention_rows<HD, NKT>(s_q, s_k, s_v, r0, lane, n_valid, softmax_f32, o);

  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  bf16* out_a = out + (static_cast<long>(b) * N + row_a) * D + h * HD + 2 * t;
  bf16* out_b = out_a + 8L * D;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row_a < N) *reinterpret_cast<uint32_t*>(out_a + n * 8) = pack_floats(o[n][0], o[n][1]);
    if (row_b < N) *reinterpret_cast<uint32_t*>(out_b + n * 8) = pack_floats(o[n][2], o[n][3]);
  }
}

template <int HD, int NKT>
cudaError_t launch(const bf16* qkv, const bf16* bias, bf16* out, int B, int N, int H,
                   int n_valid, float scale, int softmax_f32, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTileRows + 2 * NKT * 16) * (HD + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileRows - 1) / kTileRows, H, B);
  qkv_attention_kernel<HD, NKT><<<grid, 32 * kWarps, smem, stream>>>(
      qkv, bias, out, N, H, n_valid, scale, softmax_f32);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_head_dim(const bf16* qkv, const bf16* bias, bf16* out, int B, int N,
                            int H, int n_valid, float scale, int softmax_f32,
                            cudaStream_t stream) {
  if (N <= 64) return launch<HD, 4>(qkv, bias, out, B, N, H, n_valid, scale, softmax_f32, stream);
  if (N <= 128) return launch<HD, 8>(qkv, bias, out, B, N, H, n_valid, scale, softmax_f32, stream);
  if (N <= 208) return launch<HD, 13>(qkv, bias, out, B, N, H, n_valid, scale, softmax_f32, stream);
  if (N <= 256) return launch<HD, 16>(qkv, bias, out, B, N, H, n_valid, scale, softmax_f32, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward.
//
// The TPU kernel's steps and roundings (qkv_attention.py:108-157, :316-376):
// the weights W are recomputed in fp32 from the bf16 scale fold in q (scores
// rounded to bf16 first when softmax_f32 is 0); dV = round_bf16(W)^T dO;
// dW = dO V^T; tmp = rowsum(dW * W) with the unrounded W; dS =
// round_bf16(W * (dW - tmp)); dQ = dS K and dK = dS^T Q with the UNSCALED k
// and q, each multiplied by the fp32 1/sqrt(hd) (`scale`, not the bf16 value
// `scale_c` the forward folded into q) and rounded to bf16.  With a bias, the
// bias gradient is the fp32 sum over every (batch, token) row of the
// bf16-rounded dQKV.
//
// What bounds it on the H100: five products of N x N x hd per (batch, head)
// against reading QKV and dO and writing dQKV once, about 250 FLOP per byte
// at N 197: near the ridge, so latency and the tensor-core rate both matter.
//
// The simple design: one block of 8 warps per (head, batch row).  At ViT
// lengths the head's Q, K, V and dO fit in shared memory (120 KB at N 197,
// hd 64; 65 KB at hd 32), so nothing but qkv (and the bias) is saved by the
// forward and every intermediate stays on the SM.  The two-phase routine is
// attention_core.cuh's attention_backward_tiles (mode kBwdFold), shared with
// the kernels for attention over separate q, k, v and for the projection +
// attention.  Each warp adds its tiles' column sums of the rounded dQKV in
// tile order, the block adds its warps in warp order into one row of a
// (B, 3D) fp32 partial, and column_sum_kernel adds the B rows in order: the
// same bits on every run.
// ---------------------------------------------------------------------------

template <int HD, int NKT>
constexpr size_t bwd_smem_bytes() {
  return static_cast<size_t>(4 * NKT * 16) * (HD + 8) * sizeof(bf16) +
         static_cast<size_t>(3 * NKT * 16 + kBwdWarps * 3 * HD) * sizeof(float);
}

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kBwdWarps)
qkv_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                         const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                         float* __restrict__ dbias_part, int N, int H, int n_valid,
                         float scale_c, float scale, int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // q + bias, unscaled
  bf16* s_k = s_q + kPad * kLd;
  bf16* s_v = s_k + kPad * kLd;
  bf16* s_do = s_v + kPad * kLd;
  float* s_max = reinterpret_cast<float*>(s_do + kPad * kLd);
  float* s_inv = s_max + kPad;
  float* s_tmp = s_inv + kPad;
  float* s_db = s_tmp + kPad;  // [kBwdWarps][3 * HD]: each warp's dbias partial

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  const long ld = 3L * D;
  const bool want_dbias = dbias_part != nullptr;
  const bf16* base = qkv + static_cast<long>(b) * N * ld + h * HD;
  stage_rows<HD>(s_q, kPad, base, 0, N, ld, bias == nullptr ? nullptr : bias + h * HD, 1.0f, false);
  stage_rows<HD>(s_k, kPad, base + D, 0, N, ld,
                 bias == nullptr ? nullptr : bias + D + h * HD, 1.0f, false);
  stage_rows<HD>(s_v, kPad, base + 2 * D, 0, N, ld,
                 bias == nullptr ? nullptr : bias + 2 * D + h * HD, 1.0f, false);
  stage_rows<HD>(s_do, kPad, dout + static_cast<long>(b) * N * D + h * HD, 0, N, D, nullptr,
                 1.0f, false);
  for (int i = threadIdx.x; i < kBwdWarps * 3 * HD; i += blockDim.x) s_db[i] = 0.0f;
  __syncthreads();

  bf16* out = dqkv + static_cast<long>(b) * N * ld + h * HD;
  attention_backward_tiles<HD, NKT, kBwdFold>(
      s_q, s_k, s_v, s_do, s_max, s_inv, s_tmp,
      want_dbias ? s_db + (threadIdx.x / 32) * 3 * HD : nullptr, out, out + D, out + 2 * D, ld, N,
      n_valid, scale_c, scale, softmax_f32);
  if (!want_dbias) return;
  __syncthreads();
  store_dbias_partial<HD>(s_db, dbias_part, b, h, D);
}

template <int HD, int NKT>
cudaError_t launch_bwd(const bf16* qkv, const bf16* bias, const bf16* dout, bf16* dqkv,
                       float* dbias_part, float* dbias, int B, int N, int H, int n_valid,
                       float scale_c, float scale, int softmax_f32, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD, NKT>();
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_bwd_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qkv_attention_bwd_kernel<HD, NKT><<<dim3(H, B), 32 * kBwdWarps, smem, stream>>>(
      qkv, bias, dout, dqkv, bias == nullptr ? nullptr : dbias_part, N, H, n_valid, scale_c,
      scale, softmax_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || bias == nullptr) return err;
  return launch_column_sum(dbias_part, B, 3 * H * HD, dbias, stream);
}

template <int HD>
cudaError_t launch_bwd_head_dim(const bf16* qkv, const bf16* bias, const bf16* dout, bf16* dqkv,
                                float* dbias_part, float* dbias, int B, int N, int H,
                                int n_valid, float scale_c, float scale, int softmax_f32,
                                cudaStream_t stream) {
#define SSL4POLYP_BWD(NKT)                                                                     \
  launch_bwd<HD, NKT>(qkv, bias, dout, dqkv, dbias_part, dbias, B, N, H, n_valid, scale_c, \
                      scale, softmax_f32, stream)
  if (N <= 64) return SSL4POLYP_BWD(4);
  if (N <= 128) return SSL4POLYP_BWD(8);
  if (N <= 208) return SSL4POLYP_BWD(13);
  if (N <= 256) return SSL4POLYP_BWD(16);
#undef SSL4POLYP_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// qkv: (B, N, 3*H*hd) bf16, [q heads | k heads | v heads]; bias: (3*H*hd,)
// bf16 or null; out: (B, N, H*hd) bf16.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_fwd(const void* qkv, const void* bias, void* out,
                                           int B, int N, int H, int head_dim, int n_valid,
                                           float scale, int softmax_f32, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_head_dim<16>(q, bb, o, B, N, H, n_valid, scale, softmax_f32, s); break;
    case 32: err = launch_head_dim<32>(q, bb, o, B, N, H, n_valid, scale, softmax_f32, s); break;
    case 64: err = launch_head_dim<64>(q, bb, o, B, N, H, n_valid, scale, softmax_f32, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// qkv: (B, N, 3*H*hd) bf16; bias: (3*H*hd,) bf16 or null; dout: (B, N, H*hd)
// bf16; dqkv: (B, N, 3*H*hd) bf16.  With a bias, dbias_part is (B, 3*H*hd)
// fp32 scratch and dbias (3*H*hd,) fp32 receives the bias gradient; both are
// ignored without one.  scale_c is 1/sqrt(hd) as the compute dtype holds it
// (the forward's fold), scale the fp32 1/sqrt(hd).  Returns the first failing
// launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                           void* dqkv, void* dbias_part, void* dbias, int B,
                                           int N, int H, int head_dim, int n_valid,
                                           float scale_c, float scale, int softmax_f32,
                                           void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bb = static_cast<const bf16*>(bias);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_bwd_head_dim<16>(q, bb, d, dq, part, db, B, N, H, n_valid, scale_c, scale, softmax_f32, s); break;
    case 32: err = launch_bwd_head_dim<32>(q, bb, d, dq, part, db, B, N, H, n_valid, scale_c, scale, softmax_f32, s); break;
    case 64: err = launch_bwd_head_dim<64>(q, bb, d, dq, part, db, B, N, H, n_valid, scale_c, scale, softmax_f32, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
