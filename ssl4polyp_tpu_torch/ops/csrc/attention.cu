// Attention over separate q, k and v, forward and backward:
//   out = softmax(q . k^T * 1/sqrt(hd)) . v per (batch, head), (B, H, N, hd).
//
// Replaces: ssl4polyp_tpu/ops/attention.py::_attention_kernel and
// _attention_bwd_kernel (fused_attention).  Its roundings are not those of
// the QKV kernels: q and k enter the scores as they are and the scale
// multiplies the fp32 scores; the forward rounds the weights to bf16 before
// the product with v; the backward takes dV from the unrounded fp32 weights
// and dQ, dK from an unrounded dS = W * (dW - rowsum(dW * W)) * scale.  The TPU
// kernel pads N and hd to 128 for its matrix unit and masks the pad keys;
// here nothing is padded in global memory: every one of the N keys is valid,
// and the rows that fill the last 16-row tile in shared memory are zero and
// masked.
//
// What bounds it on the H100: at the classifier's shape (B 64, 12 heads, N
// 197, hd 64) the forward is 7.6 GFLOP against 77.5 MB (q, k, v in, out
// out), about 100 FLOP per byte, and the backward 19 GFLOP (30.5 with the
// second term of each split operand) against 135.6 MB: both below the data
// sheet's ridge of ~295, so HBM traffic is the floor.
//
// The simple design: the forward is one block of 4 warps per (64-query tile,
// batch * head); it copies the Q tile and all of the head's K and V into
// shared memory with cp.async and each warp takes 16 query rows through
// attention_core.cuh's attention_rows (whole score row in registers, exact
// softmax).  The backward is one block of 8 warps per (batch, head): Q, K, V
// and dO in shared memory, then attention_core.cuh's two-phase
// attention_backward_recompute_ds in mode kBwdExact, where each fp32 operand (W, dS)
// enters mma.sync as two bf16 terms.  No atomics: a rerun gives the same
// bits.  Every query tile re-reads its head's K and V from L2, and staging is
// not overlapped with the products.
#include "attention_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTileRows = 16 * kWarps;  // query rows per block

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kWarps)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int N, float scale) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kTileRows * kLd;
  bf16* s_v = s_k + kPad * kLd;

  const long head = static_cast<long>(blockIdx.y) * N * HD;  // this (batch, head) slice
  const int q0 = blockIdx.x * kTileRows;
  stage_rows_async<HD>(s_q, kTileRows, q + head, q0, N, HD);
  stage_rows_async<HD>(s_k, kPad, k + head, 0, N, HD);
  stage_rows_async<HD>(s_v, kPad, v + head, 0, N, HD);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;
  if (q0 + r0 >= N) return;  // no barrier follows

  float o[HD / 8][4];
  attention_rows<HD, NKT, false, true>(s_q, s_k, s_v, r0, lane, N, 1, o, scale);

  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  bf16* out_a = out + head + static_cast<long>(row_a) * HD + 2 * t;
  bf16* out_b = out_a + 8 * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row_a < N) *reinterpret_cast<uint32_t*>(out_a + n * 8) = pack_floats(o[n][0], o[n][1]);
    if (row_b < N) *reinterpret_cast<uint32_t*>(out_b + n * 8) = pack_floats(o[n][2], o[n][3]);
  }
}

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kBwdWarps)
attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                     float scale) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kPad * kLd;
  bf16* s_v = s_k + kPad * kLd;
  bf16* s_do = s_v + kPad * kLd;
  float* s_max = reinterpret_cast<float*>(s_do + kPad * kLd);
  float* s_inv = s_max + kPad;
  float* s_tmp = s_inv + kPad;

  const long head = static_cast<long>(blockIdx.x) * N * HD;
  stage_rows_async<HD>(s_q, kPad, q + head, 0, N, HD);
  stage_rows_async<HD>(s_k, kPad, k + head, 0, N, HD);
  stage_rows_async<HD>(s_v, kPad, v + head, 0, N, HD);
  stage_rows_async<HD>(s_do, kPad, dout + head, 0, N, HD);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  attention_backward_recompute_ds<HD, NKT, kBwdExact>(s_q, s_k, s_v, s_do, s_max, s_inv, s_tmp, nullptr,
                                               dq + head, dk + head, dv + head, HD, N, N, 1.0f,
                                               scale, 1);
}

template <int HD, int NKT>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int N,
                   float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTileRows + 2 * NKT * 16) * (HD + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileRows - 1) / kTileRows, BH);
  attention_kernel<HD, NKT><<<grid, 32 * kWarps, smem, stream>>>(q, k, v, out, N, scale);
  return cudaGetLastError();
}

template <int HD, int NKT>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                       bf16* dk, bf16* dv, int BH, int N, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(4 * NKT * 16) * (HD + 8) * sizeof(bf16) +
                      static_cast<size_t>(3 * NKT * 16) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<HD, NKT><<<BH, 32 * kBwdWarps, smem, stream>>>(q, k, v, dout, dq, dk, dv, N,
                                                                     scale);
  return cudaGetLastError();
}

// Calls CALL(HD, NKT) for the head dim and token count; cudaErrorInvalidValue
// for a shape the kernels do not take.
#define SSL4POLYP_FOR_SHAPE(CALL)                 \
  switch (head_dim) {                             \
    case 16: SSL4POLYP_FOR_TOKENS(CALL, 16)       \
    case 32: SSL4POLYP_FOR_TOKENS(CALL, 32)       \
    case 64: SSL4POLYP_FOR_TOKENS(CALL, 64)       \
    default: return cudaErrorInvalidValue;        \
  }

cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int N,
                     int head_dim, float scale, cudaStream_t stream) {
#define SSL4POLYP_FWD(HD, NKT) launch<HD, NKT>(q, k, v, out, BH, N, scale, stream)
  SSL4POLYP_FOR_SHAPE(SSL4POLYP_FWD)
#undef SSL4POLYP_FWD
}

cudaError_t dispatch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                         bf16* dk, bf16* dv, int BH, int N, int head_dim, float scale,
                         cudaStream_t stream) {
#define SSL4POLYP_BWD(HD, NKT) launch_bwd<HD, NKT>(q, k, v, dout, dq, dk, dv, BH, N, scale, stream)
  SSL4POLYP_FOR_SHAPE(SSL4POLYP_BWD)
#undef SSL4POLYP_BWD
}

#undef SSL4POLYP_FOR_SHAPE

}  // namespace

// q, k, v, out: (BH, N, head_dim) bf16, contiguous (BH = batch * heads);
// head_dim 16, 32 or 64, N <= 256; scale is the fp32 1/sqrt(head_dim).
// Returns the launch's CUDA error.
extern "C" int ssl4polyp_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       int BH, int N, int head_dim, float scale, void* stream) {
  return static_cast<int>(dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), static_cast<bf16*>(out), BH, N,
                                   head_dim, scale, static_cast<cudaStream_t>(stream)));
}

// The backward of ssl4polyp_attention_fwd for the output gradient dout; dq,
// dk, dv as q, k, v.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv, int BH,
                                       int N, int head_dim, float scale, void* stream) {
  return static_cast<int>(dispatch_bwd(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), BH, N, head_dim, scale, static_cast<cudaStream_t>(stream)));
}
