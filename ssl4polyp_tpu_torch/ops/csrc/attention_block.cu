// The QKV projection and the attention core in one kernel, forward and
// backward:  out = attention(x . W + b), x (B, N, Din), W (Din, 3D), b (3D,).
//
// Replaces: ssl4polyp_tpu/ops/attention_block.py::_fwd_kernel and _bwd_kernel
// (fused_qkvproj_attention).  The (B, N, 3D) QKV tensor never reaches global
// memory in either direction: the backward recomputes it from x.
//
// The TPU kernel's steps and roundings: qkv = round_bf16(x . W) + b, the sum
// rounded again (two roundings, attention_block.py::_project); the forward's
// core as qkv_attention.cu's (1/sqrt(hd) folded into q in bf16, fp32 scores
// optionally rounded, weights rounded before the product with v).  The
// backward: dV = round(W)^T dO; dS = round_bf16(W * (dW - tmp) * scale) with
// the fp32 scale INSIDE the rounding, dQ = dS K and dK = dS^T Q unscaled
// (attention_block.py:103: not where qkv_attention.py puts the scale); dqkv
// rounded to bf16; dx = round_bf16(dqkv . W^T); dW = x^T dqkv and db = sum of
// dqkv in fp32 over all B * N rows.
//
// What bounds it on the H100: at the classifier's shape (B 64, N 197, Din =
// D = 768, 12 heads of 64) the forward is 52.2 GFLOP (44.6 in the
// projection) against 42 MB (x in, out out, W once), over 1,200 FLOP per
// byte: the tensor cores bound it, as they bound the backward's 153 GFLOP.
//
// Forward design.  One image's x tile (197 x 768 bf16, 302 KB) does not fit
// an SM's shared memory, so a block of 8 warps owns one (image, head) pair
// and streams x in reduction chunks of 64 columns against the head's three
// 768 x hd column panels of W, one panel after the other through a two-stage
// cp.async ring (mma.sync m16n8k16, W's tile read transposed with
// ldmatrix.trans; a warp owns 16-row tiles w, w + 8 of the image and all hd
// columns).  Each panel's epilogue rounds, adds the bias, rounds again and
// leaves Q, K or V in shared memory, where attention_core.cuh's
// attention_rows takes 16 query rows per warp.  What this re-reads: every
// head reads its image's x three times (36 reads of x per image at 12 heads,
// from L2 after the first) and its own panels of W once, so W is read B
// times in all; the products are not overlapped with the next head's loads.
//
// Backward design.  dx sums over heads and dW, db over all B * N rows; the
// TPU kernel accumulates across its sequential grid, and here a fixed-order
// reduction without atomics takes its place, in phases, with the rounded
// dqkv (B, N, 3D) bf16 in global scratch between them (qkv itself is
// recomputed, never stored):
//   1. qkvproj_attention_bwd_kernel, a block per (image, head): the forward's
//      projection again, dO staged in the ring's place, then
//      attention_core.cuh's attention_backward_tiles (mode kBwdFoldScaledDs)
//      writes the head's dqkv columns and its row of the (B, 3D) fp32 db
//      partial; column_sum_kernel adds the B rows in order;
//   2. dx = dqkv . W^T on mlp.cu's tiled GEMM (ssl4polyp_matmul_nt): W's rows
//      are contiguous along the reduction;
//   3. dW = x^T dqkv on transposed_product.cuh, row slices added in order.
#include "attention_core.cuh"
#include "transposed_product.cuh"

// The tiled GEMM y = x . w^T (mlp.cu, same library).
extern "C" int ssl4polyp_matmul_nt(const void* x, const void* w, void* y, int M, int K, int NF,
                                   void* stream);

namespace {

constexpr int kBK = 64;        // reduction depth per step of the projection
constexpr int kLdX = kBK + 8;  // an x tile stored [row][k]

// One ring stage: an x tile of NKT * 16 rows and a W tile stored [k][n].
template <int HD, int NKT>
constexpr int kStageElems = NKT * 16 * kLdX + kBK * (HD + 8);

// Shared memory: Q, K, V; the two-stage ring (the backward stages dO there
// once the projection is done); the backward's row statistics and dbias
// partials.
template <int HD, int NKT, bool BWD>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(3 * NKT * 16 * (HD + 8) + 2 * kStageElems<HD, NKT>) * sizeof(bf16) +
         (BWD ? static_cast<size_t>(3 * NKT * 16 + kBwdWarps * 3 * HD) * sizeof(float) : 0);
}

// s_qkv (three tiles of NKT * 16 rows, row stride HD + 8) <- head h's Q, K
// and V of image `xb` (N rows of Din, rows at or past N zero): the fp32
// product rounded to bf16, the bias added in bf16 and rounded again.  By a
// block of kBwdWarps warps; `ring` holds two stages.  The block is
// synchronised on return.
template <int HD, int NKT>
__device__ __forceinline__ void project_head(bf16* s_qkv, bf16* ring, const bf16* __restrict__ xb,
                                             const bf16* __restrict__ w,
                                             const bf16* __restrict__ bias, int h, int N, int Din,
                                             int D) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  constexpr int kNT = HD / 8;
  constexpr int kMT = (NKT + kBwdWarps - 1) / kBwdWarps;  // 16-row tiles per warp
  static_assert(kMT <= 2, "a warp holds at most two row tiles of accumulators");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int KT = Din / kBK;
  const int total = 3 * KT;  // (panel, reduction step), flat
  const long ldw = 3L * D;

  auto load = [&](int it) {
    bf16* t_x = ring + (it % 2) * kStageElems<HD, NKT>;
    bf16* t_w = t_x + kPad * kLdX;
    const int k0 = (it % KT) * kBK;
    const int col0 = (it / KT) * D + h * HD;
    for (int i = threadIdx.x; i < kPad * (kBK / 8); i += blockDim.x) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      const bool ok = r < N;
      cp_async_16(t_x + r * kLdX + c, ok ? xb + static_cast<long>(r) * Din + k0 + c : xb,
                  ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kBK * (HD / 8); i += blockDim.x) {
      const int r = i / (HD / 8);
      const int c = (i % (HD / 8)) * 8;
      cp_async_16(t_w + r * kLd + c, w + (k0 + r) * ldw + col0 + c, 16);
    }
  };

  float acc[kMT][kNT][4];
  load(0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // stage `it` is in; every warp is done with the other stage
    if (it + 1 < total) load(it + 1);
    cp_async_commit();
    const int k_idx = it % KT;
    if (k_idx == 0) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
    }
    const bf16* t_x = ring + (it % 2) * kStageElems<HD, NKT>;
    const bf16* t_w = t_x + kPad * kLdX;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bq[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT; j += 2)
        ldmatrix_x4_trans(bq[j / 2], t_w + (kk + ((lane / 8) % 2) * 8 + (lane % 8)) * kLd + j * 8 +
                                         (lane / 16) * 8);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int mt = warp + m * kBwdWarps;
        if (mt >= NKT) continue;
        uint32_t a[4];
        ldmatrix_x4(a, t_x + (mt * 16 + (lane % 16)) * kLdX + kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          mma_16816(acc[m][j], a, bq[j / 2][0], bq[j / 2][1]);
          mma_16816(acc[m][j + 1], a, bq[j / 2][2], bq[j / 2][3]);
        }
      }
    }
    if (k_idx != KT - 1) continue;
    const int panel = it / KT;
    bf16* dst = s_qkv + panel * kPad * kLd;
    const bf16* pb = bias + panel * D + h * HD;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int mt = warp + m * kBwdWarps;
      if (mt >= NKT) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int col = n * 8 + 2 * t;
        const float b0 = __bfloat162float(pb[col]);
        const float b1 = __bfloat162float(pb[col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + 8 * half;
          uint32_t packed = 0;  // rows at or past N stay zero
          if (row < N)
            packed = pack_floats(round_bf16(acc[m][n][2 * half]) + b0,
                                 round_bf16(acc[m][n][2 * half + 1]) + b1);
          *reinterpret_cast<uint32_t*>(dst + row * kLd + col) = packed;
        }
      }
    }
  }
  __syncthreads();  // Q, K and V are whole and the ring is free
}

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kBwdWarps)
qkvproj_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ out, int N, int Din,
                         int H, int n_valid, float scale_c, int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kPad * kLd;
  bf16* s_v = s_k + kPad * kLd;
  bf16* ring = s_v + kPad * kLd;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  project_head<HD, NKT>(s_q, ring, x + static_cast<long>(b) * N * Din, w, bias, h, N, Din, D);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (N + 15) / 16;
  for (int qt = warp; qt < n_tiles; qt += kBwdWarps) {  // no barrier follows
    float o[HD / 8][4];
    attention_rows<HD, NKT, true>(s_q, s_k, s_v, qt * 16, lane, n_valid, softmax_f32, o, scale_c);
    const int row_a = qt * 16 + g;
    const int row_b = row_a + 8;
    bf16* out_a = out + (static_cast<long>(b) * N + row_a) * D + h * HD + 2 * t;
    bf16* out_b = out_a + 8L * D;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (row_a < N) *reinterpret_cast<uint32_t*>(out_a + n * 8) = pack_floats(o[n][0], o[n][1]);
      if (row_b < N) *reinterpret_cast<uint32_t*>(out_b + n * 8) = pack_floats(o[n][2], o[n][3]);
    }
  }
}

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kBwdWarps)
qkvproj_attention_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                             const bf16* __restrict__ bias, const bf16* __restrict__ dout,
                             bf16* __restrict__ dqkv, float* __restrict__ db_part, int N, int Din,
                             int H, int n_valid, float scale_c, float scale, int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kPad * kLd;
  bf16* s_v = s_k + kPad * kLd;
  bf16* ring = s_v + kPad * kLd;
  bf16* s_do = ring;  // once the projection is done
  float* s_max = reinterpret_cast<float*>(ring + 2 * kStageElems<HD, NKT>);
  float* s_inv = s_max + kPad;
  float* s_tmp = s_inv + kPad;
  float* s_db = s_tmp + kPad;  // [kBwdWarps][3 * HD]: each warp's db partial

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  const long ld = 3L * D;
  project_head<HD, NKT>(s_q, ring, x + static_cast<long>(b) * N * Din, w, bias, h, N, Din, D);
  stage_rows_async<HD>(s_do, kPad, dout + static_cast<long>(b) * N * D + h * HD, 0, N, D);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBwdWarps * 3 * HD; i += blockDim.x) s_db[i] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  bf16* dst = dqkv + static_cast<long>(b) * N * ld + h * HD;
  attention_backward_tiles<HD, NKT, kBwdFoldScaledDs>(
      s_q, s_k, s_v, s_do, s_max, s_inv, s_tmp, s_db + (threadIdx.x / 32) * 3 * HD, dst, dst + D,
      dst + 2 * D, ld, N, n_valid, scale_c, scale, softmax_f32);
  __syncthreads();
  store_dbias_partial<HD>(s_db, db_part, b, h, D);
}

template <int HD, int NKT>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int N,
                   int Din, int H, int n_valid, float scale_c, int softmax_f32,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, NKT, false>();
  cudaError_t err = cudaFuncSetAttribute(qkvproj_attention_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qkvproj_attention_kernel<HD, NKT><<<dim3(H, B), 32 * kBwdWarps, smem, stream>>>(
      x, w, bias, out, N, Din, H, n_valid, scale_c, softmax_f32);
  return cudaGetLastError();
}

template <int HD, int NKT>
cudaError_t launch_bwd(const bf16* x, const bf16* w, const bf16* bias, const bf16* dout,
                       bf16* dqkv, float* db_part, int B, int N, int Din, int H, int n_valid,
                       float scale_c, float scale, int softmax_f32, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, NKT, true>();
  cudaError_t err = cudaFuncSetAttribute(qkvproj_attention_bwd_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qkvproj_attention_bwd_kernel<HD, NKT><<<dim3(H, B), 32 * kBwdWarps, smem, stream>>>(
      x, w, bias, dout, dqkv, db_part, N, Din, H, n_valid, scale_c, scale, softmax_f32);
  return cudaGetLastError();
}

// Calls CALL(HD, NKT) for the head dim and token count; cudaErrorInvalidValue
// for a shape the kernels do not take.
#define SSL4POLYP_FOR_SHAPE(CALL)           \
  switch (head_dim) {                       \
    case 32: SSL4POLYP_FOR_TOKENS(CALL, 32) \
    case 64: SSL4POLYP_FOR_TOKENS(CALL, 64) \
    default: return cudaErrorInvalidValue;  \
  }

cudaError_t dispatch(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int N,
                     int Din, int H, int head_dim, int n_valid, float scale_c, int softmax_f32,
                     cudaStream_t stream) {
#define SSL4POLYP_FWD(HD, NKT) \
  launch<HD, NKT>(x, w, bias, out, B, N, Din, H, n_valid, scale_c, softmax_f32, stream)
  SSL4POLYP_FOR_SHAPE(SSL4POLYP_FWD)
#undef SSL4POLYP_FWD
}

cudaError_t dispatch_bwd(const bf16* x, const bf16* w, const bf16* bias, const bf16* dout,
                         bf16* dqkv, float* db_part, int B, int N, int Din, int H, int head_dim,
                         int n_valid, float scale_c, float scale, int softmax_f32,
                         cudaStream_t stream) {
#define SSL4POLYP_BWD(HD, NKT)                                                                 \
  launch_bwd<HD, NKT>(x, w, bias, dout, dqkv, db_part, B, N, Din, H, n_valid, scale_c, scale, \
                      softmax_f32, stream)
  SSL4POLYP_FOR_SHAPE(SSL4POLYP_BWD)
#undef SSL4POLYP_BWD
}

#undef SSL4POLYP_FOR_SHAPE

}  // namespace

// x: (B, N, Din) bf16; w: (Din, 3*H*hd) bf16, columns [q heads | k heads | v
// heads]; bias: (3*H*hd,) bf16; out: (B, N, H*hd) bf16.  Din a multiple of
// 64, hd 32 or 64, N <= 256.  scale_c is 1/sqrt(hd) as bf16 holds it.
// Returns the launch's CUDA error.
extern "C" int ssl4polyp_qkvproj_attention_fwd(const void* x, const void* w, const void* bias,
                                               void* out, int B, int N, int Din, int H,
                                               int head_dim, int n_valid, float scale_c,
                                               int softmax_f32, void* stream) {
  if (Din % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                   static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, N,
                                   Din, H, head_dim, n_valid, scale_c, softmax_f32,
                                   static_cast<cudaStream_t>(stream)));
}

// The backward of ssl4polyp_qkvproj_attention_fwd for the output gradient
// dout (B, N, H*hd) bf16.  Scratch: dqkv (B, N, 3D) bf16, db_part (B, 3D)
// fp32, dw_part (slices, Din, 3D) fp32.  Results: dx (B, N, Din) bf16, dw
// (Din, 3D) fp32, db (3D,) fp32.  3D a multiple of 64.  scale is the fp32
// 1/sqrt(hd).  Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_qkvproj_attention_bwd(const void* x, const void* w, const void* bias,
                                               const void* dout, void* dqkv, void* db_part,
                                               void* db, void* dx, void* dw_part, void* dw, int B,
                                               int N, int Din, int H, int head_dim, int n_valid,
                                               float scale_c, float scale, int softmax_f32,
                                               int slices, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int three_d = 3 * H * head_dim;
  const int M = B * N;
  if (Din % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dispatch_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), static_cast<float*>(db_part), B, N,
      Din, H, head_dim, n_valid, scale_c, scale, softmax_f32, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_column_sum(static_cast<const float*>(db_part), B, three_d, static_cast<float*>(db),
                          st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = ssl4polyp_matmul_nt(dqkv, w, dx, M, three_d, Din, stream);
  if (rc != 0) return rc;
  return static_cast<int>(launch_transposed_product(
      static_cast<const bf16*>(x), Din, static_cast<const bf16*>(dqkv), three_d,
      static_cast<float*>(dw_part), static_cast<float*>(dw), M, Din, three_d, slices, st));
}
