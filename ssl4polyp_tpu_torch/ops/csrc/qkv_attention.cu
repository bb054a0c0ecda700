// Attention straight from the fused QKV projection, forward and backward.
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel and _bwd_kernel
// (fused_qkv_attention), and ::_fwd_bias_kernel and _bwd_bias_kernel
// (fused_qkv_bias_attention); the optional bias argument covers the second.
// The backward's design is described above qkv_attention_bwd_kernel.
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
// forward and every intermediate stays on the SM.  dK and dV sum over every
// query row, so the kernel runs in two phases instead of reducing across
// blocks:
//   A. warps own 16-row query tiles: whole score rows in registers, softmax,
//      tmp from dW tiles formed one 8-key slice at a time, then dW again for
//      dS and dQ += dS K.  The rows' max, 1/sum and tmp go to shared memory.
//   B. warps own 16-row key tiles: for each query tile, the transposed
//      scores S^T = K Q_s^T and dW^T = V dO^T give W^T and dS^T from the
//      phase-A statistics, and dV += round(W^T) dO, dK += dS^T Q accumulate
//      in registers over all query tiles.
// Each warp adds its tiles' column sums of the rounded dQKV in tile order,
// the block adds its warps in warp order into one row of a (B, 3D) fp32
// partial, and column_sum_kernel adds the B rows in order: the same bits on
// every run.  Products run on mma.sync m16n8k16; operands that must be
// transposed are gathered from shared memory two bf16 values at a time.
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;

// A fragment (16 rows x 16 columns at `p`, row stride LD) of a row-major
// bf16 matrix in shared memory; p points at (row g, column 2t).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p) {
  a[0] = load_u32(p);
  a[1] = load_u32(p + 8 * LD);
  a[2] = load_u32(p + 8);
  a[3] = load_u32(p + 8 * LD + 8);
}

// B fragment of a (16 x 8) slice whose k index runs down the rows of a
// row-major matrix: p points at (row 2t, column g).
template <int LD>
__device__ __forceinline__ void mma_gather_b(float (&d)[4], const uint32_t (&a)[4], const bf16* p) {
  mma_16816(d, a, pack_halves(p[0], p[LD]), pack_halves(p[8 * LD], p[9 * LD]));
}

// Adds the column sums of a 16 x HD tile of rounded outputs, held as packed
// pairs (lo: row g, hi: row g + 8), to `dst` (the warp's partial of one
// section).  Rows past N count as zero.
template <int NT>
__device__ __forceinline__ void add_column_sums(float* dst, const uint32_t (&lo)[NT],
                                                const uint32_t (&hi)[NT], bool ok_lo, bool ok_hi,
                                                int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float c0 = 0.0f, c1 = 0.0f;
    if (ok_lo) {
      c0 += __uint_as_float(lo[n] << 16);
      c1 += __uint_as_float(lo[n] & 0xffff0000u);
    }
    if (ok_hi) {
      c0 += __uint_as_float(hi[n] << 16);
      c1 += __uint_as_float(hi[n] & 0xffff0000u);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, off);
      c1 += __shfl_xor_sync(0xffffffffu, c1, off);
    }
    if (g == 0) {
      dst[n * 8 + 2 * t] += c0;
      dst[n * 8 + 2 * t + 1] += c1;
    }
  }
}

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
  constexpr int kNT = HD / 8;   // n-tiles of 8 head columns
  constexpr int kKT = HD / 16;  // k-steps of 16 head columns
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

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (N + 15) / 16;  // 16-row tiles holding rows < N
  bf16* out = dqkv + static_cast<long>(b) * N * ld + h * HD;
  float* db = s_db + warp * 3 * HD;

  // Phase A: query tiles.  dQ, and each row's max, 1/sum and tmp.
  for (int qt = warp; qt < n_tiles; qt += kBwdWarps) {
    const int r0 = qt * 16;
    float s[2 * NKT][4];
    {
      uint32_t qa[kKT][4];
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        load_a<kLd>(qa[kk], s_q + (r0 + g) * kLd + kk * 16 + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], scale_c);
      }
#pragma unroll
      for (int j = 0; j < 2 * NKT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          const bf16* p = s_k + (j * 8 + g) * kLd + kk * 16 + 2 * t;
          mma_16816(s[j], qa[kk], load_u32(p), load_u32(p + 8));
        }
      }
    }
    float max0 = -INFINITY, max1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        float x = col < n_valid ? s[j][e] : -INFINITY;
        if (!softmax_f32) x = round_bf16(x);
        s[j][e] = x;
      }
      max0 = fmaxf(max0, fmaxf(s[j][0], s[j][1]));
      max1 = fmaxf(max1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      max0 = fmaxf(max0, __shfl_xor_sync(0xffffffffu, max0, off));
      max1 = fmaxf(max1, __shfl_xor_sync(0xffffffffu, max1, off));
    }
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
      s[j][0] = expf(s[j][0] - max0);
      s[j][1] = expf(s[j][1] - max0);
      s[j][2] = expf(s[j][2] - max1);
      s[j][3] = expf(s[j][3] - max1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float inv0 = 1.0f / sum0;
    const float inv1 = 1.0f / sum1;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {  // s <- W, the normalised fp32 weights
      s[j][0] *= inv0;
      s[j][1] *= inv0;
      s[j][2] *= inv1;
      s[j][3] *= inv1;
    }

    uint32_t da[kKT][4];  // dO rows r0 .. r0 + 15
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) load_a<kLd>(da[kk], s_do + (r0 + g) * kLd + kk * 16 + 2 * t);
    float tmp0 = 0.0f, tmp1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
      float dw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const bf16* p = s_v + (j * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_16816(dw, da[kk], load_u32(p), load_u32(p + 8));
      }
      tmp0 += dw[0] * s[j][0] + dw[1] * s[j][1];
      tmp1 += dw[2] * s[j][2] + dw[3] * s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmp0 += __shfl_xor_sync(0xffffffffu, tmp0, off);
      tmp1 += __shfl_xor_sync(0xffffffffu, tmp1, off);
    }
    if (t == 0) {
      s_max[r0 + g] = max0;
      s_max[r0 + g + 8] = max1;
      s_inv[r0 + g] = inv0;
      s_inv[r0 + g + 8] = inv1;
      s_tmp[r0 + g] = tmp0;
      s_tmp[r0 + g + 8] = tmp1;
    }

    float dq[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
      float dw[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        dw[jj][0] = dw[jj][1] = dw[jj][2] = dw[jj][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          const bf16* p = s_v + ((2 * kt + jj) * 8 + g) * kLd + kk * 16 + 2 * t;
          mma_16816(dw[jj], da[kk], load_u32(p), load_u32(p + 8));
        }
      }
      const float(&w0)[4] = s[2 * kt];
      const float(&w1)[4] = s[2 * kt + 1];
      const uint32_t dsa[4] = {
          pack_floats(w0[0] * (dw[0][0] - tmp0), w0[1] * (dw[0][1] - tmp0)),
          pack_floats(w0[2] * (dw[0][2] - tmp1), w0[3] * (dw[0][3] - tmp1)),
          pack_floats(w1[0] * (dw[1][0] - tmp0), w1[1] * (dw[1][1] - tmp0)),
          pack_floats(w1[2] * (dw[1][2] - tmp1), w1[3] * (dw[1][3] - tmp1)),
      };
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_gather_b<kLd>(dq[n], dsa, s_k + (kt * 16 + 2 * t) * kLd + n * 8 + g);
    }
    const int row_a = r0 + g;
    const int row_b = row_a + 8;
    uint32_t lo[kNT], hi[kNT];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      lo[n] = pack_floats(dq[n][0] * scale, dq[n][1] * scale);
      hi[n] = pack_floats(dq[n][2] * scale, dq[n][3] * scale);
      if (row_a < N) *reinterpret_cast<uint32_t*>(out + row_a * ld + n * 8 + 2 * t) = lo[n];
      if (row_b < N) *reinterpret_cast<uint32_t*>(out + row_b * ld + n * 8 + 2 * t) = hi[n];
    }
    if (want_dbias) add_column_sums<kNT>(db, lo, hi, row_a < N, row_b < N, g, t);
  }
  __syncthreads();  // the statistics of every row are in

  // Phase B: key tiles.  dK and dV, summed over every query tile.
  for (int kt = warp; kt < n_tiles; kt += kBwdWarps) {
    const int k0 = kt * 16;
    uint32_t ka[kKT][4], va[kKT][4];
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      load_a<kLd>(ka[kk], s_k + (k0 + g) * kLd + kk * 16 + 2 * t);
      load_a<kLd>(va[kk], s_v + (k0 + g) * kLd + kk * 16 + 2 * t);
    }
    const bool masked_a = k0 + g >= n_valid;
    const bool masked_b = k0 + g + 8 >= n_valid;
    float dk[kNT][4], dv[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
      dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
    }
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * 16;
      float st[2][4], dwt[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        st[jn][0] = st[jn][1] = st[jn][2] = st[jn][3] = 0.0f;
        dwt[jn][0] = dwt[jn][1] = dwt[jn][2] = dwt[jn][3] = 0.0f;
        const bf16* pq = s_q + (q0 + jn * 8 + g) * kLd + 2 * t;
        const bf16* pd = s_do + (q0 + jn * 8 + g) * kLd + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          mma_16816(st[jn], ka[kk], scale_pair(load_u32(pq + kk * 16), scale_c),
                    scale_pair(load_u32(pq + kk * 16 + 8), scale_c));
          mma_16816(dwt[jn], va[kk], load_u32(pd + kk * 16), load_u32(pd + kk * 16 + 8));
        }
      }
      // Element e of tile jn: key k0 + g (+ 8 for e >= 2), query q0 + 8 jn + 2t + (e & 1).
      float wt[2][4], dst[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + jn * 8 + 2 * t + (e & 1);
          float x = (e < 2 ? masked_a : masked_b) ? -INFINITY : st[jn][e];
          if (!softmax_f32) x = round_bf16(x);
          const float w = expf(x - s_max[q]) * s_inv[q];
          wt[jn][e] = w;
          dst[jn][e] = w * (dwt[jn][e] - s_tmp[q]);
        }
      }
      const uint32_t wa[4] = {pack_floats(wt[0][0], wt[0][1]), pack_floats(wt[0][2], wt[0][3]),
                              pack_floats(wt[1][0], wt[1][1]), pack_floats(wt[1][2], wt[1][3])};
      const uint32_t dsa[4] = {pack_floats(dst[0][0], dst[0][1]), pack_floats(dst[0][2], dst[0][3]),
                               pack_floats(dst[1][0], dst[1][1]), pack_floats(dst[1][2], dst[1][3])};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mma_gather_b<kLd>(dv[n], wa, s_do + (q0 + 2 * t) * kLd + n * 8 + g);
        mma_gather_b<kLd>(dk[n], dsa, s_q + (q0 + 2 * t) * kLd + n * 8 + g);
      }
    }
    const int row_a = k0 + g;
    const int row_b = row_a + 8;
    uint32_t klo[kNT], khi[kNT], vlo[kNT], vhi[kNT];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      klo[n] = pack_floats(dk[n][0] * scale, dk[n][1] * scale);
      khi[n] = pack_floats(dk[n][2] * scale, dk[n][3] * scale);
      vlo[n] = pack_floats(dv[n][0], dv[n][1]);
      vhi[n] = pack_floats(dv[n][2], dv[n][3]);
      bf16* pa = out + row_a * ld + n * 8 + 2 * t;
      bf16* pb = out + row_b * ld + n * 8 + 2 * t;
      if (row_a < N) {
        *reinterpret_cast<uint32_t*>(pa + D) = klo[n];
        *reinterpret_cast<uint32_t*>(pa + 2 * D) = vlo[n];
      }
      if (row_b < N) {
        *reinterpret_cast<uint32_t*>(pb + D) = khi[n];
        *reinterpret_cast<uint32_t*>(pb + 2 * D) = vhi[n];
      }
    }
    if (want_dbias) {
      add_column_sums<kNT>(db + HD, klo, khi, row_a < N, row_b < N, g, t);
      add_column_sums<kNT>(db + 2 * HD, vlo, vhi, row_a < N, row_b < N, g, t);
    }
  }

  if (!want_dbias) return;
  __syncthreads();
  // This block's row of the (B, 3D) partial: its warps added in warp order.
  for (int c = threadIdx.x; c < 3 * HD; c += blockDim.x) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) total += s_db[w * 3 * HD + c];
    dbias_part[static_cast<long>(b) * 3 * D + (c / HD) * D + h * HD + c % HD] = total;
  }
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
