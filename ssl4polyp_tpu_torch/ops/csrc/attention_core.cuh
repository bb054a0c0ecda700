// The attention kernels' shared device code (qkv_attention.cu, attn_proj.cu,
// attention.cu, attention_block.cu): staging one head's rows into shared
// memory (through registers where a bias or the scale fold applies, by
// cp.async where the rows are plain copies), one warp's 16 query rows through
// scores, softmax and the product with V, and the two-phase backward of one
// (batch, head) pair.
#pragma once

#include <math.h>

#include "common.cuh"

// Calls CALL(HD, NKT) with the smallest key-tile count NKT (tiles of 16) that
// holds N tokens, inside a function that returns a cudaError_t and has `N` in
// scope; cudaErrorInvalidValue past 256 tokens.
#define SSL4POLYP_FOR_TOKENS(CALL, HD) \
  if (N <= 64) return CALL(HD, 4);     \
  if (N <= 128) return CALL(HD, 8);    \
  if (N <= 208) return CALL(HD, 13);   \
  if (N <= 256) return CALL(HD, 16);   \
  return cudaErrorInvalidValue;

namespace {

// Copies `rows` rows of one head's HD columns into shared memory (row stride
// HD + 8 elements, which keeps the fragment loads free of bank conflicts).
// Rows at or past N are zero.  With `bias`, x + bias is rounded to bf16;
// with `fold_scale`, the result is then multiplied by `scale` and rounded
// again: the compute-dtype scale fold of the TPU kernel.  A thread issues
// the loads of eight of its 16-byte chunks before it touches the first: one
// trip to L2 for the batch, not one per chunk.
template <int HD>
__device__ void stage_rows(bf16* __restrict__ dst, int rows, const bf16* __restrict__ src,
                           int row0, int N, long ld, const bf16* __restrict__ bias, float scale,
                           bool fold_scale) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kLd = HD + 8;
  constexpr int kBatch = 8;
  const int total = rows * kChunks;
  const int stride = blockDim.x;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * stride) {
    uint4 chunk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      const int n = row0 + i / kChunks;
      chunk[u] = make_uint4(0, 0, 0, 0);
      if (i < total && n < N)
        chunk[u] = *reinterpret_cast<const uint4*>(src + n * ld + (i % kChunks) * 8);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      if (i >= total) break;
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      if (row0 + r < N && (bias != nullptr || fold_scale)) {
        bf16* e = reinterpret_cast<bf16*>(&chunk[u]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = __bfloat162float(e[j]);
          if (bias != nullptr) x = round_bf16(x + __bfloat162float(bias[c + j]));
          if (fold_scale) x = x * scale;
          e[j] = __float2bfloat16(x);
        }
      }
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = chunk[u];
    }
  }
}

// stage_rows for rows that need neither a bias nor the scale fold: 16-byte
// cp.async copies (rows at or past N zero-filled), all in flight at once.
// The caller commits the group and waits for it.
template <int HD>
__device__ __forceinline__ void stage_rows_async(bf16* dst, int rows, const bf16* src, int row0,
                                                 int N, long ld) {
  constexpr int kChunks = HD / 8;
  constexpr int kLd = HD + 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = row0 + r < N;
    cp_async_16(dst + r * kLd + c, ok ? src + (row0 + r) * ld + c : src, ok ? 16 : 0);
  }
}

// The scale fold on a packed pair of unscaled q values: round_bf16(q *
// scale_c) for each, as stage_rows folds it.
__device__ __forceinline__ uint32_t scale_pair(uint32_t packed, float scale_c) {
  return pack_floats(__uint_as_float(packed << 16) * scale_c,
                     __uint_as_float(packed & 0xffff0000u) * scale_c);
}

// One warp's 16 query rows (r0 .. r0 + 15 of the staged Q tile: scale-folded
// already, or, with SCALE_Q, unscaled and folded here with `q_scale`)
// against the whole staged K and V of the head (NKT key tiles of 16, keys
// past the sequence zero): the whole score row in registers (mma.sync
// m16n8k16, bf16 in, fp32 accumulate), keys >= n_valid masked to -inf, the
// scores optionally rounded to bf16, an exact softmax over the full row, the
// weights rounded to bf16 and multiplied by V.  With SCALE_SCORES, q is
// taken as it is and `q_scale` multiplies the fp32 scores instead (attention
// over separate q, k, v).  `o` receives the fp32 output
// fragments: o[n][0..1] row g, o[n][2..3] row g + 8, columns n * 8 + 2t, + 1.
template <int HD, int NKT, bool SCALE_Q = false, bool SCALE_SCORES = false>
__device__ __forceinline__ void attention_rows(const bf16* s_q, const bf16* s_k, const bf16* s_v,
                                               int r0, int lane, int n_valid, int softmax_f32,
                                               float (&o)[HD / 8][4], float q_scale = 1.0f) {
  constexpr int kLd = HD + 8;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* p = s_q + (r0 + g) * kLd + kk * 16 + 2 * t;
    qa[kk][0] = load_u32(p);
    qa[kk][1] = load_u32(p + 8 * kLd);
    qa[kk][2] = load_u32(p + 8);
    qa[kk][3] = load_u32(p + 8 * kLd + 8);
    if (SCALE_Q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], q_scale);
    }
  }

  // Scores: s[j] holds keys j*8 .. j*8+7; elements 0,1 are row g, 2,3 row g+8.
  float s[2 * NKT][4];
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bf16* p = s_k + (j * 8 + g) * kLd + kk * 16 + 2 * t;
      mma_16816(s[j], qa[kk], load_u32(p), load_u32(p + 8));
    }
  }

  float max0 = -INFINITY, max1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      float x = col < n_valid ? (SCALE_SCORES ? s[j][e] * q_scale : s[j][e]) : -INFINITY;
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
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    // The weights, normalised then rounded to bf16, as the A operand.
    const uint32_t pa[4] = {
        pack_floats(s[2 * kt][0] * inv0, s[2 * kt][1] * inv0),
        pack_floats(s[2 * kt][2] * inv1, s[2 * kt][3] * inv1),
        pack_floats(s[2 * kt + 1][0] * inv0, s[2 * kt + 1][1] * inv0),
        pack_floats(s[2 * kt + 1][2] * inv1, s[2 * kt + 1][3] * inv1),
    };
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const bf16* p = s_v + (kt * 16 + 2 * t) * kLd + n * 8 + g;
      mma_16816(o[n], pa, pack_halves(p[0], p[kLd]), pack_halves(p[8 * kLd], p[9 * kLd]));
    }
  }

}

// ---------------------------------------------------------------------------
// The backward of one (batch, head) pair whose Q (unscaled), K, V and dO
// tiles are staged in shared memory (NKT * 16 rows each, row stride HD + 8,
// rows at or past N zero or finite with a zero dO row), by a block of
// kBwdWarps warps.  dK and dV sum over every query row, so the routine runs
// in two phases instead of reducing across blocks:
//   A. warps own 16-row query tiles: whole score rows in registers, softmax,
//      tmp from dW tiles formed one 8-key slice at a time, then dW again for
//      dS and dQ += dS K.  The rows' max, 1/sum and tmp go to shared memory.
//   B. warps own 16-row key tiles: for each query tile, the transposed
//      scores S^T = K Q^T and dW^T = V dO^T give W^T and dS^T from the
//      phase-A statistics, and dV += W^T dO, dK += dS^T Q accumulate in
//      registers over all query tiles.
// Products run on mma.sync m16n8k16; operands that must be transposed are
// gathered from shared memory two bf16 values at a time.  MODE says where the
// TPU kernel this serves scales and rounds:
//   kBwdFold          qkv_attention.py, attn_proj.py: 1/sqrt(hd) folded into q
//                     in bf16 (scale_c); dV from round_bf16(W); dS =
//                     round_bf16(W * (dW - tmp)); dQ and dK times the fp32
//                     scale, then rounded.
//   kBwdFoldScaledDs  attention_block.py: as kBwdFold, but dS =
//                     round_bf16(W * (dW - tmp) * scale) and dQ, dK unscaled.
//   kBwdExact         attention.py: q as it is, the fp32 scores times scale;
//                     dV from the unrounded fp32 W and dS = W * (dW - tmp) *
//                     scale unrounded.  An fp32 operand enters the tensor
//                     cores as two bf16 terms (x = hi + lo, 16 bits of
//                     mantissa), each with its own mma.
// With `db` (the warp's 3 * HD floats of its block's dbias partial, zeroed by
// the caller), each warp adds its tiles' column sums of the rounded dQ, dK
// and dV in tile order.  dq_out, dk_out and dv_out point at row 0 of this
// head's columns, row stride `ld`.  Every thread of the block must call it
// (it synchronises the block between the phases).
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;
constexpr int kBwdFold = 0;
constexpr int kBwdFoldScaledDs = 1;
constexpr int kBwdExact = 2;

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

// The A operand of eight fp32 values (v[2i], v[2i + 1] are fragment register
// i): rounded to bf16 in `hi`; with SPLIT, `lo` holds the bf16 of what the
// rounding dropped, so that hi + lo carries 16 bits of mantissa.
template <bool SPLIT>
__device__ __forceinline__ void pack_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack_floats(v[2 * i], v[2 * i + 1]);
    if (SPLIT)
      lo[i] = pack_floats(v[2 * i] - __uint_as_float(hi[i] << 16),
                          v[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u));
  }
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

template <int HD, int NKT, int MODE>
__device__ __forceinline__ void attention_backward_tiles(
    const bf16* s_q, const bf16* s_k, const bf16* s_v, const bf16* s_do, float* s_max,
    float* s_inv, float* s_tmp, float* db, bf16* dq_out, bf16* dk_out, bf16* dv_out, long ld,
    int N, int n_valid, float scale_c, float scale, int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kNT = HD / 8;   // n-tiles of 8 head columns
  constexpr int kKT = HD / 16;  // k-steps of 16 head columns
  constexpr bool kExact = MODE == kBwdExact;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (N + 15) / 16;  // 16-row tiles holding rows < N
  const float ds_scale = MODE == kBwdFold ? 1.0f : scale;   // on dS, before its rounding
  const float out_scale = MODE == kBwdFold ? scale : 1.0f;  // on dQ and dK, before theirs

  // Phase A: query tiles.  dQ, and each row's max, 1/sum and tmp.
  for (int qt = warp; qt < n_tiles; qt += kBwdWarps) {
    const int r0 = qt * 16;
    float s[2 * NKT][4];
    {
      uint32_t qa[kKT][4];
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        load_a<kLd>(qa[kk], s_q + (r0 + g) * kLd + kk * 16 + 2 * t);
        if (!kExact) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], scale_c);
        }
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
        float x = col < n_valid ? (kExact ? s[j][e] * scale : s[j][e]) : -INFINITY;
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
      const float ds[8] = {
          w0[0] * (dw[0][0] - tmp0) * ds_scale, w0[1] * (dw[0][1] - tmp0) * ds_scale,
          w0[2] * (dw[0][2] - tmp1) * ds_scale, w0[3] * (dw[0][3] - tmp1) * ds_scale,
          w1[0] * (dw[1][0] - tmp0) * ds_scale, w1[1] * (dw[1][1] - tmp0) * ds_scale,
          w1[2] * (dw[1][2] - tmp1) * ds_scale, w1[3] * (dw[1][3] - tmp1) * ds_scale,
      };
      uint32_t dsa[4], dsa_lo[4];
      pack_a<kExact>(dsa, dsa_lo, ds);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const bf16* p = s_k + (kt * 16 + 2 * t) * kLd + n * 8 + g;
        mma_gather_b<kLd>(dq[n], dsa, p);
        if (kExact) mma_gather_b<kLd>(dq[n], dsa_lo, p);
      }
    }
    const int row_a = r0 + g;
    const int row_b = row_a + 8;
    uint32_t lo[kNT], hi[kNT];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      lo[n] = pack_floats(dq[n][0] * out_scale, dq[n][1] * out_scale);
      hi[n] = pack_floats(dq[n][2] * out_scale, dq[n][3] * out_scale);
      if (row_a < N) *reinterpret_cast<uint32_t*>(dq_out + row_a * ld + n * 8 + 2 * t) = lo[n];
      if (row_b < N) *reinterpret_cast<uint32_t*>(dq_out + row_b * ld + n * 8 + 2 * t) = hi[n];
    }
    if (db != nullptr) add_column_sums<kNT>(db, lo, hi, row_a < N, row_b < N, g, t);
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
          uint32_t q_lo = load_u32(pq + kk * 16), q_hi = load_u32(pq + kk * 16 + 8);
          if (!kExact) {
            q_lo = scale_pair(q_lo, scale_c);
            q_hi = scale_pair(q_hi, scale_c);
          }
          mma_16816(st[jn], ka[kk], q_lo, q_hi);
          mma_16816(dwt[jn], va[kk], load_u32(pd + kk * 16), load_u32(pd + kk * 16 + 8));
        }
      }
      // Element e of tile jn: key k0 + g (+ 8 for e >= 2), query q0 + 8 jn + 2t + (e & 1).
      // wt and dst in the A operand's order: (jn 0: e 0..3), (jn 1: e 0..3).
      float wt[8], dst[8];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + jn * 8 + 2 * t + (e & 1);
          float x = (e < 2 ? masked_a : masked_b) ? -INFINITY
                                                  : (kExact ? st[jn][e] * scale : st[jn][e]);
          if (!softmax_f32) x = round_bf16(x);
          const float w = expf(x - s_max[q]) * s_inv[q];
          wt[jn * 4 + e] = w;
          dst[jn * 4 + e] = w * (dwt[jn][e] - s_tmp[q]) * ds_scale;
        }
      }
      uint32_t wa[4], wa_lo[4], dsa[4], dsa_lo[4];
      pack_a<kExact>(wa, wa_lo, wt);
      pack_a<kExact>(dsa, dsa_lo, dst);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const bf16* p_do = s_do + (q0 + 2 * t) * kLd + n * 8 + g;
        const bf16* p_q = s_q + (q0 + 2 * t) * kLd + n * 8 + g;
        mma_gather_b<kLd>(dv[n], wa, p_do);
        mma_gather_b<kLd>(dk[n], dsa, p_q);
        if (kExact) {
          mma_gather_b<kLd>(dv[n], wa_lo, p_do);
          mma_gather_b<kLd>(dk[n], dsa_lo, p_q);
        }
      }
    }
    const int row_a = k0 + g;
    const int row_b = row_a + 8;
    uint32_t klo[kNT], khi[kNT], vlo[kNT], vhi[kNT];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      klo[n] = pack_floats(dk[n][0] * out_scale, dk[n][1] * out_scale);
      khi[n] = pack_floats(dk[n][2] * out_scale, dk[n][3] * out_scale);
      vlo[n] = pack_floats(dv[n][0], dv[n][1]);
      vhi[n] = pack_floats(dv[n][2], dv[n][3]);
      const long at_a = row_a * ld + n * 8 + 2 * t;
      const long at_b = row_b * ld + n * 8 + 2 * t;
      if (row_a < N) {
        *reinterpret_cast<uint32_t*>(dk_out + at_a) = klo[n];
        *reinterpret_cast<uint32_t*>(dv_out + at_a) = vlo[n];
      }
      if (row_b < N) {
        *reinterpret_cast<uint32_t*>(dk_out + at_b) = khi[n];
        *reinterpret_cast<uint32_t*>(dv_out + at_b) = vhi[n];
      }
    }
    if (db != nullptr) {
      add_column_sums<kNT>(db + HD, klo, khi, row_a < N, row_b < N, g, t);
      add_column_sums<kNT>(db + 2 * HD, vlo, vhi, row_a < N, row_b < N, g, t);
    }
  }
}

// One block's row of the (B, 3D) fp32 dbias partial from its warps' partials
// (s_db: [kBwdWarps][3 * HD]), added in warp order.  The caller synchronises
// the block first.
template <int HD>
__device__ __forceinline__ void store_dbias_partial(const float* s_db, float* dbias_part, int b,
                                                    int h, int D) {
  for (int c = threadIdx.x; c < 3 * HD; c += blockDim.x) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) total += s_db[w * 3 * HD + c];
    dbias_part[static_cast<long>(b) * 3 * D + (c / HD) * D + h * HD + c % HD] = total;
  }
}

}  // namespace
