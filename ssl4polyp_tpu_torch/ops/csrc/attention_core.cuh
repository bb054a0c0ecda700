// The attention kernels' shared device code (qkv_attention.cu, forward and
// backward, and attn_proj.cu): staging one head's rows into shared memory
// (through registers where a bias or the scale fold applies, by cp.async
// where the rows are plain copies), and one warp's 16 query rows through
// scores, softmax and the product with V.
#pragma once

#include <math.h>

#include "common.cuh"

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
// weights rounded to bf16 and multiplied by V.  `o` receives the fp32 output
// fragments: o[n][0..1] row g, o[n][2..3] row g + 8, columns n * 8 + 2t, + 1.
template <int HD, int NKT, bool SCALE_Q = false>
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

}  // namespace
