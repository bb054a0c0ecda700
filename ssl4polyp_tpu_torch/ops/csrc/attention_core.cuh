// The attention kernels' shared device code (qkv_attention.cu, attn_proj.cu,
// attention.cu, attention_block.cu): staging one head's rows into shared
// memory (through registers where a bias or the scale fold applies, by
// cp.async where the rows are plain copies, or by cp.async with the bias and
// the scale fold applied afterwards in place), one warp's 16 query rows
// through scores, softmax and the product with V (operands read with
// ldmatrix), the 16-byte stores of a 16-row output tile, and the backward's
// first design: two phases over one (batch, head) pair that recompute dS in
// the second.
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

// The column tiles of 8 keys that hold no key past N for every token count
// SSL4POLYP_FOR_TOKENS sends to the key width 16 * NKT (the fewest it sends
// over 8).
__host__ __device__ constexpr int nkt_whole(int nkt) {
  return (nkt == 4 ? 1 : nkt == 8 ? 65 : nkt == 13 ? 129 : 209) / 8;
}

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

// stage_rows for rows that need neither a bias nor the scale fold, or get
// them afterwards from finish_rows_in_place: 16-byte cp.async copies (rows at
// or past N zero-filled), all in flight at once, made by threads `tid` of
// `threads` (the whole block in the short form below; a warp stages a tile
// of its own with its lane and 32).  The caller commits the group and waits for it.
template <int HD>
__device__ __forceinline__ void stage_rows_async(bf16* dst, int rows, const bf16* src, int row0,
                                                 int N, long ld, int tid, int threads) {
  constexpr int kChunks = HD / 8;
  constexpr int kLd = HD + 8;
  for (int i = tid; i < rows * kChunks; i += threads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = row0 + r < N;
    cp_async_16(dst + r * kLd + c, ok ? src + (row0 + r) * ld + c : src, ok ? 16 : 0);
  }
}

template <int HD>
__device__ __forceinline__ void stage_rows_async(bf16* dst, int rows, const bf16* src, int row0,
                                                 int N, long ld) {
  stage_rows_async<HD>(dst, rows, src, row0, N, ld, threadIdx.x, blockDim.x);
}

// The bias add and the scale fold of stage_rows, with the same roundings
// (round_bf16(x + bias), then times `scale` and rounded again), in place on
// rows that stage_rows_async copied: each thread finishes the chunks it
// copied itself, so its own cp.async wait is all it needs first.  Rows at or
// past N stay zero.  The caller synchronises the readers afterwards.
//
// Both steps run as packed bf16 instructions (add.rn.bf16x2, mul.rn.bf16x2),
// two instructions for 16 bytes, and give the bits of the fp32 route: a sum of
// two bf16 values is exact in fp32 unless their exponents are more than 16
// apart, where both routes return the larger operand; a product of two bf16
// values (`scale` must be one: the wrappers pass 1/sqrt(hd) as the compute
// dtype holds it) has 16 significant bits, exact in fp32.
template <int HD>
__device__ __forceinline__ void finish_rows_in_place(bf16* dst, int rows, int row0, int N,
                                                     const bf16* __restrict__ bias, float scale,
                                                     bool fold_scale, int tid, int threads) {
  constexpr int kChunks = HD / 8;
  constexpr int kLd = HD + 8;
  if (bias == nullptr && !fold_scale) return;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
  for (int i = tid; i < rows * kChunks; i += threads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (row0 + r >= N) continue;
    uint4 chunk = *reinterpret_cast<const uint4*>(dst + r * kLd + c);
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&chunk);
    if (bias != nullptr) {
      const uint4 add = *reinterpret_cast<const uint4*>(bias + c);
      const __nv_bfloat162* add_pairs = reinterpret_cast<const __nv_bfloat162*>(&add);
#pragma unroll
      for (int j = 0; j < 4; ++j) pairs[j] = __hadd2(pairs[j], add_pairs[j]);
    }
    if (fold_scale) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pairs[j] = __hmul2(pairs[j], scale2);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = chunk;
  }
}

// The scale fold on a packed pair of unscaled q values: round_bf16(q *
// scale_c) for each, as stage_rows folds it.
__device__ __forceinline__ uint32_t scale_pair(uint32_t packed, float scale_c) {
  return pack_floats(__uint_as_float(packed << 16) * scale_c,
                     __uint_as_float(packed & 0xffff0000u) * scale_c);
}

// One warp's 16 query rows against the whole staged K and V of the head, in
// three steps that attention_rows strings together and the QKV forward kernel
// interleaves with its copies.  Shared tiles have a row stride of HD + 8
// elements, which keeps every ldmatrix free of bank conflicts.

// The A fragments of rows r0 .. r0 + 15 of the staged Q tile: one ldmatrix.x4
// for each 16 columns.
template <int HD>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qa)[HD / 16][4], const bf16* s_q, int r0,
                                                 int lane) {
  constexpr int kLd = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qa[kk], s_q + (r0 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
}

// The softmax of attention_scores on a whole score row in registers (s[j]:
// keys j*8 .. j*8+7, elements 0, 1 of row g and 2, 3 of row g + 8): with
// SCALE_SCORES, `score_scale` multiplies the fp32 scores; keys >= n_valid are
// masked to -inf (keys past the sequence are zero rows); the scores are
// optionally rounded to bf16; an exact softmax over the full row.  Leaves in s
// the unnormalised weights exp(s - max); inv0 and inv1 are the rows' 1 / sum,
// max0 and max1 their maxima.  With EXP2, exp(s - max) is exp2_approx(s *
// log2(e) - max * log2(e)) (one FMA and the special function unit, where
// expf takes about ten instructions), and max0, max1 are the maxima times
// log2(e).
template <int NKT, bool SCALE_SCORES, bool EXP2 = false>
__device__ __forceinline__ void attention_softmax(float (&s)[2 * NKT][4], int lane, int n_valid,
                                                  int softmax_f32, float score_scale,
                                                  float& inv0, float& inv1, float& max0,
                                                  float& max1) {
  const int t = lane & 3;  // thread in group
  // The mask touches only the column tiles that reach past n_valid, and the
  // rounding is one pass under one test: both conditions are the same for
  // the whole warp.
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
    const bool whole = j * 8 + 8 <= n_valid;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (SCALE_SCORES) s[j][e] *= score_scale;
      if (!whole && j * 8 + 2 * t + (e & 1) >= n_valid) s[j][e] = -INFINITY;
    }
  }
  if (!softmax_f32) {
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = round_bf16(s[j][e]);
  }
  max0 = -INFINITY;
  max1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
    max0 = fmaxf(max0, fmaxf(s[j][0], s[j][1]));
    max1 = fmaxf(max1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    max0 = fmaxf(max0, __shfl_xor_sync(0xffffffffu, max0, off));
    max1 = fmaxf(max1, __shfl_xor_sync(0xffffffffu, max1, off));
  }
  float sum0 = 0.0f, sum1 = 0.0f;
  if (EXP2) {
    max0 *= kLog2e;
    max1 *= kLog2e;
  }
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = e < 2 ? max0 : max1;
      s[j][e] = EXP2 ? exp2_approx(fmaf(s[j][e], kLog2e, -m)) : expf(s[j][e] - m);
    }
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  inv0 = 1.0f / sum0;
  inv1 = 1.0f / sum1;
}

// Scores and softmax: the whole score row in registers (mma.sync m16n8k16,
// bf16 in, fp32 accumulate; one ldmatrix.x4 of K feeds two products), then
// attention_softmax.  Leaves in s the unnormalised weights exp(s - max): s[j]
// holds keys j*8 .. j*8+7, elements 0, 1 of row g and 2, 3 of row g + 8; inv0
// and inv1 are the rows' 1 / sum.
template <int HD, int NKT, bool SCALE_SCORES>
__device__ __forceinline__ void attention_scores(const uint32_t (&qa)[HD / 16][4], const bf16* s_k,
                                                 int lane, int n_valid, int softmax_f32,
                                                 float score_scale, float (&s)[2 * NKT][4],
                                                 float& inv0, float& inv1) {
  constexpr int kLd = HD + 8;
  // Matrices of one ldmatrix.x4: (keys j*8.., k 0-7), (same keys, k 8-15),
  // (keys (j+1)*8.., k 0-7), (those keys, k 8-15).
  const bf16* k_lane = s_k + ((lane / 16) * 8 + lane % 8) * kLd + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  // The step along hd outside, the key tiles inside: neighbouring products
  // add into different accumulators, so none waits for the one before it
  // (each s[j] still sums its steps in order).
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 2 * NKT; j += 2) {
      uint32_t kb[4];
      ldmatrix_x4(kb, k_lane + j * 8 * kLd + kk * 16);
      mma_16816(s[j], qa[kk], kb[0], kb[1]);
      mma_16816(s[j + 1], qa[kk], kb[2], kb[3]);
    }
  }
  float max0, max1;
  attention_softmax<NKT, SCALE_SCORES>(s, lane, n_valid, softmax_f32, score_scale, inv0, inv1,
                                       max0, max1);
}

// The weights, normalised then rounded to bf16, times V: the score fragments
// become the A operand without leaving registers, and one ldmatrix.x4.trans
// of V (whose reduction index runs down its rows) feeds two products.  `o`
// receives the fp32 output fragments: o[n][0..1] row g, o[n][2..3] row g + 8,
// columns n * 8 + 2t, + 1.
template <int HD, int NKT>
__device__ __forceinline__ void attention_values(const float (&s)[2 * NKT][4], float inv0,
                                                 float inv1, const bf16* s_v, int lane,
                                                 float (&o)[HD / 8][4]) {
  constexpr int kLd = HD + 8;
  // Matrices of one ldmatrix.x4.trans: (keys 0-7, columns n*8..), (keys 8-15,
  // those columns), (keys 0-7, columns (n+1)*8..), (keys 8-15, those columns).
  const bf16* v_lane = s_v + (((lane / 8) % 2) * 8 + lane % 8) * kLd + (lane / 16) * 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    const uint32_t pa[4] = {
        pack_floats(s[2 * kt][0] * inv0, s[2 * kt][1] * inv0),
        pack_floats(s[2 * kt][2] * inv1, s[2 * kt][3] * inv1),
        pack_floats(s[2 * kt + 1][0] * inv0, s[2 * kt + 1][1] * inv0),
        pack_floats(s[2 * kt + 1][2] * inv1, s[2 * kt + 1][3] * inv1),
    };
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_lane + kt * 16 * kLd + n * 8);
      mma_16816(o[n], pa, vb[0], vb[1]);
      mma_16816(o[n + 1], pa, vb[2], vb[3]);
    }
  }
}

// The three steps in a row, for rows r0 .. r0 + 15 of the staged Q tile:
// scale-folded already, or, with SCALE_Q, unscaled and folded here with
// `q_scale`; with SCALE_SCORES, q is taken as it is and `q_scale` multiplies
// the fp32 scores instead (attention over separate q, k, v).
template <int HD, int NKT, bool SCALE_Q = false, bool SCALE_SCORES = false>
__device__ __forceinline__ void attention_rows(const bf16* s_q, const bf16* s_k, const bf16* s_v,
                                               int r0, int lane, int n_valid, int softmax_f32,
                                               float (&o)[HD / 8][4], float q_scale = 1.0f) {
  uint32_t qa[HD / 16][4];
  load_q_fragments<HD>(qa, s_q, r0, lane);
  if (SCALE_Q) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], q_scale);
  }
  float s[2 * NKT][4];
  float inv0, inv1;
  attention_scores<HD, NKT, SCALE_SCORES>(qa, s_k, lane, n_valid, softmax_f32, q_scale, s, inv0, inv1);
  attention_values<HD, NKT>(s, inv0, inv1, s_v, lane, o);
}

// Stores a 16 x HD tile of packed bf16 pairs (lo[n]: row g, columns n * 8 +
// 2t, + 1; hi[n]: row g + 8) at out_a (row g's first column) and out_b (row g
// + 8's), a row only where its ok flag is set: 16-byte stores (lane t takes
// column tile n + t after a quad transpose) where HD is a multiple of 32.
// Every lane of the warp must call it.
template <int HD>
__device__ __forceinline__ void store_tile_rows(bf16* out_a, bf16* out_b, uint32_t (&lo)[HD / 8],
                                                uint32_t (&hi)[HD / 8], bool ok_a, bool ok_b,
                                                int t) {
  if constexpr (HD % 32 == 0) {
#pragma unroll
    for (int n = 0; n < HD / 8; n += 4) {
      uint32_t a[4] = {lo[n], lo[n + 1], lo[n + 2], lo[n + 3]};
      uint32_t c[4] = {hi[n], hi[n + 1], hi[n + 2], hi[n + 3]};
      quad_transpose(a, t);
      quad_transpose(c, t);
      if (ok_a) *reinterpret_cast<uint4*>(out_a + (n + t) * 8) = make_uint4(a[0], a[1], a[2], a[3]);
      if (ok_b) *reinterpret_cast<uint4*>(out_b + (n + t) * 8) = make_uint4(c[0], c[1], c[2], c[3]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (ok_a) *reinterpret_cast<uint32_t*>(out_a + n * 8 + 2 * t) = lo[n];
      if (ok_b) *reinterpret_cast<uint32_t*>(out_b + n * 8 + 2 * t) = hi[n];
    }
  }
}

// ---------------------------------------------------------------------------
// The backward's first design, which keeps no dS: the backward of one (batch,
// head) pair whose Q (unscaled), K, V and dO tiles are staged in shared memory
// (NKT * 16 rows each, row stride HD + 8, rows at or past N zero or finite
// with a zero dO row), by a block of kBwdWarps warps.  It serves
// qkv_attention.cu's path past 208 tokens, where a stored dS does not fit
// beside the four tiles (its backward keeps dS in shared memory up to 208),
// and the first designs of attention.cu's and attention_block.cu's
// backwards, which only their probes reach, for timing (attention.cu's
// backward runs on wgmma: the note at the head of that file).  dK and dV
// sum over every query row, so the routine runs in two phases instead of
// reducing across blocks:
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
__device__ __forceinline__ void attention_backward_recompute_ds(
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

// One step of a reduce-scatter across the lanes `off` apart: a lane keeps
// one half of its HALF * 2 values, sends the other, and adds what its
// partner sent for the half it kept (the lane with the `off` bit keeps the
// upper half).
template <int HALF>
__device__ __forceinline__ void scatter_step(float* v, int off, bool upper) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// add_column_sums for HD >= 32 with a third of its shuffles: the 2 HD / 8
// column values of a lane (rows g and g + 8 added, each only below N) are
// summed over the eight row groups by a reduce-scatter (lanes 16, 8, 4
// apart), after which lane (g, t) holds value g * m + j (m = HD / 32), the
// sum of column (i / 2) * 8 + 2t + i % 2 for i = g * m + j, and adds it to
// `dst` itself.  The order of the additions is fixed by the shape.
template <int HD>
__device__ __forceinline__ void add_column_sums_scattered(float* dst, const uint32_t (&lo)[HD / 8],
                                                          const uint32_t (&hi)[HD / 8], bool ok_lo,
                                                          bool ok_hi, int lane) {
  constexpr int kM = HD / 4;
  float v[kM];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    v[2 * n] = v[2 * n + 1] = 0.0f;
    if (ok_lo) {
      v[2 * n] += __uint_as_float(lo[n] << 16);
      v[2 * n + 1] += __uint_as_float(lo[n] & 0xffff0000u);
    }
    if (ok_hi) {
      v[2 * n] += __uint_as_float(hi[n] << 16);
      v[2 * n + 1] += __uint_as_float(hi[n] & 0xffff0000u);
    }
  }
  scatter_step<kM / 2>(v, 16, lane & 16);
  scatter_step<kM / 4>(v, 8, lane & 8);
  scatter_step<kM / 8>(v, 4, lane & 4);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kM / 8; ++j) {
    const int i = g * (kM / 8) + j;
    dst[(i / 2) * 8 + 2 * t + i % 2] += v[j];
  }
}

// A 16 x HD gradient tile, fp32 fragments times `mult`, rounded to bf16: its
// column sums (rows below N) go to `db` when there is one, its rows below N
// to `out` (row r0 of the head's columns, row stride ld).
template <int HD>
__device__ __forceinline__ void store_gradient_tile(const float (&acc)[HD / 8][4], float mult,
                                                    bf16* out, long ld, int r0, int N, float* db,
                                                    int g, int t) {
  uint32_t lo[HD / 8], hi[HD / 8];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    lo[n] = pack_floats(acc[n][0] * mult, acc[n][1] * mult);
    hi[n] = pack_floats(acc[n][2] * mult, acc[n][3] * mult);
  }
  const int row_a = r0 + g;
  const int row_b = row_a + 8;
  if (db != nullptr) {
    if constexpr (HD >= 32)
      add_column_sums_scattered<HD>(db, lo, hi, row_a < N, row_b < N, 4 * g + t);
    else
      add_column_sums<HD / 8>(db, lo, hi, row_a < N, row_b < N, g, t);
  }
  store_tile_rows<HD>(out + row_a * ld, out + row_b * ld, lo, hi, row_a < N, row_b < N, t);
}

// One block's row of the (B, 3D) fp32 dbias partial from its WARPS warps'
// partials (s_db: [WARPS][3 * HD]), added in warp order.  The caller
// synchronises the block first.
template <int HD, int WARPS = kBwdWarps>
__device__ __forceinline__ void store_dbias_partial(const float* s_db, float* dbias_part, int b,
                                                    int h, int D) {
  for (int c = threadIdx.x; c < 3 * HD; c += blockDim.x) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += s_db[w * 3 * HD + c];
    dbias_part[static_cast<long>(b) * 3 * D + (c / HD) * D + h * HD + c % HD] = total;
  }
}

}  // namespace
