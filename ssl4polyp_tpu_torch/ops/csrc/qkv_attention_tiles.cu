// Attention straight from the fused QKV projection in bf16 past 256 tokens,
// forward and backward, on 64-row query tiles and 64-key tiles.
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel and _bwd_kernel
// (fused_qkv_attention), ::_fwd_bias_kernel and _bwd_bias_kernel
// (fused_qkv_bias_attention) at more than 256 tokens, where qkv_attention.cu's
// kernels hold a head's whole K and V (and a whole score row) on chip and
// stop.  A ViT-B/16 at 384 px has 577 tokens; its K and V alone would take
// about 170 KB of shared memory at hd 64.  qkv_attention.cu's C entry points
// send N > 256 here; N <= 256 never comes here.
//
// The same kernels also replace ssl4polyp_tpu/ops/attention.py::
// _attention_kernel and _attention_bwd_kernel (fused_attention) in bf16 past
// 256 tokens, where attention.cu's kernels stop: attention over separate (B,
// H, N, hd) q, k and v, every key weighted, no bias.  The layout is a
// template parameter (SEP; HeadRows in common.cuh), and with it go that
// kernel's roundings, which differ from rows 1-2's at 2, 3 and 5 below: q
// enters the scores as it is and the fp32 scores are multiplied by the fp32
// 1/sqrt(hd) (no bf16 fold), always softmax_f32; the backward keeps W and dS
// = W (dW - tmp) scale in fp32 (kBwdExact), each carried into the tensor
// cores as two bf16 terms, and rounds each gradient once.
//
// The TPU kernels' roundings, which these kernels keep (the plain versions,
// ops/qkv_attention.py::fused_qkv_attention_reference and
// fused_qkv_attention_backward_reference, spell them out):
//   1. x = round_bf16(qkv + bias) for q, k and v (packed bf16 adds on each
//      tile as it lands, finish_rows_in_place: the fp32 route's bits);
//   2. qs = round_bf16(x_q * scale_c), scale_c the bf16 1/sqrt(hd) (a power
//      of two at hd 16 and 64, a real rounding at hd 32);
//   3. fp32 scores qs . k^T (mma.sync, fp32 accumulation), keys at or past
//      n_valid at -inf, rounded to bf16 first when softmax_f32 is 0;
//   4. forward: the NORMALISED weights rounded to bf16 before the product
//      with v, fp32 accumulation, the output rounded once;
//   5. backward: W recomputed in fp32 from the row's max and 1/sum; dV =
//      round(W)^T dO; dW = dO V^T; tmp = rowsum(dW * W) with the unrounded W
//      (not dO . O: the bf16 O is rounded); dS = round_bf16(W (dW - tmp)),
//      and with mode 1 (ssl4polyp_tpu/ops/attention_block.py's placement)
//      round_bf16(W (dW - tmp) scale); dQ = dS K and dK = dS^T Q with the
//      unscaled q, times the fp32 scale before their rounding in mode 0;
//      dbias the fp32 sum of the rounded dqkv over every row.
// An online softmax rounds the unnormalised weights and rescales afterwards,
// which is a different rounding, so the forward takes TWO sweeps over the
// key tiles: the first keeps each row's running max and sum (exp2 on the
// special function unit, ex2.approx, as qkv_attention.cu's backward), the
// second recomputes S = Qs K^T and multiplies w = round_bf16(exp(s - m) / l)
// by V.  Max and sum come from fp32 sums in another order than the plain
// version's, so a weight's rounding may flip where the plain version's
// falls on a tie: one bf16 ulp, inside the stated tolerances.
//
// What bounds them on the H100: at a ViT-B/16 classifier's shape at 384 px
// (B 64, N 577, 12 heads of 64) the forward moves 227 MB (qkv in, out out)
// against 65.5 GFLOP of its two products: 0.068 ms of HBM traffic, 0.066 ms
// of bf16 tensor-core time, so bytes bound it, just; the backward's five
// products (164 GFLOP, 0.165 ms) bound it above its 397 MB.  The second
// sweep (and the backward's statistics pass) recompute S, which costs
// tensor-core time and no HBM traffic: K and V tiles are read again from L2,
// since the query tile is the fastest grid index and the blocks of one head
// run side by side.
//
// The design (mma.sync m16n8k16 with ldmatrix feeds, as qkv_attention.cu;
// wgmma and TMA are later work):
//   * Forward (qkv_attention_tiles_kernel<HD, false>): one block of 4 warps
//     for each (64-row query tile, head, image); warp w owns query rows 16w ..
//     16w + 15 of the tile.  Q is staged once (bias and scale fold in place);
//     the key tiles stream through two buffers by cp.async, stage j + 1's
//     copy under stage j's products: stages 0 .. T - 1 bring K (the sweep of
//     the max and sum), stages T .. 2T - 1 bring K and V (the sweep of the
//     weights), T = ceil(n_valid / 64): key tiles wholly at or past n_valid
//     are never read.  Tiles that run past N are zero-filled by cp.async's
//     source size and never written; their keys are masked (they are past
//     n_valid), and their zero V rows meet zero weights.  A tile always holds
//     a key below n_valid, so a row's running max is finite after the first
//     tile and -inf never reaches exp2 as -inf - (-inf).
//   * Backward, two kernels and a column sum:
//     1. The statistics pass (qkv_attention_tiles_kernel<HD, true>): the
//        forward's grid and sweeps, with the query tile's dO rows staged
//        beside Q; its second sweep forms W in fp32 and dW = dO V^T and sums
//        tmp = rowsum(dW * W).  Each row's (max * log2(e), 1/sum, tmp) goes
//        to a (B, H, N) float4 scratch.
//     2. The gradient pass (qkv_attention_tiles_bwd_kernel): one block of 4
//        warps for each (head, image) walks the key tiles in ascending
//        order and, for each, the query tiles in ascending order (as
//        qkv_attention_f32.cu's backward).  A stage holds K, V (two buffers,
//        by key tile), Q, its scaled copy Qs, dO and the query tile's
//        statistics (two buffers, by stage); stage j + 1's copies run under
//        stage j.  Warp w owns keys 16w .. 16w + 15: for each 16 queries,
//        S^T = K Qs^T and dW^T = V dO^T rebuild W^T from the statistics, then
//        dV += round(W)^T dO and dK += dS^T Q in registers over the query
//        tiles, and dS^T goes to shared memory.  Then warp w owns queries 16w
//        .. 16w + 15: dQ's part dS K (dS^T read with ldmatrix.trans) is added
//        to an fp32 (B, H, N, hd) scratch in key-tile order; the last key
//        tile scales, rounds and stores it.  One block owns a head's rows,
//        so there are no atomics and reruns give the same bits (F8 in
//        ROADMAP.md §3).  Key tiles wholly past n_valid get dK = dV = 0.
//     3. With a bias, each warp adds the column sums of its rounded tiles to
//        its own partial in tile order, the block adds its warps in warp
//        order into its image's row of a (B, 3D) partial, and
//        column_sum_kernel adds the B rows in order: dbias.
//   Shared memory: forward 5 tiles of 64 rows at a stride of hd + 8 (46 KB at
//   hd 64), statistics pass 6, gradient pass 10 tiles, dS^T and the
//   statistics (106 KB at hd 64, two blocks an SM).  In kBwdExact the
//   gradient pass has no Qs tiles (its scores take q as it is) and no dbias
//   partials, and holds dS^T's second term: 8 tiles, two dS^T and the
//   statistics (94 KB at hd 64, two blocks an SM); its dV, dK and dQ take
//   eight products a pair of tiles where the other modes take five.
#include "attention_core.cuh"
#include "qkv_attention_tiles.cuh"

namespace {

constexpr int kRows = 64;             // query rows or keys of a tile
constexpr int kTileWarps = 4;         // warp w takes rows 16w .. 16w + 15 of a tile
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kLdS = kRows + 8;       // dS^T's row stride (elements)

template <int HD>
__host__ __device__ constexpr int tile_elems() { return kRows * (HD + 8); }

template <int HD, bool STATS>
constexpr size_t fwd_smem_bytes() {
  return static_cast<size_t>((STATS ? 6 : 5) * tile_elems<HD>()) * sizeof(bf16);
}

// The gradient pass's shared memory: 10 tiles (K, V, Q, Qs and dO, two
// buffers each), dS^T, the statistics and the dbias partials; in kBwdExact
// (fused_attention's: no Qs, no bias) 8 tiles, dS^T's two terms and the
// statistics.
template <int HD, int MODE>
constexpr size_t bwd_smem_bytes() {
  constexpr bool exact = MODE == kBwdExact;
  return static_cast<size_t>((exact ? 8 : 10) * tile_elems<HD>() + (exact ? 2 : 1) * kRows * kLdS) *
             sizeof(bf16) +
         2 * kRows * sizeof(float4) +
         (exact ? 0 : static_cast<size_t>(kTileWarps) * 3 * HD * sizeof(float));
}

// The scores of a warp's 16 rows (A fragments `a`) against the 64 rows of
// `b_tile` taken transposed (keys or queries, at a stride of HD + 8): s[j]
// holds columns 8j .. 8j + 7, elements 0, 1 of row g and 2, 3 of row g + 8.
template <int HD>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const uint32_t (&a)[HD / 16][4],
                                            const bf16* b_tile, int lane) {
  constexpr int kLd = HD + 8;
  const bf16* b_lane = b_tile + ((lane / 16) * 8 + lane % 8) * kLd + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t b[4];
      ldmatrix_x4(b, b_lane + c * 16 * kLd + kk * 16);
      mma_16816(s[2 * c], a[kk], b[0], b[1]);
      mma_16816(s[2 * c + 1], a[kk], b[2], b[3]);
    }
  }
}

// Keys at or past n_valid to -inf (k0: the tile's first key), then the
// rounding to bf16 when softmax_f32 is 0.  With SEP (fused_attention's
// roundings) the fp32 scores are first multiplied by `scale`, the fp32
// 1/sqrt(hd), and softmax_f32 is 1.
template <bool SEP>
__device__ __forceinline__ void mask_scores(float (&s)[8][4], int k0, int n_valid,
                                            int softmax_f32, float scale, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = k0 + j * 8 + 2 * t + (e & 1) >= n_valid ? -INFINITY : s[j][e];
      if constexpr (SEP) x *= scale;
      s[j][e] = softmax_f32 ? x : round_bf16(x);
    }
}

// grid (query tiles, H, B), kTileThreads threads; q, k, v, out and dout as
// HeadRows<SEP> lays them out.  STATS false: the forward, writing out.
// STATS true: the backward's statistics pass, reading dout and writing
// stats (B, H, N): (max * log2(e), 1/sum, tmp, 0).  `scale`: scale_c, which
// folds into q (roundings 1-3 above), or with SEP the fp32 1/sqrt(hd) on the
// fp32 scores (fused_attention's; no bias).
template <int HD, bool STATS, bool SEP>
__global__ void __launch_bounds__(kTileThreads, 4)
qkv_attention_tiles_kernel(const bf16* __restrict__ q_base, const bf16* __restrict__ k_base,
                           const bf16* __restrict__ v_base, const bf16* __restrict__ bias,
                           const bf16* __restrict__ dout, bf16* __restrict__ out,
                           float4* __restrict__ stats, int N, int H, int n_valid, float scale,
                           int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kTile = tile_elems<HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // biased and scale-folded (without SEP)
  bf16* s_do = s_q + kTile;                   // the statistics pass only
  bf16* s_k = s_q + (STATS ? 2 : 1) * kTile;  // two buffers
  bf16* s_v = s_k + 2 * kTile;                // two buffers

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * HD;
  const HeadRows<SEP> rows(b, h, N, H, HD);
  const long ld = rows.ld;
  const bf16* src_q = q_base + rows.at;
  const bf16* src_k = k_base + rows.at;
  const bf16* src_v = v_base + rows.at;
  const bf16* bias_q = bias == nullptr ? nullptr : bias + h * HD;
  const bf16* bias_k = bias == nullptr ? nullptr : bias + D + h * HD;
  const bf16* bias_v = bias == nullptr ? nullptr : bias + 2 * D + h * HD;
  const int key_tiles = (n_valid + kRows - 1) / kRows;
  const int stages = 2 * key_tiles;
  const int r0 = warp * 16;
  const bool has = q0 + r0 < N;  // the warp holds a row below N

  // Stage j < key_tiles brings K(j); stage key_tiles + i brings K(i) and V(i).
  auto issue = [&](int j) {
    const int second = j >= key_tiles;
    const int k0 = (second ? j - key_tiles : j) * kRows;
    stage_rows_async<HD>(s_k + (j & 1) * kTile, kRows, src_k, k0, N, ld);
    if (second) stage_rows_async<HD>(s_v + (j & 1) * kTile, kRows, src_v, k0, N, ld);
  };

  stage_rows_async<HD>(s_q, kRows, src_q, q0, N, ld);
  if (STATS) stage_rows_async<HD>(s_do, kRows, dout + rows.o, q0, N, rows.o_ld);
  issue(0);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  uint32_t da[HD / 16][4];  // dO's fragments: the statistics pass only
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g, g + 8: running max * log2(e)
  float l0 = 0.0f, l1 = 0.0f;            // this thread's part of their sums
  float inv0 = 0.0f, inv1 = 0.0f;
  float tmp0 = 0.0f, tmp1 = 0.0f;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int j = 0; j < stages; ++j) {
    if (j + 1 < stages) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage j's copies (and Q's, dO's at j = 0) are in
    const int second = j >= key_tiles;
    const int k0 = (second ? j - key_tiles : j) * kRows;
    const bf16* k_tile = s_k + (j & 1) * kTile;
    const bf16* v_tile = s_v + (j & 1) * kTile;
    if (j == 0)
      finish_rows_in_place<HD>(s_q, kRows, q0, N, bias_q, scale, !SEP, threadIdx.x, blockDim.x);
    finish_rows_in_place<HD>(s_k + (j & 1) * kTile, kRows, k0, N, bias_k, 1.0f, false, threadIdx.x,
                             blockDim.x);
    if (second)
      finish_rows_in_place<HD>(s_v + (j & 1) * kTile, kRows, k0, N, bias_v, 1.0f, false,
                               threadIdx.x, blockDim.x);
    __syncthreads();
    if (j == 0 && has) {
      load_q_fragments<HD>(qa, s_q, r0, lane);
      if (STATS) load_q_fragments<HD>(da, s_do, r0, lane);
    }
    if (j == key_tiles) {  // the first sweep is done: 1 / sum of each row
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      inv0 = 1.0f / l0;
      inv1 = 1.0f / l1;
    }
    if (has) {
      float s[8][4];
      tile_scores<HD>(s, qa, k_tile, lane);
      mask_scores<SEP>(s, k0, n_valid, softmax_f32, scale, t);
      if (!second) {  // the running max and sum
        float tile0 = -INFINITY, tile1 = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          tile0 = fmaxf(tile0, fmaxf(s[jj][0], s[jj][1]));
          tile1 = fmaxf(tile1, fmaxf(s[jj][2], s[jj][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          tile0 = fmaxf(tile0, __shfl_xor_sync(0xffffffffu, tile0, off));
          tile1 = fmaxf(tile1, __shfl_xor_sync(0xffffffffu, tile1, off));
        }
        const float n0 = fmaxf(m0, tile0 * kLog2e);
        const float n1 = fmaxf(m1, tile1 * kLog2e);
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          sum0 += exp2_approx(fmaf(s[jj][0], kLog2e, -n0)) + exp2_approx(fmaf(s[jj][1], kLog2e, -n0));
          sum1 += exp2_approx(fmaf(s[jj][2], kLog2e, -n1)) + exp2_approx(fmaf(s[jj][3], kLog2e, -n1));
        }
        l0 = l0 * exp2_approx(m0 - n0) + sum0;  // exp2(-inf) = 0 on the first tile
        l1 = l1 * exp2_approx(m1 - n1) + sum1;
        m0 = n0;
        m1 = n1;
      } else {  // W = exp(s - max) / sum in fp32
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          s[jj][0] = exp2_approx(fmaf(s[jj][0], kLog2e, -m0)) * inv0;
          s[jj][1] = exp2_approx(fmaf(s[jj][1], kLog2e, -m0)) * inv0;
          s[jj][2] = exp2_approx(fmaf(s[jj][2], kLog2e, -m1)) * inv1;
          s[jj][3] = exp2_approx(fmaf(s[jj][3], kLog2e, -m1)) * inv1;
        }
        if constexpr (STATS) {  // tmp += rowsum(dW * W), dW = dO V^T 16 keys at a time
          const bf16* v_lane = v_tile + ((lane / 16) * 8 + lane % 8) * kLd + ((lane / 8) % 2) * 8;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float dw[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              uint32_t vb[4];
              ldmatrix_x4(vb, v_lane + c * 16 * kLd + kk * 16);
              mma_16816(dw[0], da[kk], vb[0], vb[1]);
              mma_16816(dw[1], da[kk], vb[2], vb[3]);
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float(&w)[4] = s[2 * c + jj];
              tmp0 += dw[jj][0] * w[0] + dw[jj][1] * w[1];
              tmp1 += dw[jj][2] * w[2] + dw[jj][3] * w[3];
            }
          }
        } else {  // O += round_bf16(W) V, V taken transposed
          const bf16* v_lane = v_tile + (((lane / 8) % 2) * 8 + lane % 8) * kLd + (lane / 16) * 8;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t pa[4] = {
                pack_floats(s[2 * c][0], s[2 * c][1]), pack_floats(s[2 * c][2], s[2 * c][3]),
                pack_floats(s[2 * c + 1][0], s[2 * c + 1][1]),
                pack_floats(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
            for (int n = 0; n < HD / 8; n += 2) {
              uint32_t vb[4];
              ldmatrix_x4_trans(vb, v_lane + c * 16 * kLd + n * 8);
              mma_16816(o[n], pa, vb[0], vb[1]);
              mma_16816(o[n + 1], pa, vb[2], vb[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // buffer j & 1 is read: stage j + 2 may fill it
  }
  if (!has) return;
  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  if constexpr (STATS) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmp0 += __shfl_xor_sync(0xffffffffu, tmp0, off);
      tmp1 += __shfl_xor_sync(0xffffffffu, tmp1, off);
    }
    float4* row = stats + (static_cast<long>(b) * H + h) * N;
    if (t == 0 && row_a < N) row[row_a] = make_float4(m0, inv0, tmp0, 0.0f);
    if (t == 0 && row_b < N) row[row_b] = make_float4(m1, inv1, tmp1, 0.0f);
  } else {
    uint32_t lo[HD / 8], hi[HD / 8];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      lo[n] = pack_floats(o[n][0], o[n][1]);
      hi[n] = pack_floats(o[n][2], o[n][3]);
    }
    bf16* out_a = out + rows.o + row_a * rows.o_ld;
    store_tile_rows<HD>(out_a, out_a + 8 * rows.o_ld, lo, hi, row_a < N, row_b < N, t);
  }
}

// Q(u)'s bias in place and its scaled copy qs = round_bf16(q * scale_c),
// each thread on the chunks it copied (stage_rows_async's assignment); rows
// at or past N stay zero in both.
template <int HD>
__device__ __forceinline__ void finish_q_tile(bf16* q, bf16* qs, int row0, int N,
                                              const bf16* __restrict__ bias, float scale_c) {
  constexpr int kChunks = HD / 8;
  constexpr int kLd = HD + 8;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_c);
  for (int i = threadIdx.x; i < kRows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 chunk = *reinterpret_cast<const uint4*>(q + r * kLd + c);
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&chunk);
    if (bias != nullptr && row0 + r < N) {
      const uint4 add = *reinterpret_cast<const uint4*>(bias + c);
      const __nv_bfloat162* add_pairs = reinterpret_cast<const __nv_bfloat162*>(&add);
#pragma unroll
      for (int e = 0; e < 4; ++e) pairs[e] = __hadd2(pairs[e], add_pairs[e]);
      *reinterpret_cast<uint4*>(q + r * kLd + c) = chunk;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) pairs[e] = __hmul2(pairs[e], scale2);
    *reinterpret_cast<uint4*>(qs + r * kLd + c) = chunk;
  }
}

// A warp's A fragment of dS^T (rows g, g + 8 and columns 2t, 2t + 8 of a
// 16-row slice) into shared memory at p (row g, column 2t; row stride kLdS).
__device__ __forceinline__ void store_ds_fragment(bf16* p, const uint32_t (&a)[4]) {
  *reinterpret_cast<uint32_t*>(p) = a[0];
  *reinterpret_cast<uint32_t*>(p + 8 * kLdS) = a[1];
  *reinterpret_cast<uint32_t*>(p + 8) = a[2];
  *reinterpret_cast<uint32_t*>(p + 8 * kLdS + 8) = a[3];
}

// grid (H, B), kTileThreads threads: the gradient pass (see the note above).
// q, k, v, dout and dq, dk, dv as HeadRows<SEP> lays them out; stats (B, H,
// N) from the statistics pass; dq_acc (B, H, N, hd) fp32 scratch;
// dbias_part (B, 3D) or null.  The separate layout serves fused_attention
// alone, whose roundings are kBwdExact's: S^T from q as it is, times the
// fp32 scale; W and dS = W (dW - tmp) scale kept in fp32 and carried into
// the tensor cores as two bf16 terms, hi = round(x) and lo = round(x - hi)
// (dV = W_hi^T dO + W_lo^T dO, dK = dS_hi^T Q + dS_lo^T Q, dQ = dS_hi K +
// dS_lo K); no scale afterwards.
template <int HD, int MODE, bool SEP>
__global__ void __launch_bounds__(kTileThreads, 2)
qkv_attention_tiles_bwd_kernel(const bf16* __restrict__ q_base, const bf16* __restrict__ k_base,
                               const bf16* __restrict__ v_base, const bf16* __restrict__ bias,
                               const bf16* __restrict__ dout, const float4* __restrict__ stats,
                               bf16* __restrict__ dq_base, bf16* __restrict__ dk_base,
                               bf16* __restrict__ dv_base, float* __restrict__ dq_acc,
                               float* __restrict__ dbias_part, int N, int H, int n_valid,
                               float scale_c, float scale, int softmax_f32) {
  constexpr bool kExact = MODE == kBwdExact;
  static_assert(kExact == SEP, "the separate layout is fused_attention's, and so is kBwdExact");
  constexpr int kLd = HD + 8;
  constexpr int kTile = tile_elems<HD>();
  constexpr int kNT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);  // two buffers each, by key tile
  bf16* s_v = s_k + 2 * kTile;
  bf16* s_q = s_v + 2 * kTile;                // two buffers each, by stage: q + bias,
  bf16* s_qs = s_q + 2 * kTile;               // its scale fold (none in kBwdExact),
  bf16* s_do = s_qs + (kExact ? 0 : 2) * kTile;  // dO
  bf16* s_ds = s_do + 2 * kTile;              // dS^T: [key][query]
  bf16* s_ds_lo = s_ds + kRows * kLdS;        // kBwdExact: dS^T's second term
  float4* s_stat = reinterpret_cast<float4*>(s_ds_lo + (kExact ? kRows * kLdS : 0));  // [2][kRows]
  float* s_db = reinterpret_cast<float*>(s_stat + 2 * kRows);  // [warps][3 * HD], with a bias

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  const HeadRows<SEP> rows(b, h, N, H, HD);
  const long ld = rows.ld;
  const bf16* src_q = q_base + rows.at;
  const bf16* src_k = k_base + rows.at;
  const bf16* src_v = v_base + rows.at;
  const bf16* d_src = dout + rows.o;
  const float4* head_stats = stats + (static_cast<long>(b) * H + h) * N;
  float* head_dq = dq_acc + (static_cast<long>(b) * H + h) * N * HD;
  bf16* g_q = dq_base + rows.at;
  bf16* g_k = dk_base + rows.at;
  bf16* g_v = dv_base + rows.at;
  const bf16* bias_q = bias == nullptr ? nullptr : bias + h * HD;
  const bf16* bias_k = bias == nullptr ? nullptr : bias + D + h * HD;
  const bf16* bias_v = bias == nullptr ? nullptr : bias + 2 * D + h * HD;
  float* db = dbias_part == nullptr ? nullptr : s_db + warp * 3 * HD;
  const float ds_scale = MODE == kBwdFold ? 1.0f : scale;   // on dS, before its rounding
  const float out_scale = MODE == kBwdFold ? scale : 1.0f;  // on dQ and dK, before theirs
  const int q_tiles = (N + kRows - 1) / kRows;
  const int key_tiles = (n_valid + kRows - 1) / kRows;
  const int stages = key_tiles * q_tiles;

  auto issue = [&](int j) {
    const int kt = j / q_tiles, u = j % q_tiles;
    if (u == 0) {
      stage_rows_async<HD>(s_k + (kt & 1) * kTile, kRows, src_k, kt * kRows, N, ld);
      stage_rows_async<HD>(s_v + (kt & 1) * kTile, kRows, src_v, kt * kRows, N, ld);
    }
    stage_rows_async<HD>(s_q + (j & 1) * kTile, kRows, src_q, u * kRows, N, ld);
    stage_rows_async<HD>(s_do + (j & 1) * kTile, kRows, d_src, u * kRows, N, rows.o_ld);
    if (threadIdx.x < kRows) {
      const int row = u * kRows + threadIdx.x;
      const bool ok = row < N;
      cp_async_16(s_stat + (j & 1) * kRows + threadIdx.x, head_stats + (ok ? row : 0), ok ? 16 : 0);
    }
  };

  issue(0);
  cp_async_commit();
  if (db != nullptr)
    for (int i = threadIdx.x; i < kTileWarps * 3 * HD; i += blockDim.x) s_db[i] = 0.0f;
  // Lane addresses: rows taken transposed as a B operand (b_off: two 8-row
  // column tiles a 16 rows), rows whose reduction index runs down them
  // (t_off), and dS^T read as dS's A fragment (ds_off).
  const int b_off = ((lane / 16) * 8 + lane % 8) * kLd + ((lane / 8) % 2) * 8;
  const int t_off = (((lane / 8) % 2) * 8 + lane % 8) * kLd + (lane / 16) * 8;
  const int ds_off = ((lane / 16) * 8 + lane % 8) * kLdS + warp * 16 + ((lane / 8) % 2) * 8;
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
  }

  for (int j = 0; j < stages; ++j) {
    const int kt = j / q_tiles, u = j % q_tiles;
    const int k0 = kt * kRows, i0 = u * kRows;
    if (j + 1 < stages) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage j's copies are in
    bf16* k_tile = s_k + (kt & 1) * kTile;
    bf16* v_tile = s_v + (kt & 1) * kTile;
    bf16* q_tile = s_q + (j & 1) * kTile;
    bf16* qs_tile = kExact ? q_tile : s_qs + (j & 1) * kTile;  // S^T's operand
    const bf16* do_tile = s_do + (j & 1) * kTile;
    const float4* stat = s_stat + (j & 1) * kRows;
    if (u == 0) {
      finish_rows_in_place<HD>(k_tile, kRows, k0, N, bias_k, 1.0f, false, threadIdx.x, blockDim.x);
      finish_rows_in_place<HD>(v_tile, kRows, k0, N, bias_v, 1.0f, false, threadIdx.x, blockDim.x);
    }
    if (!kExact) finish_q_tile<HD>(q_tile, qs_tile, i0, N, bias_q, scale_c);
    __syncthreads();  // stage j's tiles are finished

    // Keys 16 warp ..: dV, dK over this query tile, and dS^T.
    const int kw = k0 + warp * 16;
    const int ds_row = (warp * 16 + g) * kLdS + 2 * t;  // row g; row g + 8 is 8 kLdS on
    if (kw < n_valid) {
      if (u == 0) {
        load_q_fragments<HD>(ka, k_tile, warp * 16, lane);
        load_q_fragments<HD>(va, v_tile, warp * 16, lane);
      }
      const bool masked_a = kw + g >= n_valid;
      const bool masked_b = kw + g + 8 >= n_valid;
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // queries i0 + 16c ..
        float st[2][4] = {}, dwt[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, qs_tile + b_off + c * 16 * kLd + kk * 16);
          mma_16816(st[0], ka[kk], qb[0], qb[1]);
          mma_16816(st[1], ka[kk], qb[2], qb[3]);
          ldmatrix_x4(ob, do_tile + b_off + c * 16 * kLd + kk * 16);
          mma_16816(dwt[0], va[kk], ob[0], ob[1]);
          mma_16816(dwt[1], va[kk], ob[2], ob[3]);
        }
        // Element e of tile jn: key kw + g (+ 8 for e >= 2), query
        // 16c + 8jn + 2t + (e & 1); wt, dst in the A operand's order.
        float wt[8], dst[8];
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const float4 sa = stat[c * 16 + jn * 8 + 2 * t];
          const float4 sb = stat[c * 16 + jn * 8 + 2 * t + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4& row = e & 1 ? sb : sa;  // (max * log2(e), 1/sum, tmp)
            float x = (e < 2 ? masked_a : masked_b) ? -INFINITY : st[jn][e];
            if (kExact) x *= scale;  // fused_attention: the fp32 scores times the scale
            else if (!softmax_f32) x = round_bf16(x);
            const float w = exp2_approx(fmaf(x, kLog2e, -row.x)) * row.y;
            wt[jn * 4 + e] = w;
            dst[jn * 4 + e] = w * (dwt[jn][e] - row.z) * ds_scale;
          }
        }
        // W and dS rounded to bf16 (hi); in kBwdExact also what that dropped
        // (lo), a second term of each product.
        uint32_t wa[4], dsa[4], wa_lo[4], dsa_lo[4];
        pack_a<kExact>(wa, wa_lo, wt);
        pack_a<kExact>(dsa, dsa_lo, dst);
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, do_tile + t_off + c * 16 * kLd + n * 8);
          mma_16816(dv[n], wa, ob[0], ob[1]);
          mma_16816(dv[n + 1], wa, ob[2], ob[3]);
          if (kExact) {
            mma_16816(dv[n], wa_lo, ob[0], ob[1]);
            mma_16816(dv[n + 1], wa_lo, ob[2], ob[3]);
          }
          ldmatrix_x4_trans(qb, q_tile + t_off + c * 16 * kLd + n * 8);
          mma_16816(dk[n], dsa, qb[0], qb[1]);
          mma_16816(dk[n + 1], dsa, qb[2], qb[3]);
          if (kExact) {
            mma_16816(dk[n], dsa_lo, qb[0], qb[1]);
            mma_16816(dk[n + 1], dsa_lo, qb[2], qb[3]);
          }
        }
        store_ds_fragment(s_ds + ds_row + c * 16, dsa);
        if (kExact) store_ds_fragment(s_ds_lo + ds_row + c * 16, dsa_lo);
      }
    } else {  // keys wholly past n_valid: dS = 0
      const uint32_t zeros[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        store_ds_fragment(s_ds + ds_row + c * 16, zeros);
        if (kExact) store_ds_fragment(s_ds_lo + ds_row + c * 16, zeros);
      }
    }
    __syncthreads();  // dS^T is in

    // Queries i0 + 16 warp ..: dQ's part dS K over this key tile.
    const int qw = i0 + warp * 16;
    if (qw < N) {
      float dq[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // keys k0 + 16c ..
        uint32_t dsa[4], dsa_lo[4];
        ldmatrix_x4_trans(dsa, s_ds + ds_off + c * 16 * kLdS);
        if (kExact) ldmatrix_x4_trans(dsa_lo, s_ds_lo + ds_off + c * 16 * kLdS);
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, k_tile + t_off + c * 16 * kLd + n * 8);
          mma_16816(dq[n], dsa, kb[0], kb[1]);
          mma_16816(dq[n + 1], dsa, kb[2], kb[3]);
          if (kExact) {
            mma_16816(dq[n], dsa_lo, kb[0], kb[1]);
            mma_16816(dq[n + 1], dsa_lo, kb[2], kb[3]);
          }
        }
      }
      const int row_a = qw + g;
      const int row_b = row_a + 8;
      float* acc_a = head_dq + static_cast<long>(row_a) * HD + 2 * t;
      float* acc_b = acc_a + 8 * HD;
      if (kt > 0) {  // the parts of the key tiles before, added in key-tile order
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (row_a < N) {
            const float2 p = *reinterpret_cast<const float2*>(acc_a + n * 8);
            dq[n][0] = p.x + dq[n][0];
            dq[n][1] = p.y + dq[n][1];
          }
          if (row_b < N) {
            const float2 p = *reinterpret_cast<const float2*>(acc_b + n * 8);
            dq[n][2] = p.x + dq[n][2];
            dq[n][3] = p.y + dq[n][3];
          }
        }
      }
      if (kt + 1 == key_tiles) {
        store_gradient_tile<HD>(dq, out_scale, g_q, ld, qw, N, db, g, t);
      } else {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (row_a < N) *reinterpret_cast<float2*>(acc_a + n * 8) = make_float2(dq[n][0], dq[n][1]);
          if (row_b < N) *reinterpret_cast<float2*>(acc_b + n * 8) = make_float2(dq[n][2], dq[n][3]);
        }
      }
    }
    if (u + 1 == q_tiles) {  // key tile kt is done: dK and dV
      store_gradient_tile<HD>(dk, out_scale, g_k, ld, k0 + warp * 16, N,
                              db == nullptr ? nullptr : db + HD, g, t);
      store_gradient_tile<HD>(dv, 1.0f, g_v, ld, k0 + warp * 16, N,
                              db == nullptr ? nullptr : db + 2 * HD, g, t);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
        dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
      }
    }
    __syncthreads();  // stage j's buffers and dS^T are read
  }
  // Key tiles wholly at or past n_valid: dK = dV = 0 (their column sums too).
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < (N - key_tiles * kRows) * 2 * kChunks; i += blockDim.x) {
    const int r = key_tiles * kRows + i / (2 * kChunks);
    const int c = i % (2 * kChunks);
    *reinterpret_cast<uint4*>((c < kChunks ? g_k : g_v) + r * ld + (c % kChunks) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (dbias_part == nullptr) return;
  __syncthreads();
  store_dbias_partial<HD, kTileWarps>(s_db, dbias_part, b, h, D);
}

template <int HD, bool STATS, bool SEP>
cudaError_t launch_tiles(Sections<const bf16> in, const bf16* bias, const bf16* dout, bf16* out,
                         float4* stats, int B, int N, int H, int n_valid, float scale,
                         int softmax_f32, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD, STATS>();
  static bool configured[kMaxDevices] = {};
  const cudaError_t err =
      allow_dynamic_smem(qkv_attention_tiles_kernel<HD, STATS, SEP>, smem, configured);
  if (err != cudaSuccess) return err;
  qkv_attention_tiles_kernel<HD, STATS, SEP>
      <<<dim3((N + kRows - 1) / kRows, H, B), kTileThreads, smem, stream>>>(
          in.q, in.k, in.v, bias, dout, out, stats, N, H, n_valid, scale, softmax_f32);
  return cudaGetLastError();
}

// The gradient pass's kernel, its shared memory allowed.
template <int HD, int MODE, bool SEP>
cudaError_t configure_tiles_bwd() {
  static bool configured[kMaxDevices] = {};
  return allow_dynamic_smem(qkv_attention_tiles_bwd_kernel<HD, MODE, SEP>,
                            bwd_smem_bytes<HD, MODE>(), configured);
}

// The statistics pass, the gradient pass and (with a bias and dbias) the
// column sum.  In kBwdExact (SEP) scale_c is unused and the statistics pass
// takes the fp32 scale.
template <int HD, int MODE, bool SEP>
cudaError_t launch_tiles_bwd(Sections<const bf16> in, const bf16* bias, const bf16* dout,
                             Sections<bf16> grads, float4* stats, float* dq_acc, float* dbias_part,
                             float* dbias, int B, int N, int H, int n_valid, float scale_c,
                             float scale, int softmax_f32, cudaStream_t stream) {
  cudaError_t err = launch_tiles<HD, true, SEP>(in, bias, dout, nullptr, stats, B, N, H, n_valid,
                                                SEP ? scale : scale_c, softmax_f32, stream);
  if (err != cudaSuccess) return err;
  err = configure_tiles_bwd<HD, MODE, SEP>();
  if (err != cudaSuccess) return err;
  float* part = bias == nullptr ? nullptr : dbias_part;
  qkv_attention_tiles_bwd_kernel<HD, MODE, SEP>
      <<<dim3(H, B), kTileThreads, bwd_smem_bytes<HD, MODE>(), stream>>>(
          in.q, in.k, in.v, bias, dout, stats, grads.q, grads.k, grads.v, dq_acc, part, N, H,
          n_valid, scale_c, scale, softmax_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || bias == nullptr || dbias == nullptr) return err;
  return launch_column_sum(dbias_part, B, 3 * H * HD, dbias, stream);
}

bool tiles_shape_ok(int B, int N, int H, int n_valid) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && N >= 1 && n_valid >= 1 && n_valid <= N;
}

}  // namespace

// qkv: (B, N, 3*H*hd) bf16, [q heads | k heads | v heads]; bias: (3*H*hd,)
// bf16 or null; out: (B, N, H*hd) bf16.  hd 16, 32 or 64; 1 <= n_valid <=
// N; scale_c: 1/sqrt(hd) as bf16 holds it.  Any N >= 1 (qkv_attention.cu's
// ssl4polyp_qkv_attention_fwd sends N > 256 here).  Returns the launch's
// CUDA error.
extern "C" int ssl4polyp_qkv_attention_tiles_fwd(const void* qkv, const void* bias, void* out,
                                                 int B, int N, int H, int head_dim, int n_valid,
                                                 float scale_c, int softmax_f32, void* stream) {
  if (!tiles_shape_ok(B, N, H, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = sections_of(static_cast<const bf16*>(qkv), H, head_dim);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SSL4POLYP_TILES_FWD(HD)                                                               \
  launch_tiles<HD, false, false>(in, bb, nullptr, o, nullptr, B, N, H, n_valid, scale_c,      \
                                 softmax_f32, s)
  switch (head_dim) {
    case 16: err = SSL4POLYP_TILES_FWD(16); break;
    case 32: err = SSL4POLYP_TILES_FWD(32); break;
    case 64: err = SSL4POLYP_TILES_FWD(64); break;
  }
#undef SSL4POLYP_TILES_FWD
  return static_cast<int>(err);
}

// qkv, bias as for the forward; dout: (B, N, H*hd) bf16; dqkv: (B, N,
// 3*H*hd) bf16.  stats: (B, H, N) float4 scratch (16 bytes a row); dq_acc:
// (B, H, N, hd) fp32 scratch.  With a bias, dbias_part is (B, 3*H*hd) fp32
// scratch and dbias (3*H*hd,) fp32 receives the bias gradient, or with a
// null dbias the partial rows are left unsummed.  scale_c: 1/sqrt(hd) as
// bf16 holds it (the forward's fold), scale the fp32 1/sqrt(hd); mode 0 puts
// the scale on dQ and dK, mode 1 inside dS's rounding (qkv_attention.cu's
// kBwdFold, kBwdFoldScaledDs).  Returns the first failing launch's CUDA
// error.
extern "C" int ssl4polyp_qkv_attention_tiles_bwd(const void* qkv, const void* bias,
                                                 const void* dout, void* dqkv, void* stats,
                                                 void* dq_acc, void* dbias_part, void* dbias,
                                                 int B, int N, int H, int head_dim, int n_valid,
                                                 float scale_c, float scale, int softmax_f32,
                                                 int mode, void* stream) {
  if (!tiles_shape_ok(B, N, H, n_valid) || stats == nullptr || dq_acc == nullptr ||
      (bias != nullptr && dbias_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto in = sections_of(static_cast<const bf16*>(qkv), H, head_dim);
  const auto grads = sections_of(static_cast<bf16*>(dqkv), H, head_dim);
  const bf16* bb = static_cast<const bf16*>(bias);
  const bf16* d = static_cast<const bf16*>(dout);
  float4* st = static_cast<float4*>(stats);
  float* acc = static_cast<float*>(dq_acc);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SSL4POLYP_TILES_BWD(HD, MODE)                                                         \
  launch_tiles_bwd<HD, MODE, false>(in, bb, d, grads, st, acc, part, db, B, N, H, n_valid,    \
                                    scale_c, scale, softmax_f32, s)
  if (mode == kBwdFold) {
    switch (head_dim) {
      case 16: err = SSL4POLYP_TILES_BWD(16, kBwdFold); break;
      case 32: err = SSL4POLYP_TILES_BWD(32, kBwdFold); break;
      case 64: err = SSL4POLYP_TILES_BWD(64, kBwdFold); break;
    }
  } else if (mode == kBwdFoldScaledDs) {
    switch (head_dim) {
      case 16: err = SSL4POLYP_TILES_BWD(16, kBwdFoldScaledDs); break;
      case 32: err = SSL4POLYP_TILES_BWD(32, kBwdFoldScaledDs); break;
      case 64: err = SSL4POLYP_TILES_BWD(64, kBwdFoldScaledDs); break;
    }
  }
#undef SSL4POLYP_TILES_BWD
  return static_cast<int>(err);
}

// The gradient pass's block: *warps and *smem_bytes (its dynamic shared
// memory) at head_dim; 2, the path's number in
// ssl4polyp_qkv_attention_bwd_plan, or -1 for a head dim it does not take.
extern "C" int ssl4polyp_qkv_attention_tiles_bwd_plan(int head_dim, int* warps, int* smem_bytes) {
  *warps = kTileWarps;
  switch (head_dim) {
    case 16: *smem_bytes = static_cast<int>(bwd_smem_bytes<16, kBwdFold>()); return 2;
    case 32: *smem_bytes = static_cast<int>(bwd_smem_bytes<32, kBwdFold>()); return 2;
    case 64: *smem_bytes = static_cast<int>(bwd_smem_bytes<64, kBwdFold>()); return 2;
    default: return -1;
  }
}

// Attention over separate q, k and v in bf16 (fused_attention) on the key
// tiles, with that kernel's roundings: q, k, v and out (B, H, N, hd) bf16;
// hd 16, 32 or 64; any N >= 1 (the wrapper sends N > 256 here), every key
// weighted, no bias; scale: the fp32 1/sqrt(hd), which multiplies the fp32
// scores.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_attention_tiles_fwd(const void* q, const void* k, const void* v,
                                             void* out, int B, int H, int N, int head_dim,
                                             float scale, void* stream) {
  if (!tiles_shape_ok(B, N, H, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Sections<const bf16> in = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v)};
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SSL4POLYP_TILES_FWD(HD) \
  launch_tiles<HD, false, true>(in, nullptr, nullptr, o, nullptr, B, N, H, N, scale, 1, s)
  switch (head_dim) {
    case 16: err = SSL4POLYP_TILES_FWD(16); break;
    case 32: err = SSL4POLYP_TILES_FWD(32); break;
    case 64: err = SSL4POLYP_TILES_FWD(64); break;
  }
#undef SSL4POLYP_TILES_FWD
  return static_cast<int>(err);
}

// Its backward (kBwdExact): q, k, v, dout and dq, dk, dv (B, H, N, hd) bf16;
// stats (B, H, N) float4 scratch (16 bytes a row); dq_acc (B, H, N, hd) fp32
// scratch; scale as for the forward.  Returns the first failing launch's
// CUDA error.
extern "C" int ssl4polyp_attention_tiles_bwd(const void* q, const void* k, const void* v,
                                             const void* dout, void* dq, void* dk, void* dv,
                                             void* stats, void* dq_acc, int B, int H, int N,
                                             int head_dim, float scale, void* stream) {
  if (!tiles_shape_ok(B, N, H, N) || stats == nullptr || dq_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sections<const bf16> in = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v)};
  const Sections<bf16> grads = {static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                                static_cast<bf16*>(dv)};
  const bf16* d = static_cast<const bf16*>(dout);
  float4* st = static_cast<float4*>(stats);
  float* acc = static_cast<float*>(dq_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SSL4POLYP_TILES_BWD(HD)                                                               \
  launch_tiles_bwd<HD, kBwdExact, true>(in, nullptr, d, grads, st, acc, nullptr, nullptr, B, N, \
                                        H, N, scale, scale, 1, s)
  switch (head_dim) {
    case 16: err = SSL4POLYP_TILES_BWD(16); break;
    case 32: err = SSL4POLYP_TILES_BWD(32); break;
    case 64: err = SSL4POLYP_TILES_BWD(64); break;
  }
#undef SSL4POLYP_TILES_BWD
  return static_cast<int>(err);
}

// Its gradient pass's block: *warps, *smem_bytes (its dynamic shared
// memory) and *blocks_per_sm (resident blocks an SM, from the occupancy
// API) at head_dim.  Returns 0, a CUDA error, or -1 for a head dim it does
// not take.
extern "C" int ssl4polyp_attention_tiles_bwd_plan(int head_dim, int* warps, int* smem_bytes,
                                                  int* blocks_per_sm) {
  *warps = kTileWarps;
  cudaError_t err = cudaErrorInvalidValue;
#define SSL4POLYP_TILES_PLAN(HD)                                                          \
  *smem_bytes = static_cast<int>(bwd_smem_bytes<HD, kBwdExact>());                        \
  err = configure_tiles_bwd<HD, kBwdExact, true>();                                       \
  if (err == cudaSuccess)                                                                 \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                  \
        blocks_per_sm, qkv_attention_tiles_bwd_kernel<HD, kBwdExact, true>, kTileThreads, \
        bwd_smem_bytes<HD, kBwdExact>());
  switch (head_dim) {
    case 16: SSL4POLYP_TILES_PLAN(16) break;
    case 32: SSL4POLYP_TILES_PLAN(32) break;
    case 64: SSL4POLYP_TILES_PLAN(64) break;
    default: return -1;
  }
#undef SSL4POLYP_TILES_PLAN
  return static_cast<int>(err);
}
