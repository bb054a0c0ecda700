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
// products (164 GFLOP, 0.165 ms) bound it above its 397 MB; its statistics
// pass alone moves 234 MB (q, k, v and dO in, the float4s out) against
// 65.5 GFLOP of its two products, 0.070 ms, bytes.  The second sweep (and
// the statistics pass's) recompute S, which costs tensor-core time (98
// GFLOP issued in the forward) and no HBM traffic: K and V tiles are read
// again from L2, since the query block is the fastest unit index and the
// blocks at work at once share their heads.
//
// The forward and the statistics pass (the second design, redesigned for
// the H100; qkv_attention_tiles_kernel<HD, KT, STATS, SEP>):
//   * A persistent grid of at most one block an SM walks the units (128-row
//     query block, head, image), the query block fastest, so that the
//     blocks at work at once share their heads' K and V in L2.  A 128-row
//     block halves the K and V traffic of the first design's 64-row tiles.
//   * A producer thread loads, by 3-D TMA, the unit's Q (and in the
//     statistics pass dO) as one 128-row box into one of two buffers, and
//     key tiles of KT keys (kFwdKeys 128 in the forward, kStatsKeys 64 in
//     the statistics pass) into a ring of as many slots as fit (6 at hd 64),
//     with "full" and "empty" mbarriers: T = ceil(n_valid / KT) stages bring
//     K (the sweep of the max and sum), then T bring K and V (the sweep of
//     the weights); key tiles wholly at or past n_valid are never loaded.
//     Holding a unit's K tiles in shared memory for both sweeps, so that L2
//     serves them once, was tried and dropped: it timed about level with the
//     ring, which did not pay for a second path and a longer build.
//     Without SEP the maps lie over the fused (B, N, 3D) qkv, the boxes at
//     columns h hd, D + h hd and 2D + h hd; with SEP over each (B H, N, hd)
//     operand.  Rows at or past N arrive as zeros, and no box reads the next
//     image's or head's rows.  Rows of hd 16, 32 and 64 are 32, 64 and 128
//     bytes: each tile takes the swizzle of its width, which wgmma reads
//     back through wgmma_descriptor_swizzled.
//   * The producer warpgroup's warps 2 and 3 finish what lands, in place,
//     before the consumers read it: q's bias and (without SEP) its bf16
//     scale fold once a unit, k's and v's bias on each key tile
//     (finish_swizzled_rows: a thread's chunks all hold the same 8 columns,
//     where the swizzle put them, so it keeps their bias in registers);
//     then fence.proxy.async and an arrival on the stage's "ready" barrier,
//     on which the consumers wait.  Without a bias (rows 9, 11) the key
//     tiles skip this and the consumers wait on "full".
//   * Two consumer warpgroups take 64 rows each of the unit's block and
//     share the ring.  S = Qs K^T by wgmma m64n(KT)k16, Qs and K from shared
//     memory (K-major).  The first sweep keeps each row's running max and
//     sum over a quad of the accumulator; the second recomputes S and forms
//     W = exp2(s log2(e) - m) / l in registers: the forward rounds W to bf16
//     into register-A fragments and adds W V by wgmma m64n(hd)k16 with V the
//     MN-major operand as TMA brought it; the statistics pass issues dW = dO
//     V^T (dO from shared memory, V K-major) with S and sums tmp = rowsum(dW
//     * W) in registers.  Each sweep runs one tile ahead: the next tile's
//     products are issued before this tile's arithmetic (two sets of
//     accumulators), and the forward's W V of a tile runs under the next
//     tile's softmax.  O is rounded once and stored behind a row guard:
//     nothing past row N - 1 is written; the statistics go to the (B, H, N)
//     float4 scratch, (max * log2(e), 1/sum, tmp, 0), which the gradient
//     pass reads.  A warpgroup whose rows all lie past N (the last block at
//     N 577 holds 65 rows, so its second warpgroup has one) waits for each
//     stage and releases it.  The two warpgroups' schedulers interleave one's
//     softmax with the other's products; no barrier orders them.  No
//     atomics: reruns give the same bits.
//   * Registers: the producer warpgroup gives its registers up by setmaxnreg
//     (56), the consumers take 224; ptxas reports 168 for the launch, with
//     12 bytes spilled in the forward at hd 64, 8 in the statistics pass
//     there and in the SEP forward at hd 16, none at hd 32.
//   * The forward takes 128-key tiles (64 timed slower); the statistics
//     pass, which holds two (S, dW) pairs a thread, 64.
// The first design (qkv_attention_tiles_first_kernel; reached only through
// ssl4polyp_qkv_attention_tiles_fwd_probe, for timing; mma.sync m16n8k16
// with ldmatrix feeds, as qkv_attention.cu): one block of 4 warps for each
// (64-row query tile, head, image); warp w owns query rows 16w .. 16w + 15
// of the tile.  Q is staged once (bias and scale fold in place); the key
// tiles stream through two buffers by cp.async, stage j + 1's copy under
// stage j's products, the bias added to each by all 128 threads.  Tiles
// that run past N are zero-filled by cp.async's source size; their keys are
// masked (they are past n_valid), and their zero V rows meet zero weights.
// In both designs a tile always holds a key below n_valid, so a row's
// running max is finite after the first tile and -inf never reaches exp2 as
// -inf - (-inf).
//   * Backward, two kernels and a column sum:
//     1. The statistics pass (qkv_attention_tiles_kernel<HD, true, SEP>,
//        above).
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
//   Shared memory: forward two 128-row Q buffers and 6 (K, V) slots (128 KB
//   at hd 64), the statistics pass also two dO buffers (160 KB); the first
//   design 5 tiles of 64 rows at a stride of hd + 8 (46 KB at hd 64), its
//   statistics pass 6; the gradient pass 10 tiles, dS^T and the
//   statistics (106 KB at hd 64, two blocks an SM).  In kBwdExact the
//   gradient pass has no Qs tiles (its scores take q as it is) and no dbias
//   partials, and holds dS^T's second term: 8 tiles, two dS^T and the
//   statistics (94 KB at hd 64, two blocks an SM); its dV, dK and dQ take
//   eight products a pair of tiles where the other modes take five.
#include "attention_core.cuh"
#include "hopper.cuh"
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

// The first design (reached only through ssl4polyp_qkv_attention_tiles_fwd_probe).
// grid (query tiles, H, B), kTileThreads threads; q, k, v, out and dout as
// HeadRows<SEP> lays them out.  STATS false: the forward, writing out.
// STATS true: the backward's statistics pass, reading dout and writing
// stats (B, H, N): (max * log2(e), 1/sum, tmp, 0).  `scale`: scale_c, which
// folds into q (roundings 1-3 above), or with SEP the fp32 1/sqrt(hd) on the
// fp32 scores (fused_attention's; no bias).
template <int HD, bool STATS, bool SEP>
__global__ void __launch_bounds__(kTileThreads, 4)
qkv_attention_tiles_first_kernel(const bf16* __restrict__ q_base,
                                 const bf16* __restrict__ k_base,
                                 const bf16* __restrict__ v_base, const bf16* __restrict__ bias,
                                 const bf16* __restrict__ dout, bf16* __restrict__ out,
                                 float4* __restrict__ stats, int N, int H, int n_valid,
                                 float scale, int softmax_f32) {
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

// `probe` bits of ssl4polyp_qkv_attention_tiles_fwd_probe, a measurement
// aid (no route passes them): the first design (right results), the
// statistics pass alone (reading dout, writing stats) in place of the
// forward, and the separate (B, H, N, hd) layout of fused_attention.
constexpr int kProbeFirstDesign = 1;
constexpr int kProbeStatistics = 2;
constexpr int kProbeSeparate = 4;

// ---------------------------------------------------------------------------
// The second design (the note at the head of this file): 128-row query
// blocks on wgmma, key tiles by TMA.
// ---------------------------------------------------------------------------

constexpr int kThreads = 384;        // a producer warpgroup, two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kFinishWarps = 2;      // the producer warpgroup's warps 2 and 3
constexpr int kFinishThreads = 32 * kFinishWarps;
constexpr int kBlockRows = 128;      // a query block: 64 rows a consumer warpgroup
constexpr int kFwdKeys = 128;        // keys of a key tile: the forward's,
constexpr int kStatsKeys = 64;       // the statistics pass's

// The shared memory of one block: two buffers of a query block's Q (and, in
// the statistics pass, dO), then a ring of (K, V) tile pairs of KT keys (the
// first sweep fills only K), as many as fit (at most 8), then the barriers.
// Rows of hd 16, 32 and 64 are 32, 64 and 128 bytes; every tile is a
// multiple of 1,024 bytes (the swizzle's period) and starts at one.
template <int HD, int KT, bool STATS>
struct BlockSmem {
  static constexpr int kRowBytes = 2 * HD;
  static constexpr uint32_t kQBytes = kBlockRows * kRowBytes;  // a query block's Q or dO
  static constexpr uint32_t kTileBytes = KT * kRowBytes;       // a key tile's K or V
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = 2 * kQBytes;
  static constexpr uint32_t kK = kDo + (STATS ? 2 * kQBytes : 0);
  static constexpr uint32_t kRoom = 232448 - 1024 - 256;  // less the alignment and barriers
  static constexpr int kFit = static_cast<int>((kRoom - kK) / (2 * kTileBytes));
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  // full, ready, empty for each stage; qfull, qready, qempty for each Q buffer.
  static constexpr size_t kSmemBytes = kBars + (3 * kStages + 6) * sizeof(uint64_t) + 1024;
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "tiles at the swizzle's period");
  static_assert(kSmemBytes <= 232448, "the block's shared memory");
};

// The bias add and the scale fold of finish_rows_in_place, in place on ROWS
// rows of a tile that TMA wrote under the swizzle of its row width, by the
// kFinishThreads finishing threads: thread `tid` takes 16-byte chunks tid,
// tid + 64, ..., which all hold the columns of one chunk of their rows,
// (tid ^ (tid >> 3)) % (HD / 8) (the swizzle XORs address bits 7-9 into bits
// 4-6 and repeats every 64 chunks; the tile starts at a multiple of 1,024
// bytes): `add` holds the bias of those 8 columns.  Rows at or past N stay
// zero.  The chunks are read 4 at a time before any is written.
template <int HD, int ROWS>
__device__ __forceinline__ void finish_swizzled_rows(unsigned char* tile, int row0, int N,
                                                     uint4 add, bool with_bias, bool fold_scale,
                                                     __nv_bfloat162 scale2, int tid) {
  constexpr int kChunks = HD / 8;
  constexpr int kIters = ROWS * kChunks / kFinishThreads;
  constexpr int kBatch = kIters < 4 ? kIters : 4;
  static_assert(kFinishThreads % 64 == 0 && kIters % kBatch == 0, "whole swizzle periods");
  const __nv_bfloat162* add_pairs = reinterpret_cast<const __nv_bfloat162*>(&add);
#pragma unroll
  for (int k0 = 0; k0 < kIters; k0 += kBatch) {
    uint4 chunk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      chunk[u] = *reinterpret_cast<const uint4*>(tile + 16 * (tid + kFinishThreads * (k0 + u)));
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = tid + kFinishThreads * (k0 + u);
      if (row0 + i / kChunks >= N) continue;
      __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&chunk[u]);
      if (with_bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pairs[j] = __hadd2(pairs[j], add_pairs[j]);
      }
      if (fold_scale) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pairs[j] = __hmul2(pairs[j], scale2);
      }
      *reinterpret_cast<uint4*>(tile + 16 * i) = chunk[u];
    }
  }
}

// D = A B^T over the HD columns of two K-major tiles of HD-wide rows: 64
// rows of A (Qs or dO) against the KT rows of a key tile (K or V).
template <int HD, int KT>
__device__ __forceinline__ void wgmma_tile_product(float (&d)[KT / 2], uint64_t desc_a,
                                                   uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {  // 16 along hd is 32 bytes: 2 descriptor units
    if constexpr (KT == 64) {
      wgmma_m64n64k16(d, desc_a + 2 * kk, desc_b + 2 * kk, kk);
    } else {
      static_assert(KT == 128, "a key width");
      wgmma_m64n128k16(d, desc_a + 2 * kk, desc_b + 2 * kk, kk);
    }
  }
}

// O += P V over a key tile: P's KT / 16 register-A fragments, V MN-major as
// TMA brought it (16 keys are 16 rows of V).
template <int HD, int KT>
__device__ __forceinline__ void wgmma_tile_values(float (&o)[HD / 2],
                                                  const uint32_t (&p)[KT / 16][4],
                                                  uint64_t desc_v) {
#pragma unroll
  for (int kt = 0; kt < KT / 16; ++kt) {
    const uint64_t desc = desc_v + kt * ((16 * 2 * HD) >> 4);
    if constexpr (HD == 16) {
      wgmma_m64n16k16_rs_mn(o, p[kt], desc, 1);
    } else if constexpr (HD == 32) {
      wgmma_m64n32k16_rs_mn(o, p[kt], desc, 1);
    } else {
      static_assert(HD == 64, "a head dim of the dispatch");
      wgmma_m64n64k16_rs_mn(o, p[kt], desc, 1);
    }
  }
}

// Scores of a warp's rows g and g + 8 as wgmma leaves them (s[4 j + e]: key
// k0 + 8 j + 2 t + (e & 1), row g for e < 2, else g + 8): keys at or past
// n_valid to -inf (only in a tile that reaches past it), with SEP times the
// fp32 scale, then rounded to bf16 when softmax_f32 is 0 (mask_scores).
// Each step runs only where it changes something, under a test that is the
// same for the whole warp: a score costs nothing here in the common case.
template <int KT, bool SEP>
__device__ __forceinline__ void mask_tile_scores(float (&s)[KT / 2], int k0, int n_valid,
                                                 int softmax_f32, float scale, int t) {
  if (k0 + KT > n_valid) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= n_valid) s[4 * j + e] = -INFINITY;
  }
  if constexpr (SEP) {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] *= scale;
  }
  if (!softmax_f32) {  // a pair at a time: one packed rounding, two unpacks
#pragma unroll
    for (int i = 0; i < KT / 2; i += 2) {
      const uint32_t packed = pack_floats(s[i], s[i + 1]);
      s[i] = __uint_as_float(packed << 16);
      s[i + 1] = __uint_as_float(packed & 0xffff0000u);
    }
  }
}

// The first sweep's step on one tile's scores: each row's running max (times
// log2(e)) and this thread's part of its sum of exp2(s log2(e) - max), the
// old sum rescaled (exp2(-inf) = 0 on the first tile).  Four chains a row
// for the max and for the sum: short dependent chains are what a warp's
// softmax waits on.
template <int KT>
__device__ __forceinline__ void running_max_sum(const float (&s)[KT / 2], float (&m)[2],
                                                float (&l)[2]) {
  float top[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float chain[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
      chain[j % 4] = fmaxf(chain[j % 4], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    top[r] = fmaxf(fmaxf(chain[0], chain[1]), fmaxf(chain[2], chain[3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], off));
    const float n = fmaxf(m[r], top[r] * kLog2e);
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = fmaf(s[4 * j + 2 * r + e], kLog2e, -n);
        sum[(2 * j + e) % 4] += exp2_approx(x);
      }
    l[r] = l[r] * exp2_approx(m[r] - n) + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    m[r] = n;
  }
}

// The second sweep's weights in place: W = exp2(s log2(e) - max) / sum in fp32.
template <int KT>
__device__ __forceinline__ void tile_weights(float (&s)[KT / 2], const float (&m)[2],
                                             const float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const int r = (i / 2) % 2;
    const float x = fmaf(s[i], kLog2e, -m[r]);
    s[i] = exp2_approx(x) * inv[r];
  }
}

// A persistent grid of at most one block an SM walks the units (128-row
// query block, head, image), the query block fastest, unit blockIdx.x + i *
// gridDim.x in its step i; kThreads threads; key tiles of KT keys.  STATS
// false: the forward, writing out; STATS true: the backward's statistics
// pass, reading dO and writing stats (B, H, N): (max * log2(e), 1/sum, tmp,
// 0).  The tensor maps: SEP false, q, k and v one map each over the fused
// (B, N, 3D) qkv (boxes at columns h hd, D + h hd, 2D + h hd; q's 128 rows,
// k's and v's KT) and dO's over (B, N, D); SEP true, each over its own (B
// H, N, hd).  `scale`: scale_c, folded into q, or with SEP the fp32
// 1/sqrt(hd) on the fp32 scores.
template <int HD, int KT, bool STATS, bool SEP>
__global__ void __launch_bounds__(kThreads, 1)
qkv_attention_tiles_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const bf16* __restrict__ bias, bf16* __restrict__ out,
                           float4* __restrict__ stats, int B, int N, int H, int n_valid,
                           float scale, int softmax_f32) {
  using S = BlockSmem<HD, KT, STATS>;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  uint64_t* qfull = empty + kStages;
  uint64_t* qready = qfull + 2;
  uint64_t* qempty = qready + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&ready[s], kFinishWarps);
      mbarrier_init(&empty[s], kConsumerWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbarrier_init(&qfull[b], 1);
      mbarrier_init(&qready[b], kFinishWarps);
      mbarrier_init(&qempty[b], kConsumerWarps);
    }
    mbarrier_init_fence();
  }
  __syncthreads();

  const int D = H * HD;
  const int q_blocks = (N + kBlockRows - 1) / kBlockRows;
  const int units = q_blocks * H * B;
  const int key_tiles = (n_valid + KT - 1) / KT;
  // What lands is finished in place by the producer warpgroup's warps 2 and
  // 3 before the consumers read it: q's bias and (without SEP) its scale
  // fold; k's and v's bias.  Without either the consumers read what TMA
  // wrote.
  const bool finish_q = bias != nullptr || !SEP;
  const bool finish_kv = bias != nullptr;
  const int lane = threadIdx.x % 32;

  // The roles part here and never meet again: no block-wide barrier below.
  // Every role walks the same units and stages: stage `it` of the ring (a
  // running count over the units) lives in slot it % kStages, whose
  // barriers are in their phase it / kStages for it; unit i's Q in buffer i
  // % 2, phase i / 2.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<56>();
    if (threadIdx.x == 0) {  // the producer: one TMA issue thread
      uint32_t it = 0;
      for (int unit = blockIdx.x, i = 0; unit < units; unit += gridDim.x, ++i) {
        const int q0 = (unit % q_blocks) * kBlockRows;
        const int h = (unit / q_blocks) % H;
        const int b = unit / q_blocks / H;
        const int mat = SEP ? b * H + h : b;
        const int qb = i & 1;
        if (i >= 2) mbarrier_wait(&qempty[qb], ((i >> 1) + 1) & 1);  // unit i - 2 is done
        mbarrier_arrive_expect_tx(&qfull[qb], (STATS ? 2 : 1) * S::kQBytes);  // zeros count
        tma_load_3d(smem + S::kQ + qb * S::kQBytes, &map_q, &qfull[qb], SEP ? 0 : h * HD, q0, mat);
        if (STATS)
          tma_load_3d(smem + S::kDo + qb * S::kQBytes, &map_do, &qfull[qb], SEP ? 0 : h * HD, q0,
                      mat);
        for (int j = 0; j < 2 * key_tiles; ++j, ++it) {
          const int slot = it % kStages;
          if (it >= kStages) mbarrier_wait(&empty[slot], ((it / kStages) + 1) & 1);
          const bool second = j >= key_tiles;
          const int k0 = (second ? j - key_tiles : j) * KT;
          mbarrier_arrive_expect_tx(&full[slot], (second ? 2 : 1) * S::kTileBytes);
          tma_load_3d(smem + S::kK + slot * S::kTileBytes, &map_k, &full[slot],
                      SEP ? 0 : D + h * HD, k0, mat);
          if (second)
            tma_load_3d(smem + S::kV + slot * S::kTileBytes, &map_v, &full[slot],
                        SEP ? 0 : 2 * D + h * HD, k0, mat);
        }
      }
    } else if (threadIdx.x >= 128 - kFinishThreads && (finish_q || finish_kv)) {
      // The finishing warps: thread tid's chunks all hold one 8-column chunk
      // of their rows, whose bias it keeps in registers for the unit.
      const int tid = threadIdx.x - (128 - kFinishThreads);
      const int col = ((tid ^ (tid >> 3)) & (HD / 8 - 1)) * 8;
      const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
      uint32_t it = 0;
      for (int unit = blockIdx.x, i = 0; unit < units; unit += gridDim.x, ++i) {
        const int q0 = (unit % q_blocks) * kBlockRows;
        const int h = (unit / q_blocks) % H;
        const int qb = i & 1;
        const bf16* head_bias = bias == nullptr ? nullptr : bias + h * HD + col;
        if (finish_q) {
          const uint4 add = head_bias == nullptr
                                ? make_uint4(0u, 0u, 0u, 0u)
                                : __ldg(reinterpret_cast<const uint4*>(head_bias));
          mbarrier_wait(&qfull[qb], (i >> 1) & 1);
          finish_swizzled_rows<HD, kBlockRows>(smem + S::kQ + qb * S::kQBytes, q0, N, add,
                                               head_bias != nullptr, !SEP, scale2, tid);
          fence_proxy_async_shared();  // before wgmma reads what these stores wrote
          __syncwarp();
          if (lane == 0) mbarrier_arrive(&qready[qb]);
        }
        if (!finish_kv) continue;
        const uint4 add_k = __ldg(reinterpret_cast<const uint4*>(head_bias + D));
        const uint4 add_v = __ldg(reinterpret_cast<const uint4*>(head_bias + 2 * D));
        for (int j = 0; j < 2 * key_tiles; ++j, ++it) {
          const int slot = it % kStages;
          const bool second = j >= key_tiles;
          const int k0 = (second ? j - key_tiles : j) * KT;
          mbarrier_wait(&full[slot], (it / kStages) & 1);
          finish_swizzled_rows<HD, KT>(smem + S::kK + slot * S::kTileBytes, k0, N, add_k, true,
                                       false, scale2, tid);
          if (second)
            finish_swizzled_rows<HD, KT>(smem + S::kV + slot * S::kTileBytes, k0, N, add_v, true,
                                         false, scale2, tid);
          fence_proxy_async_shared();
          __syncwarp();
          if (lane == 0) mbarrier_arrive(&ready[slot]);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup `group` takes rows 64 group .. 64 group + 63 of
  // each query block, warp w of it rows 16 w .., thread (g, t) rows g and g
  // + 8 of those.  A warpgroup whose rows all lie at or past N (the last
  // block at N 577 holds 65 rows) still waits for each stage and releases
  // it, and computes nothing.  Each sweep runs one tile ahead: the next
  // tile's scores (and dO V^T) are issued before this tile's arithmetic, and
  // the forward's W V of a tile runs under the next tile's softmax.
  setmaxnreg_inc<224>();
  const int group = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint64_t* q_gate = finish_q ? qready : qfull;
  uint64_t* kv_gate = finish_kv ? ready : full;
  uint32_t it = 0;
  for (int unit = blockIdx.x, i = 0; unit < units; unit += gridDim.x, ++i) {
    const int q0 = (unit % q_blocks) * kBlockRows;
    const int h = (unit / q_blocks) % H;
    const int b = unit / q_blocks / H;
    const int qb = i & 1;
    const int r0 = q0 + 64 * group;  // the warpgroup's first row
    const bool active = r0 < N;
    const uint32_t it0 = it;         // the unit's first stage
    mbarrier_wait(&q_gate[qb], (i >> 1) & 1);
    const uint64_t desc_q = wgmma_descriptor_swizzled<S::kRowBytes>(
        smem + S::kQ + qb * S::kQBytes + 64 * group * S::kRowBytes);
    const uint64_t desc_do = wgmma_descriptor_swizzled<S::kRowBytes>(
        smem + S::kDo + qb * S::kQBytes + 64 * group * S::kRowBytes);
    auto slot_of = [&](int j) { return static_cast<int>((it0 + j) % kStages); };
    auto gate = [&](int j) { mbarrier_wait(&kv_gate[slot_of(j)], ((it0 + j) / kStages) & 1); };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbarrier_arrive(&empty[slot_of(j)]);
    };
    auto desc_k = [&](int j) {
      return wgmma_descriptor_swizzled<S::kRowBytes>(smem + S::kK + slot_of(j) * S::kTileBytes);
    };
    auto desc_v = [&](int j) {
      return wgmma_descriptor_swizzled<S::kRowBytes>(smem + S::kV + slot_of(j) * S::kTileBytes);
    };
    const int T = key_tiles;
    float m[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: running max * log2(e)
    float l[2] = {0.0f, 0.0f};            // this thread's part of their sums
    if (!active) {  // wait for each stage, release it
      for (int j = 0; j < 2 * T; ++j) {
        gate(j);
        release(j);
      }
    } else {
      // Sweep 1, stages 0 .. T - 1: the running max and sum.
      float sa[KT / 2], sb[KT / 2];
      auto step1 = [&](float (&cur)[KT / 2], float (&next)[KT / 2], int j) {
        if (j + 1 < T) {
          gate(j + 1);
          wgmma_fence();
          wgmma_tile_product<HD, KT>(next, desc_q, desc_k(j + 1));
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        wgmma_pin(cur);
        release(j);
        mask_tile_scores<KT, SEP>(cur, j * KT, n_valid, softmax_f32, scale, t);
        running_max_sum<KT>(cur, m, l);
      };
      gate(0);
      wgmma_fence();
      wgmma_tile_product<HD, KT>(sa, desc_q, desc_k(0));
      wgmma_commit();
      for (int j = 0; j < T; j += 2) {
        step1(sa, sb, j);
        if (j + 1 < T) step1(sb, sa, j + 1);
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
        inv[r] = 1.0f / l[r];
      }
      const int row_a = r0 + 16 * warp + g;
      const int row_b = row_a + 8;
      if constexpr (STATS) {
        // Sweep 2, stages T .. 2T - 1: W in fp32 and dW = dO V^T, tmp =
        // rowsum(dW * W).
        float tmp[2] = {0.0f, 0.0f};
        float dwa[KT / 2], dwb[KT / 2];
        auto issue = [&](float (&s)[KT / 2], float (&dw)[KT / 2], int j) {
          gate(T + j);
          wgmma_fence();
          wgmma_tile_product<HD, KT>(s, desc_q, desc_k(T + j));
          wgmma_tile_product<HD, KT>(dw, desc_do, desc_v(T + j));
          wgmma_commit();
        };
        auto step2 = [&](float (&s)[KT / 2], float (&dw)[KT / 2], float (&s_next)[KT / 2],
                         float (&dw_next)[KT / 2], int j) {
          if (j + 1 < T) {
            issue(s_next, dw_next, j + 1);
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          wgmma_pin(s);
          wgmma_pin(dw);
          release(T + j);
          mask_tile_scores<KT, SEP>(s, j * KT, n_valid, softmax_f32, scale, t);
          tile_weights<KT>(s, m, inv);
#pragma unroll
          for (int x = 0; x < KT / 2; ++x) tmp[(x / 2) % 2] += dw[x] * s[x];
        };
        issue(sa, dwa, 0);
        for (int j = 0; j < T; j += 2) {
          step2(sa, dwa, sb, dwb, j);
          if (j + 1 < T) step2(sb, dwb, sa, dwa, j + 1);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) tmp[r] += __shfl_xor_sync(0xffffffffu, tmp[r], off);
        float4* row = stats + (static_cast<long>(b) * H + h) * N;
        if (t == 0 && row_a < N) row[row_a] = make_float4(m[0], inv[0], tmp[0], 0.0f);
        if (t == 0 && row_b < N) row[row_b] = make_float4(m[1], inv[1], tmp[1], 0.0f);
      } else {
        // Sweep 2: W rounded into register-A fragments, O += W V; the next
        // tile's scores are issued before this tile's W V and softmaxed
        // under it.
        float o[HD / 2];
#pragma unroll
        for (int n = 0; n < HD / 2; ++n) o[n] = 0.0f;
        gate(T);
        wgmma_fence();
        wgmma_tile_product<HD, KT>(sa, desc_q, desc_k(T));
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(sa);
        mask_tile_scores<KT, SEP>(sa, 0, n_valid, softmax_f32, scale, t);
        tile_weights<KT>(sa, m, inv);
        for (int j = 0; j < T; ++j) {
          uint32_t p[KT / 16][4];
#pragma unroll
          for (int kt = 0; kt < KT / 16; ++kt) {
            const float* a = sa + 8 * kt;
            p[kt][0] = pack_floats(a[0], a[1]);
            p[kt][1] = pack_floats(a[2], a[3]);
            p[kt][2] = pack_floats(a[4], a[5]);
            p[kt][3] = pack_floats(a[6], a[7]);
          }
          if (j + 1 < T) {
            gate(T + j + 1);
            wgmma_fence();
            wgmma_tile_product<HD, KT>(sa, desc_q, desc_k(T + j + 1));
            wgmma_commit();
          }
          wgmma_fence();
          wgmma_tile_values<HD, KT>(o, p, desc_v(T + j));
          wgmma_commit();
          if (j + 1 < T) {
            wgmma_wait<1>();  // the next tile's scores are in
            wgmma_pin(sa);
            mask_tile_scores<KT, SEP>(sa, (j + 1) * KT, n_valid, softmax_f32, scale, t);
            tile_weights<KT>(sa, m, inv);
          }
          wgmma_wait<0>();  // V is read and p free
          wgmma_pin(o);
          release(T + j);
        }
        const HeadRows<SEP> rows(b, h, N, H, HD);
        uint32_t lo[HD / 8], hi[HD / 8];
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          lo[n] = pack_floats(o[4 * n], o[4 * n + 1]);
          hi[n] = pack_floats(o[4 * n + 2], o[4 * n + 3]);
        }
        bf16* out_a = out + rows.o + row_a * rows.o_ld;
        store_tile_rows<HD>(out_a, out_a + 8 * rows.o_ld, lo, hi, row_a < N, row_b < N, t);
      }
    }
    __syncwarp();
    if (lane == 0) mbarrier_arrive(&qempty[qb]);  // Q (and dO) are read
    it = it0 + 2 * key_tiles;
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

// The first design's forward or statistics pass.
template <int HD, bool STATS, bool SEP>
cudaError_t launch_tiles_first(Sections<const bf16> in, const bf16* bias, const bf16* dout,
                               bf16* out, float4* stats, int B, int N, int H, int n_valid,
                               float scale, int softmax_f32, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD, STATS>();
  static bool configured[kMaxDevices] = {};
  const cudaError_t err =
      allow_dynamic_smem(qkv_attention_tiles_first_kernel<HD, STATS, SEP>, smem, configured);
  if (err != cudaSuccess) return err;
  qkv_attention_tiles_first_kernel<HD, STATS, SEP>
      <<<dim3((N + kRows - 1) / kRows, H, B), kTileThreads, smem, stream>>>(
          in.q, in.k, in.v, bias, dout, out, stats, N, H, n_valid, scale, softmax_f32);
  return cudaGetLastError();
}

// The forward (STATS false, kFwdKeys keys a tile) or the statistics pass
// (STATS true, kStatsKeys): the tensor maps (host arithmetic, made anew each
// call: a map holds its pointer), then the persistent grid.  Without SEP
// in.q is the fused qkv (sections_of).
template <int HD, bool STATS, bool SEP>
cudaError_t launch_tiles(Sections<const bf16> in, const bf16* bias, const bf16* dout, bf16* out,
                         float4* stats, int B, int N, int H, int n_valid, float scale,
                         int softmax_f32, cudaStream_t stream) {
  constexpr int KT = STATS ? kStatsKeys : kFwdKeys;
  using S = BlockSmem<HD, KT, STATS>;
  CUtensorMap maps[4];  // q, k, v, dO
  cudaError_t err = cudaSuccess;
  if constexpr (SEP) {
    const bf16* bases[4] = {in.q, in.k, in.v, STATS ? dout : in.q};
    const int box_rows[4] = {kBlockRows, KT, KT, kBlockRows};
    for (int m = 0; m < 4 && err == cudaSuccess; ++m)
      err = make_tensor_map_matrices(&maps[m], bases[m], B * H, N, HD, box_rows[m]);
  } else {
    const int D = H * HD;
    err = make_tensor_map_stack(&maps[0], in.q, B, N, 3 * D, kBlockRows, HD);
    if (err == cudaSuccess) err = make_tensor_map_stack(&maps[1], in.q, B, N, 3 * D, KT, HD);
    maps[2] = maps[1];
    maps[3] = maps[0];
    if (STATS && err == cudaSuccess)
      err = make_tensor_map_stack(&maps[3], dout, B, N, D, kBlockRows, HD);
  }
  if (err != cudaSuccess) return err;
  auto kernel = qkv_attention_tiles_kernel<HD, KT, STATS, SEP>;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(kernel, S::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long units = static_cast<long>((N + kBlockRows - 1) / kBlockRows) * H * B;
  const int blocks = units < sms ? static_cast<int>(units) : sms;  // persistent: one an SM
  kernel<<<blocks, kThreads, S::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], bias,
                                                      out, stats, B, N, H, n_valid, scale,
                                                      softmax_f32);
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

// The shapes the kernels take: grids of (H, B), and at most 2^31 - 1 units
// of (128-row query block, head, image).
bool tiles_shape_ok(int B, int N, int H, int n_valid) {
  const long units = static_cast<long>((N + kBlockRows - 1) / kBlockRows) * H * B;
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && N >= 1 && n_valid >= 1 &&
         n_valid <= N && units <= 2147483647L;
}

template <int HD, bool STATS, bool SEP>
cudaError_t launch_design(int probe, Sections<const bf16> in, const bf16* bias, const bf16* dout,
                          bf16* out, float4* stats, int B, int N, int H, int n_valid, float scale,
                          int softmax_f32, cudaStream_t stream) {
  return probe & kProbeFirstDesign
             ? launch_tiles_first<HD, STATS, SEP>(in, bias, dout, out, stats, B, N, H, n_valid,
                                                  scale, softmax_f32, stream)
             : launch_tiles<HD, STATS, SEP>(in, bias, dout, out, stats, B, N, H, n_valid, scale,
                                            softmax_f32, stream);
}

template <int HD>
cudaError_t launch_probe(int probe, Sections<const bf16> in, const bf16* bias, const bf16* dout,
                         bf16* out, float4* stats, int B, int N, int H, int n_valid, float scale,
                         int softmax_f32, cudaStream_t stream) {
#define SSL4POLYP_DESIGN(STATS, SEP)                                                          \
  launch_design<HD, STATS, SEP>(probe, in, bias, dout, out, stats, B, N, H, n_valid, scale, \
                                softmax_f32, stream)
  switch (probe & (kProbeStatistics | kProbeSeparate)) {
    case 0: return SSL4POLYP_DESIGN(false, false);
    case kProbeStatistics: return SSL4POLYP_DESIGN(true, false);
    case kProbeSeparate: return SSL4POLYP_DESIGN(false, true);
    default: return SSL4POLYP_DESIGN(true, true);
  }
#undef SSL4POLYP_DESIGN
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

// The forward and the statistics pass as measurement aids: `probe` the
// kProbe* bits above (0 runs ssl4polyp_qkv_attention_tiles_fwd's kernel).
// Without kProbeSeparate q is the fused (B, N, 3*H*hd) qkv (k and v unused)
// and the arguments are ssl4polyp_qkv_attention_tiles_fwd's; with it q, k, v
// are (B, H, N, hd), bias null, n_valid N and scale the fp32 1/sqrt(hd), as
// for ssl4polyp_attention_tiles_fwd.  With kProbeStatistics dout (the
// output's layout) is read and stats (B, H, N) float4 written in place of
// out.  Returns the CUDA error of the tensor maps or the launch.
extern "C" int ssl4polyp_qkv_attention_tiles_fwd_probe(const void* q, const void* k, const void* v,
                                                       const void* bias, const void* dout,
                                                       void* out, void* stats, int B, int N,
                                                       int H, int head_dim, int n_valid,
                                                       float scale, int softmax_f32, int probe,
                                                       void* stream) {
  const bool separate = probe & kProbeSeparate;
  const bool statistics = probe & kProbeStatistics;
  if ((probe & ~(kProbeFirstDesign | kProbeStatistics | kProbeSeparate)) != 0 ||
      !tiles_shape_ok(B, N, H, n_valid) ||
      (separate && (bias != nullptr || n_valid != N || softmax_f32 != 1)) ||
      (statistics ? dout == nullptr || stats == nullptr : out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Sections<const bf16> in =
      separate ? Sections<const bf16>{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                      static_cast<const bf16*>(v)}
               : sections_of(static_cast<const bf16*>(q), H, head_dim);
  const bf16* bb = static_cast<const bf16*>(bias);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* o = static_cast<bf16*>(out);
  float4* st = static_cast<float4*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SSL4POLYP_TILES_PROBE(HD) \
  launch_probe<HD>(probe, in, bb, d, o, st, B, N, H, n_valid, scale, softmax_f32, s)
  switch (head_dim) {
    case 16: err = SSL4POLYP_TILES_PROBE(16); break;
    case 32: err = SSL4POLYP_TILES_PROBE(32); break;
    case 64: err = SSL4POLYP_TILES_PROBE(64); break;
  }
#undef SSL4POLYP_TILES_PROBE
  return static_cast<int>(err);
}
