// Attention straight from the fused QKV projection, forward and backward.
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel and _bwd_kernel
// (fused_qkv_attention), and ::_fwd_bias_kernel and _bwd_bias_kernel
// (fused_qkv_bias_attention); the optional bias argument covers the second.
// The backward's design is described under "Backward" below.
//
// What bounds the forward on the H100: at the eval path's shape (B 64, N 197,
// 12 heads of 64) a call is 7.6 GFLOP against 78 MB of compulsory traffic
// (QKV in, output out), about 100 FLOP per byte, below the ~295 of the H100's
// data sheet ridge: the floor is HBM traffic.  At ViT lengths (N <= 256) one
// (batch, head) pair's keys and values fit in shared memory, so the (N, N)
// scores never leave the SM, and what is left to lose is latency: time in
// which an SM waits for a copy, or executes loads instead of products.
//
// The design (the first form gave every 64-row query tile a block that staged
// the head's whole K and V through registers, four times a head at N 197,
// computed nothing until all three tiles had landed, and gathered V two
// bytes at a time):
//   * One block of 4 warps per (head, batch row) stages the head's K and V
//     once; its warps take the 16-row query tiles in turn (13 at N 197: 4, 3,
//     3, 3).  69 KB of shared memory at hd 64, N 197 (K and V padded to 208
//     rows, one 16-row Q tile a warp) and, under __launch_bounds__(128, 3),
//     168 registers a thread (80 bytes of spills at hd 64; left alone ptxas
//     takes 254 and two blocks an SM, which is slower): three blocks an SM.
//   * Raw rows arrive by cp.async in separate groups: K, the warp's first Q
//     tile, then V.  The bias add and the bf16 scale fold (round_bf16(x +
//     bias), then times 1/sqrt(hd) and rounded: the TPU kernel's roundings)
//     run in place in shared memory, each thread on the chunks it copied
//     itself after its own wait_group.  V's copy and its bias pass overlap
//     the first tile's S = Q K^T and softmax; a warp's next Q tile is copied
//     while it works on the current one (its fragments are in registers by
//     then, so one 16-row buffer a warp is enough).  The bias pass runs on
//     packed bf16 instructions, two for 16 bytes, with the fp32 route's bits.
//   * Operands come from shared memory with ldmatrix: x4 for the Q and K
//     fragments, x4.trans for V; each feeds two products, on a row stride of
//     hd + 8 elements that keeps them free of bank conflicts.
//   * Each warp forms the whole score row in registers with mma.sync m16n8k16
//     (bf16 in, fp32 accumulate), masks keys >= valid_len to -inf, optionally
//     rounds the scores to bf16, takes an exact softmax over the full row (no
//     online rescaling is needed because the row is whole), rounds the
//     normalised weights to bf16 and multiplies by V; the score fragments are
//     the A operand of the second product without leaving registers.
//   * The output leaves in 16-byte pieces (a quad transpose of the
//     accumulator fragments, store_tile_rows) where hd is a multiple of 32.
//   Every shape up to 256 tokens (hd 16, 32, 64) takes this one routine;
//   the C entry points send N > 256 to qkv_attention_tiles.cu's key tiles.
//   What is left: the softmax (expf, max, sum, normalise and round: some 13
//   instructions a score, 104 scores a thread a tile) now outweighs the
//   products' instructions four to one, with 12 warps an SM to hide its
//   chains; the last of the 13 tiles at N 197 holds 5 rows and costs a whole
//   one; wgmma for S and P.V (m64n208k16, m64n64k16) would take most of the
//   products' instructions away and TMA the copies'.  PERF.md has the times
//   beside PyTorch's flash kernel's.
#include "attention_core.cuh"
#include "qkv_attention_tiles.cuh"

namespace {

constexpr int kWarps = 4;

// NKT: key tiles of 16; the kernel takes N <= 16 * NKT.  Up to 208 keys the
// score row fits a register budget of three blocks an SM (168 a thread).
template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kWarps, NKT <= 13 ? 3 : 2)
qkv_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                     bf16* __restrict__ out, int N, int H, int n_valid, float scale,
                     int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + kPad * kLd;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* s_q = s_v + kPad * kLd + warp * 16 * kLd;  // this warp's 16-row Q tile

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  const long ld = 3L * D;
  const bf16* base = qkv + static_cast<long>(b) * N * ld + h * HD;
  const bf16* bias_q = bias == nullptr ? nullptr : bias + h * HD;
  const bf16* bias_k = bias == nullptr ? nullptr : bias + D + h * HD;
  const bf16* bias_v = bias == nullptr ? nullptr : bias + 2 * D + h * HD;
  const int n_tiles = (N + 15) / 16;  // 16-row query tiles holding rows < N
  int tile = warp;

  // cp.async groups of every thread, oldest first: K, Q (empty for a warp
  // without a tile), V, then one per pass of the loop (the next Q tile).
  stage_rows_async<HD>(s_k, kPad, base + D, 0, N, ld);
  cp_async_commit();
  if (tile < n_tiles) stage_rows_async<HD>(s_q, 16, base, tile * 16, N, ld, lane, 32);
  cp_async_commit();
  stage_rows_async<HD>(s_v, kPad, base + 2 * D, 0, N, ld);
  cp_async_commit();
  cp_async_wait<1>();  // K and Q are in
  finish_rows_in_place<HD>(s_k, kPad, 0, N, bias_k, 1.0f, false, threadIdx.x, blockDim.x);
  if (tile < n_tiles) finish_rows_in_place<HD>(s_q, 16, tile * 16, N, bias_q, scale, true, lane, 32);
  __syncthreads();

  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  bool first = true;
  do {  // a warp without a tile still passes once: the block's barrier is inside
    const bool has = tile < n_tiles;
    const int next = tile + kWarps;
    uint32_t qa[HD / 16][4];
    float s[2 * NKT][4];
    float inv0 = 0.0f, inv1 = 0.0f;
    if (has) load_q_fragments<HD>(qa, s_q, 0, lane);
    __syncwarp();  // the Q tile is in registers: its buffer takes the next one
    if (has && next < n_tiles) stage_rows_async<HD>(s_q, 16, base, next * 16, N, ld, lane, 32);
    cp_async_commit();
    if (has) attention_scores<HD, NKT, false>(qa, s_k, lane, n_valid, softmax_f32, 1.0f, s, inv0, inv1);
    if (first) {
      cp_async_wait<1>();  // V is in (the next Q tile may still be on its way)
      finish_rows_in_place<HD>(s_v, kPad, 0, N, bias_v, 1.0f, false, threadIdx.x, blockDim.x);
      __syncthreads();
      first = false;
    }
    if (has) {
      float o[HD / 8][4];
      attention_values<HD, NKT>(s, inv0, inv1, s_v, lane, o);
      const int row_a = tile * 16 + g;
      const int row_b = row_a + 8;
      bf16* out_a = out + (static_cast<long>(b) * N + row_a) * D + h * HD;
      uint32_t lo[HD / 8], hi[HD / 8];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        lo[n] = pack_floats(o[n][0], o[n][1]);
        hi[n] = pack_floats(o[n][2], o[n][3]);
      }
      store_tile_rows<HD>(out_a, out_a + 8L * D, lo, hi, row_a < N, row_b < N, t);
    }
    cp_async_wait<0>();  // the next Q tile
    if (has && next < n_tiles)
      finish_rows_in_place<HD>(s_q, 16, next * 16, N, bias_q, scale, true, lane, 32);
    __syncwarp();
    tile = next;
  } while (tile < n_tiles);
}

template <int HD, int NKT>
cudaError_t launch(const bf16* qkv, const bf16* bias, bf16* out, int B, int N, int H,
                   int n_valid, float scale, int softmax_f32, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * NKT * 16 + kWarps * 16) * (HD + 8) * sizeof(bf16);
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(qkv_attention_kernel<HD, NKT>, smem, configured);
  if (err != cudaSuccess) return err;
  qkv_attention_kernel<HD, NKT><<<dim3(H, B), 32 * kWarps, smem, stream>>>(
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
// bf16-rounded dQKV.  ssl4polyp_qkv_attention_bwd_mode also takes
// attention_block.py's placement of the scale (dS = round_bf16(W * (dW -
// tmp) * scale), dQ and dK unscaled), for attention_block.cu's backward,
// which runs this kernel on its recomputed projection with the projection's
// bias as the bias.
//
// What bounds it on the H100: five products of N x N x hd per (batch, head)
// against reading QKV and dO and writing dQKV once: 0.71 N FLOP per byte,
// 140 at N 197, under the ridge of ~295, so HBM sets the bound (0.0405 ms at
// the classifier's shape).  At one head a block the scores never leave the
// SM; the time goes to latency, instructions and idle warps.
//
// Two paths (ssl4polyp_qkv_attention_bwd_plan names the one a shape takes):
//   * N <= 208: the stored-dS kernel below, one block of NKT warps (4, 8 or
//     13: one warp per 16-row tile) per (head, batch row).  Shared memory,
//     rows at a stride of hd + 8: Q, K, V, dO; at hd 32 a scaled copy of q;
//     dS (NKT*16 rows at a stride of NKT*16 + 8); each query row's max and
//     1/sum; each warp's dbias partial; V's bias.  At N 197: 221,440 bytes
//     at hd 64, 179,776 at hd 32 (one block an SM, 13 warps); at N 50, hd
//     64, 49,792 (four blocks of 4 warps an SM).
//   * N 209-256: the first design (qkv_attention_bwd_recompute_kernel, 8
//     warps, attention_core.cuh's attention_backward_recompute_ds), whose
//     four tiles and no dS fit where a stored dS does not (147 KB of tiles
//     and 135 KB of dS at N 256, hd 64).
//   * N > 256: qkv_attention_tiles.cu's key tiles (a statistics pass, then
//     one block a head over key tiles and query tiles), whose shared memory
//     does not grow with N.
//
// The stored-dS kernel:
//   * Staging: cp.async in two groups, K and Q, then V and dO; the bias is
//     added in place (finish_rows_one_column, packed bf16, the fp32 route's
//     bits; each thread's bias chunks are read once, before it waits for the
//     copies: each pass had begun with a read of the bias from L2).  1/sqrt(hd) in bf16 is a
//     power of two at hd 16 and 64, so the scores of the unscaled q times
//     scale_c in fp32 are the bits of the scale fold (a power of two commutes
//     with every rounding of the product); at hd 32 a copy of round_bf16(q *
//     scale_c) is made once, in the same pass.
//   * Phase A, warp w on query rows 16w..16w+15: the scores and the softmax
//     (attention_softmax, the forward's code, with exp(x) as one FMA and
//     ex2.approx) while V and dO are in flight; each row's max and 1/sum to
//     shared memory; W, half in registers and half waiting as fp32 in the
//     warp's own dS rows; tmp from dW = dO V^T; dW formed again for dS =
//     round_bf16(W (dW - tmp)), stored to shared memory; dQ = dS K from it.
//   * Phase B, warp w on key rows 16w..16w+15: for each query tile in order,
//     S^T = K Qs^T rebuilds round_bf16(W)^T from the stored statistics, then
//     dV += W^T dO and dK += dS^T Q, dS^T read from the stored dS.  Seven
//     products a head where the first design formed eight (it formed dW^T
//     again in phase B to rebuild dS), and no tmp in phase B.
//   * Every operand comes through ldmatrix, .trans where the reduction index
//     runs down the rows (K in dQ, dO in dV, dS and Q in dK); no operand is
//     gathered two bytes at a time.
//   * Outputs leave in 16-byte stores (a quad transpose) where hd is a
//     multiple of 32.  Each warp adds its tiles' column sums of the rounded
//     dQKV (a reduce-scatter across the row groups: 14 shuffles a tile at
//     hd 64 where a reduction of each column took 48), the block adds its
//     warps in warp order into one row of a (B, 3D)
//     fp32 partial, and column_sum_kernel adds the B rows in order: with dK
//     and dV summed over query tiles in a fixed order, the same bits on
//     every run.
//   Registers.  An SM's four schedulers each hold a quarter of its registers
//   and warps w, w + 4, ...: with 13 warps one scheduler holds four, so a
//   thread gets 128.  A whole row of W (104 floats at N 197) beside the
//   products does not fit (ptxas spills some 300 bytes a thread at hd 64
//   that way, and spills reach L2 here: 221 KB of shared memory leave L1
//   little room), so half of it waits in shared memory.  ptxas (-v,
//   sm_90a), registers and spill stores a thread: hd 64: NKT 13 128 and 148
//   bytes, NKT 8 128 and none, NKT 4 127 and none; hd 32: 128 and 148
//   bytes, 127 and none, 92 and none; hd 16: 128 and 156 bytes, 119 and
//   none, 89 and none.  The
//   spills left at NKT 13 are the better trade: 12 warps would give 168
//   registers but leave one warp two tiles of 13 in both phases, and 16
//   warps give 128 all the same.
//   What is left (PERF.md has the times and the ablations): the scheduler
//   with four warps carries a third more than the others, and mma.sync's
//   rate bounds it there; one block an SM stages a head with no other block
//   to overlap; wgmma for the products is untried.
// ---------------------------------------------------------------------------

// `probe` bits, a measurement aid (0 on every path; chip_smoke.py times the
// others, whose results are wrong): phase B left out; phase A stopped after
// the softmax; phase B's weights without the exponential; the first design
// at any length.
constexpr int kProbeNoPhaseB = 1;
constexpr int kProbeNoPhaseABackward = 2;
constexpr int kProbeNoExpB = 4;
constexpr int kProbeFirstDesign = 8;

template <int HD, int NKT>
struct StoredDsPlan {
  static constexpr int kWarps = NKT;
  static constexpr int kLd = HD + 8;
  static constexpr int kPad = NKT * 16;
  static constexpr int kLdS = kPad + 8;
  static constexpr bool kCopyQ = HD == 32;  // 1/sqrt(32) in bf16 is no power of two
  static constexpr size_t kTileBytes = static_cast<size_t>(kPad) * kLd * sizeof(bf16);
  static constexpr size_t kBytes = (kCopyQ ? 5 : 4) * kTileBytes +
                                   static_cast<size_t>(kPad) * kLdS * sizeof(bf16) +
                                   kPad * sizeof(float2) +
                                   static_cast<size_t>(kWarps) * 3 * HD * sizeof(float) +
                                   HD * sizeof(bf16);  // V's bias
  static constexpr int kBlocksPerSm = NKT <= 4 ? 4 : NKT <= 8 ? 2 : 1;
};

// finish_rows_in_place for the backward's block, whose thread count is a
// multiple of HD / 8, so that each thread copied one column chunk of every
// row it staged: with `with_bias`, that chunk's bias `add` (read before the
// copies are waited on) is added to each of its rows below N.  With
// `scaled`, round_bf16(row * scale) of every row (zero past N) goes there
// too: the scale fold's copy of q.
template <int HD>
__device__ __forceinline__ void finish_rows_one_column(bf16* dst, int rows, int N, bool with_bias,
                                                       uint4 add, bf16* scaled, float scale) {
  constexpr int kChunks = HD / 8;
  constexpr int kLd = HD + 8;
  if (!with_bias && scaled == nullptr) return;
  const int c = (threadIdx.x % kChunks) * 8;
  const __nv_bfloat162* add_pairs = reinterpret_cast<const __nv_bfloat162*>(&add);
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
  for (int r = threadIdx.x / kChunks; r < rows; r += blockDim.x / kChunks) {
    uint4 chunk = *reinterpret_cast<const uint4*>(dst + r * kLd + c);
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&chunk);
    if (with_bias && r < N) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pairs[j] = __hadd2(pairs[j], add_pairs[j]);
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = chunk;
    }
    if (scaled != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pairs[j] = __hmul2(pairs[j], scale2);
      *reinterpret_cast<uint4*>(scaled + r * kLd + c) = chunk;
    }
  }
}

// Phase A's products beside a row of scores or weights in registers: an A
// fragment (16 rows, 16 columns) is loaded for each 16 columns of the
// reduction and dropped after use.  a_lane: the lane's ldmatrix.x4 address
// in the warp's 16 rows; b_lane: in the first of the 16 rows of B taken
// transposed (two 8-row column tiles, one ldmatrix.x4 each 16 columns).

// d[j] = A B_j^T for every 8-row column tile j of B (2 * NKT of them): the
// step along the reduction outside, so that neighbouring products add into
// different accumulators (each d[j] still sums its steps in order).
template <int HD, int NKT>
__device__ __forceinline__ void row_products(float (&d)[2 * NKT][4], const bf16* a_lane,
                                             const bf16* b_lane) {
  constexpr int kLd = HD + 8;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_lane + kk * 16);
#pragma unroll
    for (int j = 0; j < 2 * NKT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_lane + j * 8 * kLd + kk * 16);
      mma_16816(d[j], a, b[0], b[1]);
      mma_16816(d[j + 1], a, b[2], b[3]);
    }
  }
}

// d[0], d[1] = A B^T for the two 8-row column tiles of B at b_lane.
template <int HD>
__device__ __forceinline__ void row_pair_product(float (&d)[2][4], const bf16* a_lane,
                                                 const bf16* b_lane) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) d[jj][0] = d[jj][1] = d[jj][2] = d[jj][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, a_lane + kk * 16);
    ldmatrix_x4(b, b_lane + kk * 16);
    mma_16816(d[0], a, b[0], b[1]);
    mma_16816(d[1], a, b[2], b[3]);
  }
}

template <int HD, int NKT, int MODE>
__global__ void __launch_bounds__(32 * NKT, StoredDsPlan<HD, NKT>::kBlocksPerSm)
qkv_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                         const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                         float* __restrict__ dbias_part, int N, int H, int n_valid,
                         float scale_c, float scale, int softmax_f32, int probe) {
  using Plan = StoredDsPlan<HD, NKT>;
  constexpr int kLd = Plan::kLd;
  constexpr int kPad = Plan::kPad;
  constexpr int kLdS = Plan::kLdS;
  constexpr int kKT = HD / 16;
  constexpr int kNT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // q + bias, unscaled
  bf16* s_k = s_q + kPad * kLd;
  bf16* s_v = s_k + kPad * kLd;
  bf16* s_do = s_v + kPad * kLd;
  bf16* s_qs = Plan::kCopyQ ? s_do + kPad * kLd : s_q;  // the scores' q operand
  bf16* s_ds = (Plan::kCopyQ ? s_qs : s_do) + kPad * kLd;
  // (max * log2(e), 1/sum) of each query row
  float2* s_stat = reinterpret_cast<float2*>(s_ds + kPad * kLdS);
  float* s_db = reinterpret_cast<float*>(s_stat + kPad);           // [NKT][3 * HD]
  uint4* s_add_v = reinterpret_cast<uint4*>(s_db + NKT * 3 * HD);  // V's bias, HD / 8 chunks

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  const long ld = 3L * D;
  const bf16* base = qkv + static_cast<long>(b) * N * ld + h * HD;
  bf16* out = dqkv + static_cast<long>(b) * N * ld + h * HD;
  float* db = dbias_part == nullptr ? nullptr : s_db + warp * 3 * HD;
  const float score_scale = Plan::kCopyQ ? 1.0f : scale_c;
  const float ds_scale = MODE == kBwdFold ? 1.0f : scale;   // on dS, before its rounding
  const float out_scale = MODE == kBwdFold ? scale : 1.0f;  // on dQ and dK, before theirs
  const int n_tiles = (N + 15) / 16;

  // The bias chunks this thread adds (one column chunk of every row it
  // stages) are read before the copies are waited on: K's and Q's into
  // registers, V's through shared memory, set before the first barrier.
  const bool with_bias = bias != nullptr;
  const int chunk = threadIdx.x % (HD / 8);
  uint4 add_k = make_uint4(0, 0, 0, 0), add_q = add_k, add_v = add_k;
  if (with_bias) {
    add_k = *reinterpret_cast<const uint4*>(bias + D + h * HD + chunk * 8);
    add_q = *reinterpret_cast<const uint4*>(bias + h * HD + chunk * 8);
    if (threadIdx.x < HD / 8) add_v = *reinterpret_cast<const uint4*>(bias + 2 * D + h * HD + chunk * 8);
  }
  stage_rows_async<HD>(s_k, kPad, base + D, 0, N, ld);
  stage_rows_async<HD>(s_q, kPad, base, 0, N, ld);
  cp_async_commit();
  stage_rows_async<HD>(s_v, kPad, base + 2 * D, 0, N, ld);
  stage_rows_async<HD>(s_do, kPad, dout + static_cast<long>(b) * N * D + h * HD, 0, N, D);
  cp_async_commit();
  if (db != nullptr)
    for (int i = threadIdx.x; i < NKT * 3 * HD; i += blockDim.x) s_db[i] = 0.0f;
  if (with_bias && threadIdx.x < HD / 8) s_add_v[threadIdx.x] = add_v;
  cp_async_wait<1>();  // K and Q are in
  finish_rows_one_column<HD>(s_k, kPad, N, with_bias, add_k, nullptr, 1.0f);
  finish_rows_one_column<HD>(s_q, kPad, N, with_bias, add_q, Plan::kCopyQ ? s_qs : nullptr, scale_c);
  __syncthreads();

  // Phase A: query tile `warp`.
  const int r0 = warp * 16;
  const bool has_q = warp < n_tiles;
  float s[2 * NKT][4];
  float inv0 = 0.0f, inv1 = 0.0f, max0 = 0.0f, max1 = 0.0f;
  // Lane addresses: the A fragments of the warp's 16 rows; a B operand of 16
  // rows taken transposed (two 8-row column tiles); a B operand whose
  // reduction index runs down 16 rows (two 8-column tiles).
  const int a_off = (r0 + lane % 16) * kLd + (lane / 16) * 8;
  const int b_off = ((lane / 16) * 8 + lane % 8) * kLd + ((lane / 8) % 2) * 8;
  const int t_off = (((lane / 8) % 2) * 8 + lane % 8) * kLd + (lane / 16) * 8;
  // The row of W stays in registers for column tiles 0 .. NKT - 1 and waits
  // as fp32 in the warp's own dS rows for the rest (NKT * 32 bytes a row fit
  // in its NKT * 32 + 16).  Element e of column tile j there: float2
  // (j - NKT) * 4 + t of row g (e < 2) or g + 8.
  float2* w_a = reinterpret_cast<float2*>(s_ds + (r0 + g) * kLdS) + t;
  float2* w_b = reinterpret_cast<float2*>(s_ds + (r0 + g + 8) * kLdS) + t;
  if (has_q) {
    row_products<HD, NKT>(s, s_qs + a_off, s_k + b_off);
    attention_softmax<NKT, !Plan::kCopyQ, true>(s, lane, n_valid, softmax_f32, score_scale, inv0,
                                                inv1, max0, max1);
    if (t == 0) {
      s_stat[r0 + g] = make_float2(max0, inv0);
      s_stat[r0 + g + 8] = make_float2(max1, inv1);
    }
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {  // s <- W, the normalised fp32 weights
      s[j][0] *= inv0;
      s[j][1] *= inv0;
      s[j][2] *= inv1;
      s[j][3] *= inv1;
      if (j >= NKT) {
        w_a[(j - NKT) * 4] = make_float2(s[j][0], s[j][1]);
        w_b[(j - NKT) * 4] = make_float2(s[j][2], s[j][3]);
      }
    }
  }
  cp_async_wait<0>();  // V and dO are in
  finish_rows_one_column<HD>(s_v, kPad, N, with_bias, with_bias ? s_add_v[chunk] : add_v, nullptr,
                             1.0f);
  __syncthreads();

  if (has_q && !(probe & kProbeNoPhaseABackward)) {
    // W's column tile j, from registers or from where it waits.
    auto weights = [&](int j, float (&w)[4]) {
      const float2 lo = j < NKT ? make_float2(s[j][0], s[j][1]) : w_a[(j - NKT) * 4];
      const float2 hi = j < NKT ? make_float2(s[j][2], s[j][3]) : w_b[(j - NKT) * 4];
      w[0] = lo.x;
      w[1] = lo.y;
      w[2] = hi.x;
      w[3] = hi.y;
    };
    // dW = dO V^T 16 keys at a time: tmp, then dS.
    float tmp0 = 0.0f, tmp1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NKT; j += 2) {
      float dw[2][4];
      row_pair_product<HD>(dw, s_do + a_off, s_v + j * 8 * kLd + b_off);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float w[4];
        weights(j + jj, w);
        tmp0 += dw[jj][0] * w[0] + dw[jj][1] * w[1];
        tmp1 += dw[jj][2] * w[2] + dw[jj][3] * w[3];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmp0 += __shfl_xor_sync(0xffffffffu, tmp0, off);
      tmp1 += __shfl_xor_sync(0xffffffffu, tmp1, off);
    }
    // dS over the column tiles from kStash on (their weights wait where dS
    // goes) is held packed until every waiting weight is read; the tiles
    // before it are stored as they come, after that.
    constexpr int kStash = 2 * (NKT / 2);
    bf16* ds_a = s_ds + (r0 + g) * kLdS + 2 * t;  // row g; row g + 8 is 8 * kLdS on
    // Column tiles j, j + 1 of dS, packed: rows g and g + 8 of each.
    auto ds_pair = [&](int j, uint32_t (&d0)[2], uint32_t (&d1)[2]) {
      float dw[2][4];
      row_pair_product<HD>(dw, s_do + a_off, s_v + j * 8 * kLd + b_off);
      float w[2][4];
      weights(j, w[0]);
      weights(j + 1, w[1]);
      d0[0] = pack_floats(w[0][0] * (dw[0][0] - tmp0) * ds_scale,
                          w[0][1] * (dw[0][1] - tmp0) * ds_scale);
      d0[1] = pack_floats(w[0][2] * (dw[0][2] - tmp1) * ds_scale,
                          w[0][3] * (dw[0][3] - tmp1) * ds_scale);
      d1[0] = pack_floats(w[1][0] * (dw[1][0] - tmp0) * ds_scale,
                          w[1][1] * (dw[1][1] - tmp0) * ds_scale);
      d1[1] = pack_floats(w[1][2] * (dw[1][2] - tmp1) * ds_scale,
                          w[1][3] * (dw[1][3] - tmp1) * ds_scale);
    };
    auto store_ds = [&](int j, const uint32_t (&d)[2]) {
      *reinterpret_cast<uint32_t*>(ds_a + j * 8) = d[0];
      *reinterpret_cast<uint32_t*>(ds_a + 8 * kLdS + j * 8) = d[1];
    };
    uint32_t stash[2 * NKT - kStash][2];
#pragma unroll
    for (int j = kStash; j < 2 * NKT; j += 2) ds_pair(j, stash[j - kStash], stash[j - kStash + 1]);
    __syncwarp();  // every waiting weight is read
#pragma unroll
    for (int j = kStash; j < 2 * NKT; ++j) store_ds(j, stash[j - kStash]);
#pragma unroll
    for (int j = 0; j < kStash; j += 2) {
      uint32_t d0[2], d1[2];
      ds_pair(j, d0, d1);
      store_ds(j, d0);
      store_ds(j + 1, d1);
    }
    __syncwarp();  // the warp's dS rows are in

    float dq[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
      uint32_t dsa[4];
      ldmatrix_x4(dsa, s_ds + (r0 + lane % 16) * kLdS + kt * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, s_k + t_off + kt * 16 * kLd + n * 8);
        mma_16816(dq[n], dsa, kb[0], kb[1]);
        mma_16816(dq[n + 1], dsa, kb[2], kb[3]);
      }
    }
    store_gradient_tile<HD>(dq, out_scale, out, ld, r0, N, db, g, t);
  }
  __syncthreads();  // every query row's dS and statistics are in

  // Phase B: key tile `warp`; dK and dV summed over the query tiles in order.
  if (warp < n_tiles && !(probe & kProbeNoPhaseB)) {
    const int k0 = warp * 16;
    uint32_t ka[kKT][4];
    load_q_fragments<HD>(ka, s_k, k0, lane);
    const bool masked_a = k0 + g >= n_valid;
    const bool masked_b = k0 + g + 8 >= n_valid;
    const bf16* qs_lane = s_qs + b_off;
    const bf16* do_lane = s_do + t_off;
    const bf16* q_lane = s_q + t_off;
    // dS^T's A fragment of this key tile: ldmatrix.trans of the stored dS rows.
    const bf16* ds_lane = s_ds + ((lane / 16) * 8 + lane % 8) * kLdS + k0 + ((lane / 8) % 2) * 8;
    const bool exp_weights = !(probe & kProbeNoExpB);
    float dk[kNT][4], dv[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
      dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
    }
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * 16;
      float st[2][4];  // S^T: keys k0 + g (+ 8), queries q0 + 8 jn + 2t (+ 1)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) st[jn][0] = st[jn][1] = st[jn][2] = st[jn][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        uint32_t qb[4];
        ldmatrix_x4(qb, qs_lane + q0 * kLd + kk * 16);
        mma_16816(st[0], ka[kk], qb[0], qb[1]);
        mma_16816(st[1], ka[kk], qb[2], qb[3]);
      }
      float wt[8];  // W^T in the A operand's order
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const float4 stat = *reinterpret_cast<const float4*>(s_stat + q0 + jn * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (e < 2 ? masked_a : masked_b) ? -INFINITY : st[jn][e] * score_scale;
          if (!softmax_f32) x = round_bf16(x);
          const float m = e & 1 ? stat.z : stat.x;
          const float inv = e & 1 ? stat.w : stat.y;
          wt[jn * 4 + e] = (exp_weights ? exp2_approx(fmaf(x, kLog2e, -m)) : x) * inv;
        }
      }
      uint32_t wa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wa[i] = pack_floats(wt[2 * i], wt[2 * i + 1]);
      uint32_t dsa[4];
      ldmatrix_x4_trans(dsa, ds_lane + q0 * kLdS);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, do_lane + q0 * kLd + n * 8);
        mma_16816(dv[n], wa, ob[0], ob[1]);
        mma_16816(dv[n + 1], wa, ob[2], ob[3]);
        ldmatrix_x4_trans(qb, q_lane + q0 * kLd + n * 8);
        mma_16816(dk[n], dsa, qb[0], qb[1]);
        mma_16816(dk[n + 1], dsa, qb[2], qb[3]);
      }
    }
    store_gradient_tile<HD>(dk, out_scale, out + D, ld, k0, N, db == nullptr ? nullptr : db + HD,
                            g, t);
    store_gradient_tile<HD>(dv, 1.0f, out + 2 * D, ld, k0, N,
                            db == nullptr ? nullptr : db + 2 * HD, g, t);
  }
  if (dbias_part == nullptr) return;
  __syncthreads();
  store_dbias_partial<HD, NKT>(s_db, dbias_part, b, h, D);
}

// The first design (8 warps, dS recomputed in phase B), for N past 208.
template <int HD, int NKT>
constexpr size_t recompute_smem_bytes() {
  return static_cast<size_t>(4 * NKT * 16) * (HD + 8) * sizeof(bf16) +
         static_cast<size_t>(3 * NKT * 16 + kBwdWarps * 3 * HD) * sizeof(float);
}

template <int HD, int NKT, int MODE>
__global__ void __launch_bounds__(32 * kBwdWarps)
qkv_attention_bwd_recompute_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
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
  attention_backward_recompute_ds<HD, NKT, MODE>(
      s_q, s_k, s_v, s_do, s_max, s_inv, s_tmp,
      want_dbias ? s_db + (threadIdx.x / 32) * 3 * HD : nullptr, out, out + D, out + 2 * D, ld, N,
      n_valid, scale_c, scale, softmax_f32);
  if (!want_dbias) return;
  __syncthreads();
  store_dbias_partial<HD>(s_db, dbias_part, b, h, D);
}

// With a bias and no dbias, the (B, 3D) partial rows are left for the caller
// to add (attention_block.cu times that sum apart).
template <int HD, int NKT, int MODE>
cudaError_t launch_bwd(const bf16* qkv, const bf16* bias, const bf16* dout, bf16* dqkv,
                       float* dbias_part, float* dbias, int B, int N, int H, int n_valid,
                       float scale_c, float scale, int softmax_f32, int probe,
                       cudaStream_t stream) {
  float* part = bias == nullptr ? nullptr : dbias_part;
  cudaError_t err;
  if constexpr (NKT <= 13) {
    if (!(probe & kProbeFirstDesign)) {
      using Plan = StoredDsPlan<HD, NKT>;
      // Without a copy of q the scores take scale_c in fp32: it must be
      // 1/sqrt(hd) as bf16 holds it, a power of two.
      if (!Plan::kCopyQ && scale_c != (HD == 16 ? 0.25f : 0.125f)) return cudaErrorInvalidValue;
      static bool configured[kMaxDevices] = {};
      err = allow_dynamic_smem(qkv_attention_bwd_kernel<HD, NKT, MODE>, Plan::kBytes, configured);
      if (err != cudaSuccess) return err;
      qkv_attention_bwd_kernel<HD, NKT, MODE><<<dim3(H, B), 32 * Plan::kWarps, Plan::kBytes, stream>>>(
          qkv, bias, dout, dqkv, part, N, H, n_valid, scale_c, scale, softmax_f32, probe);
      err = cudaGetLastError();
      if (err != cudaSuccess || bias == nullptr || dbias == nullptr) return err;
      return launch_column_sum(dbias_part, B, 3 * H * HD, dbias, stream);
    }
  }
  constexpr size_t smem = recompute_smem_bytes<HD, NKT>();
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(qkv_attention_bwd_recompute_kernel<HD, NKT, MODE>, smem, configured);
  if (err != cudaSuccess) return err;
  qkv_attention_bwd_recompute_kernel<HD, NKT, MODE><<<dim3(H, B), 32 * kBwdWarps, smem, stream>>>(
      qkv, bias, dout, dqkv, part, N, H, n_valid, scale_c, scale, softmax_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || bias == nullptr || dbias == nullptr) return err;
  return launch_column_sum(dbias_part, B, 3 * H * HD, dbias, stream);
}

template <int HD, int NKT>
int bwd_plan(int* warps, int* smem_bytes) {
  if constexpr (NKT <= 13) {
    *warps = StoredDsPlan<HD, NKT>::kWarps;
    *smem_bytes = static_cast<int>(StoredDsPlan<HD, NKT>::kBytes);
    return 1;
  }
  *warps = kBwdWarps;
  *smem_bytes = static_cast<int>(recompute_smem_bytes<HD, NKT>());
  return 0;
}

template <int HD, int MODE>
cudaError_t launch_bwd_head_dim(const bf16* qkv, const bf16* bias, const bf16* dout, bf16* dqkv,
                                float* dbias_part, float* dbias, int B, int N, int H,
                                int n_valid, float scale_c, float scale, int softmax_f32,
                                int probe, cudaStream_t stream) {
#define SSL4POLYP_BWD(HD_, NKT)                                                                     \
  launch_bwd<HD_, NKT, MODE>(qkv, bias, dout, dqkv, dbias_part, dbias, B, N, H, n_valid, scale_c, \
                             scale, softmax_f32, probe, stream)
  SSL4POLYP_FOR_TOKENS(SSL4POLYP_BWD, HD)
#undef SSL4POLYP_BWD
}

template <int HD>
int bwd_plan_head_dim(int N, int* warps, int* smem_bytes) {
  if (N <= 64) return bwd_plan<HD, 4>(warps, smem_bytes);
  if (N <= 128) return bwd_plan<HD, 8>(warps, smem_bytes);
  if (N <= 208) return bwd_plan<HD, 13>(warps, smem_bytes);
  if (N <= 256) return bwd_plan<HD, 16>(warps, smem_bytes);
  return -1;
}

}  // namespace

// qkv: (B, N, 3*H*hd) bf16, [q heads | k heads | v heads]; bias: (3*H*hd,)
// bf16 or null; out: (B, N, H*hd) bf16.  N > 256 goes to
// qkv_attention_tiles.cu.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_fwd(const void* qkv, const void* bias, void* out,
                                           int B, int N, int H, int head_dim, int n_valid,
                                           float scale, int softmax_f32, void* stream) {
  if (N > kTilesPast)
    return ssl4polyp_qkv_attention_tiles_fwd(qkv, bias, out, B, N, H, head_dim, n_valid, scale,
                                             softmax_f32, stream);
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

// ssl4polyp_qkv_attention_bwd_probe where the scale enters as `mode` says:
// 0 as this kernel's TPU kernel puts it (dQ and dK times the fp32 scale,
// then rounded); 1 as attention_block.py's (dS = round_bf16(W * (dW - tmp) *
// scale), dQ and dK unscaled: attention_core.cuh's kBwdFoldScaledDs), at
// head dims 32 and 64.  With a bias, a null dbias leaves the (B, 3D) partial
// rows in dbias_part unsummed.  N > 256 goes to qkv_attention_tiles.cu, with
// its scratch taken from the stream's memory pool, and takes no probe bits.
extern "C" int ssl4polyp_qkv_attention_bwd_mode(const void* qkv, const void* bias,
                                                const void* dout, void* dqkv, void* dbias_part,
                                                void* dbias, int B, int N, int H, int head_dim,
                                                int n_valid, float scale_c, float scale,
                                                int softmax_f32, int mode, int probe,
                                                void* stream) {
  if (N > kTilesPast) {
    if (probe != 0 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t rows = static_cast<size_t>(B) * H * N;
    void* stats = nullptr;
    void* dq_acc = nullptr;
    cudaError_t err = cudaMallocAsync(&stats, rows * 4 * sizeof(float), st);
    if (err == cudaSuccess) err = cudaMallocAsync(&dq_acc, rows * head_dim * sizeof(float), st);
    if (err == cudaSuccess)
      err = static_cast<cudaError_t>(ssl4polyp_qkv_attention_tiles_bwd(
          qkv, bias, dout, dqkv, stats, dq_acc, dbias_part, dbias, B, N, H, head_dim, n_valid,
          scale_c, scale, softmax_f32, mode, stream));
    const cudaError_t freed = dq_acc == nullptr ? cudaSuccess : cudaFreeAsync(dq_acc, st);
    const cudaError_t freed_stats = stats == nullptr ? cudaSuccess : cudaFreeAsync(stats, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(freed != cudaSuccess ? freed : freed_stats);
  }
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bb = static_cast<const bf16*>(bias);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SSL4POLYP_BWD_MODE(HD, MODE)                                                        \
  launch_bwd_head_dim<HD, MODE>(q, bb, d, dq, part, db, B, N, H, n_valid, scale_c, scale, \
                                softmax_f32, probe, s)
  if (mode == kBwdFold) {
    switch (head_dim) {
      case 16: err = SSL4POLYP_BWD_MODE(16, kBwdFold); break;
      case 32: err = SSL4POLYP_BWD_MODE(32, kBwdFold); break;
      case 64: err = SSL4POLYP_BWD_MODE(64, kBwdFold); break;
    }
  } else if (mode == kBwdFoldScaledDs) {
    switch (head_dim) {
      case 32: err = SSL4POLYP_BWD_MODE(32, kBwdFoldScaledDs); break;
      case 64: err = SSL4POLYP_BWD_MODE(64, kBwdFoldScaledDs); break;
    }
  }
#undef SSL4POLYP_BWD_MODE
  return static_cast<int>(err);
}

// ssl4polyp_qkv_attention_bwd with `probe` (0 on every path; the bits at
// kProbeNoPhaseB above leave parts out or run the first design, for timing).
extern "C" int ssl4polyp_qkv_attention_bwd_probe(const void* qkv, const void* bias,
                                                 const void* dout, void* dqkv, void* dbias_part,
                                                 void* dbias, int B, int N, int H, int head_dim,
                                                 int n_valid, float scale_c, float scale,
                                                 int softmax_f32, int probe, void* stream) {
  return ssl4polyp_qkv_attention_bwd_mode(qkv, bias, dout, dqkv, dbias_part, dbias, B, N, H,
                                          head_dim, n_valid, scale_c, scale, softmax_f32,
                                          kBwdFold, probe, stream);
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
  return ssl4polyp_qkv_attention_bwd_probe(qkv, bias, dout, dqkv, dbias_part, dbias, B, N, H,
                                           head_dim, n_valid, scale_c, scale, softmax_f32, 0,
                                           stream);
}

// Which backward takes (N, head_dim): 1 the stored-dS kernel, 0 the first
// design, 2 qkv_attention_tiles.cu's key tiles (N > 256; its gradient
// pass's block), -1 none; *warps and *smem_bytes receive its block's warps
// and dynamic shared memory.
extern "C" int ssl4polyp_qkv_attention_bwd_plan(int N, int head_dim, int* warps,
                                                int* smem_bytes) {
  if (N < 1) return -1;
  if (N > kTilesPast) return ssl4polyp_qkv_attention_tiles_bwd_plan(head_dim, warps, smem_bytes);
  switch (head_dim) {
    case 16: return bwd_plan_head_dim<16>(N, warps, smem_bytes);
    case 32: return bwd_plan_head_dim<32>(N, warps, smem_bytes);
    case 64: return bwd_plan_head_dim<64>(N, warps, smem_bytes);
    default: return -1;
  }
}
