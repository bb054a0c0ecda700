// The QKV projection and the attention core in one kernel, forward and
// backward:  out = attention(x . W + b), x (B, N, Din), W (Din, 3D), b (3D,).
//
// Replaces: ssl4polyp_tpu/ops/attention_block.py::_fwd_kernel and _bwd_kernel
// (fused_qkvproj_attention).  The forward never writes the (B, N, 3D) QKV
// tensor to global memory; the backward recomputes it from x into a scratch
// of device memory (below).
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
// byte: the tensor cores bound it, as they bound the backward's 153 GFLOP
// (three projection-sized products, 134 GFLOP, and the core's 19).
//
// The forward (the second design; PERF.md has its times, the first
// design's and the ablations, through ssl4polyp_qkvproj_attention_fwd_probe):
//   * A unit is one image and 64 of W's columns in each of its three
//     panels: one head at hd 64, two neighbouring heads at hd 32, so that the
//     projection is the same at both.  A persistent grid of one block an SM
//     walks the units head-fastest (unit blockIdx.x + i * gridDim.x), so the
//     blocks in flight share a few images' x and all of W in L2.
//   * The projection is computed transposed, qkv^T = W^T x^T: each of W's
//     three 64-column panels (q, k, v) is the MN-major A operand, read as it
//     lies in W's (in, out) layout with wgmma's transpose bit, and x's rows
//     are the K-major B operand.  M is 3 x 64 features, exact, where the other
//     form would pad 197 rows to 256; the tokens are padded to 16 * NKT (208
//     at N 197, 6 % wasted).  Two consumer warpgroups split the tokens in
//     halves and hold all three panels' products for theirs: 3 x
//     m64n(8 NKT)k16 a step of 16, 3 x 4 NKT accumulators a thread (156 at
//     N 197).
//   * A producer thread (its warpgroup gives its registers up by
//     setmaxnreg) loads each 32-deep reduction step by TMA into a ring stage
//     (five at N 197, 25.6 KB each): x's 16 * NKT rows of 32 columns from a
//     3-D map over (B, N, Din) under the 64-byte swizzle, whose rows at or
//     past N arrive as zeros and never come from the next image, and the
//     three 32 x 64 W boxes at columns p * D + 64 * (the unit's column
//     block).  x is read once a unit, not once a panel.  The ring runs on
//     across units, so the next unit's first stages load while this one's
//     attention runs.  Steps of 64 (two stages fit) and of 16 were slower,
//     and so were clusters sharing x stages and W boxes by TMA multicast:
//     neither the L2's rate nor the intake binds (without x's loads, or
//     without W's, the projection runs 5 % faster), the products and their
//     per-step cost do.
//   * The epilogue rounds each product to bf16, adds the bias in bf16 and
//     rounds again, folds 1/sqrt(hd) into q with its rounding, zeroes the
//     tokens at or past N, and stores the tiles transposed (stmatrix .trans)
//     as row-major, swizzled Q, K and V tiles laid out as attention.cu's:
//     (token, hd) rows of 2 * hd bytes under the swizzle of that width.  The
//     two consumer warpgroups meet at a named barrier before (the last unit's
//     attention is done with the tiles) and after (the tiles are whole).
//   * The attention phase is attention.cu's on these tiles: the two
//     warpgroups take a unit's (head, 64-row query tile) items in turn; S =
//     Q K^T by wgmma m64n(16 NKT)k16 from shared memory; keys at or past
//     valid_len masked, the scores rounded to bf16 unless softmax_f32, the
//     exact softmax on the accumulator fragments (exp2 on the special
//     function unit, eight max and sum chains a row), the weights rounded
//     into wgmma's register A fragments; O = P V by register-A wgmma with V
//     MN-major; O rounded once and stored 16 bytes a thread behind a row
//     guard, nothing past row N - 1 or outside the head's columns.  It does
//     not overlap the next unit's products: those need the 156 accumulators
//     the softmax's score row shares the registers with, and a third
//     warpgroup (one a panel, or the producer's taking attention items)
//     leaves each thread 168 registers, under which the score row spills.
//   * No atomics: a rerun gives the same bits.
//
// The first design (qkvproj_attention_first_kernel, reached only through
// the probe): a block of 8 warps per (image, head) streams x in 64-column
// reduction steps against the head's three 768 x hd panels of W one panel
// after the other through a two-stage cp.async ring (mma.sync m16n8k16,
// W's tile read transposed with ldmatrix.trans), so every head reads its
// image's x three times; each panel's epilogue leaves Q, K or V in shared
// memory, where attention_core.cuh's attention_rows takes 16 query rows a
// warp.  Its projection is project_head, which the backward's first design
// shares.
//
// The backward (the second design): four steps, each on a kernel designed
// for this card, with two (B, N, 3D) bf16 scratches in device memory between
// them (58 MB each at the classifier's shape; 0.035 ms of HBM traffic a
// round trip): the backward's 134 GFLOP of projection-sized products want
// the card's wgmma GEMMs, which the first design's per-head projection on
// mma.sync (x read three times a head) was not.
//   1. qkv = round_bf16(x . W), the bias not added, on mlp.cu's wgmma + TMA
//      GEMM (ssl4polyp_matmul_nt), whose K-major B operand is W^T: a 32 x 32
//      tile transpose (weight_transpose_kernel) writes it first.
//   2. The attention backward on qkv with b as its bias: qkv_attention.cu's
//      kernel (the stored-dS kernel up to 208 tokens, its first design past
//      them) in attention_block.py's mode (ssl4polyp_qkv_attention_bwd_mode
//      1: dS = round_bf16(W * (dW - tmp) * scale), dQ and dK unscaled).  Its
//      staging rounds qkv + b in bf16, which is _project's second rounding,
//      and its dbias partials (the rounded dqkv summed over each image's
//      rows) are db's: column_sum_kernel adds the B rows in order.
//   3. dx = round_bf16(dqkv . W^T) on the same GEMM: W's (in, out) rows are
//      contiguous along the reduction, so W is its K-major B as it lies.
//   4. dW = x^T dqkv on dw_product.cu's wgmma product, both operands
//      MN-major, row slices added in order.
// No atomics anywhere: a rerun gives the same bits.
//
// The first design of the backward (qkvproj_attention_bwd_kernel, reached
// only through ssl4polyp_qkvproj_attention_bwd_probe, for timing): a block
// per (image, head) recomputes the head's q, k and v with project_head, then
// runs attention_core.cuh's attention_backward_recompute_ds (mode
// kBwdFoldScaledDs), writing dqkv and a (B, 3D) db partial; dx as step 3;
// dW on transposed_product.cuh (mma.sync, 3D a multiple of 64).
//
// Past 256 tokens.  The forward above holds a head's whole Q, K and V tiles
// and a whole score row on chip (SSL4POLYP_FOR_TOKENS ends at 16 key tiles);
// a ViT-B/16 at 384 px has 577 tokens.  There the forward writes qkv to a
// (B, N, 3D) bf16 scratch as the backward's step 1 does: W^T by
// weight_transpose_kernel, qkv = round_bf16(x . W) on the bare GEMM, then
// qkv_attention_tiles.cu's forward with b as its bias (added in bf16 as each
// tile lands: _project's second rounding), both scratches the caller's.  The
// scratch costs 227 MB of HBM traffic a round trip at B 64, N 577, 3D 2,304
// (0.068 ms), against the key tiles' 0.8 ms.  The
// backward's four steps are the same at any N; past 256 tokens step 2 runs
// the key tiles' backward in mode 1, which leaves the (B, 3D) dbias partial
// rows for the column sum when given no dbias, its statistics and dQ sums in
// the caller's scratch.  The first designs take at most 256 tokens.
#include "attention_core.cuh"
#include "hopper.cuh"
#include "qkv_attention_tiles.cuh"
#include "transposed_product.cuh"

// The library's other entry points this backward (and the forward past
// kTilesPast tokens) runs (mlp.cu, qkv_attention.cu, dw_product.cu).
extern "C" int ssl4polyp_matmul_nt(const void* x, const void* w, void* y, int M, int K, int NF,
                                   void* stream);
extern "C" int ssl4polyp_qkv_attention_fwd(const void* qkv, const void* bias, void* out, int B,
                                           int N, int H, int head_dim, int n_valid, float scale,
                                           int softmax_f32, void* stream);
extern "C" int ssl4polyp_qkv_attention_bwd_mode(const void* qkv, const void* bias,
                                                const void* dout, void* dqkv, void* dbias_part,
                                                void* dbias, int B, int N, int H, int head_dim,
                                                int n_valid, float scale_c, float scale,
                                                int softmax_f32, int mode, int probe,
                                                void* stream);
extern "C" int ssl4polyp_dw_product(const void* a, const void* b, void* part, void* dw, int M,
                                    int I, int J, int slices, int parts, void* stream);

namespace {

// `probe` bits of the forward, a measurement aid (0 on every path;
// chip_smoke.py times the kernel with parts left out, whose results are
// wrong): no softmax arithmetic (the scores rounded straight into the
// weights), no projection products (q, k and v are the bias alone), no
// prefetch (a unit's loads start once the last unit is done); and two with
// right results: the first design, and the projection alone (each head's q,
// before the scale fold, written into its columns of out).
constexpr int kProbeNoSoftmax = 1;
constexpr int kProbeNoProjection = 2;
constexpr int kProbeNoPrefetch = 4;
constexpr int kProbeFirstDesign = 8;
constexpr int kProbeProjectionOnly = 16;
constexpr int kProbeBits = 31;

// `probe` bits of the backward, a measurement aid (0 on every path): the
// first design; and which of the backward's launches run (none of bits 1-7
// set: all), each reading what the earlier ones left in the buffers, so that
// a caller times each launch alone.  The first design has no transpose or
// projection launch: it recomputes qkv inside its attention kernel.
constexpr int kBwdProbeFirstDesign = 1;
constexpr int kStepTranspose = 2;
constexpr int kStepProjection = 4;
constexpr int kStepAttention = 8;
constexpr int kStepDbSum = 16;
constexpr int kStepDx = 32;
constexpr int kStepDw = 64;
constexpr int kStepDwSum = 128;
constexpr int kSteps = 254;
constexpr int kBwdProbeBits = 255;
// The first design's row slices of dW (transposed_product.cuh).
constexpr int kFirstDesignDwSlices = 2;

// ---------------------------------------------------------------------------
// The first design's projection (the backward's first design's too) and
// forward.
// ---------------------------------------------------------------------------

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

// The first design's forward (kProbeFirstDesign).
template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kBwdWarps)
qkvproj_attention_first_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
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
  attention_backward_recompute_ds<HD, NKT, kBwdFoldScaledDs>(
      s_q, s_k, s_v, s_do, s_max, s_inv, s_tmp, s_db + (threadIdx.x / 32) * 3 * HD, dst, dst + D,
      dst + 2 * D, ld, N, n_valid, scale_c, scale, softmax_f32);
  __syncthreads();
  store_dbias_partial<HD>(s_db, db_part, b, h, D);
}

// ---------------------------------------------------------------------------
// The forward (second design).
// ---------------------------------------------------------------------------

constexpr int kThreads = 384;      // a producer warpgroup, two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kConsumerThreads = 256;
constexpr int kQRows = 64;         // a query tile: one wgmma's M
constexpr int kUnitCols = 64;      // W's columns a unit takes in each panel
constexpr int kStep = 32;          // reduction depth of a ring stage
constexpr int kChains = 8;         // independent max and sum chains a row
constexpr int kBarrierFree = 1;    // named barriers of the consumer warpgroups
constexpr int kBarrierReady = 2;

// Shared memory of the forward, each piece aligned to 1,024 bytes (the
// swizzle's period): a unit's Q, K and V for each of its heads (attention.cu's
// Buffers: the Q tiles, then K and V), then the ring of stages (x's 16 * NKT
// rows of 32 reduction columns under the 64-byte swizzle, then the three W
// boxes of 32 x 64 under the 128-byte one), then the barriers.
template <int HD, int NKT>
struct Layout {
  static constexpr int kHeads = kUnitCols / HD;  // heads a unit
  static constexpr int kRowBytes = 2 * HD;
  static constexpr int kKeys = 16 * NKT;
  static constexpr int kHalf = kKeys / 2;        // tokens a consumer warpgroup projects
  static constexpr int kQTiles = (kKeys + kQRows - 1) / kQRows;
  static constexpr uint32_t kQTileBytes = kQRows * kRowBytes;
  static constexpr uint32_t kKVStride = (kKeys * kRowBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kK = kQTiles * kQTileBytes;  // offsets in a head's tiles
  static constexpr uint32_t kV = kK + kKVStride;
  static constexpr uint32_t kHeadBytes = kV + kKVStride;
  static constexpr uint32_t kQKVBytes = kHeads * kHeadBytes;
  static constexpr uint32_t kXBytes = kKeys * 2 * kStep;
  static constexpr uint32_t kWBytes = kStep * 2 * kUnitCols;
  static constexpr uint32_t kStageBytes = kXBytes + 3 * kWBytes;
  static constexpr size_t kFixed = kQKVBytes + 32 * sizeof(uint64_t) + 1024;
  static constexpr int kFit = static_cast<int>((232448 - kFixed) / kStageBytes);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static_assert(kStages >= 2, "two stages and the tiles fit the block's shared memory");
  static_assert(2 * kStages + 1 <= 32, "the barriers fit their room");
  static constexpr size_t kSmemBytes = kFixed + kStages * kStageBytes;
};

// acc (+)= W_panel^T x^T for a step of 16: 64 features by N tokens, W's
// panel MN-major (as it lies), x's rows K-major.
template <int N>
__device__ __forceinline__ void wgmma_projection(float (&acc)[N / 2], uint64_t desc_w,
                                                 uint64_t desc_x) {
  if constexpr (N == 32) {
    wgmma_m64n32k16_mn_a(acc, desc_w, desc_x, 1);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_mn_a(acc, desc_w, desc_x, 1);
  } else if constexpr (N == 104) {
    wgmma_m64n104k16_mn_a(acc, desc_w, desc_x, 1);
  } else {
    static_assert(N == 128, "half a key width of the dispatch");
    wgmma_m64n128k16_mn_a(acc, desc_w, desc_x, 1);
  }
}

// S (+)= Q K^T for 64 query rows and 16 * NKT keys, both K-major.
template <int NKT>
__device__ __forceinline__ void wgmma_scores(float (&s)[8 * NKT], uint64_t desc_q, uint64_t desc_k,
                                             int accumulate) {
  if constexpr (NKT == 4) {
    wgmma_m64n64k16(s, desc_q, desc_k, accumulate);
  } else if constexpr (NKT == 8) {
    wgmma_m64n128k16(s, desc_q, desc_k, accumulate);
  } else if constexpr (NKT == 13) {
    wgmma_m64n208k16(s, desc_q, desc_k, accumulate);
  } else {
    static_assert(NKT == 16, "a key width of the dispatch");
    wgmma_m64n256k16(s, desc_q, desc_k, accumulate);
  }
}

// O (+)= P V for 16 keys: P from registers, V MN-major.
template <int HD>
__device__ __forceinline__ void wgmma_values(float (&o)[HD / 2], const uint32_t (&p)[4],
                                             uint64_t desc_v, int accumulate) {
  if constexpr (HD == 32) {
    wgmma_m64n32k16_rs_mn(o, p, desc_v, accumulate);
  } else {
    static_assert(HD == 64, "a head dim of the dispatch");
    wgmma_m64n64k16_rs_mn(o, p, desc_v, accumulate);
  }
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a tile of
// ROW_BYTES-byte rows (128 or 64) under the swizzle of that width, as TMA
// writes it and wgmma reads it (the tile aligned to 1,024 bytes).
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  const uint32_t off = row * ROW_BYTES + chunk * 16;
  return off ^ ((off >> 3) & (ROW_BYTES == 128 ? 0x70u : 0x30u));
}

// Combines C partial maxima (or sums) pairwise into r[0].
template <int C, typename Op>
__device__ __forceinline__ void combine(float (&r)[C], Op op) {
#pragma unroll
  for (int w = C / 2; w > 0; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) r[c] = op(r[c], r[c + w]);
}

// The weights of a warp's rows g and g + 8 from their scores (s[4 j + e]:
// key 8 j + 2 t + (e & 1), row g for e < 2, else g + 8, as wgmma leaves
// them; q carries the scale already): keys at or past n_valid masked, the
// scores rounded to bf16 unless softmax_f32, the exact softmax (exp2 with
// log2(e) folded into one FMA), normalised and rounded into p, wgmma's A
// fragments of the 16-key steps (p[kt]: keys 16 kt + 2t, + 1 of rows g and
// g + 8, then keys 16 kt + 8 + 2t, + 1).  The maxima and sums run as
// kChains chains a row, combined pairwise.  Without `softmax`, p is S
// rounded (a measurement aid).
template <int NKT>
__device__ __forceinline__ void attention_weights(float (&s)[8 * NKT], uint32_t (&p)[NKT][4],
                                                  int n_valid, int softmax_f32, int t,
                                                  bool softmax) {
  float inv0 = 1.0f, inv1 = 1.0f;
  if (softmax) {
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
      if (8 * j + 8 > n_valid) {  // the column tile reaches past the last valid key
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= n_valid) s[4 * j + e] = -INFINITY;
      }
    }
    if (!softmax_f32) {
#pragma unroll
      for (int i = 0; i < 8 * NKT; ++i) s[i] = round_bf16(s[i]);
    }
    float max0[kChains], max1[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) max0[c] = max1[c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
      max0[j % kChains] = fmaxf(max0[j % kChains], fmaxf(s[4 * j], s[4 * j + 1]));
      max1[j % kChains] = fmaxf(max1[j % kChains], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const auto max_op = [](float a, float b) { return fmaxf(a, b); };
    combine(max0, max_op);
    combine(max1, max_op);
    float m0 = max0[0], m1 = max1[0];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    m0 *= kLog2e;
    m1 *= kLog2e;
    float sum0[kChains], sum1[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) sum0[c] = sum1[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], kLog2e, e < 2 ? -m0 : -m1));
      sum0[j % kChains] += s[4 * j] + s[4 * j + 1];
      sum1[j % kChains] += s[4 * j + 2] + s[4 * j + 3];
    }
    const auto sum_op = [](float a, float b) { return a + b; };
    combine(sum0, sum_op);
    combine(sum1, sum_op);
    float total0 = sum0[0], total1 = sum1[0];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      total0 += __shfl_xor_sync(0xffffffffu, total0, off);
      total1 += __shfl_xor_sync(0xffffffffu, total1, off);
    }
    inv0 = 1.0f / total0;
    inv1 = 1.0f / total1;
  }
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    const float* a = s + 8 * kt;
    p[kt][0] = pack_floats(a[0] * inv0, a[1] * inv0);
    p[kt][1] = pack_floats(a[2] * inv1, a[3] * inv1);
    p[kt][2] = pack_floats(a[4] * inv0, a[5] * inv0);
    p[kt][3] = pack_floats(a[6] * inv1, a[7] * inv1);
  }
}

// A packed pair of fp32 products rounded to bf16, plus `bias` (both halves)
// rounded again, times `scale` rounded again where `fold`: the bf16
// instructions give the fp32 route's bits (attention_core.cuh's
// finish_rows_in_place says why).
__device__ __forceinline__ uint32_t finish_pair(float a, float b, __nv_bfloat162 bias,
                                                __nv_bfloat162 scale, bool fold) {
  const uint32_t packed = pack_floats(a, b);
  __nv_bfloat162 v = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&packed), bias);
  if (fold) v = __hmul2(v, scale);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int NKT>
__global__ void __launch_bounds__(kThreads, 1)
qkvproj_attention_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ bias,
                         bf16* __restrict__ out, int B, int N, int Din, int H, int n_valid,
                         float scale_c, int softmax_f32, int probe) {
  using L = Layout<HD, NKT>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  unsigned char* tiles = smem;  // [kHeads][Q tiles | K | V]
  unsigned char* ring = smem + L::kQKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* done = empty + kStages;  // a unit's end, for kProbeNoPrefetch
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&empty[s], kConsumerWarps);
    }
    mbarrier_init(done, kConsumerWarps);
    mbarrier_init_fence();
  }
  // The query rows past the projected ones, up to the last 64-row tile, are
  // zero for good: no product of theirs is stored, but they stay finite.
  constexpr int kPadChunks = (L::kQTiles * kQRows - L::kKeys) * L::kRowBytes / 16;
  if constexpr (kPadChunks > 0) {
    for (int i = threadIdx.x; i < L::kHeads * kPadChunks; i += blockDim.x) {
      const uint32_t at = L::kKeys * L::kRowBytes + (i % kPadChunks) * 16;
      *reinterpret_cast<uint4*>(tiles + (i / kPadChunks) * L::kHeadBytes + at) =
          make_uint4(0, 0, 0, 0);
    }
  }
  fence_proxy_async_shared();
  __syncthreads();

  const int D = H * HD;
  const int per_image = (H + L::kHeads - 1) / L::kHeads;  // units an image
  const int units = B * per_image;
  const int ksteps = Din / kStep;

  // The roles part here and never meet again: no block-wide barrier below.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t parity = 1;  // a fresh "empty" barrier lets the first pass through
      for (int unit = blockIdx.x, i = 0; unit < units; unit += gridDim.x, ++i) {
        if ((probe & kProbeNoPrefetch) && i > 0) mbarrier_wait(done, (i - 1) & 1);
        const int b = unit / per_image;
        const int col = (unit % per_image) * kUnitCols;
        for (int ks = 0; ks < ksteps; ++ks) {
          mbarrier_wait(&empty[stage], parity);
          unsigned char* st = ring + stage * L::kStageBytes;
          mbarrier_arrive_expect_tx(&full[stage], L::kStageBytes);  // zeros count
          tma_load_3d(st, &map_x, &full[stage], ks * kStep, 0, b);
          for (int p = 0; p < 3; ++p)
            tma_load_2d(st + L::kXBytes + p * L::kWBytes, &map_w, &full[stage], p * D + col,
                        ks * kStep);
          if (++stage == kStages) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int group = threadIdx.x / 128 - 1;  // consumer warpgroup: tokens group * kHalf ..
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool project = !(probe & kProbeNoProjection);
  const bool attend = !(probe & kProbeProjectionOnly);
  const bool softmax = !(probe & kProbeNoSoftmax);
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_c);
  const int tok0 = group * L::kHalf;
  int stage = 0;
  uint32_t parity = 0;
  for (int unit = blockIdx.x, i = 0; unit < units; unit += gridDim.x, ++i) {
    const int b = unit / per_image;
    const int head0 = (unit % per_image) * L::kHeads;
    const int col = head0 * HD;

    // acc[p][4 j + e]: panel p (q, k, v); feature 16 warp + g of the unit's
    // 64 for e < 2, + 8 for e >= 2; token tok0 + 8 j + 2 t + (e & 1).
    float acc[3][L::kHalf / 2];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int e = 0; e < L::kHalf / 2; ++e) acc[p][e] = 0.0f;
    int previous = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbarrier_wait(&full[stage], parity);
      if (project) {
        const unsigned char* st = ring + stage * L::kStageBytes;
        const uint64_t desc_x = wgmma_descriptor_swizzled<2 * kStep>(st + tok0 * 2 * kStep);
        const uint64_t desc_w = wgmma_descriptor_swizzled<128>(st + L::kXBytes);
        wgmma_pin(acc[0]);
        wgmma_pin(acc[1]);
        wgmma_pin(acc[2]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kStep / 16; ++kk)  // 16 along K: 32 bytes of x, 16 rows of W
#pragma unroll
          for (int p = 0; p < 3; ++p)
            wgmma_projection<L::kHalf>(acc[p], desc_w + p * (L::kWBytes >> 4) + kk * 128,
                                       desc_x + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
      }
      if (ks > 0 && lane == 0) mbarrier_arrive(&empty[previous]);
      previous = stage;
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbarrier_arrive(&empty[previous]);
    wgmma_pin(acc[0]);
    wgmma_pin(acc[1]);
    wgmma_pin(acc[2]);

    // The epilogue: this thread's features f and f + 8 of each panel, its
    // warp's 16 features the 16-byte chunks 2 warp and 2 warp + 1 of the
    // unit's 64 (the head's row at hd 64; chunks of two heads' rows at hd
    // 32).  stmatrix's lanes 0-7 address the first chunk's 8 token rows,
    // lanes 8-15 the second's.
    named_barrier_sync(kBarrierFree, kConsumerThreads);  // the last unit's tiles are read
    const int f = 16 * warp + g;
    const int chunk = 2 * warp + ((lane >> 3) & 1);
    unsigned char* head_tiles = tiles + (chunk / (HD / 8)) * L::kHeadBytes;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const bf16 zero = __float2bfloat16(0.0f);
      const bf16 b_lo = col + f < D ? bias[p * D + col + f] : zero;
      const bf16 b_hi = col + f + 8 < D ? bias[p * D + col + f + 8] : zero;
      const bool fold = p == 0 && attend;
      unsigned char* dst = head_tiles + (p == 0 ? 0 : p == 1 ? L::kK : L::kV);
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const int tok = tok0 + 8 * j + 2 * t;
        uint32_t lo = finish_pair(acc[p][4 * j], acc[p][4 * j + 1], __bfloat162bfloat162(b_lo),
                                  scale2, fold);
        uint32_t hi = finish_pair(acc[p][4 * j + 2], acc[p][4 * j + 3],
                                  __bfloat162bfloat162(b_hi), scale2, fold);
        const uint32_t keep = tok >= N ? 0u : tok + 1 >= N ? 0x0000ffffu : 0xffffffffu;
        stmatrix_x2_trans(dst + swizzled<L::kRowBytes>(tok0 + 8 * j + (lane & 7),
                                                      chunk % (HD / 8)),
                          lo & keep, hi & keep);
      }
    }
    fence_proxy_async_shared();  // the stores, before wgmma reads them
    named_barrier_sync(kBarrierReady, kConsumerThreads);

    if (attend) {
      // The warpgroups take the (head, query tile) items in turn, the first
      // by the unit's parity, so that a short last tile falls to each in turn.
      const int q_tiles = (N + kQRows - 1) / kQRows;
      for (int item = (group + i) & 1; item < L::kHeads * q_tiles; item += 2) {
        const int hh = item / q_tiles;
        const int tile = item % q_tiles;
        if (head0 + hh >= H) continue;  // hd 32 and an odd head count: the last unit's second
        const unsigned char* buf = tiles + hh * L::kHeadBytes;
        const uint64_t desc_q = wgmma_descriptor_swizzled<L::kRowBytes>(buf + tile * L::kQTileBytes);
        const uint64_t desc_k = wgmma_descriptor_swizzled<L::kRowBytes>(buf + L::kK);
        const uint64_t desc_v = wgmma_descriptor_swizzled<L::kRowBytes>(buf + L::kV);
        float s[8 * NKT];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)  // 16 along hd is 32 bytes: 2 descriptor units
          wgmma_scores<NKT>(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(s);

        const int r0 = tile * kQRows + 16 * warp;  // this warp's first row
        uint32_t pw[NKT][4];
        if (r0 < N) {
          attention_weights<NKT>(s, pw, n_valid, softmax_f32, t, softmax);
        } else {  // no row of this warp is a token: its weights are never read
#pragma unroll
          for (int kt = 0; kt < NKT; ++kt) pw[kt][0] = pw[kt][1] = pw[kt][2] = pw[kt][3] = 0u;
        }
        float o[HD / 2];
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < NKT; ++kt)  // 16 keys are 16 rows of V
          wgmma_values<HD>(o, pw[kt], desc_v + kt * ((16 * L::kRowBytes) >> 4), kt);
        wgmma_commit();
        wgmma_wait<0>();  // V is read and pw free
        wgmma_pin(o);
        uint32_t lo[HD / 8], hi[HD / 8];  // o[4 n + e]: column tile n, as s
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          lo[n] = pack_floats(o[4 * n], o[4 * n + 1]);
          hi[n] = pack_floats(o[4 * n + 2], o[4 * n + 3]);
        }
        const int row_a = r0 + g;
        bf16* out_a = out + (static_cast<long>(b) * N + row_a) * D + (head0 + hh) * HD;
        store_tile_rows<HD>(out_a, out_a + 8L * D, lo, hi, row_a < N, row_a + 8 < N, t);
      }
    } else {  // kProbeProjectionOnly: each head's q, unscaled, into its columns of out
      constexpr int kChunks = HD / 8;
      for (int i2 = threadIdx.x - 128; i2 < L::kHeads * N * kChunks; i2 += kConsumerThreads) {
        const int hh = i2 / (N * kChunks);
        const int row = (i2 / kChunks) % N;
        const int c = i2 % kChunks;
        if (head0 + hh >= H) continue;
        *reinterpret_cast<uint4*>(out + (static_cast<long>(b) * N + row) * D + (head0 + hh) * HD +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(tiles + hh * L::kHeadBytes +
                                            swizzled<L::kRowBytes>(row, c));
      }
    }
    if (probe & kProbeNoPrefetch) {
      __syncwarp();
      if (lane == 0) mbarrier_arrive(done);
    }
  }
}

template <int HD, int NKT>
cudaError_t launch_first(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int N,
                         int Din, int H, int n_valid, float scale_c, int softmax_f32,
                         cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, NKT, false>();
  cudaError_t err = cudaFuncSetAttribute(qkvproj_attention_first_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qkvproj_attention_first_kernel<HD, NKT><<<dim3(H, B), 32 * kBwdWarps, smem, stream>>>(
      x, w, bias, out, N, Din, H, n_valid, scale_c, softmax_f32);
  return cudaGetLastError();
}

template <int HD, int NKT>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int N,
                   int Din, int H, int n_valid, float scale_c, int softmax_f32, int probe,
                   cudaStream_t stream) {
  if (probe & kProbeFirstDesign)
    return launch_first<HD, NKT>(x, w, bias, out, B, N, Din, H, n_valid, scale_c, softmax_f32,
                                 stream);
  using L = Layout<HD, NKT>;
  CUtensorMap map_x, map_w;
  cudaError_t err = make_tensor_map_stack(&map_x, x, B, N, Din, L::kKeys, kStep);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_sw128(&map_w, w, Din, 3 * H * HD, kStep);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(qkvproj_attention_kernel<HD, NKT>, L::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int units = B * ((H + L::kHeads - 1) / L::kHeads);
  const int blocks = units < sms ? units : sms;  // persistent: one block an SM at most
  qkvproj_attention_kernel<HD, NKT><<<blocks, kThreads, L::kSmemBytes, stream>>>(
      map_x, map_w, bias, out, B, N, Din, H, n_valid, scale_c, softmax_f32, probe);
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
                     int probe, cudaStream_t stream) {
#define SSL4POLYP_FWD(HD, NKT) \
  launch<HD, NKT>(x, w, bias, out, B, N, Din, H, n_valid, scale_c, softmax_f32, probe, stream)
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

// out (C, R) = in^T for a row-major (R, C) bf16 matrix, through 32 x 32
// tiles in shared memory (grid: C / 32 by R / 32, rounded up).
__global__ void __launch_bounds__(256)
weight_transpose_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, int R, int C) {
  __shared__ bf16 tile[32][33];
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  for (int y = threadIdx.x / 32; y < 32; y += 8) {
    const int r = blockIdx.y * 32 + y;
    if (r < R && c < C) tile[y][lane] = in[static_cast<long>(r) * C + c];
  }
  __syncthreads();
  const int r = blockIdx.y * 32 + lane;
  for (int y = threadIdx.x / 32; y < 32; y += 8) {
    const int cc = blockIdx.x * 32 + y;
    if (cc < C && r < R) out[static_cast<long>(cc) * R + r] = tile[lane][y];
  }
}

// The first design's backward, the launches of `steps` (kStep* bits).
cudaError_t first_design_bwd(const bf16* x, const bf16* w, const bf16* bias, const bf16* dout,
                             bf16* dqkv, float* db_part, float* db, bf16* dx, float* dw_part,
                             float* dw, int B, int N, int Din, int H, int head_dim, int n_valid,
                             float scale_c, float scale, int softmax_f32, int steps,
                             cudaStream_t st) {
  const int three_d = 3 * H * head_dim;
  const int M = B * N;
  cudaError_t err = cudaSuccess;
  if (steps & kStepAttention) {
    err = dispatch_bwd(x, w, bias, dout, dqkv, db_part, B, N, Din, H, head_dim, n_valid, scale_c,
                       scale, softmax_f32, st);
    if (err != cudaSuccess) return err;
  }
  if (steps & kStepDbSum) {
    err = launch_column_sum(db_part, B, three_d, db, st);
    if (err != cudaSuccess) return err;
  }
  if (steps & kStepDx) {
    const int rc = ssl4polyp_matmul_nt(dqkv, w, dx, M, three_d, Din, st);
    if (rc != 0) return static_cast<cudaError_t>(rc);
  }
  const int parts = (steps & kStepDw ? 1 : 0) | (steps & kStepDwSum ? 2 : 0);
  if (parts)
    err = launch_transposed_product(x, Din, dqkv, three_d, dw_part, dw, M, Din, three_d,
                                    kFirstDesignDwSlices, parts, st);
  return err;
}

// Runs f(p), p[i] a buffer of bytes[i] from the stream's memory pool (null
// where bytes[i] is 0), for the entry points whose caller hands over no
// scratch, then frees them.  Returns f's error, else the first failing
// allocation's or release's.
template <int K, typename F>
int with_pool_scratch(const size_t (&bytes)[K], cudaStream_t st, F f) {
  void* p[K] = {};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < K && err == cudaSuccess; ++i)
    if (bytes[i] != 0) err = cudaMallocAsync(&p[i], bytes[i], st);
  int rc = err != cudaSuccess ? static_cast<int>(err) : f(p);
  for (int i = K - 1; i >= 0; --i) {
    if (p[i] == nullptr) continue;
    const cudaError_t freed = cudaFreeAsync(p[i], st);
    if (rc == 0 && freed != cudaSuccess) rc = static_cast<int>(freed);
  }
  return rc;
}

}  // namespace

// x: (B, N, Din) bf16; w: (Din, 3*H*hd) bf16, columns [q heads | k heads | v
// heads]; bias: (3*H*hd,) bf16; out: (B, N, H*hd) bf16; all contiguous and
// 16-byte aligned.  Din a multiple of 64, hd 32 or 64.  scale_c is
// 1/sqrt(hd) as bf16 holds it.  `probe` (0 on every path) is a measurement
// aid: the kProbe* bits above.  Past kTilesPast tokens three launches, with
// no probe bits: w_t, a (3D, Din) bf16 scratch, receives W^T, qkv, a (B, N,
// 3D) bf16 scratch, round_bf16(x . W) from the bare GEMM, and the key tiles'
// attention forward with b as its bias writes out; up to kTilesPast both
// scratches are unused (null).  Returns the CUDA error of the tensor maps or
// the first failing launch.
extern "C" int ssl4polyp_qkvproj_attention_fwd_probe(const void* x, const void* w,
                                                     const void* bias, void* w_t, void* qkv,
                                                     void* out, int B, int N, int Din, int H,
                                                     int head_dim, int n_valid, float scale_c,
                                                     int softmax_f32, int probe, void* stream) {
  if (B < 1 || Din % kBK != 0 || (probe & ~kProbeBits))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > kTilesPast) {
    const int three_d = 3 * H * head_dim;
    if (probe != 0 || H < 1 || Din < kBK || w_t == nullptr || qkv == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    weight_transpose_kernel<<<dim3((three_d + 31) / 32, (Din + 31) / 32), 256, 0, st>>>(
        static_cast<const bf16*>(w), static_cast<bf16*>(w_t), Din, three_d);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc == 0) rc = ssl4polyp_matmul_nt(x, w_t, qkv, B * N, Din, three_d, stream);
    if (rc != 0) return rc;
    return ssl4polyp_qkv_attention_fwd(qkv, bias, out, B, N, H, head_dim, n_valid, scale_c,
                                       softmax_f32, stream);
  }
  return static_cast<int>(dispatch(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                   static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, N,
                                   Din, H, head_dim, n_valid, scale_c, softmax_f32, probe, st));
}

// ssl4polyp_qkvproj_attention_fwd_probe with probe 0, past kTilesPast tokens
// its two scratches taken from the stream's memory pool.
extern "C" int ssl4polyp_qkvproj_attention_fwd(const void* x, const void* w, const void* bias,
                                               void* out, int B, int N, int Din, int H,
                                               int head_dim, int n_valid, float scale_c,
                                               int softmax_f32, void* stream) {
  const bool tiles = N > kTilesPast && B > 0 && Din > 0 && H > 0 && head_dim > 0;
  const size_t three_d = tiles ? 3 * static_cast<size_t>(H) * head_dim : 0;
  const size_t bytes[2] = {three_d * Din * sizeof(bf16),
                           static_cast<size_t>(B) * N * three_d * sizeof(bf16)};
  return with_pool_scratch(bytes, static_cast<cudaStream_t>(stream), [&](void* const* p) {
    return ssl4polyp_qkvproj_attention_fwd_probe(x, w, bias, p[0], p[1], out, B, N, Din, H,
                                                 head_dim, n_valid, scale_c, softmax_f32, 0,
                                                 stream);
  });
}

// The backward of ssl4polyp_qkvproj_attention_fwd for the output gradient
// dout (B, N, H*hd) bf16.  Scratch: w_t (3D, Din) bf16, qkv and dqkv (B, N,
// 3D) bf16, db_part (B, 3D) fp32, dw_part (slices, Din, 3D) fp32 (the count
// ssl4polyp_dw_product_slices gives; kFirstDesignDwSlices for the first
// design); past kTilesPast tokens stats (B, H, N) float4 and dq_acc (B, H,
// N, hd) fp32, the key tiles' backward's (null up to them).  Results: dx (B,
// N, Din) bf16, dw (Din, 3D) fp32, db (3D,) fp32.  scale is the fp32
// 1/sqrt(hd).  `probe` (0 on every path) is a measurement aid: the kBwdProbe*
// and kStep* bits above.  Any N >= 1: past kTilesPast tokens the attention
// step runs the key tiles' backward in mode 1, which leaves the (B, 3D)
// dbias partial rows for the column sum, and the first design, which takes
// at most kTilesPast, is refused.  Returns the first failing launch's CUDA
// error.
extern "C" int ssl4polyp_qkvproj_attention_bwd_probe(
    const void* x, const void* w, const void* bias, const void* dout, void* w_t, void* qkv,
    void* dqkv, void* db_part, void* db, void* dx, void* dw_part, void* dw, void* stats,
    void* dq_acc, int B, int N, int Din, int H, int head_dim, int n_valid, float scale_c,
    float scale, int softmax_f32, int slices, int probe, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int three_d = 3 * H * head_dim;
  const int M = B * N;
  const bool tiles = N > kTilesPast;
  const int steps = probe & kSteps ? probe & kSteps : kSteps;
  if (B < 1 || N < 1 || Din % kBK != 0 || (probe & ~kBwdProbeBits) ||
      (tiles && (probe & kBwdProbeFirstDesign)) ||
      (tiles && (steps & kStepAttention) && (stats == nullptr || dq_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (probe & kBwdProbeFirstDesign)
    return static_cast<int>(first_design_bwd(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), static_cast<float*>(db_part),
        static_cast<float*>(db), static_cast<bf16*>(dx), static_cast<float*>(dw_part),
        static_cast<float*>(dw), B, N, Din, H, head_dim, n_valid, scale_c, scale, softmax_f32,
        steps, st));
  int rc = 0;
  if (steps & kStepTranspose) {
    weight_transpose_kernel<<<dim3((three_d + 31) / 32, (Din + 31) / 32), 256, 0, st>>>(
        static_cast<const bf16*>(w), static_cast<bf16*>(w_t), Din, three_d);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (steps & kStepProjection) {
    rc = ssl4polyp_matmul_nt(x, w_t, qkv, M, Din, three_d, stream);
    if (rc != 0) return rc;
  }
  if (steps & kStepAttention) {
    rc = tiles ? ssl4polyp_qkv_attention_tiles_bwd(qkv, bias, dout, dqkv, stats, dq_acc, db_part,
                                                 nullptr, B, N, H, head_dim, n_valid, scale_c,
                                                 scale, softmax_f32, kBwdFoldScaledDs, stream)
             : ssl4polyp_qkv_attention_bwd_mode(qkv, bias, dout, dqkv, db_part, nullptr, B, N, H,
                                                head_dim, n_valid, scale_c, scale, softmax_f32,
                                                kBwdFoldScaledDs, 0, stream);
    if (rc != 0) return rc;
  }
  if (steps & kStepDbSum) {
    rc = static_cast<int>(
        launch_column_sum(static_cast<const float*>(db_part), B, three_d, static_cast<float*>(db), st));
    if (rc != 0) return rc;
  }
  if (steps & kStepDx) {
    rc = ssl4polyp_matmul_nt(dqkv, w, dx, M, three_d, Din, stream);
    if (rc != 0) return rc;
  }
  const int parts = (steps & kStepDw ? 1 : 0) | (steps & kStepDwSum ? 2 : 0);
  if (parts) rc = ssl4polyp_dw_product(x, dqkv, dw_part, dw, M, Din, three_d, slices, parts, stream);
  return rc;
}

// ssl4polyp_qkvproj_attention_bwd_probe with probe 0, its bf16 scratches
// (and past kTilesPast tokens the key tiles') taken from the stream's memory
// pool; dw_part holds `slices` slices.
extern "C" int ssl4polyp_qkvproj_attention_bwd(const void* x, const void* w, const void* bias,
                                               const void* dout, void* dqkv, void* db_part,
                                               void* db, void* dx, void* dw_part, void* dw, int B,
                                               int N, int Din, int H, int head_dim, int n_valid,
                                               float scale_c, float scale, int softmax_f32,
                                               int slices, void* stream) {
  const size_t three_d = 3 * static_cast<size_t>(H) * head_dim;
  const size_t rows = static_cast<size_t>(B > 0 ? B : 1) * (N > 0 ? N : 1);
  const bool tiles = N > kTilesPast && B > 0 && H > 0 && head_dim > 0;
  const size_t bytes[4] = {three_d * (Din > 0 ? Din : 1) * sizeof(bf16),
                           rows * three_d * sizeof(bf16),
                           tiles ? rows * H * 4 * sizeof(float) : 0,
                           tiles ? rows * H * head_dim * sizeof(float) : 0};
  return with_pool_scratch(bytes, static_cast<cudaStream_t>(stream), [&](void* const* p) {
    return ssl4polyp_qkvproj_attention_bwd_probe(x, w, bias, dout, p[0], p[1], dqkv, db_part, db,
                                                 dx, dw_part, dw, p[2], p[3], B, N, Din, H,
                                                 head_dim, n_valid, scale_c, scale, softmax_f32,
                                                 slices, 0, stream);
  });
}
