// Attention with the output projection folded in, forward and backward:
//   y = bf16(bf16(attention_core(qkv)) . W^T) + b.
//
// Replaces: ssl4polyp_tpu/ops/attn_proj.py::_fwd_kernel and _bwd_kernel
// (fused_attention_proj).  W is torch's (out, in) layout, so both operands
// of the forward product are contiguous along the reduction.
//
// What bounds it on the H100: at the fine-tune shape (B 64, N 197, 12 heads
// of 64, D 768) the forward is 22.5 GFLOP (7.6 in the attention core, 14.9
// in the projection) against 79 MB of compulsory traffic (QKV in, y out, W
// once), some 285 FLOP per byte: at the data sheet's ridge, so neither side
// is free.  What the fold saves is the core output's round trip through HBM
// (2 x 19 MB) and a launch.
//
// Forward design.  The TPU program holds whole images in VMEM; one image's
// core output (197 x 768 bf16, 302 KB) does not fit an SM, so:
//   * A block owns (image, up to 8 query tiles of 16 rows): as many tiles as
//     its shared memory holds beside one head's K and V, the image's tiles
//     split evenly over its blocks (13 tiles at N 197: 7 + 6, two blocks an
//     image, 128 blocks for a batch of 64: one wave on 132 SMs, every block
//     with real rows).  K and V of a head are staged twice an image, W is
//     read from L2 once a block.
//   * 8 consumer warps and one producer warp.  In the attention phase consumer
//     warp w owns query tile w, all heads.  The block's Q rows (rows x D, all
//     heads) are copied once, by cp.async, into the O tile itself: head h's Q
//     columns lie exactly where the warp will write head h's output, so Q
//     costs no shared memory of its own.
//   * The O tile is laid out as the projection's A operand: D / 64 panels of
//     (rows x 64) bf16 with 128-byte rows under the 128-byte swizzle (chunk c
//     of row r at chunk c ^ (r % 8)).  The Q copies, the Q ldmatrix loads and
//     the O stores all use that address map; none has a bank conflict.
//   * K and V have one buffer each, padded as attention_core.cuh wants them,
//     and their copies run ahead: K of head h + 1 is copied while the warps
//     multiply the weights of head h with V, V of head h + 1 while they form
//     the scores of head h + 1; two block barriers a head.
//   * The projection runs on wgmma m64n128k16: A is the O tile (a descriptor
//     per panel and warpgroup: rows 0-63 and 64-127), B a ring of three
//     128 x 64 tiles of W (torch's (out, in): K-major as it lies) that the
//     producer warp fills by TMA into the space K and V have left, with full /
//     empty mbarriers as in mlp.cu.  A warpgroup hands a tile back as soon as
//     its four products are done (a ring of three is too short to keep one
//     group in flight as mlp.cu does).  A generic-to-async proxy fence orders
//     the O stores before the first wgmma.  Rows of the second warpgroup past
//     the block's tile read whatever follows in shared memory; they are never
//     stored.
//   * The epilogue rounds the fp32 sum to bf16, adds the bias in bf16 and
//     rounds again, as the TPU kernel does, and stores 16 bytes a thread
//     (quad_transpose).  O never reaches global memory.
//   The block takes 227 KB at D 768 (O tile 168 KB, K and V 58.5 KB): one
//   block of 9 warps an SM, by design.  Registers (ptxas, sm_90a): 9 warps put
//   three on one of the SM's four schedulers, which caps a thread at 168; at
//   13 key tiles that spills 80 bytes at hd 64 (40 in PREP; 36-48 at hd 32) and
//   at 16 key tiles 204-232 bytes, none below.  Eight warps with thread 0 as
//   the producer take 254 registers and spill nothing, and were slower: the
//   ring stalls on a producer that also computes (PERF.md has both times).
//   What is left: the attention phase is 8 warps an SM of mma.sync and fp32
//   softmax instructions, more than half of the kernel's time; the projection
//   drains the tensor cores once a step.  Tried and dropped, each slower or
//   level: a ring of seven 8 KB tiles (128 x 32 under the 64-byte swizzle, or
//   64 x 64 with m64n64k16), blocks starting at different column tiles of W,
//   pairs of blocks in a cluster sharing each W tile by TMA multicast.
//
// Backward design.  dW and db sum over every row of the batch, and the port
// uses no float atomics (reruns give the same bits), so the backward runs in
// phases, with the recomputed core output O and dO in global scratch:
//   1. W^T into scratch (a 32 x 32 tile transpose), then the forward's kernel
//      again (PREP): recomputes the O tile, writes it to scratch, loads the dy
//      tile in its place and forms dO = bf16(dy . W) with W^T as its K-major
//      B operand, the forward's loop unchanged;
//   2. dw_product.cu: dW[out, in] = sum over rows of dy[r, out] O[r, in] in
//      fp32, on wgmma with both operands MN-major; a unit is a 128 x 256
//      tile of dW over one of `slices` row slices and writes its partial;
//      the slices are added in order (the first design, transposed_product.cuh
//      on mma.sync, stays behind a phase bit, for timing);
//   3. dy_column_partial_kernel and column_sum_kernel: db = sum of dy in fp32,
//      64-row partials added in order;
//   4. the attention backward kernel (qkv_attention.cu) on dO, which
//      recomputes the weights itself and writes dQKV.
//
// Past 256 tokens.  The kernel above holds a head's whole K and V and every
// query tile's O panel row on chip (SSL4POLYP_FOR_TOKENS ends at 16 key
// tiles); a ViT-B/16 at 384 px has 577 tokens.  There both directions are
// compositions of the library's hand-written kernels, with O in a (B, N, D)
// bf16 scratch of device memory (75.6 MB at B 64, N 577, D 768: 0.045 ms of
// HBM traffic a round trip, against the key tiles' 0.8 ms):
//   forward: O from qkv_attention_tiles.cu's
//   forward (no bias), then y = round(round(O . W^T) + b) on mlp.cu's wgmma
//   GEMM with the bias in its epilogue (ssl4polyp_matmul_nt_bias): W is its
//   K-major (NF, K) operand as it lies;
//   backward, phase 1: W^T (the transpose above), O again from the key
//   tiles' forward into `o`, dO = round(dy . W) on the bare GEMM
//   (ssl4polyp_matmul_nt) with W^T as its (NF, K) operand; phases 2-4 as
//   above, phase 4 on the key tiles' backward (mode 0).
// The caller hands over every scratch buffer (O, the key tiles' statistics
// and dQ sums), as up to 256 tokens; the entry points route on N alone.
// The roundings are the TPU kernel's: O rounded once, the product rounded,
// the bias added in bf16 and the sum rounded again.  No atomics: a rerun
// gives the same bits.
#include "attention_core.cuh"
#include "hopper.cuh"
#include "qkv_attention_tiles.cuh"
#include "transposed_product.cuh"

// The weight gradients' product (dw_product.cu, same library).
extern "C" int ssl4polyp_dw_product(const void* a, const void* b, void* part, void* dw, int M,
                                    int I, int J, int slices, int parts, void* stream);

// The GEMM (mlp.cu) and the attention forward's entry point (qkv_attention.cu),
// which past 256 tokens run this function in two launches (same library).
extern "C" int ssl4polyp_matmul_nt(const void* x, const void* w, void* y, int M, int K, int NF,
                                   void* stream);
extern "C" int ssl4polyp_matmul_nt_bias(const void* x, const void* w, const void* bias, void* y,
                                        int M, int K, int NF, void* stream);
extern "C" int ssl4polyp_qkv_attention_fwd(const void* qkv, const void* bias, void* out, int B,
                                           int N, int H, int head_dim, int n_valid, float scale,
                                           int softmax_f32, void* stream);

// The attention backward's entry point (qkv_attention.cu, same library);
// past 256 tokens its key tiles' (qkv_attention_tiles.cuh).
extern "C" int ssl4polyp_qkv_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                           void* dqkv, void* dbias_part, void* dbias, int B,
                                           int N, int H, int head_dim, int n_valid,
                                           float scale_c, float scale, int softmax_f32,
                                           void* stream);

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kBN = 128;                   // output columns per W tile
constexpr int kBK = 64;                    // reduction depth per W tile: one O panel
constexpr int kStages = 3;
constexpr int kStageBytes = kBN * kBK * sizeof(bf16);
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kBarrierBytes = 64;          // full[3], empty[3], heads_done
constexpr int kMaxSmemBytes = 232448;      // what a block may take on sm_90
// Row slices of dW on the first design (transposed_product.cuh).
constexpr int kFirstDesignDwSlices = 4;

// K and V of a head (padded rows, attention_core.cuh), then the W ring, share
// one region.
template <int HD, int NKT>
struct ProjRegion {
  static constexpr int kKvBytes = 2 * NKT * 16 * (HD + 8) * static_cast<int>(sizeof(bf16));
  static constexpr int kBytes = kKvBytes > kRingBytes ? kKvBytes : kRingBytes;
};

// Element offset of the 16-byte chunk `chunk` (8 columns) of row `row` in an
// O tile of `rows` rows: panel chunk / 8, 128-byte rows, the 128-byte swizzle.
__device__ __forceinline__ int o_index(int row, int chunk, int rows) {
  return ((chunk >> 3) * rows + row) * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

// The consumer warps' barrier (the producer warp never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// mbarrier_wait that gives up: a fault in the barrier protocol becomes a
// launch error, not a hung card.
__device__ __forceinline__ void mbarrier_wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_address(bar);
  for (int tries = 0; tries < (1 << 24); ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// PREP false: the forward; `out` receives y.  PREP true: the backward's
// first phase; `o_out` receives the recomputed core output and `out`
// dO = bf16(dy . W), with map_w over W^T; `bias` is not read.  A block owns
// `tiles` query tiles of 16 rows of image blockIdx.y, from tile blockIdx.x *
// tiles.  `ablate` (a measurement aid, 0 otherwise): bit 0 skips the attention
// arithmetic, bit 1 the wgmma.  Dynamic shared memory, 1,024-byte aligned:
// the O tile (tiles * 16 rows x D), the K / V / ring region, the barriers.
template <int HD, int NKT, bool PREP>
__global__ void __launch_bounds__(kThreads, 1)
attn_proj_kernel(const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ qkv,
                 const bf16* __restrict__ bias, const bf16* __restrict__ dy,
                 bf16* __restrict__ o_out, bf16* __restrict__ out, int N, int H, int n_valid,
                 float scale, int softmax_f32, int tiles, int ablate) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  constexpr int kHeadChunks = HD / 8;
  const int D = H * HD;
  const int R = tiles * 16;
  extern __shared__ __align__(1024) unsigned char proj_smem[];
  bf16* s_o = reinterpret_cast<bf16*>(proj_smem);
  unsigned char* region = proj_smem + static_cast<size_t>(R) * D * sizeof(bf16);
  bf16* s_k = reinterpret_cast<bf16*>(region);
  bf16* s_v = s_k + kPad * kLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(region + ProjRegion<HD, NKT>::kBytes);
  uint64_t* empty = full + kStages;
  uint64_t* heads_done = empty + kStages;

  if (threadIdx.x == 0) {
    if (smem_address(proj_smem) & 1023u) __trap();  // the swizzle is keyed on address bits
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&empty[s], kConsumerWarps);
    }
    mbarrier_init(heads_done, kConsumerWarps);
    mbarrier_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int KT = D / kBK;  // reduction steps: the O tile's panels
  const int NT = D / kBN;

  // The roles part here and never meet again: no block-wide barrier below.
  if (warp == kConsumerWarps) {
    if (lane != 0) return;
    mbarrier_wait_or_trap(heads_done, 0);  // every warp is done with K and V
    int stage = 0;
    uint32_t parity = 1;  // a fresh "empty" barrier lets the first pass through
    for (int nt = 0; nt < NT; ++nt) {
      for (int ks = 0; ks < KT; ++ks) {
        mbarrier_wait_or_trap(&empty[stage], parity);
        mbarrier_arrive_expect_tx(&full[stage], kStageBytes);
        tma_load_2d(region + stage * kStageBytes, &map_w, &full[stage], ks * kBK, nt * kBN);
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;  // 0 .. kConsumers - 1
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int rows = min(R, N - q0);  // rows of the tile that exist
  const int r0 = warp * 16;
  const bool has = r0 < rows && !(ablate & 1);  // else the warp has no query tile
  const long ld = 3L * D;
  const bf16* base = qkv + static_cast<long>(b) * N * ld;
  const int chunks = D / 8;

  // Rows q0 .. of `src` (row stride src_ld, D columns) into the O tile.
  auto copy_tile = [&](const bf16* src, long src_ld) {
    for (int i = tid; i < R * chunks; i += kConsumers) {
      const int r = i / chunks;
      const int c = i % chunks;
      const bool ok = r < rows;
      cp_async_16(s_o + o_index(r, c, R), ok ? src + (q0 + r) * src_ld + c * 8 : src, ok ? 16 : 0);
    }
  };

  // The bias is in qkv already, so K and V are plain copies, and the scale
  // folds into q as its fragments load.
  stage_rows_async<HD>(s_k, kPad, base + D, 0, N, ld, tid, kConsumers);
  copy_tile(base, ld);
  cp_async_commit();
  cp_async_wait<0>();
  consumer_sync();  // Q and K of head 0 are in
  stage_rows_async<HD>(s_v, kPad, base + 2 * D, 0, N, ld, tid, kConsumers);
  cp_async_commit();

  for (int h = 0; h < H; ++h) {
    float s[2 * NKT][4];
    float inv0 = 0.0f, inv1 = 0.0f;
    if (has) {
      uint32_t qa[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldmatrix_x4(qa[kk], s_o + o_index(r0 + lane % 16, h * kHeadChunks + kk * 2 + lane / 16, R));
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], scale);
      }
      attention_scores<HD, NKT, false>(qa, s_k, lane, n_valid, softmax_f32, 1.0f, s, inv0, inv1);
    }
    cp_async_wait<0>();
    consumer_sync();  // V of this head is in; every warp is done with its K
    if (h + 1 < H) stage_rows_async<HD>(s_k, kPad, base + D + (h + 1) * HD, 0, N, ld, tid, kConsumers);
    cp_async_commit();
    if (has) {
      float o[HD / 8][4];
      attention_values<HD, NKT>(s, inv0, inv1, s_v, lane, o);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {  // over the head's Q columns, which are in registers
        const int chunk = h * kHeadChunks + n;
        *reinterpret_cast<uint32_t*>(s_o + o_index(r0 + g, chunk, R) + 2 * t) =
            pack_floats(o[n][0], o[n][1]);
        *reinterpret_cast<uint32_t*>(s_o + o_index(r0 + g + 8, chunk, R) + 2 * t) =
            pack_floats(o[n][2], o[n][3]);
      }
    }
    cp_async_wait<0>();
    if (h + 1 == H) break;
    consumer_sync();  // K of the next head is in; every warp is done with this V
    stage_rows_async<HD>(s_v, kPad, base + 2 * D + (h + 1) * HD, 0, N, ld, tid, kConsumers);
    cp_async_commit();
  }
  __syncwarp();
  if (lane == 0) mbarrier_arrive(heads_done);  // the region is the producer's
  fence_proxy_async_shared();
  consumer_sync();  // the O tile is whole

  if (PREP) {
    for (int i = tid; i < rows * chunks; i += kConsumers) {
      const int r = i / chunks;
      const int c = i % chunks;
      *reinterpret_cast<uint4*>(o_out + (static_cast<long>(b) * N + q0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(s_o + o_index(r, c, R));
    }
    consumer_sync();
    copy_tile(dy + static_cast<long>(b) * N * D, D);  // the dy tile takes the O tile's place
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async_shared();
    consumer_sync();
  }

  // The projection: (rows x D) . (D x D).  Warpgroup wg owns rows 64 wg ..;
  // both take every W tile.
  const int wg = warp / 4;
  const bool wg_has = wg * 64 < rows && !(ablate & 2);
  const int row_lo = wg * 64 + (warp % 4) * 16 + g;  // of the tile
  const int row_hi = row_lo + 8;
  bf16* out_lo = out + (static_cast<long>(b) * N + q0 + row_lo) * D;
  bf16* out_hi = out_lo + 8L * D;
  int stage = 0;
  uint32_t parity = 0;
  for (int nt = 0; nt < NT; ++nt) {
    // acc[4 j + e]: column tile j of 8; e = 0, 1 row g, e = 2, 3 row g + 8
    // of this warp's 16 rows; columns 2t, 2t + 1 of the tile.
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < KT; ++ks) {
      mbarrier_wait_or_trap(&full[stage], parity);
      if (wg_has) {
        const uint64_t desc_a = wgmma_descriptor_sw128(s_o + (ks * R + wg * 64) * 64);
        const uint64_t desc_b = wgmma_descriptor_sw128(region + stage * kStageBytes);
        wgmma_pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 16 along K is 32 bytes: 2 descriptor units
          wgmma_m64n128k16(acc, desc_a + 2 * kk, desc_b + 2 * kk, 1);
        wgmma_commit();
        // With three stages the tile goes back as soon as its products are
        // done, so that two loads stay in flight; the other warpgroup's
        // products fill the tensor cores meanwhile.
        wgmma_wait<0>();
      }
      if (lane == 0) mbarrier_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    if (!wg_has) continue;
    wgmma_pin(acc);
#pragma unroll
    for (int jg = 0; jg < kBN / 32; ++jg) {  // four column tiles: 32 columns
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = jg * 4 + i;
        float v00 = acc[4 * j], v01 = acc[4 * j + 1], v10 = acc[4 * j + 2], v11 = acc[4 * j + 3];
        if (!PREP) {  // the product rounded to bf16, then the bias added in bf16
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + nt * kBN + j * 8 + 2 * t));
          v00 = round_bf16(v00) + bb.x;
          v01 = round_bf16(v01) + bb.y;
          v10 = round_bf16(v10) + bb.x;
          v11 = round_bf16(v11) + bb.y;
        }
        lo[i] = pack_floats(v00, v01);
        hi[i] = pack_floats(v10, v11);
      }
      // Lane t now takes column tile t of the four: 8 contiguous columns.
      quad_transpose(lo, t);
      quad_transpose(hi, t);
      const int col = nt * kBN + jg * 32 + 8 * t;
      if (row_lo < rows) *reinterpret_cast<uint4*>(out_lo + col) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      if (row_hi < rows) *reinterpret_cast<uint4*>(out_hi + col) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// How an image's query tiles split over blocks: as many tiles a block as its
// shared memory holds (8 at most: one a consumer warp), the tiles spread
// evenly over the fewest blocks.
struct ProjPlan {
  int tiles;   // query tiles of 16 rows a block
  int blocks;  // blocks an image
  size_t smem;
};

template <int HD, int NKT>
ProjPlan proj_plan(int N, int D) {
  const int fixed = ProjRegion<HD, NKT>::kBytes + kBarrierBytes;
  const int tile_bytes = 16 * D * static_cast<int>(sizeof(bf16));
  int cap = (kMaxSmemBytes - fixed) / tile_bytes;
  if (cap > kConsumerWarps) cap = kConsumerWarps;
  if (cap < 1) return {0, 0, 0};
  const int n_tiles = (N + 15) / 16;
  const int blocks = (n_tiles + cap - 1) / cap;
  const int tiles = (n_tiles + blocks - 1) / blocks;
  return {tiles, blocks, static_cast<size_t>(tiles) * tile_bytes + fixed};
}

// `w` is the B operand as (n, k) rows: W for the forward, W^T for PREP.
template <int HD, int NKT, bool PREP>
cudaError_t launch_proj(const bf16* qkv, const bf16* w, const bf16* bias, const bf16* dy,
                        bf16* o_out, bf16* out, int B, int N, int H, int n_valid, float scale,
                        int softmax_f32, int ablate, cudaStream_t stream) {
  const int D = H * HD;
  const ProjPlan plan = proj_plan<HD, NKT>(N, D);
  if (plan.tiles < 1) return cudaErrorInvalidValue;
  CUtensorMap map_w;
  cudaError_t err = make_tensor_map_sw128(&map_w, w, D, D, kBN);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(attn_proj_kernel<HD, NKT, PREP>, kMaxSmemBytes, configured);
  if (err != cudaSuccess) return err;
  attn_proj_kernel<HD, NKT, PREP><<<dim3(plan.blocks, B), kThreads, plan.smem, stream>>>(
      map_w, qkv, bias, dy, o_out, out, N, H, n_valid, scale, softmax_f32, plan.tiles, ablate);
  return cudaGetLastError();
}

template <bool PREP>
cudaError_t dispatch_proj(const bf16* qkv, const bf16* w, const bf16* bias, const bf16* dy,
                          bf16* o_out, bf16* out, int B, int N, int H, int head_dim, int n_valid,
                          float scale, int softmax_f32, int ablate, cudaStream_t stream) {
  if ((H * head_dim) % kBN != 0) return cudaErrorInvalidValue;
#define SSL4POLYP_PROJ(HD, NKT)                                                              \
  launch_proj<HD, NKT, PREP>(qkv, w, bias, dy, o_out, out, B, N, H, n_valid, scale, softmax_f32, \
                             ablate, stream)
  switch (head_dim) {
    case 32: SSL4POLYP_FOR_TOKENS(SSL4POLYP_PROJ, 32)
    case 64: SSL4POLYP_FOR_TOKENS(SSL4POLYP_PROJ, 64)
    default: return cudaErrorInvalidValue;
  }
#undef SSL4POLYP_PROJ
}

// out (D, D) = w^T, through 32 x 32 tiles in shared memory.
__global__ void __launch_bounds__(256)
attn_proj_transpose_kernel(const bf16* __restrict__ w, bf16* __restrict__ out, int D) {
  __shared__ bf16 tile[32][33];
  const int x = threadIdx.x % 32;
  const int y0 = threadIdx.x / 32;
  for (int y = y0; y < 32; y += 8)
    tile[y][x] = w[static_cast<long>(blockIdx.y * 32 + y) * D + blockIdx.x * 32 + x];
  __syncthreads();
  for (int y = y0; y < 32; y += 8)
    out[static_cast<long>(blockIdx.x * 32 + y) * D + blockIdx.y * 32 + x] = tile[x][y];
}

// part[block][c] = sum of dy[r][c] over the block's 64 rows, in row order.
constexpr int kDbRows = 64;

__global__ void __launch_bounds__(256)
dy_column_partial_kernel(const bf16* __restrict__ dy, int M, int D, float* __restrict__ part) {
  const int r0 = blockIdx.x * kDbRows;
  const int r1 = min(M, r0 + kDbRows);
  for (int c = 2 * threadIdx.x; c < D; c += 2 * blockDim.x) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dy + static_cast<long>(r) * D + c));
      s0 += v.x;
      s1 += v.y;
    }
    part[static_cast<long>(blockIdx.x) * D + c] = s0;
    part[static_cast<long>(blockIdx.x) * D + c + 1] = s1;
  }
}

}  // namespace

// qkv: (B, N, 3*H*hd) bf16, [q heads | k heads | v heads], its bias already
// added; w: (D, D) bf16 as (out, in); bias: (D,) bf16; out: (B, N, D) bf16,
// D = H*hd a multiple of 128, hd 32 or 64; o: (B, N, D) bf16 scratch, read
// only past kTilesPast tokens (null up to them).  scale is 1/sqrt(hd) as
// bf16 holds it.  `ablate` is 0; a caller that wants to know where the time
// goes passes 1 (no scores, softmax or weights . V: the copies and barriers
// of the head loop stay), 2 (no wgmma: the W ring and the epilogue stay) or
// 3, and gets a wrong `out` whose time it may read.  Past kTilesPast tokens
// the key tiles' attention forward writes the core output into `o`, then the
// GEMM forms y = round(round(o . w^T) + bias) into `out`; no ablate bits
// there.  Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_attn_proj_fwd(const void* qkv, const void* w, const void* bias, void* o,
                                       void* out, int B, int N, int H, int head_dim, int n_valid,
                                       float scale, int softmax_f32, int ablate, void* stream) {
  if (N > kTilesPast) {
    const int D = H * head_dim;
    if (ablate != 0 || B < 1 || H < 1 || D % kBN != 0 || o == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc = ssl4polyp_qkv_attention_fwd(qkv, nullptr, o, B, N, H, head_dim, n_valid,
                                               scale, softmax_f32, stream);
    return rc != 0 ? rc : ssl4polyp_matmul_nt_bias(o, w, bias, out, B * N, D, D, stream);
  }
  return static_cast<int>(dispatch_proj<false>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      nullptr, nullptr, static_cast<bf16*>(out), B, N, H, head_dim, n_valid, scale, softmax_f32,
      ablate, static_cast<cudaStream_t>(stream)));
}

// The backward of ssl4polyp_attn_proj_fwd for the output gradient dy
// (B, N, D) bf16.  Scratch: w_t (D, D) bf16, o and d_o (B, N, D) bf16,
// dw_part (max(slices, 4), D, D) fp32 (slices: ssl4polyp_dw_product_slices),
// db_part (ceil(B*N / 64), D) fp32; past kTilesPast tokens stats (B, H, N)
// float4 and dq_acc (B, H, N, hd) fp32, the key tiles' backward's (null up
// to them).  Results: dqkv
// (B, N, 3D) bf16, dw (D, D) fp32 as (out, in), db (D,) fp32.  scale_c is
// 1/sqrt(hd) as bf16 holds it, scale the fp32 value.  `phases` is a mask of
// the phases to run, 15 for the whole backward: 1 the transpose and the
// PREP kernel (w_t, o, d_o; past 256 tokens the key tiles' forward into o
// and the GEMM for d_o), 2 dw, 4 db, 8 the attention backward (dqkv, from
// d_o; past 256 tokens the key tiles'); and 16, for timing, dw on the first
// design; a caller that times one phase runs the earlier ones first.
// Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_attn_proj_bwd(const void* qkv, const void* w, const void* dy, void* w_t,
                                       void* o, void* d_o, void* dqkv, void* dw_part, void* dw,
                                       void* db_part, void* db, void* stats, void* dq_acc, int B,
                                       int N, int H, int head_dim, int n_valid, float scale_c,
                                       float scale, int softmax_f32, int slices, int phases,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * head_dim;
  const int M = B * N;
  const bool tiles = N > kTilesPast;
  if (tiles && (phases & 8) && (stats == nullptr || dq_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    if (D % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
    attn_proj_transpose_kernel<<<dim3(D / 32, D / 32), 256, 0, st>>>(static_cast<const bf16*>(w),
                                                           static_cast<bf16*>(w_t), D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tiles) {
      int rc = ssl4polyp_qkv_attention_fwd(qkv, nullptr, o, B, N, H, head_dim, n_valid, scale_c,
                                           softmax_f32, stream);
      if (rc == 0) rc = ssl4polyp_matmul_nt(dy, w_t, d_o, M, D, D, stream);
      if (rc != 0) return rc;
    } else {
      err = dispatch_proj<true>(
          static_cast<const bf16*>(qkv), static_cast<const bf16*>(w_t), nullptr,
          static_cast<const bf16*>(dy), static_cast<bf16*>(o), static_cast<bf16*>(d_o), B, N, H,
          head_dim, n_valid, scale_c, softmax_f32, 0, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (phases & 2) {
    const int rc = ssl4polyp_dw_product(dy, o, dw_part, dw, M, D, D, slices, 3, stream);
    if (rc != 0) return rc;
  }
  if (phases & 16) {
    err = launch_transposed_product(static_cast<const bf16*>(dy), D, static_cast<const bf16*>(o),
                                    D, static_cast<float*>(dw_part), static_cast<float*>(dw), M,
                                    D, D, kFirstDesignDwSlices, 3, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 4) {
    const int db_blocks = (M + kDbRows - 1) / kDbRows;
    dy_column_partial_kernel<<<db_blocks, 256, 0, st>>>(static_cast<const bf16*>(dy), M, D,
                                                        static_cast<float*>(db_part));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_column_sum(static_cast<const float*>(db_part), db_blocks, D,
                            static_cast<float*>(db), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!(phases & 8)) return static_cast<int>(cudaSuccess);
  if (tiles)
    return ssl4polyp_qkv_attention_tiles_bwd(qkv, nullptr, d_o, dqkv, stats, dq_acc, nullptr,
                                             nullptr, B, N, H, head_dim, n_valid, scale_c, scale,
                                             softmax_f32, kBwdFold, stream);
  return ssl4polyp_qkv_attention_bwd(qkv, nullptr, d_o, dqkv, nullptr, nullptr, B, N, H, head_dim,
                                     n_valid, scale_c, scale, softmax_f32, stream);
}
