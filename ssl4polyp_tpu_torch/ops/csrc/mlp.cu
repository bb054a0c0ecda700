// The transformer MLP's kernels.  First, fc1 with its exact-erf GELU:
// y = gelu(x . w^T + b), and optionally h = x . w^T + b; second (below), the
// whole MLP in one kernel, fc1 + GELU + fc2, optionally behind a LayerNorm
// prologue and with the block's residual folded in.
//
// fc1+GELU replaces: ssl4polyp_tpu/ops/mlp.py::_fc1_kernel (fc1_gelu).  Like the TPU
// kernel it writes the pre-activation h, rounded once to bf16, as the
// backward's residual when the caller asks for it (a non-null h); inference
// passes null and writes y only.  The backward is plain torch, as the JAX
// package leaves it to XLA.
//
// What bounds it on the H100: at the eval path's shape (M = 64*197 = 12,608,
// K = 768, NF = 3072) the product is 59.5 GFLOP against about 102 MB of
// bf16 traffic, some 590 FLOP per byte, well above the ~295 of the H100's
// data sheet ridge: it is bound by the tensor cores, and only wgmma reaches
// their full rate.  The MAE decoder's call (K 512, NF 2,048, h written) moves
// 118 MB for 26 GFLOP, 224 FLOP per byte: bound by bytes, so what counts
// there is that h and y leave in whole sectors.
//
// The design (the first form ran mma.sync from a cp.async ring that all
// threads filled, and stored 4 bytes a thread):
//   * One block of three warpgroups, persistent: a grid of one block an SM,
//     each walking output tiles tile = blockIdx.x, + gridDim.x, ...  Tiles are
//     numbered with the column index fastest, so the tiles in flight at one
//     time share a few row panels of x and all of w, which stay in L2.
//   * Warpgroup 0 is the producer: it gives its registers back (setmaxnreg)
//     and one of its threads starts TMA loads of the x tile (128 x 64) and the
//     w tile (BN x 64) into a ring of 128-byte-swizzled stages, each stage
//     with a "full" mbarrier (the TMA bytes) and an "empty" one (one arrival
//     from each of the eight consumer warps).  Ragged M, NF and K edges are
//     TMA's out-of-bounds zeros: nothing is masked in the main loop.
//   * Warpgroups 1 and 2 are the consumers, 64 rows of the tile each: four
//     wgmma.mma_async m64nBNk16 a stage (bf16 in, fp32 accumulators in
//     registers), both operands K-major from shared memory (x row-major, w
//     in torch's (out, in) layout: no transpose anywhere), one group kept in
//     flight while the previous stage is handed back.  The producer runs
//     ahead into the next tile's stages while the consumers are in their
//     epilogue, so a tile's first loads are hidden.
//   * The epilogue adds the bias in fp32, applies 0.5*h*(1+erf(h/sqrt(2)))
//     with CUDA's erff to the fp32 h, rounds once to bf16 (and h once, when
//     asked), then transposes each group of four accumulator column tiles
//     across the four lanes of a quad with shuffles, so that every thread
//     stores 16 contiguous bytes and a quad a 64-byte piece of a row: whole
//     32-byte sectors, where the first form's 4-byte stores covered half a
//     sector an instruction.  No shared memory is spent on it, which leaves
//     the ring its depth.
//   * Tile width by shape: 128 x 256 (ring of 4, 128 accumulators a thread)
//     where its tiles fill the SMs' waves at least as well as 128 x 128's
//     (ring of 6), which takes the rest: the classifier's and the decoder's
//     calls are exactly 9 and 6 waves of 128 x 256 tiles on 132 SMs; the MAE
//     encoder's (M 3,200: 25 row tiles) and ssl4polyp_matmul_nt's dx product
//     (NF 768) fill 4.5 waves of 128 x 128 tiles against 2.3 of the wide one.
//   What is left: the tensor cores idle during a tile's epilogue, which is
//   bound by the instruction rate (128 erff a thread): with the bare epilogue of
//   ssl4polyp_matmul_nt the same loop runs level with cuBLAS, and the GELU adds
//   about 45 % to it at the classifier's shape.  Running a parked tile's
//   epilogue (a second set of 64 accumulators at BN 128) between the next
//   tile's K steps was tried and was slower than the plain order at BN 256;
//   giving each consumer warpgroup a tile of its own, half a tile apart,
//   needs a deeper ring than 227 KB holds at this tile size, or w tiles
//   multicast to a cluster.  PERF.md has the times.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;            // rows of a tile: 64 for each consumer warpgroup
constexpr int kBK = 64;             // 128 bytes of bf16: one swizzle row
constexpr int kGemmThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;

template <int BN>
struct GemmShape {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kTileA = kBM * kBK;  // elements
  static constexpr int kTileB = BN * kBK;
  static constexpr uint32_t kStageBytes = (kTileA + kTileB) * sizeof(bf16);
  // The ring, its 2 * kStages barriers, and room to align the ring to 1,024 bytes.
  static constexpr size_t kSmemBytes = kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + 1024;
};

// The GEMM's epilogues.  kEpiGelu: y = gelu(acc + bias), and h = acc + bias
// when h is not null.  kEpiBare: the bare product y = x . w^T rounded once to
// bf16 (`bias` and `h` are not read): the streaming GEMM other kernels'
// phases call through ssl4polyp_matmul_nt.  kEpiBias: y = round(round(acc) +
// bias), the product rounded before the bias is added in bf16 (the output
// projection's two roundings, ssl4polyp_tpu/ops/attn_proj.py:83), through
// ssl4polyp_matmul_nt_bias; `h` is not read.
enum Epilogue : int { kEpiBare = 0, kEpiGelu = 1, kEpiBias = 2 };

template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
fc1_gelu_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                const bf16* __restrict__ bias, bf16* __restrict__ h, bf16* __restrict__ y, int M,
                int K, int NF) {
  constexpr bool GELU = EPI == kEpiGelu;
  using Shape = GemmShape<BN>;
  constexpr int kStages = Shape::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  bf16* tiles_a = reinterpret_cast<bf16*>(smem);
  bf16* tiles_b = tiles_a + kStages * Shape::kTileA;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles_b + kStages * Shape::kTileB);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&empty[s], kConsumerWarps);
    }
    mbarrier_init_fence();
  }
  __syncthreads();

  const int tiles_n = (NF + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int ksteps = (K + kBK - 1) / kBK;

  // The roles part here and never meet again: no block-wide barrier below.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t parity = 1;  // a fresh "empty" barrier lets the first pass through
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM;
        const int n0 = (tile % tiles_n) * BN;
        for (int ks = 0; ks < ksteps; ++ks) {
          mbarrier_wait(&empty[stage], parity);
          mbarrier_arrive_expect_tx(&full[stage], Shape::kStageBytes);
          tma_load_2d(tiles_a + stage * Shape::kTileA, &map_x, &full[stage], ks * kBK, m0);
          tma_load_2d(tiles_b + stage * Shape::kTileB, &map_w, &full[stage], ks * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int group = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 * group .. + 63
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool write_h = GELU && h != nullptr;
    int stage = 0;
    uint32_t parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM;
      const int n0 = (tile % tiles_n) * BN;
      // acc[4 j + e]: column tile j of 8; e = 0, 1 row g, e = 2, 3 row g + 8
      // of this warp's 16 rows; columns 2t, 2t + 1 of the tile.
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int previous = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbarrier_wait(&full[stage], parity);
        const uint64_t desc_a =
            wgmma_descriptor_sw128(tiles_a + stage * Shape::kTileA + group * 64 * kBK);
        const uint64_t desc_b = wgmma_descriptor_sw128(tiles_b + stage * Shape::kTileB);
        wgmma_pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {  // 16 along K is 32 bytes: 2 descriptor units
          if constexpr (BN == 256) {
            wgmma_m64n256k16(acc, desc_a + 2 * kk, desc_b + 2 * kk, 1);
          } else {
            wgmma_m64n128k16(acc, desc_a + 2 * kk, desc_b + 2 * kk, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (ks > 0 && lane == 0) mbarrier_arrive(&empty[previous]);
        previous = stage;
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbarrier_arrive(&empty[previous]);
      wgmma_pin(acc);

      const int row_lo = m0 + group * 64 + warp * 16 + g;
      const int row_hi = row_lo + 8;
#pragma unroll
      for (int jg = 0; jg < BN / 32; ++jg) {  // four column tiles: 32 columns
        uint32_t y_lo[4], y_hi[4], h_lo[4], h_hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = jg * 4 + i;
          const int col = n0 + j * 8 + 2 * t;
          float h00 = acc[4 * j], h01 = acc[4 * j + 1], h10 = acc[4 * j + 2], h11 = acc[4 * j + 3];
          if constexpr (GELU) {
            float b0 = 0.0f, b1 = 0.0f;
            if (col < NF) {
              const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
              b0 = b.x;
              b1 = b.y;
            }
            h00 += b0;
            h01 += b1;
            h10 += b0;
            h11 += b1;
            h_lo[i] = pack_floats(h00, h01);
            h_hi[i] = pack_floats(h10, h11);
            y_lo[i] = pack_floats(gelu_erf(h00), gelu_erf(h01));
            y_hi[i] = pack_floats(gelu_erf(h10), gelu_erf(h11));
          } else {
            if constexpr (EPI == kEpiBias) {  // NF is a multiple of 8: the pair is in or out
              if (col < NF) {
                const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
                h00 = round_bf16(h00) + b.x;
                h01 = round_bf16(h01) + b.y;
                h10 = round_bf16(h10) + b.x;
                h11 = round_bf16(h11) + b.y;
              }
            }
            y_lo[i] = pack_floats(h00, h01);
            y_hi[i] = pack_floats(h10, h11);
          }
        }
        // Lane t now takes column tile t of the four: 8 contiguous columns.
        const int col = n0 + jg * 32 + 8 * t;
        const bool col_ok = col < NF;  // NF is a multiple of 8: a piece is in or out whole
        quad_transpose(y_lo, t);
        quad_transpose(y_hi, t);
        if (col_ok && row_lo < M)
          *reinterpret_cast<uint4*>(y + static_cast<long>(row_lo) * NF + col) =
              make_uint4(y_lo[0], y_lo[1], y_lo[2], y_lo[3]);
        if (col_ok && row_hi < M)
          *reinterpret_cast<uint4*>(y + static_cast<long>(row_hi) * NF + col) =
              make_uint4(y_hi[0], y_hi[1], y_hi[2], y_hi[3]);
        if (write_h) {
          quad_transpose(h_lo, t);
          quad_transpose(h_hi, t);
          if (col_ok && row_lo < M)
            *reinterpret_cast<uint4*>(h + static_cast<long>(row_lo) * NF + col) =
                make_uint4(h_lo[0], h_lo[1], h_lo[2], h_lo[3]);
          if (col_ok && row_hi < M)
            *reinterpret_cast<uint4*>(h + static_cast<long>(row_hi) * NF + col) =
                make_uint4(h_hi[0], h_hi[1], h_hi[2], h_hi[3]);
        }
      }
    }
  }
}

template <int BN, int EPI>
cudaError_t launch_gemm(const bf16* x, const bf16* w, const bf16* bias, bf16* h, bf16* y, int M,
                        int K, int NF, int sms, cudaStream_t stream) {
  using Shape = GemmShape<BN>;
  CUtensorMap map_x, map_w;
  cudaError_t err = make_tensor_map_sw128(&map_x, x, M, K, kBM);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_sw128(&map_w, w, NF, K, BN);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(fc1_gelu_kernel<BN, EPI>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kBM - 1) / kBM) * ((NF + BN - 1) / BN);
  const int blocks = tiles < sms ? tiles : sms;  // persistent: one block an SM at most
  fc1_gelu_kernel<BN, EPI><<<blocks, kGemmThreads, Shape::kSmemBytes, stream>>>(
      map_x, map_w, bias, h, y, M, K, NF);
  return cudaGetLastError();
}

// The wide tile where its tiles fill the SMs' waves at least as well as the
// narrow one's do (it reads x and w from shared memory half as often per
// product), the narrow one otherwise.
template <int EPI>
cudaError_t dispatch_gemm(const bf16* x, const bf16* w, const bf16* bias, bf16* h, bf16* y, int M,
                          int K, int NF, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long rows = (M + kBM - 1) / kBM;
  const long wide = rows * ((NF + 255) / 256), narrow = rows * ((NF + 127) / 128);
  const long wide_slots = (wide + sms - 1) / sms * sms, narrow_slots = (narrow + sms - 1) / sms * sms;
  // wide / wide_slots >= narrow / narrow_slots
  if (NF > 128 && wide * narrow_slots >= narrow * wide_slots)
    return launch_gemm<256, EPI>(x, w, bias, h, y, M, K, NF, sms, stream);
  return launch_gemm<128, EPI>(x, w, bias, h, y, M, K, NF, sms, stream);
}


// ---------------------------------------------------------------------------
// fc1 + GELU + fc2 in one kernel:
//   h = x . W1^T + b1 (fp32, written in bf16 when h is not null),
//   g = gelu(h) in fp32, rounded to bf16 and kept in shared memory,
//   out = sum over NF of g . W2^T in fp32, + b2, rounded once;
// with a LayerNorm prologue (ln_s not null) x is first replaced, in shared
// memory, by m = LN(x) * s + t rounded to bf16, and the epilogue adds the
// residual: out = (x + acc) + b2, in fp32, rounded once.
//
// Replaces: ssl4polyp_tpu/ops/mlp.py::_mlp_kernel (mlp_fused) and
// _mlp_ln_kernel (mlp_ln_fused).  The backwards are plain torch, as the JAX
// package leaves them to XLA.
//
// What bounds it on the H100: at the fine-tune shape (M = 64*197 = 12,608,
// K = 768, NF = 3072) the two products are 119 GFLOP, 0.120 ms at the
// tensor cores' peak; HBM traffic is 90 MB (x, h and out; W once), 0.027
// ms.  The fp32 output accumulator (rows x K) lives across the whole NF
// walk, so a block owns few rows, and every block reads all of W1 and W2
// (9.4 MB at K 768) into its shared memory.  A byte of W brought in serves
// as many FLOP as the block has rows: the first design (below, 32 rows a
// block, mma.sync) read 3.7 GB of L2 a call.  Here a block owns 64 rows,
// the most its registers hold (64 x 768 fp32 over 256 threads: 192 each),
// so it still needs 64 FLOP for every byte of W it takes in: its products
// want about 114 GB/s of W a SM at the tensor cores' peak, and a SM takes
// in about 70 GB/s (the W loads alone, without products, run at that).
//
// The design (sm_90a):
//   * A block of three warpgroups owns 64 rows of x, resident in shared
//     memory as K/64 TMA boxes of 64 x 64 under the 128-byte swizzle (the LN
//     variant normalises them in place, swizzle-aware, rounded as
//     common.cuh::layernorm_rows_in_place rounds).  Blocks on two
//     consecutive row tiles form a cluster: every W tile is read from L2
//     once and TMA-multicast to both, so one fetch serves 128 rows (0.9 GB
//     of L2 reads a call at K 768).  Each block of the cluster loads half of
//     each tile's rows for both.
//   * Warpgroup 0 is the producer: one thread walks NF in chunks of 64
//     hidden features and feeds a ring of 16 KB stages (two 64 x 64 boxes
//     each; 7 stages at K 768, 9 at K 512): a chunk's fc1 stages (W1 rows
//     of the chunk, 128 columns of K a stage), then the previous chunk's fc2
//     stages (64 W2 rows of each consumer's columns).  A stage's "empty"
//     barrier takes one arrival from each consumer warp of every block of
//     the cluster, since the producer's multicast writes into all of them.
//   * Warpgroups 1 and 2 are the consumers.  They split the output's K
//     columns (64 x 384 fp32 a warpgroup at K 768: 192 registers of the 240
//     setmaxnreg gives; 128 at K 512) and the chunk's 64 hidden features
//     (32 each).  Per chunk j each issues its fc1 half with wgmma m64n32k16
//     (x from the resident boxes, W1 from the ring), then the fc2 of chunk
//     j - 1 with wgmma m64n64k16 (g tile j - 1 against its W2 rows), and
//     while those fc2 products run it adds b1 in fp32, applies the exact-erf
//     GELU, stores h in 16-byte pieces (quad shuffles) and writes its half
//     of g as bf16 into the swizzled g tile j (two g tiles alternate).  A
//     proxy fence and a named barrier over the 256 consumer threads publish
//     g to the next chunk's fc2.  Three stages' products stay in flight;
//     each stage is handed back once the products after it are issued and
//     its own are done.
//   * Ragged edges: the grid is rounded up to whole clusters; rows past M,
//     W1 rows past NF and W2 columns past NF are TMA's out-of-bounds zeros
//     (a zero W1 row and a masked b1 give g = 0, which adds nothing), and
//     the stores of h and out are masked.
//   * No atomics: each output element is summed by one thread in an order
//     fixed by the shape, so reruns give the same bits.
//   What is left: the W intake above; the GELU's erff, which the fc2
//   products under it do not hide (about a sixth of the time at K 768); fc1's
//   m64n32 products, which read 3 KB of shared memory for 16 cycles of
//   tensor work; and 197 row tiles, which fill two waves of 132 blocks by
//   three quarters.  Clusters of 4 (256 rows a fetch) were slower: the four
//   blocks wait on each other's hand-backs.  PERF.md has the times, the
//   ablations (ssl4polyp_mlp_fused_probe) and the designs tried.
// ---------------------------------------------------------------------------

constexpr int kFusedRows = 64;       // rows of x a block owns
constexpr int kFusedChunk = 64;      // hidden features a step of the NF walk
constexpr int kFusedThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kFusedConsumers = 256;
constexpr int kFusedConsumerWarps = 8;
constexpr int kFusedCluster = 2;     // blocks sharing each W tile
constexpr uint32_t kBox = 64 * 64 * sizeof(bf16);  // one swizzled 64 x 64 box: 8 KB
constexpr uint32_t kFusedStageBytes = 2 * kBox;

// `probe` bits, a measurement aid (0 on every path; chip_smoke.py times the
// kernel with parts left out, whose results are wrong): no fc2 products, no
// fc1 epilogue (bias, GELU, h and g), no fc1 products, no W loads (the ring
// is not waited on); clusters of 4 blocks or of 1 (no multicast; right
// results); the first design (right results).
constexpr int kMlpProbeNoFc2 = 1;
constexpr int kMlpProbeNoEpilogue = 2;
constexpr int kMlpProbeNoFc1 = 4;
constexpr int kMlpProbeNoLoads = 8;
constexpr int kMlpProbeCluster4 = 16;
constexpr int kMlpProbeCluster1 = 32;
constexpr int kMlpProbeFirstDesign = 64;

template <int K>
struct FusedShape {
  static constexpr int kBoxes = K / 64;     // x boxes; W1 K-slices
  static constexpr int kSteps = K / 128;    // ring stages of a chunk's fc1, and of its fc2
  static constexpr int kStages = K == 768 ? 7 : 9;  // what 227 KB leaves beside x and two g tiles
  static constexpr size_t kSmemBytes =
      (kBoxes + 2) * kBox + kStages * kFusedStageBytes + (2 * kStages + 1) * sizeof(uint64_t) + 1024;
  static_assert(kSmemBytes <= 232448, "the block's shared memory");
};

template <int K, bool LN>
__global__ void __launch_bounds__(kFusedThreads, 1)
mlp_fused_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ x,
                 const float* __restrict__ ln_s, const float* __restrict__ ln_t,
                 const bf16* __restrict__ b1, const bf16* __restrict__ b2, bf16* __restrict__ h,
                 bf16* __restrict__ out, int M, int NF, float eps, int probe) {
  using Shape = FusedShape<K>;
  constexpr int kStages = Shape::kStages;
  constexpr int kSteps = Shape::kSteps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  unsigned char* xs = smem;                         // the block's rows: kBoxes boxes
  unsigned char* gs = xs + Shape::kBoxes * kBox;    // two g tiles
  unsigned char* ring = gs + 2 * kBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kFusedStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* x_full = empty + kStages;

  const uint32_t rank = cluster_rank();
  const uint32_t blocks = cluster_size();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&empty[s], kFusedConsumerWarps * blocks);
    }
    mbarrier_init(x_full, 1);
    mbarrier_init_fence();
  }
  cluster_sync();  // every block's barriers exist before a copy or an arrival reaches them

  const int m0 = blockIdx.x * kFusedRows;
  const int chunks = (NF + kFusedChunk - 1) / kFusedChunk;

  // The roles part here and never meet again: no block-wide barrier below.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbarrier_arrive_expect_tx(x_full, Shape::kBoxes * kBox);
      for (int b = 0; b < Shape::kBoxes; ++b) tma_load_2d(xs + b * kBox, &map_x, x_full, b * 64, m0);
      // This block loads rows [rank * part, + part) of every box of a stage
      // for the whole cluster.
      const int part = kFusedRows / blocks;
      const uint16_t mask = static_cast<uint16_t>((1u << blocks) - 1);
      int stage = 0;
      uint32_t parity = 1;  // a fresh "empty" barrier lets the first pass through
      for (int j = 0; j <= chunks && !(probe & kMlpProbeNoLoads); ++j) {
        for (int half = 0; half < 2; ++half) {  // fc1 of chunk j, then fc2 of chunk j - 1
          if (half == 0 ? j == chunks : j == 0) continue;
          for (int i = 0; i < kSteps; ++i) {
            mbarrier_wait(&empty[stage], parity);
            mbarrier_arrive_expect_tx(&full[stage], kFusedStageBytes);
            for (int p = 0; p < 2; ++p) {
              unsigned char* dst = ring + stage * kFusedStageBytes + p * kBox + rank * part * 128;
              const CUtensorMap* map = half == 0 ? &map_w1 : &map_w2;
              // W1 (NF, K): rows of chunk j, K columns 128 i + 64 p ..;
              // W2 (K, NF): rows p * K/2 + 64 i .., NF columns of chunk j - 1.
              const int c0 = half == 0 ? (2 * i + p) * 64 : (j - 1) * kFusedChunk;
              const int c1 = (half == 0 ? j * kFusedChunk : p * (K / 2) + i * 64) + rank * part;
              if (blocks == 1) {
                tma_load_2d(dst, map, &full[stage], c0, c1);
              } else {
                tma_load_2d_multicast(dst, map, &full[stage], c0, c1, mask);
              }
            }
            if (++stage == kStages) {
              stage = 0;
              parity ^= 1;
            }
          }
        }
      }
      // Every block of the cluster hands every stage back before this block
      // exits: no arrival reaches its barriers after that.
      for (int s = 0; s < kStages && !(probe & kMlpProbeNoLoads); ++s) {
        mbarrier_wait(&empty[stage], parity);
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int group = threadIdx.x / 128 - 1;  // output columns group * K/2 ..; hidden 32 * group ..
    const int warp = (threadIdx.x % 128) / 32;  // rows 16 * warp .. + 15 of the tile
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool do_fc2 = !(probe & kMlpProbeNoFc2);
    const bool do_epilogue = !(probe & kMlpProbeNoEpilogue);
    const bool do_fc1 = !(probe & kMlpProbeNoFc1);
    const bool loads = !(probe & kMlpProbeNoLoads);

    mbarrier_wait(x_full, 0);
    if (LN) {  // rows w, w + 8, .. for consumer warp w; lane l the column pair 2l of every box
      const float inv_k = 1.0f / static_cast<float>(K);
      for (int r = threadIdx.x / 32 - 4; r < kFusedRows; r += kFusedConsumerWarps) {
        unsigned char* row = xs + r * 128 + ((((lane >> 2) ^ (r & 7)) << 4) | ((lane & 3) << 2));
        float sum = 0.0f;
#pragma unroll
        for (int b = 0; b < Shape::kBoxes; ++b) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + b * kBox));
          sum += v.x + v.y;
        }
        const float mean = warp_sum(sum) * inv_k;
        float sq = 0.0f;
#pragma unroll
        for (int b = 0; b < Shape::kBoxes; ++b) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + b * kBox));
          sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
        }
        const float rstd = rsqrtf(warp_sum(sq) * inv_k + eps);
#pragma unroll
        for (int b = 0; b < Shape::kBoxes; ++b) {
          const int c = 64 * b + 2 * lane;
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + b * kBox));
          const float n0 = (v.x - mean) * rstd * ln_s[c] + ln_t[c];
          const float n1 = (v.y - mean) * rstd * ln_s[c + 1] + ln_t[c + 1];
          *reinterpret_cast<uint32_t*>(row + b * kBox) = pack_floats(n0, n1);
        }
      }
      fence_proxy_async_shared();
      named_barrier_sync(1, kFusedConsumers);
    }

    // acc[i][4 jj + e]: output columns group * K/2 + 64 i + 8 jj + 2t (+1),
    // rows 16 warp + g (e = 0, 1) and + 8 (e = 2, 3).  hacc likewise for the
    // chunk's hidden features 32 group + 8 jj + 2t (+1).
    float acc[kSteps][32];
    float hacc[16] = {};
    uint32_t bias[4] = {}, h_lo[4], h_hi[4], g_lo[4], g_hi[4];
    int stage = 0;
    uint32_t parity = 0;
    auto release = [&](int s) {
      if (lane == 0 && loads)
        for (uint32_t r = 0; r < blocks; ++r) mbarrier_arrive_cluster(&empty[s], r);
    };
    // The stages whose products may still run, newest first.
    int held[3] = {-1, -1, -1};
    // After issuing a stage's products: all but the newest `depth` groups are
    // done, so the stages they read go back.
    auto retire = [&](auto depth) {
      constexpr int D = decltype(depth)::value;
      wgmma_wait<D>();
#pragma unroll
      for (int k = D - 1; k < 3; ++k) {
        if (held[k] >= 0) release(held[k]);
        held[k] = -1;
      }
#pragma unroll
      for (int k = D - 1; k > 0; --k) held[k] = held[k - 1];
      held[0] = stage;
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    };
    using One = std::integral_constant<int, 1>;
    using Three = std::integral_constant<int, 3>;
    auto gelu_tile = [&](int jj) {  // a bf16 is the top half of its fp32
      const float b_lo = __uint_as_float(bias[jj] << 16), b_hi = __uint_as_float(bias[jj] & 0xffff0000u);
      const float h00 = hacc[4 * jj] + b_lo, h01 = hacc[4 * jj + 1] + b_hi;
      const float h10 = hacc[4 * jj + 2] + b_lo, h11 = hacc[4 * jj + 3] + b_hi;
      h_lo[jj] = pack_floats(h00, h01);
      h_hi[jj] = pack_floats(h10, h11);
      g_lo[jj] = pack_floats(gelu_erf(h00), gelu_erf(h01));
      g_hi[jj] = pack_floats(gelu_erf(h10), gelu_erf(h11));
    };
    const int r_lo = 16 * warp + g;  // this thread's rows of the tile: r_lo, r_lo + 8

    for (int j = 0; j <= chunks; ++j) {
      const int f0 = j * kFusedChunk;
      if (j < chunks) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {  // b1 of this thread's columns, read before the products
          const int f = f0 + 32 * group + 8 * jj + 2 * t;
          bias[jj] = f < NF ? load_u32(b1 + f) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {  // fc1: hacc = x . W1[chunk j]^T, 128 of K a stage
          if (loads) mbarrier_wait(&full[stage], parity);
          const unsigned char* w = ring + stage * kFusedStageBytes + group * 32 * 128;
          wgmma_pin(hacc);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < 2 && do_fc1; ++p) {
            const uint64_t desc_a = wgmma_descriptor_sw128(xs + (2 * i + p) * kBox);
            const uint64_t desc_b = wgmma_descriptor_sw128(w + p * kBox);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n32k16(hacc, desc_a + 2 * kk, desc_b + 2 * kk, i + p + kk > 0);
          }
          wgmma_commit();
          retire(Three{});
        }
      }
      if (j > 0) {  // fc2 of chunk j - 1, with chunk j's epilogue under its products
        const unsigned char* g_old = gs + ((j - 1) & 1) * kBox;
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          if (loads) mbarrier_wait(&full[stage], parity);
          const unsigned char* w = ring + stage * kFusedStageBytes + group * kBox;
          wgmma_pin(acc[i]);
          wgmma_fence();
          if (do_fc2) {
            const uint64_t desc_a = wgmma_descriptor_sw128(g_old);
            const uint64_t desc_b = wgmma_descriptor_sw128(w);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n64k16(acc[i], desc_a + 2 * kk, desc_b + 2 * kk, j > 1 || kk > 0);
          }
          wgmma_commit();
          if (i > 0 && j < chunks && do_epilogue) {
            // fc1 of chunk j finished at the first stage's retire: spread
            // its four column tiles over the stages that follow.
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (jj * (kSteps - 1) / 4 == i - 1) gelu_tile(jj);
          }
          if (i == 0) {
            retire(One{});  // and fc1 of chunk j with it: its sums may be read
            wgmma_pin(hacc);
          } else {
            retire(Three{});
          }
        }
      } else {  // chunk 0: no fc2 to overlap
        wgmma_wait<0>();
        wgmma_pin(hacc);
        if (do_epilogue) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) gelu_tile(jj);
        }
      }
      if (j < chunks && do_epilogue) {
        // Lane t now takes column tile t of the four: 8 contiguous features.
        quad_transpose(g_lo, t);
        quad_transpose(g_hi, t);
        unsigned char* g_new = gs + (j & 1) * kBox;
        const int piece = ((4 * group + t) ^ (r_lo & 7)) << 4;  // the 128-byte swizzle
        *reinterpret_cast<uint4*>(g_new + r_lo * 128 + piece) =
            make_uint4(g_lo[0], g_lo[1], g_lo[2], g_lo[3]);
        *reinterpret_cast<uint4*>(g_new + (r_lo + 8) * 128 + piece) =
            make_uint4(g_hi[0], g_hi[1], g_hi[2], g_hi[3]);
        fence_proxy_async_shared();
        const int col = f0 + 32 * group + 8 * t;
        if (h != nullptr) {
          quad_transpose(h_lo, t);
          quad_transpose(h_hi, t);
          if (col < NF && m0 + r_lo < M)  // NF is a multiple of 32: a piece is in or out whole
            *reinterpret_cast<uint4*>(h + static_cast<long>(m0 + r_lo) * NF + col) =
                make_uint4(h_lo[0], h_lo[1], h_lo[2], h_lo[3]);
          if (col < NF && m0 + r_lo + 8 < M)
            *reinterpret_cast<uint4*>(h + static_cast<long>(m0 + r_lo + 8) * NF + col) =
                make_uint4(h_hi[0], h_hi[1], h_hi[2], h_hi[3]);
        }
      }
      // Both warpgroups' products that read g tile j - 1 are done before
      // either writes g tile j + 1 into its place, and g tile j is whole
      // before the next chunk's fc2 reads it.
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (held[k] >= 0) release(held[k]);
        held[k] = -1;
      }
      if (j < chunks) named_barrier_sync(1, kFusedConsumers);
    }

#pragma unroll
    for (int a = 0; a < kSteps; ++a) wgmma_pin(acc[a]);
    const int row_lo = m0 + r_lo;
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int jg = 0; jg < 2; ++jg) {  // four column tiles: 32 columns
        uint32_t o_lo[4], o_hi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jj = 4 * jg + q;
          const int col = group * (K / 2) + 64 * i + 8 * jj + 2 * t;
          float v00 = acc[i][4 * jj], v01 = acc[i][4 * jj + 1];
          float v10 = acc[i][4 * jj + 2], v11 = acc[i][4 * jj + 3];
          if (LN) {  // the residual first: (x + acc) + b2
            if (row_lo < M) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + static_cast<long>(row_lo) * K + col));
              v00 = r.x + v00;
              v01 = r.y + v01;
            }
            if (row_hi < M) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + static_cast<long>(row_hi) * K + col));
              v10 = r.x + v10;
              v11 = r.y + v11;
            }
          }
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
          o_lo[q] = pack_floats(v00 + b.x, v01 + b.y);
          o_hi[q] = pack_floats(v10 + b.x, v11 + b.y);
        }
        quad_transpose(o_lo, t);
        quad_transpose(o_hi, t);
        const int col = group * (K / 2) + 64 * i + 32 * jg + 8 * t;
        if (row_lo < M)
          *reinterpret_cast<uint4*>(out + static_cast<long>(row_lo) * K + col) =
              make_uint4(o_lo[0], o_lo[1], o_lo[2], o_lo[3]);
        if (row_hi < M)
          *reinterpret_cast<uint4*>(out + static_cast<long>(row_hi) * K + col) =
              make_uint4(o_hi[0], o_hi[1], o_hi[2], o_hi[3]);
      }
    }
  }
}

template <int K, bool LN>
cudaError_t launch_mlp_fused(const bf16* x, const float* ln_s, const float* ln_t, const bf16* w1,
                             const bf16* b1, const bf16* w2, const bf16* b2, bf16* h, bf16* out,
                             int M, int NF, float eps, int probe, cudaStream_t stream) {
  using Shape = FusedShape<K>;
  const int cluster = probe & kMlpProbeCluster1 ? 1 : probe & kMlpProbeCluster4 ? 4 : kFusedCluster;
  CUtensorMap map_x, map_w1, map_w2;
  cudaError_t err = make_tensor_map_sw128(&map_x, x, M, K, kFusedRows);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_sw128(&map_w1, w1, NF, K, kFusedRows / cluster);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_sw128(&map_w2, w2, K, NF, kFusedRows / cluster);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(mlp_fused_kernel<K, LN>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kFusedRows - 1) / kFusedRows;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((tiles + cluster - 1) / cluster * cluster);  // whole clusters
  config.blockDim = dim3(kFusedThreads);
  config.dynamicSmemBytes = Shape::kSmemBytes;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  void* args[] = {&map_x, &map_w1, &map_w2, &x, &ln_s, &ln_t, &b1, &b2, &h, &out, &M, &NF, &eps,
                  &probe};
  err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(mlp_fused_kernel<K, LN>), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The first design of the fused MLP, kept for timing only: reached
// through ssl4polyp_mlp_fused_probe's kMlpProbeFirstDesign, by no route.
// One block of 8 warps owns 32 rows of x, resident in shared memory
// (normalised there for the LN variant), and walks NF in tiles of 32 hidden
// features: fc1 (warp tile 16 x 8, mma.sync m16n8k16) reads the tile's 32
// rows of W1 from shared memory, the epilogue stages h and g in shared
// memory and stores h, fc2 (warp tile 32 rows x K/8 columns) adds g . W2^T
// into registers; cp.async brings the next W1 tile under fc2 and the next W2
// tile under fc1.  Every block streams all of W1 and W2 for its 32 rows:
// bound by L2.  The same roundings and bit-identical reruns.
// ---------------------------------------------------------------------------

constexpr int kFRows = 32;          // rows of x per block
constexpr int kFTile = 32;          // hidden features per step of the NF loop
constexpr int kFLd = kFTile + 8;    // padded shared row of the W2, h and g tiles
constexpr int kFThreads = 256;

template <int K>
constexpr size_t mlp_fused_first_smem_bytes() {
  return static_cast<size_t>(kFRows * (K + 8)   // x rows (normalised for the LN variant)
                             + kFTile * (K + 8)  // the W1 tile: 32 rows of K
                             + K * kFLd          // the W2 tile: K rows of 32
                             + 2 * kFRows * kFLd)  // the h and g tiles
         * sizeof(bf16);
}

template <int K, bool LN>
__global__ void __launch_bounds__(kFThreads)
mlp_fused_first_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_t, const bf16* __restrict__ w1,
                       const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                       const bf16* __restrict__ b2, bf16* __restrict__ h, bf16* __restrict__ out,
                       int M, int NF, float eps) {
  constexpr int kLdX = K + 8;
  constexpr int kLdS = K + 4;     // fp32 staging row of the output
  constexpr int kWarpCols = K / 8;  // fc2 output columns per warp
  constexpr int kNT = kWarpCols / 8;  // n8 tiles per warp in fc2
  static_assert(K % 128 == 0, "K must be a multiple of 128");
  static_assert(kFRows * kLdS * sizeof(float) <= (kFTile * kLdX + K * kFLd) * sizeof(bf16),
                "the fp32 output stage must fit where the weight tiles were");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = xs + kFRows * kLdX;
  bf16* w2s = w1s + kFTile * kLdX;
  bf16* hs = w2s + K * kFLd;
  bf16* gs = hs + kFRows * kFLd;
  float* stage = reinterpret_cast<float*>(w1s);  // after the NF loop only

  const int m0 = blockIdx.x * kFRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  auto load_x = [&]() {
    for (int i = threadIdx.x; i < kFRows * (K / 8); i += kFThreads) {
      const int r = i / (K / 8);
      const int c = (i % (K / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async_16(xs + r * kLdX + c, ok ? x + static_cast<long>(m0 + r) * K + c : x, ok ? 16 : 0);
    }
  };
  auto load_w1 = [&](int f0) {  // rows f0 .. f0 + 31 of W1 (NF, K)
    for (int i = threadIdx.x; i < kFTile * (K / 8); i += kFThreads) {
      const int r = i / (K / 8);
      const int c = (i % (K / 8)) * 8;
      cp_async_16(w1s + r * kLdX + c, w1 + static_cast<long>(f0 + r) * K + c, 16);
    }
  };
  auto load_w2 = [&](int f0) {  // columns f0 .. f0 + 31 of W2 (K, NF)
    for (int i = threadIdx.x; i < K * (kFTile / 8); i += kFThreads) {
      const int r = i / (kFTile / 8);
      const int c = (i % (kFTile / 8)) * 8;
      cp_async_16(w2s + r * kFLd + c, w2 + static_cast<long>(r) * NF + f0 + c, 16);
    }
  };

  // cp.async groups, oldest first: {x, W1 tile 0}, {W2 tile 0}; then in step
  // j: {W1 tile j + 1} after fc1, {W2 tile j + 1} after fc2 (empty past the end).
  load_x();
  load_w1(0);
  cp_async_commit();
  load_w2(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (LN) {
    layernorm_rows_in_place(xs, kLdX, kFRows, K, ln_s, ln_t, eps);
    __syncthreads();
  }

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.0f;

  // fc1 warp tile: rows (warp / 4) * 16 .. + 15, tile features (warp % 4) * 8 .. + 7.
  const int h_row = (warp / 4) * 16;
  const int h_col = (warp % 4) * 8;
  const int a_row = h_row + (lane % 16);
  const int a_col = (lane / 16) * 8;
  const int b1_row = h_col + (lane % 8);
  const int b1_col = ((lane / 8) % 2) * 8;
  // fc2 warp tile: all 32 rows, output columns warp * K/8 .. + K/8 - 1.
  const int wn = warp * kWarpCols;
  const int b2_row = wn + (lane / 16) * 8 + (lane % 8);
  const int b2_col = ((lane / 8) % 2) * 8;

  const int tiles = NF / kFTile;
  for (int j = 0; j < tiles; ++j) {
    const int f0 = j * kFTile;
    float hacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t a[4], b[2];
      ldmatrix_x4(a, xs + a_row * kLdX + kk + a_col);
      ldmatrix_x2(b, w1s + b1_row * kLdX + kk + b1_col);
      mma_16816(hacc, a, b[0], b[1]);
    }
    __syncthreads();  // every warp is done with the W1 tile
    if (j + 1 < tiles) load_w1(f0 + kFTile);
    cp_async_commit();

    const int col = h_col + 2 * t;
    const float bias0 = __bfloat162float(b1[f0 + col]);
    const float bias1 = __bfloat162float(b1[f0 + col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = h_row + g + 8 * half;
      const float h0 = hacc[2 * half] + bias0;
      const float h1 = hacc[2 * half + 1] + bias1;
      *reinterpret_cast<uint32_t*>(hs + row * kFLd + col) = pack_floats(h0, h1);
      *reinterpret_cast<uint32_t*>(gs + row * kFLd + col) = pack_floats(gelu_erf(h0), gelu_erf(h1));
    }
    cp_async_wait<1>();  // the W2 tile j (the W1 tile j + 1 may still be in flight)
    __syncthreads();     // h, g and the W2 tile are complete

    if (h != nullptr && threadIdx.x < kFRows * (kFTile / 8)) {  // 32 rows of 64 bytes
      const int r = threadIdx.x / (kFTile / 8);
      const int c = (threadIdx.x % (kFTile / 8)) * 8;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(h + static_cast<long>(m0 + r) * NF + f0 + c) =
            *reinterpret_cast<const uint4*>(hs + r * kFLd + c);
    }
#pragma unroll
    for (int kk = 0; kk < kFTile; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], gs + (i * 16 + (lane % 16)) * kFLd + kk + a_col);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, w2s + (b2_row + n * 8) * kFLd + kk + b2_col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][n], a[i], b[0], b[1]);
          mma_16816(acc[i][n + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the W2 tile, h and g
    if (j + 1 < tiles) load_w2(f0 + kFTile);
    cp_async_commit();
    cp_async_wait<1>();  // the W1 tile j + 1
    __syncthreads();
  }

  // The fp32 accumulator through shared memory, then 16-byte rows out.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i * 16 + g + 8 * half;
        *reinterpret_cast<float2*>(stage + row * kLdS + wn + n * 8 + 2 * t) =
            make_float2(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
      }
  __syncthreads();
  for (int i = threadIdx.x; i < kFRows * (K / 8); i += kFThreads) {
    const int r = i / (K / 8);
    const int c = (i % (K / 8)) * 8;
    if (m0 + r >= M) continue;
    const float4 lo = *reinterpret_cast<const float4*>(stage + r * kLdS + c);
    const float4 hi = *reinterpret_cast<const float4*>(stage + r * kLdS + c + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const uint4 bq = *reinterpret_cast<const uint4*>(b2 + c);
    const bf16* bv = reinterpret_cast<const bf16*>(&bq);
    const long at = static_cast<long>(m0 + r) * K + c;
    if (LN) {
      const uint4 xq = *reinterpret_cast<const uint4*>(x + at);
      const bf16* xv = reinterpret_cast<const bf16*>(&xq);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(xv[e]) + v[e];
    }
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[e] = pack_floats(v[2 * e] + __bfloat162float(bv[2 * e]),
                          v[2 * e + 1] + __bfloat162float(bv[2 * e + 1]));
    *reinterpret_cast<uint4*>(out + at) = o;
  }
}

template <int K, bool LN>
cudaError_t launch_mlp_fused_first(const bf16* x, const float* ln_s, const float* ln_t, const bf16* w1,
                             const bf16* b1, const bf16* w2, const bf16* b2, bf16* h, bf16* out,
                             int M, int NF, float eps, cudaStream_t stream) {
  constexpr size_t bytes = mlp_fused_first_smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(mlp_fused_first_kernel<K, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  mlp_fused_first_kernel<K, LN><<<(M + kFRows - 1) / kFRows, kFThreads, bytes, stream>>>(
      x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t dispatch_mlp_fused(int K, const bf16* x, const float* ln_s, const float* ln_t,
                               const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                               bf16* h, bf16* out, int M, int NF, float eps, int probe,
                               cudaStream_t stream) {
  const bool first = probe & kMlpProbeFirstDesign;
  switch (K) {
    case 512:
      return first ? launch_mlp_fused_first<512, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, stream)
                   : launch_mlp_fused<512, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, probe, stream);
    case 768:
      return first ? launch_mlp_fused_first<768, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, stream)
                   : launch_mlp_fused<768, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, probe, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) bf16; w: (NF, K) bf16; bias: (NF,) bf16; h (or null) and y:
// (M, NF) bf16.  K and NF are multiples of 8 and every pointer is 16-byte
// aligned.  Returns the CUDA error of the tensor maps or the launch.
extern "C" int ssl4polyp_fc1_gelu_fwd(const void* x, const void* w, const void* bias, void* h,
                                      void* y, int M, int K, int NF, void* stream) {
  return static_cast<int>(dispatch_gemm<kEpiGelu>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(h), static_cast<bf16*>(y), M, K, NF, static_cast<cudaStream_t>(stream)));
}

// y = x . w^T, rounded once to bf16.  x: (M, K) bf16; w: (NF, K) bf16; y:
// (M, NF) bf16; K and NF multiples of 8, every pointer 16-byte aligned.  The
// same kernel as fc1+GELU with a bare epilogue, for the products inside other
// kernels' phases (attention_block.cu's dx).  Returns the CUDA error of the
// tensor maps or the launch.
extern "C" int ssl4polyp_matmul_nt(const void* x, const void* w, void* y, int M, int K, int NF,
                                   void* stream) {
  return static_cast<int>(dispatch_gemm<kEpiBare>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), nullptr, nullptr,
      static_cast<bf16*>(y), M, K, NF, static_cast<cudaStream_t>(stream)));
}

// y = round(round(x . w^T) + bias): the bare product rounded to bf16, then
// the bias added in bf16 and the sum rounded again.  x: (M, K) bf16; w: (NF,
// K) bf16; bias: (NF,) bf16; y: (M, NF) bf16; K and NF multiples of 8, every
// pointer 16-byte aligned.  The same kernel as ssl4polyp_matmul_nt with the
// bias in its epilogue (attn_proj.cu's y past 256 tokens).  Returns the CUDA
// error of the tensor maps or the launch.
extern "C" int ssl4polyp_matmul_nt_bias(const void* x, const void* w, const void* bias, void* y,
                                        int M, int K, int NF, void* stream) {
  return static_cast<int>(dispatch_gemm<kEpiBias>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      nullptr, static_cast<bf16*>(y), M, K, NF, static_cast<cudaStream_t>(stream)));
}

// x: (M, K) bf16; ln_s, ln_t: (K,) fp32, or both null for no LayerNorm
// prologue (and no residual); w1: (NF, K), b1: (NF,), w2: (K, NF), b2: (K,)
// bf16; h (or null): (M, NF) bf16; out: (M, K) bf16.  K is 512 or 768 (the
// MAE decoder's and ViT-B's widths), NF a multiple of 32 and every pointer
// 16-byte aligned.  `probe` (0 on every path) is a measurement aid: the
// kMlpProbe* bits above.  Returns the CUDA error of the tensor maps or the
// launch.
extern "C" int ssl4polyp_mlp_fused_probe(const void* x, const void* ln_s, const void* ln_t,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, void* h, void* out, int M, int K, int NF,
                                         float eps, int probe, void* stream) {
  const auto* xb = static_cast<const bf16*>(x);
  const auto* s = static_cast<const float*>(ln_s);
  const auto* t = static_cast<const float*>(ln_t);
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* b1b = static_cast<const bf16*>(b1);
  const auto* w2b = static_cast<const bf16*>(w2);
  const auto* b2b = static_cast<const bf16*>(b2);
  auto* hb = static_cast<bf16*>(h);
  auto* ob = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      s == nullptr
          ? dispatch_mlp_fused<false>(K, xb, s, t, w1b, b1b, w2b, b2b, hb, ob, M, NF, eps, probe, st)
          : dispatch_mlp_fused<true>(K, xb, s, t, w1b, b1b, w2b, b2b, hb, ob, M, NF, eps, probe, st);
  return static_cast<int>(err);
}

// ssl4polyp_mlp_fused_probe with probe 0: the kernel every route launches.
extern "C" int ssl4polyp_mlp_fused_fwd(const void* x, const void* ln_s, const void* ln_t,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* h, void* out, int M, int K, int NF,
                                       float eps, void* stream) {
  return ssl4polyp_mlp_fused_probe(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, K, NF, eps, 0, stream);
}
