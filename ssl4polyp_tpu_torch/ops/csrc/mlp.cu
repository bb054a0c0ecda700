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

// GELU true: y = gelu(acc + bias), and h = acc + bias when h is not null.
// GELU false: the bare product y = x . w^T rounded once to bf16 (`bias` and
// `h` are not read): the streaming GEMM other kernels' phases call through
// ssl4polyp_matmul_nt.
template <int BN, bool GELU>
__global__ void __launch_bounds__(kGemmThreads, 1)
fc1_gelu_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                const bf16* __restrict__ bias, bf16* __restrict__ h, bf16* __restrict__ y, int M,
                int K, int NF) {
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
          if (GELU) {
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

template <int BN, bool GELU>
cudaError_t launch_gemm(const bf16* x, const bf16* w, const bf16* bias, bf16* h, bf16* y, int M,
                        int K, int NF, int sms, cudaStream_t stream) {
  using Shape = GemmShape<BN>;
  CUtensorMap map_x, map_w;
  cudaError_t err = make_tensor_map_sw128(&map_x, x, M, K, kBM);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_sw128(&map_w, w, NF, K, BN);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(fc1_gelu_kernel<BN, GELU>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kBM - 1) / kBM) * ((NF + BN - 1) / BN);
  const int blocks = tiles < sms ? tiles : sms;  // persistent: one block an SM at most
  fc1_gelu_kernel<BN, GELU><<<blocks, kGemmThreads, Shape::kSmemBytes, stream>>>(
      map_x, map_w, bias, h, y, M, K, NF);
  return cudaGetLastError();
}

// The wide tile where its tiles fill the SMs' waves at least as well as the
// narrow one's do (it reads x and w from shared memory half as often per
// product), the narrow one otherwise.
template <bool GELU>
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
    return launch_gemm<256, GELU>(x, w, bias, h, y, M, K, NF, sms, stream);
  return launch_gemm<128, GELU>(x, w, bias, h, y, M, K, NF, sms, stream);
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
// K = 768, NF = 3072) the two products are 119 GFLOP; what the fusion saves
// is g's HBM round trip (2 x 77 MB).  The fp32 output accumulator (rows x K)
// lives across the whole NF loop, so a block can own few rows: 32 rows of
// 768 fp32 values are 96 registers a thread over 256 threads.  Every block
// therefore streams all of W1 and W2 (9.4 MB at K 768) through L2 for its
// 32 rows, about 3.7 GB of L2 reads per call: the L2 bandwidth, not the
// tensor cores, bounds this design.  wgmma with larger row tiles (the
// accumulator split over a cluster's blocks) is the later work.
//
// The design: one block of 8 warps owns 32 rows of x, resident in shared
// memory (normalised there for the LN variant).  It walks NF in tiles of 32
// hidden features.  fc1 (warp tile 16 x 8, mma.sync m16n8k16, fp32
// accumulate) reads the tile's 32 rows of W1 from shared memory; the
// epilogue adds b1, stages h and g in shared memory and stores the h tile in
// 16-byte rows.  fc2 (warp tile 32 rows x K/8 columns) adds g . W2tile^T
// into the register accumulator.  The W1 tile for step j + 1 loads (cp.async)
// while fc2 of step j runs, and the W2 tile for step j + 1 while fc1 of
// step j + 1 runs.  At the end the accumulator is staged in fp32 through
// shared memory, and the epilogue adds b2 (and x) and stores 16-byte rows.
// No atomics: each output element is summed by one thread in a fixed
// order, so reruns give the same bits.
// ---------------------------------------------------------------------------

constexpr int kFRows = 32;          // rows of x per block
constexpr int kFTile = 32;          // hidden features per step of the NF loop
constexpr int kFLd = kFTile + 8;    // padded shared row of the W2, h and g tiles
constexpr int kFThreads = 256;

template <int K>
constexpr size_t mlp_fused_smem_bytes() {
  return static_cast<size_t>(kFRows * (K + 8)   // x rows (normalised for the LN variant)
                             + kFTile * (K + 8)  // the W1 tile: 32 rows of K
                             + K * kFLd          // the W2 tile: K rows of 32
                             + 2 * kFRows * kFLd)  // the h and g tiles
         * sizeof(bf16);
}

template <int K, bool LN>
__global__ void __launch_bounds__(kFThreads)
mlp_fused_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
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
cudaError_t launch_mlp_fused(const bf16* x, const float* ln_s, const float* ln_t, const bf16* w1,
                             const bf16* b1, const bf16* w2, const bf16* b2, bf16* h, bf16* out,
                             int M, int NF, float eps, cudaStream_t stream) {
  constexpr size_t bytes = mlp_fused_smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(mlp_fused_kernel<K, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  mlp_fused_kernel<K, LN><<<(M + kFRows - 1) / kFRows, kFThreads, bytes, stream>>>(
      x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t dispatch_mlp_fused(int K, const bf16* x, const float* ln_s, const float* ln_t,
                               const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                               bf16* h, bf16* out, int M, int NF, float eps, cudaStream_t stream) {
  switch (K) {
    case 512: return launch_mlp_fused<512, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, stream);
    case 768: return launch_mlp_fused<768, LN>(x, ln_s, ln_t, w1, b1, w2, b2, h, out, M, NF, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) bf16; w: (NF, K) bf16; bias: (NF,) bf16; h (or null) and y:
// (M, NF) bf16.  K and NF are multiples of 8 and every pointer is 16-byte
// aligned.  Returns the CUDA error of the tensor maps or the launch.
extern "C" int ssl4polyp_fc1_gelu_fwd(const void* x, const void* w, const void* bias, void* h,
                                      void* y, int M, int K, int NF, void* stream) {
  return static_cast<int>(dispatch_gemm<true>(
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
  return static_cast<int>(dispatch_gemm<false>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), nullptr, nullptr,
      static_cast<bf16*>(y), M, K, NF, static_cast<cudaStream_t>(stream)));
}

// x: (M, K) bf16; ln_s, ln_t: (K,) fp32, or both null for no LayerNorm
// prologue (and no residual); w1: (NF, K), b1: (NF,), w2: (K, NF), b2: (K,)
// bf16; h (or null): (M, NF) bf16; out: (M, K) bf16.  K is 512 or 768 (the
// MAE decoder's and ViT-B's widths) and NF a multiple of 32.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_mlp_fused_fwd(const void* x, const void* ln_s, const void* ln_t,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* h, void* out, int M, int K, int NF,
                                       float eps, void* stream) {
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
          ? dispatch_mlp_fused<false>(K, xb, s, t, w1b, b1b, w2b, b2b, hb, ob, M, NF, eps, st)
          : dispatch_mlp_fused<true>(K, xb, s, t, w1b, b1b, w2b, b2b, hb, ob, M, NF, eps, st);
  return static_cast<int>(err);
}
