// LayerNorm folded into the linear that follows it:
// out = LN(x) . W^T + b, with m = (x - mean) * rsqrt(var + eps) * s + t.
//
// Replaces: ssl4polyp_tpu/ops/ln_linear.py::_ln_linear_kernel (ln_linear),
// which the JAX package runs for each block's norm1 + QKV projection under
// qkv_ln_fusion.  Like the TPU kernel it takes the statistics in fp32 over
// whole rows, rounds the normalised row m to bf16 once, accumulates the
// product in fp32, adds the bias in fp32 and rounds once.  The backward is
// plain torch, as the JAX package leaves it to XLA.
//
// What bounds it on the H100: at the fine-tune shape (M = 12,608, K = 768,
// N = 2304) the product is 44.6 GFLOP against about 65 MB of bf16 traffic:
// the tensor cores, which only wgmma drives at their full rate.  What the
// fusion saves is the normalised stream's HBM round trip (2 x 19 MB).
//
// The design (the first design, below, ran mma.sync from a cp.async ring
// that all threads filled, 96 whole rows a block, so that every block
// streamed all of W, and stored 4 bytes a thread):
//   * Two launches in one call.  First ln_linear_stats_kernel: a warp a row,
//     fp32 (mean, rstd) into a (M, 2) scratch, summed in the order of
//     common.cuh::layernorm_rows_in_place (lane l the pairs 2l, 2l + 64, ..,
//     then warp_sum), so that m keeps the first design's bits.  Then the
//     GEMM, launched with programmatic stream serialisation: its blocks
//     start, set up and load their first stages while the statistics
//     finish; only the warps that read them wait (griddepcontrol.wait).
//   * The GEMM is mlp.cu's fc1 loop: a persistent grid of one block an SM
//     walking 128 x BN output tiles (columns fastest); a producer warpgroup
//     whose one thread feeds a ring of 128-byte-swizzled TMA stages of x
//     (128 x 64) and W (BN x 64) with full / empty mbarriers; two consumer
//     warpgroups of 64 rows each on wgmma m64nBNk16 with fp32 accumulators
//     in registers.  Ragged M and N are TMA's out-of-bounds zeros.
//   * The normalisation is the consumers' and stays in registers: each warp
//     reads its 16 rows of an x stage with ldmatrix (through the swizzle),
//     applies the fp32 formula with its two rows' (mean, rstd) (loaded once
//     a tile) and the stage's s and t (copied to shared memory once a
//     block), rounds once, and hands the result to wgmma as its A operand
//     (B, the W tile, stays in shared memory).  The next step's A is made
//     into a second set of registers while the current step's products
//     run.  Normalised in place in shared memory instead (fence, then a
//     named barrier) the stores did not overlap the products in flight:
//     +0.035 ms at the classifier's shape, +0.067 ms on a warpgroup of its
//     own (PERF.md).
//   * The epilogue is fc1's without the GELU: b (a tile's slice copied into
//     shared memory under the products) added in fp32, one rounding, a quad
//     transpose, 16 contiguous bytes a thread.
//   * The wide tile, 128 x 256 (ring of 4), wherever its tiles fill a wave:
//     each N tile normalises its x stages again, so 128 x 128 (ring of 6)
//     does that twice as often; below a wave, mlp.cu's dispatch_gemm rule.
//   * No atomics: each output element is summed by one thread in an order
//     fixed by the shape; reruns give the same bits.
//   PERF.md has the times, the first design's and the ablations
//   (ssl4polyp_ln_linear_probe).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// `probe` bits, a measurement aid (0 on every path; chip_smoke.py times the
// kernel with parts left out, whose results are wrong): no normalisation (x
// straight into the products), no statistics launch (the GEMM reads the
// scratch as it finds it), the bare epilogue (no bias); the tile width that
// the shape rule did not pick, and the first design (both right results).
constexpr int kProbeNoNormalise = 1;
constexpr int kProbeNoStats = 2;
constexpr int kProbeBareEpilogue = 4;
constexpr int kProbeOtherWidth = 8;
constexpr int kProbeFirstDesign = 16;

constexpr int kMaxK = 768;         // s and t live in shared memory
constexpr int kBM = 128;           // rows of a tile: 64 for each consumer warpgroup
constexpr int kBK = 64;            // 128 bytes of bf16: one swizzle row
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kStatsWarps = 8;     // rows a block of the statistics kernel

template <int BN>
struct Shape {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kTileA = kBM * kBK;  // elements
  static constexpr int kTileB = BN * kBK;
  static constexpr uint32_t kStageBytes = (kTileA + kTileB) * sizeof(bf16);
  // The ring, s and t, each consumer warpgroup's two bias slices, 2 *
  // kStages barriers, and room to align the ring to 1,024 bytes.
  static constexpr size_t kSmemBytes = kStages * kStageBytes + 2 * kMaxK * sizeof(float) +
                                       2 * 2 * BN * sizeof(bf16) + 2 * kStages * sizeof(uint64_t) +
                                       1024;
  static_assert(kSmemBytes <= 232448, "the block's shared memory");
};

// (mean, rstd) of row blockIdx.x * kStatsWarps + warp, in fp32, in the
// order of layernorm_rows_in_place.
__global__ void __launch_bounds__(32 * kStatsWarps)
ln_linear_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int M, int K,
                       float eps) {
  grid_dependents_launch();  // the GEMM may start setting up at once
  const int r = blockIdx.x * kStatsWarps + threadIdx.x / 32;
  if (r >= M) return;
  const int lane = threadIdx.x % 32;
  const bf16* row = x + static_cast<long>(r) * K + 2 * lane;
  const int pairs = K / 64;
  float2 v[kMaxK / 64];
#pragma unroll
  for (int j = 0; j < kMaxK / 64; ++j)
    if (j < pairs) v[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 64 * j));
  const float inv_k = 1.0f / static_cast<float>(K);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxK / 64; ++j)
    if (j < pairs) sum += v[j].x + v[j].y;
  const float mean = warp_sum(sum) * inv_k;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxK / 64; ++j)
    if (j < pairs) sq += (v[j].x - mean) * (v[j].x - mean) + (v[j].y - mean) * (v[j].y - mean);
  const float rstd = rsqrtf(warp_sum(sq) * inv_k + eps);
  if (lane == 0) stats[r] = make_float2(mean, rstd);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
ln_linear_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ ln_s, const float* __restrict__ ln_t,
                 const float2* __restrict__ stats, const bf16* __restrict__ bias,
                 bf16* __restrict__ out, int M, int K, int N, int probe) {
  using S = Shape<BN>;
  using Zero = std::integral_constant<int, 0>;
  using One = std::integral_constant<int, 1>;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  bf16* tiles_a = reinterpret_cast<bf16*>(smem);
  bf16* tiles_b = tiles_a + kStages * S::kTileA;
  float* s_sm = reinterpret_cast<float*>(tiles_b + kStages * S::kTileB);
  float* t_sm = s_sm + kMaxK;
  bf16* bias_sm = reinterpret_cast<bf16*>(t_sm + kMaxK);  // [warpgroup][tile parity][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_sm + 2 * 2 * BN);
  uint64_t* empty = full + kStages;

  for (int i = threadIdx.x; i < K; i += kThreads) {
    s_sm[i] = ln_s[i];
    t_sm[i] = ln_t[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&empty[s], kConsumerWarps);
    }
    mbarrier_init_fence();
  }
  __syncthreads();

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int ksteps = K / kBK;

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
          mbarrier_arrive_expect_tx(&full[stage], S::kStageBytes);
          tma_load_2d(tiles_a + stage * S::kTileA, &map_x, &full[stage], ks * kBK, m0);
          tma_load_2d(tiles_b + stage * S::kTileB, &map_w, &full[stage], ks * kBK, n0);
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
  const int group = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 * group .. + 63
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool normalise = !(probe & kProbeNoNormalise);
  const bool with_bias = !(probe & kProbeBareEpilogue);

  // This thread's rows of a tile: g and g + 8 of its warp's 16.
  float mean[2], rstd[2];
  auto load_stats = [&](int tile) {
    const int r0 = (tile / tiles_n) * kBM + group * 64 + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float2 st = r < M ? stats[r] : make_float2(0.0f, 0.0f);  // rows past M: TMA's zeros
      mean[i] = st.x;
      rstd[i] = st.y;
    }
  };
  // Two sets of A operands, by step parity: one is read by the products in
  // flight while the next step's is loaded and normalised into the other.
  // Both are indexed by constants only, so they stay in registers, and no
  // register is copied between them.
  uint32_t a_frag[2][kBK / 16][4];
  // The x stage's 16 x 64 slice of this warp into a_frag[B] (ldmatrix through
  // the swizzle), m = (x - mean) * rstd * s + t in fp32, rounded once, as
  // layernorm_rows_in_place writes it.
  auto load_a = [&](auto buf, int st, int k0) {
    constexpr int B = decltype(buf)::value;
    const unsigned char* tile = reinterpret_cast<const unsigned char*>(tiles_a + st * S::kTileA);
    const int r = group * 64 + 16 * warp + (lane % 16);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t(&a)[4] = a_frag[B][kk];
      const int piece = 2 * kk + lane / 16;
      ldmatrix_x4(a, reinterpret_cast<const bf16*>(tile + r * 128 + ((piece ^ (r & 7)) << 4)));
      if (normalise) {
        const int c = k0 + 16 * kk + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a[q]: row g (q even) or g + 8, columns c (q < 2) or c + 8
          const int cq = c + 8 * (q / 2);
          const float2 sq = *reinterpret_cast<const float2*>(s_sm + cq);
          const float2 tq = *reinterpret_cast<const float2*>(t_sm + cq);
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[q]));
          a[q] = pack_floats((v.x - mean[q % 2]) * rstd[q % 2] * sq.x + tq.x,
                             (v.y - mean[q % 2]) * rstd[q % 2] * sq.y + tq.y);
        }
      }
    }
  };

  grid_dependency_wait();  // the statistics are written
  int stage = 0;
  uint32_t parity = 0;
  if (blockIdx.x < tiles) {  // the first tile's first stage
    load_stats(blockIdx.x);
    mbarrier_wait(&full[stage], parity);
    load_a(Zero{}, stage, 0);
  }
  // One tile, whose step ks reads a_frag[(ks + P) % 2].
  auto run_tile = [&](auto phase, int tile, int it) {
    constexpr int P = decltype(phase)::value;
    const int m0 = (tile / tiles_n) * kBM;
    const int n0 = (tile % tiles_n) * BN;
    // The tile's bias slice into this warpgroup's buffer of the tile's
    // parity, under the products.  That buffer's last reader, the epilogue
    // two tiles back, is done in every warp: each passed the barrier before
    // the last tile's epilogue.
    bf16* bias_tile = bias_sm + (2 * group + (it & 1)) * BN;
    if (warp == 0 && lane < BN / 8) {
      const int col = n0 + 8 * lane;
      cp_async_16(bias_tile + 8 * lane, col < N ? bias + col : bias, col < N ? 16 : 0);
      cp_async_commit();
    }
    // acc[4 j + e]: column tile j of 8; e = 0, 1 row g, e = 2, 3 row g + 8
    // of this warp's 16 rows; columns 2t, 2t + 1 of the tile.
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    auto step = [&](auto buf, int ks) {
      constexpr int B = decltype(buf)::value;
      // Stage `stage` holds step ks, arrived, its A in a_frag[B].
      const uint64_t desc_b = wgmma_descriptor_sw128(tiles_b + stage * S::kTileB);
      wgmma_pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {  // 16 along K is 32 bytes: 2 descriptor units
        if constexpr (BN == 256) {
          wgmma_m64n256k16_rs(acc, a_frag[B][kk], desc_b + 2 * kk, 1);
        } else {
          wgmma_m64n128k16_rs(acc, a_frag[B][kk], desc_b + 2 * kk, 1);
        }
      }
      wgmma_commit();
      const int done = stage;
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
      // The next step's A is made while these products run: the next K
      // slice, or the next tile's first.
      const bool last = ks + 1 == ksteps;
      if (!last || tile + static_cast<int>(gridDim.x) < tiles) {
        if (last) load_stats(tile + gridDim.x);
        mbarrier_wait(&full[stage], parity);
        load_a(std::integral_constant<int, 1 - B>{}, stage, last ? 0 : (ks + 1) * kBK);
      }
      wgmma_wait<0>();  // the products are done: a_frag[B] is free, the stage goes back
      if (lane == 0) mbarrier_arrive(&empty[done]);
    };
    for (int ks = 0; ks < ksteps; ks += 2) {
      step(std::integral_constant<int, P>{}, ks);
      if (ks + 1 < ksteps) step(std::integral_constant<int, 1 - P>{}, ks + 1);
    }
    wgmma_pin(acc);
    cp_async_wait<0>();
    named_barrier_sync(1 + group, 128);  // the bias slice is in

    const int row_lo = m0 + group * 64 + warp * 16 + g;
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int jg = 0; jg < BN / 32; ++jg) {  // four column tiles: 32 columns
      uint32_t y_lo[4], y_hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = jg * 4 + i;
        float b0 = 0.0f, b1 = 0.0f;
        if (with_bias) {
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias_tile + j * 8 + 2 * t));
          b0 = b.x;
          b1 = b.y;
        }
        y_lo[i] = pack_floats(acc[4 * j] + b0, acc[4 * j + 1] + b1);
        y_hi[i] = pack_floats(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
      // Lane t now takes column tile t of the four: 8 contiguous columns.
      const int col = n0 + jg * 32 + 8 * t;
      const bool col_ok = col < N;  // N is a multiple of 8: a piece is in or out whole
      quad_transpose(y_lo, t);
      quad_transpose(y_hi, t);
      if (col_ok && row_lo < M)
        *reinterpret_cast<uint4*>(out + static_cast<long>(row_lo) * N + col) =
            make_uint4(y_lo[0], y_lo[1], y_lo[2], y_lo[3]);
      if (col_ok && row_hi < M)
        *reinterpret_cast<uint4*>(out + static_cast<long>(row_hi) * N + col) =
            make_uint4(y_hi[0], y_hi[1], y_hi[2], y_hi[3]);
    }
  };
  // A tile of an odd number of steps hands the next one the other set.
  bool odd = false;
  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    if (odd) {
      run_tile(One{}, tile, it);
    } else {
      run_tile(Zero{}, tile, it);
    }
    odd ^= ksteps & 1;
  }
}

template <int BN>
cudaError_t launch_ln_linear(const bf16* x, const float* ln_s, const float* ln_t, const bf16* w,
                             const bf16* bias, float2* stats, bf16* out, int M, int K, int N,
                             float eps, int probe, int sms, cudaStream_t stream) {
  using S = Shape<BN>;
  CUtensorMap map_x, map_w;
  cudaError_t err = make_tensor_map_sw128(&map_x, x, M, K, kBM);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_sw128(&map_w, w, N, K, BN);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(ln_linear_kernel<BN>, S::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  if (!(probe & kProbeNoStats)) {
    ln_linear_stats_kernel<<<(M + kStatsWarps - 1) / kStatsWarps, 32 * kStatsWarps, 0, stream>>>(
        x, stats, M, K, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int tiles = ((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles < sms ? tiles : sms);  // persistent: one block an SM at most
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = S::kSmemBytes;
  config.stream = stream;
  // Only behind the statistics kernel, which began after every earlier
  // launch in the stream had finished: x and W are final, out is free.
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = probe & kProbeNoStats ? 0 : 1;
  const float2* stats_in = stats;
  void* args[] = {&map_x, &map_w, &ln_s, &ln_t, &stats_in, &bias, &out, &M, &K, &N, &probe};
  err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(ln_linear_kernel<BN>), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t dispatch_ln_linear(const bf16* x, const float* ln_s, const float* ln_t, const bf16* w,
                               const bf16* bias, float2* stats, bf16* out, int M, int K, int N,
                               float eps, int probe, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // The wide tile wherever its tiles fill at least one wave: every N tile
  // normalises its x stages again, and the narrow one has twice as many.
  // Below a wave, mlp.cu's dispatch_gemm rule: the wide tile where its
  // tiles fill the SMs' waves at least as well as the narrow one's.
  const long rows = (M + kBM - 1) / kBM;
  const long wide = rows * ((N + 255) / 256), narrow = rows * ((N + 127) / 128);
  const long wide_slots = (wide + sms - 1) / sms * sms, narrow_slots = (narrow + sms - 1) / sms * sms;
  const bool pick_wide = N > 128 && (wide >= sms || wide * narrow_slots >= narrow * wide_slots);
  if (pick_wide != static_cast<bool>(probe & kProbeOtherWidth))
    return launch_ln_linear<256>(x, ln_s, ln_t, w, bias, stats, out, M, K, N, eps, probe, sms, stream);
  return launch_ln_linear<128>(x, ln_s, ln_t, w, bias, stats, out, M, K, N, eps, probe, sms, stream);
}

// ---------------------------------------------------------------------------
// The first design, kept for timing only: reached through
// ssl4polyp_ln_linear_probe's kProbeFirstDesign, by no route.  A block owns
// 96 whole rows of x and walks every column of the output.  The rows are
// loaded once into shared memory (cp.async, ragged rows zero-filled) and
// normalised there in place (layernorm_rows_in_place); 12,608 rows are 132
// blocks, one wave on the H100's 132 SMs.  W then streams through a
// three-stage cp.async ring of 128 x 64 tiles, one ring across all the N
// tiles, and each of the 8 warps accumulates a 48 x 32 sub-tile with
// mma.sync m16n8k16.  After the last K step of an N tile the epilogue adds b
// in fp32, rounds once and stores from the registers (two bf16 a thread).
// Every block reads all of W (3.5 MB at K 768): 467 MB of L2 reads a call.
// ---------------------------------------------------------------------------


constexpr int kFRows = 96;
constexpr int kFCols = 128;
constexpr int kFK = 64;
constexpr int kFLdW = kFK + 8;  // padded shared row of a W tile
constexpr int kFStages = 3;
constexpr int kFThreads = 256;
constexpr int kFTileW = kFCols * kFLdW;
constexpr int kFWarpM = 48;  // rows per warp: 3 m16 tiles; warps as 2 x 4
constexpr int kFMT = kFWarpM / 16;

size_t ln_linear_first_smem_bytes(int K) {
  return (static_cast<size_t>(kFRows) * (K + 8) + kFStages * kFTileW) * sizeof(bf16);
}

__global__ void __launch_bounds__(kFThreads)
ln_linear_first_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_t, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int K, int N,
                       float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_x = K + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // kFRows rows of K, normalised in place
  bf16* ws = xs + kFRows * ld_x;             // kFStages W tiles

  const int m0 = blockIdx.x * kFRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / 4) * kFWarpM;  // warp's rows in the block
  const int wn = (warp % 4) * 32;        // warp's columns in the N tile
  const int k_steps = K / kFK;
  const int total = ((N + kFCols - 1) / kFCols) * k_steps;  // steps of the one W ring

  auto load_w = [&](int step) {  // step -> rows n0 .. n0 + 127, columns k0 .. k0 + 63 of W
    bf16* dst = ws + (step % kFStages) * kFTileW;
    const int n0 = (step / k_steps) * kFCols;
    const int k0 = (step % k_steps) * kFK;
    for (int i = threadIdx.x; i < kFCols * (kFK / 8); i += kFThreads) {
      const int r = i / (kFK / 8);
      const int c = (i % (kFK / 8)) * 8;
      const bool ok = n0 + r < N;
      cp_async_16(dst + r * kFLdW + c, ok ? w + static_cast<long>(n0 + r) * K + k0 + c : w,
                  ok ? 16 : 0);
    }
  };

  // cp.async groups, oldest first: {x rows, W step 0}, {W step 1}, then one
  // per step of the main loop (empty past the end).
  for (int i = threadIdx.x; i < kFRows * (K / 8); i += kFThreads) {
    const int r = i / (K / 8);
    const int c = (i % (K / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async_16(xs + r * ld_x + c, ok ? x + static_cast<long>(m0 + r) * K + c : x, ok ? 16 : 0);
  }
  load_w(0);
  cp_async_commit();
  if (total > 1) load_w(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  layernorm_rows_in_place(xs, ld_x, kFRows, K, ln_s, ln_t, eps);

  const int a_row = wm + (lane % 16);
  const int a_col = (lane / 16) * 8;
  const int b_row = wn + (lane / 16) * 8 + (lane % 8);
  const int b_col = ((lane / 8) % 2) * 8;
  float acc[kFMT][4][4];
#pragma unroll
  for (int i = 0; i < kFMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int step = 0; step < total; ++step) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // W step `step` is in (and, at step 0, the rows are normalised)
    if (step + kFStages - 1 < total) load_w(step + kFStages - 1);
    cp_async_commit();
    const bf16* tile = ws + (step % kFStages) * kFTileW;
    const int k0 = (step % k_steps) * kFK;
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 16) {
      uint32_t a[kFMT][4];
#pragma unroll
      for (int i = 0; i < kFMT; ++i) ldmatrix_x4(a[i], xs + (a_row + i * 16) * ld_x + k0 + kk + a_col);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, tile + (b_row + j * 8) * kFLdW + kk + b_col);
#pragma unroll
        for (int i = 0; i < kFMT; ++i) {
          mma_16816(acc[i][j], a[i], b[0], b[1]);
          mma_16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (step % k_steps != k_steps - 1) continue;

    // The N tile is complete: + b in fp32, one rounding, out of the registers.
    const int n0 = (step / k_steps) * kFCols;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      const bool col_ok = col < N;  // N is a multiple of 8, so col + 1 < N too
      const float b0 = col_ok ? __bfloat162float(bias[col]) : 0.0f;
      const float b1 = col_ok ? __bfloat162float(bias[col + 1]) : 0.0f;
#pragma unroll
      for (int i = 0; i < kFMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm + i * 16 + g + 8 * half;
          if (col_ok && row < M)
            *reinterpret_cast<uint32_t*>(out + static_cast<long>(row) * N + col) =
                pack_floats(acc[i][j][2 * half] + b0, acc[i][j][2 * half + 1] + b1);
          acc[i][j][2 * half] = acc[i][j][2 * half + 1] = 0.0f;
        }
    }
  }
}


cudaError_t launch_ln_linear_first(const bf16* x, const float* ln_s, const float* ln_t,
                                   const bf16* w, const bf16* bias, bf16* out, int M, int K, int N,
                                   float eps, cudaStream_t stream) {
  const size_t bytes = ln_linear_first_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      ln_linear_first_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ln_linear_first_kernel<<<(M + kFRows - 1) / kFRows, kFThreads, bytes, stream>>>(
      x, ln_s, ln_t, w, bias, out, M, K, N, eps);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) bf16; ln_s, ln_t: (K,) fp32; w: (N, K) bf16; bias: (N,) bf16;
// stats: (M, 2) fp32 scratch (the rows' mean and rstd; unused by the first
// design); out: (M, N) bf16.  K is a multiple of 64 up to 768, N a multiple
// of 8, every pointer 16-byte aligned (stats 8-byte).  `probe` (0 on every
// path) is a measurement aid: the kProbe* bits above.  Returns the CUDA
// error of the tensor maps or the launches.
extern "C" int ssl4polyp_ln_linear_probe(const void* x, const void* ln_s, const void* ln_t,
                                         const void* w, const void* bias, void* stats, void* out,
                                         int M, int K, int N, float eps, int probe, void* stream) {
  const auto* xb = static_cast<const bf16*>(x);
  const auto* s = static_cast<const float*>(ln_s);
  const auto* t = static_cast<const float*>(ln_t);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(bias);
  auto* ob = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (K % 64 || K < 64 || K > kMaxK || N % 8 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      probe & kProbeFirstDesign
          ? launch_ln_linear_first(xb, s, t, wb, bb, ob, M, K, N, eps, st)
          : dispatch_ln_linear(xb, s, t, wb, bb, static_cast<float2*>(stats), ob, M, K, N, eps,
                               probe, st);
  return static_cast<int>(err);
}

// The kernel for a caller without scratch: ssl4polyp_ln_linear_probe with
// probe 0 and the statistics' scratch taken from the stream's memory pool
// (stream-ordered, freed after the launches).  Arguments as above.
extern "C" int ssl4polyp_ln_linear_fwd(const void* x, const void* ln_s, const void* ln_t,
                                       const void* w, const void* bias, void* out, int M, int K,
                                       int N, float eps, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  void* stats = nullptr;
  cudaError_t err = cudaMallocAsync(&stats, static_cast<size_t>(M > 0 ? M : 1) * sizeof(float2), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = ssl4polyp_ln_linear_probe(x, ln_s, ln_t, w, bias, stats, out, M, K, N, eps, 0, stream);
  err = cudaFreeAsync(stats, st);
  return rc != 0 ? rc : static_cast<int>(err);
}
