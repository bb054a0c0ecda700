// The weight gradient of a linear layer: the product of two row-major bf16
// matrices over their shared row index,
//   dW[i, j] = sum over rows r of a[r, i] * b[r, j]   (a^T . b, fp32),
// a (M, I) and b (M, J): attention_block.cu's dW = x^T dqkv and attn_proj.cu's
// dW = dy^T O.
//
// Replaces no TPU kernel of its own: it is the dW step of two TPU kernels'
// backwards (ssl4polyp_tpu/ops/attention_block.py::_bwd_kernel,
// attn_proj.py::_bwd_kernel), which accumulate it across their sequential
// grid.  The first design, transposed_product.cuh (mma.sync, 64 x 64 tiles,
// ldmatrix.trans on both operands), stays behind the probes of the two
// backwards for timing.
//
// What bounds it on the H100: at the QKV projection's shape (M = 64 * 197 =
// 12,608, I 768, J 2,304) it is 44.6 GFLOP against 84 MB (a and b read once,
// dW written once in fp32), 530 FLOP a byte: the tensor cores bound it, 0.045
// ms at their peak.  Only wgmma reaches that rate.
//
// The design (mlp.cu's persistent warp-specialised GEMM, both operands
// transposed):
//   * A tile of dW is 128 rows (a's columns; 64 a consumer warpgroup) by 256
//     columns (b's).  The reduction runs down both operands' rows, so for
//     wgmma both are MN-major: a's 64-row step of one warpgroup is one TMA box
//     of 64 x 64 under the 128-byte swizzle, exactly one swizzle atom wide
//     along M; b's is four such boxes side by side along N, 8 KB apart, which
//     the descriptor's leading offset steps across (wgmma_descriptor_mn_sw128).
//     One wgmma m64n256k16 a step of 16 with both transpose bits set: bit-equal
//     on integers to four m64n64k16 (one an atom, the leading offset unused),
//     and 2 % faster at the three shapes (PERF.md).
//   * A producer thread (its warpgroup gives its registers up by setmaxnreg)
//     fills a ring of four 48 KB stages by TMA; two consumer warpgroups take
//     them, one product group in flight while the previous stage is handed
//     back, 128 accumulators a thread.
//   * No atomics: the rows split into `slices` ranges of whole 64-row steps; a
//     unit is (slice, tile); a persistent grid of one block an SM walks the
//     units; each writes its fp32 partial, and dw_slice_sum_kernel adds the
//     slices in order (one slice: the product lands in dW itself).  A rerun
//     gives the same bits.  The slice count (ssl4polyp_dw_product_slices)
//     trades the rounds of units on the SMs against the partials' traffic:
//     2 at the QKV projection's shape (54 tiles), 5 at the MAE decoder's
//     (512 x 1,536: 24), 7 at the output projection's (768 x 768: 18).
//   * Ragged edges: rows past M and columns past I or J arrive as TMA's zeros;
//     the stores are guarded.  I and J are multiples of 8 (TMA's 16-byte row
//     pitch), no more: J = 288 (three heads of 32) takes a partial tile.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kDwThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kDwConsumerWarps = 8;
constexpr int kDwRows = 128;     // dW rows a tile: 64 a consumer warpgroup
constexpr int kDwCols = 256;     // dW columns a tile
constexpr int kDwStep = 64;      // reduction rows a stage
constexpr int kDwStages = 4;
constexpr uint32_t kDwBox = 64 * 64 * sizeof(bf16);  // a 64 x 64 box, one swizzle atom wide
constexpr uint32_t kDwABytes = 2 * kDwBox;
constexpr uint32_t kDwStageBytes = kDwABytes + 4 * kDwBox;
constexpr size_t kDwSmemBytes = kDwStages * kDwStageBytes + 2 * kDwStages * sizeof(uint64_t) + 1024;

// `parts` of ssl4polyp_dw_product.
constexpr int kDwProducts = 1;
constexpr int kDwSum = 2;

// The unit's geometry: its tile's first row and column of dW, its slice and
// its rows [r0, r1) of the reduction.
struct DwUnit {
  int i0, j0, slice, r0, r1;
  __device__ DwUnit(int unit, int tiles, int tiles_j, int M, int rows_per_slice) {
    const int tile = unit % tiles;
    i0 = (tile / tiles_j) * kDwRows;
    j0 = (tile % tiles_j) * kDwCols;
    slice = unit / tiles;
    r0 = slice * rows_per_slice;
    r1 = min(M, r0 + rows_per_slice);
  }
};

// dst: (slices, I, J) fp32 partials.
__global__ void __launch_bounds__(kDwThreads, 1)
dw_product_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  float* __restrict__ dst, int M, int I, int J, int slices, int rows_per_slice) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kDwStageBytes);
  uint64_t* empty = full + kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&empty[s], kDwConsumerWarps);
    }
    mbarrier_init_fence();
  }
  __syncthreads();

  const int tiles_j = (J + kDwCols - 1) / kDwCols;
  const int tiles = ((I + kDwRows - 1) / kDwRows) * tiles_j;
  const int units = tiles * slices;

  // The roles part here and never meet again: no block-wide barrier below.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t parity = 1;  // a fresh "empty" barrier lets the first pass through
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        const DwUnit u(unit, tiles, tiles_j, M, rows_per_slice);
        // A box wholly past I or J is not loaded: what its room holds reaches
        // only dW's rows or columns that are never stored.
        const int a_boxes = min(2, (I - u.i0 + 63) / 64);
        const int b_boxes = min(4, (J - u.j0 + 63) / 64);
        for (int r = u.r0; r < u.r1; r += kDwStep) {
          mbarrier_wait(&empty[stage], parity);
          unsigned char* st = smem + stage * kDwStageBytes;
          mbarrier_arrive_expect_tx(&full[stage], (a_boxes + b_boxes) * kDwBox);  // zeros count
          for (int g = 0; g < a_boxes; ++g)
            tma_load_2d(st + g * kDwBox, &map_a, &full[stage], u.i0 + 64 * g, r);
          for (int c = 0; c < b_boxes; ++c)
            tma_load_2d(st + kDwABytes + c * kDwBox, &map_b, &full[stage], u.j0 + 64 * c, r);
          if (++stage == kDwStages) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int group = threadIdx.x / 128 - 1;  // consumer warpgroup: dW rows 64 * group .. + 63
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  int stage = 0;
  uint32_t parity = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const DwUnit u(unit, tiles, tiles_j, M, rows_per_slice);
    // acc[4 j + e]: column tile j of 8; e = 0, 1 row g, e = 2, 3 row g + 8 of
    // this warp's 16 rows; columns 2t, 2t + 1 of the tile.
    float acc[kDwCols / 2];
#pragma unroll
    for (int i = 0; i < kDwCols / 2; ++i) acc[i] = 0.0f;
    int previous = -1;
    for (int r = u.r0; r < u.r1; r += kDwStep) {
      mbarrier_wait(&full[stage], parity);
      const unsigned char* st = smem + stage * kDwStageBytes;
      const uint64_t desc_a = wgmma_descriptor_mn_sw128(st + group * kDwBox, kDwBox);
      const uint64_t desc_b = wgmma_descriptor_mn_sw128(st + kDwABytes, kDwBox);
      wgmma_pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDwStep / 16; ++kk)  // 16 rows of K: 2,048 bytes, 128 units
        wgmma_m64n256k16_mn_ab(acc, desc_a + 128 * kk, desc_b + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: hand it back
      if (previous >= 0 && lane == 0) mbarrier_arrive(&empty[previous]);
      previous = stage;
      if (++stage == kDwStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    if (previous >= 0 && lane == 0) mbarrier_arrive(&empty[previous]);
    wgmma_pin(acc);

    // An empty slice (more slices than steps) writes its zeros all the same.
    float* out = dst + static_cast<long>(u.slice) * I * J;
    const int row_lo = u.i0 + group * 64 + warp * 16 + g;
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int j = 0; j < kDwCols / 8; ++j) {
      const int col = u.j0 + j * 8 + 2 * t;
      if (col >= J) continue;  // J is even: a pair is in or out whole
      if (row_lo < I)
        *reinterpret_cast<float2*>(out + static_cast<long>(row_lo) * J + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row_hi < I)
        *reinterpret_cast<float2*>(out + static_cast<long>(row_hi) * J + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// out[k] = part[k] + part[n + k] + ... + part[(slices - 1) n + k], in slice
// order, four floats a thread at a time; n4 = n / 4.
__global__ void __launch_bounds__(256)
dw_slice_sum_kernel(const float4* __restrict__ part, int slices, long n4, float4* __restrict__ out) {
  for (long k = blockIdx.x * 256L + threadIdx.x; k < n4; k += static_cast<long>(gridDim.x) * 256) {
    float4 s = part[k];
    for (int i = 1; i < slices; ++i) {
      const float4 v = part[i * n4 + k];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[k] = s;
  }
}

// The slice count of the fewest estimated nanoseconds: rounds of units on the
// SMs times the steps of a unit (560 ns a 64-row step of a 128 x 256 tile at
// the tensor cores' peak an SM), plus the partials' traffic past one slice
// (written, then read by the sum: 2 * slices * I * J * 4 bytes at 3,350
// bytes a nanosecond).
int choose_slices(int M, int I, int J, int sms) {
  const long tiles = static_cast<long>((I + kDwRows - 1) / kDwRows) * ((J + kDwCols - 1) / kDwCols);
  const int steps = (M + kDwStep - 1) / kDwStep;
  int best = 1;
  double best_ns = 0.0;
  for (int s = 1; s <= steps && s <= 64; ++s) {
    const long rounds = (tiles * s + sms - 1) / sms;
    const double ns = static_cast<double>(rounds) * ((steps + s - 1) / s) * 560.0 +
                      (s > 1 ? 8.0 * s * I * static_cast<double>(J) / 3350.0 : 0.0);
    if (s == 1 || ns < best_ns) {
      best = s;
      best_ns = ns;
    }
  }
  return best;
}

}  // namespace

// The slice count ssl4polyp_dw_product's callers size their partials by, for
// M rows and an (I, J) dW on the current device; negative: a CUDA error.
extern "C" int ssl4polyp_dw_product_slices(int M, int I, int J) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return choose_slices(M, I, J, sms);
}

// dW (I, J) fp32 = a^T . b for a (M, I) and b (M, J) bf16, row-major,
// contiguous, 16-byte aligned; I and J multiples of 8.  `part` holds `slices`
// (I, J) fp32 partials.  `parts` says what runs: 1 the products (into part,
// or with one slice into dw itself), 2 the sum of the slices into dw (nothing
// with one slice); 3 both.  Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_dw_product(const void* a, const void* b, void* part, void* dw, int M, int I,
                                    int J, int slices, int parts, void* stream) {
  if (M < 1 || I < 8 || J < 8 || I % 8 || J % 8 || slices < 1 || (parts & ~3))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slices == 1 ? dw : part);
  cudaError_t err = cudaSuccess;
  if (parts & kDwProducts) {
    CUtensorMap map_a, map_b;
    err = make_tensor_map_sw128(&map_a, a, M, I, kDwStep);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = make_tensor_map_sw128(&map_b, b, M, J, kDwStep);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int steps = (M + kDwStep - 1) / kDwStep;
    const int rows_per_slice = (steps + slices - 1) / slices * kDwStep;
    const long units = static_cast<long>((I + kDwRows - 1) / kDwRows) * ((J + kDwCols - 1) / kDwCols) *
                       slices;
    const int blocks = static_cast<int>(units < sms ? units : sms);
    static bool configured[kMaxDevices] = {};
    err = allow_dynamic_smem(dw_product_kernel, kDwSmemBytes, configured);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw_product_kernel<<<blocks, kDwThreads, kDwSmemBytes, st>>>(map_a, map_b, dst, M, I, J, slices,
                                                                rows_per_slice);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((parts & kDwSum) && slices > 1) {
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long n4 = static_cast<long>(I) * J / 4;
    const long want = (n4 + 255) / 256;
    const int blocks = static_cast<int>(want < 8L * sms ? want : 8L * sms);
    dw_slice_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(part), slices, n4,
                                                static_cast<float4*>(dw));
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
