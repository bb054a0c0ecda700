// LayerNorm over the last axis of a bf16 or fp32 (M, D) activation, forward
// and backward, with fp32 statistics and fp32 affine parameters.
//
// Replaces: ssl4polyp_tpu/ops/layernorm.py::_fwd_kernel and _bwd_kernel (the
// 3-D variants), _fwd2_kernel and _bwd2_kernel (the 2-D variants), and so
// layernorm_fused_view too: LayerNorm does not depend on the order of the
// rows, so one kernel over M rows covers every shape.
//
// What bounds it on the H100: a few FLOPs per element against 4 (forward) or
// 6 (backward) bytes of bf16 traffic per element: HBM bandwidth.  The design
// reads each row once and writes once: one warp owns a row, holds it in
// registers (D / 32 values a lane), and takes the two-pass fp32 mean and
// variance from registers with warp shuffles, as the TPU kernel takes them
// from VMEM.  Loads and stores are 16 bytes a lane.
//
// The backward recomputes the statistics (nothing but x is saved), writes dx
// in bf16 and sums dscale = sum(dy * xhat) and dbias = sum(dy) over every row
// in fp32.  The TPU kernel carried those sums across its sequential grid.
// Here a block's tail (its warps' sums added through shared memory, a partial
// stored) must be paid rarely, and enough bytes must be in flight:
//   * A persistent grid, two blocks of 8 warps an SM up to D 768 (one above):
//     warp w of the grid walks rows w, w + warps, ... and keeps its dscale and
//     dbias sums in registers across all of them, so the block's warp-order
//     sum through shared memory and its partial store happen once, and the
//     partial is (blocks, 2, D) with at most 264 blocks on 132 SMs.
//   * Rows arrive by cp.async into a ring of the warp's own in shared memory
//     (x, dy and, for the residual variant, dres; six rows a warp: three
//     stages without dres, two with), each lane copying the 16-byte chunks it
//     will read itself, so its own wait_group is all the ordering it needs.
//     The rows one and two turns ahead are in flight while the current one is
//     worked on: up to 96 KB outstanding an SM.  The weight sits in shared
//     memory, not in registers.
//   * Registers (ptxas, sm_90a): 121 a thread at D 768 (127 with dres), 96
//     at D 512, under __launch_bounds__(256, 2), no spills at any D: 16 warps
//     an SM stay resident; 150-244 above D 768, where one block an SM runs.
//   * column_sum_kernel, 32 warps a block here, adds the blocks' partials in
//     block order: the result depends on the shape alone, never on scheduling.
// The statistics are two-pass fp32 from the row in registers, dx is rounded
// once (after + dres), dscale and dbias are fp32 sums of the same products.
//
// fp32 activations (the `amp: false` runs) take the same kernels, templated on
// the element type: a lane's chunk is still 8 columns, two 16-byte pieces of
// fp32 where bf16 takes one, so the registers, the statistics and the sums'
// order are the bf16 kernels'.  Twice the bytes a row in the ring: at D 768 a
// block of 8 warps with six rows each takes 150 KB, so one block an SM (the
// same 96 KB in flight as bf16's two), two up to D 512; past D 1024 a warp
// keeps three rows (one stage: no prefetch) to stay under 227 KB.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

// Rows of shared memory a backward warp owns: six (three stages of x and dy,
// two with dres), three for fp32 rows past D 1024.
template <typename T>
__host__ __device__ constexpr int bwd_ring_rows(int chunks) {
  return sizeof(T) == 2 || chunks <= 4 ? 6 : 3;
}

// Blocks an SM of the backward's persistent grid: the dscale and dbias sums
// are 16 registers a thread for every 256 columns, and two blocks of 256
// threads leave a thread 128; fp32 rings take two blocks' shared memory up to
// D 512 only.
template <typename T>
__host__ __device__ constexpr int bwd_blocks_per_sm(int chunks) {
  return chunks <= (sizeof(T) == 2 ? 3 : 2) ? 2 : 1;
}

// Eight values of a row as they lie in memory: one 16-byte piece of bf16,
// two of fp32.
template <typename T>
struct Raw8 {
  uint4 piece[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> zero_raw() {
  Raw8<T> r;
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k) r.piece[k] = make_uint4(0, 0, 0, 0);
  return r;
}

// 16-byte-aligned global or shared memory.
template <typename T>
__device__ __forceinline__ Raw8<T> load_raw(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k)
    r.piece[k] = reinterpret_cast<const uint4*>(p)[k];
  return r;
}

// Eight bf16 values (16 bytes) as fp32.
__device__ __forceinline__ void unpack8(float (&v)[8], const Raw8<bf16>& raw) {
  const uint4& chunk = raw.piece[0];
  const uint32_t p[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(p[j] << 16);
    v[2 * j + 1] = __uint_as_float(p[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack8(float (&v)[8], const Raw8<float>& raw) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    v[4 * k] = __uint_as_float(raw.piece[k].x);
    v[4 * k + 1] = __uint_as_float(raw.piece[k].y);
    v[4 * k + 2] = __uint_as_float(raw.piece[k].z);
    v[4 * k + 3] = __uint_as_float(raw.piece[k].w);
  }
}

// Eight fp32 values rounded once to the row's type and stored (16-byte aligned).
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 packed;
  packed.x = pack_floats(v[0], v[1]);
  packed.y = pack_floats(v[2], v[3]);
  packed.z = pack_floats(v[4], v[5]);
  packed.w = pack_floats(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = packed;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight values of a row, global -> shared, in 16-byte cp.async pieces.
template <typename T>
__device__ __forceinline__ void cp_async_8(T* dst, const T* src) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a piece
#pragma unroll
  for (int k = 0; k < 8 / kPer; ++k) cp_async_16(dst + k * kPer, src + k * kPer, 16);
}

// Loads lane's chunks (chunk c = lane + 32 i covers columns 8c .. 8c+7) of a
// row into fp32 registers; chunks past D are zero.
template <int CHUNKS, typename T>
__device__ __forceinline__ void load_row(float (&v)[CHUNKS][8], const T* row, int D, int lane) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    Raw8<T> chunk = zero_raw<T>();
    if (c < D) chunk = load_raw(row + c);
    unpack8(v[i], chunk);
  }
}

template <int CHUNKS, typename T>
__device__ __forceinline__ void store_row(T* row, const float (&v)[CHUNKS][8], int D, int lane) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < D) store8(row + c, v[i]);
  }
}

template <int CHUNKS>
__device__ __forceinline__ void load_params(float (&v)[CHUNKS][8], const float* p, int D, int lane) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (c < D) {
      lo = *reinterpret_cast<const float4*>(p + c);
      hi = *reinterpret_cast<const float4*>(p + c + 4);
    }
    v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = lo.z; v[i][3] = lo.w;
    v[i][4] = hi.x; v[i][5] = hi.y; v[i][6] = hi.z; v[i][7] = hi.w;
  }
}

// Two-pass fp32 statistics of a row held in registers: mean, then the mean
// of the squared deviations (the TPU kernel's order).  Chunks past D hold
// zeros and are left out of the second sum.
template <int CHUNKS>
__device__ __forceinline__ void row_stats(const float (&v)[CHUNKS][8], int D, int lane, float eps,
                                          float& mean, float& rstd) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[i][j];
  mean = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if ((lane + 32 * i) * 8 >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = v[i][j] - mean;
      sq += d * d;
    }
  }
  rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
}

template <int CHUNKS, typename T>
__global__ void __launch_bounds__(32 * kWarps)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                     const float* __restrict__ bias, T* __restrict__ y, int M, int D, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= M) return;  // no barrier in this kernel
  float v[CHUNKS][8];
  load_row<CHUNKS>(v, x + static_cast<long>(row) * D, D, lane);
  float mean, rstd;
  row_stats<CHUNKS>(v, D, lane, eps, mean, rstd);
  float w[CHUNKS][8], b[CHUNKS][8];
  load_params<CHUNKS>(w, weight, D, lane);
  load_params<CHUNKS>(b, bias, D, lane);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = (v[i][j] - mean) * rstd * w[i][j] + b[i][j];
  store_row<CHUNKS>(y + static_cast<long>(row) * D, v, D, lane);
}

// Eight fp32 values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// part: (gridDim.x, 2, D) fp32; row blk holds this block's [dscale | dbias].
// DRES: dres is added to dx in fp32 before its one rounding: the gradient of
// a residual folded into the consumer (mlp_ln_fused).  Dynamic shared memory:
// the weight (D floats), then each warp's ring of bwd_ring_rows rows of D
// values, which the block's partial sums ([kWarps][2][D] floats) reuse at the
// end.
template <int CHUNKS, bool DRES, typename T>
__global__ void __launch_bounds__(32 * kWarps, bwd_blocks_per_sm<T>(CHUNKS))
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const T* __restrict__ dres, const float* __restrict__ weight,
                     T* __restrict__ dx, float* __restrict__ part, int M, int D, float eps) {
  constexpr int kRingRows = bwd_ring_rows<T>(CHUNKS);
  constexpr int kRowsPerStage = DRES ? 3 : 2;
  constexpr int kStages = kRingRows / kRowsPerStage;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);
  T* s_rows = reinterpret_cast<T*>(s_w + D);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* ring = s_rows + static_cast<long>(warp) * kRingRows * D;
  const int warps_total = gridDim.x * kWarps;

  // This lane's chunks of row `r` into stage `stage`: x, dy and dres.
  auto request = [&](int r, int stage) {
    if (r >= M) return;
    T* dst = ring + stage * kRowsPerStage * D;
    const long at = static_cast<long>(r) * D;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= D) continue;
      cp_async_8(dst + c, x + at + c);
      cp_async_8(dst + D + c, dy + at + c);
      if (DRES) cp_async_8(dst + 2 * D + c, dres + at + c);
    }
  };

  int row = blockIdx.x * kWarps + warp;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    request(row + s * warps_total, s);
    cp_async_commit();
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) s_w[c] = weight[c];
  __syncthreads();

  float acc_s[CHUNKS][8], acc_b[CHUNKS][8];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_s[i][j] = acc_b[i][j] = 0.0f;

  int stage = 0;
  for (; row < M; row += warps_total) {
    // One group a turn, empty past the last row: the group of `row` is the
    // oldest of the kStages in flight.
    request(row + (kStages - 1) * warps_total, (stage + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const T* src = ring + stage * kRowsPerStage * D;
    float v[CHUNKS][8];
    Raw8<T> gq[CHUNKS];
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = (lane + 32 * i) * 8;
      Raw8<T> xq = zero_raw<T>();
      gq[i] = xq;
      if (c < D) {
        xq = load_raw(src + c);
        gq[i] = load_raw(src + D + c);
      }
      unpack8(v[i], xq);
    }
    float mean, rstd;
    row_stats<CHUNKS>(v, D, lane, eps, mean, rstd);
    // v <- xhat, then dxhat = dy * w; m1 = mean(dxhat), m2 = mean(dxhat * xhat).
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = (lane + 32 * i) * 8;
      float g[8], w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      unpack8(g, gq[i]);
      if (c < D) load8(w, s_w + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = (v[i][j] - mean) * rstd;
        const float dxhat = g[j] * w[j];
        m1 += dxhat;
        m2 += dxhat * v[i][j];
      }
    }
    m1 = warp_sum(m1) / static_cast<float>(D);
    m2 = warp_sum(m2) / static_cast<float>(D);
    T* out_row = dx + static_cast<long>(row) * D;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= D) continue;  // the chunk holds zeros and adds nothing below
      float g[8], w[8], out[8];
      unpack8(g, gq[i]);
      load8(w, s_w + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[j] = rstd * (g[j] * w[j] - m1 - v[i][j] * m2);
        acc_s[i][j] += g[j] * v[i][j];
        acc_b[i][j] += g[j];
      }
      if (DRES) {
        float res[8];
        unpack8(res, load_raw(src + 2 * D + c));
#pragma unroll
        for (int j = 0; j < 8; ++j) out[j] += res[j];
      }
      store8(out_row + c, out);
    }
    stage = (stage + 1) % kStages;
  }

  // The block's partial sums, its warps added in warp order: each warp lays
  // its sums down in the ring's space, then a thread adds a column's eight.
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring
  float* s_acc = reinterpret_cast<float*>(s_rows);  // [kWarps][2][D]
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= D) continue;
    float* mine = s_acc + static_cast<long>(warp) * 2 * D + c;  // 16-byte stores
    float4* to_s = reinterpret_cast<float4*>(mine);
    float4* to_b = reinterpret_cast<float4*>(mine + D);
    to_s[0] = make_float4(acc_s[i][0], acc_s[i][1], acc_s[i][2], acc_s[i][3]);
    to_s[1] = make_float4(acc_s[i][4], acc_s[i][5], acc_s[i][6], acc_s[i][7]);
    to_b[0] = make_float4(acc_b[i][0], acc_b[i][1], acc_b[i][2], acc_b[i][3]);
    to_b[1] = make_float4(acc_b[i][4], acc_b[i][5], acc_b[i][6], acc_b[i][7]);
  }
  __syncthreads();
  float* out = part + static_cast<long>(blockIdx.x) * 2 * D;
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_acc[w * 2 * D + c];
    out[c] = total;
  }
}

// The backward's grid: persistent, bwd_blocks_per_sm blocks an SM, and no
// more blocks than there are rows for their warps.
template <typename T>
inline cudaError_t bwd_grid(int M, int D, int* blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int wanted = (M + kWarps - 1) / kWarps;
  const int resident = sms * bwd_blocks_per_sm<T>((D + 255) / 256);
  *blocks = wanted < resident ? wanted : resident;
  return cudaSuccess;
}

template <int CHUNKS, typename T>
cudaError_t launch_fwd(const T* x, const float* w, const float* b, T* y, int M, int D,
                       float eps, cudaStream_t stream) {
  layernorm_fwd_kernel<CHUNKS, T><<<(M + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
      x, w, b, y, M, D, eps);
  return cudaGetLastError();
}

template <int CHUNKS, bool DRES, typename T>
cudaError_t launch_bwd_rows(const T* x, const T* dy, const T* dres, const float* w,
                            T* dx, float* part, int blocks, int M, int D, float eps,
                            cudaStream_t stream) {
  // The ring (bwd_ring_rows rows a warp) also holds the final sums
  // ([kWarps][2][D] floats): 12 (bf16) or 24 and 12 (fp32) against 8 bytes a
  // warp and column.
  constexpr size_t per_column =
      sizeof(float) + kWarps * bwd_ring_rows<T>(CHUNKS) * sizeof(T);
  const size_t smem = D * per_column;
  static bool configured[kMaxDevices] = {};  // allowed once, for the widest D of CHUNKS
  const cudaError_t err = allow_dynamic_smem(layernorm_bwd_kernel<CHUNKS, DRES, T>,
                                             256 * CHUNKS * per_column, configured);
  if (err != cudaSuccess) return err;
  layernorm_bwd_kernel<CHUNKS, DRES, T><<<blocks, 32 * kWarps, smem, stream>>>(
      x, dy, dres, w, dx, part, M, D, eps);
  return cudaGetLastError();
}

template <int CHUNKS, typename T>
cudaError_t launch_bwd(const T* x, const T* dy, const T* dres, const float* w, T* dx,
                       float* part, float* dparams, int M, int D, float eps, int parts,
                       cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = bwd_grid<T>(M, D, &blocks);
  if (err != cudaSuccess) return err;
  if (parts & 1)
    err = dres == nullptr
              ? launch_bwd_rows<CHUNKS, false>(x, dy, dres, w, dx, part, blocks, M, D, eps, stream)
              : launch_bwd_rows<CHUNKS, true>(x, dy, dres, w, dx, part, blocks, M, D, eps, stream);
  if (err != cudaSuccess || !(parts & 2)) return err;
  return launch_column_sum<32>(part, blocks, 2 * D, dparams, stream);
}

// Calls fn with std::integral_constant<int, CHUNKS>, the number of 8-element
// chunks a lane holds for rows of D columns (D <= 32 * 8 * 8 = 2048).
template <typename Fn>
cudaError_t dispatch_chunks(int D, Fn fn) {
  switch ((D + 255) / 256) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

// The C entry points of one element type.
template <typename T>
int layernorm_fwd(const void* x, const void* weight, const void* bias, void* y, int M, int D,
                  float eps, void* stream) {
  if (M < 1 || D < 8 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_chunks(D, [&](auto chunks) {
    return launch_fwd<decltype(chunks)::value>(
        static_cast<const T*>(x), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<T*>(y), M, D, eps,
        static_cast<cudaStream_t>(stream));
  }));
}

template <typename T>
int layernorm_bwd_blocks(int M, int D) {
  int blocks = 0;
  return bwd_grid<T>(M, D, &blocks) == cudaSuccess ? blocks : 0;
}

template <typename T>
int layernorm_bwd(const void* x, const void* dy, const void* dres, const void* weight, void* dx,
                  void* part, void* dparams, int M, int D, float eps, int parts, void* stream) {
  if (M < 1 || D < 8 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_chunks(D, [&](auto chunks) {
    return launch_bwd<decltype(chunks)::value>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const T*>(dres), static_cast<const float*>(weight),
        static_cast<T*>(dx), static_cast<float*>(part), static_cast<float*>(dparams), M, D,
        eps, parts, static_cast<cudaStream_t>(stream));
  }));
}

}  // namespace

// x, y: (M, D) bf16; weight, bias: (D,) fp32; D a multiple of 8, at most
// 2048.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_layernorm_fwd(const void* x, const void* weight, const void* bias,
                                       void* y, int M, int D, float eps, void* stream) {
  return layernorm_fwd<bf16>(x, weight, bias, y, M, D, eps, stream);
}

// The same with x and y fp32.
extern "C" int ssl4polyp_layernorm_fwd_f32(const void* x, const void* weight, const void* bias,
                                           void* y, int M, int D, float eps, void* stream) {
  return layernorm_fwd<float>(x, weight, bias, y, M, D, eps, stream);
}

// The blocks of the backward's grid for (M, D) rows on the current device:
// the rows of its `part` scratch.  0 if the device cannot be asked.
extern "C" int ssl4polyp_layernorm_bwd_blocks(int M, int D) {
  return layernorm_bwd_blocks<bf16>(M, D);
}

// The same for fp32 rows.
extern "C" int ssl4polyp_layernorm_bwd_blocks_f32(int M, int D) {
  return layernorm_bwd_blocks<float>(M, D);
}

// x, dy, dx and dres (or null): (M, D) bf16; weight: (D,) fp32; part:
// (ssl4polyp_layernorm_bwd_blocks(M, D), 2, D) fp32 scratch; dparams: (2, D)
// fp32, [dweight | dbias] summed over all M rows.  `parts` is 3 for the whole
// backward; 1 runs the row kernel alone (dx and part) and 2 the sum of part
// into dparams alone, for a caller that times them apart.  Returns the first
// failing launch's CUDA error.
extern "C" int ssl4polyp_layernorm_bwd(const void* x, const void* dy, const void* dres,
                                       const void* weight, void* dx, void* part, void* dparams,
                                       int M, int D, float eps, int parts, void* stream) {
  return layernorm_bwd<bf16>(x, dy, dres, weight, dx, part, dparams, M, D, eps, parts, stream);
}

// The same with x, dy, dx and dres fp32; part has
// ssl4polyp_layernorm_bwd_blocks_f32(M, D) rows.
extern "C" int ssl4polyp_layernorm_bwd_f32(const void* x, const void* dy, const void* dres,
                                           const void* weight, void* dx, void* part,
                                           void* dparams, int M, int D, float eps, int parts,
                                           void* stream) {
  return layernorm_bwd<float>(x, dy, dres, weight, dx, part, dparams, M, D, eps, parts, stream);
}
