// The register-tiled fp32 SGEMM that fc1_gelu_f32.cu, ln_linear_f32.cu,
// attn_proj_f32.cu and attention_block_f32.cu share: C = A . B^T over (M, K)
// rows of A and (N, K) rows of B, on the CUDA cores (FFMA, fp32
// accumulation; no TF32, no split into bf16 terms: wgmma has no fp32 operand
// type).
//
//   * A block of 256 threads computes a 128 x 128 tile of C, each thread an
//     8 x 8 sub-tile (two 4-row by two 4-column groups, so that its reads of
//     shared memory are 16-byte and the tile's stores are too), in 64
//     registers of accumulators.
//   * A k-step of 8 is one 16-byte piece a thread of each operand, staged
//     through registers into one of two shared buffers, [k][row], while the
//     other buffer's step is multiplied: one barrier a step.  The next
//     step's loads and stores are unconditional (loads past the range are
//     predicated off and stage zeros, into a buffer nobody reads after the
//     last step): behind an `if (more)` the compiler sank the loads below
//     the products, which then waited out their latency every step (15 % of
//     fc1+GELU's time on an H100).  Each operand is read in one of two
//     layouts:
//       - KMajor: element (row, k) is component k % 4 of `load(row, k)`'s
//         16-byte piece (row, k .. k + 3), as the caller defines it (a row of
//         memory, or x normalised as it is staged).  A thread takes row
//         tid / 2, k offsets (tid % 2) * 4, and stores the piece transposed.
//         A piece is whole or wholly past the range: K (and each slice's
//         bounds) a multiple of 4.
//       - MNMajor: element (row, k) at p[k * ld + row] (a transposed
//         operand: torch's (out, in) weight read as (in, out), or the rows of
//         an activation as the columns of its transpose).  A thread takes k
//         offset tid / 32 and rows (tid % 32) * 4 .. + 3, one 16-byte piece
//         stored as it is; k at or past the slice's end stages zeros, so any
//         K runs.  Rows a multiple of 4, ld a multiple of 4.
//     Rows past an operand's `rows` stage zeros and are never stored.
//   * `epilogue(row, col, acc)` receives the fp32 sums of C's columns
//     col .. col + 3 of each row below M (N is a multiple of 4, so a group
//     of 4 is whole or wholly past N).
//   * Split-K (sgemm_f32_split): slice z of the grid's third dimension sums
//     k in [z chunk, (z + 1) chunk) into its own (M, N) tile of a scratch the
//     wrapper allocates, chunk = 8 * ceil(K / (8 slices)); a second launch
//     adds the slices in slice order.  No atomics: reruns give the same bits
//     (F8 in ROADMAP.md §3).  For a weight gradient summed over 12,608 rows,
//     whose 36 or 108 output tiles would fill a fraction of 132 SMs.
// Each output (or slice) is the FFMA chain over k in ascending order, so
// reruns give the same bits.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kSgemmBM = 128;
constexpr int kSgemmBN = 128;
constexpr int kSgemmBK = 8;
constexpr int kSgemmThreads = 256;
// Least k a split-K slice takes: each slice then streams at least 64 steps.
constexpr int kSgemmMinSliceK = 512;
constexpr int kSgemmMaxSlices = 32;

using SgemmStage = float[kSgemmBK][kSgemmBM];

// The 16-byte piece (row, k .. k + 3) of a row-major (rows, ld) matrix.
struct RowLoad {
  const float* p;
  long ld;
  __device__ __forceinline__ float4 operator()(int row, int k) const {
    return *reinterpret_cast<const float4*>(p + static_cast<long>(row) * ld + k);
  }
};

// Each layout hands the tile a per-thread cursor over its rows, made once
// before the k loop: the thread's row (clamped to 0 past `rows`) and
// offsets, so that a step's fetch is one predicated 16-byte load (zeros past
// `rows` or past the range's end).
template <class Load>
struct KMajor {
  Load load;
  int rows;
  struct Cursor {
    const Load& load;
    int row, k;
    bool ok;
    __device__ __forceinline__ float4 fetch(int k0, int k_end) const {
      return ok && k0 + k < k_end ? load(row, k0 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  __device__ __forceinline__ Cursor cursor(int r0) const {
    const int row = r0 + (threadIdx.x >> 1);
    const bool ok = row < rows;
    return Cursor{load, ok ? row : 0, static_cast<int>(threadIdx.x & 1) * 4, ok};
  }
  __device__ __forceinline__ void stage(SgemmStage& s, float4 v) const {
    const int row = threadIdx.x >> 1, k = (threadIdx.x & 1) * 4;
    s[k + 0][row] = v.x;
    s[k + 1][row] = v.y;
    s[k + 2][row] = v.z;
    s[k + 3][row] = v.w;
  }
};

template <class Load>
__host__ __device__ __forceinline__ KMajor<Load> k_major(Load load, int rows) {
  return KMajor<Load>{load, rows};
}

struct MNMajor {
  const float* p;
  long ld;
  int rows;
  struct Cursor {
    const float* src;  // the thread's 4 rows at k offset 0
    long ld;
    int k;
    bool ok;
    __device__ __forceinline__ float4 fetch(int k0, int k_end) const {
      return ok && k0 + k < k_end
                 ? *reinterpret_cast<const float4*>(src + static_cast<long>(k0 + k) * ld)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  __device__ __forceinline__ Cursor cursor(int r0) const {
    const int row = r0 + static_cast<int>(threadIdx.x & 31) * 4;
    const bool ok = row < rows;
    return Cursor{p + (ok ? row : 0), ld, static_cast<int>(threadIdx.x >> 5), ok};
  }
  __device__ __forceinline__ void stage(SgemmStage& s, float4 v) const {
    *reinterpret_cast<float4*>(&s[threadIdx.x >> 5][(threadIdx.x & 31) * 4]) = v;
  }
};

// The block's 128 x 128 tile (blockIdx.y over A's rows, blockIdx.x over B's)
// of A . B^T summed over k in [k_begin, k_end).
template <class A, class B, class Epilogue>
__device__ __forceinline__ void sgemm_f32_tile(const A& a, const B& b, int k_begin, int k_end,
                                               Epilogue epilogue) {
  __shared__ __align__(16) float s_a[2][kSgemmBK][kSgemmBM];
  __shared__ __align__(16) float s_b[2][kSgemmBK][kSgemmBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kSgemmBM;
  const int n0 = blockIdx.x * kSgemmBN;

  // The thread's outputs: rows r0 + {0..3} and r0 + 64 + {0..3}, columns
  // c0 + {0..3} and c0 + 64 + {0..3} of the tile.
  const int r0 = (tid / 16) * 4;
  const int c0 = (tid % 16) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const auto a_cur = a.cursor(m0);
  const auto b_cur = b.cursor(n0);
  float4 a_next = a_cur.fetch(k_begin, k_end);
  float4 b_next = b_cur.fetch(k_begin, k_end);
  a.stage(s_a[0], a_next);
  b.stage(s_b[0], b_next);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kSgemmBK) {
    a_next = a_cur.fetch(k0 + kSgemmBK, k_end);
    b_next = b_cur.fetch(k0 + kSgemmBK, k_end);
#pragma unroll
    for (int kk = 0; kk < kSgemmBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&s_a[buf][kk][r0]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&s_a[buf][kk][r0 + 64]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&s_b[buf][kk][c0]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&s_b[buf][kk][c0 + 64]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    a.stage(s_a[buf ^ 1], a_next);
    b.stage(s_b[buf ^ 1], b_next);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + r0 + (i & 3) + (i >> 2) * 64;
    if (row >= a.rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + c0 + half * 64;
      if (col >= b.rows) continue;
      epilogue(row, col, make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                                     acc[i][4 * half + 2], acc[i][4 * half + 3]));
    }
  }
}

// C (a.rows, b.rows) row-major = A . B^T over k < K, plus `bias` (b.rows,)
// on every row when it is not null (after the sum, as torch's matmul + b).
template <class A, class B>
__global__ void __launch_bounds__(kSgemmThreads, 2)
sgemm_f32_kernel(A a, B b, const float* __restrict__ bias, float* __restrict__ c, int K) {
  const long ldc = b.rows;
  sgemm_f32_tile(a, b, 0, K, [&](int row, int col, float4 acc) {
    if (bias != nullptr) {
      const float4 v = *reinterpret_cast<const float4*>(bias + col);
      acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
    }
    *reinterpret_cast<float4*>(c + row * ldc + col) = acc;
  });
}

// Slice blockIdx.z of the split: k in [z chunk, min(K, (z + 1) chunk)) into
// part + z * rows * cols.
template <class A, class B>
__global__ void __launch_bounds__(kSgemmThreads, 2)
sgemm_f32_slice_kernel(A a, B b, float* __restrict__ part, int K, int chunk) {
  const long ldc = b.rows;
  const int k_begin = blockIdx.z * chunk;
  float* c = part + static_cast<long>(blockIdx.z) * a.rows * ldc;
  sgemm_f32_tile(a, b, k_begin, min(K, k_begin + chunk), [&](int row, int col, float4 acc) {
    *reinterpret_cast<float4*>(c + row * ldc + col) = acc;
  });
}

// out = part[0] + part[1] + ... + part[slices - 1], added in slice order, 16
// bytes a thread.
__global__ void __launch_bounds__(256)
sgemm_f32_slice_sum_kernel(const float4* __restrict__ part, long count, int slices,
                           float4* __restrict__ out) {
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    float4 s = part[i];
    for (int z = 1; z < slices; ++z) {
      const float4 v = part[z * count + i];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    out[i] = s;
  }
}

inline dim3 sgemm_f32_grid(int rows, int cols, int slices = 1) {
  return dim3((cols + kSgemmBN - 1) / kSgemmBN, (rows + kSgemmBM - 1) / kSgemmBM, slices);
}

template <class A, class B>
cudaError_t launch_sgemm_f32(const A& a, const B& b, const float* bias, float* c, int K,
                             cudaStream_t stream) {
  sgemm_f32_kernel<<<sgemm_f32_grid(a.rows, b.rows), kSgemmThreads, 0, stream>>>(a, b, bias, c, K);
  return cudaGetLastError();
}

// The k each slice of a split takes (a multiple of 8).
inline int sgemm_f32_chunk(int K, int slices) {
  return ((K + slices - 1) / slices + kSgemmBK - 1) / kSgemmBK * kSgemmBK;
}

// The slices a split over K takes for a (rows, cols) output: enough to give
// two blocks to every SM, each slice at least kSgemmMinSliceK deep.
inline cudaError_t sgemm_f32_slices(int rows, int cols, int K, int* slices) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = ((rows + kSgemmBM - 1) / kSgemmBM) * ((cols + kSgemmBN - 1) / kSgemmBN);
  *slices = std::max(1, std::min({2 * sms / std::max(tiles, 1), K / kSgemmMinSliceK,
                                   kSgemmMaxSlices}));
  return cudaSuccess;
}

// C (a.rows, b.rows) = A . B^T over k < K, split into `slices` slices of
// sgemm_f32_chunk(K, slices): part is (slices, a.rows, b.rows) fp32 scratch
// (unused, and may be null, with one slice).  a.rows * b.rows a multiple of 4.
template <class A, class B>
cudaError_t launch_sgemm_f32_split(const A& a, const B& b, float* part, float* c, int K,
                                   int slices, cudaStream_t stream) {
  if (slices <= 1) return launch_sgemm_f32(a, b, nullptr, c, K, stream);
  sgemm_f32_slice_kernel<<<sgemm_f32_grid(a.rows, b.rows, slices), kSgemmThreads, 0, stream>>>(
      a, b, part, K, sgemm_f32_chunk(K, slices));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long count = static_cast<long>(a.rows) * b.rows / 4;
  const int blocks = static_cast<int>(std::min((count + 255) / 256, 4096L));
  sgemm_f32_slice_sum_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                         count, slices,
                                                         reinterpret_cast<float4*>(c));
  return cudaGetLastError();
}

}  // namespace
