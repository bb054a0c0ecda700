// Device helpers shared by the port's kernels: bf16 packing, the mma.sync
// m16n8k16 product with its ldmatrix and cp.async feeds, the quad transpose
// that turns accumulator fragments into 16-byte stores, a warp sum, the
// LayerNorm prologue of the fused kernels, the device's SM count, and a
// deterministic column sum.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t):
//   A (16x16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                         a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same cols);
//   B (16x8, column-major): b0 (rows 2t, 2t+1 of col g), b1 (rows 2t+8, 2t+9);
//   C (16x8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_halves(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 2^x on the special function unit (ex2.approx.ftz: about 2^-22 relative).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 out.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives its mma fragment of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ldmatrix_x4 with each 8x8 matrix transposed on the way: for an operand
// whose reduction index runs down the rows in shared memory.  Lane l gives
// the address of row l % 8 of matrix l / 8 as stored; thread (g, t) receives
// the stored elements (2t, g) and (2t + 1, g) of each matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two 8x8 bf16 matrices; lanes 0-15 give the addresses (row l % 8 of matrix
// l / 8), the other lanes' addresses are ignored.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// 16-byte global -> shared copy; copies `bytes` (0 or 16) and zero-fills the rest.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A 4 x 4 transpose across the four lanes of a quad (lane = 4g + t): lane t
// gives a[0..3] and receives, in a[i], what lane i of its quad held in a[t].
// With a[i] the packed pair of accumulator column tile i (columns 2t, 2t + 1
// of its 8), lane t ends with the 8 contiguous columns of tile t: 16 bytes to
// store.  Every lane of the warp must call it.
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
  const bool odd = t & 1;
  uint32_t s0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[1], 1);
  uint32_t s1 = __shfl_xor_sync(0xffffffffu, odd ? a[2] : a[3], 1);
  if (odd) {
    a[0] = s0;
    a[2] = s1;
  } else {
    a[1] = s0;
    a[3] = s1;
  }
  const bool high = t & 2;
  s0 = __shfl_xor_sync(0xffffffffu, high ? a[0] : a[2], 2);
  s1 = __shfl_xor_sync(0xffffffffu, high ? a[1] : a[3], 2);
  if (high) {
    a[0] = s0;
    a[1] = s1;
  } else {
    a[2] = s0;
    a[3] = s1;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The exact-erf GELU in fp32.
__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// The LayerNorm prologue of the fused kernels (ln_linear, mlp_ln_fused), in
// place on `rows` bf16 rows of K values in shared memory (row stride `ld`):
// fp32 two-pass statistics over the whole row, m = (x - mean) * rsqrt(var +
// eps) * s + t in fp32, rounded once to bf16.  Warp w takes rows w, w +
// warps, ...; lane l the column pairs 2l, 2l + 64, ...  K is a multiple of 64.
// The caller synchronises before and after.
__device__ __forceinline__ void layernorm_rows_in_place(bf16* xs, int ld, int rows, int K,
                                                        const float* __restrict__ s,
                                                        const float* __restrict__ t, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const float inv_k = 1.0f / static_cast<float>(K);
  for (int r = warp; r < rows; r += warps) {
    bf16* row = xs + r * ld;
    float sum = 0.0f;
    for (int c = 2 * lane; c < K; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      sum += v.x + v.y;
    }
    const float mean = warp_sum(sum) * inv_k;
    float sq = 0.0f;
    for (int c = 2 * lane; c < K; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_k + eps);
    for (int c = 2 * lane; c < K; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      const float m0 = (v.x - mean) * rstd * s[c] + t[c];
      const float m1 = (v.y - mean) * rstd * s[c + 1] + t[c + 1];
      *reinterpret_cast<uint32_t*>(row + c) = pack_floats(m0, m1);
    }
  }
}

// Host: raises `kernel`'s dynamic shared memory limit to `bytes` the first
// time it is asked on each device (`done` is the call site's own record, one
// flag a device); the runtime call costs microseconds, and a launch follows
// every time.  Past kMaxDevices devices it just asks every time.
constexpr int kMaxDevices = 16;

template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

// The SMs of the current device, asked once a device.
inline cudaError_t sm_count(int* count) {
  static int known[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && known[device] > 0) {
    *count = known[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) known[device] = *count;
  return err;
}

constexpr int kColumnSumWarps = 8;

// out[c] = sum over r of part[r * cols + c], fp32, in an order fixed by the
// shape alone: warp w sums rows w, w + WARPS, ... of 32 columns, then warp 0
// adds the WARPS partial sums in warp order.  Reruns give the same bits,
// which float atomics would not.  A caller with hundreds of rows takes more
// warps (up to 32), so that each walks few rows with its loads in flight
// together.
template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
column_sum_kernel(const float* __restrict__ part, int rows, int cols, float* __restrict__ out) {
  __shared__ float partial[WARPS][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (col < cols) {
#pragma unroll 4
    for (int r = warp; r < rows; r += WARPS) acc += part[static_cast<long>(r) * cols + col];
  }
  partial[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += partial[w][lane];
    out[col] = total;
  }
}

template <int WARPS = kColumnSumWarps>
inline cudaError_t launch_column_sum(const float* part, int rows, int cols, float* out,
                                     cudaStream_t stream) {
  column_sum_kernel<WARPS><<<(cols + 31) / 32, 32 * WARPS, 0, stream>>>(part, rows, cols, out);
  return cudaGetLastError();
}

// Where one (image b, head h)'s rows of an attention's operands lie; the
// fp32 attention and the bf16 key tiles take the layout as a template
// parameter.  Row i of q, k and v, and of dq, dk and dv, is at base + at + i
// * ld; row i of the output and of dO at base + o + i * o_ld.  The fused
// layout (SEP false): one (B, N, 3D) qkv whose bases for q, k and v are qkv,
// qkv + D and qkv + 2D (sections_of; dqkv likewise), the output and dO (B,
// N, D).  The separate layout (SEP true, fused_attention's): every operand
// (B, H, N, hd).
template <bool SEP>
struct HeadRows {
  long at, ld, o, o_ld;
  __device__ HeadRows(int b, int h, int N, int H, int HD)
      : at(SEP ? (static_cast<long>(b) * H + h) * N * HD
               : static_cast<long>(b) * N * 3 * H * HD + h * HD),
        ld(SEP ? HD : 3L * H * HD),
        o(SEP ? at : static_cast<long>(b) * N * H * HD + h * HD),
        o_ld(SEP ? HD : static_cast<long>(H) * HD) {}
};

// A launch's q, k and v (or dq, dk and dv): the bases HeadRows offsets.
template <typename T>
struct Sections {
  T *q, *k, *v;
};

// The sections of a fused (B, N, 3 * H * head_dim) qkv or dqkv.
template <typename T>
inline Sections<T> sections_of(T* qkv, int H, int head_dim) {
  const long D = static_cast<long>(H) * head_dim;
  return {qkv, qkv + D, qkv + 2 * D};
}

}  // namespace
