// Attention straight from the fused QKV projection, forward only.
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel (fused_qkv_attention)
// and ::_fwd_bias_kernel (fused_qkv_bias_attention); the optional bias
// argument covers the second.
//
// What bounds it on the H100: at the eval path's shape (B 64, N 197, 12 heads
// of 64) a call is 7.6 GFLOP against 78 MB of compulsory traffic (QKV in,
// output out), about 100 FLOP per byte, below the ~295 of the H100's data
// sheet ridge: the floor is HBM traffic.  At ViT lengths (N <= 256)
// one (batch, head) pair's keys and values fit in shared memory, so the
// (N, N) scores never leave the SM.  The TPU kernel stacked heads to
// amortise its fixed per-dot overhead; here every block simply owns one
// (batch, head, 64-query tile) and the 132 SMs run thousands of such blocks.
// Each query tile re-reads its head's K and V (from L2 after the first), and
// the synchronous staging loads are not overlapped with the products: this
// simple form is bound by load latency more than by either roofline.
//
// The simple design: one block of 4 warps per (query tile of 64 rows, head,
// batch row).  The block copies the head's Q tile, all of K and all of V
// from the (B, N, 3D) input into shared memory (adding the bias and folding
// the 1/sqrt(hd) scale into Q in bf16, as the TPU kernel does), zero-padding
// keys to a multiple of 16.  Each warp then owns 16 query rows: it forms the
// whole score row in registers with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), masks keys >= valid_len to -inf, optionally rounds the
// scores to bf16, takes an exact softmax over the full row (no online
// rescaling is needed because the row is whole), rounds the weights to bf16
// and multiplies by V with mma.sync.  The score fragments are reused as the
// A operand of the second product without leaving registers.  Later work:
// ldmatrix, cp.async or TMA loads, and wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kTileRows = 16 * kWarps;  // query rows per block

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

// Copies `rows` rows of one head's HD columns into shared memory (row stride
// HD + 8 elements, which keeps the fragment loads free of bank conflicts).
// Rows at or past N are zero.  With `bias`, x + bias is rounded to bf16;
// with `fold_scale`, the result is then multiplied by `scale` and rounded
// again: the compute-dtype scale fold of the TPU kernel.
template <int HD>
__device__ void stage_rows(bf16* dst, int rows, const bf16* src, int row0, int N,
                           long ld, const bf16* bias, float scale, bool fold_scale) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kLd = HD + 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int n = row0 + r;
    uint4 chunk = make_uint4(0, 0, 0, 0);
    if (n < N) {
      chunk = *reinterpret_cast<const uint4*>(src + n * ld + c);
      if (bias != nullptr || fold_scale) {
        bf16* e = reinterpret_cast<bf16*>(&chunk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = __bfloat162float(e[j]);
          if (bias != nullptr) x = round_bf16(x + __bfloat162float(bias[c + j]));
          if (fold_scale) x = x * scale;
          e[j] = __float2bfloat16(x);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = chunk;
  }
}

// NKT: key tiles of 16; the kernel takes N <= 16 * NKT.
template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kWarps)
qkv_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                     bf16* __restrict__ out, int N, int H, int n_valid, float scale,
                     int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kTileRows * kLd;
  bf16* s_v = s_k + kPad * kLd;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int D = H * HD;
  const long ld = 3L * D;
  const bf16* base = qkv + static_cast<long>(b) * N * ld + h * HD;
  const bf16* bias_q = bias == nullptr ? nullptr : bias + h * HD;
  const bf16* bias_k = bias == nullptr ? nullptr : bias + D + h * HD;
  const bf16* bias_v = bias == nullptr ? nullptr : bias + 2 * D + h * HD;
  stage_rows<HD>(s_q, kTileRows, base, q0, N, ld, bias_q, scale, true);
  stage_rows<HD>(s_k, kPad, base + D, 0, N, ld, bias_k, 1.0f, false);
  stage_rows<HD>(s_v, kPad, base + 2 * D, 0, N, ld, bias_v, 1.0f, false);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = warp * 16;
  if (q0 + r0 >= N) return;  // no barrier follows

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* p = s_q + (r0 + g) * kLd + kk * 16 + 2 * t;
    qa[kk][0] = load_u32(p);
    qa[kk][1] = load_u32(p + 8 * kLd);
    qa[kk][2] = load_u32(p + 8);
    qa[kk][3] = load_u32(p + 8 * kLd + 8);
  }

  // Scores: s[j] holds keys j*8 .. j*8+7; elements 0,1 are row g, 2,3 row g+8.
  float s[2 * NKT][4];
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bf16* p = s_k + (j * 8 + g) * kLd + kk * 16 + 2 * t;
      mma_16816(s[j], qa[kk], load_u32(p), load_u32(p + 8));
    }
  }

  float max0 = -INFINITY, max1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      float x = col < n_valid ? s[j][e] : -INFINITY;
      if (!softmax_f32) x = round_bf16(x);
      s[j][e] = x;
    }
    max0 = fmaxf(max0, fmaxf(s[j][0], s[j][1]));
    max1 = fmaxf(max1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    max0 = fmaxf(max0, __shfl_xor_sync(0xffffffffu, max0, off));
    max1 = fmaxf(max1, __shfl_xor_sync(0xffffffffu, max1, off));
  }
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
    s[j][0] = expf(s[j][0] - max0);
    s[j][1] = expf(s[j][1] - max0);
    s[j][2] = expf(s[j][2] - max1);
    s[j][3] = expf(s[j][3] - max1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  const float inv0 = 1.0f / sum0;
  const float inv1 = 1.0f / sum1;

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    // The weights, normalised then rounded to bf16, as the A operand.
    const uint32_t pa[4] = {
        pack_floats(s[2 * kt][0] * inv0, s[2 * kt][1] * inv0),
        pack_floats(s[2 * kt][2] * inv1, s[2 * kt][3] * inv1),
        pack_floats(s[2 * kt + 1][0] * inv0, s[2 * kt + 1][1] * inv0),
        pack_floats(s[2 * kt + 1][2] * inv1, s[2 * kt + 1][3] * inv1),
    };
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const bf16* p = s_v + (kt * 16 + 2 * t) * kLd + n * 8 + g;
      mma_16816(o[n], pa, pack_halves(p[0], p[kLd]), pack_halves(p[8 * kLd], p[9 * kLd]));
    }
  }

  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  bf16* out_a = out + (static_cast<long>(b) * N + row_a) * D + h * HD + 2 * t;
  bf16* out_b = out_a + 8L * D;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row_a < N) *reinterpret_cast<uint32_t*>(out_a + n * 8) = pack_floats(o[n][0], o[n][1]);
    if (row_b < N) *reinterpret_cast<uint32_t*>(out_b + n * 8) = pack_floats(o[n][2], o[n][3]);
  }
}

template <int HD, int NKT>
cudaError_t launch(const bf16* qkv, const bf16* bias, bf16* out, int B, int N, int H,
                   int n_valid, float scale, int softmax_f32, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTileRows + 2 * NKT * 16) * (HD + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileRows - 1) / kTileRows, H, B);
  qkv_attention_kernel<HD, NKT><<<grid, 32 * kWarps, smem, stream>>>(
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

}  // namespace

// qkv: (B, N, 3*H*hd) bf16, [q heads | k heads | v heads]; bias: (3*H*hd,)
// bf16 or null; out: (B, N, H*hd) bf16.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_fwd(const void* qkv, const void* bias, void* out,
                                           int B, int N, int H, int head_dim, int n_valid,
                                           float scale, int softmax_f32, void* stream) {
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
