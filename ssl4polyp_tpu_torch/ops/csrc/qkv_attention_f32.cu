// Attention straight from the fused QKV projection in fp32, forward and
// backward, for the runs that compute in fp32 (`amp: false`,
// PretrainSettings.precision "fp32").
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel, _bwd_kernel
// (fused_qkv_attention), ::_fwd_bias_kernel and _bwd_bias_kernel
// (fused_qkv_bias_attention) at compute dtype float32, where the TPU kernels
// take cdtype = qkv.dtype and every product is fp32.  The bf16 kernels
// (qkv_attention.cu) run on mma.sync, which has no fp32 operand type, so
// these are plain SIMT kernels: FFMA on the CUDA cores, fp32 accumulation,
// no TF32 and no split into bf16 terms.  The contract is the plain versions'
// in ops/qkv_attention.py: q = (qkv_q + bias_q) * scale, with the fp32 scale
// 1/sqrt(hd); scores q . k^T; keys at or past n_valid masked; an exact
// softmax over the whole row (expf, max, sum, divide); out = W . v.  The
// backward recomputes W, then dV = W^T dO, dW = dO V^T, tmp = rowsum(dW * W),
// dS = W * (dW - tmp), dQ = scale * dS K and dK = scale * dS^T Q (q
// unscaled), as the TPU kernel's _bwd_kernel does.
//
// What bounds them on the H100: at the classifier's shape (B 64, N 197, 12
// heads of 64) the forward is 7.6 GFLOP against 155 MB of compulsory traffic,
// 0.114 ms at the 67 TFLOP/s fp32 rate: operations, as is the backward with
// about three times the forward's products.  At N <= 256 one (image, head)
// pair's K and V fit in shared memory (128 KB in fp32 at hd 64), so the
// scores never leave the SM.  The design is simple rather than fast:
//   * One block of 8 warps per (head, image) stages the head's K (rows padded
//     to hd + 4 floats, so that lanes reading different rows in 16-byte
//     pieces hit different banks) and V once, the bias added on the way.
//   * A warp takes 4 query rows at a time.  Their scaled q rows go to a small
//     buffer of the warp's own; lane l holds the scores of keys l, l + 32,
//     ..., up to 8 keys for N <= 256, and forms them as FFMA chains over d in
//     ascending order, one 16-byte K piece a key feeding 16 products.
//   * The softmax of each row takes its max and sum with warp shuffles.  The
//     weights go to the warp's buffer transposed ([key][row], 16 bytes a
//     key), and for the product with V each lane owns hd / 32 columns of the
//     output: one V row and one 16-byte broadcast of the four rows' weights a
//     key.
//   * The backward runs two passes in one block, so that dK and dV are sums
//     over query rows in an order fixed by the shape, with no atomics.  Pass
//     1 is the forward's loop with dO staged beside q: it forms S and dW = dO
//     V^T together, keeps each row's max, sum and tmp in shared memory, and
//     writes dQ from dS through the warp's buffer.  Pass 2 stages Q (unscaled)
//     and dO in place of K and V, gives each lane query rows instead of keys
//     and each warp 4 key rows at a time, recomputes S and dW in the same
//     FFMA order (so W and dS are pass 1's bits), and writes dV = W^T dO and
//     dK = scale dS^T Q through the warp's buffers.  224 KB of shared memory
//     at N 256, hd 64.
//   * With a bias, each block then sums its head's dqkv columns over the
//     image's rows into one row of a (B, 3D) scratch, and a column sum adds
//     the B rows in order: dbias.
// Head dims 32 and 64; N <= 256.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;      // rows a warp takes at once (query rows; key rows in pass 2)
constexpr int kSlots = 8;     // rows a lane holds across the warp: N <= 32 * kSlots
constexpr int kMaxTokens = 32 * kSlots;
constexpr float kLowest = -3.402823466e38f;  // below every finite score

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// acc += a . b over four consecutive d, in ascending order.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One section (0 q, 1 k, 2 v) of head h's row i of qkv, columns c .. c + 3,
// with the bias added (the plain version's qkv + bias).
struct Head {
  const float* qkv;   // this image's (N, 3D) rows
  const float* bias;  // (3D,) or null
  int D, h, hd;

  __device__ __forceinline__ float4 load(int section, int i, int c) const {
    const int col = section * D + h * hd + c;
    float4 v = ld4(qkv + static_cast<long>(i) * 3 * D + col);
    if (bias != nullptr) v = add4(v, ld4(bias + col));
    return v;
  }
};

// Rows i0 .. i0 + kRows - 1 of a section into `dst` (kRows x HD), times
// `scale`; rows past N are zeros.  The calling warp only.
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const Head& head, int section, int i0,
                                           int N, float scale, int lane) {
  constexpr int kPieces = HD / 4;
  for (int p = lane; p < kRows * kPieces; p += 32) {
    const int r = p / kPieces, c = (p % kPieces) * 4;
    const int i = i0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < N) v = head.load(section, i, c);
    if (scale != 1.0f) v = mul4(v, scale);
    st4(dst + r * HD + c, v);
  }
}

// Rows 0 .. N - 1 of two sections into (N, HD + 4) buffers, by the block.
template <int HD>
__device__ __forceinline__ void stage_head(float* a, float* b, const Head& head, int sa, int sb,
                                           int N) {
  constexpr int kPieces = HD / 4, LD = HD + 4;
  for (int p = threadIdx.x; p < N * kPieces; p += blockDim.x) {
    const int i = p / kPieces, c = (p % kPieces) * 4;
    st4(a + i * LD + c, head.load(sa, i, c));
    st4(b + i * LD + c, head.load(sb, i, c));
  }
}

// Lane-owned rows (i = 32 t + lane) against the warp's kRows staged rows:
// out[r][t] = sum_d (rows[i][d] * row_scale) * staged[r][d], d ascending,
// for t < slots; `rows` is an (N, HD + 4) buffer, row N - 1 read in place of
// rows past N.  A pass that swaps the two operands forms the same FFMA chain,
// so the same bits.
template <int HD>
__device__ __forceinline__ void lane_rows_dot(float (&out)[kRows][kSlots], const float* rows,
                                              float row_scale, const float* staged, int N,
                                              int slots, int lane) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < kSlots; ++t) out[r][t] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < HD; c += 4) {
    float4 s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = ld4(staged + r * HD + c);
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      if (t >= slots) continue;  // uniform across the warp
      const int i = min(32 * t + lane, N - 1);
      float4 v = ld4(rows + i * LD + c);
      if (row_scale != 1.0f) v = mul4(v, row_scale);
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[r][t] = dot4(s[r], v, out[r][t]);
    }
  }
}

// acc[r][:] = sum over j < N of wt[j][r] * rows[j][lane's columns]: wt is
// (N, kRows) in shared memory, rows an (N, HD + 4) buffer.
template <int HD>
__device__ __forceinline__ void weighted_rows(float (&acc)[kRows][HD / 32], const float* wt,
                                              const float* rows, int N, int lane) {
  constexpr int LD = HD + 4, DPL = HD / 32;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0f;
  for (int j = 0; j < N; ++j) {
    const float4 p = ld4(wt + j * kRows);
    const float pr[kRows] = {p.x, p.y, p.z, p.w};
    float v[DPL];
    if constexpr (DPL == 2) {
      const float2 pair = *reinterpret_cast<const float2*>(rows + j * LD + 2 * lane);
      v[0] = pair.x;
      v[1] = pair.y;
    } else {
      v[0] = rows[j * LD + lane];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pr[r], v[e], acc[r][e]);
  }
}

// Row i's lane columns of a section of dqkv (or out), from acc[r] times scale.
template <int HD>
__device__ __forceinline__ void store_lane_columns(float* dst, const float (&acc)[HD / 32],
                                                   float scale, int lane) {
  if constexpr (HD / 32 == 2) {
    *reinterpret_cast<float2*>(dst + 2 * lane) = make_float2(acc[0] * scale, acc[1] * scale);
  } else {
    dst[lane] = acc[0] * scale;
  }
}

// The softmax of row r from the lane's scores (keys 32 t + lane): returns the
// row's max and sum and leaves exp(s - max) / sum in s, zero at masked keys
// and past N.
__device__ __forceinline__ void softmax_row(float (&s)[kSlots], int slots, int n_valid, int lane,
                                            float& m, float& l) {
  m = kLowest;
#pragma unroll
  for (int t = 0; t < kSlots; ++t)
    if (t < slots && 32 * t + lane < n_valid) m = fmaxf(m, s[t]);
  m = warp_max(m);
  l = 0.0f;
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    s[t] = (t < slots && 32 * t + lane < n_valid) ? expf(s[t] - m) : 0.0f;
    l += s[t];
  }
  l = warp_sum(l);
#pragma unroll
  for (int t = 0; t < kSlots; ++t) s[t] = s[t] / l;
}

// The four rows' values of each lane key into wt[j][0..3] (16 bytes a key).
__device__ __forceinline__ void store_transposed(float* wt, const float (&v)[kRows][kSlots],
                                                 int slots, int N, int lane) {
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int j = 32 * t + lane;
    if (t < slots && j < N) st4(wt + j * kRows, make_float4(v[0][t], v[1][t], v[2][t], v[3][t]));
  }
}

template <int HD>
constexpr int fwd_smem_floats(int N) {
  return N * (HD + 4) * 2 + kWarps * (kRows * HD + N * kRows);
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps, 1)
qkv_attention_f32_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                             float* __restrict__ out, int N, int H, int n_valid, float scale) {
  constexpr int LD = HD + 4;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y, D = H * HD;
  const Head head{qkv + static_cast<long>(b) * N * 3 * D, bias, D, h, HD};
  float* s_k = smem;
  float* s_v = s_k + N * LD;
  float* s_q = s_v + N * LD + warp * (kRows * HD + N * kRows);
  float* s_p = s_q + kRows * HD;
  stage_head<HD>(s_k, s_v, head, 1, 2, N);
  __syncthreads();

  const int slots = (N + 31) / 32;
  for (int i0 = warp * kRows; i0 < N; i0 += kWarps * kRows) {
    stage_rows<HD>(s_q, head, 0, i0, N, scale, lane);
    __syncwarp();
    float s[kRows][kSlots];
    lane_rows_dot<HD>(s, s_k, 1.0f, s_q, N, slots, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m, l;
      softmax_row(s[r], slots, n_valid, lane, m, l);
    }
    store_transposed(s_p, s, slots, N, lane);
    __syncwarp();
    float acc[kRows][HD / 32];
    weighted_rows<HD>(acc, s_p, s_v, N, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < N)
        store_lane_columns<HD>(out + (static_cast<long>(b) * N + i0 + r) * D + h * HD, acc[r],
                               1.0f, lane);
    __syncwarp();  // the buffers are the next rows'
  }
}

template <int HD>
constexpr int bwd_smem_floats(int N) {
  return N * (HD + 4) * 2 + 3 * ((N + 3) & ~3) + kWarps * (2 * kRows * HD + 2 * N * kRows);
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps, 1)
qkv_attention_f32_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                             const float* __restrict__ dout, float* dqkv, float* __restrict__ part,
                             int N, int H, int n_valid, float scale) {
  constexpr int LD = HD + 4, DPL = HD / 32;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y, D = H * HD;
  const Head head{qkv + static_cast<long>(b) * N * 3 * D, bias, D, h, HD};
  const float* d_rows = dout + static_cast<long>(b) * N * D + h * HD;  // dO row i at i * D
  float* rows_dq = dqkv + static_cast<long>(b) * N * 3 * D + h * HD;  // + section * D
  float* s_a = smem;             // pass 1: K; pass 2: Q (unscaled)
  float* s_b = s_a + N * LD;     // pass 1: V; pass 2: dO
  const int NP = (N + 3) & ~3;   // 16-byte multiples
  float* s_m = s_b + N * LD;     // each query row's max, sum and tmp
  float* s_l = s_m + NP;
  float* s_tmp = s_l + NP;
  float* s_st = s_tmp + NP + warp * (2 * kRows * HD + 2 * N * kRows);
  float* s_st2 = s_st + kRows * HD;
  float* s_w = s_st2 + kRows * HD;  // (N, kRows)
  float* s_ds = s_w + N * kRows;    // (N, kRows)
  const int slots = (N + 31) / 32;

  // dO rows i0 .. i0 + kRows - 1 into the warp's buffer; zeros past N.
  auto stage_grad_rows = [&](float* dst, int i0) {
    constexpr int kPieces = HD / 4;
    for (int p = lane; p < kRows * kPieces; p += 32) {
      const int r = p / kPieces, c = (p % kPieces) * 4;
      const int i = i0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < N) v = ld4(d_rows + static_cast<long>(i) * D + c);
      st4(dst + r * HD + c, v);
    }
  };

  // Pass 1: query rows; lanes hold keys.
  stage_head<HD>(s_a, s_b, head, 1, 2, N);
  __syncthreads();
  for (int i0 = warp * kRows; i0 < N; i0 += kWarps * kRows) {
    stage_rows<HD>(s_st, head, 0, i0, N, scale, lane);
    stage_grad_rows(s_st2, i0);
    __syncwarp();
    float s[kRows][kSlots], dw[kRows][kSlots];
    lane_rows_dot<HD>(s, s_a, 1.0f, s_st, N, slots, lane);
    lane_rows_dot<HD>(dw, s_b, 1.0f, s_st2, N, slots, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m, l;
      softmax_row(s[r], slots, n_valid, lane, m, l);
      float tmp = 0.0f;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) tmp += dw[r][t] * s[r][t];
      tmp = warp_sum(tmp);
#pragma unroll
      for (int t = 0; t < kSlots; ++t) dw[r][t] = s[r][t] * (dw[r][t] - tmp);  // dS
      if (lane == 0 && i0 + r < N) {
        s_m[i0 + r] = m;
        s_l[i0 + r] = l;
        s_tmp[i0 + r] = tmp;
      }
    }
    store_transposed(s_ds, dw, slots, N, lane);
    __syncwarp();
    float acc[kRows][DPL];
    weighted_rows<HD>(acc, s_ds, s_a, N, lane);  // dS K
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < N)
        store_lane_columns<HD>(rows_dq + static_cast<long>(i0 + r) * 3 * D, acc[r], scale, lane);
    __syncwarp();
  }
  __syncthreads();

  // Pass 2: key rows; lanes hold query rows.
  {
    constexpr int kPieces = HD / 4;
    for (int p = threadIdx.x; p < N * kPieces; p += blockDim.x) {
      const int i = p / kPieces, c = (p % kPieces) * 4;
      st4(s_a + i * LD + c, head.load(0, i, c));
      st4(s_b + i * LD + c, ld4(d_rows + static_cast<long>(i) * D + c));
    }
  }
  __syncthreads();
  for (int j0 = warp * kRows; j0 < N; j0 += kWarps * kRows) {
    stage_rows<HD>(s_st, head, 1, j0, N, 1.0f, lane);   // K rows
    stage_rows<HD>(s_st2, head, 2, j0, N, 1.0f, lane);  // V rows
    __syncwarp();
    float s[kRows][kSlots], dw[kRows][kSlots];
    lane_rows_dot<HD>(s, s_a, scale, s_st, N, slots, lane);  // (q * scale) . k
    lane_rows_dot<HD>(dw, s_b, 1.0f, s_st2, N, slots, lane);  // dO . v
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int i = 32 * t + lane;
      const bool row_ok = t < slots && i < N;
      const float m = row_ok ? s_m[i] : 0.0f, l = row_ok ? s_l[i] : 1.0f;
      const float tmp = row_ok ? s_tmp[i] : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float w = row_ok && j0 + r < n_valid ? expf(s[r][t] - m) / l : 0.0f;
        s[r][t] = w;
        dw[r][t] = w * (dw[r][t] - tmp);  // dS
      }
    }
    store_transposed(s_w, s, slots, N, lane);
    store_transposed(s_ds, dw, slots, N, lane);
    __syncwarp();
    float dv[kRows][DPL], dk[kRows][DPL];
    weighted_rows<HD>(dv, s_w, s_b, N, lane);   // W^T dO
    weighted_rows<HD>(dk, s_ds, s_a, N, lane);  // dS^T Q
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (j0 + r >= N) continue;
      float* row = rows_dq + static_cast<long>(j0 + r) * 3 * D;
      store_lane_columns<HD>(row + D, dk[r], scale, lane);
      store_lane_columns<HD>(row + 2 * D, dv[r], 1.0f, lane);
    }
    __syncwarp();
  }

  if (part == nullptr) return;
  // This head's columns of dqkv summed over the image's rows in row order:
  // the block's own writes, visible to it after the barrier.
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * HD; c += blockDim.x) {
    const int col = (c / HD) * D + h * HD + c % HD;
    const float* src = dqkv + static_cast<long>(b) * N * 3 * D + col;
    float total = 0.0f;
    for (int i = 0; i < N; ++i) total += src[static_cast<long>(i) * 3 * D];
    part[static_cast<long>(b) * 3 * D + col] = total;
  }
}

template <int HD>
cudaError_t launch_fwd(const float* qkv, const float* bias, float* out, int B, int N, int H,
                       int n_valid, float scale, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(qkv_attention_f32_fwd_kernel<HD>,
                                       sizeof(float) * fwd_smem_floats<HD>(kMaxTokens), configured);
  if (err != cudaSuccess) return err;
  qkv_attention_f32_fwd_kernel<HD><<<dim3(H, B), 32 * kWarps,
                                     sizeof(float) * fwd_smem_floats<HD>(N), stream>>>(
      qkv, bias, out, N, H, n_valid, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const float* qkv, const float* bias, const float* dout, float* dqkv,
                       float* part, float* dbias, int B, int N, int H, int n_valid, float scale,
                       cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(qkv_attention_f32_bwd_kernel<HD>,
                                       sizeof(float) * bwd_smem_floats<HD>(kMaxTokens), configured);
  if (err != cudaSuccess) return err;
  const bool with_bias = bias != nullptr;
  qkv_attention_f32_bwd_kernel<HD><<<dim3(H, B), 32 * kWarps,
                                     sizeof(float) * bwd_smem_floats<HD>(N), stream>>>(
      qkv, bias, dout, dqkv, with_bias ? part : nullptr, N, H, n_valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !with_bias) return err;
  return launch_column_sum<32>(part, B, 3 * H * HD, dbias, stream);
}

}  // namespace

// qkv: (B, N, 3*H*hd) fp32; bias: (3*H*hd,) fp32 or null; out: (B, N, H*hd)
// fp32.  hd 32 or 64; 1 <= n_valid <= N <= 256; scale: the fp32 1/sqrt(hd).
// Returns the launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_fwd_f32(const void* qkv, const void* bias, void* out,
                                               int B, int N, int H, int head_dim, int n_valid,
                                               float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > kMaxTokens || n_valid < 1 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(qkv);
  const float* bb = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch_fwd<32>(q, bb, o, B, N, H, n_valid, scale, s));
    case 64: return static_cast<int>(launch_fwd<64>(q, bb, o, B, N, H, n_valid, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// qkv: (B, N, 3*H*hd) fp32; bias: (3*H*hd,) fp32 or null; dout: (B, N, H*hd)
// fp32; dqkv: (B, N, 3*H*hd) fp32.  With a bias, dbias_part is (B, 3*H*hd)
// fp32 scratch and dbias (3*H*hd,) fp32 receives the bias gradient (the sum
// of dqkv over every row).  hd 32 or 64; 1 <= n_valid <= N <= 256; scale:
// the fp32 1/sqrt(hd), folded into q and applied to dQ and dK.  Returns the
// first failing launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_bwd_f32(const void* qkv, const void* bias,
                                               const void* dout, void* dqkv, void* dbias_part,
                                               void* dbias, int B, int N, int H, int head_dim,
                                               int n_valid, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > kMaxTokens || n_valid < 1 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bias != nullptr && (dbias_part == nullptr || dbias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(qkv);
  const float* bb = static_cast<const float*>(bias);
  const float* d = static_cast<const float*>(dout);
  float* dq = static_cast<float*>(dqkv);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch_bwd<32>(q, bb, d, dq, part, db, B, N, H, n_valid,
                                                    scale, s));
    case 64: return static_cast<int>(launch_bwd<64>(q, bb, d, dq, part, db, B, N, H, n_valid,
                                                    scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
