// Attention straight from the fused QKV projection in fp32, forward and
// backward, for the runs that compute in fp32 (`amp: false`,
// PretrainSettings.precision "fp32").
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel, _bwd_kernel
// (fused_qkv_attention), ::_fwd_bias_kernel and _bwd_bias_kernel
// (fused_qkv_bias_attention) at compute dtype float32, where the TPU kernels
// take cdtype = qkv.dtype and every product is fp32.  The bf16 kernels
// (qkv_attention.cu) run on mma.sync, which has no fp32 operand type, so
// these are SIMT kernels: every product an FFMA on fp32 operands, fp32
// accumulation, no TF32 and no split into bf16 terms.  The contract is the
// plain versions' in ops/qkv_attention.py: q = (qkv_q + bias_q) * scale, with
// the fp32 scale 1/sqrt(hd); scores q . k^T; keys at or past n_valid masked;
// a softmax over the row; out = W . v.  The backward gives dV = W^T dO,
// dW = dO V^T, dS = W * (dW - D), dQ = scale * dS K and dK = scale * dS^T Q
// (q unscaled), with D = rowsum(dO * O), which equals the plain version's
// tmp = rowsum(dW * W) in exact arithmetic.  In the `scaled_ds` mode the scale
// sits where ssl4polyp_tpu/ops/attention_block.py::_bwd_kernel puts it (the
// backward of fused_qkvproj_attention, which attention_block_f32.cu runs):
// dS = W * (dW - D) * scale, dQ = dS K and dK = dS^T Q.  In fp32 the two
// modes differ only in the order of the multiplications.
//
// The same kernels also serve ssl4polyp_tpu/ops/attention.py::_attention_kernel
// and _attention_bwd_kernel (fused_attention) at float32: attention over
// separate (B, H, N, hd) q, k and v, no bias, every key weighted, the
// backward in the `scaled_ds` mode (that kernel's dS = W * (dW - tmp) *
// scale).  The layout is a template parameter (SEP): each operand is a base
// pointer and a (head, image) offset and row stride computed from it, so the
// fused instantiations' arithmetic is the same.  That kernel multiplies the
// fp32 scores by the scale where these fold it into q in fp32: one rounding
// of order apart.
//
// What bounds them on the H100: at the classifier's shape (B 64, N 197, 12
// heads of 64) the forward is 7.6 GFLOP against 155 MB of compulsory
// traffic, 0.114 ms at the 67 TFLOP/s fp32 rate: operations, as is the
// backward with five products to the forward's two.  So the design keeps
// the FFMA units fed from shared memory (FlashAttention's tiling, on the
// CUDA cores), with as many warps an SM as the register file allows:
//   * Tiles of 64 rows (queries or keys) by 64 keys or queries, blocks of
//     256 threads.  Thread (rg, cg) = (tid / 16, tid % 16) holds rows rg +
//     16 i (i < 4) of a tile; in a score product the 4 x 4 scores of
//     columns cg + 16 j, each one FFMA chain over d ascending from 16-byte
//     loads (per 4 d and warp: 4 row loads of 2 addresses, 4 column loads of
//     16, no bank conflict); in a product with a score tile (P.V, dS.K, ...)
//     4 rows x hd / 16 output columns.  A row's 16 threads are a half-warp,
//     so its max and sum are shuffles.  4 x 4 tiles keep a thread within
//     128 registers, so two blocks (16 warps) share an SM: on an H100, 8 x 4
//     and 8 x 8 tiles at 8-12 warps an SM were slower.
//   * Operand tiles are row-major [row][d], rows padded to hd + 4 floats,
//     filled by 16-byte cp.async straight from qkv; the bias (and q's scale)
//     is added in place by the thread that copied each piece.  Score tiles
//     (P, dS) have rows of 64 + 16 floats.  Shared memory does not grow with
//     N, so any N >= 1 runs.
//   * Rows past a tile's end and key slots past the last weighted key are
//     skipped (a separate instantiation for whole tiles keeps their loops
//     free of checks); key tiles stop at n_valid.
//   * Forward: one block for each (query tile, head, image), the query tile
//     the fastest grid index, so neighbouring blocks read one head's K and
//     V from L2.  Q (scaled, biased) stays; K and V stream through one
//     buffer each, each loaded under the other's product (V of tile t under
//     the scores, K of tile t + 1 under P.V): 71 KB at hd 64.  An online
//     softmax carries each row's running max and a per-thread partial sum,
//     rescales the output accumulators, and divides once at the end; with
//     `lse` it writes each row's log-sum-exp L = m + log(l) for the
//     backward.
//   * Backward: a small kernel takes D = dO . O from the forward's output;
//     then one block for each (head, image) walks the key tiles in ascending
//     order and, for each, the query tiles in ascending order: S^T and dW^T
//     (rows are keys), P^T = exp(S - L) and dS^T into shared memory, dK +=
//     dS^T Q and dV += P^T dO in registers, and dQ's part dS K, read from
//     dS^T with each thread's 4 queries contiguous.  The block adds that
//     part to the query tile's rows of dqkv, which only it writes, in
//     key-tile order, so no atomics and reruns give the same bits (F8 in
//     ROADMAP.md §3).  Five products a pair of tiles: a block for each query
//     tile and another for each key tile (two kernels) would recompute S and
//     dW in both, seven products, and measured slower on an H100.  The
//     cost: B x H blocks, so a small batch fills few SMs.  With a bias, each
//     block writes each tile's column sums into its own row of a (B *
//     tiles, 3D) scratch, and a column sum adds the rows in order: dbias.
// Head dims 32 and 64.  Every sum is taken in an order fixed by the shape.
#include "common.cuh"
#include "qkv_attention_f32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;    // row groups rg and column groups cg
constexpr int kTile = 64;      // rows (queries or keys) and columns of a tile
constexpr int kPer = 4;        // a thread's rows (rg + 16 i) and score columns (cg + 16 j)
constexpr int kLdS = kTile + kGroups;  // a score tile's row stride: 16 banks between rows
constexpr float kLowest = -3.402823466e38f;  // below every finite score

template <int HD>
__host__ __device__ constexpr int operand_floats() { return kTile * (HD + 4); }

constexpr int kScoreFloats = kTile * kLdS;

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

// Max and sum over a row's 16 lanes (a half-warp); every lane of the warp
// must call them.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DC consecutive floats, DC 2 or 4 (8- or 16-byte aligned).
template <int DC>
__device__ __forceinline__ void load_cols(float (&v)[DC], const float* p) {
  if constexpr (DC == 4) {
    const float4 t = ld4(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

template <int DC>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[DC]) {
  if constexpr (DC == 4) {
    st4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// Rows r0 .. r0 + 63 of `src` (row i at src + i * stride, HD columns) into
// an operand tile by cp.async; rows at or past n are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long stride, int r0,
                                          int n) {
  constexpr int kPieces = HD / 4, LD = HD + 4;
  static_assert(kTile * kPieces % kThreads == 0, "whole pieces a thread");
#pragma unroll
  for (int k = 0; k < kTile * kPieces / kThreads; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int r = p / kPieces, c = (p % kPieces) * 4;
    const bool ok = r0 + r < n;
    cp_async_16(dst + r * LD + c, src + static_cast<long>(ok ? r0 + r : 0) * stride + c,
                ok ? 16 : 0);
  }
}

// The bias, then the scale, on this thread's pieces of a load_tile once
// its copies have landed (the plain version's (qkv + bias) * scale); rows
// at or past n stay zero.  A null bias and scale 1 leave the tile as it is.
template <int HD>
__device__ __forceinline__ void finish_tile(float* dst, const float* bias, float scale, int r0,
                                            int n) {
  constexpr int kPieces = HD / 4, LD = HD + 4;
  if (bias == nullptr && scale == 1.0f) return;
#pragma unroll
  for (int k = 0; k < kTile * kPieces / kThreads; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int r = p / kPieces, c = (p % kPieces) * 4;
    if (r0 + r >= n) continue;
    float4 v = ld4(dst + r * LD + c);
    if (bias != nullptr) v = add4(v, ld4(bias + c));
    if (scale != 1.0f) v = mul4(v, scale);
    st4(dst + r * LD + c, v);
  }
}

// acc[i][j] = sum over d of a[rg + 16 i][d] * (b[cg + 16 j][d] * b_scale):
// one FFMA chain over d ascending, the same bits whichever operand is a.  a
// and b are operand tiles.  CHECKED: rows at or past `rows` and column
// slots with 16 j >= `cols` are left at zero.
template <int HD, bool CHECKED>
__device__ __forceinline__ void tile_scores(float (&acc)[kPer][kPer], const float* a,
                                            const float* b, float b_scale, int rg, int cg,
                                            int rows, int cols) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 bv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      bv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (CHECKED && kGroups * j >= cols) continue;
      bv[j] = ld4(b + (cg + kGroups * j) * LD + d);
      if (b_scale != 1.0f) bv[j] = mul4(bv[j], b_scale);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (CHECKED && rg + kGroups * i >= rows) continue;
      const float4 av = ld4(a + (rg + kGroups * i) * LD + d);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (CHECKED && kGroups * j >= cols) continue;
        acc[i][j] = dot4(av, bv[j], acc[i][j]);
      }
    }
  }
}

// acc[i][c] += sum over j < count of s[rg + 16 i][j] * b[j][cg * DC + c], j
// ascending: s a score tile, b an operand tile, DC = HD / 16.  The sum runs
// to count rounded up to 4, where s holds zeros and b finite rows.
// CHECKED: rows at or past `rows` are skipped; otherwise count is kTile.
template <int HD, bool CHECKED>
__device__ __forceinline__ void tile_product(float (&acc)[kPer][HD / kGroups], const float* s,
                                             const float* b, int rg, int cg, int rows,
                                             int count) {
  constexpr int LD = HD + 4, DC = HD / kGroups;
  const int n = CHECKED ? count : kTile;
#pragma unroll 2
  for (int j = 0; j < n; j += 4) {
    float bv[4][DC];
#pragma unroll
    for (int t = 0; t < 4; ++t) load_cols<DC>(bv[t], b + (j + t) * LD + cg * DC);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (CHECKED && rg + kGroups * i >= rows) continue;
      const float4 w = ld4(s + (rg + kGroups * i) * kLdS + j);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        acc[i][c] = fmaf(w.x, bv[0][c], acc[i][c]);
        acc[i][c] = fmaf(w.y, bv[1][c], acc[i][c]);
        acc[i][c] = fmaf(w.z, bv[2][c], acc[i][c]);
        acc[i][c] = fmaf(w.w, bv[3][c], acc[i][c]);
      }
    }
  }
}

template <int HD>
__device__ __forceinline__ void scores(float (&acc)[kPer][kPer], const float* a, const float* b,
                                       float b_scale, int rg, int cg, int rows, int cols) {
  if (rows == kTile && cols == kTile)
    tile_scores<HD, false>(acc, a, b, b_scale, rg, cg, rows, cols);
  else
    tile_scores<HD, true>(acc, a, b, b_scale, rg, cg, rows, cols);
}

template <int HD>
__device__ __forceinline__ void product(float (&acc)[kPer][HD / kGroups], const float* s,
                                        const float* b, int rg, int cg, int rows, int count) {
  if (rows == kTile && count == kTile)
    tile_product<HD, false>(acc, s, b, rg, cg, rows, count);
  else
    tile_product<HD, true>(acc, s, b, rg, cg, rows, count);
}

template <int DC>
__device__ __forceinline__ void zero(float (&acc)[kPer][DC]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
}

// One head (blockIdx.y) of one image (blockIdx.z): where its rows lie
// (HeadRows) and its slices of the bias.
template <bool SEP>
struct Head : HeadRows<SEP> {
  const float *bq, *bk, *bv;  // null without a bias
  __device__ Head(const float* bias, int N, int H, int HD)
      : HeadRows<SEP>(blockIdx.z, blockIdx.y, N, H, HD),
        bq(bias == nullptr ? nullptr : bias + blockIdx.y * HD),
        bk(bias == nullptr ? nullptr : bias + H * HD + blockIdx.y * HD),
        bv(bias == nullptr ? nullptr : bias + 2 * H * HD + blockIdx.y * HD) {}
};

template <int HD>
constexpr int fwd_smem_bytes() {
  return sizeof(float) * (3 * operand_floats<HD>() + kScoreFloats);
}

template <int HD>
constexpr int bwd_smem_bytes() {
  return sizeof(float) * (4 * operand_floats<HD>() + 2 * kScoreFloats);
}

// grid (query tiles, H, B).  q, k, v and out as HeadRows<SEP> lays them out;
// lse (B, H, N) or null.  At hd 32 three blocks share an SM (48 KB each, 80
// registers a thread), which measured faster on an H100; at hd 64 two, with
// 128 registers.
template <int HD, bool SEP>
__global__ void __launch_bounds__(kThreads, HD == 32 ? 3 : 2)
qkv_attention_f32_fwd_kernel(const float* __restrict__ q_base, const float* __restrict__ k_base,
                             const float* __restrict__ v_base, const float* __restrict__ bias,
                             float* __restrict__ out, float* __restrict__ lse, int N, int H,
                             int n_valid, float scale) {
  constexpr int DC = HD / kGroups;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + operand_floats<HD>();
  float* s_v = s_k + operand_floats<HD>();
  float* s_p = s_v + operand_floats<HD>();
  const int rg = threadIdx.x / kGroups, cg = threadIdx.x % kGroups;
  const Head<SEP> head(bias, N, H, HD);
  const float* src_q = q_base + head.at;
  const float* src_k = k_base + head.at;
  const float* src_v = v_base + head.at;
  const int q0 = blockIdx.x * kTile;
  const int rows = min(kTile, N - q0);
  const int tiles = (n_valid + kTile - 1) / kTile;

  load_tile<HD>(s_q, src_q, head.ld, q0, N);
  load_tile<HD>(s_k, src_k, head.ld, 0, N);
  cp_async_commit();
  cp_async_wait<0>();
  finish_tile<HD>(s_q, head.bq, scale, q0, N);
  finish_tile<HD>(s_k, head.bk, 1.0f, 0, N);
  __syncthreads();

  float o[kPer][DC], m[kPer], l[kPer];
  zero(o);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kLowest;
    l[i] = 0.0f;
  }
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    const int count = min(kTile, n_valid - k0);  // keys of this tile with weight
    load_tile<HD>(s_v, src_v, head.ld, k0, N);  // V(t) under the scores
    cp_async_commit();
    float s[kPer][kPer];
    scores<HD>(s, s_q, s_k, 1.0f, rg, cg, rows, count);
    // The online softmax: each row's running max m, the thread's part of
    // its running sum l, the output accumulators rescaled to the new max.
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float tile_max = kLowest;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (cg + kGroups * j < count) tile_max = fmaxf(tile_max, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = cg + kGroups * j < count ? expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        s_p[(rg + kGroups * i) * kLdS + cg + kGroups * j] = p;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    cp_async_wait<0>();
    finish_tile<HD>(s_v, head.bv, 1.0f, k0, N);
    __syncthreads();  // P and V(t) visible; K(t) read
    if (t + 1 < tiles) {  // K(t + 1) under P.V
      load_tile<HD>(s_k, src_k, head.ld, k0 + kTile, N);
      cp_async_commit();
    }
    product<HD>(o, s_p, s_v, rg, cg, rows, count);
    cp_async_wait<0>();
    if (t + 1 < tiles) finish_tile<HD>(s_k, head.bk, 1.0f, k0 + kTile, N);
    __syncthreads();  // K(t + 1) visible; P and V(t) read
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float sum = row_sum(l[i]);
    const int row = rg + kGroups * i;
    if (row >= rows) continue;
    float v[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) v[c] = o[i][c] / sum;
    store_cols<DC>(out + head.o + static_cast<long>(q0 + row) * head.o_ld + cg * DC, v);
    if (lse != nullptr && cg == 0)
      lse[(static_cast<long>(blockIdx.z) * H + blockIdx.y) * N + q0 + row] = m[i] + logf(sum);
  }
}

// D = rowsum(dO * O) for every (image, head, row), rows (b H + h) N + i: a
// row's 16 lanes take HD / 16 columns each, then the row's sum.  out and dO
// (B, N, D), or (B, H, N, hd) with SEP.
template <int HD, bool SEP>
__global__ void __launch_bounds__(kThreads)
qkv_attention_f32_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                               float* __restrict__ delta, long rows, int N, int H) {
  constexpr int DC = HD / kGroups;
  const long row = static_cast<long>(blockIdx.x) * (kThreads / kGroups) + threadIdx.x / kGroups;
  const int lane = threadIdx.x % kGroups;
  float part = 0.0f;
  if (row < rows) {
    long at = row * HD + lane * DC;
    if constexpr (!SEP) {
      const long bh = row / N;
      at = ((bh / H) * N + row % N) * H * HD + (bh % H) * HD + lane * DC;
    }
    float o[DC], d[DC];
    load_cols<DC>(o, out + at);
    load_cols<DC>(d, dout + at);
#pragma unroll
    for (int c = 0; c < DC; ++c) part = fmaf(d[c], o[c], part);
  }
  part = row_sum(part);
  if (row < rows && lane == 0) delta[row] = part;
}

// The backward, grid (1, H, B): see the note above.  q, k, v, dout and dq,
// dk, dv as HeadRows<SEP> lays them out; lse, delta (B, H, N); part (B * tiles,
// 3D) or null.
template <int HD, bool SEP>
__global__ void __launch_bounds__(kThreads, 2)
qkv_attention_f32_bwd_kernel(const float* __restrict__ q_base, const float* __restrict__ k_base,
                             const float* __restrict__ v_base, const float* __restrict__ bias,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const float* __restrict__ dout, float* __restrict__ dq_base,
                             float* __restrict__ dk_base, float* __restrict__ dv_base,
                             float* __restrict__ part, int N, int H, int n_valid, float scale,
                             bool scaled_ds) {
  constexpr int DC = HD / kGroups, LD = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + operand_floats<HD>();
  float* s_q = s_v + operand_floats<HD>();
  float* s_do = s_q + operand_floats<HD>();
  float* s_p = s_do + operand_floats<HD>();  // P^T: [key][query]
  float* s_ds = s_p + kScoreFloats;          // dS^T
  // rg, cg: rows rg + 16 i (keys) and columns cg + 16 j (queries) of the
  // score tiles, dK and dV's columns cg DC + c; in dS K, queries 4 rg + a.
  const int rg = threadIdx.x / kGroups, cg = threadIdx.x % kGroups;
  const Head<SEP> head(bias, N, H, HD);
  const int D = H * HD, h = blockIdx.y;
  const long part_ld = 3L * D;  // a row of the dbias scratch
  const long stats = (static_cast<long>(blockIdx.z) * H + h) * N;
  const float* src_q = q_base + head.at;
  const float* src_k = k_base + head.at;
  const float* src_v = v_base + head.at;
  const float* d_src = dout + head.o;
  float* g_q = dq_base + head.at;
  float* g_k = dk_base + head.at;
  float* g_v = dv_base + head.at;
  const int tiles = (N + kTile - 1) / kTile;
  const int key_tiles = (n_valid + kTile - 1) / kTile;  // those with a weighted key
  const long part_row = static_cast<long>(blockIdx.z) * tiles;
  // Where the scale goes: into dS (scaled_ds), or onto dQ and dK.
  const float ds_scale = scaled_ds ? scale : 1.0f;
  const float out_scale = scaled_ds ? 1.0f : scale;

  load_tile<HD>(s_k, src_k, head.ld, 0, N);
  load_tile<HD>(s_v, src_v, head.ld, 0, N);
  load_tile<HD>(s_q, src_q, head.ld, 0, N);
  cp_async_commit();
  load_tile<HD>(s_do, d_src, head.o_ld, 0, N);
  cp_async_commit();
  for (int kt = 0; kt < key_tiles; ++kt) {
    const int k0 = kt * kTile;
    const int keys = min(kTile, n_valid - k0);  // keys of the tile with weight
    const bool last = kt + 1 == key_tiles;      // dQ's last part: scale it, sum its columns
    float dk[kPer][DC], dv[kPer][DC];
    zero(dk);
    zero(dv);
    for (int u = 0; u < tiles; ++u) {
      const int i0 = u * kTile;
      const int count = min(kTile, N - i0);  // query rows of this tile
      cp_async_wait<1>();  // Q(u) (and K, V at u = 0); dO(u) may be in flight
      if (u == 0) {
        finish_tile<HD>(s_k, head.bk, 1.0f, k0, N);
        finish_tile<HD>(s_v, head.bv, 1.0f, k0, N);
      }
      finish_tile<HD>(s_q, head.bq, 1.0f, i0, N);  // q unscaled: dK's operand
      __syncthreads();  // Q(u) visible
      float row_l[kPer], row_d[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = cg + kGroups * j;
        row_l[j] = i < count ? lse[stats + i0 + i] : 0.0f;
        row_d[j] = i < count ? delta[stats + i0 + i] : 0.0f;
      }
      float st[kPer][kPer];
      scores<HD>(st, s_k, s_q, scale, rg, cg, keys, count);  // K . (q scale)^T
      cp_async_wait<0>();
      __syncthreads();  // dO(u) visible
      float dwt[kPer][kPer];
      scores<HD>(dwt, s_v, s_do, 1.0f, rg, cg, keys, count);  // V . dO^T
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool ok = rg + kGroups * i < keys && cg + kGroups * j < count;
          const float p = ok ? expf(st[i][j] - row_l[j]) : 0.0f;
          const int at = (rg + kGroups * i) * kLdS + cg + kGroups * j;
          s_p[at] = p;
          s_ds[at] = p * (dwt[i][j] - row_d[j]) * ds_scale;
        }
      __syncthreads();  // P^T, dS^T visible
      product<HD>(dk, s_ds, s_q, rg, cg, keys, count);
      float dq[kPer][DC];
      zero(dq);
#pragma unroll 4
      for (int j = 0; j < keys; ++j) {  // dS K over this tile's keys, j ascending
        float w[kPer], kc[DC];
        load_cols<kPer>(w, s_ds + j * kLdS + kPer * rg);
        load_cols<DC>(kc, s_k + j * LD + cg * DC);
#pragma unroll
        for (int a = 0; a < kPer; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) dq[a][c] = fmaf(w[a], kc[c], dq[a][c]);
      }
      __syncthreads();  // Q(u), K(kt), V(kt) and dS^T read
      if (u + 1 < tiles) {  // Q(u + 1) under dV
        load_tile<HD>(s_q, src_q, head.ld, i0 + kTile, N);
      } else if (kt + 1 < key_tiles) {  // the next key tile's K, V and Q(0)
        load_tile<HD>(s_k, src_k, head.ld, k0 + kTile, N);
        load_tile<HD>(s_v, src_v, head.ld, k0 + kTile, N);
        load_tile<HD>(s_q, src_q, head.ld, 0, N);
      }
      cp_async_commit();
      product<HD>(dv, s_p, s_do, rg, cg, keys, count);
      // The tile's dQ rows += this key tile's part, in key-tile order; the
      // last part then times out_scale (the plain version's (dS K) scale, or
      // 1 where dS holds it).
      float column[DC] = {};
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const int row = kPer * rg + a;
        if (row >= count) continue;
        float* dst = g_q + (i0 + row) * head.ld + cg * DC;
        float v[DC];
        if (kt > 0) load_cols<DC>(v, dst);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          v[c] = kt > 0 ? v[c] + dq[a][c] : dq[a][c];
          if (last) {
            v[c] *= out_scale;
            column[c] += v[c];
          }
        }
        store_cols<DC>(dst, v);
      }
      float* red = s_ds;  // (16, HD): dS^T was read before the last barrier
      if (last && part != nullptr) {
#pragma unroll
        for (int c = 0; c < DC; ++c) red[rg * HD + cg * DC + c] = column[c];
      }
      __syncthreads();  // dO(u), P^T read; red written
      if (last && part != nullptr) {
        for (int c = threadIdx.x; c < HD; c += kThreads) {
          float total = 0.0f;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) total += red[g * HD + c];
          part[(part_row + u) * part_ld + h * HD + c] = total;
        }
      }
      if (u + 1 < tiles) {  // dO(u + 1) under the next scores
        load_tile<HD>(s_do, d_src, head.o_ld, i0 + kTile, N);
      } else if (kt + 1 < key_tiles) {
        load_tile<HD>(s_do, d_src, head.o_ld, 0, N);
      }
      cp_async_commit();
    }

    // dK and dV of this key tile, and their columns' sums.
    const int rows = min(kTile, N - k0);
    float column[2][DC] = {};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = rg + kGroups * i;
      if (row >= rows) continue;
      float k[DC], v[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        k[c] = dk[i][c] * out_scale;
        v[c] = dv[i][c];
        column[0][c] += k[c];
        column[1][c] += v[c];
      }
      const long at = (k0 + row) * head.ld + cg * DC;
      store_cols<DC>(g_k + at, k);
      store_cols<DC>(g_v + at, v);
    }
    if (part != nullptr) {
      // (16, 2 HD); P^T was read before the last barrier, and the next key
      // tile writes it after two more.
      float* red = s_p;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        red[rg * 2 * HD + cg * DC + c] = column[0][c];
        red[rg * 2 * HD + HD + cg * DC + c] = column[1][c];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < 2 * HD; c += kThreads) {
        float total = 0.0f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) total += red[g * 2 * HD + c];
        part[(part_row + kt) * part_ld + (1 + c / HD) * D + h * HD + c % HD] = total;
      }
    }
  }
  // Key tiles wholly at or past n_valid: dK = dV = 0.
  for (int kt = key_tiles; kt < tiles; ++kt) {
    const int k0 = kt * kTile, pieces = 2 * HD / 4;
    for (int p = threadIdx.x; p < min(kTile, N - k0) * pieces; p += kThreads) {
      const int row = p / pieces, c = (p % pieces) * 4;
      st4((c < HD ? g_k : g_v) + (k0 + row) * head.ld + c % HD,
          make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (part != nullptr)
      for (int c = threadIdx.x; c < 2 * HD; c += kThreads)
        part[(part_row + kt) * part_ld + (1 + c / HD) * D + h * HD + c % HD] = 0.0f;
  }
}

template <int HD, bool SEP>
cudaError_t launch_fwd(Sections<const float> in, const float* bias, float* out, float* lse,
                       int B, int N, int H, int n_valid, float scale, cudaStream_t stream) {
  constexpr int bytes = fwd_smem_bytes<HD>();
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(qkv_attention_f32_fwd_kernel<HD, SEP>, bytes, configured);
  if (err != cudaSuccess) return err;
  qkv_attention_f32_fwd_kernel<HD, SEP><<<dim3((N + kTile - 1) / kTile, H, B), kThreads, bytes,
                                          stream>>>(in.q, in.k, in.v, bias, out, lse, N, H,
                                                    n_valid, scale);
  return cudaGetLastError();
}

template <int HD, bool SEP>
cudaError_t launch_bwd(Sections<const float> in, const float* bias, const float* dout, float* out,
                       float* lse, float* delta, Sections<float> grads, float* part, float* dbias,
                       int B, int N, int H, int n_valid, float scale, bool scaled_ds,
                       bool forward_first, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (forward_first) {
    err = launch_fwd<HD, SEP>(in, bias, out, lse, B, N, H, n_valid, scale, stream);
    if (err != cudaSuccess) return err;
  }
  constexpr int bytes = bwd_smem_bytes<HD>();
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(qkv_attention_f32_bwd_kernel<HD, SEP>, bytes, configured);
  if (err != cudaSuccess) return err;
  const long rows = static_cast<long>(B) * H * N;
  constexpr int kRowsPerBlock = kThreads / kGroups;
  qkv_attention_f32_delta_kernel<HD, SEP>
      <<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads, 0,
         stream>>>(out, dout, delta, rows, N, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qkv_attention_f32_bwd_kernel<HD, SEP><<<dim3(1, H, B), kThreads, bytes, stream>>>(
      in.q, in.k, in.v, bias, lse, delta, dout, grads.q, grads.k, grads.v,
      bias != nullptr ? part : nullptr, N, H, n_valid, scale, scaled_ds);
  err = cudaGetLastError();
  if (err != cudaSuccess || bias == nullptr) return err;
  return launch_column_sum<32>(part, B * ((N + kTile - 1) / kTile), 3 * H * HD, dbias, stream);
}

bool shape_ok(int B, int N, int H, int n_valid) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && N >= 1 && n_valid >= 1 && n_valid <= N;
}

}  // namespace

// qkv: (B, N, 3*H*hd) fp32; bias: (3*H*hd,) fp32 or null; out: (B, N, H*hd)
// fp32; lse: (B, H, N) fp32, each row's log-sum-exp for the backward, or
// null.  hd 32 or 64; 1 <= n_valid <= N; scale: the fp32 1/sqrt(hd).
// Returns the launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_fwd_f32(const void* qkv, const void* bias, void* out,
                                               void* lse, int B, int N, int H, int head_dim,
                                               int n_valid, float scale, void* stream) {
  if (!shape_ok(B, N, H, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = sections_of(static_cast<const float*>(qkv), H, head_dim);
  const float* bb = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch_fwd<32, false>(in, bb, o, l, B, N, H, n_valid, scale, s));
    case 64:
      return static_cast<int>(launch_fwd<64, false>(in, bb, o, l, B, N, H, n_valid, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// qkv, bias as for the forward; dout: (B, N, H*hd) fp32; out (B, N, H*hd)
// and lse (B, H, N) fp32: the forward's output and log-sum-exp, or with
// forward_first scratch that the forward kernel fills first; delta: (B, H,
// N) fp32 scratch; dqkv: (B, N, 3*H*hd) fp32.  With a bias, dbias_part is
// (part_rows, 3*H*hd) fp32 scratch, part_rows = B * ceil(N / 64), and dbias
// (3*H*hd,) fp32 receives the bias gradient (the sum of dqkv over every
// row).  hd 32 or 64; 1 <= n_valid <= N; scale: the fp32 1/sqrt(hd), folded
// into q and applied to dQ and dK, or with scaled_ds to dS.  Returns the
// first failing launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_bwd_f32(const void* qkv, const void* bias,
                                               const void* dout, void* out, void* lse,
                                               void* delta, void* dqkv, void* dbias_part,
                                               void* dbias, int part_rows, int B, int N, int H,
                                               int head_dim, int n_valid, float scale,
                                               int scaled_ds, int forward_first, void* stream) {
  if (!shape_ok(B, N, H, n_valid) || out == nullptr || lse == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bias != nullptr && (dbias_part == nullptr || dbias == nullptr ||
                          part_rows != B * ((N + kTile - 1) / kTile)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto in = sections_of(static_cast<const float*>(qkv), H, head_dim);
  const auto grads = sections_of(static_cast<float*>(dqkv), H, head_dim);
  const float* bb = static_cast<const float*>(bias);
  const float* d = static_cast<const float*>(dout);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  const bool first = forward_first != 0, scaled = scaled_ds != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch_bwd<32, false>(in, bb, d, o, l, dl, grads, part, db, B,
                                                           N, H, n_valid, scale, scaled, first, s));
    case 64: return static_cast<int>(launch_bwd<64, false>(in, bb, d, o, l, dl, grads, part, db, B,
                                                           N, H, n_valid, scale, scaled, first, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Attention over separate q, k and v in fp32 (fused_attention): q, k, v
// and out (B, H, N, hd) fp32; lse (B, H, N) fp32, each row's log-sum-exp for
// the backward, or null.  hd 32 or 64, any N >= 1, every key weighted, no
// bias; scale: the fp32 1/sqrt(hd).  Returns the launch's CUDA error.
extern "C" int ssl4polyp_attention_fwd_f32(const void* q, const void* k, const void* v,
                                           void* out, void* lse, int B, int H, int N,
                                           int head_dim, float scale, void* stream) {
  if (!shape_ok(B, N, H, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Sections<const float> in = {static_cast<const float*>(q), static_cast<const float*>(k),
                                    static_cast<const float*>(v)};
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch_fwd<32, true>(in, nullptr, o, l, B, N, H, N, scale, s));
    case 64: return static_cast<int>(launch_fwd<64, true>(in, nullptr, o, l, B, N, H, N, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Its backward, with the scale inside dS (the scaled_ds mode): q, k, v, dout
// (B, H, N, hd) fp32; out (B, H, N, hd) and lse (B, H, N) fp32, the forward's
// output and log-sum-exp, or with forward_first scratch that the forward
// kernel fills first; delta (B, H, N) fp32 scratch; dq, dk, dv (B, H, N, hd)
// fp32.  hd 32 or 64; scale: the fp32 1/sqrt(hd).  Returns the first failing
// launch's CUDA error.
extern "C" int ssl4polyp_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* dout, void* out, void* lse, void* delta,
                                           void* dq, void* dk, void* dv, int B, int H, int N,
                                           int head_dim, float scale, int forward_first,
                                           void* stream) {
  if (!shape_ok(B, N, H, N) || out == nullptr || lse == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sections<const float> in = {static_cast<const float*>(q), static_cast<const float*>(k),
                                    static_cast<const float*>(v)};
  const Sections<float> grads = {static_cast<float*>(dq), static_cast<float*>(dk),
                                 static_cast<float*>(dv)};
  const float* d = static_cast<const float*>(dout);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  const bool first = forward_first != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch_bwd<32, true>(in, nullptr, d, o, l, dl, grads, nullptr,
                                                          nullptr, B, N, H, N, scale, true, first,
                                                          s));
    case 64: return static_cast<int>(launch_bwd<64, true>(in, nullptr, d, o, l, dl, grads, nullptr,
                                                          nullptr, B, N, H, N, scale, true, first,
                                                          s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
