// Attention with the output projection folded in, forward and backward:
//   y = bf16(bf16(attention_core(qkv)) . W^T) + b.
//
// Replaces: ssl4polyp_tpu/ops/attn_proj.py::_fwd_kernel and _bwd_kernel
// (fused_attention_proj).  W is torch's (out, in) layout, so both operands
// of the forward product are contiguous along the reduction.
//
// What bounds it on the H100: at the fine-tune shape (B 64, N 197, 12 heads
// of 64, D 768) the forward is 22.5 GFLOP (7.6 in the attention core, 14.9
// in the projection) against 79 MB of compulsory traffic (QKV in, y out, W
// once), some 285 FLOP per byte: at the data sheet's ridge, so neither side
// is free.  What the fold saves is the core output's round trip through HBM
// (2 x 19 MB) and a launch.
//
// Forward design.  The TPU program holds whole images in VMEM; one image's
// core output (197 x 768 bf16, 302 KB) does not fit an SM's shared memory, so
// a block owns one (image, 64 query rows) tile instead.  It loops over the
// heads: stages the head's Q tile, K and V (cp.async copies, all in flight
// at once; attention_core.cuh), each of its 4 warps takes 16 query rows through
// scores, softmax and the product with V, and rounds its O fragment to bf16
// into the block's O tile in shared memory (64 x D, 97 KB at D 768).  Then
// the tile is multiplied by W: column tiles of 128, the reduction in steps of
// 64 through a three-stage cp.async ring (in the space the head staging has
// left), warps as 2 x 2 with 32 x 64 each on mma.sync m16n8k16.  The epilogue
// rounds the fp32 sum to bf16, adds the bias in bf16 and rounds again, as the
// TPU kernel does.  O never reaches global memory.  The last row tile of an
// image holds 5 of 64 rows at N 197, every block re-reads its image's K and V
// and all of W from L2, and staging is not overlapped with the head's
// products: the later work is wgmma, TMA and a persistent schedule.
//
// Backward design.  dW and db sum over every row of the batch, and the port
// uses no float atomics (reruns give the same bits), so the backward runs in
// phases, with the recomputed core output O and dO in global scratch:
//   1. the forward's kernel again (PREP): recomputes the O tile, writes it to
//      scratch, loads the dy tile in its place and forms dO = bf16(dy . W)
//      with W's tiles read transposed (ldmatrix.trans);
//   2. attn_proj_dw_kernel: dW[out, in] = sum over rows of dy[r, out] O[r, in]
//      in fp32; a block owns a 64 x 64 tile of dW and one of `slices` row
//      slices, reads both operands transposed, and writes its partial;
//      column_sum_kernel adds the slices in order;
//   3. dy_column_partial_kernel and column_sum_kernel: db = sum of dy in fp32,
//      64-row partials added in order;
//   4. the attention backward kernel (qkv_attention.cu) on dO, which
//      recomputes the weights itself and writes dQKV.
#include "attention_core.cuh"

// The attention backward's entry point (qkv_attention.cu, same library).
extern "C" int ssl4polyp_qkv_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                           void* dqkv, void* dbias_part, void* dbias, int B,
                                           int N, int H, int head_dim, int n_valid,
                                           float scale_c, float scale, int softmax_f32,
                                           void* stream);

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;        // query rows per block: 16 per warp
constexpr int kBN = 128;         // output columns per tile of the projection
constexpr int kBK = 64;          // reduction depth per step
constexpr int kStages = 3;
constexpr int kLdW = kBK + 8;    // a W tile stored [n][k]
constexpr int kLdWT = kBN + 8;   // a W tile stored [k][n] (read transposed)
constexpr int kStageElems = kBN * kLdW;
static_assert(kBK * kLdWT <= kStageElems, "a transposed W tile must fit a stage");

template <int HD, int NKT>
constexpr int head_stage_elems() {
  return (kRows + 2 * NKT * 16) * (HD + 8);
}

template <int HD, int NKT>
size_t proj_smem_bytes(int D) {
  const int ring = kStages * kStageElems;
  const int stage = head_stage_elems<HD, NKT>() > ring ? head_stage_elems<HD, NKT>() : ring;
  return static_cast<size_t>(kRows * (D + 8) + stage) * sizeof(bf16);
}

// PREP false: the forward; `out` receives y.  PREP true: the backward's
// first phase; `o_out` receives the recomputed core output and `out`
// dO = bf16(dy . W); `bias` is not read.
template <int HD, int NKT, bool PREP>
__global__ void __launch_bounds__(kThreads)
attn_proj_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, const bf16* __restrict__ dy,
                 bf16* __restrict__ o_out, bf16* __restrict__ out, int N, int H, int n_valid,
                 float scale, int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  const int D = H * HD;
  const int ldA = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);  // the O tile (then the dy tile)
  bf16* s_r = s_a + kRows * ldA;              // head staging, then the W ring
  bf16* s_q = s_r;
  bf16* s_k = s_q + kRows * kLd;
  bf16* s_v = s_k + kPad * kLd;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;
  const long ld = 3L * D;
  const bf16* base = qkv + static_cast<long>(b) * N * ld;
  const bool active = q0 + r0 < N;  // else the warp's rows are all past the sequence

  for (int h = 0; h < H; ++h) {
    if (h > 0) __syncthreads();  // every warp is done with the previous head's tiles
    // The bias is in qkv already, so the three tiles are plain copies: one
    // cp.async group, and the scale folds into q as its fragments load.
    stage_rows_async<HD>(s_q, kRows, base + h * HD, q0, N, ld);
    stage_rows_async<HD>(s_k, kPad, base + D + h * HD, 0, N, ld);
    stage_rows_async<HD>(s_v, kPad, base + 2 * D + h * HD, 0, N, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float o[HD / 8][4];
    if (active) {
      attention_rows<HD, NKT, true>(s_q, s_k, s_v, r0, lane, n_valid, softmax_f32, o, scale);
    } else {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    }
    bf16* dst = s_a + (r0 + g) * ldA + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_floats(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * ldA + n * 8) = pack_floats(o[n][2], o[n][3]);
    }
  }
  __syncthreads();  // the O tile is whole and the staging region is free

  if (PREP) {
    const int chunks = D / 8;
    for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i % chunks) * 8;
      if (q0 + r < N)
        *reinterpret_cast<uint4*>(o_out + (static_cast<long>(b) * N + q0 + r) * D + c) =
            *reinterpret_cast<const uint4*>(s_a + r * ldA + c);
    }
    __syncthreads();
    // The dy tile takes the O tile's place; it joins the first W tile's group.
    for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i % chunks) * 8;
      const bool ok = q0 + r < N;
      cp_async_16(s_a + r * ldA + c,
                  ok ? dy + (static_cast<long>(b) * N + q0 + r) * D + c : dy, ok ? 16 : 0);
    }
  }

  // The projection: (64 x D) . (D x D), flat over (column tile, reduction step).
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 64;
  const int KT = D / kBK;
  const int tiles = (D / kBN) * KT;
  auto load_w = [&](int it) {
    bf16* dst = s_r + (it % kStages) * kStageElems;
    const int n0 = (it / KT) * kBN;
    const int k0 = (it % KT) * kBK;
    if (!PREP) {  // rows n0.. of W (out, in), columns k0..: stored [n][k]
      for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8);
        const int c = (i % (kBK / 8)) * 8;
        cp_async_16(dst + r * kLdW + c, w + static_cast<long>(n0 + r) * D + k0 + c, 16);
      }
    } else {  // dO = dy . W: the reduction runs down W's rows: stored [k][n]
      for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
        const int r = i / (kBN / 8);
        const int c = (i % (kBN / 8)) * 8;
        cp_async_16(dst + r * kLdWT + c, w + static_cast<long>(k0 + r) * D + n0 + c, 16);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_w(s);
    cp_async_commit();
  }
  float acc[2][8][4];
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` is in; every warp is done with the slot refilled next
    const int next = it + kStages - 1;
    if (next < tiles) load_w(next);
    cp_async_commit();
    const int k_idx = it % KT;
    if (k_idx == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    }
    const bf16* tile = s_r + (it % kStages) * kStageElems;
    const int k0 = k_idx * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], s_a + (wm + i * 16 + (lane % 16)) * ldA + k0 + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bq[4];
        if (!PREP) {
          ldmatrix_x4(bq, tile + (wn + j * 8 + (lane / 16) * 8 + (lane % 8)) * kLdW + kk +
                              ((lane / 8) % 2) * 8);
        } else {
          ldmatrix_x4_trans(bq, tile + (kk + ((lane / 8) % 2) * 8 + (lane % 8)) * kLdWT + wn +
                                    j * 8 + (lane / 16) * 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][j], a[i], bq[0], bq[1]);
          mma_16816(acc[i][j + 1], a[i], bq[2], bq[3]);
        }
      }
    }
    if (k_idx != KT - 1) continue;
    const int n0 = (it / KT) * kBN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      float b0 = 0.0f, b1 = 0.0f;
      if (!PREP) {
        b0 = __bfloat162float(bias[col]);
        b1 = __bfloat162float(bias[col + 1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q0 + wm + i * 16 + g + 8 * half;
          if (row >= N) continue;
          float v0 = acc[i][j][2 * half];
          float v1 = acc[i][j][2 * half + 1];
          if (!PREP) {  // the product rounded to bf16, then the bias added in bf16
            v0 = round_bf16(v0) + b0;
            v1 = round_bf16(v1) + b1;
          }
          *reinterpret_cast<uint32_t*>(out + (static_cast<long>(b) * N + row) * D + col) =
              pack_floats(v0, v1);
        }
      }
    }
  }
}

template <int HD, int NKT, bool PREP>
cudaError_t launch_proj(const bf16* qkv, const bf16* w, const bf16* bias, const bf16* dy,
                        bf16* o_out, bf16* out, int B, int N, int H, int n_valid, float scale,
                        int softmax_f32, cudaStream_t stream) {
  const size_t smem = proj_smem_bytes<HD, NKT>(H * HD);
  cudaError_t err = cudaFuncSetAttribute(attn_proj_kernel<HD, NKT, PREP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_proj_kernel<HD, NKT, PREP><<<dim3((N + kRows - 1) / kRows, B), kThreads, smem, stream>>>(
      qkv, w, bias, dy, o_out, out, N, H, n_valid, scale, softmax_f32);
  return cudaGetLastError();
}

template <bool PREP>
cudaError_t dispatch_proj(const bf16* qkv, const bf16* w, const bf16* bias, const bf16* dy,
                          bf16* o_out, bf16* out, int B, int N, int H, int head_dim, int n_valid,
                          float scale, int softmax_f32, cudaStream_t stream) {
  if ((H * head_dim) % kBN != 0) return cudaErrorInvalidValue;
#define SSL4POLYP_PROJ(HD, NKT)                                                              \
  launch_proj<HD, NKT, PREP>(qkv, w, bias, dy, o_out, out, B, N, H, n_valid, scale, softmax_f32, \
                             stream)
#define SSL4POLYP_PROJ_N(HD)                 \
  if (N <= 64) return SSL4POLYP_PROJ(HD, 4);   \
  if (N <= 128) return SSL4POLYP_PROJ(HD, 8);  \
  if (N <= 208) return SSL4POLYP_PROJ(HD, 13); \
  if (N <= 256) return SSL4POLYP_PROJ(HD, 16); \
  return cudaErrorInvalidValue;
  switch (head_dim) {
    case 32: SSL4POLYP_PROJ_N(32)
    case 64: SSL4POLYP_PROJ_N(64)
    default: return cudaErrorInvalidValue;
  }
#undef SSL4POLYP_PROJ_N
#undef SSL4POLYP_PROJ
}

// dW[out, in] = sum over rows r of dy[r, out] * O[r, in], fp32: one 64 x 64
// tile of dW over one slice of the rows.  Both operands have the reduction
// index running down their rows, so both fragments are read transposed.
constexpr int kDwTile = 64;
constexpr int kDwRows = 64;  // rows of the reduction per step
constexpr int kDwLd = kDwTile + 8;
constexpr int kDwStageElems = 2 * kDwRows * kDwLd;  // a dy tile and an O tile
constexpr size_t kDwSmemBytes = kStages * kDwStageElems * sizeof(bf16);

__global__ void __launch_bounds__(kThreads)
attn_proj_dw_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ o,
                    float* __restrict__ part, int M, int D, int rows_per_slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  const int in0 = blockIdx.x * kDwTile;   // O's columns: dW's columns
  const int out0 = blockIdx.y * kDwTile;  // dy's columns: dW's rows
  const int r_begin = blockIdx.z * rows_per_slice;
  const int r_end = min(M, r_begin + rows_per_slice);
  const int steps = r_end > r_begin ? (r_end - r_begin + kDwRows - 1) / kDwRows : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  auto load = [&](int step) {
    bf16* t_dy = s + (step % kStages) * kDwStageElems;
    bf16* t_o = t_dy + kDwRows * kDwLd;
    const int row0 = r_begin + step * kDwRows;
    for (int i = threadIdx.x; i < kDwRows * (kDwTile / 8); i += kThreads) {
      const int r = i / (kDwTile / 8);
      const int c = (i % (kDwTile / 8)) * 8;
      const int row = row0 + r;
      const bool ok = row < r_end;
      cp_async_16(t_dy + r * kDwLd + c, ok ? dy + static_cast<long>(row) * D + out0 + c : dy,
                  ok ? 16 : 0);
      cp_async_16(t_o + r * kDwLd + c, ok ? o + static_cast<long>(row) * D + in0 + c : o,
                  ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps) load(next);
    cp_async_commit();
    const bf16* t_dy = s + (step % kStages) * kDwStageElems;
    const bf16* t_o = t_dy + kDwRows * kDwLd;
    const int m8 = lane / 8;  // which 8x8 matrix this lane addresses
#pragma unroll
    for (int kk = 0; kk < kDwRows; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4_trans(a[i], t_dy + (kk + (m8 >> 1) * 8 + (lane % 8)) * kDwLd + wm + i * 16 +
                                    (m8 & 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, t_o + (kk + (m8 & 1) * 8 + (lane % 8)) * kDwLd + wn + j * 8 +
                                  (m8 >> 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][j], a[i], bq[0], bq[1]);
          mma_16816(acc[i][j + 1], a[i], bq[2], bq[3]);
        }
      }
    }
  }
  float* dst = part + static_cast<long>(blockIdx.z) * D * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = out0 + wm + i * 16 + g + 8 * half;
        const int col = in0 + wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst + static_cast<long>(row) * D + col) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
}

// part[block][c] = sum of dy[r][c] over the block's 64 rows, in row order.
constexpr int kDbRows = 64;

__global__ void __launch_bounds__(256)
dy_column_partial_kernel(const bf16* __restrict__ dy, int M, int D, float* __restrict__ part) {
  const int r0 = blockIdx.x * kDbRows;
  const int r1 = min(M, r0 + kDbRows);
  for (int c = 2 * threadIdx.x; c < D; c += 2 * blockDim.x) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dy + static_cast<long>(r) * D + c));
      s0 += v.x;
      s1 += v.y;
    }
    part[static_cast<long>(blockIdx.x) * D + c] = s0;
    part[static_cast<long>(blockIdx.x) * D + c + 1] = s1;
  }
}

}  // namespace

// qkv: (B, N, 3*H*hd) bf16, [q heads | k heads | v heads], its bias already
// added; w: (D, D) bf16 as (out, in); bias: (D,) bf16; out: (B, N, D) bf16,
// D = H*hd a multiple of 128, hd 32 or 64, N <= 256.  scale is 1/sqrt(hd) as
// bf16 holds it.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_attn_proj_fwd(const void* qkv, const void* w, const void* bias, void* out,
                                       int B, int N, int H, int head_dim, int n_valid, float scale,
                                       int softmax_f32, void* stream) {
  return static_cast<int>(dispatch_proj<false>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      nullptr, nullptr, static_cast<bf16*>(out), B, N, H, head_dim, n_valid, scale, softmax_f32,
      static_cast<cudaStream_t>(stream)));
}

// The backward of ssl4polyp_attn_proj_fwd for the output gradient dy
// (B, N, D) bf16.  Scratch: o and d_o (B, N, D) bf16, dw_part (slices, D, D)
// fp32, db_part (ceil(B*N / 64), D) fp32.  Results: dqkv (B, N, 3D) bf16, dw
// (D, D) fp32 as (out, in), db (D,) fp32.  scale_c is 1/sqrt(hd) as bf16
// holds it, scale the fp32 value.  Returns the first failing launch's CUDA
// error.
extern "C" int ssl4polyp_attn_proj_bwd(const void* qkv, const void* w, const void* dy, void* o,
                                       void* d_o, void* dqkv, void* dw_part, void* dw,
                                       void* db_part, void* db, int B, int N, int H, int head_dim,
                                       int n_valid, float scale_c, float scale, int softmax_f32,
                                       int slices, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * head_dim;
  const int M = B * N;
  if (slices < 1 || D % kDwTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dispatch_proj<true>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(w), nullptr,
      static_cast<const bf16*>(dy), static_cast<bf16*>(o), static_cast<bf16*>(d_o), B, N, H,
      head_dim, n_valid, scale_c, softmax_f32, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(attn_proj_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDwSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_slice = ((M + slices - 1) / slices + kDwRows - 1) / kDwRows * kDwRows;
  attn_proj_dw_kernel<<<dim3(D / kDwTile, D / kDwTile, slices), kThreads, kDwSmemBytes, st>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(o), static_cast<float*>(dw_part), M,
      D, per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_column_sum(static_cast<const float*>(dw_part), slices, D * D,
                          static_cast<float*>(dw), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int db_blocks = (M + kDbRows - 1) / kDbRows;
  dy_column_partial_kernel<<<db_blocks, 256, 0, st>>>(static_cast<const bf16*>(dy), M, D,
                                                      static_cast<float*>(db_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_column_sum(static_cast<const float*>(db_part), db_blocks, D,
                          static_cast<float*>(db), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  return ssl4polyp_qkv_attention_bwd(qkv, nullptr, d_o, dqkv, nullptr, nullptr, B, N, H, head_dim,
                                     n_valid, scale_c, scale, softmax_f32, stream);
}
