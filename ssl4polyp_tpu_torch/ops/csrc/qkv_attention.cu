// Attention straight from the fused QKV projection, forward and backward.
//
// Replaces: ssl4polyp_tpu/ops/qkv_attention.py::_fwd_kernel and _bwd_kernel
// (fused_qkv_attention), and ::_fwd_bias_kernel and _bwd_bias_kernel
// (fused_qkv_bias_attention); the optional bias argument covers the second.
// The backward's design is described above qkv_attention_bwd_kernel and
// attention_core.cuh's attention_backward_tiles.
//
// What bounds the forward on the H100: at the eval path's shape (B 64, N 197,
// 12 heads of 64) a call is 7.6 GFLOP against 78 MB of compulsory traffic
// (QKV in, output out), about 100 FLOP per byte, below the ~295 of the H100's
// data sheet ridge: the floor is HBM traffic.  At ViT lengths (N <= 256) one
// (batch, head) pair's keys and values fit in shared memory, so the (N, N)
// scores never leave the SM, and what is left to lose is latency: time in
// which an SM waits for a copy, or executes loads instead of products.
//
// The design (the first form gave every 64-row query tile a block that staged
// the head's whole K and V through registers, four times a head at N 197,
// computed nothing until all three tiles had landed, and gathered V two
// bytes at a time):
//   * One block of 4 warps per (head, batch row) stages the head's K and V
//     once; its warps take the 16-row query tiles in turn (13 at N 197: 4, 3,
//     3, 3).  69 KB of shared memory at hd 64, N 197 (K and V padded to 208
//     rows, one 16-row Q tile a warp) and, under __launch_bounds__(128, 3),
//     168 registers a thread (80 bytes of spills at hd 64; left alone ptxas
//     takes 254 and two blocks an SM, which is slower): three blocks an SM.
//   * Raw rows arrive by cp.async in separate groups: K, the warp's first Q
//     tile, then V.  The bias add and the bf16 scale fold (round_bf16(x +
//     bias), then times 1/sqrt(hd) and rounded: the TPU kernel's roundings)
//     run in place in shared memory, each thread on the chunks it copied
//     itself after its own wait_group.  V's copy and its bias pass overlap
//     the first tile's S = Q K^T and softmax; a warp's next Q tile is copied
//     while it works on the current one (its fragments are in registers by
//     then, so one 16-row buffer a warp is enough).  The bias pass runs on
//     packed bf16 instructions, two for 16 bytes, with the fp32 route's bits.
//   * Operands come from shared memory with ldmatrix: x4 for the Q and K
//     fragments, x4.trans for V; each feeds two products, on a row stride of
//     hd + 8 elements that keeps them free of bank conflicts.
//   * Each warp forms the whole score row in registers with mma.sync m16n8k16
//     (bf16 in, fp32 accumulate), masks keys >= valid_len to -inf, optionally
//     rounds the scores to bf16, takes an exact softmax over the full row (no
//     online rescaling is needed because the row is whole), rounds the
//     normalised weights to bf16 and multiplies by V; the score fragments are
//     the A operand of the second product without leaving registers.
//   * The output leaves in 16-byte pieces (a quad transpose of the
//     accumulator fragments) where hd is a multiple of 32.
//   Every supported shape (hd 16, 32, 64; N <= 256) takes this one routine.
//   What is left: the softmax (expf, max, sum, normalise and round: some 13
//   instructions a score, 104 scores a thread a tile) now outweighs the
//   products' instructions four to one, with 12 warps an SM to hide its
//   chains; the last of the 13 tiles at N 197 holds 5 rows and costs a whole
//   one; wgmma for S and P.V (m64n208k16, m64n64k16) would take most of the
//   products' instructions away and TMA the copies'.  PERF.md has the times
//   beside PyTorch's flash kernel's.
#include "attention_core.cuh"

namespace {

constexpr int kWarps = 4;

// NKT: key tiles of 16; the kernel takes N <= 16 * NKT.  Up to 208 keys the
// score row fits a register budget of three blocks an SM (168 a thread).
template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kWarps, NKT <= 13 ? 3 : 2)
qkv_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                     bf16* __restrict__ out, int N, int H, int n_valid, float scale,
                     int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + kPad * kLd;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* s_q = s_v + kPad * kLd + warp * 16 * kLd;  // this warp's 16-row Q tile

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  const long ld = 3L * D;
  const bf16* base = qkv + static_cast<long>(b) * N * ld + h * HD;
  const bf16* bias_q = bias == nullptr ? nullptr : bias + h * HD;
  const bf16* bias_k = bias == nullptr ? nullptr : bias + D + h * HD;
  const bf16* bias_v = bias == nullptr ? nullptr : bias + 2 * D + h * HD;
  const int n_tiles = (N + 15) / 16;  // 16-row query tiles holding rows < N
  int tile = warp;

  // cp.async groups of every thread, oldest first: K, Q (empty for a warp
  // without a tile), V, then one per pass of the loop (the next Q tile).
  stage_rows_async<HD>(s_k, kPad, base + D, 0, N, ld);
  cp_async_commit();
  if (tile < n_tiles) stage_rows_async<HD>(s_q, 16, base, tile * 16, N, ld, lane, 32);
  cp_async_commit();
  stage_rows_async<HD>(s_v, kPad, base + 2 * D, 0, N, ld);
  cp_async_commit();
  cp_async_wait<1>();  // K and Q are in
  finish_rows_in_place<HD>(s_k, kPad, 0, N, bias_k, 1.0f, false, threadIdx.x, blockDim.x);
  if (tile < n_tiles) finish_rows_in_place<HD>(s_q, 16, tile * 16, N, bias_q, scale, true, lane, 32);
  __syncthreads();

  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  bool first = true;
  do {  // a warp without a tile still passes once: the block's barrier is inside
    const bool has = tile < n_tiles;
    const int next = tile + kWarps;
    uint32_t qa[HD / 16][4];
    float s[2 * NKT][4];
    float inv0 = 0.0f, inv1 = 0.0f;
    if (has) load_q_fragments<HD>(qa, s_q, 0, lane);
    __syncwarp();  // the Q tile is in registers: its buffer takes the next one
    if (has && next < n_tiles) stage_rows_async<HD>(s_q, 16, base, next * 16, N, ld, lane, 32);
    cp_async_commit();
    if (has) attention_scores<HD, NKT, false>(qa, s_k, lane, n_valid, softmax_f32, 1.0f, s, inv0, inv1);
    if (first) {
      cp_async_wait<1>();  // V is in (the next Q tile may still be on its way)
      finish_rows_in_place<HD>(s_v, kPad, 0, N, bias_v, 1.0f, false, threadIdx.x, blockDim.x);
      __syncthreads();
      first = false;
    }
    if (has) {
      float o[HD / 8][4];
      attention_values<HD, NKT>(s, inv0, inv1, s_v, lane, o);
      const int row_a = tile * 16 + g;
      const int row_b = row_a + 8;
      bf16* out_a = out + (static_cast<long>(b) * N + row_a) * D + h * HD;
      bf16* out_b = out_a + 8L * D;
      if constexpr (HD % 32 == 0) {
#pragma unroll
        for (int n = 0; n < HD / 8; n += 4) {  // lane t takes column tile n + t: 16 bytes
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = pack_floats(o[n + i][0], o[n + i][1]);
            hi[i] = pack_floats(o[n + i][2], o[n + i][3]);
          }
          quad_transpose(lo, t);
          quad_transpose(hi, t);
          if (row_a < N)
            *reinterpret_cast<uint4*>(out_a + (n + t) * 8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          if (row_b < N)
            *reinterpret_cast<uint4*>(out_b + (n + t) * 8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          if (row_a < N)
            *reinterpret_cast<uint32_t*>(out_a + n * 8 + 2 * t) = pack_floats(o[n][0], o[n][1]);
          if (row_b < N)
            *reinterpret_cast<uint32_t*>(out_b + n * 8 + 2 * t) = pack_floats(o[n][2], o[n][3]);
        }
      }
    }
    cp_async_wait<0>();  // the next Q tile
    if (has && next < n_tiles)
      finish_rows_in_place<HD>(s_q, 16, next * 16, N, bias_q, scale, true, lane, 32);
    __syncwarp();
    tile = next;
  } while (tile < n_tiles);
}

template <int HD, int NKT>
cudaError_t launch(const bf16* qkv, const bf16* bias, bf16* out, int B, int N, int H,
                   int n_valid, float scale, int softmax_f32, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * NKT * 16 + kWarps * 16) * (HD + 8) * sizeof(bf16);
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(qkv_attention_kernel<HD, NKT>, smem, configured);
  if (err != cudaSuccess) return err;
  qkv_attention_kernel<HD, NKT><<<dim3(H, B), 32 * kWarps, smem, stream>>>(
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

// ---------------------------------------------------------------------------
// Backward.
//
// The TPU kernel's steps and roundings (qkv_attention.py:108-157, :316-376):
// the weights W are recomputed in fp32 from the bf16 scale fold in q (scores
// rounded to bf16 first when softmax_f32 is 0); dV = round_bf16(W)^T dO;
// dW = dO V^T; tmp = rowsum(dW * W) with the unrounded W; dS =
// round_bf16(W * (dW - tmp)); dQ = dS K and dK = dS^T Q with the UNSCALED k
// and q, each multiplied by the fp32 1/sqrt(hd) (`scale`, not the bf16 value
// `scale_c` the forward folded into q) and rounded to bf16.  With a bias, the
// bias gradient is the fp32 sum over every (batch, token) row of the
// bf16-rounded dQKV.
//
// What bounds it on the H100: five products of N x N x hd per (batch, head)
// against reading QKV and dO and writing dQKV once, about 250 FLOP per byte
// at N 197: near the ridge, so latency and the tensor-core rate both matter.
//
// The simple design: one block of 8 warps per (head, batch row).  At ViT
// lengths the head's Q, K, V and dO fit in shared memory (120 KB at N 197,
// hd 64; 65 KB at hd 32), so nothing but qkv (and the bias) is saved by the
// forward and every intermediate stays on the SM.  The two-phase routine is
// attention_core.cuh's attention_backward_tiles (mode kBwdFold), shared with
// the kernels for attention over separate q, k, v and for the projection +
// attention.  Each warp adds its tiles' column sums of the rounded dQKV in
// tile order, the block adds its warps in warp order into one row of a
// (B, 3D) fp32 partial, and column_sum_kernel adds the B rows in order: the
// same bits on every run.
// ---------------------------------------------------------------------------

template <int HD, int NKT>
constexpr size_t bwd_smem_bytes() {
  return static_cast<size_t>(4 * NKT * 16) * (HD + 8) * sizeof(bf16) +
         static_cast<size_t>(3 * NKT * 16 + kBwdWarps * 3 * HD) * sizeof(float);
}

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kBwdWarps)
qkv_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                         const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                         float* __restrict__ dbias_part, int N, int H, int n_valid,
                         float scale_c, float scale, int softmax_f32) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // q + bias, unscaled
  bf16* s_k = s_q + kPad * kLd;
  bf16* s_v = s_k + kPad * kLd;
  bf16* s_do = s_v + kPad * kLd;
  float* s_max = reinterpret_cast<float*>(s_do + kPad * kLd);
  float* s_inv = s_max + kPad;
  float* s_tmp = s_inv + kPad;
  float* s_db = s_tmp + kPad;  // [kBwdWarps][3 * HD]: each warp's dbias partial

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * HD;
  const long ld = 3L * D;
  const bool want_dbias = dbias_part != nullptr;
  const bf16* base = qkv + static_cast<long>(b) * N * ld + h * HD;
  stage_rows<HD>(s_q, kPad, base, 0, N, ld, bias == nullptr ? nullptr : bias + h * HD, 1.0f, false);
  stage_rows<HD>(s_k, kPad, base + D, 0, N, ld,
                 bias == nullptr ? nullptr : bias + D + h * HD, 1.0f, false);
  stage_rows<HD>(s_v, kPad, base + 2 * D, 0, N, ld,
                 bias == nullptr ? nullptr : bias + 2 * D + h * HD, 1.0f, false);
  stage_rows<HD>(s_do, kPad, dout + static_cast<long>(b) * N * D + h * HD, 0, N, D, nullptr,
                 1.0f, false);
  for (int i = threadIdx.x; i < kBwdWarps * 3 * HD; i += blockDim.x) s_db[i] = 0.0f;
  __syncthreads();

  bf16* out = dqkv + static_cast<long>(b) * N * ld + h * HD;
  attention_backward_tiles<HD, NKT, kBwdFold>(
      s_q, s_k, s_v, s_do, s_max, s_inv, s_tmp,
      want_dbias ? s_db + (threadIdx.x / 32) * 3 * HD : nullptr, out, out + D, out + 2 * D, ld, N,
      n_valid, scale_c, scale, softmax_f32);
  if (!want_dbias) return;
  __syncthreads();
  store_dbias_partial<HD>(s_db, dbias_part, b, h, D);
}

template <int HD, int NKT>
cudaError_t launch_bwd(const bf16* qkv, const bf16* bias, const bf16* dout, bf16* dqkv,
                       float* dbias_part, float* dbias, int B, int N, int H, int n_valid,
                       float scale_c, float scale, int softmax_f32, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD, NKT>();
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_bwd_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qkv_attention_bwd_kernel<HD, NKT><<<dim3(H, B), 32 * kBwdWarps, smem, stream>>>(
      qkv, bias, dout, dqkv, bias == nullptr ? nullptr : dbias_part, N, H, n_valid, scale_c,
      scale, softmax_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || bias == nullptr) return err;
  return launch_column_sum(dbias_part, B, 3 * H * HD, dbias, stream);
}

template <int HD>
cudaError_t launch_bwd_head_dim(const bf16* qkv, const bf16* bias, const bf16* dout, bf16* dqkv,
                                float* dbias_part, float* dbias, int B, int N, int H,
                                int n_valid, float scale_c, float scale, int softmax_f32,
                                cudaStream_t stream) {
#define SSL4POLYP_BWD(NKT)                                                                     \
  launch_bwd<HD, NKT>(qkv, bias, dout, dqkv, dbias_part, dbias, B, N, H, n_valid, scale_c, \
                      scale, softmax_f32, stream)
  if (N <= 64) return SSL4POLYP_BWD(4);
  if (N <= 128) return SSL4POLYP_BWD(8);
  if (N <= 208) return SSL4POLYP_BWD(13);
  if (N <= 256) return SSL4POLYP_BWD(16);
#undef SSL4POLYP_BWD
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

// qkv: (B, N, 3*H*hd) bf16; bias: (3*H*hd,) bf16 or null; dout: (B, N, H*hd)
// bf16; dqkv: (B, N, 3*H*hd) bf16.  With a bias, dbias_part is (B, 3*H*hd)
// fp32 scratch and dbias (3*H*hd,) fp32 receives the bias gradient; both are
// ignored without one.  scale_c is 1/sqrt(hd) as the compute dtype holds it
// (the forward's fold), scale the fp32 1/sqrt(hd).  Returns the first failing
// launch's CUDA error.
extern "C" int ssl4polyp_qkv_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                           void* dqkv, void* dbias_part, void* dbias, int B,
                                           int N, int H, int head_dim, int n_valid,
                                           float scale_c, float scale, int softmax_f32,
                                           void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bb = static_cast<const bf16*>(bias);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_bwd_head_dim<16>(q, bb, d, dq, part, db, B, N, H, n_valid, scale_c, scale, softmax_f32, s); break;
    case 32: err = launch_bwd_head_dim<32>(q, bb, d, dq, part, db, B, N, H, n_valid, scale_c, scale, softmax_f32, s); break;
    case 64: err = launch_bwd_head_dim<64>(q, bb, d, dq, part, db, B, N, H, n_valid, scale_c, scale, softmax_f32, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
