// Attention over separate q, k and v, forward and backward:
//   out = softmax(q . k^T * 1/sqrt(hd)) . v per (batch, head), (B, H, N, hd).
//
// Replaces: ssl4polyp_tpu/ops/attention.py::_attention_kernel and
// _attention_bwd_kernel (fused_attention).  Its roundings are not those of
// the QKV kernels: q and k enter the scores as they are and the scale
// multiplies the fp32 scores; the forward rounds the weights to bf16 before
// the product with v; the backward takes dV from the unrounded fp32 weights
// and dQ, dK from an unrounded dS = W * (dW - rowsum(dW * W)) * scale.  The TPU
// kernel pads N and hd to 128 for its matrix unit and masks the pad keys;
// here nothing is padded in global memory: every one of the N keys is valid,
// and the rows that fill the last 16-row tile in shared memory are zero and
// masked.
//
// What bounds it on the H100: at the classifier's shape (B 64, 12 heads, N
// 197, hd 64) the forward is 7.6 GFLOP against 77.5 MB (q, k, v in, out
// out), about 100 FLOP per byte, and the backward 19 GFLOP (30.5 with the
// second term of each split operand) against 135.6 MB: both below the data
// sheet's ridge of ~295, so HBM traffic is the floor.
//
// The forward (the second design; PERF.md has its times, the first
// design's and the ablations, through ssl4polyp_attention_fwd_probe):
//   * A persistent grid of one block an SM (227 KB of shared memory hold two
//     heads' tiles) walks the B * H heads, head blockIdx.x + i * gridDim.x in
//     its step i.  768 heads on 132 SMs are 5.8 rounds: 108 SMs take 6 heads
//     and 24 take 5, a tail of 3 % of the work, which splitting heads would
//     only move, not remove, at this count.
//   * A producer thread (its warpgroup gives its registers up by setmaxnreg)
//     loads a head's Q tiles (64 rows each), K and V (16 * NKT rows each)
//     with TMA from 3-D tensor maps over (B * H, N, hd), into one of two
//     buffers, completing on that buffer's "full" mbarrier; rows at or past
//     N arrive as zeros and no box reads the next head.  It loads the next
//     head into the other buffer while the consumers work on this one, once
//     they have released it ("empty", an arrival a consumer warp).  Rows of
//     hd 64, 32 and 16 are 128, 64 and 32 bytes: each takes the swizzle of
//     its width, which wgmma reads back through wgmma_descriptor_swizzled.
//   * Two consumer warpgroups take a head's query tiles in turn (the first
//     by the head's parity, so that an odd count does not always fall on
//     the same one).  For a tile: S = Q K^T by wgmma m64n(16 * NKT)k16, Q
//     and K from shared memory (K-major), fp32 in registers; the keys at or
//     past N masked to -inf; the exact softmax over the whole row, in fp32,
//     on the accumulator fragments (a quad holds a row): the scale folded
//     into exp2_approx's argument, one FMA a score; the weights normalised,
//     rounded to bf16 and packed into wgmma's register A fragments without
//     leaving registers; O = P V by register-A wgmma m64n(hd)k16 with V as
//     the MN-major B operand (row-major as TMA brought it, the transpose bit
//     set); O rounded once and stored 16 bytes a thread behind a row guard,
//     so nothing past row N - 1 of a head is written.  A warp whose 16 rows
//     all lie at or past N (the last tile at N 197 holds 5 rows) skips the
//     softmax and still takes part in its warpgroup's products.  The two
//     warpgroups' schedulers interleave one's softmax with the other's
//     products; no barrier orders them.
//   * The softmax is what a warp waits on: about 5.5 instructions and one
//     ex2 a score, 104 scores a thread at N 197.  Its maxima and sums run as
//     eight independent chains a row (a row's 26 column tiles as three or
//     four per chain, combined pairwise): with one chain a row the kernel
//     ran slower at both timed shapes.  Keys past N are masked only in the
//     column tiles that can reach past N at this key width.
//   * hd 16, 32 and 64 and every token count up to 256 take this kernel
//     (the key width NKT * 16 as for the first design).
//   * The bound: at the classifier's shape the 77.5 MB are 23 us at the
//     HBM rate.  The products, padded to 64-row tiles and 208 keys, are
//     10.5 GFLOP (11 us at the tensor cores' peak), and the softmax one
//     ex2 a score on the 16-a-clock special function unit of each SM (some
//     9 us).
//   * Tried and dropped (PERF.md says how each fared): softmax turns between the
//     two warpgroups (named barriers: one warp a scheduler in its softmax at
//     a time ran slower than two), three consumer warpgroups (168 registers
//     a thread spill, and with a producer warp 13 warps leave 128), the
//     (head, tile) units dealt out across heads in place of a head at a
//     time, the next tile's scores issued behind P V, P V in two or four
//     accumulator chains, four buffers at hd 32, a rotating warp for the
//     short last tile, and an earlier release of the buffer.
//   * No atomics: a rerun gives the same bits.
//
// The first design (attention_first_kernel; ssl4polyp_attention_fwd_probe
// reaches it, no route does): one block of 4 warps per (64-query tile,
// batch * head); it copies the Q tile and all of the head's K and V into
// shared memory with cp.async (so every query tile reads its head's K and V
// again) and waits for all of it; each warp takes 16 query rows through
// attention_core.cuh's attention_rows (mma.sync, whole score row in
// registers, expf).
//
// The backward is one block of 8 warps per (batch, head): Q, K, V and dO in
// shared memory, then attention_core.cuh's two-phase
// attention_backward_recompute_ds in mode kBwdExact, where each fp32 operand
// (W, dS) enters mma.sync as two bf16 terms.  No atomics: a rerun gives the
// same bits.
#include "attention_core.cuh"
#include "hopper.cuh"

namespace {

// `probe` bits, a measurement aid (0 on every path; chip_smoke.py times the
// kernel with parts left out, whose results are wrong): no softmax
// arithmetic (S rounded straight into P), no P V (each warp writes the first
// hd columns of its weights instead), no prefetch (a head is loaded only
// once the last is released), no exponential (the softmax with exp2 left
// out); and the first design (right results).
constexpr int kProbeNoSoftmax = 1;
constexpr int kProbeNoValues = 2;
constexpr int kProbeNoPrefetch = 4;
constexpr int kProbeFirstDesign = 8;
constexpr int kProbeNoExp = 16;

constexpr int kThreads = 384;      // a producer warpgroup, two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kQRows = 64;         // a query tile: one wgmma's M
constexpr int kChains = 8;         // independent max and sum chains a row

// One buffer: the Q tiles, K and V of a head, each tile aligned to 1,024
// bytes (the swizzle's period).
template <int HD, int NKT>
struct Buffers {
  static constexpr int kRowBytes = 2 * HD;
  static constexpr int kKeys = 16 * NKT;
  static constexpr int kQTiles = (kKeys + kQRows - 1) / kQRows;
  static constexpr uint32_t kQTileBytes = kQRows * kRowBytes;
  static constexpr uint32_t kKVBytes = kKeys * kRowBytes;  // what a K or V box brings
  static constexpr uint32_t kKVStride = (kKVBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kK = kQTiles * kQTileBytes;  // offsets in the buffer
  static constexpr uint32_t kV = kK + kKVStride;
  static constexpr uint32_t kBytes = kV + kKVStride;
  // Two buffers, their "full" and "empty" barriers, and room to align the
  // first to 1,024 bytes.
  static constexpr size_t kSmemBytes = 2 * kBytes + 4 * sizeof(uint64_t) + 1024;
  static_assert(kSmemBytes <= 232448, "the block's shared memory");
};

// S (+)= Q K^T for 64 query rows and 16 * NKT keys, both K-major.
template <int NKT>
__device__ __forceinline__ void wgmma_scores(float (&s)[8 * NKT], uint64_t desc_q, uint64_t desc_k,
                                             int accumulate) {
  if constexpr (NKT == 4) {
    wgmma_m64n64k16(s, desc_q, desc_k, accumulate);
  } else if constexpr (NKT == 8) {
    wgmma_m64n128k16(s, desc_q, desc_k, accumulate);
  } else if constexpr (NKT == 13) {
    wgmma_m64n208k16(s, desc_q, desc_k, accumulate);
  } else {
    static_assert(NKT == 16, "a key width of the dispatch");
    wgmma_m64n256k16(s, desc_q, desc_k, accumulate);
  }
}

// O (+)= P V for 16 keys: P from registers, V MN-major.
template <int HD>
__device__ __forceinline__ void wgmma_values(float (&o)[HD / 2], const uint32_t (&p)[4],
                                             uint64_t desc_v, int accumulate) {
  if constexpr (HD == 16) {
    wgmma_m64n16k16_rs_mn(o, p, desc_v, accumulate);
  } else if constexpr (HD == 32) {
    wgmma_m64n32k16_rs_mn(o, p, desc_v, accumulate);
  } else {
    static_assert(HD == 64, "a head dim of the dispatch");
    wgmma_m64n64k16_rs_mn(o, p, desc_v, accumulate);
  }
}

// Combines C partial maxima (or sums) pairwise into r[0].
template <int C, typename Op>
__device__ __forceinline__ void combine(float (&r)[C], Op op) {
#pragma unroll
  for (int w = C / 2; w > 0; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) r[c] = op(r[c], r[c + w]);
}

// The weights of a warp's rows g and g + 8 from their scores (s[4 j + e]:
// key 8 j + 2 t + (e & 1), row g for e < 2, else g + 8, as wgmma leaves
// them): keys >= N masked, the exact softmax of the scores times `scale`
// (passed as scale * log2(e)), normalised and rounded into p, wgmma's A
// fragments of the 16-key steps (p[kt]: keys 16 kt + 2t, + 1 of rows g and
// g + 8, then keys 16 kt + 8 + 2t, + 1).  Only the column tiles that may
// reach past N for this width are masked, and the maxima and sums run as
// kChains chains a row (column tile j in chain j % kChains), combined
// pairwise: short dependent chains are what a warp's softmax waits on.
// Without `softmax`, p is S rounded; without `with_exp`, the exponential is
// left out (a measurement aid).
template <int NKT>
__device__ __forceinline__ void attention_weights(float (&s)[8 * NKT], uint32_t (&p)[NKT][4],
                                                  int N, float scale_log2, int t, bool softmax,
                                                  bool with_exp) {
  float inv0 = 1.0f, inv1 = 1.0f;
  if (softmax) {
    float max0[kChains], max1[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) max0[c] = max1[c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
      if (j >= nkt_whole(NKT) && 8 * j + 8 > N) {  // the column tile reaches past the last key
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= N) s[4 * j + e] = -INFINITY;
      }
      max0[j % kChains] = fmaxf(max0[j % kChains], fmaxf(s[4 * j], s[4 * j + 1]));
      max1[j % kChains] = fmaxf(max1[j % kChains], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const auto max_op = [](float a, float b) { return fmaxf(a, b); };
    combine(max0, max_op);
    combine(max1, max_op);
    float m0 = max0[0], m1 = max1[0];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    m0 *= scale_log2;
    m1 *= scale_log2;
    float sum0[kChains], sum1[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) sum0[c] = sum1[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[4 * j + e], scale_log2, e < 2 ? -m0 : -m1);
        s[4 * j + e] = with_exp ? exp2_approx(x) : x;
      }
      sum0[j % kChains] += s[4 * j] + s[4 * j + 1];
      sum1[j % kChains] += s[4 * j + 2] + s[4 * j + 3];
    }
    const auto sum_op = [](float a, float b) { return a + b; };
    combine(sum0, sum_op);
    combine(sum1, sum_op);
    float total0 = sum0[0], total1 = sum1[0];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      total0 += __shfl_xor_sync(0xffffffffu, total0, off);
      total1 += __shfl_xor_sync(0xffffffffu, total1, off);
    }
    inv0 = 1.0f / total0;
    inv1 = 1.0f / total1;
  }
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    const float* a = s + 8 * kt;
    p[kt][0] = pack_floats(a[0] * inv0, a[1] * inv0);
    p[kt][1] = pack_floats(a[2] * inv1, a[3] * inv1);
    p[kt][2] = pack_floats(a[4] * inv0, a[5] * inv0);
    p[kt][3] = pack_floats(a[6] * inv1, a[7] * inv1);
  }
}

template <int HD, int NKT>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out, int BH, int N,
                 float scale, int probe) {
  using B = Buffers<HD, NKT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * B::kBytes);
  uint64_t* empty = full + 2;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbarrier_init(&full[b], 1);
      mbarrier_init(&empty[b], kConsumerWarps);
    }
    mbarrier_init_fence();
  }
  __syncthreads();
  const int q_tiles = (N + kQRows - 1) / kQRows;

  // The roles part here and never meet again: no block-wide barrier below.
  // Head i of this block lives in buffer i % 2, whose barriers are in their
  // phase i / 2 for it.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const bool prefetch = !(probe & kProbeNoPrefetch);
      const uint32_t bytes = q_tiles * B::kQTileBytes + 2 * B::kKVBytes;  // zeros count
      for (int head = blockIdx.x, i = 0; head < BH; head += gridDim.x, ++i) {
        const int b = i & 1;
        if (prefetch) {
          if (i >= 2) mbarrier_wait(&empty[b], ((i >> 1) + 1) & 1);  // head i - 2 is released
        } else if (i >= 1) {
          mbarrier_wait(&empty[b ^ 1], ((i - 1) >> 1) & 1);  // head i - 1 is released
        }
        unsigned char* buf = smem + b * B::kBytes;
        mbarrier_arrive_expect_tx(&full[b], bytes);
        for (int tile = 0; tile < q_tiles; ++tile)
          tma_load_3d(buf + tile * B::kQTileBytes, &map_q, &full[b], 0, tile * kQRows, head);
        tma_load_3d(buf + B::kK, &map_k, &full[b], 0, 0, head);
        tma_load_3d(buf + B::kV, &map_v, &full[b], 0, 0, head);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int group = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool softmax = !(probe & kProbeNoSoftmax);
  const bool values = !(probe & kProbeNoValues);
  const bool with_exp = !(probe & kProbeNoExp);
  const float scale_log2 = scale * kLog2e;
  for (int head = blockIdx.x, i = 0; head < BH; head += gridDim.x, ++i) {
    const int b = i & 1;
    const unsigned char* buf = smem + b * B::kBytes;
    // Every consumer warp waits, even one without a tile of this head: an
    // arrival on "empty" must not run ahead into the buffer's next phase.
    mbarrier_wait(&full[b], (i >> 1) & 1);
    const uint64_t desc_k = wgmma_descriptor_swizzled<B::kRowBytes>(buf + B::kK);
    const uint64_t desc_v = wgmma_descriptor_swizzled<B::kRowBytes>(buf + B::kV);
    // The warpgroups take the query tiles in turn, the first by head parity,
    // so that a short last tile (5 rows at N 197) falls to each in turn.
    for (int tile = (group + i) & 1; tile < q_tiles; tile += 2) {
      const uint64_t desc_q = wgmma_descriptor_swizzled<B::kRowBytes>(buf + tile * B::kQTileBytes);
      float s[8 * NKT];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // 16 along hd is 32 bytes: 2 descriptor units
        wgmma_scores<NKT>(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(s);

      const int r0 = tile * kQRows + 16 * warp;  // this warp's first row
      uint32_t p[NKT][4];
      if (r0 < N) {
        attention_weights<NKT>(s, p, N, scale_log2, t, softmax, with_exp);
      } else {  // no row of this warp is a token: its weights are never read
#pragma unroll
        for (int kt = 0; kt < NKT; ++kt) p[kt][0] = p[kt][1] = p[kt][2] = p[kt][3] = 0u;
      }
      uint32_t lo[HD / 8], hi[HD / 8];  // o[4 n + e]: column tile n, as s
      if (values) {
        float o[HD / 2];
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < NKT; ++kt)  // 16 keys are 16 rows of V
          wgmma_values<HD>(o, p[kt], desc_v + kt * ((16 * B::kRowBytes) >> 4), kt);
        wgmma_commit();
        wgmma_wait<0>();  // V is read and p free
        wgmma_pin(o);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          lo[n] = pack_floats(o[4 * n], o[4 * n + 1]);
          hi[n] = pack_floats(o[4 * n + 2], o[4 * n + 3]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          lo[n] = p[n / 2][2 * (n % 2)];
          hi[n] = p[n / 2][2 * (n % 2) + 1];
        }
      }
      const int row_a = r0 + g;
      bf16* out_a = out + (static_cast<long>(head) * N + row_a) * HD;
      store_tile_rows<HD>(out_a, out_a + 8 * HD, lo, hi, row_a < N, row_a + 8 < N, t);
    }
    __syncwarp();
    if (lane == 0) mbarrier_arrive(&empty[b]);
  }
}

// ---------------------------------------------------------------------------
// The first design, kept for timing only (kProbeFirstDesign).
// ---------------------------------------------------------------------------

constexpr int kFirstWarps = 4;
constexpr int kFirstRows = 16 * kFirstWarps;  // query rows per block

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kFirstWarps)
attention_first_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int N, float scale) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kFirstRows * kLd;
  bf16* s_v = s_k + kPad * kLd;

  const long head = static_cast<long>(blockIdx.y) * N * HD;  // this (batch, head) slice
  const int q0 = blockIdx.x * kFirstRows;
  stage_rows_async<HD>(s_q, kFirstRows, q + head, q0, N, HD);
  stage_rows_async<HD>(s_k, kPad, k + head, 0, N, HD);
  stage_rows_async<HD>(s_v, kPad, v + head, 0, N, HD);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;
  if (q0 + r0 >= N) return;  // no barrier follows

  float o[HD / 8][4];
  attention_rows<HD, NKT, false, true>(s_q, s_k, s_v, r0, lane, N, 1, o, scale);

  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  bf16* out_a = out + head + static_cast<long>(row_a) * HD + 2 * t;
  bf16* out_b = out_a + 8 * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row_a < N) *reinterpret_cast<uint32_t*>(out_a + n * 8) = pack_floats(o[n][0], o[n][1]);
    if (row_b < N) *reinterpret_cast<uint32_t*>(out_b + n * 8) = pack_floats(o[n][2], o[n][3]);
  }
}

template <int HD, int NKT>
__global__ void __launch_bounds__(32 * kBwdWarps)
attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                     float scale) {
  constexpr int kLd = HD + 8;
  constexpr int kPad = NKT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kPad * kLd;
  bf16* s_v = s_k + kPad * kLd;
  bf16* s_do = s_v + kPad * kLd;
  float* s_max = reinterpret_cast<float*>(s_do + kPad * kLd);
  float* s_inv = s_max + kPad;
  float* s_tmp = s_inv + kPad;

  const long head = static_cast<long>(blockIdx.x) * N * HD;
  stage_rows_async<HD>(s_q, kPad, q + head, 0, N, HD);
  stage_rows_async<HD>(s_k, kPad, k + head, 0, N, HD);
  stage_rows_async<HD>(s_v, kPad, v + head, 0, N, HD);
  stage_rows_async<HD>(s_do, kPad, dout + head, 0, N, HD);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  attention_backward_recompute_ds<HD, NKT, kBwdExact>(s_q, s_k, s_v, s_do, s_max, s_inv, s_tmp, nullptr,
                                               dq + head, dk + head, dv + head, HD, N, N, 1.0f,
                                               scale, 1);
}

template <int HD, int NKT>
cudaError_t launch_first(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int N,
                         float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kFirstRows + 2 * NKT * 16) * (HD + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attention_first_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kFirstRows - 1) / kFirstRows, BH);
  attention_first_kernel<HD, NKT><<<grid, 32 * kFirstWarps, smem, stream>>>(q, k, v, out, N, scale);
  return cudaGetLastError();
}

template <int HD, int NKT>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int N,
                   float scale, int probe, cudaStream_t stream) {
  if (probe & kProbeFirstDesign) return launch_first<HD, NKT>(q, k, v, out, BH, N, scale, stream);
  using B = Buffers<HD, NKT>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_tensor_map_matrices(&map_q, q, BH, N, HD, kQRows);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_matrices(&map_k, k, BH, N, HD, B::kKeys);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_matrices(&map_v, v, BH, N, HD, B::kKeys);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = allow_dynamic_smem(attention_kernel<HD, NKT>, B::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = BH < sms ? BH : sms;  // persistent: one block an SM at most
  attention_kernel<HD, NKT><<<blocks, kThreads, B::kSmemBytes, stream>>>(
      map_q, map_k, map_v, out, BH, N, scale, probe);
  return cudaGetLastError();
}

template <int HD, int NKT>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                       bf16* dk, bf16* dv, int BH, int N, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(4 * NKT * 16) * (HD + 8) * sizeof(bf16) +
                      static_cast<size_t>(3 * NKT * 16) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<HD, NKT><<<BH, 32 * kBwdWarps, smem, stream>>>(q, k, v, dout, dq, dk, dv, N,
                                                                     scale);
  return cudaGetLastError();
}

// Calls CALL(HD, NKT) for the head dim and token count; cudaErrorInvalidValue
// for a shape the kernels do not take.
#define SSL4POLYP_FOR_SHAPE(CALL)                 \
  switch (head_dim) {                             \
    case 16: SSL4POLYP_FOR_TOKENS(CALL, 16)       \
    case 32: SSL4POLYP_FOR_TOKENS(CALL, 32)       \
    case 64: SSL4POLYP_FOR_TOKENS(CALL, 64)       \
    default: return cudaErrorInvalidValue;        \
  }

cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int N,
                     int head_dim, float scale, int probe, cudaStream_t stream) {
#define SSL4POLYP_FWD(HD, NKT) launch<HD, NKT>(q, k, v, out, BH, N, scale, probe, stream)
  SSL4POLYP_FOR_SHAPE(SSL4POLYP_FWD)
#undef SSL4POLYP_FWD
}

cudaError_t dispatch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                         bf16* dk, bf16* dv, int BH, int N, int head_dim, float scale,
                         cudaStream_t stream) {
#define SSL4POLYP_BWD(HD, NKT) launch_bwd<HD, NKT>(q, k, v, dout, dq, dk, dv, BH, N, scale, stream)
  SSL4POLYP_FOR_SHAPE(SSL4POLYP_BWD)
#undef SSL4POLYP_BWD
}

#undef SSL4POLYP_FOR_SHAPE

}  // namespace

// q, k, v, out: (BH, N, head_dim) bf16, contiguous, 16-byte aligned (BH =
// batch * heads); head_dim 16, 32 or 64, N <= 256; scale is the fp32
// 1/sqrt(head_dim).  `probe` (0 on every path) is a measurement aid: the
// kProbe* bits above.  Returns the CUDA error of the tensor maps or the launch.
extern "C" int ssl4polyp_attention_fwd_probe(const void* q, const void* k, const void* v, void* out,
                                             int BH, int N, int head_dim, float scale, int probe,
                                             void* stream) {
  if (BH < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), static_cast<bf16*>(out), BH, N,
                                   head_dim, scale, probe, static_cast<cudaStream_t>(stream)));
}

// ssl4polyp_attention_fwd_probe with probe 0.
extern "C" int ssl4polyp_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       int BH, int N, int head_dim, float scale, void* stream) {
  return ssl4polyp_attention_fwd_probe(q, k, v, out, BH, N, head_dim, scale, 0, stream);
}

// The backward of ssl4polyp_attention_fwd for the output gradient dout; dq,
// dk, dv as q, k, v.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv, int BH,
                                       int N, int head_dim, float scale, void* stream) {
  return static_cast<int>(dispatch_bwd(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), BH, N, head_dim, scale, static_cast<cudaStream_t>(stream)));
}
