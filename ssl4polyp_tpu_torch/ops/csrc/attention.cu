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
// The backward (the second design, replacing _attention_bwd_kernel; PERF.md
// has its times beside the first design's and the ablations, through
// ssl4polyp_attention_bwd_probe).  What bounds it: at the classifier's shape
// 135.6 MB move in 0.0405 ms at the HBM rate, and the products it issues,
// 64-row tiles over 208 keys with the second terms, are 57.6 GFLOP (0.058 ms
// at the tensor cores' peak); at the MAE decoder's (64, 16, 197, 32) 0.0270
// ms and 38.4 GFLOP (0.039 ms).  Two exponentials a score and the hi + lo
// splits load the special function units beside them.
//   * The grid and loads are the forward's: a persistent grid over the B * H
//     heads, a producer thread loading a head's Q, K, V and dO as four 3-D
//     TMA boxes of the 16 * NKT rows the key width holds (rows at or past N
//     zeros, no box reading the next head) into one of two buffers (213 KB
//     at hd 64 and N 197; one buffer at hd 64 past 208 tokens, where two do
//     not fit), released by an arrival of each consumer warp.
//   * Phase A: 64-row query tiles, the two consumer warpgroups in turn.  S =
//     Q K^T on wgmma (both K-major), the keys at or past N masked, the exact
//     softmax in registers (the forward's softmax_exponentials), W kept
//     there in fp32; each row's max (times scale * log2 e) and 1 / sum go to
//     shared memory.  dW = dO V^T in chunks of 64 keys (16 for the last at
//     the key width 208) gives tmp = rowsum(dW * W); then each chunk's dW
//     again gives dS = W (dW - tmp) scale, split in registers into hi + lo,
//     and dQ += dS_hi K + dS_lo K by register-A wgmma with K the MN-major B
//     operand (as the forward's P V reads V).  The last tile reads the 64
//     rows that end at the key width (at N 197 rows 144 .. 207), so no read
//     leaves the box; its warps below the rows it owns skip their arithmetic
//     and write nothing.  Every warp of a tile writes the statistics of the
//     rows it owns, zeros at or past N, those without a row below N
//     included: phase B's chunks read every row of a tile that begins
//     before N, and shared memory holds what the last kernel left there.
//   * A named barrier over the two warpgroups: every row's statistics are
//     in.  Two sets of them, by head parity, let a warpgroup start the next
//     head's phase A while the other finishes this head's phase B.
//   * Phase B: 64-row key tiles.  S^T = K Q^T and dW^T = V dO^T in chunks of
//     64 queries (both K-major), W^T rebuilt from the stored max and 1 / sum
//     with phase A's formula, dS^T from the stored tmp; query rows at or past
//     N have zero max, 1 / sum and tmp, and zero Q and dO rows, so their W^T
//     and dS^T are zero.  dV +=
//     W^T_hi dO + W^T_lo dO and dK += dS^T_hi Q + dS^T_lo Q by register-A
//     wgmma, dO and Q MN-major.  dK and dV sum over every query inside one
//     warpgroup; dQ over every key inside one: no atomics, reruns give the
//     same bits.  Stores are the forward's row-guarded 16-byte stores:
//     nothing past row N - 1 of a head is written.
//   * Neither W nor dS touches shared or device memory, no operand is
//     gathered by hand, and no product reads a transposed copy: 11 product
//     passes of the tile, all on wgmma.  An fp32 operand enters as x = hi +
//     lo, two bf16 terms (16 bits of mantissa), each with its own product.
//   * Phase B's W^T comes from phase A's formula and statistics, but from S^T
//     = K Q^T, whose fp32 sums the tensor cores may take in another order
//     than S = Q K^T's: its bits are not promised equal to phase A's W, and
//     the plain version stays the judge.
//   * hd 16, 32 and 64 (rows of 32, 64 and 128 bytes, each under the swizzle
//     of its width) and every token count up to 256 take this kernel; no
//     shape goes to the first design.
//   * ptxas: the consumers run at up to 232 registers (setmaxnreg; the launch
//     reports 168); no spills at the key widths 64, 128 and 208; at 256 (N
//     209 .. 256, no timed shape) 8 bytes spill at hd 64 (160 in the probe's
//     instance, 32 there at hd 32), and ptxas serialises the products there
//     for want of registers.
//   * Where the time goes (PERF.md, through the probe): phase B about half,
//     phase A's dW, tmp and dQ passes about a third, the rest the loads, S
//     and the softmax; the second terms' products about a tenth.  Each
//     warpgroup waits on every product group it issues, and what it waits
//     for is mostly latency: the tensor cores run at about 40 % of their
//     peak.
//   * Tried and dropped, each slower or level at both timed shapes (PERF.md):
//     32-row chunks with the next chunk's products issued under this chunk's
//     arithmetic, two deep (spills; ptxas serialised the products) or one
//     deep; the next chunk's S^T and dW^T issued in one group behind this
//     chunk's dV and dK products (spills at hd 64); the two warpgroups
//     taking turns at issuing each product group by named barriers; a
//     producer warp alone (288 threads: ptxas holds a thread to 168
//     registers all the same, where setmaxnreg gives the consumers 232);
//     and the hi + lo split with hi truncated (one conversion a pair).
//
// The backward's first design (attention_bwd_first_kernel, reached only
// through the probe): one block of 8 warps per (batch, head), Q, K, V and dO
// staged by cp.async, then attention_core.cuh's two-phase
// attention_backward_recompute_ds in mode kBwdExact on mma.sync.
#include "attention_core.cuh"
#include "hopper.cuh"

#include <type_traits>

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

// The exact softmax of a warp's rows g and g + 8 from their scores (s[4 j +
// e]: key 8 j + 2 t + (e & 1), row g for e < 2, else g + 8, as wgmma leaves
// them), in place: keys >= N masked, then s <- 2^(s * scale_log2 - m) with m
// the row's max times scale_log2 (scale_log2 = scale * log2(e)); m and
// 1 / sum for each row.  Without `with_exp` the exponential is left out (a
// measurement aid).  Only the column tiles that may reach past N for this
// width are masked, and the maxima and sums run as kChains chains a row
// (column tile j in chain j % kChains), combined pairwise: short dependent
// chains are what a warp's softmax waits on.
template <int NKT>
__device__ __forceinline__ void softmax_exponentials(float (&s)[8 * NKT], int N, float scale_log2,
                                                     int t, bool with_exp, float (&m)[2],
                                                     float (&inv)[2]) {
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
  m[0] = m0;
  m[1] = m1;
  inv[0] = 1.0f / total0;
  inv[1] = 1.0f / total1;
}

// The weights of a warp's rows g and g + 8 from their scores (softmax_exponentials),
// normalised and rounded into p, wgmma's A fragments of the 16-key steps
// (p[kt]: keys 16 kt + 2t, + 1 of rows g and g + 8, then keys 16 kt + 8 +
// 2t, + 1).  Without `softmax`, p is S rounded; without `with_exp`, the
// exponential is left out (measurement aids).
template <int NKT>
__device__ __forceinline__ void attention_weights(float (&s)[8 * NKT], uint32_t (&p)[NKT][4],
                                                  int N, float scale_log2, int t, bool softmax,
                                                  bool with_exp) {
  float m[2] = {0.0f, 0.0f}, inv[2] = {1.0f, 1.0f};
  if (softmax) softmax_exponentials<NKT>(s, N, scale_log2, t, with_exp, m, inv);
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    const float* a = s + 8 * kt;
    p[kt][0] = pack_floats(a[0] * inv[0], a[1] * inv[0]);
    p[kt][1] = pack_floats(a[2] * inv[1], a[3] * inv[1]);
    p[kt][2] = pack_floats(a[4] * inv[0], a[5] * inv[0]);
    p[kt][3] = pack_floats(a[6] * inv[1], a[7] * inv[1]);
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
// The backward (the note at the head of this file).
// ---------------------------------------------------------------------------

// `probe` bits of the backward, a measurement aid (0 on every path;
// chip_smoke.py times the kernel with parts left out, whose results are
// wrong): phase B left out (dK, dV unwritten), phase A stopped after the
// softmax and its statistics (no dW, tmp or dQ), the fp32 operands as their
// bf16 rounding alone (no second term's products); and, with right results,
// one buffer (a head is loaded only once the last is released) and the
// first design.  The kernel reads the first four only in its kProbed
// instance, which probe 0 never launches: the path's instance compiles
// without their branches.
constexpr int kBwdProbeNoPhaseB = 1;
constexpr int kBwdProbeSoftmaxOnly = 2;
constexpr int kBwdProbeNoPrefetch = 4;
constexpr int kBwdProbeFirstDesign = 8;
constexpr int kBwdProbeOneTerm = 16;

constexpr int kBwdTile = 64;   // the rows of a phase-A query tile or a phase-B key tile
constexpr int kBwdChunk = 64;  // the keys of a phase-A dW chunk, the queries of a phase-B chunk

// A head's Q, K, V and dO, each one TMA box of the 16 * NKT rows the key
// width holds (rows at or past N are zeros), each aligned to 1,024 bytes;
// two buffers where they fit beside the statistics, else one; then two sets
// of the statistics (each query row's scaled max, 1 / sum and tmp), by the
// head's parity.
template <int HD, int NKT>
struct BwdBuffers {
  static constexpr int kRowBytes = 2 * HD;
  static constexpr int kRows = 16 * NKT;
  static constexpr uint32_t kBoxBytes = kRows * kRowBytes;
  static constexpr uint32_t kStride = (kBoxBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kQ = 0;  // offsets in a buffer
  static constexpr uint32_t kK = kStride;
  static constexpr uint32_t kV = 2 * kStride;
  static constexpr uint32_t kDo = 3 * kStride;
  static constexpr uint32_t kBytes = 4 * kStride;
  static constexpr uint32_t kStatBytes = 3 * kRows * sizeof(float);
  static constexpr size_t kFixed = 2 * kStatBytes + 4 * sizeof(uint64_t) + 1024;
  static constexpr int kBuffers = 2 * kBytes + kFixed <= 232448 ? 2 : 1;
  static constexpr size_t kSmemBytes = kBuffers * kBytes + kFixed;
  static_assert(kSmemBytes <= 232448, "the block's shared memory");
  // Chunks of kBwdChunk along the 16 * NKT rows, the last kTail wide (16 at NKT 13).
  static constexpr int kChunks = (kRows + kBwdChunk - 1) / kBwdChunk;
  static constexpr int kTail = kRows - (kChunks - 1) * kBwdChunk;
  static_assert(kTail == kBwdChunk || kTail == 16, "a chunk width of the products");
};

// Calls body(width, c) for chunk c of the 16 * NKT rows (width an
// integral_constant: kBwdChunk, or kTail for the last) where the chunk
// begins before row N; the loop unrolls, so c is a constant in each call.
// Chunk c holds the rows that phase A's tile c owns, and every warp of that
// tile writes its rows' statistics, zeros at or past N.
template <int HD, int NKT, typename Body>
__device__ __forceinline__ void for_chunks(int N, Body&& body) {
  using B = BwdBuffers<HD, NKT>;
  constexpr int kFull = B::kTail == kBwdChunk ? B::kChunks : B::kChunks - 1;
#pragma unroll
  for (int c = 0; c < kFull; ++c)
    if (kBwdChunk * c < N) body(std::integral_constant<int, kBwdChunk>(), c);
  if constexpr (kFull < B::kChunks) {
    if (kBwdChunk * kFull < N) body(std::integral_constant<int, B::kTail>(), kFull);
  }
}

// D = A . B^T over the K = HD columns of two K-major tiles, for an N of W
// rows of B (64, or a 16-row tail).
template <int HD, int W>
__device__ __forceinline__ void wgmma_chunk(float (&d)[W / 2], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {  // 16 along hd is 32 bytes: 2 descriptor units
    if constexpr (W == 64) {
      wgmma_m64n64k16(d, desc_a + 2 * kk, desc_b + 2 * kk, kk);
    } else {
      static_assert(W == 16, "a chunk width");
      wgmma_m64n16k16(d, desc_a + 2 * kk, desc_b + 2 * kk, kk);
    }
  }
}

// The 16-row steps of a chunk as register-A products with a MN-major B of
// RB-byte rows: acc += hi[kt] . B rows (16 kt ..) and, with `two_terms`, +=
// lo[kt] . the same rows.  desc_b points at the chunk's first row.
template <int HD, int W, int RB>
__device__ __forceinline__ void wgmma_split_steps(float (&acc)[HD / 2], const uint32_t (&hi)[W / 16][4],
                                                  const uint32_t (&lo)[W / 16][4], uint64_t desc_b,
                                                  bool two_terms) {
#pragma unroll
  for (int kt = 0; kt < W / 16; ++kt) {
    const uint64_t desc = desc_b + kt * ((16 * RB) >> 4);
    wgmma_values<HD>(acc, hi[kt], desc, 1);
    if (two_terms) wgmma_values<HD>(acc, lo[kt], desc, 1);
  }
}

// Rounds a warp's accumulator rows g and g + 8 (acc[4 n + e], as wgmma
// leaves them) to bf16 and stores the rows whose flags are set.
template <int HD>
__device__ __forceinline__ void store_accumulator_rows(bf16* out_a, const float (&acc)[HD / 2],
                                                       bool ok_a, bool ok_b, int t) {
  uint32_t lo[HD / 8], hi[HD / 8];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    lo[n] = pack_floats(acc[4 * n], acc[4 * n + 1]);
    hi[n] = pack_floats(acc[4 * n + 2], acc[4 * n + 3]);
  }
  store_tile_rows<HD>(out_a, out_a + 8 * HD, lo, hi, ok_a, ok_b, t);
}

template <int HD, int NKT, bool kProbed>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int N, float scale,
                     int probe_bits) {
  using B = BwdBuffers<HD, NKT>;
  constexpr int RB = B::kRowBytes;
  const int probe = kProbed ? probe_bits : 0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_address(smem_raw) & 1023u)) & 1023u);
  float* stat_sets = reinterpret_cast<float*>(smem + B::kBuffers * B::kBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat_sets + 2 * 3 * B::kRows);
  uint64_t* empty = full + 2;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbarrier_init(&full[b], 1);
      mbarrier_init(&empty[b], kConsumerWarps);
    }
    mbarrier_init_fence();
  }
  __syncthreads();
  // Head i of this block lives in buffer i % buffers, whose barriers are in
  // their phase i / buffers for it.
  const int buffers = (probe & kBwdProbeNoPrefetch) ? 1 : B::kBuffers;
  const int tiles = (N + kBwdTile - 1) / kBwdTile;

  // The roles part here; the consumers meet at a named barrier of their own.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int head = blockIdx.x, i = 0; head < BH; head += gridDim.x, ++i) {
        const int b = buffers == 2 ? i & 1 : 0;
        const int use = buffers == 2 ? i >> 1 : i;  // the buffer's earlier heads
        if (use >= 1) mbarrier_wait(&empty[b], (use - 1) & 1);
        unsigned char* buf = smem + b * B::kBytes;
        mbarrier_arrive_expect_tx(&full[b], 4 * B::kBoxBytes);  // zeros count
        tma_load_3d(buf + B::kQ, &map_q, &full[b], 0, 0, head);
        tma_load_3d(buf + B::kK, &map_k, &full[b], 0, 0, head);
        tma_load_3d(buf + B::kV, &map_v, &full[b], 0, 0, head);
        tma_load_3d(buf + B::kDo, &map_do, &full[b], 0, 0, head);
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
  const bool phase_b = !(probe & kBwdProbeNoPhaseB);
  const bool softmax_only = probe & kBwdProbeSoftmaxOnly;
  const bool two_terms = !(probe & kBwdProbeOneTerm);
  const float scale_log2 = scale * kLog2e;
  for (int head = blockIdx.x, i = 0; head < BH; head += gridDim.x, ++i) {
    const int b = buffers == 2 ? i & 1 : 0;
    const unsigned char* buf = smem + b * B::kBytes;
    float* s_max = stat_sets + (i & 1) * 3 * B::kRows;  // each row's max times scale_log2
    float* s_inv = s_max + B::kRows;
    float* s_tmp = s_inv + B::kRows;
    // Every consumer warp waits, even one without a tile of this head: an
    // arrival on "empty" must not run ahead into the buffer's next phase.
    mbarrier_wait(&full[b], (buffers == 2 ? i >> 1 : i) & 1);
    const uint64_t desc_q = wgmma_descriptor_swizzled<RB>(buf + B::kQ);
    const uint64_t desc_k = wgmma_descriptor_swizzled<RB>(buf + B::kK);
    const uint64_t desc_v = wgmma_descriptor_swizzled<RB>(buf + B::kV);
    const uint64_t desc_do = wgmma_descriptor_swizzled<RB>(buf + B::kDo);
    const long head_at = static_cast<long>(head) * N * HD;

    // Phase A: 64-row query tiles, the warpgroups in turn (the first by the
    // head's parity).  Tile `tile` owns rows 64 tile .. 64 tile + 63; the
    // last reads the 64 rows that end at 16 * NKT (at N 197: 144 .. 207),
    // and its warps below the rows it owns skip their arithmetic and write
    // nothing.
    for (int tile = (group + i) & 1; tile < tiles; tile += 2) {
      const int start = min(kBwdTile * tile, B::kRows - kBwdTile);
      const int r0 = start + 16 * warp;  // this warp's first row
      const bool owned = r0 >= kBwdTile * tile;
      const bool active = owned && r0 < N;
      const uint64_t desc_qt = desc_q + ((start * RB) >> 4);
      const uint64_t desc_dot = desc_do + ((start * RB) >> 4);
      float s[8 * NKT];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_scores<NKT>(s, desc_qt + 2 * kk, desc_k + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(s);
      float m[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
      if (active) {
        softmax_exponentials<NKT>(s, N, scale_log2, t, true, m, inv);
#pragma unroll
        for (int j = 0; j < 2 * NKT; ++j)  // s <- W, the normalised fp32 weights
#pragma unroll
          for (int e = 0; e < 4; ++e) s[4 * j + e] *= inv[e >> 1];
      }

      // tmp = rowsum(dW * W), dW = dO V^T a chunk of keys at a time.
      float tmp[2] = {0.0f, 0.0f};
      if (!softmax_only) {
        for_chunks<HD, NKT>(N, [&](auto width, int c) {  // keys >= N: W is zero
          constexpr int W = decltype(width)::value;
          float dw[W / 2];
          wgmma_fence();
          wgmma_chunk<HD, W>(dw, desc_dot, desc_v + ((kBwdChunk * c * RB) >> 4));
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_pin(dw);
          if (active) {
#pragma unroll
            for (int jj = 0; jj < W / 8; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                tmp[e >> 1] = fmaf(dw[4 * jj + e], s[4 * (8 * c + jj) + e], tmp[e >> 1]);
          }
        });
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          tmp[0] += __shfl_xor_sync(0xffffffffu, tmp[0], off);
          tmp[1] += __shfl_xor_sync(0xffffffffu, tmp[1], off);
        }
      }
      // Every row a tile owns gets statistics, those at or past N zeros (zero
      // weights in phase B): phase B's chunks read them all, and shared
      // memory holds whatever the last kernel on this SM left there.
      if (owned && t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + g + 8 * h;
          const bool token = row < N;
          s_max[row] = token ? m[h] : 0.0f;
          s_inv[row] = token ? inv[h] : 0.0f;
          s_tmp[row] = token ? tmp[h] : 0.0f;
        }
      }
      if (softmax_only) continue;

      // dQ = dS K, dS = W (dW - tmp) scale formed a chunk at a time (dW
      // again) and split into hi + lo in registers.
      float acc[HD / 2];
#pragma unroll
      for (int n = 0; n < HD / 2; ++n) acc[n] = 0.0f;
      for_chunks<HD, NKT>(N, [&](auto width, int c) {
        constexpr int W = decltype(width)::value;
        float dw[W / 2];
        wgmma_fence();
        wgmma_chunk<HD, W>(dw, desc_dot, desc_v + ((kBwdChunk * c * RB) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(dw);
        uint32_t hi[W / 16][4] = {}, lo[W / 16][4] = {};
        if (active) {
#pragma unroll
          for (int kt = 0; kt < W / 16; ++kt) {
            float ds[8];  // column tile 2 kt + x / 4, element x % 4
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              const int jj = 2 * kt + x / 4, e = x % 4;
              ds[x] = s[4 * (8 * c + jj) + e] * (dw[4 * jj + e] - tmp[e >> 1]) * scale;
            }
            pack_a<true>(hi[kt], lo[kt], ds);
          }
        }
        wgmma_fence();
        wgmma_split_steps<HD, W, RB>(acc, hi, lo, desc_k + ((kBwdChunk * c * RB) >> 4),
                                     two_terms);
        wgmma_commit();
        wgmma_wait<0>();  // hi and lo are free
        wgmma_pin(acc);
      });
      if (active) {
        const int row_a = r0 + g;
        store_accumulator_rows<HD>(dq + head_at + static_cast<long>(row_a) * HD, acc, row_a < N,
                                   row_a + 8 < N, t);
      }
    }
    named_barrier_sync(1, 256);  // every query row's statistics are in

    // Phase B: 64-row key tiles, as phase A's query tiles.  W^T and dS^T
    // from S^T = K Q^T, dW^T = V dO^T and the statistics, a chunk of queries
    // at a time; dV += W^T dO, dK += dS^T Q.
    for (int tile = (group + i) & 1; phase_b && tile < tiles; tile += 2) {
      const int start = min(kBwdTile * tile, B::kRows - kBwdTile);
      const int r0 = start + 16 * warp;
      const bool active = r0 >= kBwdTile * tile && r0 < N;
      const uint64_t desc_kt = desc_k + ((start * RB) >> 4);
      const uint64_t desc_vt = desc_v + ((start * RB) >> 4);
      float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
      for (int n = 0; n < HD / 2; ++n) acc_k[n] = acc_v[n] = 0.0f;
      for_chunks<HD, NKT>(N, [&](auto width, int c) {  // queries >= N add nothing
        constexpr int W = decltype(width)::value;
        const uint64_t chunk = (kBwdChunk * c * RB) >> 4;
        float st[W / 2], dwt[W / 2];
        wgmma_fence();
        wgmma_chunk<HD, W>(st, desc_kt, desc_q + chunk);
        wgmma_chunk<HD, W>(dwt, desc_vt, desc_do + chunk);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(st);
        wgmma_pin(dwt);
        // Element (jj, e): key row g (+ 8 for e >= 2), query 64 c + 8 jj + 2t + (e & 1).
        uint32_t w_hi[W / 16][4] = {}, w_lo[W / 16][4] = {};
        uint32_t ds_hi[W / 16][4] = {}, ds_lo[W / 16][4] = {};
        if (active) {
#pragma unroll
          for (int kt = 0; kt < W / 16; ++kt) {
            float w[8], ds[8];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int jj = 2 * kt + half;
              const int q = kBwdChunk * c + 8 * jj + 2 * t;
              const float2 qm = *reinterpret_cast<const float2*>(s_max + q);
              const float2 qi = *reinterpret_cast<const float2*>(s_inv + q);
              const float2 qt = *reinterpret_cast<const float2*>(s_tmp + q);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const bool odd = e & 1;
                const float x = fmaf(st[4 * jj + e], scale_log2, -(odd ? qm.y : qm.x));
                const float weight = exp2_approx(x) * (odd ? qi.y : qi.x);
                w[4 * half + e] = weight;
                ds[4 * half + e] = weight * (dwt[4 * jj + e] - (odd ? qt.y : qt.x)) * scale;
              }
            }
            pack_a<true>(w_hi[kt], w_lo[kt], w);
            pack_a<true>(ds_hi[kt], ds_lo[kt], ds);
          }
        }
        wgmma_fence();
        wgmma_split_steps<HD, W, RB>(acc_v, w_hi, w_lo, desc_do + chunk, two_terms);
        wgmma_split_steps<HD, W, RB>(acc_k, ds_hi, ds_lo, desc_q + chunk, two_terms);
        wgmma_commit();
        wgmma_wait<0>();  // the fragments are free
        wgmma_pin(acc_v);
        wgmma_pin(acc_k);
      });
      if (active) {
        const int row_a = r0 + g;
        const long at = head_at + static_cast<long>(row_a) * HD;
        store_accumulator_rows<HD>(dk + at, acc_k, row_a < N, row_a + 8 < N, t);
        store_accumulator_rows<HD>(dv + at, acc_v, row_a < N, row_a + 8 < N, t);
      }
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
attention_bwd_first_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
cudaError_t launch_bwd_first(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                             bf16* dk, bf16* dv, int BH, int N, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(4 * NKT * 16) * (HD + 8) * sizeof(bf16) +
                      static_cast<size_t>(3 * NKT * 16) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_first_kernel<HD, NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_bwd_first_kernel<HD, NKT><<<BH, 32 * kBwdWarps, smem, stream>>>(q, k, v, dout, dq, dk,
                                                                           dv, N, scale);
  return cudaGetLastError();
}

template <int HD, int NKT>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                       bf16* dk, bf16* dv, int BH, int N, float scale, int probe,
                       cudaStream_t stream) {
  if (probe & kBwdProbeFirstDesign)
    return launch_bwd_first<HD, NKT>(q, k, v, dout, dq, dk, dv, BH, N, scale, stream);
  using B = BwdBuffers<HD, NKT>;
  CUtensorMap maps[4];
  const bf16* operands[4] = {q, k, v, dout};
  for (int m = 0; m < 4; ++m) {
    const cudaError_t err = make_tensor_map_matrices(&maps[m], operands[m], BH, N, HD, B::kRows);
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = BH < sms ? BH : sms;  // persistent: one block an SM at most
  if (probe == 0) {
    static bool configured[kMaxDevices] = {};
    err = allow_dynamic_smem(attention_bwd_kernel<HD, NKT, false>, B::kSmemBytes, configured);
    if (err != cudaSuccess) return err;
    attention_bwd_kernel<HD, NKT, false><<<blocks, kThreads, B::kSmemBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], dq, dk, dv, BH, N, scale, 0);
  } else {
    static bool configured[kMaxDevices] = {};
    err = allow_dynamic_smem(attention_bwd_kernel<HD, NKT, true>, B::kSmemBytes, configured);
    if (err != cudaSuccess) return err;
    attention_bwd_kernel<HD, NKT, true><<<blocks, kThreads, B::kSmemBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], dq, dk, dv, BH, N, scale, probe);
  }
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
                         bf16* dk, bf16* dv, int BH, int N, int head_dim, float scale, int probe,
                         cudaStream_t stream) {
#define SSL4POLYP_BWD(HD, NKT) \
  launch_bwd<HD, NKT>(q, k, v, dout, dq, dk, dv, BH, N, scale, probe, stream)
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
// dk, dv as q, k, v.  `probe` (0 on every path) is a measurement aid: the
// kBwdProbe* bits above.  Returns the CUDA error of the tensor maps or the
// launch.
extern "C" int ssl4polyp_attention_bwd_probe(const void* q, const void* k, const void* v,
                                             const void* dout, void* dq, void* dk, void* dv,
                                             int BH, int N, int head_dim, float scale, int probe,
                                             void* stream) {
  if (BH < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_bwd(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), BH, N, head_dim, scale, probe, static_cast<cudaStream_t>(stream)));
}

// ssl4polyp_attention_bwd_probe with probe 0.
extern "C" int ssl4polyp_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv, int BH,
                                       int N, int head_dim, float scale, void* stream) {
  return ssl4polyp_attention_bwd_probe(q, k, v, dout, dq, dk, dv, BH, N, head_dim, scale, 0,
                                       stream);
}
