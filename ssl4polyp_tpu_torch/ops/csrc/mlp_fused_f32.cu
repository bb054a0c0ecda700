// The transformer MLP in one kernel, in fp32, with an optional LayerNorm
// prologue and the block's residual:
//   out = [x +] gelu([LN](x) . W1^T + b1) . W2^T + b2,
// for the runs that compute in fp32 (`amp: false`, PretrainSettings.precision
// "fp32") under `mlp_fusion` "full" and "full_ln".
//
// Replaces: ssl4polyp_tpu/ops/mlp.py::_mlp_kernel (mlp_fused) and
// ::_mlp_ln_kernel (mlp_ln_fused) at compute_dtype float32, where every cast
// of the TPU kernels is a no-op: h, g = gelu(h) and the output's sum are fp32,
// nothing rounded between them; the LN variant adds x + acc + b2 in fp32.
// The bf16 kernels (mlp.cu) run on wgmma, which has no fp32 operand type, so
// this is a plain SIMT kernel: FFMA on the CUDA cores, fp32 accumulation, no
// TF32 and no split into bf16 terms.  g never goes to HBM; h is written only
// when the wrapper asks (a backward follows).
//
// What bounds it on the H100: at the classifier's shape (M 12608, K 768, NF
// 3072) a call is 119.0 GFLOP, 1.776 ms at the 67 TFLOP/s fp32 rate, against
// 0.23 GB of HBM traffic (x, W1, W2 in; out, and h when written, out; 0.39 GB
// with h); at the MAE decoder's (K 512, NF 2048) 52.9 GFLOP, 0.789 ms:
// operations.
//
// Design.  The output accumulator is a whole row block of K columns, held in
// registers: 64 rows would take 192 accumulators a thread of a 256-thread
// block beside the fc1 tile, past what the register file gives, so a block
// takes 32 rows (96 accumulators a thread at K 768, 64 at K 512), one block
// an SM.  What each row block reads of W1 and W2, 2 x K x NF x 4 bytes (18.9
// MB at ViT-B, 8.4 MB at the decoder's width), comes from L2: 394 blocks a
// call at M 12608, 7.4 GB of L2 reads a call (3.3 GB at the decoder's).  So
// the W stream, not the FFMAs alone, sets the pace: the first design read
// one stage ahead into registers and stalled on it (with its loads or its
// products left out, either half took most of the whole's time).  This
// design keeps two 36 KB stages in flight by cp.async while a third is
// multiplied.
//   * Prologue: the block's 32 rows of x into shared memory, one warp a row
//     (16-byte pieces); the LN variant takes each row's mean, then the mean
//     of (x - mean)^2 over the same registers (two passes, as the TPU kernel
//     takes them) and stages m = (x - mean) * rsqrt(var + eps) * s + t.
//   * NF is walked in chunks of 128, each K / 64 stages of W1 (the chunk's
//     128 rows x 64 of K, as they lie in memory) then 16 stages of W2 (its
//     K rows x 8 of the chunk's columns), through a ring of three slots of
//     shared memory that cp.async fills (16-byte pieces, zeros past NF): one
//     barrier a stage.
//   * fc1: the chunk's (32 x 128) h tile, 4 rows x 4 columns 32 apart a
//     thread, from 16-byte reads along k of the rows and of W1's rows; then
//     + b1, h to HBM when asked, and gelu(h) (erff) into shared memory as
//     g[j][row].  fc2: out's (32 x K) accumulators, 8 rows x (K / 64)
//     columns 64 apart a thread, += g . W2[:, chunk]^T, from broadcasts of g
//     and 16-byte reads along j of W2's rows.  Row pitches of 68, 12 and 36
//     floats keep each warp's reads at the fewest wavefronts, below the
//     FFMAs' issue time.
//   * Epilogue: out = acc + b2, or (x + acc) + b2 with x read again.
// Each output is one fixed-order FFMA chain (NF chunk by chunk, ascending),
// so reruns give the same bits.  K is 512 or 768 (one instantiation each),
// NF a multiple of 32 (a last chunk of 32, 64 or 96 stages W rows and
// columns past NF as zeros: gelu(0) = 0 adds nothing); rows past M are
// masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;    // rows a block
constexpr int kNC = 128;   // NF columns a chunk
constexpr int kBK = 64;    // fc1's depth a stage
constexpr int kBJ = 8;     // fc2's depth a stage
constexpr int kP1 = kBK + 4;  // a W1 stage's row pitch, floats
constexpr int kP2 = kBJ + 4;  // a W2 stage's row pitch
constexpr int kPG = kBM + 4;  // g's row pitch
constexpr int kSlots = 3;

template <int K>
struct Smem {
  static constexpr int kSlot = kNC * kP1 > K * kP2 ? kNC * kP1 : K * kP2;  // floats a slot
  float a[kBM][K + 4];          // the block's rows (normalised in the LN variant)
  float g[kNC][kPG];            // gelu(h) of the chunk, [j][row]
  float ring[kSlots][kSlot];    // W1 stages [n][k], W2 stages [c][j]
};

template <int K, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fused_f32_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ t, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ h,
                     float* __restrict__ out, int M, int NF, float eps) {
  constexpr int kQ = K / 64;      // fc2's columns a thread, 64 apart
  constexpr int kV = K / 128;     // 16-byte pieces of a row a lane stages
  constexpr int kS1 = K / kBK;    // W1 stages a chunk
  constexpr int kS = kS1 + kNC / kBJ;  // stages a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<K>& sm = *reinterpret_cast<Smem<K>*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * kBM;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int chunks = (NF + kNC - 1) / kNC;
  const int stages = chunks * kS;

  // Stage `index` of the W stream into its slot, as one cp.async group (an
  // empty group past the end, so that every thread counts groups alike).
  // W1: pieces p = tid + 256 u, row p / 16 of the chunk, k piece p % 16 (a
  // warp: two 256-byte row segments).  W2: row p / 2, columns (p % 2) * 4.
  auto issue = [&](int index) {
    if (index < stages) {
      const int chunk = index / kS, st = index % kS, n0 = chunk * kNC;
      float* slot = sm.ring[index % kSlots];
      if (st < kS1) {
#pragma unroll
        for (int u = 0; u < kNC * kBK / 4 / kThreads; ++u) {
          const int p = tid + kThreads * u, n = p / (kBK / 4), k = (p % (kBK / 4)) * 4;
          const bool ok = n0 + n < NF;
          cp_async_16(slot + n * kP1 + k,
                      w1 + static_cast<long>(ok ? n0 + n : 0) * K + st * kBK + k, ok ? 16 : 0);
        }
      } else {
        const int j0 = n0 + (st - kS1) * kBJ;  // NF % 8 == 0: a stage's 8 columns are whole
        const bool ok = j0 < NF;
#pragma unroll
        for (int u = 0; u < K * kBJ / 4 / kThreads; ++u) {
          const int p = tid + kThreads * u, c = p / 2, j = (p % 2) * 4;
          cp_async_16(slot + c * kP2 + j, w2 + static_cast<long>(c) * NF + (ok ? j0 + j : 0),
                      ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // Prologue: warp w stages rows w, w + 8, w + 16, w + 24; lane l the pieces
  // at columns 4l, 4l + 128, ...
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    float4 v[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i)
      v[i] = row < M ? *reinterpret_cast<const float4*>(x + static_cast<long>(row) * K +
                                                        4 * lane + 128 * i)
                     : zero;
    if (LN && row < M) {
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kV; ++i) sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      const float mean = warp_sum(sum) / static_cast<float>(K);
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
        sq += (a * a + b * b) + (c * c + d * d);
      }
      const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(K) + eps);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int c = 4 * lane + 128 * i;
        const float4 sc = *reinterpret_cast<const float4*>(s + c);
        const float4 sh = *reinterpret_cast<const float4*>(t + c);
        v[i] = make_float4((v[i].x - mean) * rstd * sc.x + sh.x,
                           (v[i].y - mean) * rstd * sc.y + sh.y,
                           (v[i].z - mean) * rstd * sc.z + sh.z,
                           (v[i].w - mean) * rstd * sc.w + sh.w);
      }
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) *reinterpret_cast<float4*>(&sm.a[r][4 * lane + 128 * i]) = v[i];
  }

  // fc1's tile: rows r1 .. r1 + 3, chunk columns n1 + 32 j (a warp: two row
  // groups by 16 consecutive columns).  fc2's: rows r2 .. r2 + 7 (one a warp
  // pair), columns c2 + 64 q.
  const int r1 = ((warp >> 1) * 2 + (lane >> 4)) * 4;
  const int n1 = (warp & 1) * 16 + (lane & 15);
  const int r2 = (tid / 64) * 8;
  const int c2 = tid % 64;
  float acc[8][kQ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[i][q] = 0.0f;
  float hacc[4][4];

  for (int index = 0; index < stages; ++index) {
    cp_async_wait<1>();  // this stage has landed (the next may be in flight)
    __syncthreads();     // for every thread; and the slot issued next was last read before here
    issue(index + 2);
    const float* slot = sm.ring[index % kSlots];
    const int chunk = index / kS, st = index % kS, n0 = chunk * kNC;
    if (st < kS1) {
      if (st == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hacc[i][j] = 0.0f;
      }
      const int k0 = st * kBK;
#pragma unroll 4
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(&sm.a[r1 + i][k0 + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = *reinterpret_cast<const float4*>(slot + (n1 + 32 * j) * kP1 + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hacc[i][j] = fmaf(av[i].x, wv[j].x, hacc[i][j]);
            hacc[i][j] = fmaf(av[i].y, wv[j].y, hacc[i][j]);
            hacc[i][j] = fmaf(av[i].z, wv[j].z, hacc[i][j]);
            hacc[i][j] = fmaf(av[i].w, wv[j].w, hacc[i][j]);
          }
      }
      if (st == kS1 - 1) {
        // h = acc + b1 (to HBM when asked), g = gelu(h) into shared memory;
        // g's last reader, the previous chunk's fc2, was before a barrier,
        // and the next stage's barrier publishes it.
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + n1 + 32 * j;
          const bool ok = n < NF;
          const float bias = ok ? b1[n] : 0.0f;
          float gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pre = hacc[i][j] + bias;
            const int row = m0 + r1 + i;
            if (h != nullptr && ok && row < M) h[static_cast<long>(row) * NF + n] = pre;
            gv[i] = gelu_erf(pre);
          }
          *reinterpret_cast<float4*>(&sm.g[n1 + 32 * j][r1]) =
              make_float4(gv[0], gv[1], gv[2], gv[3]);
        }
      }
    } else {
      const int j0 = (st - kS1) * kBJ;
#pragma unroll
      for (int jj = 0; jj < kBJ; jj += 4) {
        float gv[4][8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 lo = *reinterpret_cast<const float4*>(&sm.g[j0 + jj + e][r2]);
          const float4 hi = *reinterpret_cast<const float4*>(&sm.g[j0 + jj + e][r2 + 4]);
          gv[e][0] = lo.x, gv[e][1] = lo.y, gv[e][2] = lo.z, gv[e][3] = lo.w;
          gv[e][4] = hi.x, gv[e][5] = hi.y, gv[e][6] = hi.z, gv[e][7] = hi.w;
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 wv = *reinterpret_cast<const float4*>(slot + (c2 + 64 * q) * kP2 + jj);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][q] = fmaf(gv[0][i], wv.x, acc[i][q]);
            acc[i][q] = fmaf(gv[1][i], wv.y, acc[i][q]);
            acc[i][q] = fmaf(gv[2][i], wv.z, acc[i][q]);
            acc[i][q] = fmaf(gv[3][i], wv.w, acc[i][q]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + r2 + i;
    if (row >= M) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int col = c2 + 64 * q;
      const long at = static_cast<long>(row) * K + col;
      const float o = LN ? x[at] + acc[i][q] : acc[i][q];
      out[at] = o + b2[col];
    }
  }
}

template <int K, bool LN>
int launch(const float* x, const float* s, const float* t, const float* w1, const float* b1,
           const float* w2, const float* b2, float* h, float* out, int M, int NF, float eps,
           cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const auto kernel = mlp_fused_f32_kernel<K, LN>;
  cudaError_t err = allow_dynamic_smem(kernel, sizeof(Smem<K>), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + kBM - 1) / kBM, kThreads, sizeof(Smem<K>), stream>>>(x, s, t, w1, b1, w2, b2, h,
                                                                    out, M, NF, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) fp32; ln_s, ln_t: (K,) fp32, both null for the plain MLP; w1:
// (NF, K), b1: (NF,), w2: (K, NF), b2: (K,) fp32 (torch's (out, in) layouts);
// h: (M, NF) fp32 or null; out: (M, K) fp32.  K 512 or 768, NF a multiple of
// 32, every pointer 16-byte aligned.  Returns the launch's CUDA error.
extern "C" int ssl4polyp_mlp_fused_fwd_f32(const void* x, const void* ln_s, const void* ln_t,
                                           const void* w1, const void* b1, const void* w2,
                                           const void* b2, void* h, void* out, int M, int K,
                                           int NF, float eps, void* stream) {
  if (M < 1 || NF < 32 || NF % 32 || (K != 512 && K != 768) || ((ln_s == nullptr) != (ln_t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* sf = static_cast<const float*>(ln_s);
  const auto* tf = static_cast<const float*>(ln_t);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  auto* hf = static_cast<float*>(h);
  auto* of = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ln = ln_s != nullptr;
  if (K == 768)
    return ln ? launch<768, true>(xf, sf, tf, w1f, b1f, w2f, b2f, hf, of, M, NF, eps, st)
              : launch<768, false>(xf, sf, tf, w1f, b1f, w2f, b2f, hf, of, M, NF, eps, st);
  return ln ? launch<512, true>(xf, sf, tf, w1f, b1f, w2f, b2f, hf, of, M, NF, eps, st)
            : launch<512, false>(xf, sf, tf, w1f, b1f, w2f, b2f, hf, of, M, NF, eps, st);
}
