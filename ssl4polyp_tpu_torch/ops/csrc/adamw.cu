// One AdamW step over many tensors in one pass: the fp32 master parameters
// and moments updated in place and the bf16 compute copy of each matrix
// written from the same registers.
//
// Replaces: ssl4polyp_tpu/ops/adamw.py::_kernel (adamw_leaf_pallas), which
// runs once per leaf; here one launch covers up to 64 tensors, so a step over
// the MAE's 254 tensors is 4 launches and the classifier's 152 are 3.
//
// What bounds it on the H100: bytes.  Per element it reads p, g, mu, nu (16 B)
// and writes p, mu, nu (12 B) and, for a matrix, the bf16 copy (2 B), against
// some 15 floating-point operations: 3.3 GB a step for the MAE's 111 M
// elements, about 1 ms at the data sheet's 3.35 TB/s.  The design only has to
// keep every access a full-width coalesced vector: a block takes 8,192
// consecutive elements of one tensor, four per thread per pass.
//
// The arithmetic is the plain version's (training/optim.py), operation by
// operation, each rounded to fp32 once: the intrinsics below forbid the
// compiler's fused multiply-add, which rounds once where two eager torch ops
// round twice.  The bias corrections divide as multiplications by their
// reciprocals (taken in double on the host, rounded to fp32), which is what
// torch's division of a CUDA tensor by a scalar does and what the plain
// version therefore writes out on every device.  With the same scalars the
// results are the plain version's bits.
//
// The tensor table travels as a kernel argument (the gradients are new
// tensors every step, so nothing about it can be cached on the device): 64
// tensors' pointers, sizes and scalars are 3,880 bytes of the 4,096 a launch
// may carry.
#include "common.cuh"

namespace {

constexpr int kMaxTensors = 64;
constexpr int kAdamThreads = 256;
constexpr int kBlockElems = 8192;  // elements of one tensor per block

constexpr int kFlagGradBf16 = 1;  // the gradient is bf16, else fp32
constexpr int kFlagFrozen = 2;    // lr * lr_scale == 0: only the moments move
constexpr int kFlagDecay = 4;     // weight_decay * wd_scale != 0

struct AdamWChunk {
  float* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  bf16* copy[kMaxTensors];     // null: no compute copy of this tensor
  int n[kMaxTensors];          // elements
  float lr[kMaxTensors];       // lr * lr_scale, rounded to fp32
  float decay[kMaxTensors];    // weight_decay * wd_scale, rounded to fp32
  int flags[kMaxTensors];
  int block_start[kMaxTensors + 1];  // first block of each tensor; [count] is the grid
  int count;
  float b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps;
  int pad;
};
static_assert(sizeof(AdamWChunk) == 3880, "the host packs this layout byte for byte");

struct AdamWScalars {
  float b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, lr, decay;
  bool frozen, with_decay;
};

// One element.  mu and nu always move; p only when the tensor trains.
__device__ __forceinline__ void adamw_element(float& p, float g, float& mu, float& nu,
                                              const AdamWScalars& s) {
  mu = __fadd_rn(__fmul_rn(mu, s.b1), __fmul_rn(g, s.one_minus_b1));
  nu = __fadd_rn(__fmul_rn(nu, s.b2), __fmul_rn(__fmul_rn(g, g), s.one_minus_b2));
  if (s.frozen) return;
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, s.inv_bc2)), s.eps);
  float dir = __fdiv_rn(__fmul_rn(mu, s.inv_bc1), denom);
  if (s.with_decay) dir = __fadd_rn(dir, __fmul_rn(p, s.decay));
  p = __fsub_rn(p, __fmul_rn(dir, s.lr));
}

__global__ void __launch_bounds__(kAdamThreads)
adamw_kernel(const __grid_constant__ AdamWChunk c) {
  int which = 0;
  while (static_cast<int>(blockIdx.x) >= c.block_start[which + 1]) ++which;
  const int n = c.n[which];
  const int flags = c.flags[which];
  const AdamWScalars s = {c.b1, c.one_minus_b1, c.b2, c.one_minus_b2, c.inv_bc1, c.inv_bc2, c.eps,
                          c.lr[which], c.decay[which], (flags & kFlagFrozen) != 0,
                          (flags & kFlagDecay) != 0};
  float* __restrict__ p = c.p[which];
  float* __restrict__ mu = c.mu[which];
  float* __restrict__ nu = c.nu[which];
  bf16* __restrict__ copy = c.copy[which];
  const float* __restrict__ g32 = static_cast<const float*>(c.g[which]);
  const bf16* __restrict__ g16 = static_cast<const bf16*>(c.g[which]);
  const bool grad_bf16 = (flags & kFlagGradBf16) != 0;

  const int begin = (static_cast<int>(blockIdx.x) - c.block_start[which]) * kBlockElems;
  const int end = min(n, begin + kBlockElems);
  for (int i = begin + 4 * threadIdx.x; i < end; i += 4 * kAdamThreads) {
    if (i + 4 <= end) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      float4 mv = *reinterpret_cast<const float4*>(mu + i);
      float4 nv = *reinterpret_cast<const float4*>(nu + i);
      float4 gv;
      if (grad_bf16) {
        const uint2 raw = *reinterpret_cast<const uint2*>(g16 + i);
        gv = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                         __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
      } else {
        gv = *reinterpret_cast<const float4*>(g32 + i);
      }
      adamw_element(pv.x, gv.x, mv.x, nv.x, s);
      adamw_element(pv.y, gv.y, mv.y, nv.y, s);
      adamw_element(pv.z, gv.z, mv.z, nv.z, s);
      adamw_element(pv.w, gv.w, mv.w, nv.w, s);
      *reinterpret_cast<float4*>(mu + i) = mv;
      *reinterpret_cast<float4*>(nu + i) = nv;
      if (!s.frozen) {
        *reinterpret_cast<float4*>(p + i) = pv;
        if (copy != nullptr)
          *reinterpret_cast<uint2*>(copy + i) =
              make_uint2(pack_floats(pv.x, pv.y), pack_floats(pv.z, pv.w));
      }
    } else {  // the tensor's last one to three elements
      for (int j = i; j < end; ++j) {
        float pj = p[j], mj = mu[j], nj = nu[j];
        const float gj = grad_bf16 ? __bfloat162float(g16[j]) : g32[j];
        adamw_element(pj, gj, mj, nj, s);
        mu[j] = mj;
        nu[j] = nj;
        if (!s.frozen) {
          p[j] = pj;
          if (copy != nullptr) copy[j] = __float2bfloat16(pj);
        }
      }
    }
  }
}

}  // namespace

// chunks: `count` AdamWChunk records in host memory, each holding up to 64
// tensors (every pointer 16-byte aligned, on the current device).  One launch
// per record.  Returns the first failing launch's CUDA error.
extern "C" int ssl4polyp_adamw_step(const void* chunks, int count, void* stream) {
  const AdamWChunk* records = static_cast<const AdamWChunk*>(chunks);
  for (int i = 0; i < count; ++i) {
    const AdamWChunk& c = records[i];
    if (c.count < 1 || c.count > kMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = c.block_start[c.count];
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    adamw_kernel<<<blocks, kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// sizeof(AdamWChunk), the tensors per record and the elements per block, for
// the host's packing.
extern "C" int ssl4polyp_adamw_layout(int what) {
  switch (what) {
    case 0: return static_cast<int>(sizeof(AdamWChunk));
    case 1: return kMaxTensors;
    case 2: return kBlockElems;
    default: return -1;
  }
}
