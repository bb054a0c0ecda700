// Hopper-only device and host helpers (sm_90a): mbarriers (arrivals on a
// cluster peer's too), thread block clusters, TMA tile loads through a
// tensor map (2-D, multicast to a cluster as well, and 3-D over a stack of
// matrices), the warpgroup matrix multiply (wgmma, A from shared memory,
// K-major or MN-major, or from registers, B K-major or MN-major) with its
// shared-memory descriptors for swizzled tiles, named barriers, the
// async-proxy fence, programmatic dependent launch, transposed stmatrix
// stores, and setmaxnreg.  mlp.cu's GEMM and fused MLP, ln_linear.cu's
// kernel, attention.cu's forward and backward, attention_block.cu's forward
// and dw_product.cu's weight-gradient product are built from them.
//
// The shared-memory layout everything here agrees on: a tile of R rows of 64
// bf16 values (128 bytes a row), written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B, so that within each group of 8 rows (1,024
// bytes, and the tile's base is aligned to that) the 16-byte chunk c of row r
// lies at chunk c ^ (r % 8).  wgmma reads it back through a descriptor of
// layout type "128-byte swizzle" with a stride of 1,024 bytes between 8-row
// groups; a step of 16 along K inside the 64 is 32 bytes on the start address.
// Rows of 32 or 16 values take the 64- or 32-byte swizzle the same way
// (wgmma_descriptor_swizzled).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_address(bar)), "r"(arrivals)
               : "memory");
}

// After the last mbarrier_init, by the thread that made them, before the
// block's barrier: the initial state becomes visible to every thread and to
// the copy engine.
__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_address(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic: the phase ends when
// the arrivals and the bytes are both in.
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of parity `parity` has ended (a fresh
// barrier is in phase 0, so waiting on parity 1 returns at once).
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_address(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- clusters ---------------------------------------------------------------

// This block's rank in its cluster, and the cluster's size in blocks.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t size;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(size));
  return size;
}

// Every thread of every block of the cluster: what each did before (barrier
// inits among it) is visible to all of them after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One arrival on the barrier at `bar`'s offset in the shared memory of the
// cluster's block `rank` (this block's own included).
__device__ __forceinline__ void mbarrier_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(rank)
      : "memory");
}

// A barrier over `threads` threads of the block (a multiple of 32), by its
// number: 0 is __syncthreads's, so callers take 1 to 15.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// After ordinary stores to shared memory, before an asynchronous-proxy
// reader (wgmma, a TMA store) reads them.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- programmatic dependent launch ------------------------------------------

// In a kernel launched with programmatic stream serialisation: waits until
// the kernel before it in the stream has finished and its writes are
// visible.  Without that attribute it returns at once.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the next kernel in the stream, if it was launched with programmatic
// stream serialisation, start once every block of this grid has said so.
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// --- TMA ------------------------------------------------------------------

// One box of the tensor behind `map`, at element coordinates (c0 innermost,
// c1), into shared memory at `dst`; the box's bytes (out-of-bounds parts are
// written as zeros and count) complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// tma_load_2d into the same offsets of every block of the cluster named in
// `mask` (bit r: rank r): one read from L2 feeds them all, and the bytes
// complete on the barrier at `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// One box of a 3-D tensor at element coordinates (c0 innermost, c1, c2),
// completing on `bar` as tma_load_2d does.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// The descriptor of a K-major bf16 tile of 128-byte rows under the 128-byte
// swizzle, starting at `tile` (+ 32 bytes for each step of 16 along K).
__device__ __forceinline__ uint64_t wgmma_descriptor_sw128(const void* tile) {
  uint64_t desc = (smem_address(tile) & 0x3FFFFu) >> 4;  // start address, 16-byte units
  desc |= 1ull << 16;                                   // leading offset: unused under a swizzle
  desc |= (1024ull >> 4) << 32;                         // stride between 8-row groups
  desc |= 1ull << 62;                                   // 128-byte swizzle
  return desc;
}

// The descriptor of a bf16 tile of ROW_BYTES-byte rows (128, 64 or 32) that
// TMA wrote under the swizzle of the same width (CU_TENSOR_MAP_SWIZZLE_128B,
// _64B, _32B), 8-row groups ROW_BYTES * 8 bytes apart, the tile's base
// aligned to 1,024 bytes.  Read K-major (K along a row, + 32 bytes a step of
// 16 along K) or, with the transpose bit of the instruction, MN-major (N
// along a row: a row-major (K, N) tile, + 16 rows a step of 16 along K).
// Both offsets hold the 8-row-group stride: a K-major read ignores the
// leading offset under a swizzle, and an MN-major read takes it only between
// swizzle atoms along N, which a tile one atom wide (N = ROW_BYTES / 2) never
// has; the stride offset steps between the 8-row groups either way.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t wgmma_descriptor_swizzled(const void* tile) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64 || ROW_BYTES == 32, "a swizzle width");
  constexpr uint64_t kLayout = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  constexpr uint64_t kGroup = (8 * ROW_BYTES) >> 4;
  uint64_t desc = (smem_address(tile) & 0x3FFFFu) >> 4;  // start address, 16-byte units
  desc |= kGroup << 16;
  desc |= kGroup << 32;
  desc |= kLayout << 62;
  return desc;
}

// The descriptor of an MN-major bf16 operand wider than one swizzle atom:
// row-major (K, 64) tiles of 128-byte rows that TMA wrote under the 128-byte
// swizzle (each a box, aligned to 1,024 bytes), laid side by side along M or
// N `atom_bytes` apart.  The leading offset steps between those atoms, the
// stride offset between 8-row groups of K (1,024 bytes); + 16 rows of K a
// step of 16 along K.
__device__ __forceinline__ uint64_t wgmma_descriptor_mn_sw128(const void* tile, uint32_t atom_bytes) {
  uint64_t desc = (smem_address(tile) & 0x3FFFFu) >> 4;  // start address, 16-byte units
  desc |= static_cast<uint64_t>((atom_bytes >> 4) & 0x3FFFu) << 16;
  desc |= (1024ull >> 4) << 32;
  desc |= 1ull << 62;  // 128-byte swizzle
  return desc;
}

// Before the first wgmma of a batch: orders the warpgroup's register and
// shared-memory accesses before it.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators between the asynchronous products and ordinary code:
// the compiler may not move their reads or writes across this point.
template <int R>
__device__ __forceinline__ void wgmma_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 16, fp32, 8 registers a thread) (+)= A (64 x 16) . B (16 x 16)^T, both bf16,
// K-major in shared memory behind the descriptors; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, fp32, 16 registers a thread) (+)= A (64 x 16) . B (32 x 16)^T, both bf16,
// K-major in shared memory behind the descriptors; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, fp32, 32 registers a thread) (+)= A (64 x 16) . B (64 x 16)^T, both bf16,
// K-major in shared memory behind the descriptors; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, fp32, 64 registers a thread) (+)= A (64 x 16) . B (128 x 16)^T, both bf16,
// K-major in shared memory behind the descriptors; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 256, fp32, 128 registers a thread) (+)= A (64 x 16) . B (256 x 16)^T, both bf16,
// K-major in shared memory behind the descriptors; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 208, fp32, 104 registers a thread) (+)= A (64 x 16) . B (208 x 16)^T, both bf16,
// K-major in shared memory behind the descriptors; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n208k16(float (&d)[104], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103}, "
      "%104, %105, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, fp32, 16 registers a thread) (+)= A (64 x 16) . B (32 x 16)^T, both bf16
// in shared memory behind their descriptors: A MN-major (its 16 rows of K each hold
// the 64 values of M contiguously: a row-major (K, M) tile, the transpose bit set),
// B K-major.  `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n32k16_mn_a(float (&d)[16], uint64_t desc_a,
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, fp32, 32 registers a thread) (+)= A (64 x 16) . B (64 x 16)^T, both bf16
// in shared memory behind their descriptors: A MN-major (its 16 rows of K each hold
// the 64 values of M contiguously: a row-major (K, M) tile, the transpose bit set),
// B K-major.  `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_mn_a(float (&d)[32], uint64_t desc_a,
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 104, fp32, 52 registers a thread) (+)= A (64 x 16) . B (104 x 16)^T, both bf16
// in shared memory behind their descriptors: A MN-major (its 16 rows of K each hold
// the 64 values of M contiguously: a row-major (K, M) tile, the transpose bit set),
// B K-major.  `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n104k16_mn_a(float (&d)[52], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51}, "
      "%52, %53, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, fp32, 64 registers a thread) (+)= A (64 x 16) . B (128 x 16)^T, both bf16
// in shared memory behind their descriptors: A MN-major (its 16 rows of K each hold
// the 64 values of M contiguously: a row-major (K, M) tile, the transpose bit set),
// B K-major.  `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_mn_a(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 256, fp32, 128 registers a thread) (+)= A (64 x 16) . B (16 x 256), both bf16
// in shared memory behind their descriptors, both MN-major (the transpose bits set):
// A's 16 rows of K each hold the 64 values of M contiguously, B's the 256 values of N
// (four swizzle atoms, wgmma_descriptor_mn_sw128).  `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k16_mn_ab(float (&d)[128], uint64_t desc_a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, fp32, 64 registers a thread) (+)= A (64 x 16) . B (128 x 16)^T, both bf16,
// A from registers (a[0..3]: this warp's 16 x 16 slice in mma.sync's A layout:
// rows g, g + 8 by columns 2t, 2t + 1, then 2t + 8, 2t + 9), B K-major in shared
// memory behind its descriptor; `accumulate` 0 overwrites D.  a must keep its
// registers unwritten until the product has been waited for.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 256, fp32, 128 registers a thread) (+)= A (64 x 16) . B (256 x 16)^T, both bf16,
// A from registers (a[0..3]: this warp's 16 x 16 slice in mma.sync's A layout:
// rows g, g + 8 by columns 2t, 2t + 1, then 2t + 8, 2t + 9), B K-major in shared
// memory behind its descriptor; `accumulate` 0 overwrites D.  a must keep its
// registers unwritten until the product has been waited for.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 16, fp32, 8 registers a thread) (+)= A (64 x 16) . B (16 x 16), both bf16,
// A from registers (as for wgmma_m64n128k16_rs), B MN-major in shared memory
// behind its descriptor: its 16 rows of K each hold the 16 values of N
// contiguously (a row-major (K, N) tile, the transpose bit set).
// `accumulate` 0 overwrites D.  a must keep its registers unwritten until the
// product has been waited for.
__device__ __forceinline__ void wgmma_m64n16k16_rs_mn(float (&d)[8], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, fp32, 16 registers a thread) (+)= A (64 x 16) . B (16 x 32), both bf16,
// A from registers (as for wgmma_m64n128k16_rs), B MN-major in shared memory
// behind its descriptor: its 16 rows of K each hold the 32 values of N
// contiguously (a row-major (K, N) tile, the transpose bit set).
// `accumulate` 0 overwrites D.  a must keep its registers unwritten until the
// product has been waited for.
__device__ __forceinline__ void wgmma_m64n32k16_rs_mn(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, fp32, 32 registers a thread) (+)= A (64 x 16) . B (16 x 64), both bf16,
// A from registers (as for wgmma_m64n128k16_rs), B MN-major in shared memory
// behind its descriptor: its 16 rows of K each hold the 64 values of N
// contiguously (a row-major (K, N) tile, the transpose bit set).
// `accumulate` 0 overwrites D.  a must keep its registers unwritten until the
// product has been waited for.
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// --- stmatrix ---------------------------------------------------------------

// Two 8x8 bf16 matrices from registers into shared memory, each transposed on
// the way: thread (g, t) gives r[i], the elements (g, 2t) and (g, 2t + 1) of
// matrix i (mma's and wgmma's accumulator layout, packed), and lane l < 16
// the address of row l % 8 of the stored matrix l / 8, which receives column
// l % 8 of the one in registers (16 contiguous bytes).
__device__ __forceinline__ void stmatrix_x2_trans(void* row, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(
                   smem_address(row)),
               "r"(r0), "r"(r1)
               : "memory");
}

// --- registers --------------------------------------------------------------

// The warpgroup gives registers back to the SM (dec) or takes more (inc);
// all four warps execute it, inside a branch the other role never joins.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// --- host: tensor maps ------------------------------------------------------

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the library does not link
// against (only the runtime): it is looked up in the copy the process has
// loaded already.  Null if there is none.
inline TensorMapEncode tensor_map_encoder() {
  static TensorMapEncode encode = nullptr;
  if (encode == nullptr) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* fn = libcuda == nullptr ? nullptr : dlsym(libcuda, "cuTensorMapEncodeTiled");
    encode = reinterpret_cast<TensorMapEncode>(fn);
  }
  return encode;
}

// A tensor map over a row-major (rows, cols) bf16 matrix for boxes of
// box_rows x 64 columns under the 128-byte swizzle, zeros out of bounds.
// The map holds the pointer, so it is made anew for every call (host
// arithmetic only).
inline cudaError_t make_tensor_map_sw128(CUtensorMap* map, const void* base, int rows, int cols,
                                         int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};  // bytes between rows
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                             dims, strides, box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over `count` row-major (rows, cols) bf16 matrices that follow
// one another in memory (images of (B, N, Din)), for boxes of box_rows x
// box_cols of one matrix under the swizzle of the box's row (box_cols 64,
// 32 or 16: 128, 64 or 32 bytes): rows past a matrix's last are zeros, and
// a box never reads the next matrix.
inline cudaError_t make_tensor_map_stack(CUtensorMap* map, const void* base, int count, int rows,
                                         int cols, int box_rows, int box_cols) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_NONE) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(count)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,  // bytes between rows
                                 static_cast<cuuint64_t>(rows) * cols * 2};  // between matrices
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                             dims, strides, box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over `count` row-major (rows, cols) bf16 matrices that follow
// one another in memory (heads of (B * H, N, hd)), for boxes of box_rows x
// cols of one matrix, under the swizzle of a row's width (cols 64, 32 or 16:
// 128, 64 or 32 bytes; wgmma_descriptor_swizzled reads it back).  Rows past
// a matrix's last are zeros: a box never reads the next matrix.
inline cudaError_t make_tensor_map_matrices(CUtensorMap* map, const void* base, int count, int rows,
                                            int cols, int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : cols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_NONE) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(count)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,  // bytes between rows
                                 static_cast<cuuint64_t>(rows) * cols * 2};  // between matrices
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                             dims, strides, box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
