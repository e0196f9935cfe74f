// Small Hopper (sm_90a) building blocks shared by the port's tensor-core
// kernels: asynchronous 16- and 4-byte copies into shared memory (cp.async),
// ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 tensor-core product,
// the fp64 mma.sync.m16n8k8 product (DMMA) and its fragment loads,
// the fences and descriptors of warpgroup products (wgmma) over
// 128-byte-swizzled shared-memory tiles, and the tensor-memory-accelerator
// (TMA) loads, mbarriers and thread-block-cluster operations that feed them
// (barriers, ranks and reads of another block's shared memory); and, for the
// contraction epilogues, a programmatic dependent launch and the fixed-order
// sum of per-block partials.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without touching registers. ``valid`` false
// zero-fills the destination and reads nothing (``src`` must still be a
// mapped address: callers pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, for rows that are not 16-byte aligned; as above
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// d (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> packed bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin a wgmma accumulator in its registers across this point, so the
// compiler moves no other instruction that defines them into the span
// between a wgmma and its wait (which would serialize the wgmma pipeline)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand tile
// (layout type B128). ``lbo`` and ``sbo`` in bytes: for a K-major tile
// (rows of 64 bf16 along K, 8-row swizzle atoms of 1024 bytes) sbo is the
// stride between 8-row groups and lbo is unused; for an MN-major tile
// (rows of 64 bf16 along M or N, one row per k) lbo is the stride between
// 64-wide column atoms and sbo the stride between groups of 8 k-rows.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// ---- fp64 tensor-core products: mma.sync.m16n8k8.f64 (DMMA) --------------
// Lane (g, t) = (lane / 4, lane % 4) of a warp holds the fragments below.

struct FragA { double v[4]; };   // 16 x 8, row major
struct FragB { double v[2]; };   // 8 x 8, col major

// d += a b: fp32 operands are exact in fp64, so are their products; the sums
// round to nearest in fp64
__device__ __forceinline__ void mma(double (&d)[4], const FragA& a, const FragB& b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a.v[0]), "d"(a.v[1]), "d"(a.v[2]), "d"(a.v[3]), "d"(b.v[0]), "d"(b.v[1]));
}

// A (16 x 8) of a row-major fp32 or fp64 tile: element (r, k) at p[r * ld + k]
template <class T>
__device__ __forceinline__ FragA load_a(const T* p, int ld, int g, int t) {
  return {{(double)p[g * ld + t], (double)p[(g + 8) * ld + t], (double)p[g * ld + t + 4],
           (double)p[(g + 8) * ld + t + 4]}};
}

// A (16 x 8) as the transpose of a row-major tile: element (r, k) at p[k * ld + r]
__device__ __forceinline__ FragA load_at(const float* p, int ld, int g, int t) {
  return {{p[t * ld + g], p[t * ld + g + 8], p[(t + 4) * ld + g], p[(t + 4) * ld + g + 8]}};
}

// B (8 x 8) of a row-major tile: element (k, n) at p[k * ld + n]
__device__ __forceinline__ FragB load_b(const float* p, int ld, int g, int t) {
  return {{p[t * ld + g], p[(t + 4) * ld + g]}};
}

// B (8 x 8) as the transpose of a row-major fp32 or fp64 tile: element (k, n)
// at p[n * ld + k]
template <class T>
__device__ __forceinline__ FragB load_bt(const T* p, int ld, int g, int t) {
  return {{(double)p[g * ld + t], (double)p[g * ld + t + 4]}};
}

// ---- mbarriers, TMA and clusters ----------------------------------------

__device__ __forceinline__ void mbar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the cluster (and the TMA unit)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait until the barrier's phase with parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(void* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// arrive once (release: this thread's earlier writes are seen by a waiter)
__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive once, announcing ``bytes`` that TMA copies will complete
__device__ __forceinline__ void mbar_arrive_expect_tx(void* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrive once on the barrier at the same shared-memory offset in cluster
// block ``cta`` (this block included), with the default cta-scope release:
// the arriving warpgroup's wgmma wait already retired the reads it
// releases, and a cluster-scope release stalls every arrive
__device__ __forceinline__ void mbar_arrive_cluster(void* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// store v at ``p``'s shared-memory offset in cluster block ``cta``
// (distributed shared memory; this block included). A later cluster
// barrier makes it visible there.
__device__ __forceinline__ void st_cluster_f32(void* p, uint32_t cta, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(cta));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// the two halves of a cluster barrier, for work between them: every block
// of the cluster arrives (relaxed: orders nothing), then waits for all
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// TMA: the 2D box at (c0 inner, c1 outer) of ``map`` into this block's
// shared memory, completing ``bytes`` on ``bar``
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, void* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the same box into the same offset of every cluster block in ``mask``,
// each completing its own barrier at ``bar``'s offset
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      void* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// programmatic dependent launch: let the next grid in the stream start,
// and (in that grid) wait for the previous one's memory
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_wait_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launch ``kern`` as the programmatic dependent of the stream's previous
// kernel: its blocks may start while that kernel runs, and each must wait
// for it (grid_wait_previous) before reading what it writes.
template <typename... Params, typename... Args>
int launch_dependent(void (*kern)(Params...), dim3 grid, int threads, int smem,
                     cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out[t] = the sum of parts[t n .. t n + n - 1] for t = blockIdx.x, one warp
// a t: lane l adds partials l, l + 32, ... in order, then a fixed shuffle
// tree. The order depends on n alone, never on the grid, so tangent t's sum
// is the same bits whatever the number of tangents. Launched with
// launch_dependent behind the kernel that writes the partials.
template <int WARP = 32>
__global__ void __launch_bounds__(WARP)
sum_parts_kernel(const float* __restrict__ parts, float* __restrict__ out, int n) {
  grid_wait_previous();
  const float* p = parts + (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += WARP) s += p[i];
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace hopper
