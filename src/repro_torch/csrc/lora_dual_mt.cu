// LoRA multi-tangent projection for Hopper (sm_90a), plain C interface.
//
//   yd_t = s * ((x @ Ad_t + xd_t @ A) @ B + (x @ A) @ Bd_t) + xd_t @ W
//
// for t < T, and its jvp-contraction epilogue <gy, yd_t> for t < T with no
// yd output. Replace the TPU kernels repro/kernels/lora_dual/kernel.py::
// lora_dual_mt_kernel (emit_primal=False) and lora_dual_mt_jvps_kernel.
// x, xd, W, gy: XT (float or bf16); A, Ad, B, Bd: float; yd: XT. All sums
// are fp32; the output is rounded once. Three routes for the tangents, one
// rule in repro_torch/kernels/lora_dual/ops.py::lora_mt_path:
//
// tc (bf16, an input tangent, K % 8 == N % 8 == 0, every operand 16-byte
//   aligned: TMA rows, the pre-pass's float4 factor loads and the
//   epilogue's float2 Bd loads). The T
//   GEMMs xd_t @ W (2 T M K N operations) bound the call by operations at
//   T M >= 1024 and by the bytes of W and xd at T = 1. The T tangents are
//   one GEMM of T*M rows, (T M, K) @ (K, N), so a block multiplies its tile
//   of W against the stacked rows of every tangent it owns, and W is read
//   once a call, not once a tangent: blocks run in launch order with the M
//   tile fastest (blockIdx.x), so the blocks that share a K x BN strip of W
//   run side by side, the strip comes from device memory once and from the
//   50 MB L2 after (W is 2-32 MB, xd 0.5-16 MB); and the two blocks of a
//   cluster (adjacent M tiles) share each W tile by TMA multicast, so L2
//   serves half of it to each. A block is WGS consumer warpgroups (64 rows
//   each; bf16 wgmma m64nBNk16 with fp32 accumulators in registers, one
//   wgmma group in flight) and one producer warpgroup, whose single thread
//   keeps the TMA unit filling a 5- to 8-stage ring of 128-byte-swizzled
//   tiles (xd K-major, W MN-major: the descriptor's transpose bit) through
//   full and empty mbarriers, and whose other warps stage the epilogue's
//   factors meanwhile. Tile by shape: 128 x 128 (two consumer warpgroups)
//   where that gives at least 120 blocks, about one wave of the 132 SMs;
//   otherwise 64 x 64, 4x the blocks: at the CLI's T = 1, T M = 256 and
//   K = N = 1024 the large tile makes 16 blocks, the small one 64.
//   The rank-r pieces u = x @ A and ud_t = x @ Ad_t + xd_t @ A come from a
//   pre-pass kernel in the same call (fp32, a fixed summation order, the
//   factors read beside x and xd with no staging) into fp32 scratch; the GEMM is its programmatic dependent launch, so its K loop
//   may start while the pre-pass runs. The epilogue adds
//   s (ud_t @ B + u @ Bd_t) to the fp32 accumulator, rounds once, and
//   writes the tile through shared memory in 16-byte rows; row i of the
//   stacked GEMM belongs to tangent i / M, so a tile straddles tangents
//   when M is not a multiple of the tile.
// store (bf16, no input tangent, K % 8 == N % 8 == 0). W is never read;
//   after the same pre-pass only rank-r work is left, and writing the
//   (T, M, N) output bounds the call by bytes: each block stages its 256
//   columns of B and Bd_t once and writes rows with 16-byte stores.
// simt (fp32, or shapes off the 8-element alignment). One launch over a
//   (N/64, M/64, T) grid of plain fp32 FMAs on 64 x 64 tiles, the rank-r
//   pieces accumulated in shared memory in the same K loop. fp32 stays
//   here: TF32 tensor cores keep about three digits, and the card-vs-CPU
//   parity of the reduced fp32 configs is held at 1e-5.
//
// The contraction epilogue takes two routes, one rule in ops.py::
// lora_jvps_path. Its work is one frozen-W product z = gy @ W^T (2 M K N
// operations) shared by all T tangents, plus rank-r terms; with an input
// tangent the bytes of W and the T xd tangents bound it (T = 8, K = N =
// 4096: 54.5 MB against 8.6 GFLOP), without one the bytes of x and gy.
//
// tc (bf16, K % 8 == N % 8 == 0, every operand 16-byte aligned; with or
//   without an input tangent). <gy, yd_t> = <z, xd_t> + s <gy, ud_t @ B +
//   u @ Bd_t>, and both terms are sums over N. The rank-r pre-pass above
//   writes u and ud_t; then, as its programmatic dependent launch,
//   lora_jvps_tc_kernel: a block owns a 64 x 128 tile of z over one slice
//   of N, and the slices are the fewest that bring the grid to about one
//   wave of the 132 SMs (4 at roberta-large's K = N = 1024, M = 256; 1 at
//   llama2-7b's 4096). Its producer thread keeps TMA filling an 8-stage ring
//   of 128-byte-swizzled gy and W tiles, both K-major (W's rows are W^T's
//   columns, N contiguous: no transpose bit), then each xd_t's tile as the
//   ring drains, so the tangents' tiles arrive while the GEMM runs; one
//   consumer warpgroup runs bf16 wgmma m64n128k16 into fp32 registers and
//   dots that fragment with each xd_t's tile in fp32: z never leaves the
//   block. The producer warpgroup's other three warps add the rank-r terms
//   of the slice's rows, shared among the tile's K blocks. Each block writes
//   one partial a tangent; a one-warp kernel sums them in a fixed order. The
//   plan depends on (M, K, N) alone and every sum's order on neither T nor
//   the tangent's place, so tangent t of a T = 8 launch is bitwise a T = 1
//   launch. Without an input tangent lora_jvps_rank_kernel runs the rank-r
//   terms alone over the same plan. bf16 products are exact in fp32, so
//   the error is the fp32 sums' (the limit is 1e-6 of sum|terms|).
// simt (fp32, or off that alignment): lora_dual_mt_jvps_kernel below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int R_MAX = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename XT, bool HAS_XD>
__global__ void __launch_bounds__(THREADS)
lora_dual_mt_kernel(const XT* __restrict__ x, const XT* __restrict__ xd,
                    const XT* __restrict__ w, const float* __restrict__ a,
                    const float* __restrict__ ad, const float* __restrict__ b,
                    const float* __restrict__ bd, XT* __restrict__ yd,
                    int M, int K, int N, int r, float scale) {
  const int t = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const XT* xd_t = HAS_XD ? xd + (size_t)t * M * K : nullptr;
  const float* ad_t = ad + (size_t)t * K * r;
  const float* bd_t = bd + (size_t)t * r * N;

  __shared__ float xs[BM][BK + 1];      // x tile
  __shared__ float xds[BK][BM + 4];     // xd_t tile, transposed for the GEMM
  __shared__ float ws[BK][BN + 4];      // W tile
  __shared__ float as_[BK][R_MAX];      // A rows of this k tile
  __shared__ float ads[BK][R_MAX];      // Ad_t rows of this k tile
  __shared__ float su[BM][R_MAX];       // u  = x @ A          (this block's rows)
  __shared__ float sud[BM][R_MAX];      // ud = x @ Ad_t + xd_t @ A
  __shared__ float sb[R_MAX][BN];       // B  columns of this block
  __shared__ float sbd[R_MAX][BN];      // Bd_t columns of this block

  for (int i = tid; i < BM * R_MAX; i += THREADS) {
    su[i / R_MAX][i % R_MAX] = 0.f;
    sud[i / R_MAX][i % R_MAX] = 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      const bool in = gm < M && gk < K;
      xs[mm][kk] = in ? to_f(x[(size_t)gm * K + gk]) : 0.f;
      if (HAS_XD) xds[kk][mm] = in ? to_f(xd_t[(size_t)gm * K + gk]) : 0.f;
    }
    if (HAS_XD) {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk][nn] = (gk < K && gn < N) ? to_f(w[(size_t)gk * N + gn]) : 0.f;
      }
    }
    for (int i = tid; i < BK * r; i += THREADS) {
      const int kk = i / r, j = i % r;
      const int gk = k0 + kk;
      as_[kk][j] = gk < K ? a[(size_t)gk * r + j] : 0.f;
      ads[kk][j] = gk < K ? ad_t[(size_t)gk * r + j] : 0.f;
    }
    __syncthreads();

    if (HAS_XD) {   // the input-tangent GEMM xd_t @ W: 4 x 4 outputs a thread
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = xds[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    // rank-r pieces: one owner thread per (row, j) pair
    for (int p = tid; p < BM * r; p += THREADS) {
      const int mm = p / r, j = p % r;
      float u = su[mm][j], ud = sud[mm][j];
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float xv = xs[mm][kk];
        u = fmaf(xv, as_[kk][j], u);
        ud = fmaf(xv, ads[kk][j], ud);
        if (HAS_XD) ud = fmaf(xds[kk][mm], as_[kk][j], ud);
      }
      su[mm][j] = u;
      sud[mm][j] = ud;
    }
    __syncthreads();
  }

  for (int i = tid; i < r * BN; i += THREADS) {
    const int j = i / BN, nn = i % BN;
    const int gn = n0 + nn;
    sb[j][nn] = gn < N ? b[(size_t)j * N + gn] : 0.f;
    sbd[j][nn] = gn < N ? bd_t[(size_t)j * N + gn] : 0.f;
  }
  __syncthreads();

  XT* yd_t = yd + (size_t)t * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = ty * 4 + i, gm = m0 + mm;
    if (gm >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nn = tx * 4 + jj, gn = n0 + nn;
      if (gn >= N) continue;
      float lo = 0.f;
      for (int j = 0; j < r; ++j) {
        lo = fmaf(sud[mm][j], sb[j][nn], lo);
        lo = fmaf(su[mm][j], sbd[j][nn], lo);
      }
      yd_t[(size_t)gm * N + gn] = from_f<XT>(scale * lo + acc[i][jj]);
    }
  }
}

template <typename XT>
int launch(const void* x, const void* xd, const void* w, const void* a,
           const void* ad, const void* b, const void* bd, void* yd, int M,
           int K, int N, int r, int T, float scale, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, T);
  if (xd != nullptr) {
    lora_dual_mt_kernel<XT, true><<<grid, THREADS, 0, stream>>>(
        (const XT*)x, (const XT*)xd, (const XT*)w, (const float*)a,
        (const float*)ad, (const float*)b, (const float*)bd, (XT*)yd, M, K, N,
        r, scale);
  } else {
    lora_dual_mt_kernel<XT, false><<<grid, THREADS, 0, stream>>>(
        (const XT*)x, nullptr, (const XT*)w, (const float*)a, (const float*)ad,
        (const float*)b, (const float*)bd, (XT*)yd, M, K, N, r, scale);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Contraction epilogue: parts[mi][ni][t] = <gy, yd_t> over one (JBM, JBN)
// tile of gy, with no yd tile ever formed. Per tile, with z1 = gy @ B^T
// (this tile's columns) and u = x @ A,
//
//   <gy, yd_t> = <gy @ W^T + s z1 A^T, xd_t>        (zw: once per k step)
//              + s <x^T z1, Ad_t> + s <u^T gy, Bd_t>
//
// so everything that does not depend on t (the frozen-W product zw = gy
// @ W_k^T, e = z1 @ A_k^T and c = x_k^T z1) is formed once per k step and
// shared by all T tangents; the per-tangent work is one pass over the
// tangent's xd tile and rank-r sized dots. Each thread keeps its own
// running sum per tangent in shared memory; the block sums them in thread
// order at the end (no atomics: the same sum every run).
// ---------------------------------------------------------------------------

constexpr int JBM = 64;
constexpr int JBN = 64;
constexpr int JBK = 32;        // one warp lane per k column of a tile
constexpr int JTHREADS = 256;  // 8 warps
constexpr int JT_MAX = 64;
constexpr int JOWN = JBM * JBK / JTHREADS;   // (row, k) tile entries a thread owns

size_t jvps_smem_floats(int T) {
  return (size_t)JBM * JBN + JBK * (JBN + 1) + JBM * (JBK + 1) + JBK * R_MAX +
         2 * JBM * R_MAX + JBK * R_MAX + R_MAX * JBN + (size_t)T * JTHREADS;
}

template <typename XT, bool HAS_XD>
__global__ void __launch_bounds__(JTHREADS, 1)
lora_dual_mt_jvps_kernel(const XT* __restrict__ x, const XT* __restrict__ xd,
                         const XT* __restrict__ w, const float* __restrict__ a,
                         const float* __restrict__ ad, const float* __restrict__ b,
                         const float* __restrict__ bd, const XT* __restrict__ gy,
                         float* __restrict__ parts, int M, int K, int N, int r,
                         int T, float scale) {
  extern __shared__ float sm[];
  float* gys = sm;                          // JBM x JBN    gy tile
  float* ws = gys + JBM * JBN;              // JBK x (JBN + 1)  W_k tile
  float* xs = ws + JBK * (JBN + 1);         // JBM x (JBK + 1)  x_k tile
  float* as_ = xs + JBM * (JBK + 1);        // JBK x R_MAX  A_k rows
  float* su = as_ + JBK * R_MAX;            // JBM x R_MAX  u = x @ A
  float* z1 = su + JBM * R_MAX;             // JBM x R_MAX  gy @ B^T
  float* c = z1 + JBM * R_MAX;              // JBK x R_MAX  x_k^T z1
  float* z2 = c + JBK * R_MAX;              // R_MAX x JBN  u^T gy
  float* jp = z2 + R_MAX * JBN;             // T x JTHREADS running sums

  const int m0 = blockIdx.y * JBM;
  const int n0 = blockIdx.x * JBN;
  const int tid = threadIdx.x;
  const int kk_own = tid % JBK;             // this thread's k column ...
  const int mm_own = tid / JBK;             // ... and rows mm_own + 8 i

  for (int i = tid; i < JBM * JBN; i += JTHREADS) {
    const int gm = m0 + i / JBN, gn = n0 + i % JBN;
    gys[i] = (gm < M && gn < N) ? to_f(gy[(size_t)gm * N + gn]) : 0.f;
  }
  for (int i = tid; i < JBM * R_MAX; i += JTHREADS) su[i] = 0.f;
  for (int i = tid; i < T * JTHREADS; i += JTHREADS) jp[i] = 0.f;
  __syncthreads();
  for (int p = tid; p < JBM * r; p += JTHREADS) {
    const int mm = p / r, j = p % r;
    float s = 0.f;
    for (int nn = 0; nn < JBN && n0 + nn < N; ++nn)
      s = fmaf(gys[mm * JBN + nn], b[(size_t)j * N + n0 + nn], s);
    z1[mm * R_MAX + j] = s;
  }

  for (int k0 = 0; k0 < K; k0 += JBK) {
    __syncthreads();
    for (int i = tid; i < JBM * JBK; i += JTHREADS) {
      const int mm = i / JBK, kk = i % JBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[mm * (JBK + 1) + kk] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    if (HAS_XD) {
      for (int i = tid; i < JBK * JBN; i += JTHREADS) {
        const int kk = i / JBN, nn = i % JBN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk * (JBN + 1) + nn] = (gk < K && gn < N) ? to_f(w[(size_t)gk * N + gn]) : 0.f;
      }
    }
    for (int i = tid; i < JBK * r; i += JTHREADS) {
      const int kk = i / r, j = i % r;
      as_[kk * R_MAX + j] = k0 + kk < K ? a[(size_t)(k0 + kk) * r + j] : 0.f;
    }
    __syncthreads();

    for (int p = tid; p < JBM * r; p += JTHREADS) {     // u += x_k @ A_k
      const int mm = p / r, j = p % r;
      float s = su[mm * R_MAX + j];
      for (int kk = 0; kk < JBK; ++kk)
        s = fmaf(xs[mm * (JBK + 1) + kk], as_[kk * R_MAX + j], s);
      su[mm * R_MAX + j] = s;
    }
    for (int p = tid; p < JBK * r; p += JTHREADS) {     // c = x_k^T z1
      const int kk = p / r, j = p % r;
      float s = 0.f;
      for (int mm = 0; mm < JBM; ++mm)
        s = fmaf(xs[mm * (JBK + 1) + kk], z1[mm * R_MAX + j], s);
      c[kk * R_MAX + j] = s;
    }
    float g[JOWN];                 // (gy @ W_k^T + s z1 @ A_k^T) at owned entries
    if (HAS_XD) {
#pragma unroll
      for (int i = 0; i < JOWN; ++i) {
        const int mm = mm_own + (JTHREADS / JBK) * i;
        float zw = 0.f;
        for (int nn = 0; nn < JBN; ++nn)
          zw = fmaf(gys[mm * JBN + nn], ws[kk_own * (JBN + 1) + nn], zw);
        float e = 0.f;
        for (int j = 0; j < r; ++j) e = fmaf(z1[mm * R_MAX + j], as_[kk_own * R_MAX + j], e);
        g[i] = fmaf(scale, e, zw);
      }
    }
    __syncthreads();               // c complete

    const int gk_own = k0 + kk_own;
    for (int t = 0; t < T; ++t) {
      float s = 0.f;
      if (HAS_XD && gk_own < K) {
        const XT* xd_t = xd + (size_t)t * M * K;
#pragma unroll
        for (int i = 0; i < JOWN; ++i) {
          const int gm = m0 + mm_own + (JTHREADS / JBK) * i;
          if (gm < M) s = fmaf(g[i], to_f(xd_t[(size_t)gm * K + gk_own]), s);
        }
      }
      const float* ad_t = ad + (size_t)t * K * r;
      for (int p = tid; p < JBK * r; p += JTHREADS) {
        const int kk = p / r, j = p % r;
        if (k0 + kk < K) s = fmaf(scale * c[kk * R_MAX + j], ad_t[(size_t)(k0 + kk) * r + j], s);
      }
      jp[t * JTHREADS + tid] += s;
    }
  }
  __syncthreads();

  for (int p = tid; p < r * JBN; p += JTHREADS) {       // z2 = u^T gy
    const int j = p / JBN, nn = p % JBN;
    float s = 0.f;
    for (int mm = 0; mm < JBM; ++mm) s = fmaf(su[mm * R_MAX + j], gys[mm * JBN + nn], s);
    z2[j * JBN + nn] = s;
  }
  for (int t = 0; t < T; ++t) {
    const float* bd_t = bd + (size_t)t * r * N;
    float s = 0.f;
    for (int p = tid; p < r * JBN; p += JTHREADS) {     // entries this thread wrote
      const int j = p / JBN, gn = n0 + p % JBN;
      if (gn < N) s = fmaf(z2[p], bd_t[(size_t)j * N + gn], s);
    }
    jp[t * JTHREADS + tid] = fmaf(scale, s, jp[t * JTHREADS + tid]);
  }
  __syncthreads();
  for (int t = tid; t < T; t += JTHREADS) {
    float s = 0.f;
    for (int i = 0; i < JTHREADS; ++i) s += jp[t * JTHREADS + i];
    parts[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * T + t] = s;
  }
}

template <typename XT>
int launch_jvps(const void* x, const void* xd, const void* w, const void* a,
                const void* ad, const void* b, const void* bd, const void* gy,
                void* parts, int M, int K, int N, int r, int T, float scale,
                cudaStream_t stream) {
  const size_t smem = jvps_smem_floats(T) * sizeof(float);
  const dim3 grid((N + JBN - 1) / JBN, (M + JBM - 1) / JBM);
  auto kern = xd != nullptr ? lora_dual_mt_jvps_kernel<XT, true>
                            : lora_dual_mt_jvps_kernel<XT, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, JTHREADS, smem, stream>>>(
      (const XT*)x, (const XT*)xd, (const XT*)w, (const float*)a,
      (const float*)ad, (const float*)b, (const float*)bd, (const XT*)gy,
      (float*)parts, M, K, N, r, T, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 routes: the rank-r pre-pass, the tensor-core GEMM (route tc) and the
// store-bound kernel without an input tangent (route store). See the note
// at the top of this file.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& p, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// u (M, r) = x @ A and ud (T, M, r) = x @ Ad_t (+ xd_t @ A). Block (t + 1,
// g) owns RR_ROWS rows a warp of tangent t (t = -1: u's rows); a lane reads
// its 8-k slices of x and xd with 16-byte loads and the factors' rows
// beside them with no staging, barrier or shared memory, sums its slices in
// k order, and the warp reduces by a fixed shuffle tree. RC bounds r: at
// RC = 1, the rank of every config, A and Ad_t are single columns read as
// float4 pairs, and the kernel holds few enough registers that its blocks
// can share an SM with those of the GEMM, its programmatic dependent
// launch, whose K loop runs meanwhile; RC = R_MAX takes any r <= 16 with
// scalar loads (the 8 k of a slice are 8 r floats apart). One row a warp:
// twice the warps of two rows a warp, for the same sums in the same order,
// took 7-10% off rows 1 and 5 at llama2-7b widths. Needs K % 8 == 0 and
// 16-byte aligned x, xd, A and Ad.
constexpr int RR_WARPS = 8;
constexpr int RR_ROWS = 1;

// acc + sum_c x[c] f[c * stride], in c order
__device__ __forceinline__ float dot8(const float (&x)[8], const float* f, int stride,
                                      float acc) {
  float v[8];
  if (stride == 1) {
    const float4 f0 = *reinterpret_cast<const float4*>(f);
    const float4 f1 = *reinterpret_cast<const float4*>(f + 4);
    v[0] = f0.x; v[1] = f0.y; v[2] = f0.z; v[3] = f0.w;
    v[4] = f1.x; v[5] = f1.y; v[6] = f1.z; v[7] = f1.w;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = f[c * stride];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) acc = fmaf(x[c], v[c], acc);
  return acc;
}

template <int RC>
__global__ void __launch_bounds__(32 * RR_WARPS)
lora_mt_rank_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xd,
                    const float* __restrict__ a, const float* __restrict__ ad,
                    float* __restrict__ u, float* __restrict__ ud, int M, int K, int r) {
  // the kernel after this one (tensor-core GEMM or store kernel) may start
  // its u/ud-free work now: it waits for this grid before reading u and ud
  hopper::grid_launch_dependents();
  const int t = (int)blockIdx.x - 1;
  const float* f = t < 0 ? a : ad + (size_t)t * K * r;
  const bool with_xd = t >= 0 && xd != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (blockIdx.y * RR_WARPS + warp) * RR_ROWS;
  const int rs = RC == 1 ? 1 : r;                 // a factor's row stride, known at RC = 1
  float acc[RR_ROWS][RC];
#pragma unroll
  for (int i = 0; i < RR_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = lane * 8; k < K; k += 256) {
#pragma unroll
    for (int i = 0; i < RR_ROWS; ++i) {
      const int m = min(m0 + i, M - 1);      // rows past M are computed, not stored
      float xf[8], xdf[8];
      unpack8(*reinterpret_cast<const uint4*>(x + (size_t)m * K + k), xf);
      if (with_xd) unpack8(*reinterpret_cast<const uint4*>(xd + ((size_t)t * M + m) * K + k), xdf);
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        if (j < r) {
          acc[i][j] = dot8(xf, f + (size_t)k * rs + j, rs, acc[i][j]);
          if (with_xd) acc[i][j] = dot8(xdf, a + (size_t)k * rs + j, rs, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RR_ROWS; ++i) {
    const int m = m0 + i;
    float* out = t < 0 ? u + (size_t)m * r : ud + ((size_t)t * M + m) * r;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      if (j < r) {
        const float v = warp_sum(acc[i][j]);
        if (lane == 0 && m < M) out[j] = v;
      }
    }
  }
}

// d (64 x 64 fp32, the warpgroup's accumulator fragment) += a (64 x 16,
// K-major) * b (16 x 64, MN-major), both bf16 in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128 fp32, the warpgroup's accumulator fragment) += a (64 x 16,
// K-major) * b (16 x 128), both bf16 in shared memory; b MN-major at
// TRANS_B = 1 (the descriptor's transpose bit), K-major at 0
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B)
      : "memory");
}


constexpr int TC_BK = 64;        // k a stage: one 128-byte swizzle row of bf16

template <int WGS, int BN>
struct TcTile {
  static constexpr int BM = 64 * WGS;                // rows of the stacked GEMM
  static constexpr int THREADS = 128 * (WGS + 1);    // consumers + one producer warpgroup
  static constexpr int A_BYTES = BM * TC_BK * 2;     // BM rows of 128 bytes
  static constexpr int B_BYTES = TC_BK * BN * 2;     // BN / 64 atoms of TC_BK rows
  static constexpr int STAGE = A_BYTES + B_BYTES;    // a multiple of 1024
  // ring depth: up to 8 stages within 160 KB, which leaves room for the
  // epilogue's staged factors (at most 40 KB) in the 227 KB a block may hold
  static constexpr int STAGES = (160 * 1024) / STAGE < 8 ? (160 * 1024) / STAGE : 8;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BARS = (2 * STAGES + 1) * 8;    // full, empty, epilogue-ready
  static constexpr int NT = 2;         // tangents whose Bd columns are staged
  // floats staged for the epilogue: B and NT tangents' Bd columns, u and
  // ud of the block's rows
  static int staged_floats(int r) { return r * BN * (1 + NT) + 2 * BM * r; }
  // + 1024 bytes of slack for aligning the ring
  static constexpr int SMEM_MAX =
      1024 + RING + BARS + (R_MAX * BN * (1 + NT) + 2 * BM * R_MAX) * 4;
};

// One (BM, BN) tile of yd over the stacked rows, in a cluster of two blocks
// that share the tile's W columns (adjacent M tiles). Warpgroups 0 .. WGS-1
// consume (64 rows each, wgmma); the last one produces: one thread walks the
// K tiles, waits for a free stage, and asks the TMA unit for this block's
// xd tile and for its half of the W tile, which the TMA multicasts into
// both blocks of the cluster. A stage is free again once the consumers of
// both blocks have released it (each arrives on both blocks' empty
// barrier), so W's traffic from L2 is half a pass a block.
template <int WGS, int BN>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(128 * (WGS + 1))
lora_mt_tc_kernel(const __grid_constant__ CUtensorMap map_xd,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ b, const float* __restrict__ bd,
                  const float* __restrict__ u, const float* __restrict__ ud,
                  bf16* __restrict__ yd, int M, int K, int N, int r, int T,
                  float scale) {
  using Tile = TcTile<WGS, BN>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // swizzle atoms must start on 1024-byte boundaries of the shared window
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::RING);
  uint64_t* empty = full + STAGES;
  uint64_t* epi_ready = empty + STAGES;           // u and ud staged
  float* sB = reinterpret_cast<float*>(smem + Tile::RING + Tile::BARS);
  float* sBd = sB + r * BN;                       // NT x r x BN
  float* sU = sBd + Tile::NT * r * BN;            // BM x r: u of each row's position
  float* sUD = sU + Tile::BM * r;                 // BM x r
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const uint32_t rank = hopper::cluster_rank();
  const int TM = T * M;
  const int row0 = blockIdx.x * Tile::BM;
  const int n0 = blockIdx.y * BN;
  const int KT = (K + TC_BK - 1) / TC_BK;
  const int t0 = row0 / M;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);               // the producer's expect_tx
      hopper::mbar_init(&empty[s], 2 * WGS);        // each consumer warpgroup, both blocks
    }
    hopper::mbar_init(epi_ready, 1);
    hopper::mbar_init_fence();
  }
  // the epilogue's B and Bd columns: B's and the first NT tangents' Bd
  // columns of this tile (u and ud wait for the pre-pass, below)
  for (int i = tid; i < r * BN; i += Tile::THREADS) {
    const int j = i / BN, gn = n0 + i % BN;
    sB[i] = gn < N ? b[(size_t)j * N + gn] : 0.f;
#pragma unroll
    for (int tt = 0; tt < Tile::NT; ++tt)
      sBd[tt * r * BN + i] = (gn < N && t0 + tt < T) ? bd[((size_t)(t0 + tt) * r + j) * N + gn] : 0.f;
  }
  hopper::cluster_sync();          // both blocks' barriers initialised, staging done

  if (wg == WGS) {
    // producer: one thread issues every copy of the ring; warps 1-3 of the
    // warpgroup stage u and ud, which come from the rank-r pre-pass: they
    // wait for it (programmatic dependent launch) while the K loop runs
    if (tid >= 128 * WGS + 32) {
      hopper::grid_wait_previous();
      for (int i = tid - (128 * WGS + 32); i < Tile::BM * r; i += 96) {
        const int lr = i / r, j = i % r, grow = row0 + lr;
        const bool ok = grow < TM;
        sU[i] = ok ? u[(size_t)(grow % M) * r + j] : 0.f;
        sUD[i] = ok ? ud[(size_t)grow * r + j] : 0.f;
      }
      asm volatile("bar.sync 2, 96;\n" ::: "memory");
      if (tid == 128 * WGS + 32) hopper::mbar_arrive(epi_ready);
    } else if (tid == 128 * WGS) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);   // round 0 passes
        uint8_t* sa = smem + s * Tile::STAGE;
        uint8_t* sb = sa + Tile::A_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], Tile::STAGE);
        hopper::tma_load_2d(sa, &map_xd, &full[s], kt * TC_BK, row0);
#pragma unroll
        for (int at = 0; at < BN / 64; ++at)         // this block's half of W's atoms
          if ((at & 1) == (int)rank)
            hopper::tma_load_2d_multicast(sb + at * (TC_BK * 128), &map_w, &full[s],
                                          n0 + 64 * at, kt * TC_BK, 0x3);
      }
    }
  } else {
    // consumers: one wgmma group in flight; stage kt - 1 is released (on
    // both blocks' empty barriers) once the group of step kt is issued and
    // that of kt - 1 has retired
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    hopper::fence_acc(acc);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint8_t* sa = smem + s * Tile::STAGE + wg * 64 * 128;
      const uint8_t* sb = smem + s * Tile::STAGE + Tile::A_BYTES;
      hopper::fence_acc(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint64_t da = hopper::wgmma_desc(sa + kk * 32, 16, 1024);
        const uint64_t db = hopper::wgmma_desc(sb + kk * 16 * 128, TC_BK * 128, 1024);
        if constexpr (BN == 128) wgmma_n128<1>(acc, da, db);
        else wgmma_n64(acc, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_acc(acc);
      if (kt > 0 && tid % 128 == 0) {
        const int ps = (kt - 1) % STAGES;
        hopper::mbar_arrive_cluster(&empty[ps], 0);
        hopper::mbar_arrive_cluster(&empty[ps], 1);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc);

    hopper::mbar_wait(epi_ready, 0);
    // every consumer is done with the ring, whose every stage has landed
    // (the partner sends nothing more): it takes the output tile
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WGS) : "memory");

    // epilogue: thread (warp w, lane l) of a warpgroup holds rows 16 w + l / 4
    // (+ 8) and, in each 8-column block i, columns 8 i + 2 (l % 4) (+ 1). It
    // adds s (ud_t @ B + u @ Bd_t) into the fp32 accumulator, one rank at a
    // time over the whole row (two float2 reads a column pair, no extra
    // registers), rounds once and writes the bf16 tile to shared memory
    // (rows padded by 16 bytes: the quad's rows hit distinct banks); the
    // consumers then store it in 16-byte row chunks.
    constexpr int OLD = BN + 8;
    bf16* sO = reinterpret_cast<bf16*>(smem);
    const int lane = tid % 32;
    const int lbase = wg * 64 + ((tid % 128) / 32) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = lbase + 8 * h, grow = row0 + lr;
      if (grow >= TM) continue;
      const int t = grow / M;
      // Bd_t columns: staged for the tile's first NT tangents, else read
      const bool staged = t - t0 < Tile::NT;
      const float* bdt = staged ? sBd + (t - t0) * r * BN : bd + (size_t)t * r * N + n0;
      const int bd_ld = staged ? BN : N;
      for (int j = 0; j < r; ++j) {
        const float c1 = scale * sUD[lr * r + j], c2 = scale * sU[lr * r + j];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int c = i * 8 + (lane & 3) * 2;
          if (n0 + c >= N) continue;
          const float2 bb = *reinterpret_cast<const float2*>(sB + j * BN + c);
          const float2 bdd = *reinterpret_cast<const float2*>(bdt + j * bd_ld + c);
          acc[i * 4 + 2 * h] = fmaf(c2, bdd.x, fmaf(c1, bb.x, acc[i * 4 + 2 * h]));
          acc[i * 4 + 2 * h + 1] = fmaf(c2, bdd.y, fmaf(c1, bb.y, acc[i * 4 + 2 * h + 1]));
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = i * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(sO + lr * OLD + c) =
            hopper::pack_bf16(acc[i * 4 + 2 * h], acc[i * 4 + 2 * h + 1]);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WGS) : "memory");
    for (int i = tid; i < Tile::BM * (BN / 8); i += 128 * WGS) {
      const int lr = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int grow = row0 + lr;
      if (grow < TM && n0 + c < N)
        *reinterpret_cast<uint4*>(yd + (size_t)grow * N + n0 + c) =
            *reinterpret_cast<const uint4*>(sO + lr * OLD + c);
    }
  }
  // no block leaves while its partner may still arrive on its barriers
  hopper::cluster_sync();
}

// No input tangent: yd_t = s (ud_t @ B + u @ Bd_t), W never read. A block
// owns 256 columns (32 lanes x 8) of ST_ROWS rows of one tangent; its B and
// Bd_t columns are staged once; every row is one 512-byte warp store.
constexpr int ST_COLS = 256;
constexpr int ST_ROWS = 32;

__global__ void __launch_bounds__(256)
lora_mt_store_kernel(const float* __restrict__ b, const float* __restrict__ bd,
                     const float* __restrict__ u, const float* __restrict__ ud,
                     bf16* __restrict__ yd, int M, int N, int r, float scale) {
  __shared__ __align__(16) float sb[R_MAX][ST_COLS];
  __shared__ __align__(16) float sbd[R_MAX][ST_COLS];
  const int t = blockIdx.z;
  const int n0 = blockIdx.x * ST_COLS;
  const int m0 = blockIdx.y * ST_ROWS;
  const float* bdt = bd + (size_t)t * r * N;
  for (int i = threadIdx.x; i < r * ST_COLS; i += 256) {
    const int j = i / ST_COLS, c = i % ST_COLS, gn = n0 + c;
    sb[j][c] = gn < N ? b[(size_t)j * N + gn] : 0.f;
    sbd[j][c] = gn < N ? bdt[(size_t)j * N + gn] : 0.f;
  }
  // u and ud come from the rank-r pre-pass (programmatic dependent launch)
  hopper::grid_wait_previous();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = lane * 8, gn = n0 + c0;
  if (gn >= N) return;                 // N % 8 == 0: a lane's 8 columns are all in
  for (int mm = warp; mm < ST_ROWS && m0 + mm < M; mm += 8) {
    const int m = m0 + mm;
    const float* udr = ud + ((size_t)t * M + m) * r;
    const float* ur = u + (size_t)m * r;
    float lo[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) lo[c] = 0.f;
    for (int j = 0; j < r; ++j) {
      const float c1 = udr[j], c2 = ur[j];
#pragma unroll
      for (int c = 0; c < 8; ++c) lo[c] = fmaf(c2, sbd[j][c0 + c], fmaf(c1, sb[j][c0 + c], lo[c]));
    }
    uint4 o;
    o.x = hopper::pack_bf16(scale * lo[0], scale * lo[1]);
    o.y = hopper::pack_bf16(scale * lo[2], scale * lo[3]);
    o.z = hopper::pack_bf16(scale * lo[4], scale * lo[5]);
    o.w = hopper::pack_bf16(scale * lo[6], scale * lo[7]);
    *reinterpret_cast<uint4*>(yd + ((size_t)t * M + m) * N + gn) = o;
  }
}

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime so
// the library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 (outer, inner) matrix in boxes of (box_outer, 64): 128
// bytes of the inner dimension, swizzled for wgmma; out-of-range reads fill
// zeros
int bf16_map(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                           dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int WGS, int BN>
int launch_tc(const bf16* xd, const bf16* w, const float* b, const float* bd,
              const float* u, const float* ud, bf16* yd, int M, int K, int N,
              int r, int T, float scale, cudaStream_t stream) {
  using Tile = TcTile<WGS, BN>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(lora_mt_tc_kernel<WGS, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap map_xd, map_w;
  int err = bf16_map(&map_xd, xd, K, T * M, Tile::BM);
  if (err == 0) err = bf16_map(&map_w, w, N, K, TC_BK);
  if (err != 0) return err;
  // an even number of M tiles: the cluster pairs them
  const int mt = (T * M + Tile::BM - 1) / Tile::BM;
  const dim3 grid(mt + (mt & 1), (N + BN - 1) / BN);
  const int smem = 1024 + Tile::RING + Tile::BARS + Tile::staged_floats(r) * 4;
  return hopper::launch_dependent(lora_mt_tc_kernel<WGS, BN>, grid, Tile::THREADS, smem,
                                  stream, map_xd, map_w, b, bd, u, ud, yd, M, K, N, r, T,
                                  scale);
}

// the rank-r pre-pass: u (M, r) and ud (T, M, r) into fp32 scratch
int launch_prepass(const void* x, const void* xd, const void* a, const void* ad, float* u,
                   float* ud, int M, int K, int r, int T, cudaStream_t s) {
  const dim3 grid(T + 1, (M + RR_WARPS * RR_ROWS - 1) / (RR_WARPS * RR_ROWS));
  if (r == 1)
    lora_mt_rank_kernel<1><<<grid, 32 * RR_WARPS, 0, s>>>(
        (const bf16*)x, (const bf16*)xd, (const float*)a, (const float*)ad, u, ud, M, K, r);
  else
    lora_mt_rank_kernel<R_MAX><<<grid, 32 * RR_WARPS, 0, s>>>(
        (const bf16*)x, (const bf16*)xd, (const float*)a, (const float*)ad, u, ud, M, K, r);
  return (int)cudaGetLastError();
}

// the large tile where it gives about one wave of blocks, else the small
int tc_tile_large(int TM, int N) {
  return (long long)((TM + 127) / 128) * ((N + 127) / 128) >= 120;
}

// ---------------------------------------------------------------------------
// bf16 contraction epilogue (route tc of lora_jvps_path). See the note at the
// top of this file. With z = gy @ W^T,
//
//   <gy, yd_t> = <z, xd_t> + s <gy, ud_t @ B + u @ Bd_t>,
//
// and both terms are sums over N: a block takes one slice of N, and its
// (T,) partial is a sum over that slice alone. No block sums another's z.
// ---------------------------------------------------------------------------

constexpr int JC_M = 64;       // rows of gy (and of z) a block: one consumer warpgroup
constexpr int JC_K = 128;      // columns of z a block: rows of W, the wgmma width
constexpr int JC_N = 64;       // N a stage: one 128-byte swizzle row of bf16
constexpr int JC_STAGES = 8;
constexpr int JC_A = JC_M * JC_N * 2;       // gy tile, K-major (N contiguous)
constexpr int JC_B = JC_K * JC_N * 2;       // W tile, K-major as well: W^T's rows are W's
constexpr int JC_STAGE = JC_A + JC_B;       // 24 KB, a multiple of 1024
constexpr int JC_XD = JC_M * JC_K * 2;      // xd_t's tile: two 64-column swizzle atoms
constexpr int JC_RED = 8;                   // partials a tangent: 4 consumer, 3 rank warps
constexpr int JC_SMEM = 1024 + JC_STAGES * JC_STAGE + 2 * JC_STAGES * 8 + JT_MAX * JC_RED * 4;
constexpr int JC_WAVE = 128;   // blocks to aim for: about one wave of the 132 SMs

// The tile plan, a function of (M, K, N) alone, never of T: (M / 64, K / 128)
// tiles of z, and N split into as few slices of ``steps`` 64-column stages
// as bring the grid to about one wave.
struct JvpsPlan {
  dim3 grid;
  int steps;
};

JvpsPlan jvps_plan(int M, int K, int N) {
  const int mt = (M + JC_M - 1) / JC_M, kt = (K + JC_K - 1) / JC_K;
  const int n_steps = (N + JC_N - 1) / JC_N;
  const long long tiles = (long long)mt * kt;
  int split = (int)std::min<long long>(n_steps, std::max<long long>(1, (JC_WAVE + tiles - 1) / tiles));
  const int steps = (n_steps + split - 1) / split;
  split = (n_steps + steps - 1) / steps;
  return {dim3(mt, kt, split), steps};
}

// s <gy, ud_t @ B + u @ Bd_t> over rows m0 + first, m0 + first + stride, ...
// below min(m0 + JC_M, M) and columns [n0, n1) (n1 - n0 a multiple of 8),
// for t < T. Thread ``tid`` of ``nthr`` (whole warps) takes (row, 8-column
// chunk) pairs tid, tid + nthr, ... in order, with 16-byte loads of gy and
// float4 loads of B and Bd_t, for JC_TG tangents at once: their loads are
// independent, so a pair's L2 round trips overlap (one tangent at a time,
// the walk was bound by their latency). Its warp's sum of each tangent, by
// a fixed shuffle tree, goes to red[t * JC_RED + tid / 32]. A tangent's
// arithmetic and order are the same whatever T is and whichever group it
// falls in.
constexpr int JC_TG = 8;
__device__ void jvps_rank_terms(const bf16* __restrict__ gy, const float* __restrict__ b,
                                const float* __restrict__ bd, const float* __restrict__ u,
                                const float* __restrict__ ud, float* red, int M, int N, int r,
                                int T, float scale, int m0, int first, int stride, int n0,
                                int n1, int tid, int nthr) {
  const int lim = min(JC_M, M - m0);
  const int rows = first < lim ? (lim - 1 - first) / stride + 1 : 0;
  const int chunks = (n1 - n0) / 8;
  for (int t0 = 0; t0 < T; t0 += JC_TG) {
    const int nt = min(JC_TG, T - t0);
    float acc[JC_TG];
#pragma unroll
    for (int q = 0; q < JC_TG; ++q) acc[q] = 0.f;
    for (int p = tid; p < rows * chunks; p += nthr) {
      const int m = m0 + first + (p / chunks) * stride;
      const int c = n0 + (p % chunks) * 8;
      float g[8], lo[JC_TG][8];
      unpack8(*reinterpret_cast<const uint4*>(gy + (size_t)m * N + c), g);
#pragma unroll
      for (int q = 0; q < JC_TG; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) lo[q][i] = 0.f;
      for (int j = 0; j < r; ++j) {
        const float* bj = b + (size_t)j * N + c;
        const float4 b0 = *reinterpret_cast<const float4*>(bj);
        const float4 b1 = *reinterpret_cast<const float4*>(bj + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float c2 = u[(size_t)m * r + j];
#pragma unroll
        for (int q = 0; q < JC_TG; ++q) {
          if (q < nt) {
            const int t = t0 + q;
            const float c1 = ud[((size_t)t * M + m) * r + j];
            const float* dj = bd + ((size_t)t * r + j) * N + c;
            const float4 d0 = *reinterpret_cast<const float4*>(dj);
            const float4 d1 = *reinterpret_cast<const float4*>(dj + 4);
            const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) lo[q][i] = fmaf(c2, dv[i], fmaf(c1, bv[i], lo[q][i]));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < JC_TG; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[q] = fmaf(g[i], lo[q][i], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < JC_TG; ++q) {
      const float v = warp_sum(acc[q]);
      if (q < nt && tid % 32 == 0) red[(t0 + q) * JC_RED + tid / 32] = scale * v;
    }
  }
}

// One (JC_M, JC_K) tile of z = gy @ W^T over one slice of N, contracted with
// each xd_t's tile in fp32; nothing of z leaves the block. Warpgroup 0
// consumes: bf16 wgmma m64n128k16, fp32 accumulators in registers, one
// group in flight; then, per tangent, its accumulator fragment dotted with
// xd_t's tile from shared memory. Warpgroup 1 produces: one thread asks the
// TMA unit for the slice's gy and W tiles (both K-major, 128-byte swizzled),
// then for each xd_t tile, through a ring of full and empty mbarriers, so
// the tangents' tiles arrive while the GEMM runs; its warps 1-3 wait for
// the pre-pass (programmatic dependent launch) and add the rank-r terms of
// their share of the slice's rows. parts[t][block] = the consumer warps'
// sums + the rank warps', in a fixed order.
__global__ void __launch_bounds__(256, 1)
lora_jvps_tc_kernel(const __grid_constant__ CUtensorMap map_gy,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_xd, const bf16* __restrict__ gy,
                    const float* __restrict__ b, const float* __restrict__ bd,
                    const float* __restrict__ u, const float* __restrict__ ud,
                    float* __restrict__ parts, int M, int N, int r, int T, float scale,
                    int steps) {
  hopper::grid_launch_dependents();     // the partials' sum may launch; it waits for this grid
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + JC_STAGES * JC_STAGE);
  uint64_t* empty = full + JC_STAGES;
  float* red = reinterpret_cast<float*>(empty + JC_STAGES);    // T x JC_RED
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * JC_M, k0 = blockIdx.y * JC_K;
  const int n0 = blockIdx.z * steps * JC_N;
  const int n1 = min(N, n0 + steps * JC_N);
  const int ns = (n1 - n0 + JC_N - 1) / JC_N;     // this slice's stages (>= 1)

  if (tid == 0) {
    for (int s = 0; s < JC_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);             // the producer's expect_tx
      hopper::mbar_init(&empty[s], 4);            // each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 5) {
    // rank-r terms: rows m0 + blockIdx.y + gridDim.y i of the slice, so the
    // K tiles of one (M tile, slice) share its rows
    hopper::grid_wait_previous();
    jvps_rank_terms(gy, b, bd, u, ud, red + 4, M, N, r, T, scale, m0, blockIdx.y, gridDim.y,
                    n0, n1, tid - 160, 96);
  } else if (tid == 128) {
    for (int i = 0; i < ns + T; ++i) {
      const int s = i % JC_STAGES;
      hopper::mbar_wait(&empty[s], ((i / JC_STAGES) & 1) ^ 1);   // round 0 passes
      uint8_t* st = smem + s * JC_STAGE;
      if (i < ns) {
        const int n = n0 + i * JC_N;
        hopper::mbar_arrive_expect_tx(&full[s], JC_STAGE);
        hopper::tma_load_2d(st, &map_gy, &full[s], n, m0);
        hopper::tma_load_2d(st + JC_A, &map_w, &full[s], n, k0);
      } else {   // rows past M belong to the next tangent: the consumers skip them
        const int row = (i - ns) * M + m0;
        hopper::mbar_arrive_expect_tx(&full[s], JC_XD);
        hopper::tma_load_2d(st, &map_xd, &full[s], k0, row);
        hopper::tma_load_2d(st + JC_XD / 2, &map_xd, &full[s], k0 + 64, row);
      }
    }
  } else if (warp < 4) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    hopper::fence_acc(acc);
    for (int i = 0; i < ns; ++i) {
      const int s = i % JC_STAGES;
      hopper::mbar_wait(&full[s], (i / JC_STAGES) & 1);
      const uint8_t* sa = smem + s * JC_STAGE;
      hopper::fence_acc(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < JC_N / 16; ++kk)
        wgmma_n128<0>(acc, hopper::wgmma_desc(sa + kk * 32, 16, 1024),
                      hopper::wgmma_desc(sa + JC_A + kk * 32, 16, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_acc(acc);
      if (i > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % JC_STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(ns - 1) % JC_STAGES]);

    // per tangent: thread (warp w, lane l) holds z at rows 16 w + l / 4 (+ 8)
    // and, in each 8-column block c, columns 8 c + 2 (l % 4) (+ 1); it dots
    // them with the same entries of xd_t's tile, whose row y keeps its
    // 16-byte chunk q of each 128-byte atom row at q ^ (y % 8) (TMA's 128-byte
    // swizzle), in a fixed order; the warp's sum goes to red by a fixed tree
    const int rl = warp * 16 + (lane >> 2);
    for (int t = 0; t < T; ++t) {
      const int i = ns + t, s = i % JC_STAGES;
      hopper::mbar_wait(&full[s], (i / JC_STAGES) & 1);
      const uint8_t* xs = smem + s * JC_STAGE;
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = rl + 8 * h;
        if (m0 + y >= M) continue;
#pragma unroll
        for (int c = 0; c < JC_K / 8; ++c) {
          const uint8_t* p = xs + (c / 8) * (JC_XD / 2) + y * 128 + (((c % 8) ^ (y % 8)) << 4) +
                             (lane & 3) * 4;
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
          sum = fmaf(acc[c * 4 + 2 * h], xv.x, sum);
          sum = fmaf(acc[c * 4 + 2 * h + 1], xv.y, sum);
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        red[t * JC_RED + warp] = sum;
        hopper::mbar_arrive(&empty[s]);
      }
    }
  }
  __syncthreads();
  if (tid < T) {
    const float* rt = red + tid * JC_RED;
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    parts[(size_t)tid * gridDim.x * gridDim.y * gridDim.z + blk] =
        ((rt[0] + rt[1]) + (rt[2] + rt[3])) + ((rt[4] + rt[5]) + rt[6]);
  }
}

// No input tangent: the rank-r terms alone, over the same plan and rows
// (four warps), so parts has the same shape.
__global__ void __launch_bounds__(128)
lora_jvps_rank_kernel(const bf16* __restrict__ gy, const float* __restrict__ b,
                      const float* __restrict__ bd, const float* __restrict__ u,
                      const float* __restrict__ ud, float* __restrict__ parts, int M, int N,
                      int r, int T, float scale, int steps) {
  __shared__ float red[JT_MAX * JC_RED];
  hopper::grid_launch_dependents();
  hopper::grid_wait_previous();
  const int m0 = blockIdx.x * JC_M, n0 = blockIdx.z * steps * JC_N;
  jvps_rank_terms(gy, b, bd, u, ud, red, M, N, r, T, scale, m0, blockIdx.y, gridDim.y, n0,
                  min(N, n0 + steps * JC_N), threadIdx.x, 128);
  __syncthreads();
  if (threadIdx.x < T) {
    const float* rt = red + threadIdx.x * JC_RED;
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    parts[(size_t)threadIdx.x * gridDim.x * gridDim.y * gridDim.z + blk] =
        (rt[0] + rt[1]) + (rt[2] + rt[3]);
  }
}

int jvps_blocks(int M, int K, int N) {
  const JvpsPlan p = jvps_plan(M, K, N);
  return (int)(p.grid.x * p.grid.y * p.grid.z);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, xd, w, yd). xd may be null.
// Returns cudaGetLastError() after the launch.
extern "C" int lora_dual_mt_tangents(int dtype, const void* x, const void* xd,
                                     const void* w, const void* a,
                                     const void* ad, const void* b,
                                     const void* bd, void* yd, int M, int K,
                                     int N, int r, int T, float scale,
                                     void* stream) {
  if (r < 1 || r > R_MAX || T < 1 || T > 65535 || M < 1 || K < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, xd, w, a, ad, b, bd, yd, M, K, N, r, T, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, xd, w, a, ad, b, bd, yd, M, K, N, r, T, scale, s);
  return (int)cudaErrorInvalidValue;
}

// parts: fp32 (ceil(M/64), ceil(N/64), T), summed by the caller. dtype
// covers x, xd, w and gy; xd may be null (then W is not read).
extern "C" int lora_dual_mt_jvps(int dtype, const void* x, const void* xd,
                                 const void* w, const void* a, const void* ad,
                                 const void* b, const void* bd, const void* gy,
                                 void* parts, int M, int K, int N, int r, int T,
                                 float scale, void* stream) {
  if (r < 1 || r > R_MAX || T < 1 || T > JT_MAX || M < 1 || K < 1 || N < 1 ||
      (M + JBM - 1) / JBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_jvps<float>(x, xd, w, a, ad, b, bd, gy, parts, M, K, N, r, T, scale, s);
  if (dtype == 1)
    return launch_jvps<__nv_bfloat16>(x, xd, w, a, ad, b, bd, gy, parts, M, K, N, r, T, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 routes (K % 8 == 0, N % 8 == 0): the rank-r pre-pass into
// ``scratch`` (fp32, (M + T M) r: u, then ud), then the tensor-core GEMM
// (xd given) or the store kernel (xd null). Returns cudaGetLastError()
// after the last launch, or the first failure.
extern "C" int lora_dual_mt_tangents_bf16(const void* x, const void* xd,
                                          const void* w, const void* a,
                                          const void* ad, const void* b,
                                          const void* bd, void* yd, void* scratch,
                                          int M, int K, int N, int r, int T,
                                          float scale, void* stream) {
  if (r < 1 || r > R_MAX || T < 1 || T > 65535 || M < 1 || K < 1 || N < 1 ||
      K % 8 != 0 || N % 8 != 0 || (long long)M * (T + 1) > 0x7fffffffLL ||
      ((uintptr_t)x | (uintptr_t)xd | (uintptr_t)w | (uintptr_t)a | (uintptr_t)ad |
       (uintptr_t)b | (uintptr_t)bd) % 16 != 0 ||
      (M + RR_WARPS * RR_ROWS - 1) / (RR_WARPS * RR_ROWS) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* u = (float*)scratch;
  float* ud = u + (size_t)M * r;
  const int err = launch_prepass(x, xd, a, ad, u, ud, M, K, r, T, s);
  if (err != 0) return err;
  if (xd == nullptr) {
    const dim3 grid((N + ST_COLS - 1) / ST_COLS, (M + ST_ROWS - 1) / ST_ROWS, T);
    return hopper::launch_dependent(lora_mt_store_kernel, grid, 256, 0, s, (const float*)b,
                                    (const float*)bd, (const float*)u, (const float*)ud,
                                    (bf16*)yd, M, N, r, scale);
  }
  if (tc_tile_large(T * M, N))
    return launch_tc<2, 128>((const bf16*)xd, (const bf16*)w, (const float*)b,
                             (const float*)bd, u, ud, (bf16*)yd, M, K, N, r, T, scale, s);
  return launch_tc<1, 64>((const bf16*)xd, (const bf16*)w, (const float*)b,
                          (const float*)bd, u, ud, (bf16*)yd, M, K, N, r, T, scale, s);
}

// Blocks of a bf16 contraction-epilogue launch (its partials per tangent),
// or -1 for a shape it does not take.
extern "C" int lora_dual_mt_jvps_bf16_blocks(int M, int K, int N) {
  if (M < 1 || K < 1 || N < 1) return -1;
  return jvps_blocks(M, K, N);
}

// The bf16 contraction epilogue (K % 8 == 0, N % 8 == 0, every operand 16-byte
// aligned): the rank-r pre-pass into ``scratch`` (fp32: u (M r), ud (T M r),
// then the partials (T, lora_dual_mt_jvps_bf16_blocks)), the tensor-core GEMM
// with its contraction (xd given) or the rank-r terms alone (xd null), then
// the partials' fixed-order sum into ``jvps`` (fp32, T). Returns
// cudaGetLastError() after the last launch, or the first failure.
extern "C" int lora_dual_mt_jvps_bf16(const void* x, const void* xd, const void* w,
                                      const void* a, const void* ad, const void* b,
                                      const void* bd, const void* gy, void* scratch,
                                      void* jvps, int M, int K, int N, int r, int T,
                                      float scale, void* stream) {
  if (r < 1 || r > R_MAX || T < 1 || T > JT_MAX || M < 1 || K < 1 || N < 1 ||
      K % 8 != 0 || N % 8 != 0 || (long long)M * (T + 1) > 0x7fffffffLL ||
      ((uintptr_t)x | (uintptr_t)xd | (uintptr_t)w | (uintptr_t)a | (uintptr_t)ad |
       (uintptr_t)b | (uintptr_t)bd | (uintptr_t)gy) % 16 != 0 ||
      (M + RR_WARPS * RR_ROWS - 1) / (RR_WARPS * RR_ROWS) > 65535 ||
      (K + JC_K - 1) / JC_K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* u = (float*)scratch;
  float* ud = u + (size_t)M * r;
  float* parts = ud + (size_t)T * M * r;
  int err = launch_prepass(x, xd, a, ad, u, ud, M, K, r, T, s);
  if (err != 0) return err;
  const JvpsPlan plan = jvps_plan(M, K, N);
  if (xd == nullptr) {
    err = hopper::launch_dependent(lora_jvps_rank_kernel, plan.grid, 128, 0, s, (const bf16*)gy,
                                   (const float*)b, (const float*)bd, (const float*)u,
                                   (const float*)ud, parts, M, N, r, T, scale, plan.steps);
  } else {
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(lora_jvps_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, JC_SMEM);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    CUtensorMap map_gy, map_w, map_xd;
    err = bf16_map(&map_gy, gy, N, M, JC_M);
    if (err == 0) err = bf16_map(&map_w, w, N, K, JC_K);
    if (err == 0) err = bf16_map(&map_xd, xd, K, T * M, JC_M);
    if (err != 0) return err;
    err = hopper::launch_dependent(lora_jvps_tc_kernel, plan.grid, 256, JC_SMEM, s, map_gy,
                                   map_w, map_xd, (const bf16*)gy, (const float*)b,
                                   (const float*)bd, (const float*)u, (const float*)ud, parts,
                                   M, N, r, T, scale, plan.steps);
  }
  if (err != 0) return err;
  return hopper::launch_dependent(hopper::sum_parts_kernel<32>, dim3(T), 32, 0, s,
                                  (const float*)parts, (float*)jvps,
                                  (int)(plan.grid.x * plan.grid.y * plan.grid.z));
}
