// LoRA multi-tangent projection for Hopper (sm_90a), plain C interface.
//
//   yd_t = s * ((x @ Ad_t + xd_t @ A) @ B + (x @ A) @ Bd_t) + xd_t @ W
//
// for t < T, in one launch over a (N/BN, M/BM, T) grid. Replaces the TPU
// kernel repro/kernels/lora_dual/kernel.py::lora_dual_mt_kernel
// (emit_primal=False). See repro_torch/kernels/lora_dual/ops.py for the
// design note. x, xd, W: XT (float or bf16); A, Ad, B, Bd: float; yd: XT.
// All sums are fp32; the output is rounded once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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
