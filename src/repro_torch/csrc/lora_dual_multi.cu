// Multi-adapter LoRA projection for Hopper (sm_90a), plain C interface.
//
//   y[m] = x[m] @ W + s * (x[m] @ A[idx[m]]) @ B[idx[m]]
//
// for a batch whose rows each read their own adapter page, in one pass over
// the shared frozen W. Replaces the TPU kernel
// repro/kernels/lora_dual/kernel.py::lora_dual_multi_kernel. See
// repro_torch/kernels/lora_dual/ops.py for the design notes. x, W, y: XT
// (float or bf16); A stack (P, K, r), B stack (P, r, N): float; idx (M,)
// int32. All sums are fp32; the output is rounded once. A row whose page is
// outside [0, P) reads no page and is written as NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BN = 32;            // columns a block, one a lane
constexpr int KW = 16;            // warps a block, each on its slice of a K chunk
constexpr int THREADS = BN * KW;  // 512
constexpr int BM = 8;             // rows a block
constexpr int KC = 512;           // K chunk staged in shared memory
constexpr int KPW = KC / KW;      // k a warp reads a chunk
constexpr int R_MAX = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename XT>
__global__ void __launch_bounds__(THREADS)
lora_dual_multi_kernel(const XT* __restrict__ x, const int* __restrict__ idx,
                       const XT* __restrict__ w, const float* __restrict__ a,
                       const float* __restrict__ b, XT* __restrict__ y, int M,
                       int K, int N, int r, int P, float scale) {
  __shared__ float xs[BM][KC];          // x rows of this block, one K chunk
  __shared__ float red[KW][BM][BN];     // each warp's partial x @ W
  __shared__ float ured[THREADS];       // each thread's partial x @ A
  __shared__ float su[BM][R_MAX];       // u = x @ A[page]
  __shared__ int spage[BM];             // each row's page, -1 if none

  const int tid = threadIdx.x;
  const int lane = tid % BN;
  const int warp = tid / BN;
  const int n = blockIdx.x * BN + lane;
  const int m0 = blockIdx.y * BM;
  const int mt = min(BM, M - m0);       // rows of this block
  if (tid < BM) {
    int p = -1;
    if (tid < mt) {
      const int v = idx[m0 + tid];
      p = (v >= 0 && v < P) ? v : -1;
    }
    spage[tid] = p;
  }
  // the rank-r piece: thread tid owns the pair (um, uj) on k slice `slice`
  // of every chunk; the block sums the slices in order at the end
  const int pr = BM * r;
  const int n_slices = THREADS / pr;
  const int slice = tid / pr;
  const int um = (tid % pr) / r, uj = (tid % pr) % r;
  float upart = 0.f;
  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;
  __syncthreads();
  const int upage = slice < n_slices ? spage[um] : -1;

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = tid; i < BM * KC; i += THREADS) {
      const int mm = i / KC, kk = i % KC;
      const int gk = k0 + kk;
      xs[mm][kk] = (mm < mt && gk < K) ? to_f(x[(size_t)(m0 + mm) * K + gk]) : 0.f;
    }
    __syncthreads();
    // frozen-W product: this lane's column over the warp's k slice; lanes
    // read neighbouring columns of one W row (coalesced), x is a broadcast
    const int kb = warp * KPW;
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int gk = k0 + kb + i;
      const float wv = (gk < K && n < N) ? to_f(w[(size_t)gk * N + n]) : 0.f;
#pragma unroll
      for (int m = 0; m < BM; ++m) acc[m] = fmaf(xs[m][kb + i], wv, acc[m]);
    }
    if (upage >= 0) {
      const float* a_p = a + (size_t)upage * K * r;
      for (int kk = slice; kk < KC && k0 + kk < K; kk += n_slices)
        upart = fmaf(xs[um][kk], a_p[(size_t)(k0 + kk) * r + uj], upart);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) red[warp][m][lane] = acc[m];
  ured[tid] = upart;
  __syncthreads();
  if (tid < pr) {
    float s = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) s += ured[sl * pr + tid];
    su[tid / r][tid % r] = s;
  }
  __syncthreads();

  for (int o = tid; o < BM * BN; o += THREADS) {
    const int mm = o / BN, nn = o % BN;
    const int gn = blockIdx.x * BN + nn;
    if (mm >= mt || gn >= N) continue;
    float yv = 0.f;
    for (int ww = 0; ww < KW; ++ww) yv += red[ww][mm][nn];
    const int page = spage[mm];
    float out = __int_as_float(0x7fc00000);   // NaN: no page for this row
    if (page >= 0) {
      const float* b_p = b + (size_t)page * r * N;
      float lo = 0.f;
      for (int j = 0; j < r; ++j) lo = fmaf(su[mm][j], b_p[(size_t)j * N + gn], lo);
      out = fmaf(scale, lo, yv);
    }
    y[(size_t)(m0 + mm) * N + gn] = from_f<XT>(out);
  }
}

template <typename XT>
int launch(const void* x, const void* idx, const void* w, const void* a,
           const void* b, void* y, int M, int K, int N, int r, int P,
           float scale, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_dual_multi_kernel<XT><<<grid, THREADS, 0, stream>>>(
      (const XT*)x, (const int*)idx, (const XT*)w, (const float*)a,
      (const float*)b, (XT*)y, M, K, N, r, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, y). Returns cudaGetLastError()
// after the launch.
extern "C" int lora_dual_multi(int dtype, const void* x, const void* idx,
                               const void* w, const void* a, const void* b,
                               void* y, int M, int K, int N, int r, int P,
                               float scale, void* stream) {
  if (r < 1 || r > R_MAX || P < 1 || M < 1 || K < 1 || N < 1 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, idx, w, a, b, y, M, K, N, r, P, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, idx, w, a, b, y, M, K, N, r, P, scale, s);
  return (int)cudaErrorInvalidValue;
}
