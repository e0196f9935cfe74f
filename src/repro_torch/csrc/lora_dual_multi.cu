// Multi-adapter LoRA projection for Hopper (sm_90a), plain C interface.
//
//   y[m] = x[m] @ W + s * (x[m] @ A[idx[m]]) @ B[idx[m]]
//
// for a batch whose rows each read their own adapter page, in one pass over
// the shared frozen W. Replaces the TPU kernel
// repro/kernels/lora_dual/kernel.py::lora_dual_multi_kernel. x, W, y: XT
// (float or bf16); A stack (P, K, r), B stack (P, r, N): float; idx (M,)
// int32. All sums are fp32; the output is rounded once. A row whose page is
// outside [0, P) reads no page and is written as NaN.
//
// At the serving engine's decode (M = 4 rows, K = N = 4096, bf16) the call
// is bound by the bytes of W: 33.6 MB, 10 us at 3.35 TB/s, against 4 flop a
// byte; and the engine's step finds each of its 64 W cold in the L2. The
// bf16 route for M <= 16 (lora_multi_stream_kernel) streams W from HBM: a
// block owns a strip of 128 columns and one of 8 K slices (32 x 8 = 256
// blocks of 256 threads at decode, all resident at once). Each thread owns
// 8 columns of the strip and every 16th row of the slice: it keeps 10
// 16-byte cp.async copies of its rows in flight, each into its own slot of a
// shared-memory ring (40 KB a block, about 80 KB an SM), and keeps fp32 sums
// for the block's rows; x's K slice comes first into shared memory, by the
// same copies. The 8 slices of a strip form a
// thread-block cluster: each block sums its threads (shuffles, then its
// warps in order), sends the partials of columns 16 c .. 16 c + 15 into
// block c's shared memory and its slice of u = x @ A[page] (read from the
// pages its rows use only) to every block, and after one cluster barrier
// block c sums the 8 partials in rank order, adds s * u @ B[page] and rounds
// once. No float atomics and no workspace: two launches on the same inputs
// are bitwise equal, and a call is one launch.
//
// Every other case (fp32, M > 16, K or N off the 8-element rows, x or W off
// 16 bytes, K > 8192) is lora_dual_multi_kernel: a (N/32, M/8) grid of 512
// threads; lanes run along N (neighbouring columns of one W row), the
// block's 16 warps split each 512-wide K chunk staged in shared memory,
// each thread holds fp32 sums for the block's 8 rows of its column, and
// the block accumulates u from its rows' pages in the same K loop; the
// epilogue sums the warps' partials in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16, M <= 16: stream W (see the note at the top)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int SN = 128;                 // columns a block, 8 a thread
constexpr int SPLIT = 8;                // K slices: the blocks of a cluster
constexpr int CW = SN / SPLIT;          // columns each block of a cluster finishes
constexpr int ST = 256;                 // threads a block
constexpr int SROWS = ST / (SN / 8);    // 16 W rows a block reads at once
constexpr int STREAM_M_MAX = 16;
constexpr int STREAM_K_MAX = 8192;

// 16-byte copies of W a thread keeps in flight, each into its own slot of
// a shared-memory ring (40 KB a block, so three blocks an SM at MB <= 4:
// the 32 clusters of the decode shape are resident at once)
constexpr int NST = 10;
// loads a thread issues before it uses any of u's A values
constexpr int BATCH = 16;

// shared memory of a stream block (floats): the W ring (NST x ST x 16
// bytes), which after the W loop holds the warps' partials of x @ W (ST /
// 32 x MB x SN); x's K slice (MB x ks bf16); the u slices (ULEN); the
// partials the cluster's blocks send this one (SPLIT x MB x CW of x @ W,
// SPLIT x MB x R_MAX of u); the rows' pages
constexpr int ULEN = ST > STREAM_M_MAX * R_MAX ? ST : STREAM_M_MAX * R_MAX;
__host__ __device__ constexpr int ring_floats(int mb) {
  return NST * ST * 4 > (ST / 32) * mb * SN ? NST * ST * 4 : (ST / 32) * mb * SN;
}
size_t stream_smem_bytes(int mb, int ks) {
  return sizeof(float) * ((size_t)ring_floats(mb) + (size_t)ks * mb / 2 + ULEN +
                          SPLIT * mb * (CW + R_MAX) + mb);
}

template <int MB>
__global__ void __cluster_dims__(1, SPLIT, 1) __launch_bounds__(ST, MB <= 4 ? 3 : MB <= 8 ? 2 : 1)
lora_multi_stream_kernel(const bf16* __restrict__ x, const int* __restrict__ idx,
                         const bf16* __restrict__ w, const float* __restrict__ a,
                         const float* __restrict__ b, bf16* __restrict__ y, int M, int K,
                         int N, int r, int P, int ks, float scale) {
  extern __shared__ __align__(16) float sm[];
  uint4* ring = reinterpret_cast<uint4*>(sm);  // NST x ST
  float* wred = sm;                            // ST / 32 x MB x SN, after the W loop
  bf16* xs = reinterpret_cast<bf16*>(sm + ring_floats(MB));          // MB x ks
  float* ured = sm + ring_floats(MB) + (size_t)ks * MB / 2;         // ULEN
  float* xin = ured + ULEN;                    // SPLIT x MB x CW: x @ W from each slice
  float* uin = xin + SPLIT * MB * CW;          // SPLIT x MB x R_MAX: u from each slice
  int* spage = reinterpret_cast<int*>(uin + SPLIT * MB * R_MAX);   // MB

  const int tid = threadIdx.x;
  const int cg = tid % (SN / 8), rg = tid / (SN / 8);   // column chunk, row group
  const int n0 = blockIdx.x * SN;
  const int rank = (int)hopper::cluster_rank();          // this block's K slice
  const int k0 = rank * ks, k1 = min(K, k0 + ks);
  const bool col_ok = n0 + 8 * cg < N;                    // N % 8 == 0: all 8 or none
  const bf16* wc = w + n0 + 8 * cg;
  hopper::cluster_arrive();             // started; waited on before the first remote store

  // x's slice goes first, by 16-byte cp.async (group 0), ahead of W in the
  // memory queues; then step s of this thread copies its 8 columns of W row
  // k0 + rg + s SROWS into ring slot s % NST (zeros past the slice), one
  // group a step, NST steps in flight. A thread reads only its own slots, so
  // its own cp.async waits order them: no barrier after x's
  for (int c = tid; c < MB * ks / 8; c += ST) {
    const int m = c / (ks / 8), kk = 8 * (c % (ks / 8));
    const bool ok = m < M && k0 + kk < K;                  // K % 8 == 0
    hopper::cp_async16(xs + m * ks + kk, ok ? x + (size_t)m * K + k0 + kk : x, ok);
  }
  hopper::cp_async_commit();
  const int steps = ks / SROWS;
  auto issue = [&](int step) {
    const int kr = k0 + rg + step * SROWS;
    const bool ok = col_ok && step < steps && kr < k1;
    hopper::cp_async16(ring + (step % NST) * ST + tid, ok ? wc + (size_t)kr * N : w, ok);
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < NST; ++st) issue(st);
  const int pv = tid < M ? idx[tid] : -1;   // thread m < M: row m's page
  if (tid < MB) spage[tid] = pv >= 0 && pv < P ? pv : -1;
  hopper::cp_async_wait<NST>();
  __syncthreads();
  // x @ W over this slice: thread (cg, rg) sums rows rg, rg + SROWS, ...
  // (its zero-filled steps past the slice add nothing), refilling each slot
  // once its value is in registers
  float acc[MB][8];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;
  for (int st = 0; st < steps; ++st) {
    hopper::cp_async_wait<NST - 1>();
    const uint4 wv = ring[(st % NST) * ST + tid];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&wv);
    float wf[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(h[c]);
      wf[2 * c] = f.x;
      wf[2 * c + 1] = f.y;
    }
    const bf16* xr = xs + rg + st * SROWS;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float xm = __bfloat162float(xr[m * ks]);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xm, wf[c], acc[m][c]);
    }
    issue(st + NST);
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the warps' partials
  // u's slice, now that W's traffic is past: (slice sl, pair (m, j)) over
  // k = k0 + sl, + n_sl, ...
  const int pr = M * r, n_sl = max(1, ST / pr);
  for (int t = tid; t < pr * n_sl; t += ST) {
    const int pair = t % pr, sl = t / pr;
    const int m = pair / r, j = pair % r, pg = spage[m];
    float up = 0.f;
    if (pg >= 0) {
      const float* ap = a + ((size_t)pg * K + k0) * r + j;
      for (int kk0 = sl; k0 + kk0 < k1; kk0 += BATCH * n_sl) {
        float av[BATCH];
#pragma unroll
        for (int e = 0; e < BATCH; ++e) {
          const int kk = kk0 + e * n_sl;
          av[e] = k0 + kk < k1 ? ap[(size_t)kk * r] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < BATCH; ++e)
          if (k0 + kk0 + e * n_sl < k1)
            up = fmaf(__bfloat162float(xs[m * ks + kk0 + e * n_sl]), av[e], up);
      }
    }
    ured[t] = up;
  }

  // the block's partials: a warp's row groups by shuffles (lanes below SN /
  // 8 then hold the warp's sums), the warps in order, u's slices in order;
  // each sent to the cluster block that finishes its columns (x @ W) or to
  // every block (u), at this block's slot
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[m][c];
#pragma unroll
      for (int o = SN / 8; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < SN / 8) wred[(warp * MB + m) * SN + 8 * lane + c] = v;
    }
  __syncthreads();
  hopper::cluster_wait();
  for (int i = tid; i < MB * SN; i += ST) {
    float v = wred[i];
    for (int wi = 1; wi < ST / 32; ++wi) v += wred[wi * MB * SN + i];
    const int m = i / SN, col = i % SN;
    hopper::st_cluster_f32(xin + (rank * MB + m) * CW + col % CW, col / CW, v);
  }
  for (int t = tid; t < pr; t += ST) {
    float v = 0.f;
    for (int sl = 0; sl < n_sl; ++sl) v += ured[sl * pr + t];
    for (int c = 0; c < SPLIT; ++c) hopper::st_cluster_f32(uin + rank * MB * R_MAX + t, c, v);
  }
  hopper::cluster_sync();               // every slice's partials have arrived

  // this block finishes columns CW rank .. CW rank + CW - 1 of the strip:
  // the slices' partials in rank order, then s u @ B[page], rounded once
  if (tid < M * CW) {
    const int m = tid / CW, cc = tid % CW, n = n0 + CW * rank + cc;
    if (n < N) {
      float xw = 0.f;
      for (int c = 0; c < SPLIT; ++c) xw += xin[(c * MB + m) * CW + cc];
      const int page = spage[m];
      float out = __int_as_float(0x7fc00000);   // NaN: no page for this row
      if (page >= 0) {
        const float* bp = b + (size_t)page * r * N + n;
        float lo = 0.f;
        for (int j = 0; j < r; ++j) {
          float u = 0.f;
          for (int c = 0; c < SPLIT; ++c) u += uin[c * MB * R_MAX + m * r + j];
          lo = fmaf(u, bp[(size_t)j * N], lo);
        }
        out = fmaf(scale, lo, xw);
      }
      y[(size_t)m * N + n] = __float2bfloat16(out);
    }
  }
}

// rows of W a K slice holds: a quarter of K rounded up to the rows the
// block reads at once, so every thread takes the same steps
int slice_rows(int K) { return ((K + SPLIT - 1) / SPLIT + SROWS - 1) / SROWS * SROWS; }

template <int MB>
int launch_stream_mb(const void* x, const void* idx, const void* w, const void* a,
                     const void* b, void* y, int M, int K, int N, int r, int P, float scale,
                     cudaStream_t stream) {
  const int ks = slice_rows(K);
  static bool attr_set = false;
  if (!attr_set) {   // the largest plan: K = STREAM_K_MAX
    const size_t most = stream_smem_bytes(MB, slice_rows(STREAM_K_MAX));
    cudaError_t e = cudaFuncSetAttribute(lora_multi_stream_kernel<MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((N + SN - 1) / SN, SPLIT);
  lora_multi_stream_kernel<MB><<<grid, ST, stream_smem_bytes(MB, ks), stream>>>(
      (const bf16*)x, (const int*)idx, (const bf16*)w, (const float*)a, (const float*)b,
      (bf16*)y, M, K, N, r, P, ks, scale);
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

// bf16, 1 <= M <= 16, K % 8 == 0, K <= 8192, N % 8 == 0, x and W 16-byte
// aligned: the streaming kernel. Arguments as lora_dual_multi without the
// dtype.
extern "C" int lora_dual_multi_stream(const void* x, const void* idx, const void* w,
                                      const void* a, const void* b, void* y, int M, int K,
                                      int N, int r, int P, float scale, void* stream) {
  if (r < 1 || r > R_MAX || P < 1 || M < 1 || M > STREAM_M_MAX || K < 1 ||
      K > STREAM_K_MAX || K % 8 != 0 || N < 1 || N % 8 != 0 ||
      ((uintptr_t)x | (uintptr_t)w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 4) return launch_stream_mb<4>(x, idx, w, a, b, y, M, K, N, r, P, scale, s);
  if (M <= 8) return launch_stream_mb<8>(x, idx, w, a, b, y, M, K, N, r, P, scale, s);
  return launch_stream_mb<16>(x, idx, w, a, b, y, M, K, N, r, P, scale, s);
}
