// Causal (sliding-window) GQA flash attention for Hopper (sm_90a): primal,
// multi-tangent, and the multi-tangent jvp-contraction epilogue; plain C
// interface.
//
// Replaces the TPU kernels repro/kernels/swa_attention/kernel.py::
// swa_attention_kernel, swa_attention_mt_kernel (emit_primal=False) and
// swa_attention_mt_jvps_kernel. See repro_torch/kernels/swa_attention/ops.py
// for the design note.
//
// Layout: q (BH, S, hd), k/v (BKV, S, hd) with BKV = BH / G; the tangents
// lead with T: qd (T, BH, S, hd), kd/vd (T, BKV, S, hd) -> od (T, BH, S, hd).
// Query row (bh, i) reads kv row (bh / H) * (H / G) + (bh % H) / G. The
// contraction epilogue reads gy (BH, S, hd) instead of writing od and
// writes one fp32 partial per (bh, query block, t): parts (BH, QB, T).
//
// One warp per query row; lanes split hd (NI = ceil(hd / 32) elements a
// lane). Keys are walked in chunks of KC = 32 staged in shared memory as
// fp32: lane j scores key j, the warp reduces max and sum with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int KC = 32;
constexpr int T_MAX = 64;   // at hd = 128 one warp a block then needs 132 KB
constexpr int HD_MAX = 128;
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on sm_90

// what a launch computes: the primal, T tangent outputs, or T contractions
// <gy, od_t> with no tangent output
enum Mode { PRIMAL = 0, TANGENTS = 1, JVPS = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Stage keys [c0, c0 + KC) of one (S, hd) matrix: rows past S are zero.
// ``stride`` is hd + 1 for matrices read key-major by lane (no bank
// conflicts), hd for matrices read hd-major.
template <typename XT>
__device__ __forceinline__ void stage(float* dst, const XT* src, int c0, int S,
                                      int hd, int stride) {
  for (int i = threadIdx.x; i < KC * hd; i += blockDim.x) {
    const int kk = i / hd, d = i % hd;
    const int pos = c0 + kk;
    dst[kk * stride + d] = pos < S ? to_f(src[(size_t)pos * hd + d]) : 0.f;
  }
}

size_t smem_floats(int mode, int hd, int T, int nwarps) {
  const bool tang = mode != PRIMAL;
  size_t kv = (size_t)KC * (2 * hd + 1) * (tang ? 2 : 1);
  size_t per_warp = hd + (tang ? (size_t)2 * T * hd + T : 0);
  size_t red = mode == JVPS ? (size_t)nwarps * T : 0;   // the block's row partials
  return kv + per_warp * nwarps + red;
}

// warps (query rows) a block: 8, halved until the shared-memory plan fits
int pick_warps(int mode, int hd, int T) {
  int nwarps = 8;
  while (nwarps > 1 && smem_floats(mode, hd, T, nwarps) * sizeof(float) > SMEM_LIMIT)
    nwarps /= 2;
  return nwarps;
}

template <typename XT, int NI, int MODE>
__global__ void swa_kernel(const XT* __restrict__ q, const XT* __restrict__ k,
                           const XT* __restrict__ v, const XT* __restrict__ qd,
                           const XT* __restrict__ kd, const XT* __restrict__ vd,
                           const XT* __restrict__ gy, XT* __restrict__ out,
                           float* __restrict__ parts, int BH, int S, int hd,
                           int H, int G, int T, int window, float scale) {
  constexpr bool TANG = MODE != PRIMAL;
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * nwarps;
  const int qpos = q0 + warp;
  const bool active = qpos < S;
  const int BKV = BH / G;
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;

  float* ks = smem;                                 // KC x (hd + 1)
  float* vs = ks + KC * (hd + 1);                   // KC x hd
  float* kds = vs + KC * hd;                        // KC x (hd + 1), TANG only
  float* vds = kds + (TANG ? KC * (hd + 1) : 0);    // KC x hd,       TANG only
  float* wbase = vds + (TANG ? KC * hd : 0);
  const size_t per_warp = hd + (TANG ? (size_t)2 * T * hd + T : 0);
  float* qrow = wbase + warp * per_warp;            // hd
  float* qdrow = qrow + hd;                         // T x hd
  float* accd = qdrow + (TANG ? T * hd : 0);        // T x hd
  float* mud = accd + (TANG ? T * hd : 0);          // T

  const XT* kmat = k + (size_t)kvh * S * hd;
  const XT* vmat = v + (size_t)kvh * S * hd;
  if (active) {
    const XT* qg = q + ((size_t)bh * S + qpos) * hd;
    for (int d = lane; d < hd; d += 32) qrow[d] = to_f(qg[d]);
    if (TANG) {
      for (int t = 0; t < T; ++t) {
        const XT* qdg = qd + (((size_t)t * BH + bh) * S + qpos) * hd;
        for (int d = lane; d < hd; d += 32) {
          qdrow[t * hd + d] = to_f(qdg[d]);
          accd[t * hd + d] = 0.f;
        }
      }
      if (lane == 0)
        for (int t = 0; t < T; ++t) mud[t] = 0.f;
    }
  }
  __syncwarp();

  float m = NEG_INF, l = 0.f;
  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;

  // the block's rows share one band: from the first row's window start
  // (chunk-aligned, as the reference's (q_start - (window - 1)) // block_k)
  // to the last row
  const int q_last = min(q0 + nwarps, S) - 1;
  int c_first = 0;
  if (window > 0) c_first = max(0, floor_div(q0 - (window - 1), KC)) * KC;

  for (int c0 = c_first; c0 <= q_last; c0 += KC) {
    __syncthreads();
    stage(ks, kmat, c0, S, hd, hd + 1);
    stage(vs, vmat, c0, S, hd, hd);
    __syncthreads();

    const int kpos = c0 + lane;
    const bool keep = active && kpos <= qpos && kpos < S &&
                      (window <= 0 || kpos > qpos - window);
    float p = 0.f, alpha = 1.f;
    if (active) {
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qrow[d], ks[lane * (hd + 1) + d], s);
      s = keep ? s * scale : NEG_INF;
      const float m_new = fmaxf(m, warp_max(s));
      alpha = expf(m - m_new);
      // explicit keep-gating: exp(NEG_INF - NEG_INF) would be 1, not 0
      p = keep ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i] *= alpha;
      for (int j = 0; j < KC; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) acc[i] = fmaf(pj, vs[j * hd + d], acc[i]);
        }
      }
      m = m_new;
    }

    if (TANG) {
      for (int t = 0; t < T; ++t) {
        __syncthreads();
        stage(kds, kd + ((size_t)t * BKV + kvh) * S * hd, c0, S, hd, hd + 1);
        stage(vds, vd + ((size_t)t * BKV + kvh) * S * hd, c0, S, hd, hd);
        __syncthreads();
        if (!active) continue;
        const float* qdt = qdrow + t * hd;
        float sd = 0.f;
        for (int d = 0; d < hd; ++d) {
          sd = fmaf(qdt[d], ks[lane * (hd + 1) + d], sd);
          sd = fmaf(qrow[d], kds[lane * (hd + 1) + d], sd);
        }
        // p == 0 lanes kill any out-of-band score tangent
        const float psd = p * (sd * scale);
        const float mu_new = mud[t] * alpha + warp_sum(psd);
        float ad[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          ad[i] = d < hd ? accd[t * hd + d] * alpha : 0.f;
        }
        for (int j = 0; j < KC; ++j) {
          const float psj = __shfl_sync(0xffffffffu, psd, j);
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int d = lane + 32 * i;
            if (d < hd) ad[i] = fmaf(psj, vs[j * hd + d], fmaf(pj, vds[j * hd + d], ad[i]));
          }
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) accd[t * hd + d] = ad[i];
        }
        __syncwarp();
        if (lane == 0) mud[t] = mu_new;
        __syncwarp();
      }
    }
  }

  const float lc = fmaxf(l, 1e-30f);
  if (MODE == JVPS) {
    // finish: od_t = accd_t / l - (mud_t / l) * out, contracted with this
    // row's gy in fp32 and reduced over the warp; the block's rows are
    // then summed in warp order (no atomics: the same sum every run)
    float* red = wbase + nwarps * per_warp;         // nwarps x T
    float g[NI];
    const XT* gyg = gy + ((size_t)bh * S + (active ? qpos : 0)) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      g[i] = (active && d < hd) ? to_f(gyg[d]) : 0.f;
    }
    for (int t = 0; t < T; ++t) {
      float part = 0.f;
      if (active) {
        const float mu_l = mud[t] / lc;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) part = fmaf(g[i], accd[t * hd + d] / lc - mu_l * (acc[i] / lc), part);
        }
      }
      part = warp_sum(part);
      if (lane == 0) red[warp * T + t] = part;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum += red[w * T + t];
      parts[((size_t)bh * gridDim.y + blockIdx.y) * T + t] = sum;
    }
    return;
  }
  if (!active) return;
  if (!TANG) {
    XT* og = out + ((size_t)bh * S + qpos) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) og[d] = from_f<XT>(acc[i] / lc);
    }
    return;
  }
  for (int t = 0; t < T; ++t) {
    XT* odg = out + (((size_t)t * BH + bh) * S + qpos) * hd;
    const float mu_l = mud[t] / lc;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) odg[d] = from_f<XT>(accd[t * hd + d] / lc - mu_l * (acc[i] / lc));
    }
  }
}

template <typename XT, int NI, int MODE>
int launch_ni(const void* q, const void* k, const void* v, const void* qd,
              const void* kd, const void* vd, const void* gy, void* out,
              int BH, int S, int hd, int H, int G, int T, int window,
              float scale, cudaStream_t stream) {
  const int nwarps = pick_warps(MODE, hd, T);
  const size_t smem = smem_floats(MODE, hd, T, nwarps) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = swa_kernel<XT, NI, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(BH, (S + nwarps - 1) / nwarps);
  kern<<<grid, nwarps * 32, smem, stream>>>(
      (const XT*)q, (const XT*)k, (const XT*)v, (const XT*)qd, (const XT*)kd,
      (const XT*)vd, (const XT*)gy, MODE == JVPS ? nullptr : (XT*)out,
      MODE == JVPS ? (float*)out : nullptr, BH, S, hd, H, G, T, window, scale);
  return (int)cudaGetLastError();
}

template <typename XT, int MODE>
int launch(const void* q, const void* k, const void* v, const void* qd,
           const void* kd, const void* vd, const void* gy, void* out, int BH,
           int S, int hd, int H, int G, int T, int window, float scale,
           cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch_ni<XT, 1, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    case 2: return launch_ni<XT, 2, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    case 3: return launch_ni<XT, 3, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    case 4: return launch_ni<XT, 4, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_args(int BH, int S, int hd, int H, int G, int T) {
  return BH < 1 || S < 1 || hd < 1 || hd > HD_MAX || H < 1 || G < 1 ||
         H % G != 0 || BH % H != 0 || T < 1 || T > T_MAX ||
         S > 65535;   // grid.y = ceil(S / warps) must stay <= 65535
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means full causal.
// Each entry returns cudaGetLastError() after its launch.
extern "C" int swa_attention_fwd(int dtype, const void* q, const void* k,
                                 const void* v, void* out, int BH, int S,
                                 int hd, int H, int G, int window, float scale,
                                 void* stream) {
  if (bad_args(BH, S, hd, H, G, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, PRIMAL>(q, k, v, nullptr, nullptr, nullptr, nullptr, out, BH, S, hd, H, G, 1, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, PRIMAL>(q, k, v, nullptr, nullptr, nullptr, nullptr, out, BH, S, hd, H, G, 1, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int swa_attention_mt_tangents(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* qd, const void* kd,
                                         const void* vd, void* od, int BH,
                                         int S, int hd, int H, int G, int T,
                                         int window, float scale, void* stream) {
  if (bad_args(BH, S, hd, H, G, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, TANGENTS>(q, k, v, qd, kd, vd, nullptr, od, BH, S, hd, H, G, T, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, TANGENTS>(q, k, v, qd, kd, vd, nullptr, od, BH, S, hd, H, G, T, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Query blocks of a contraction-epilogue launch: parts has (BH, this, T).
extern "C" int swa_attention_mt_jvps_blocks(int S, int hd, int T) {
  if (S < 1 || hd < 1 || hd > HD_MAX || T < 1 || T > T_MAX) return -1;
  const int nwarps = pick_warps(JVPS, hd, T);
  return (S + nwarps - 1) / nwarps;
}

// parts: fp32 (BH, swa_attention_mt_jvps_blocks(S, hd, T), T).
extern "C" int swa_attention_mt_jvps(int dtype, const void* q, const void* k,
                                     const void* v, const void* qd,
                                     const void* kd, const void* vd,
                                     const void* gy, void* parts, int BH, int S,
                                     int hd, int H, int G, int T, int window,
                                     float scale, void* stream) {
  if (bad_args(BH, S, hd, H, G, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, JVPS>(q, k, v, qd, kd, vd, gy, parts, BH, S, hd, H, G, T, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, JVPS>(q, k, v, qd, kd, vd, gy, parts, BH, S, hd, H, G, T, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
