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
// The bf16 primal with hd % 16 == 0 (swa_tc_kernel) runs on tensor cores.
// It does 4 hd operations a kept (query, key) pair and reads q, k, v once,
// so it is bound by operations at long S (S = 2048: 17 GFLOP in 16 heads)
// and by launch latency at the main path's S = 32, where it moves 0.26 MB.
// A warp owns 16 query rows (the m16n8k16 tile height); a block is one
// (b, h) and min(4, ceil(S / 16)) warps, so S = 32 takes two full warps and
// no idle rows, and S = 2048 takes 64-row blocks whose K/V tiles feed four
// warps. Keys arrive in 64-key tiles by cp.async into a double-buffered
// shared-memory ring (rows padded by 16 bytes, so ldmatrix rows hit
// distinct banks) while the previous tile is in the tensor cores. Q stays
// in registers as mma A fragments; S = Q K^T accumulates in fp32
// fragments; the keep-gate, scale and online softmax run on those
// fragments, with row max and sum reduced over the lane quad by shuffles;
// P is rounded to bf16 (as the reference's p.astype(v.dtype)) and becomes
// the A fragment of P V in registers, V read transposed by ldmatrix.trans.
// l is summed from the fp32 p and clamped at 1e-30. The longest causal
// walks launch first (blockIdx.y reversed), and a warp skips the products
// of a tile wholly after its rows or wholly before their band.
//
// The bf16 tangents with hd % 16 == 0 (swa_tc_mt_kernel) run the same
// walk on tensor cores. At the main path's S = 32 they are bound by bytes:
// the (T, B*H, S, hd) tangent stacks in and the tangent outputs out, about
// 18 MB at roberta-large's T = 8 (5.5 us); at long S by operations ((4 +
// 8 T) hd a kept pair). A block is one (b, h), one query tile of 16 rows a warp
// and a group of TW tangents (4 at hd <= 32, 2 at hd <= 64, 1 above: each
// holds a 16 x hd fp32 accumulator, hd / 2 registers a thread, beside the
// primal's and the tile's p and sd fragments); more tangents are more
// blocks, so K and V are shared by a block's warps and read again, from the
// L2, by each tangent group. Q and the group's Qd_t rows, then per key tile
// K, V and each tangent's Kd_t, Vd_t arrive by cp.async (rows padded by 16
// bytes; one buffer when S fits one tile of 64 keys, 16-row granular, else
// two). Each warp runs the primal walk itself (S = Q K^T, the online
// softmax, O += bf16(P) V), then per tangent Sd = Qd_t K^T + Q Kd_t^T on the
// tensor cores, psd = p sd scale in fp32 (its row sums into mu_t over the
// lane quad), and acc_t = alpha acc_t + psd V + bf16(p) Vd_t, V and Vd_t
// read transposed by ldmatrix. psd goes into the product as two bf16 (hi,
// lo), not rounded once as the reference's psd.astype(v.dtype): psd is
// several units where few keys are kept, and the first rows' outd = acc_t /
// l - (mu_t / l) out cancels it against the fp32 mu_t, so one rounding
// leaves up to |psd| |v| / 512 against the fp32 plain
// version's 2e-2 check. The finish writes outd_t through the warp's Qd_t
// staging rows in 16-byte stores. 16-key groups past S or past the warp's
// last row are skipped.
//
// Every other case (fp32, hd not a multiple of 16, and the contraction
// mode) is swa_kernel: one warp per query row; lanes split hd
// (NI = ceil(hd / 32) elements a lane). Keys are walked in chunks of
// KC = 32 staged in shared memory as fp32: lane j scores key j, the warp
// reduces max and sum with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16 primal on tensor cores (hd % 16 == 0). See the note at the top.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BKV = 64;       // keys a shared-memory tile
constexpr int TC_WARPS = 4;      // most warps (16 query rows each) a block

// warps a block: one per 16 query rows, at most TC_WARPS
int tc_warps(int S) { return S >= 16 * TC_WARPS ? TC_WARPS : (S + 15) / 16; }

size_t tc_smem_bytes(int hd) {   // K and V, two buffers each, rows padded by 8
  return (size_t)4 * TC_BKV * (hd + 8) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// The online softmax of one warp's 16 x TC_BKV tile of raw Q K^T sums
// ``s`` (query rows r_lo = qw + l / 4 and r_hi = r_lo + 8, keys c0 + 8 j +
// 2 (l % 4) (+1)): the keep-gate, the scale, the running maxima m_* and
// sums l_* (from the fp32 p), and the rescale al_* of what was accumulated
// before. On return s holds the fp32 p. A row's values sit in the lane quad
// l / 4, so max and sum reduce over lanes xor 1 and 2. Scores are kept in
// log2 units (scale * log2 e folded into ``scale2``), so every exponential
// is one exp2. A tile whose keys every row of the warp keeps (below the
// diagonal, inside the band, before S) skips the gate.
__device__ __forceinline__ void tile_softmax(float (&s)[TC_BKV / 8][4], float& m_lo,
                                             float& m_hi, float& l_lo, float& l_hi,
                                             float& al_lo, float& al_hi, int r_lo, int r_hi,
                                             int qw, int c0, int S, int window,
                                             float scale2) {
  const int cq = 2 * (threadIdx.x & 3);
  float sum_lo = 0.f, sum_hi = 0.f;
  auto softmax = [&](auto gated) {
    constexpr bool GATE = decltype(gated)::value;
    uint32_t keep = 0;
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < TC_BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (GATE) {
          const int qp = e < 2 ? r_lo : r_hi;
          const int kp = c0 + 8 * j + cq + (e & 1);
          const bool kb = qp < S && kp <= qp && kp < S && (window <= 0 || kp > qp - window);
          keep |= (uint32_t)kb << (4 * j + e);
          s[j][e] = kb ? s[j][e] * scale2 : NEG_INF;
        } else {
          s[j][e] *= scale2;
        }
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    al_lo = exp2f(m_lo - mn_lo);
    al_hi = exp2f(m_hi - mn_hi);
#pragma unroll
    for (int j = 0; j < TC_BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[j][e] - (e < 2 ? mn_lo : mn_hi));
        // explicit keep-gating: exp(NEG_INF - NEG_INF) would be 1, not 0
        if constexpr (GATE) s[j][e] = (keep >> (4 * j + e)) & 1u ? pe : 0.f;
        else s[j][e] = pe;
      }
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    m_lo = mn_lo;
    m_hi = mn_hi;
  };
  const bool interior = c0 + TC_BKV - 1 <= qw && c0 + TC_BKV - 1 < S &&
                        (window <= 0 || c0 + window > qw + 15);
  if (interior) softmax(std::false_type{});
  else softmax(std::true_type{});
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o_);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o_);
  }
  l_lo = l_lo * al_lo + sum_lo;
  l_hi = l_hi * al_hi + sum_hi;
}

// scale an accumulator's rows r_lo (elements 0, 1) and r_hi (2, 3)
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N][4], float al_lo, float al_hi) {
#pragma unroll
  for (int d = 0; d < N; ++d) {
    acc[d][0] *= al_lo;
    acc[d][1] *= al_lo;
    acc[d][2] *= al_hi;
    acc[d][3] *= al_hi;
  }
}

// acc (16 x 16 NHD fp32 fragments) += p V over the tile's first ``groups``
// 16-key groups. p is rounded to bf16 before the product (the reference's
// p.astype(v.dtype)), or with SPLIT carried as two bf16, hi = bf16(p) and
// lo = bf16(p - hi), whose products sum to p V within 2^-16 of |p|. The
// fragments of keys 16 j .. 16 j + 15 are the A fragment; V rows are keys
// with hd contiguous (row stride LD), read transposed by ldmatrix into the B
template <int NHD, int LD, bool SPLIT = false>
__device__ __forceinline__ void tile_pv(float (&acc)[2 * NHD][4],
                                        const float (&p)[TC_BKV / 8][4], const bf16* vt,
                                        int lane, int groups) {
  const int mi = lane >> 3;             // the 8x8 matrix this lane addresses
#pragma unroll
  for (int j = 0; j < TC_BKV / 16; ++j) {
    if (j >= groups) break;
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {       // A regs: (row lo, k lo), (hi, lo), (lo, hi), (hi, hi)
      const float* f = &p[2 * j + (h >> 1)][2 * (h & 1)];
      pa[h] = hopper::pack_bf16(f[0], f[1]);
      if constexpr (SPLIT) {
        pl[h] = hopper::pack_bf16(f[0] - __uint_as_float(pa[h] << 16),
                                  f[1] - __uint_as_float(pa[h] & 0xffff0000u));
      }
    }
#pragma unroll
    for (int d2 = 0; d2 < NHD; ++d2) {
      uint32_t b0, b1, b2, b3;
      hopper::ldsm_x4_trans(b0, b1, b2, b3,
                            vt + (16 * j + 8 * (mi & 1) + (lane & 7)) * LD + 16 * d2 + 8 * (mi >> 1));
      hopper::mma_bf16(acc[2 * d2], pa, b0, b1);
      hopper::mma_bf16(acc[2 * d2 + 1], pa, b2, b3);
      if constexpr (SPLIT) {
        hopper::mma_bf16(acc[2 * d2], pl, b0, b1);
        hopper::mma_bf16(acc[2 * d2 + 1], pl, b2, b3);
      }
    }
  }
}

template <int NHD>
__global__ void __launch_bounds__(32 * TC_WARPS)
swa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H,
              int G, int window, float scale) {
  constexpr int HD = 16 * NHD;
  constexpr int LD = HD + 8;          // padded row: ldmatrix rows hit distinct banks
  constexpr int CH = HD / 8;          // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);      // 2 x TC_BKV x LD
  bf16* vs = ks + 2 * TC_BKV * LD;                    // 2 x TC_BKV x LD
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  // the longest causal walks (the last query blocks) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 16 * nw;
  const int qw = q0 + 16 * warp;      // this warp's first row
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const bf16* qm = q + (size_t)bh * S * HD;
  const bf16* km = k + (size_t)kvh * S * HD;
  const bf16* vm = v + (size_t)kvh * S * HD;
  const float scale2 = scale * 1.4426950408889634f;    // scores in log2 units

  // Q stays in registers as mma A fragments: rows qw + l/4 (+8), columns
  // 16 kk + 2 (l % 4) (+8)
  const int r_lo = qw + (lane >> 2), r_hi = r_lo + 8;
  const int cq = 2 * (lane & 3);
  uint32_t qf[NHD][4];
#pragma unroll
  for (int kk = 0; kk < NHD; ++kk) {
    qf[kk][0] = ld_pair(qm + (size_t)r_lo * HD + 16 * kk + cq, r_lo < S);
    qf[kk][1] = ld_pair(qm + (size_t)r_hi * HD + 16 * kk + cq, r_hi < S);
    qf[kk][2] = ld_pair(qm + (size_t)r_lo * HD + 16 * kk + 8 + cq, r_lo < S);
    qf[kk][3] = ld_pair(qm + (size_t)r_hi * HD + 16 * kk + 8 + cq, r_hi < S);
  }
  float o[2 * NHD][4];
#pragma unroll
  for (int d = 0; d < 2 * NHD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  // the block's rows share one band: from the first row's window start,
  // floored to the key tile, to the last row
  const int q_last = min(q0 + 16 * nw, S) - 1;
  int c_first = 0;
  if (window > 0) c_first = max(0, floor_div(q0 - (window - 1), TC_BKV)) * TC_BKV;
  const int n_tiles = (q_last - c_first) / TC_BKV + 1;

  auto load = [&](int c0, int buf) {
    bf16* kd = ks + buf * TC_BKV * LD;
    bf16* vd = vs + buf * TC_BKV * LD;
    for (int i = threadIdx.x; i < TC_BKV * CH; i += blockDim.x) {
      const int kr = i / CH, c = i % CH;
      const int pos = c0 + kr;
      const bool ok = pos < S;
      hopper::cp_async16(kd + kr * LD + 8 * c, ok ? km + (size_t)pos * HD + 8 * c : km, ok);
      hopper::cp_async16(vd + kr * LD + 8 * c, ok ? vm + (size_t)pos * HD + 8 * c : vm, ok);
    }
  };

  load(c_first, 0);
  hopper::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = c_first + it * TC_BKV;
    if (it + 1 < n_tiles) load(c0 + TC_BKV, (it + 1) & 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * TC_BKV * LD;
    const bf16* vt = vs + (it & 1) * TC_BKV * LD;
    // a tile wholly after this warp's rows or wholly before their band
    // changes nothing (p = 0, alpha = 1): skip its products
    const bool live = qw < S && c0 <= qw + 15 &&
                      (window <= 0 || c0 + TC_BKV - 1 > qw - window);
    if (live) {
      const int mi = lane >> 3;       // the 8x8 matrix this lane addresses
      float s[TC_BKV / 8][4];
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T: K rows are keys with hd contiguous, the col-major B
#pragma unroll
      for (int j2 = 0; j2 < TC_BKV / 16; ++j2) {
#pragma unroll
        for (int kk = 0; kk < NHD; ++kk) {
          uint32_t b0, b1, b2, b3;
          hopper::ldsm_x4(b0, b1, b2, b3,
                          kt + (16 * j2 + 8 * (mi >> 1) + (lane & 7)) * LD + 16 * kk + 8 * (mi & 1));
          hopper::mma_bf16(s[2 * j2], qf[kk], b0, b1);
          hopper::mma_bf16(s[2 * j2 + 1], qf[kk], b2, b3);
        }
      }
      float al_lo, al_hi;
      tile_softmax(s, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi, r_lo, r_hi, qw, c0, S, window,
                   scale2);
      rescale(o, al_lo, al_hi);
      tile_pv<NHD, LD>(o, s, vt, lane, TC_BKV / 16);
    }
    __syncthreads();                  // buffer it & 1 is refilled at it + 2
  }
  hopper::cp_async_wait<0>();

  const float lc_lo = fmaxf(l_lo, 1e-30f), lc_hi = fmaxf(l_hi, 1e-30f);
  bf16* om = out + (size_t)bh * S * HD;
#pragma unroll
  for (int d = 0; d < 2 * NHD; ++d) {
    const int col = 8 * d + cq;
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(om + (size_t)r_lo * HD + col) =
          hopper::pack_bf16(o[d][0] / lc_lo, o[d][1] / lc_lo);
    if (r_hi < S)
      *reinterpret_cast<uint32_t*>(om + (size_t)r_hi * HD + col) =
          hopper::pack_bf16(o[d][2] / lc_hi, o[d][3] / lc_hi);
  }
}

template <int NHD>
int launch_tc_nhd(const void* q, const void* k, const void* v, void* out, int BH,
                  int S, int H, int G, int window, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(16 * NHD);
  static bool attr_set = false;
  if (!attr_set && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_tc_kernel<NHD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nw = tc_warps(S);
  const dim3 grid(BH, (S + 16 * nw - 1) / (16 * nw));
  swa_tc_kernel<NHD><<<grid, 32 * nw, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, H, G, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tangents on tensor cores (hd % 16 == 0). See the note at the top.
// ---------------------------------------------------------------------------

// tangents a warp carries: each holds a 16 x hd fp32 accumulator (hd / 2
// registers a thread) beside the primal's and the tile's p and sd fragments
// (32 + 32), so 4 at hd <= 32, 2 at hd <= 64 and 1 above
__host__ __device__ constexpr int tangents_a_warp(int nhd) { return nhd <= 2 ? 4 : nhd <= 4 ? 2 : 1; }

// shared memory of a tangent block: Q and the block's Qd_t rows, then
// ``nbuf`` buffers of K, V and each tangent's Kd_t, Vd_t (``rows`` keys each)
size_t tc_mt_smem_bytes(int hd, int tw, int nw, int rows, int nbuf) {
  return (size_t)((1 + tw) * 16 * nw + nbuf * (2 + 2 * tw) * rows) * (hd + 8) * sizeof(bf16);
}

// rows [r0, r0 + n) of an (S, 16 NHD) matrix into shared memory at row
// stride LD by 16-byte cp.async, rows past S zero
template <int NHD, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int n, int S) {
  constexpr int CH = 2 * NHD;         // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < S;
    hopper::cp_async16(dst + r * LD + 8 * c, ok ? src + (size_t)(r0 + r) * 16 * NHD + 8 * c : src,
                       ok);
  }
}

// s (16 x TC_BKV fp32 fragments) += A K^T over the tile's first ``groups``
// 16-key groups: A is 16 rows x 16 NHD in shared memory, read by ldmatrix
// into the A fragments; K rows are keys with hd contiguous, the col-major B
template <int NHD, int LD>
__device__ __forceinline__ void tile_scores(float (&s)[TC_BKV / 8][4], const bf16* a,
                                            const bf16* kt, int lane, int groups) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < NHD; ++kk) {
    uint32_t af[4];
    hopper::ldsm_x4(af[0], af[1], af[2], af[3], a + (lane & 15) * LD + 16 * kk + 8 * (lane >> 4));
#pragma unroll
    for (int j2 = 0; j2 < TC_BKV / 16; ++j2) {
      if (j2 >= groups) break;
      uint32_t b0, b1, b2, b3;
      hopper::ldsm_x4(b0, b1, b2, b3,
                      kt + (16 * j2 + 8 * (mi >> 1) + (lane & 7)) * LD + 16 * kk + 8 * (mi & 1));
      hopper::mma_bf16(s[2 * j2], af, b0, b1);
      hopper::mma_bf16(s[2 * j2 + 1], af, b2, b3);
    }
  }
}

template <int NHD>
__global__ void __launch_bounds__(32 * TC_WARPS)
swa_tc_mt_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ qd,
                 const bf16* __restrict__ kd, const bf16* __restrict__ vd,
                 bf16* __restrict__ od, int BH, int S, int H, int G, int T, int window,
                 float scale, int rows) {
  constexpr int HD = 16 * NHD;
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;
  constexpr int TW = tangents_a_warp(NHD);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nw = blockDim.x / 32;
  const int QR = 16 * nw;             // query rows of the block
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // QR x LD
  bf16* qds = qs + QR * LD;                        // TW x QR x LD
  bf16* tiles = qds + TW * QR * LD;                // buffers of (2 + 2 TW) x rows x LD
  const int buf = (2 + 2 * TW) * rows * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  // the longest causal walks (the last query blocks) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;
  const int qw = q0 + 16 * warp;      // this warp's first row
  const int t0 = blockIdx.z * TW;     // the block's tangents t0 .. t0 + nt - 1
  const int nt = min(TW, T - t0);
  const int BKV = BH / G;
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const bf16* km = k + (size_t)kvh * S * HD;
  const bf16* vm = v + (size_t)kvh * S * HD;
  // the (S, hd) matrix of row ``row`` of tangent t in a (T, nrow, S, hd) stack
  auto tangent = [&](const bf16* base, int nrow, int row, int t) {
    return base + ((size_t)t * nrow + row) * S * HD;
  };
  const float scale2 = scale * 1.4426950408889634f;    // scores in log2 units

  stage_rows<NHD, LD>(qs, q + (size_t)bh * S * HD, q0, QR, S);
  for (int u = 0; u < nt; ++u)
    stage_rows<NHD, LD>(qds + u * QR * LD, tangent(qd, BH, bh, t0 + u), q0, QR, S);

  // the block's rows share one band: from the first row's window start,
  // floored to the key tile, to the last row
  const int q_last = min(q0 + QR, S) - 1;
  int c_first = 0;
  if (window > 0) c_first = max(0, floor_div(q0 - (window - 1), TC_BKV)) * TC_BKV;
  const int n_tiles = (q_last - c_first) / TC_BKV + 1;
  auto load = [&](int c0, int b) {
    bf16* t = tiles + b * buf;
    stage_rows<NHD, LD>(t, km, c0, rows, S);
    stage_rows<NHD, LD>(t + rows * LD, vm, c0, rows, S);
    for (int u = 0; u < nt; ++u) {
      stage_rows<NHD, LD>(t + (2 + 2 * u) * rows * LD, tangent(kd, BKV, kvh, t0 + u), c0, rows, S);
      stage_rows<NHD, LD>(t + (3 + 2 * u) * rows * LD, tangent(vd, BKV, kvh, t0 + u), c0, rows, S);
    }
  };

  const int r_lo = qw + (lane >> 2), r_hi = r_lo + 8;
  float o[2 * NHD][4], acc[TW][2 * NHD][4], mu[TW][2];
#pragma unroll
  for (int d = 0; d < 2 * NHD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[d][e] = 0.f;
#pragma unroll
      for (int u = 0; u < TW; ++u) acc[u][d][e] = 0.f;
    }
#pragma unroll
  for (int u = 0; u < TW; ++u) mu[u][0] = mu[u][1] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  const bf16* qrow = qs + 16 * warp * LD;          // this warp's rows

  load(c_first, 0);
  hopper::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = c_first + it * TC_BKV;
    if (it + 1 < n_tiles) load(c0 + TC_BKV, (it + 1) & 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = tiles + (it & 1) * buf;
    const bf16* vt = kt + rows * LD;
    // a tile wholly after this warp's rows or wholly before their band
    // changes nothing (p = 0, alpha = 1): skip it; and within a tile the
    // 16-key groups past S or past the warp's last row
    const bool live = qw < S && c0 <= qw + 15 &&
                      (window <= 0 || c0 + TC_BKV - 1 > qw - window);
    if (live) {
      const int groups = min(TC_BKV, min(S, qw + 16) - c0 + 15) / 16;
      // the primal walk: S = Q K^T, the online softmax, O += bf16(P) V
      float p[TC_BKV / 8][4];
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
      tile_scores<NHD, LD>(p, qrow, kt, lane, groups);
      float al_lo, al_hi;
      tile_softmax(p, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi, r_lo, r_hi, qw, c0, S, window,
                   scale2);
      rescale(o, al_lo, al_hi);
      tile_pv<NHD, LD>(o, p, vt, lane, groups);
      // each tangent: sd = Qd_t K^T + Q Kd_t^T; psd = p sd scale (fp32);
      // mu_t += sum psd; acc_t += psd V (psd as a bf16 pair) + bf16(p) Vd_t
#pragma unroll
      for (int u = 0; u < TW; ++u) {
        if (u >= nt) break;
        const bf16* kdt = kt + (2 + 2 * u) * rows * LD;
        float sd[TC_BKV / 8][4];
#pragma unroll
        for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sd[j][e] = 0.f;
        tile_scores<NHD, LD>(sd, qds + u * QR * LD + 16 * warp * LD, kt, lane, groups);
        tile_scores<NHD, LD>(sd, qrow, kdt, lane, groups);
        float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
        for (int j = 0; j < TC_BKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sd[j][e] = p[j][e] * (sd[j][e] * scale);
          ps_lo += sd[j][0] + sd[j][1];
          ps_hi += sd[j][2] + sd[j][3];
        }
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
          ps_lo += __shfl_xor_sync(0xffffffffu, ps_lo, o_);
          ps_hi += __shfl_xor_sync(0xffffffffu, ps_hi, o_);
        }
        mu[u][0] = mu[u][0] * al_lo + ps_lo;
        mu[u][1] = mu[u][1] * al_hi + ps_hi;
        rescale(acc[u], al_lo, al_hi);
        tile_pv<NHD, LD, true>(acc[u], sd, vt, lane, groups);
        tile_pv<NHD, LD>(acc[u], p, kdt + rows * LD, lane, groups);
      }
    }
    __syncthreads();                  // buffer it & 1 is refilled at it + 2
  }
  hopper::cp_async_wait<0>();
  if (qw >= S) return;

  // finish: outd_t = acc_t / l - (mu_t / l) * out, rounded to bf16 into
  // this warp's rows of the Qd_t staging (read for the last time above),
  // then stored in 16-byte rows
  const float lc_lo = fmaxf(l_lo, 1e-30f), lc_hi = fmaxf(l_hi, 1e-30f);
  const int cq = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < TW; ++u) {
    if (u >= nt) break;
    bf16* st = qds + u * QR * LD + 16 * warp * LD;
    const float ml_lo = mu[u][0] / lc_lo, ml_hi = mu[u][1] / lc_hi;
#pragma unroll
    for (int d = 0; d < 2 * NHD; ++d) {
      const int col = 8 * d + cq;
      *reinterpret_cast<uint32_t*>(st + (lane >> 2) * LD + col) = hopper::pack_bf16(
          acc[u][d][0] / lc_lo - ml_lo * (o[d][0] / lc_lo),
          acc[u][d][1] / lc_lo - ml_lo * (o[d][1] / lc_lo));
      *reinterpret_cast<uint32_t*>(st + ((lane >> 2) + 8) * LD + col) = hopper::pack_bf16(
          acc[u][d][2] / lc_hi - ml_hi * (o[d][2] / lc_hi),
          acc[u][d][3] / lc_hi - ml_hi * (o[d][3] / lc_hi));
    }
    __syncwarp();
    bf16* og = od + ((size_t)(t0 + u) * BH + bh) * S * HD;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      if (qw + r < S)
        *reinterpret_cast<uint4*>(og + (size_t)(qw + r) * HD + 8 * c) =
            *reinterpret_cast<const uint4*>(st + r * LD + 8 * c);
    }
  }
}

template <int NHD>
int launch_tc_mt_nhd(const void* q, const void* k, const void* v, const void* qd,
                     const void* kd, const void* vd, void* od, int BH, int S, int H, int G,
                     int T, int window, float scale, cudaStream_t stream) {
  constexpr int TW = tangents_a_warp(NHD);
  static bool attr_set = false;
  if (!attr_set) {   // the largest plan: four warps, two buffers of 64 keys
    const size_t most = tc_mt_smem_bytes(16 * NHD, TW, TC_WARPS, TC_BKV, 2);
    if (most > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        swa_tc_mt_kernel<NHD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // one tile of the keys rounded up to 16 when S fits one, else two
  // buffers of TC_BKV
  const bool one = S <= TC_BKV;
  const int rows = one ? (S + 15) / 16 * 16 : TC_BKV;
  const int nw = tc_warps(S);
  const size_t smem = tc_mt_smem_bytes(16 * NHD, TW, nw, rows, one ? 1 : 2);
  const dim3 grid(BH, (S + 16 * nw - 1) / (16 * nw), (T + TW - 1) / TW);
  swa_tc_mt_kernel<NHD><<<grid, 32 * nw, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)qd, (const bf16*)kd,
      (const bf16*)vd, (bf16*)od, BH, S, H, G, T, window, scale, rows);
  return (int)cudaGetLastError();
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

// bf16, hd % 16 == 0, 16-byte aligned: the tensor-core primal. window <= 0
// means full causal.
extern "C" int swa_attention_fwd_tc(const void* q, const void* k, const void* v,
                                    void* out, int BH, int S, int hd, int H, int G,
                                    int window, float scale, void* stream) {
  if (bad_args(BH, S, hd, H, G, 1) || hd % 16 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd / 16) {
    case 1: return launch_tc_nhd<1>(q, k, v, out, BH, S, H, G, window, scale, s);
    case 2: return launch_tc_nhd<2>(q, k, v, out, BH, S, H, G, window, scale, s);
    case 3: return launch_tc_nhd<3>(q, k, v, out, BH, S, H, G, window, scale, s);
    case 4: return launch_tc_nhd<4>(q, k, v, out, BH, S, H, G, window, scale, s);
    case 5: return launch_tc_nhd<5>(q, k, v, out, BH, S, H, G, window, scale, s);
    case 6: return launch_tc_nhd<6>(q, k, v, out, BH, S, H, G, window, scale, s);
    case 7: return launch_tc_nhd<7>(q, k, v, out, BH, S, H, G, window, scale, s);
    case 8: return launch_tc_nhd<8>(q, k, v, out, BH, S, H, G, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16, hd % 16 == 0, every operand 16-byte aligned: the tensor-core
// tangent walk. Layout and arguments as swa_attention_mt_tangents.
extern "C" int swa_attention_mt_tangents_tc(const void* q, const void* k, const void* v,
                                            const void* qd, const void* kd, const void* vd,
                                            void* od, int BH, int S, int hd, int H, int G,
                                            int T, int window, float scale, void* stream) {
  if (bad_args(BH, S, hd, H, G, T) || hd % 16 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)qd | (uintptr_t)kd |
       (uintptr_t)vd | (uintptr_t)od) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd / 16) {
    case 1: return launch_tc_mt_nhd<1>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    case 2: return launch_tc_mt_nhd<2>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    case 3: return launch_tc_mt_nhd<3>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    case 4: return launch_tc_mt_nhd<4>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    case 5: return launch_tc_mt_nhd<5>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    case 6: return launch_tc_mt_nhd<6>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    case 7: return launch_tc_mt_nhd<7>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    case 8: return launch_tc_mt_nhd<8>(q, k, v, qd, kd, vd, od, BH, S, H, G, T, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
