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
// The bf16 primal with hd % 8 == 0 (swa_tc_kernel) runs on tensor cores.
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
// The bf16 tangents with hd % 8 == 0 (swa_tc_mt_kernel) run the same
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
// The bf16 contraction epilogue with hd % 8 == 0 (swa_tc_jvps_kernel) is
// the same walk: the warp's 16 rows of gy are staged beside Q, and at the
// finish outd_t stays in fp32 fragments, is dotted with gy's in fp32 and
// reduced over the warp by shuffles and over the block's warps in warp
// order, one partial a (t, bh, query block); a one-warp kernel sums each
// tangent's partials in a fixed order. Nothing is stored but the partials,
// so at S = 32 the bytes it reads bound it (4.4 MB at roberta-large's T =
// 8). The contraction is held to 1e-6 of sum|terms| against the fp32 plain
// version, and one rounding of p leaves about 2^-9 of each term, ~4x that
// limit over a roberta-large contraction's ~2.6e5 terms: so p too goes in
// as a bf16 (hi, lo) pair, in P V and in p Vd_t (psd already does in psd
// V), which leaves about 2^-16. A tangent's arithmetic and every sum's
// order are the same in any slot of any tangent group, so tangent t of a
// T = 8 launch is bitwise a T = 1 launch.
//
// Head widths. The tensor-core kernels take bf16 with hd a multiple of 8 up
// to 256. A width off the 16 multiple is padded inside the kernels, never in
// device memory: the global row stride stays hd (hd = 120 is 240 bytes, 15
// whole 16-byte chunks, so every row stays on 16 bytes), the cp.async
// chunks past column hd are zero-filled in shared memory, the softmax scale
// stays 1 / sqrt(hd) (the caller's), the stores write only the first hd
// columns, and the contraction's sum over the padding adds exactly 0 (gy is
// zero-filled there, and o and acc_t are exactly zero, V and Vd_t being
// zero-filled). hd <= 128 runs the instantiation of ceil(hd / 16)
// 16-column groups with the plans above, unchanged; 128 < hd <= 256
// (gemma3-12b's 256) pads to the next multiple of 32 and runs a wide plan,
// because the registers (255 a thread) and shared memory (227 KB) of the
// narrow one do not hold it:
// - the primal keeps o (hd / 2 fp32 registers a thread at hd = 256) and the
//   score fragments in registers, but not Q beside them (another hd / 8):
//   Q is staged in shared memory with the first K/V tile and read by
//   ldmatrix per key tile, as the tangent walk reads its Q rows;
// - the tangent walk and the contraction would hold o and one tangent's
//   accumulator, hd fp32 registers a thread together, so each splits the hd
//   columns of its outputs across two blocks (blockIdx.z = tangent group x
//   2 + half): both blocks compute the scores S = Q K^T and Sd_t = Qd_t K^T
//   + Q Kd_t^T over the full hd (so p, psd, l and mu_t are the same in both),
//   and each accumulates o and acc_t over its own half of the columns
//   (hd / 4 registers each, the hd = 128 plan's count) and stages only its
//   half of V, Vd_t and gy. A tangent output column is still computed by one
//   block in one order, so no sum of the tangent outputs changes; the
//   contraction writes one partial a (t, bh, query block, half), and the
//   one-warp sum adds them in that fixed order, so two launches agree and
//   tangent t of a T = 8 launch equals a T = 1 launch bit for bit. The
//   scores are computed twice (1.5x the operations of one walk at hd =
//   256). Q and the tangent group's Qd_t (full width), then per 64-key tile
//   K, Kd_t (full) and V, Vd_t (half) take 183 KB with the contraction's gy,
//   so the wide plan keeps one key buffer, refilled after each tile.
//
// Every other case (fp32, hd off the 8 multiple) is swa_kernel: one warp
// per query row; lanes split hd
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
constexpr int T_MAX = 64;   // simt at hd = 128: one warp a block then needs 132 KB
                            // (at hd = 256 the simt plan holds T <= 48)
constexpr int HD_MAX = 256; // gemma3-12b; widths off 16 pad inside the kernels
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
    case 5: return launch_ni<XT, 5, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    case 6: return launch_ni<XT, 6, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    case 7: return launch_ni<XT, 7, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    case 8: return launch_ni<XT, 8, MODE>(q, k, v, qd, kd, vd, gy, out, BH, S, hd, H, G, T, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 primal on tensor cores (hd % 8 == 0). See the note at the top.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BKV = 64;       // keys a shared-memory tile
constexpr int TC_WARPS = 4;      // most warps (16 query rows each) a block

// warps a block: one per 16 query rows, at most TC_WARPS
int tc_warps(int S) { return S >= 16 * TC_WARPS ? TC_WARPS : (S + 15) / 16; }

// 16-column groups of the tensor-core instantiation a head width hd (a
// multiple of 8) runs: hd rounded up to 16 through 128; above, rounded up
// to 32, so the wide plan's two column halves are whole groups
int tc_nhd(int hd) { return hd <= 128 ? (hd + 15) / 16 : 2 * ((hd + 31) / 32); }

// the primal's shared memory: K and V, two buffers each, and (wide plan)
// the block's Q rows, rows padded by 8
size_t tc_smem_bytes(int nhd, int nw) {
  return (size_t)(4 * TC_BKV + (nhd > 8 ? 16 * nw : 0)) * (16 * nhd + 8) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// rows [r0, r0 + n) of an (S, hd) matrix (row stride hd, a multiple of 8)
// into shared memory at row stride LD by 16-byte cp.async: CH chunks a row
// from column col0; chunks at or past column hd (the padding of a width off
// the instantiation's) and rows past S are zero
template <int CH, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int n, int S,
                                           int hd, int col0 = 0) {
  for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const int col = col0 + 8 * c;
    const bool ok = r0 + r < S && col < hd;
    hopper::cp_async16(dst + r * LD + 8 * c, ok ? src + (size_t)(r0 + r) * hd + col : src,
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
  if constexpr (NHD > 8) {
    // the wide plan walks the depth in unrolled chunks of 4 steps, so its
    // ldmatrix addresses are not all live at once (the products go into s
    // in the same order)
#pragma unroll 1
    for (int k0 = 0; k0 < NHD; k0 += 4) {
#pragma unroll
      for (int kk = k0; kk < k0 + 4; ++kk) {
        uint32_t af[4];
        hopper::ldsm_x4(af[0], af[1], af[2], af[3],
                        a + (lane & 15) * LD + 16 * kk + 8 * (lane >> 4));
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
    return;
  }
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

// PAD: hd (the row stride) is a runtime width up to HD, padded in shared
// memory; without, it is HD itself, and the kernel compiles as for a width
// of the 16 multiple alone
template <int NHD, bool PAD>
__global__ void __launch_bounds__(32 * TC_WARPS)
swa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out, int S, int hd_arg, int H,
              int G, int window, float scale) {
  constexpr int HD = 16 * NHD;        // hd padded to the instantiation's width
  const int hd = PAD ? hd_arg : HD;
  constexpr int LD = HD + 8;          // padded row: ldmatrix rows hit distinct banks
  constexpr int CH = HD / 8;          // 16-byte chunks a row
  constexpr bool QREG = NHD <= 8;     // Q in registers; the wide plan stages it
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);      // 2 x TC_BKV x LD
  bf16* vs = ks + 2 * TC_BKV * LD;                    // 2 x TC_BKV x LD
  bf16* qs = vs + 2 * TC_BKV * LD;                    // 16 nw x LD, wide plan only
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  // the longest causal walks (the last query blocks) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 16 * nw;
  const int qw = q0 + 16 * warp;      // this warp's first row
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const bf16* qm = q + (size_t)bh * S * hd;
  const bf16* km = k + (size_t)kvh * S * hd;
  const bf16* vm = v + (size_t)kvh * S * hd;
  const float scale2 = scale * 1.4426950408889634f;    // scores in log2 units

  // Q as mma A fragments: rows qw + l/4 (+8), columns 16 kk + 2 (l % 4)
  // (+8), zero past S and past hd; kept in registers unless the plan is wide
  const int r_lo = qw + (lane >> 2), r_hi = r_lo + 8;
  const int cq = 2 * (lane & 3);
  uint32_t qf[QREG ? NHD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < NHD; ++kk) {
      const int c0 = 16 * kk + cq, c1 = c0 + 8;
      qf[kk][0] = ld_pair(qm + (size_t)r_lo * hd + c0, r_lo < S && c0 < hd);
      qf[kk][1] = ld_pair(qm + (size_t)r_hi * hd + c0, r_hi < S && c0 < hd);
      qf[kk][2] = ld_pair(qm + (size_t)r_lo * hd + c1, r_lo < S && c1 < hd);
      qf[kk][3] = ld_pair(qm + (size_t)r_hi * hd + c1, r_hi < S && c1 < hd);
    }
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
      const bool ok = pos < S && 8 * c < hd;
      hopper::cp_async16(kd + kr * LD + 8 * c, ok ? km + (size_t)pos * hd + 8 * c : km, ok);
      hopper::cp_async16(vd + kr * LD + 8 * c, ok ? vm + (size_t)pos * hd + 8 * c : vm, ok);
    }
  };

  if constexpr (!QREG) stage_rows<CH, LD>(qs, qm, q0, 16 * nw, S, hd);
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
      float s[TC_BKV / 8][4];
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (QREG) {
        // S = Q K^T: K rows are keys with hd contiguous, the col-major B
        const int mi = lane >> 3;     // the 8x8 matrix this lane addresses
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
      } else {
        tile_scores<NHD, LD>(s, qs + 16 * warp * LD, kt, lane, TC_BKV / 16);
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
  bf16* om = out + (size_t)bh * S * hd;
#pragma unroll
  for (int d = 0; d < 2 * NHD; ++d) {
    const int col = 8 * d + cq;
    if (col >= hd) continue;          // the padding of a width off the instantiation's
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(om + (size_t)r_lo * hd + col) =
          hopper::pack_bf16(o[d][0] / lc_lo, o[d][1] / lc_lo);
    if (r_hi < S)
      *reinterpret_cast<uint32_t*>(om + (size_t)r_hi * hd + col) =
          hopper::pack_bf16(o[d][2] / lc_hi, o[d][3] / lc_hi);
  }
}

template <int NHD, bool PAD>
int launch_tc_nhd(const void* q, const void* k, const void* v, void* out, int BH,
                  int S, int hd, int H, int G, int window, float scale, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {   // the largest plan: four warps
    const size_t most = tc_smem_bytes(NHD, TC_WARPS);
    if (most > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (most > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          swa_tc_kernel<NHD, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      if (e != cudaSuccess) return (int)e;
    }
    attr_set = true;
  }
  const int nw = tc_warps(S);
  const dim3 grid(BH, (S + 16 * nw - 1) / (16 * nw));
  swa_tc_kernel<NHD, PAD><<<grid, 32 * nw, tc_smem_bytes(NHD, nw), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, hd, H, G, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tangents on tensor cores (hd % 8 == 0). See the note at the top.
// ---------------------------------------------------------------------------

// tangents a warp carries: each holds a 16 x (output width) fp32
// accumulator (a quarter of that width in registers a thread) beside the
// primal's and the tile's p and sd fragments (32 + 32), so 4 at widths <=
// 32, 2 at <= 64 and 1 above; ``no`` is the output's 16-column groups
__host__ __device__ constexpr int tangents_a_warp(int no) { return no <= 2 ? 4 : no <= 4 ? 2 : 1; }

// blocks a (b*h, query block, tangent group) splits its output columns
// over: two in the wide plan (hd > 128), else one
__host__ __device__ constexpr int col_split(int nhd) { return nhd > 8 ? 2 : 1; }

// shared memory of a tangent block, rows padded by 8: Q and the block's
// Qd_t rows at the full width (``ld``), the contraction's gy rows at this
// block's output width (``ldo``), then ``nbuf`` buffers of K and each
// tangent's Kd_t (full width) and V and each Vd_t (output width), ``rows``
// keys each
size_t tc_mt_smem_bytes(int ld, int ldo, int tw, int nw, int rows, int nbuf, bool jvps) {
  return ((size_t)(1 + tw) * 16 * nw * ld + (jvps ? (size_t)16 * nw * ldo : 0) +
          (size_t)nbuf * (1 + tw) * rows * (ld + ldo)) * sizeof(bf16);
}

// The tangent walk of one block; JVPS: the contraction epilogue, which
// stages the block's gy rows beside Q, carries p as a bf16 pair in P V and
// p Vd_t (as psd in psd V), and contracts outd_t with gy instead of storing
// it, one partial a (t, bh, query block, column half) in parts (T, BH,
// gridDim.y, col_split). The wide plan (col_split 2) computes every score
// over the full hd and its outputs over its half of the columns.
template <int NHD, bool JVPS, bool PAD>
__device__ __forceinline__ void tc_mt_walk(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                           const bf16* __restrict__ v, const bf16* __restrict__ qd,
                                           const bf16* __restrict__ kd, const bf16* __restrict__ vd,
                                           const bf16* __restrict__ gy, bf16* __restrict__ od,
                                           float* __restrict__ parts, int BH, int S, int hd_arg,
                                           int H, int G, int T, int window, float scale, int rows) {
  constexpr int HD = 16 * NHD;        // hd padded to the instantiation's width
  const int hd = PAD ? hd_arg : HD;   // PAD: as in swa_tc_kernel
  constexpr int NSPLIT = col_split(NHD);
  constexpr int NO = NHD / NSPLIT;    // 16-column groups of this block's outputs
  constexpr int LD = HD + 8;          // Q, Qd_t, K, Kd_t rows
  constexpr int LDO = 16 * NO + 8;    // V, Vd_t and gy rows: this block's columns
  constexpr int CH = HD / 8;
  constexpr int CHO = 2 * NO;
  constexpr int TW = tangents_a_warp(NO);
  constexpr bool DB = NSPLIT == 1;    // two key buffers; the wide plan refills one
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nw = blockDim.x / 32;
  const int QR = 16 * nw;             // query rows of the block
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // QR x LD
  bf16* qds = qs + QR * LD;                        // TW x QR x LD
  bf16* gys = qds + TW * QR * LD;                  // QR x LDO, JVPS only
  bf16* tiles = gys + (JVPS ? QR * LDO : 0);       // buffers of (1 + TW) x rows x (LD + LDO)
  const int buf = (1 + TW) * rows * (LD + LDO);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  // the longest causal walks (the last query blocks) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;
  const int qw = q0 + 16 * warp;      // this warp's first row
  const int half = blockIdx.z % NSPLIT;
  const int col0 = 16 * NO * half;    // this block's first output column
  const int t0 = blockIdx.z / NSPLIT * TW;   // the block's tangents t0 .. t0 + nt - 1
  const int nt = min(TW, T - t0);
  const int BKV = BH / G;
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const bf16* km = k + (size_t)kvh * S * hd;
  const bf16* vm = v + (size_t)kvh * S * hd;
  // the (S, hd) matrix of row ``row`` of tangent t in a (T, nrow, S, hd) stack
  auto tangent = [&](const bf16* base, int nrow, int row, int t) {
    return base + ((size_t)t * nrow + row) * S * hd;
  };
  const float scale2 = scale * 1.4426950408889634f;    // scores in log2 units

  stage_rows<CH, LD>(qs, q + (size_t)bh * S * hd, q0, QR, S, hd);
  for (int u = 0; u < nt; ++u)
    stage_rows<CH, LD>(qds + u * QR * LD, tangent(qd, BH, bh, t0 + u), q0, QR, S, hd);
  if (JVPS) stage_rows<CHO, LDO>(gys, gy + (size_t)bh * S * hd, q0, QR, S, hd, col0);

  // the block's rows share one band: from the first row's window start,
  // floored to the key tile, to the last row
  const int q_last = min(q0 + QR, S) - 1;
  int c_first = 0;
  if (window > 0) c_first = max(0, floor_div(q0 - (window - 1), TC_BKV)) * TC_BKV;
  const int n_tiles = (q_last - c_first) / TC_BKV + 1;
  // buffer b: K, V, then each tangent's Kd_t, Vd_t
  auto load = [&](int c0, int b) {
    bf16* t = tiles + b * buf;
    stage_rows<CH, LD>(t, km, c0, rows, S, hd);
    stage_rows<CHO, LDO>(t + rows * LD, vm, c0, rows, S, hd, col0);
    for (int u = 0; u < nt; ++u) {
      bf16* tu = t + (1 + u) * rows * (LD + LDO);
      stage_rows<CH, LD>(tu, tangent(kd, BKV, kvh, t0 + u), c0, rows, S, hd);
      stage_rows<CHO, LDO>(tu + rows * LD, tangent(vd, BKV, kvh, t0 + u), c0, rows, S, hd,
                           col0);
    }
  };

  const int r_lo = qw + (lane >> 2), r_hi = r_lo + 8;
  float o[2 * NO][4], acc[TW][2 * NO][4], mu[TW][2];
#pragma unroll
  for (int d = 0; d < 2 * NO; ++d)
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
    if constexpr (DB) {
      if (it + 1 < n_tiles) load(c0 + TC_BKV, (it + 1) & 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = tiles + (DB ? it & 1 : 0) * buf;
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
      tile_pv<NO, LDO, JVPS>(o, p, vt, lane, groups);
      // each tangent: sd = Qd_t K^T + Q Kd_t^T; psd = p sd scale (fp32);
      // mu_t += sum psd; acc_t += psd V (psd as a bf16 pair) + bf16(p) Vd_t
      // (p too as a pair under JVPS)
#pragma unroll
      for (int u = 0; u < TW; ++u) {
        if (u >= nt) break;
        const bf16* kdt = kt + (1 + u) * rows * (LD + LDO);
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
        tile_pv<NO, LDO, true>(acc[u], sd, vt, lane, groups);
        tile_pv<NO, LDO, JVPS>(acc[u], p, kdt + rows * LD, lane, groups);
      }
    }
    __syncthreads();                  // a buffer is refilled only after every warp read it
    if constexpr (!DB) {
      if (it + 1 < n_tiles) {
        load(c0 + TC_BKV, 0);
        hopper::cp_async_commit();
      }
    }
  }
  hopper::cp_async_wait<0>();
  const float lc_lo = fmaxf(l_lo, 1e-30f), lc_hi = fmaxf(l_hi, 1e-30f);
  const int cq = 2 * (lane & 3);
  if constexpr (JVPS) {
    // finish: outd_t = acc_t / l - (mu_t / l) * out in fp32 fragments, dotted
    // with this warp's gy rows in a fixed order (gy is zero past S, where
    // outd_t is zero too, and in the padding past hd, where o and acc_t are
    // exactly zero: those products add exactly 0), reduced over the warp by
    // a fixed shuffle tree; the block's warps are summed in warp order. A
    // tangent's arithmetic is the same in any slot of any group, so it does
    // not depend on T.
    __shared__ float red[4][TC_WARPS];
    const bf16* gw = gys + (16 * warp + (lane >> 2)) * LDO + cq;
#pragma unroll
    for (int u = 0; u < TW; ++u) {
      if (u >= nt) break;
      const float ml_lo = mu[u][0] / lc_lo, ml_hi = mu[u][1] / lc_hi;
      float sum = 0.f;
#pragma unroll
      for (int d = 0; d < 2 * NO; ++d) {
        const float2 g_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gw + 8 * d));
        const float2 g_hi =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gw + 8 * LDO + 8 * d));
        sum = fmaf(g_lo.x, acc[u][d][0] / lc_lo - ml_lo * (o[d][0] / lc_lo), sum);
        sum = fmaf(g_lo.y, acc[u][d][1] / lc_lo - ml_lo * (o[d][1] / lc_lo), sum);
        sum = fmaf(g_hi.x, acc[u][d][2] / lc_hi - ml_hi * (o[d][2] / lc_hi), sum);
        sum = fmaf(g_hi.y, acc[u][d][3] / lc_hi - ml_hi * (o[d][3] / lc_hi), sum);
      }
      sum = warp_sum(sum);
      if (lane == 0) red[u][warp] = sum;
    }
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      float sum = red[threadIdx.x][0];
      for (int w = 1; w < nw; ++w) sum += red[threadIdx.x][w];
      parts[(((size_t)(t0 + threadIdx.x) * BH + bh) * gridDim.y + blockIdx.y) * NSPLIT + half] =
          sum;
    }
    return;
  }
  if (qw >= S) return;

  // finish: outd_t = acc_t / l - (mu_t / l) * out, rounded to bf16 into
  // this warp's rows of the Qd_t staging (read for the last time above),
  // then stored in 16-byte rows, the real columns only
  __syncwarp();
#pragma unroll
  for (int u = 0; u < TW; ++u) {
    if (u >= nt) break;
    bf16* st = qds + u * QR * LD + 16 * warp * LD;
    const float ml_lo = mu[u][0] / lc_lo, ml_hi = mu[u][1] / lc_hi;
#pragma unroll
    for (int d = 0; d < 2 * NO; ++d) {
      const int col = 8 * d + cq;
      *reinterpret_cast<uint32_t*>(st + (lane >> 2) * LD + col) = hopper::pack_bf16(
          acc[u][d][0] / lc_lo - ml_lo * (o[d][0] / lc_lo),
          acc[u][d][1] / lc_lo - ml_lo * (o[d][1] / lc_lo));
      *reinterpret_cast<uint32_t*>(st + ((lane >> 2) + 8) * LD + col) = hopper::pack_bf16(
          acc[u][d][2] / lc_hi - ml_hi * (o[d][2] / lc_hi),
          acc[u][d][3] / lc_hi - ml_hi * (o[d][3] / lc_hi));
    }
    __syncwarp();
    bf16* og = od + ((size_t)(t0 + u) * BH + bh) * S * hd;
    for (int i = lane; i < 16 * CHO; i += 32) {
      const int r = i / CHO, c = i % CHO;
      if (qw + r < S && col0 + 8 * c < hd)
        *reinterpret_cast<uint4*>(og + (size_t)(qw + r) * hd + col0 + 8 * c) =
            *reinterpret_cast<const uint4*>(st + r * LD + 8 * c);
    }
  }
}

template <int NHD, bool PAD>
__global__ void __launch_bounds__(32 * TC_WARPS)
swa_tc_mt_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ qd,
                 const bf16* __restrict__ kd, const bf16* __restrict__ vd,
                 bf16* __restrict__ od, int BH, int S, int hd, int H, int G, int T, int window,
                 float scale, int rows) {
  tc_mt_walk<NHD, false, PAD>(q, k, v, qd, kd, vd, nullptr, od, nullptr, BH, S, hd, H, G, T,
                         window, scale, rows);
}

template <int NHD, bool PAD>
__global__ void __launch_bounds__(32 * TC_WARPS)
swa_tc_jvps_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ qd,
                   const bf16* __restrict__ kd, const bf16* __restrict__ vd,
                   const bf16* __restrict__ gy, float* __restrict__ parts, int BH, int S,
                   int hd, int H, int G, int T, int window, float scale, int rows) {
  hopper::grid_launch_dependents();     // the partials' sum may launch; it waits for this grid
  tc_mt_walk<NHD, true, PAD>(q, k, v, qd, kd, vd, gy, nullptr, parts, BH, S, hd, H, G, T, window,
                        scale, rows);
}

// The tangent walk (gy null) or its contraction into ``parts`` (T, BH,
// query blocks, col_split) followed by their fixed-order sum into ``jvps``
// (T).
template <int NHD, bool PAD>
int launch_tc_mt_nhd(const void* q, const void* k, const void* v, const void* qd,
                     const void* kd, const void* vd, const void* gy, void* od, float* parts,
                     int BH, int S, int hd, int H, int G, int T, int window, float scale,
                     cudaStream_t stream) {
  constexpr int NSPLIT = col_split(NHD);
  constexpr int LD = 16 * NHD + 8, LDO = 16 * NHD / NSPLIT + 8;
  constexpr int TW = tangents_a_warp(NHD / NSPLIT);
  constexpr int NBUF = NSPLIT == 1 ? 2 : 1;
  const bool jvps = gy != nullptr;
  static bool attr_set[2] = {false, false};
  if (!attr_set[jvps]) {   // the largest plan: four warps, NBUF buffers of 64 keys
    const size_t most = tc_mt_smem_bytes(LD, LDO, TW, TC_WARPS, TC_BKV, NBUF, jvps);
    if (most > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t e = jvps ? cudaFuncSetAttribute(swa_tc_jvps_kernel<NHD, PAD>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)most)
                         : cudaFuncSetAttribute(swa_tc_mt_kernel<NHD, PAD>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)most);
    if (e != cudaSuccess) return (int)e;
    attr_set[jvps] = true;
  }
  // one tile of the keys rounded up to 16 when S fits one, else NBUF
  // buffers of TC_BKV
  const bool one = S <= TC_BKV;
  const int rows = one ? (S + 15) / 16 * 16 : TC_BKV;
  const int nw = tc_warps(S);
  const size_t smem = tc_mt_smem_bytes(LD, LDO, TW, nw, rows, one ? 1 : NBUF, jvps);
  const dim3 grid(BH, (S + 16 * nw - 1) / (16 * nw), (T + TW - 1) / TW * NSPLIT);
  if (!jvps) {
    swa_tc_mt_kernel<NHD, PAD><<<grid, 32 * nw, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)qd, (const bf16*)kd,
        (const bf16*)vd, (bf16*)od, BH, S, hd, H, G, T, window, scale, rows);
    return (int)cudaGetLastError();
  }
  swa_tc_jvps_kernel<NHD, PAD><<<grid, 32 * nw, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)qd, (const bf16*)kd,
      (const bf16*)vd, (const bf16*)gy, parts, BH, S, hd, H, G, T, window, scale, rows);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return hopper::launch_dependent(hopper::sum_parts_kernel<32>, dim3(T), 32, 0, stream,
                                  (const float*)parts, (float*)od, (int)(BH * grid.y * NSPLIT));
}

// the tensor-core instantiations: NHD 16-column groups; up to 8 with a
// padded (PAD) and an unpadded variant, the wide plan's padded only
#define SWA_TC_CASES(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(10) F(12) F(14) F(16)

template <int NHD>
int launch_tc_mt_pad(const void* q, const void* k, const void* v, const void* qd,
                     const void* kd, const void* vd, const void* gy, void* od, float* parts,
                     int BH, int S, int hd, int H, int G, int T, int window, float scale,
                     cudaStream_t s) {
  if (NHD <= 8 && hd == 16 * NHD)
    return launch_tc_mt_nhd<NHD, NHD <= 8 ? false : true>(q, k, v, qd, kd, vd, gy, od, parts, BH, S, hd, H, G, T, window, scale, s);
  return launch_tc_mt_nhd<NHD, true>(q, k, v, qd, kd, vd, gy, od, parts, BH, S, hd, H, G, T, window, scale, s);
}

int launch_tc_mt(const void* q, const void* k, const void* v, const void* qd, const void* kd,
                 const void* vd, const void* gy, void* od, float* parts, int BH, int S, int hd,
                 int H, int G, int T, int window, float scale, cudaStream_t s) {
  switch (tc_nhd(hd)) {
#define F(N) \
    case N: return launch_tc_mt_pad<N>(q, k, v, qd, kd, vd, gy, od, parts, BH, S, hd, H, G, T, window, scale, s);
    SWA_TC_CASES(F)
#undef F
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

// bf16, hd % 8 == 0, 16-byte aligned: the tensor-core primal. window <= 0
// means full causal.
extern "C" int swa_attention_fwd_tc(const void* q, const void* k, const void* v,
                                    void* out, int BH, int S, int hd, int H, int G,
                                    int window, float scale, void* stream) {
  if (bad_args(BH, S, hd, H, G, 1) || hd % 8 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tc_nhd(hd)) {
#define F(N)                                                                         \
    case N:                                                                          \
      return N <= 8 && hd == 16 * N                                                  \
                 ? launch_tc_nhd<N, N <= 8 ? false : true>(q, k, v, out, BH, S, hd, H, G, \
                                                          window, scale, s)          \
                 : launch_tc_nhd<N, true>(q, k, v, out, BH, S, hd, H, G, window, scale, s);
    SWA_TC_CASES(F)
#undef F
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16, hd % 8 == 0, every operand 16-byte aligned: the tensor-core
// tangent walk. Layout and arguments as swa_attention_mt_tangents.
extern "C" int swa_attention_mt_tangents_tc(const void* q, const void* k, const void* v,
                                            const void* qd, const void* kd, const void* vd,
                                            void* od, int BH, int S, int hd, int H, int G,
                                            int T, int window, float scale, void* stream) {
  if (bad_args(BH, S, hd, H, G, T) || hd % 8 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)qd | (uintptr_t)kd |
       (uintptr_t)vd | (uintptr_t)od) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return launch_tc_mt(q, k, v, qd, kd, vd, nullptr, od, nullptr, BH, S, hd, H, G, T, window,
                      scale, s);
}

// bf16, hd % 8 == 0, every operand 16-byte aligned: the tensor-core
// contraction epilogue. Operands as swa_attention_mt_jvps; ``parts`` is fp32
// scratch of at least 2 * T * BH * ceil(S / 16) partials (one a tangent, b*h,
// query block of 16 rows or more and column half), ``jvps`` the fp32 (T)
// result. Returns cudaGetLastError() after the last launch, or
// the first failure.
extern "C" int swa_attention_mt_jvps_tc(const void* q, const void* k, const void* v,
                                        const void* qd, const void* kd, const void* vd,
                                        const void* gy, void* parts, void* jvps, int BH, int S,
                                        int hd, int H, int G, int T, int window, float scale,
                                        void* stream) {
  if (bad_args(BH, S, hd, H, G, T) || hd % 8 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)qd | (uintptr_t)kd |
       (uintptr_t)vd | (uintptr_t)gy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_tc_mt(q, k, v, qd, kd, vd, gy, jvps, (float*)parts, BH, S, hd, H, G, T,
                      window, scale, (cudaStream_t)stream);
}
