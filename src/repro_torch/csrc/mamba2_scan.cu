// Mamba2 state recurrence for Hopper (sm_90a): primal, multi-tangent, and
// the multi-tangent jvp-contraction epilogue; plain C interface.
//
//   h_s  = d_s h_{s-1} + x_s B_s^T                      (h: hd x N per head)
//   y_s  = h_s C_s
//   hd_s = dd_s h_{s-1} + d_s hd_{s-1} + xd_s B_s^T + x_s Bd_s^T   (tangent t)
//   yd_s = hd_s C_s + h_s Cd_s
//
// Replaces the TPU kernels repro/kernels/mamba2_scan/kernel.py::
// mamba2_scan_kernel, mamba2_scan_mt_kernel (emit_primal=False) and
// mamba2_scan_mt_jvps_kernel. See repro_torch/kernels/mamba2_scan/ops.py for
// the design note. Every operand and output is fp32 (the reference's
// ops.py casts all of them to fp32 before its kernels).
//
// Layout (the public one, no transposes): x (B, S, H, hd), bm/cm (B, S, N),
// dec (B, S, H); tangents lead with T: xd (T, B, S, H, hd), bd/cd
// (T, B, S, N), dd (T, B, S, H); y (B, S, H, hd), yd (T, B, S, H, hd);
// gy (B, S, H, hd). A state row is (b, h, i): its (h, i) pair, r = h * hd + i,
// runs over the H * hd rows of batch row b, which are contiguous for a token.
//
// One warp per state row (RW rows a warp, RB = WARPS * RW rows a block, all
// of one batch row b); lane l holds columns l, l + 32, ... of the row (N <=
// 128), so the row's primal state and its TC tangent states live in
// registers and y_s[i] is one warp reduction. A block walks the S tokens in
// chunks of SC: it stages the chunk's B/C (and the TC tangents' Bd/Cd),
// which every row of the batch row shares, and its rows' x, d, xd, dd (and
// gy) in shared memory with coalesced loads, and writes its outputs back
// from shared memory the same way. grid.z walks the tangents in chunks of
// TC; each chunk recomputes the (cheap) primal walk instead of holding more
// tangent state. Each tangent runs the same instruction sequence (explicit
// __fmaf_rn / __fmul_rn, the same shuffle tree) whatever T and TC are, so a
// tangent's output from a T = 8 launch is bit for bit its T = 1 output.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARPS = 8;            // warps a block
constexpr int RW = 2;               // state rows a warp
constexpr int RB = WARPS * RW;      // state rows a block
constexpr int SC = 8;               // tokens a staged chunk
constexpr int N_MAX = 128;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on sm_90

// what a launch computes: the primal y, T tangent outputs, or the T
// contractions <gy, yd_t> with no tangent output
enum Mode { PRIMAL = 0, TANGENTS = 1, JVPS = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;   // the same value in every lane (fp addition commutes)
}

// Shared-memory floats of a block: staged B/C (+ tangents), per-row scalars
// (x, d, xd, dd, gy), staged outputs, and the JVPS block reduction.
size_t smem_floats(int mode, int np, int tc) {
  const size_t tcm = mode == PRIMAL ? 0 : tc;
  const size_t bc = (size_t)SC * np * (2 + 2 * tcm);
  const size_t rows = (size_t)SC * RB * (2 + 2 * tcm + (mode == JVPS));
  const size_t out = (size_t)SC * RB * (mode == PRIMAL ? 1 : mode == TANGENTS ? tcm : 0);
  const size_t red = mode == JVPS ? (size_t)WARPS * tcm : 0;
  return bc + rows + out + red;
}

template <int NJ, int TC, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
mamba2_kernel(const float* __restrict__ x, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ dec,
              const float* __restrict__ xd, const float* __restrict__ bd,
              const float* __restrict__ cd, const float* __restrict__ dd,
              const float* __restrict__ gy, float* __restrict__ out, int B,
              int S, int H, int hd, int N, int T) {
  constexpr int NP = NJ * 32;
  constexpr int TCM = MODE == PRIMAL ? 0 : TC;
  constexpr int TCA = TCM > 0 ? TCM : 1;          // array extent
  extern __shared__ float smem[];
  float* sB = smem;                               // (SC, NP)
  float* sC = sB + SC * NP;                       // (SC, NP)
  float* sBd = sC + SC * NP;                      // (TCM, SC, NP)
  float* sCd = sBd + TCM * SC * NP;               // (TCM, SC, NP)
  float* sX = sCd + TCM * SC * NP;                // (SC, RB)
  float* sDec = sX + SC * RB;                     // (SC, RB)
  float* sXd = sDec + SC * RB;                    // (TCM, SC, RB)
  float* sDd = sXd + TCM * SC * RB;               // (TCM, SC, RB)
  float* sG = sDd + TCM * SC * RB;                // (SC, RB), JVPS only
  float* sOut = sG + (MODE == JVPS ? SC * RB : 0);  // (SC, RB) or (TC, SC, RB)
  float* sRed = sOut + (MODE == PRIMAL ? SC * RB : MODE == TANGENTS ? TC * SC * RB : 0);

  const int HD = H * hd;
  const int r0 = blockIdx.x * RB;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * TC;
  const int nt = MODE == PRIMAL ? 0 : min(TC, T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float h[RW][NJ];
  float sd[RW][TCA][NJ];
  float acc[RW][TCA];
#pragma unroll
  for (int k = 0; k < RW; ++k) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) h[k][j] = 0.f;
#pragma unroll
    for (int t = 0; t < TCA; ++t) {
      acc[k][t] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) sd[k][t][j] = 0.f;
    }
  }

  for (int s0 = 0; s0 < S; s0 += SC) {
    __syncthreads();   // the previous chunk's outputs have left sOut
    for (int e = threadIdx.x; e < SC * NP; e += blockDim.x) {
      const int ss = e / NP, n = e % NP, s = s0 + ss;
      const bool ok = s < S && n < N;
      const size_t g = ((size_t)b * S + s) * N + n;
      sB[e] = ok ? bm[g] : 0.f;
      sC[e] = ok ? cm[g] : 0.f;
    }
    for (int e = threadIdx.x; e < TCM * SC * NP; e += blockDim.x) {
      const int t = e / (SC * NP), ss = (e / NP) % SC, n = e % NP, s = s0 + ss;
      const bool ok = t < nt && s < S && n < N;
      const size_t g = (((size_t)(t0 + t) * B + b) * S + s) * N + n;
      sBd[e] = ok ? bd[g] : 0.f;
      sCd[e] = ok ? cd[g] : 0.f;
    }
    for (int e = threadIdx.x; e < SC * RB; e += blockDim.x) {
      const int ss = e / RB, r = r0 + e % RB, s = s0 + ss;
      const bool ok = s < S && r < HD;
      const size_t g = ((size_t)b * S + s) * HD + r;
      sX[e] = ok ? x[g] : 0.f;
      sDec[e] = ok ? dec[((size_t)b * S + s) * H + r / hd] : 0.f;
      if (MODE == JVPS) sG[e] = ok ? gy[g] : 0.f;
    }
    for (int e = threadIdx.x; e < TCM * SC * RB; e += blockDim.x) {
      const int t = e / (SC * RB), ss = (e / RB) % SC, r = r0 + e % RB, s = s0 + ss;
      const bool ok = t < nt && s < S && r < HD;
      const size_t bs = ((size_t)(t0 + t) * B + b) * S + s;
      sXd[e] = ok ? xd[bs * HD + r] : 0.f;
      sDd[e] = ok ? dd[bs * H + r / hd] : 0.f;
    }
    __syncthreads();

    const int ns = min(SC, S - s0);
    for (int ss = 0; ss < ns; ++ss) {
      float bv[NJ], cv[NJ], hn[RW][NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        bv[j] = sB[ss * NP + lane + 32 * j];
        cv[j] = sC[ss * NP + lane + 32 * j];
      }
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        const int rr = warp * RW + k;
        const float xv = sX[ss * RB + rr], dc = sDec[ss * RB + rr];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          hn[k][j] = __fmaf_rn(dc, h[k][j], __fmul_rn(xv, bv[j]));
        if (MODE == PRIMAL) {
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) p = __fmaf_rn(hn[k][j], cv[j], p);
          p = warp_sum(p);
          if (lane == 0) sOut[ss * RB + rr] = p;
        }
      }
#pragma unroll
      for (int t = 0; t < TCM; ++t) {
        float bdv[NJ], cdv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          bdv[j] = sBd[(t * SC + ss) * NP + lane + 32 * j];
          cdv[j] = sCd[(t * SC + ss) * NP + lane + 32 * j];
        }
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          const int rr = warp * RW + k;
          const float xv = sX[ss * RB + rr], dc = sDec[ss * RB + rr];
          const float xdv = sXd[(t * SC + ss) * RB + rr];
          const float ddv = sDd[(t * SC + ss) * RB + rr];
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            // dd h_{s-1} + d hd_{s-1} + xd B + x Bd, then hd_s C
            const float v = __fmaf_rn(ddv, h[k][j], __fmaf_rn(dc, sd[k][t][j],
                              __fmaf_rn(xdv, bv[j], __fmul_rn(xv, bdv[j]))));
            sd[k][t][j] = v;
            p = __fmaf_rn(v, cv[j], p);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) p = __fmaf_rn(hn[k][j], cdv[j], p);   // + h_s Cd
          p = warp_sum(p);
          if (MODE == TANGENTS) {
            if (lane == 0) sOut[(t * SC + ss) * RB + rr] = p;
          } else {
            acc[k][t] = __fmaf_rn(sG[ss * RB + rr], p, acc[k][t]);   // contract, never store
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RW; ++k)
#pragma unroll
        for (int j = 0; j < NJ; ++j) h[k][j] = hn[k][j];
    }
    __syncthreads();
    if (MODE == PRIMAL) {
      for (int e = threadIdx.x; e < SC * RB; e += blockDim.x) {
        const int s = s0 + e / RB, r = r0 + e % RB;
        if (s < S && r < HD) out[((size_t)b * S + s) * HD + r] = sOut[e];
      }
    } else if (MODE == TANGENTS) {
      for (int e = threadIdx.x; e < TC * SC * RB; e += blockDim.x) {
        const int t = e / (SC * RB), s = s0 + (e / RB) % SC, r = r0 + e % RB;
        if (t < nt && s < S && r < HD)
          out[(((size_t)(t0 + t) * B + b) * S + s) * HD + r] = sOut[e];
      }
    }
  }

  if (MODE == JVPS) {
    // the block's partial of each tangent: its warps' rows in row order,
    // then the warps in warp order (every lane holds the same acc)
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < TCM; ++t) {
        float w = 0.f;
#pragma unroll
        for (int k = 0; k < RW; ++k) w = __fadd_rn(w, acc[k][t]);
        sRed[warp * TCA + t] = w;
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      float v = 0.f;
      for (int w = 0; w < WARPS; ++w) v = __fadd_rn(v, sRed[w * TCA + threadIdx.x]);
      const size_t P = (size_t)gridDim.x * gridDim.y;
      out[(size_t)(t0 + threadIdx.x) * P + (size_t)b * gridDim.x + blockIdx.x] = v;
    }
  }
}

// out[t] = sum over p of parts[t, p], in p order within each lane, then the
// shuffle tree: one warp a tangent, the same order whatever T is.
__global__ void __launch_bounds__(32)
sum_parts_kernel(const float* __restrict__ parts, long long P, float* __restrict__ out) {
  const int t = blockIdx.x;
  float v = 0.f;
  for (long long p = threadIdx.x; p < P; p += 32) v = __fadd_rn(v, parts[t * P + p]);
  v = warp_sum(v);
  if (threadIdx.x == 0) out[t] = v;
}

int tangent_chunk(int T) { return T >= 8 ? 8 : T >= 4 ? 4 : T >= 2 ? 2 : 1; }

template <int NJ, int TC, int MODE>
int launch_t(const float* x, const float* bm, const float* cm, const float* dec,
             const float* xd, const float* bd, const float* cd, const float* dd,
             const float* gy, float* out, int B, int S, int H, int hd, int N,
             int T, cudaStream_t stream) {
  const size_t smem = smem_floats(MODE, NJ * 32, TC) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = mamba2_kernel<NJ, TC, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H * hd + RB - 1) / RB, B, MODE == PRIMAL ? 1 : (T + TC - 1) / TC);
  kern<<<grid, WARPS * 32, smem, stream>>>(x, bm, cm, dec, xd, bd, cd, dd, gy,
                                           out, B, S, H, hd, N, T);
  return (int)cudaGetLastError();
}

template <int NJ, int MODE>
int launch_nj(const float* x, const float* bm, const float* cm, const float* dec,
              const float* xd, const float* bd, const float* cd, const float* dd,
              const float* gy, float* out, int B, int S, int H, int hd, int N,
              int T, cudaStream_t s) {
  if constexpr (MODE == PRIMAL) {
    return launch_t<NJ, 1, MODE>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
  } else {
    switch (tangent_chunk(T)) {
      case 8: return launch_t<NJ, 8, MODE>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
      case 4: return launch_t<NJ, 4, MODE>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
      case 2: return launch_t<NJ, 2, MODE>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
      default: return launch_t<NJ, 1, MODE>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
    }
  }
}

template <int MODE>
int launch(const void* x, const void* bm, const void* cm, const void* dec,
           const void* xd, const void* bd, const void* cd, const void* dd,
           const void* gy, void* out, int B, int S, int H, int hd, int N, int T,
           void* stream) {
  const float *fx = (const float*)x, *fb = (const float*)bm, *fc = (const float*)cm,
              *fd = (const float*)dec, *fxd = (const float*)xd, *fbd = (const float*)bd,
              *fcd = (const float*)cd, *fdd = (const float*)dd, *fg = (const float*)gy;
  float* fo = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((N + 31) / 32) {
    case 1: return launch_nj<1, MODE>(fx, fb, fc, fd, fxd, fbd, fcd, fdd, fg, fo, B, S, H, hd, N, T, s);
    case 2: return launch_nj<2, MODE>(fx, fb, fc, fd, fxd, fbd, fcd, fdd, fg, fo, B, S, H, hd, N, T, s);
    case 3:
    case 4: return launch_nj<4, MODE>(fx, fb, fc, fd, fxd, fbd, fcd, fdd, fg, fo, B, S, H, hd, N, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_args(int B, int S, int H, int hd, int N, int T) {
  return B < 1 || B > 65535 || S < 1 || H < 1 || hd < 1 || N < 1 || N > N_MAX ||
         (long long)H * hd > 2147483647LL - RB || T < 1 ||
         (T + tangent_chunk(T) - 1) / tangent_chunk(T) > 65535;
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches.
extern "C" int mamba2_scan_fwd(const void* x, const void* bm, const void* cm,
                               const void* dec, void* y, int B, int S, int H,
                               int hd, int N, void* stream) {
  if (bad_args(B, S, H, hd, N, 1)) return (int)cudaErrorInvalidValue;
  return launch<PRIMAL>(x, bm, cm, dec, nullptr, nullptr, nullptr, nullptr,
                        nullptr, y, B, S, H, hd, N, 1, stream);
}

extern "C" int mamba2_scan_mt_tangents(const void* x, const void* bm,
                                       const void* cm, const void* dec,
                                       const void* xd, const void* bd,
                                       const void* cd, const void* dd, void* yd,
                                       int B, int S, int H, int hd, int N, int T,
                                       void* stream) {
  if (bad_args(B, S, H, hd, N, T)) return (int)cudaErrorInvalidValue;
  return launch<TANGENTS>(x, bm, cm, dec, xd, bd, cd, dd, nullptr, yd, B, S, H,
                          hd, N, T, stream);
}

// Per-block partials of a contraction launch: parts is fp32 (T, this).
extern "C" long long mamba2_scan_mt_jvps_parts(int B, int H, int hd) {
  return (long long)((H * (long long)hd + RB - 1) / RB) * B;
}

// parts: fp32 scratch (T, mamba2_scan_mt_jvps_parts(B, H, hd)); jvps: fp32 (T,).
extern "C" int mamba2_scan_mt_jvps(const void* x, const void* bm, const void* cm,
                                   const void* dec, const void* xd,
                                   const void* bd, const void* cd,
                                   const void* dd, const void* gy, void* parts,
                                   void* jvps, int B, int S, int H, int hd,
                                   int N, int T, void* stream) {
  if (bad_args(B, S, H, hd, N, T)) return (int)cudaErrorInvalidValue;
  const int err = launch<JVPS>(x, bm, cm, dec, xd, bd, cd, dd, gy, parts, B, S,
                               H, hd, N, T, stream);
  if (err != 0) return err;
  sum_parts_kernel<<<T, 32, 0, (cudaStream_t)stream>>>(
      (const float*)parts, mamba2_scan_mt_jvps_parts(B, H, hd), (float*)jvps);
  return (int)cudaGetLastError();
}
