// Mamba2 state recurrence for Hopper (sm_90a) in its recurrent form: the
// primal and the multi-tangent jvp-contraction epilogue; plain C interface.
//
//   h_s  = d_s h_{s-1} + x_s B_s^T,   y_s = h_s C_s       (h: hd x N per head)
//   hd_s = dd_s h_{s-1} + d_s hd_{s-1} + xd_s B_s^T + x_s Bd_s^T   (tangent t)
//   yd_s = hd_s C_s + h_s Cd_s,   jvps_t = <gy, yd_t>
//
// Replaces the TPU kernels repro/kernels/mamba2_scan/kernel.py::
// mamba2_scan_kernel and, for S > 32, mamba2_scan_mt_jvps_kernel (the
// multi-tangent pass, and the contraction at S <= 32, are in mamba2_ssd.cu,
// in the chunked state-space-dual form). Every operand and output is fp32
// (the reference's ops.py casts all of them to fp32 before its kernels).
//
// The primal (mamba2_primal_kernel) keeps the recurrence because the
// estimator's card-vs-CPU parity needs it: the CPU reference rounds the
// (hd, N) state to fp32 at every token, and a zamba2 round's new PEFT
// follows the primal's rounding pattern, not its accuracy: a primal exact
// in fp64 misses the zamba2 limit that this kernel meets
// (scripts/parity_plain_on_card.py; PERF.md, Findings), and so did the
// chunked form on the H100. So the state rows (b, h, i) and their
// N columns live in registers and the kernel does the reference's
// operations in the reference's order, x B, d h and their sum, each rounded
// to fp32 (the state is bit for bit the reference's on the same inputs),
// one thread a row holding its N columns; the readout y_s = h_s C_s keeps
// eight partial sums (column n in sum n mod 8) and adds them as a CPU's
// 8-wide horizontal sum does (four lanes a row with a shuffle tree ran
// slower on the H100 and moved the zamba2 reading past its limit). A block
// of 128 rows of one batch row stages each 16-token chunk of B and C
// (which every row shares) and its rows' x and decays in shared memory. Bound by
// its operations (5 hd N flops a token and head: 0.34 GFLOP at zamba2's
// shape, 5.0 us at 67 TFLOP/s; its 8.6 MB take 2.6 us).
//
// The recurrent contraction epilogue (mamba2_jvps_kernel, route rec) serves
// S > 32 until the chunked one carries its state across chunks; every
// main-path launch (S = 32) takes mamba2_ssd.cu's. It is bound by operations
// in this form, 11 hd N flops a (b, h, token, tangent) of fp32 FMAs and warp
// reductions.
//
// Layout (the public one, no transposes): x (B, S, H, hd), bm/cm (B, S, N),
// dec (B, S, H); tangents lead with T: xd (T, B, S, H, hd), bd/cd
// (T, B, S, N), dd (T, B, S, H); gy (B, S, H, hd). A state row is (b, h, i):
// its (h, i) pair, r = h * hd + i, runs over the H * hd rows of batch row b,
// which are contiguous for a token.
//
// The contraction epilogue: one warp per state row (RW rows a warp, RB =
// WARPS * RW rows a block, all of one batch row b); lane l holds columns l,
// l + 32, ... of the row (N <=
// 128), so the row's primal state and its TC tangent states live in
// registers and yd_s[i] is one warp reduction. A block walks the S tokens in
// chunks of SC: it stages the chunk's B/C and the TC tangents' Bd/Cd, which
// every row of the batch row shares, and its rows' x, d, xd, dd and gy in
// shared memory with coalesced loads. grid.z walks the tangents in chunks of
// TC; each chunk recomputes the (cheap) primal walk instead of holding more
// tangent state. The contraction writes one fp32 partial per (tangent,
// block) in a fixed order and sum_parts_kernel sums them in a fixed order:
// no atomics. Each tangent runs the same instruction sequence (explicit
// __fmaf_rn / __fmul_rn, the same shuffle tree) whatever T and TC are, so a
// tangent's jvp from a T = 8 launch is bit for bit its T = 1 jvp.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARPS = 8;            // warps a block
constexpr int RW = 2;               // state rows a warp
constexpr int RB = WARPS * RW;      // state rows a block
constexpr int SC = 8;               // tokens a staged chunk
constexpr int N_MAX = 128;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on sm_90

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;   // the same value in every lane (fp addition commutes)
}

// Shared-memory floats of a block: staged B/C and the tangents' Bd/Cd,
// per-row scalars (x, d, xd, dd, gy) and the block reduction.
size_t smem_floats(int np, int tc) {
  const size_t bc = (size_t)SC * np * (2 + 2 * tc);
  const size_t rows = (size_t)SC * RB * (3 + 2 * tc);
  return bc + rows + (size_t)WARPS * tc;
}

template <int NJ, int TC>
__global__ void __launch_bounds__(WARPS * 32)
mamba2_jvps_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ dec,
                   const float* __restrict__ xd, const float* __restrict__ bd,
                   const float* __restrict__ cd, const float* __restrict__ dd,
                   const float* __restrict__ gy, float* __restrict__ out, int B,
                   int S, int H, int hd, int N, int T) {
  constexpr int NP = NJ * 32;
  extern __shared__ float smem[];
  float* sB = smem;                               // (SC, NP)
  float* sC = sB + SC * NP;                       // (SC, NP)
  float* sBd = sC + SC * NP;                      // (TC, SC, NP)
  float* sCd = sBd + TC * SC * NP;                // (TC, SC, NP)
  float* sX = sCd + TC * SC * NP;                 // (SC, RB)
  float* sDec = sX + SC * RB;                     // (SC, RB)
  float* sXd = sDec + SC * RB;                    // (TC, SC, RB)
  float* sDd = sXd + TC * SC * RB;                // (TC, SC, RB)
  float* sG = sDd + TC * SC * RB;                 // (SC, RB)
  float* sRed = sG + SC * RB;                     // (WARPS, TC)

  const int HD = H * hd;
  const int r0 = blockIdx.x * RB;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * TC;
  const int nt = min(TC, T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float h[RW][NJ];
  float sd[RW][TC][NJ];
  float acc[RW][TC];
#pragma unroll
  for (int k = 0; k < RW; ++k) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) h[k][j] = 0.f;
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      acc[k][t] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) sd[k][t][j] = 0.f;
    }
  }

  for (int s0 = 0; s0 < S; s0 += SC) {
    __syncthreads();   // the previous chunk's rows have been read
    for (int e = threadIdx.x; e < SC * NP; e += blockDim.x) {
      const int ss = e / NP, n = e % NP, s = s0 + ss;
      const bool ok = s < S && n < N;
      const size_t g = ((size_t)b * S + s) * N + n;
      sB[e] = ok ? bm[g] : 0.f;
      sC[e] = ok ? cm[g] : 0.f;
    }
    for (int e = threadIdx.x; e < TC * SC * NP; e += blockDim.x) {
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
      sG[e] = ok ? gy[g] : 0.f;
    }
    for (int e = threadIdx.x; e < TC * SC * RB; e += blockDim.x) {
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
      }
#pragma unroll
      for (int t = 0; t < TC; ++t) {
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
          acc[k][t] = __fmaf_rn(sG[ss * RB + rr], p, acc[k][t]);   // contract, never store
        }
      }
#pragma unroll
      for (int k = 0; k < RW; ++k)
#pragma unroll
        for (int j = 0; j < NJ; ++j) h[k][j] = hn[k][j];
    }
  }

  // the block's partial of each tangent: its warps' rows in row order, then
  // the warps in warp order (every lane holds the same acc)
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      float w = 0.f;
#pragma unroll
      for (int k = 0; k < RW; ++k) w = __fadd_rn(w, acc[k][t]);
      sRed[warp * TC + t] = w;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < nt) {
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v = __fadd_rn(v, sRed[w * TC + threadIdx.x]);
    const size_t P = (size_t)gridDim.x * gridDim.y;
    out[(size_t)(t0 + threadIdx.x) * P + (size_t)b * gridDim.x + blockIdx.x] = v;
  }
}

// ---- the primal: one thread a state row -----------------------------------

constexpr int PR = 128;             // state rows a primal block, one a thread
constexpr int PS = 16;              // tokens a staged chunk

template <int NP>
__global__ void __launch_bounds__(PR)
mamba2_primal_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dec,
                     float* __restrict__ y, int S, int H, int hd, int N) {
  __shared__ __align__(16) float sB[PS][NP];
  __shared__ __align__(16) float sC[PS][NP];
  __shared__ float sX[PS][PR];
  __shared__ float sD[PS][PR];
  const int HD = H * hd;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * PR;
  const int r = r0 + threadIdx.x;               // this thread's state row (h, i)
  float h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) h[n] = 0.f;
  for (int s0 = 0; s0 < S; s0 += PS) {
    __syncthreads();   // the previous chunk is read
    for (int e = threadIdx.x; e < PS * NP; e += PR) {
      const int ss = e / NP, n = e % NP, s = s0 + ss;
      const bool ok = s < S && n < N;
      const size_t g = ((size_t)b * S + s) * N + n;
      sB[ss][n] = ok ? bm[g] : 0.f;
      sC[ss][n] = ok ? cm[g] : 0.f;
    }
    for (int e = threadIdx.x; e < PS * PR; e += PR) {
      const int ss = e / PR, rr = r0 + e % PR, s = s0 + ss;
      const bool ok = s < S && rr < HD;
      sX[ss][e % PR] = ok ? x[((size_t)b * S + s) * HD + rr] : 0.f;
      sD[ss][e % PR] = ok ? dec[((size_t)b * S + s) * H + rr / hd] : 0.f;
    }
    __syncthreads();
    const int ns = min(PS, S - s0);
    for (int ss = 0; ss < ns; ++ss) {
      const float xv = sX[ss][threadIdx.x], dv = sD[ss][threadIdx.x];
      float p[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = 0.f;
#pragma unroll
      for (int n4 = 0; n4 < NP / 4; ++n4) {
        const float4 bb = *reinterpret_cast<const float4*>(&sB[ss][4 * n4]);
        const float4 cc = *reinterpret_cast<const float4*>(&sC[ss][4 * n4]);
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = 4 * n4 + k;
          h[n] = __fadd_rn(__fmul_rn(dv, h[n]), __fmul_rn(xv, bv[k]));   // d h + x B
          p[n & 7] = __fmaf_rn(h[n], cv[k], p[n & 7]);
        }
      }
      const float v = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[4]), __fadd_rn(p[2], p[6])),
                                __fadd_rn(__fadd_rn(p[1], p[5]), __fadd_rn(p[3], p[7])));
      if (r < HD) y[((size_t)b * S + s0 + ss) * HD + r] = v;
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

template <int NJ, int TC>
int launch_t(const float* x, const float* bm, const float* cm, const float* dec,
             const float* xd, const float* bd, const float* cd, const float* dd,
             const float* gy, float* out, int B, int S, int H, int hd, int N,
             int T, cudaStream_t stream) {
  const size_t smem = smem_floats(NJ * 32, TC) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = mamba2_jvps_kernel<NJ, TC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H * hd + RB - 1) / RB, B, (T + TC - 1) / TC);
  kern<<<grid, WARPS * 32, smem, stream>>>(x, bm, cm, dec, xd, bd, cd, dd, gy,
                                           out, B, S, H, hd, N, T);
  return (int)cudaGetLastError();
}

template <int NJ>
int launch_nj(const float* x, const float* bm, const float* cm, const float* dec,
              const float* xd, const float* bd, const float* cd, const float* dd,
              const float* gy, float* out, int B, int S, int H, int hd, int N,
              int T, cudaStream_t s) {
  switch (tangent_chunk(T)) {
    case 8: return launch_t<NJ, 8>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
    case 4: return launch_t<NJ, 4>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
    case 2: return launch_t<NJ, 2>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
    default: return launch_t<NJ, 1>(x, bm, cm, dec, xd, bd, cd, dd, gy, out, B, S, H, hd, N, T, s);
  }
}

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
    case 1: return launch_nj<1>(fx, fb, fc, fd, fxd, fbd, fcd, fdd, fg, fo, B, S, H, hd, N, T, s);
    case 2: return launch_nj<2>(fx, fb, fc, fd, fxd, fbd, fcd, fdd, fg, fo, B, S, H, hd, N, T, s);
    case 3:
    case 4: return launch_nj<4>(fx, fb, fc, fd, fxd, fbd, fcd, fdd, fg, fo, B, S, H, hd, N, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_args(int B, int S, int H, int hd, int N, int T) {
  return B < 1 || B > 65535 || S < 1 || H < 1 || hd < 1 || N < 1 || N > N_MAX ||
         (long long)H * hd > 2147483647LL - RB || T < 1 ||
         (T + tangent_chunk(T) - 1) / tangent_chunk(T) > 65535;
}

template <int NP>
int launch_primal(const void* x, const void* bm, const void* cm, const void* dec, void* y,
                  int B, int S, int H, int hd, int N, cudaStream_t stream) {
  const dim3 grid((H * hd + PR - 1) / PR, B);
  mamba2_primal_kernel<NP><<<grid, PR, 0, stream>>>((const float*)x, (const float*)bm,
                                                    (const float*)cm, (const float*)dec,
                                                    (float*)y, S, H, hd, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches.
extern "C" int mamba2_scan_fwd(const void* x, const void* bm, const void* cm,
                               const void* dec, void* y, int B, int S, int H,
                               int hd, int N, void* stream) {
  if (bad_args(B, S, H, hd, N, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 32) return launch_primal<32>(x, bm, cm, dec, y, B, S, H, hd, N, s);
  if (N <= 64) return launch_primal<64>(x, bm, cm, dec, y, B, S, H, hd, N, s);
  return launch_primal<128>(x, bm, cm, dec, y, B, S, H, hd, N, s);
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
  const int err = launch(x, bm, cm, dec, xd, bd, cd, dd, gy, parts, B, S, H, hd, N, T,
                         stream);
  if (err != 0) return err;
  sum_parts_kernel<<<T, 32, 0, (cudaStream_t)stream>>>(
      (const float*)parts, mamba2_scan_mt_jvps_parts(B, H, hd), (float*)jvps);
  return (int)cudaGetLastError();
}
