// RWKV6 WKV recurrence for Hopper (sm_90a): primal, multi-tangent, and the
// multi-tangent jvp-contraction epilogue; plain C interface.
//
//   y_t  = r_t^T (S_{t-1} + (u * k_t) v_t^T)           (S: hd x hd per head)
//   S_t  = diag(w_t) S_{t-1} + k_t v_t^T,  S_0 = 0
//   Sd_t = wd_t * S_{t-1} + w_t * Sd_{t-1} + kd_t v_t^T + k_t vd_t^T
//   yd_t = rd_t^T (S_{t-1} + (u * k_t) v_t^T)
//        + r_t^T (Sd_{t-1} + (u * kd_t + ud * k_t) v_t^T + (u * k_t) vd_t^T)
//
// Replaces the TPU kernels repro/kernels/wkv6_scan/kernel.py::
// wkv6_scan_kernel, wkv6_scan_mt_kernel (emit_primal=False) and
// wkv6_scan_mt_jvps_kernel. See repro_torch/kernels/wkv6_scan/ops.py for the
// design note. Every operand and output is fp32 (the reference's ops.py
// casts all of them to fp32 before its kernels).
//
// Layout (the public one, no transposes): r, k, v, w, gy (B, S, H, hd),
// u (H, hd); tangents lead with T: rd, kd, vd, wd (T, B, S, H, hd), ud
// (T, H, hd) or null; y (B, S, H, hd), yd (T, B, S, H, hd).
//
// Column j of y_t, S and every Sd reads only column j of the state, so G = 8
// lanes own one value column j of one (b, h) row: lane g holds rows
// i = q * G + g (q < R, R = HP / G, HP = hd padded to 16, 32 or 64) of the
// column's primal state and of its TC tangent states, in registers, and
// y_t[j] is a 3-step shuffle sum over the 8 lanes. A block takes JB = 32
// columns of one (b, h) row (256 threads). It walks the S tokens in chunks
// of SC: it stages the chunk's r, k, w (and the TC tangents' rd, kd, wd),
// which every column reads, and its columns' v, vd (and gy) in shared
// memory with coalesced loads, and writes its outputs back from shared
// memory the same way. grid.z walks the tangents in chunks of TC; each chunk
// recomputes the (cheap) primal walk instead of holding more tangent state.
// The contraction multiplies each lane's partial by gy_t[j] as it goes (no
// per-token shuffle), then sums the block in a fixed order into one partial
// per (tangent, block), which a second kernel sums in a fixed order: no
// atomics. Each tangent runs the same instruction sequence (explicit
// __fmaf_rn / __fmul_rn / __fadd_rn, the same shuffle trees) whatever T and
// TC are, so a tangent's output from a T = 8 launch is bit for bit its
// T = 1 output.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int G = 8;                // lanes a value column
constexpr int JB = 32;              // value columns a block
constexpr int THREADS = G * JB;     // 256
constexpr int WARPS = THREADS / 32;
constexpr int SC = 8;               // tokens a staged chunk
constexpr int HD_MAX = 64;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on sm_90

// what a launch computes: the primal y, T tangent outputs, or the T
// contractions <gy, yd_t> with no tangent output
enum Mode { PRIMAL = 0, TANGENTS = 1, JVPS = 2 };

// sum over the 8 lanes of a column group; the same value in every lane (fp
// addition commutes, so both partners of each exchange add the same pair)
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory floats of a block: staged r/k/w rows and v columns (+ the
// tangents'), ud, gy, staged outputs, and the JVPS block reduction.
size_t smem_floats(int mode, int hp, int tc) {
  const size_t tcm = mode == PRIMAL ? 0 : tc;
  const size_t chunk = (size_t)SC * (3 * hp + JB);
  const size_t ud = tcm * hp;
  const size_t g = mode == JVPS ? (size_t)SC * JB : 0;
  const size_t out = (size_t)SC * JB * (mode == PRIMAL ? 1 : mode == TANGENTS ? tcm : 0);
  const size_t red = mode == JVPS ? (size_t)WARPS * tcm : 0;
  return chunk * (1 + tcm) + ud + g + out + red;
}

template <int R, int TC, int MODE>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ rd,
            const float* __restrict__ kd, const float* __restrict__ vd,
            const float* __restrict__ wd, const float* __restrict__ ud,
            const float* __restrict__ gy, float* __restrict__ out, int B,
            int S, int H, int hd, int T) {
  constexpr int HP = R * G;
  constexpr int TCM = MODE == PRIMAL ? 0 : TC;
  constexpr int TCA = TCM > 0 ? TCM : 1;          // array extent
  extern __shared__ float smem[];
  float* sR = smem;                               // (SC, HP)
  float* sK = sR + SC * HP;                       // (SC, HP)
  float* sW = sK + SC * HP;                       // (SC, HP)
  float* sV = sW + SC * HP;                       // (SC, JB)
  float* sRd = sV + SC * JB;                      // (TCM, SC, HP)
  float* sKd = sRd + TCM * SC * HP;               // (TCM, SC, HP)
  float* sWd = sKd + TCM * SC * HP;               // (TCM, SC, HP)
  float* sVd = sWd + TCM * SC * HP;               // (TCM, SC, JB)
  float* sUd = sVd + TCM * SC * JB;               // (TCM, HP)
  float* sG = sUd + TCM * HP;                     // (SC, JB), JVPS only
  float* sOut = sG + (MODE == JVPS ? SC * JB : 0);  // (SC, JB) or (TC, SC, JB)
  float* sRed = sOut + (MODE == PRIMAL ? SC * JB : MODE == TANGENTS ? TC * SC * JB : 0);

  const int ntile = (hd + JB - 1) / JB;
  const int bh = blockIdx.x / ntile, j0 = (blockIdx.x % ntile) * JB;
  const int b = bh / H, h = bh % H;
  const int t0 = blockIdx.z * TC;
  const int nt = MODE == PRIMAL ? 0 : min(TC, T - t0);
  const bool has_ud = MODE != PRIMAL && ud != nullptr;
  const int cl = threadIdx.x / G, g = threadIdx.x % G;   // column in the tile, lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t HH = (size_t)H * hd;                      // one token's stride

  float uu[R], s[R], sd[TCA][R], acc[TCA];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = q * G + g;
    uu[q] = i < hd ? u[(size_t)h * hd + i] : 0.f;
    s[q] = 0.f;
#pragma unroll
    for (int t = 0; t < TCA; ++t) sd[t][q] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < TCA; ++t) acc[t] = 0.f;
  if (MODE != PRIMAL) {
    for (int e = threadIdx.x; e < TCM * HP; e += THREADS) {
      const int t = e / HP, i = e % HP;
      sUd[e] = has_ud && t < nt && i < hd ? ud[((size_t)(t0 + t) * H + h) * hd + i] : 0.f;
    }
  }

  for (int s0 = 0; s0 < S; s0 += SC) {
    __syncthreads();   // the previous chunk's outputs have left sOut
    for (int e = threadIdx.x; e < SC * HP; e += THREADS) {
      const int ss = e / HP, i = e % HP, tk = s0 + ss;
      const bool ok = tk < S && i < hd;
      const size_t gi = ((size_t)b * S + tk) * HH + (size_t)h * hd + i;
      sR[e] = ok ? r[gi] : 0.f;
      sK[e] = ok ? k[gi] : 0.f;
      sW[e] = ok ? w[gi] : 0.f;
    }
    for (int e = threadIdx.x; e < SC * JB; e += THREADS) {
      const int ss = e / JB, j = j0 + e % JB, tk = s0 + ss;
      const bool ok = tk < S && j < hd;
      const size_t gi = ((size_t)b * S + tk) * HH + (size_t)h * hd + j;
      sV[e] = ok ? v[gi] : 0.f;
      if (MODE == JVPS) sG[e] = ok ? gy[gi] : 0.f;
    }
    for (int e = threadIdx.x; e < TCM * SC * HP; e += THREADS) {
      const int t = e / (SC * HP), ss = (e / HP) % SC, i = e % HP, tk = s0 + ss;
      const bool ok = t < nt && tk < S && i < hd;
      const size_t gi = (((size_t)(t0 + t) * B + b) * S + tk) * HH + (size_t)h * hd + i;
      sRd[e] = ok ? rd[gi] : 0.f;
      sKd[e] = ok ? kd[gi] : 0.f;
      sWd[e] = ok ? wd[gi] : 0.f;
    }
    for (int e = threadIdx.x; e < TCM * SC * JB; e += THREADS) {
      const int t = e / (SC * JB), ss = (e / JB) % SC, j = j0 + e % JB, tk = s0 + ss;
      const bool ok = t < nt && tk < S && j < hd;
      const size_t gi = (((size_t)(t0 + t) * B + b) * S + tk) * HH + (size_t)h * hd + j;
      sVd[e] = ok ? vd[gi] : 0.f;
    }
    __syncthreads();

    const int ns = min(SC, S - s0);
    for (int ss = 0; ss < ns; ++ss) {
      const float vj = sV[ss * JB + cl];
      float rr[R], ww[R], kk[R], kv[R], su[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = q * G + g;
        rr[q] = sR[ss * HP + i];
        kk[q] = sK[ss * HP + i];
        ww[q] = sW[ss * HP + i];
        kv[q] = __fmul_rn(kk[q], vj);                  // (k v^T)[i, j]
        su[q] = __fmaf_rn(uu[q], kv[q], s[q]);         // (S + u k v^T)[i, j]
      }
      if (MODE == PRIMAL) {
        float p = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q) p = __fmaf_rn(rr[q], su[q], p);
        p = group_sum(p);
        if (g == 0) sOut[ss * JB + cl] = p;
      }
#pragma unroll
      for (int t = 0; t < TCM; ++t) {
        const float vdj = sVd[(t * SC + ss) * JB + cl];
        float p = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = q * G + g;
          const int o = (t * SC + ss) * HP + i;
          // kd v^T + k vd^T, the bonus u (.) that (+ ud (.) k v^T), then
          // r (Sd + bonus) + rd (S + u k v^T), and the tangent state update
          const float kvd = __fmaf_rn(sKd[o], vj, __fmul_rn(kk[q], vdj));
          const float ubon = __fmul_rn(uu[q], kvd);
          const float bonus = has_ud ? __fmaf_rn(sUd[t * HP + i], kv[q], ubon) : ubon;
          p = __fmaf_rn(rr[q], __fadd_rn(sd[t][q], bonus), p);
          p = __fmaf_rn(sRd[o], su[q], p);
          sd[t][q] = __fmaf_rn(sWd[o], s[q], __fmaf_rn(ww[q], sd[t][q], kvd));
        }
        if (MODE == TANGENTS) {
          p = group_sum(p);
          if (g == 0) sOut[(t * SC + ss) * JB + cl] = p;
        } else {
          acc[t] = __fmaf_rn(sG[ss * JB + cl], p, acc[t]);   // contract, never store
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) s[q] = __fmaf_rn(ww[q], s[q], kv[q]);
    }
    __syncthreads();
    if (MODE == PRIMAL) {
      for (int e = threadIdx.x; e < SC * JB; e += THREADS) {
        const int tk = s0 + e / JB, j = j0 + e % JB;
        if (tk < S && j < hd) out[((size_t)b * S + tk) * HH + (size_t)h * hd + j] = sOut[e];
      }
    } else if (MODE == TANGENTS) {
      for (int e = threadIdx.x; e < TC * SC * JB; e += THREADS) {
        const int t = e / (SC * JB), tk = s0 + (e / JB) % SC, j = j0 + e % JB;
        if (t < nt && tk < S && j < hd)
          out[(((size_t)(t0 + t) * B + b) * S + tk) * HH + (size_t)h * hd + j] = sOut[e];
      }
    }
  }

  if (MODE == JVPS) {
    // the block's partial of each tangent: a shuffle tree over each warp's
    // lanes, then the warps in warp order
#pragma unroll
    for (int t = 0; t < TCM; ++t) {
      const float ws = warp_sum(acc[t]);
      if (lane == 0) sRed[warp * TCA + t] = ws;
    }
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      float tot = 0.f;
      for (int wi = 0; wi < WARPS; ++wi) tot = __fadd_rn(tot, sRed[wi * TCA + threadIdx.x]);
      out[(size_t)(t0 + threadIdx.x) * gridDim.x + blockIdx.x] = tot;
    }
  }
}

// out[t] = sum over p of parts[t, p], in p order within each lane, then the
// shuffle tree: one warp a tangent, the same order whatever T is.
__global__ void __launch_bounds__(32)
sum_parts_kernel(const float* __restrict__ parts, long long P, float* __restrict__ out) {
  const int t = blockIdx.x;
  float acc = 0.f;
  for (long long p = threadIdx.x; p < P; p += 32) acc = __fadd_rn(acc, parts[t * P + p]);
  acc = warp_sum(acc);
  if (threadIdx.x == 0) out[t] = acc;
}

int tangent_chunk(int T) { return T >= 8 ? 8 : T >= 4 ? 4 : T >= 2 ? 2 : 1; }

long long n_blocks(int B, int H, int hd) {
  return (long long)B * H * ((hd + JB - 1) / JB);
}

struct Args {
  const float *r, *k, *v, *w, *u, *rd, *kd, *vd, *wd, *ud, *gy;
  float* out;
  int B, S, H, hd, T;
};

template <int R, int TC, int MODE>
int launch_t(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(MODE, R * G, TC) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = wkv6_kernel<R, TC, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)n_blocks(a.B, a.H, a.hd), 1,
                  MODE == PRIMAL ? 1 : (a.T + TC - 1) / TC);
  kern<<<grid, THREADS, smem, stream>>>(a.r, a.k, a.v, a.w, a.u, a.rd, a.kd, a.vd,
                                        a.wd, a.ud, a.gy, a.out, a.B, a.S, a.H,
                                        a.hd, a.T);
  return (int)cudaGetLastError();
}

template <int R, int MODE>
int launch_r(const Args& a, cudaStream_t s) {
  if constexpr (MODE == PRIMAL) {
    return launch_t<R, 1, MODE>(a, s);
  } else {
    switch (tangent_chunk(a.T)) {
      case 8: return launch_t<R, 8, MODE>(a, s);
      case 4: return launch_t<R, 4, MODE>(a, s);
      case 2: return launch_t<R, 2, MODE>(a, s);
      default: return launch_t<R, 1, MODE>(a, s);
    }
  }
}

template <int MODE>
int launch(const Args& a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a.hd <= 16) return launch_r<2, MODE>(a, s);
  if (a.hd <= 32) return launch_r<4, MODE>(a, s);
  return launch_r<8, MODE>(a, s);
}

bool bad_args(int B, int S, int H, int hd, int T) {
  return B < 1 || S < 1 || H < 1 || hd < 1 || hd > HD_MAX || T < 1 ||
         n_blocks(B, H, hd) > 2147483647LL ||
         (T + tangent_chunk(T) - 1) / tangent_chunk(T) > 65535;
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches.
extern "C" int wkv6_scan_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, void* y, int B,
                             int S, int H, int hd, void* stream) {
  if (bad_args(B, S, H, hd, 1)) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)r, (const float*)k, (const float*)v, (const float*)w,
               (const float*)u, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, (float*)y, B, S, H, hd, 1};
  return launch<PRIMAL>(a, stream);
}

// ud may be null (u carries no tangent).
extern "C" int wkv6_scan_mt_tangents(const void* r, const void* k, const void* v,
                                     const void* w, const void* u, const void* rd,
                                     const void* kd, const void* vd,
                                     const void* wd, const void* ud, void* yd,
                                     int B, int S, int H, int hd, int T,
                                     void* stream) {
  if (bad_args(B, S, H, hd, T)) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)r, (const float*)k, (const float*)v, (const float*)w,
               (const float*)u, (const float*)rd, (const float*)kd, (const float*)vd,
               (const float*)wd, (const float*)ud, nullptr, (float*)yd, B, S, H,
               hd, T};
  return launch<TANGENTS>(a, stream);
}

// Per-block partials of a contraction launch: parts is fp32 (T, this).
extern "C" long long wkv6_scan_mt_jvps_parts(int B, int H, int hd) {
  return n_blocks(B, H, hd);
}

// parts: fp32 scratch (T, wkv6_scan_mt_jvps_parts(B, H, hd)); jvps: fp32 (T,).
extern "C" int wkv6_scan_mt_jvps(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* rd,
                                 const void* kd, const void* vd, const void* wd,
                                 const void* ud, const void* gy, void* parts,
                                 void* jvps, int B, int S, int H, int hd, int T,
                                 void* stream) {
  if (bad_args(B, S, H, hd, T)) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)r, (const float*)k, (const float*)v, (const float*)w,
               (const float*)u, (const float*)rd, (const float*)kd, (const float*)vd,
               (const float*)wd, (const float*)ud, (const float*)gy, (float*)parts,
               B, S, H, hd, T};
  const int err = launch<JVPS>(a, stream);
  if (err != 0) return err;
  sum_parts_kernel<<<T, 32, 0, (cudaStream_t)stream>>>(
      (const float*)parts, n_blocks(B, H, hd), (float*)jvps);
  return (int)cudaGetLastError();
}
