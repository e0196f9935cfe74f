// RWKV6 WKV recurrence for Hopper (sm_90a): primal, multi-tangent (S > 32),
// and the multi-tangent jvp-contraction epilogue; plain C interface.
//
//   y_t  = r_t^T (S_{t-1} + (u * k_t) v_t^T)           (S: hd x hd per head)
//   S_t  = diag(w_t) S_{t-1} + k_t v_t^T,  S_0 = 0
//   Sd_t = wd_t * S_{t-1} + w_t * Sd_{t-1} + kd_t v_t^T + k_t vd_t^T
//   yd_t = rd_t^T (S_{t-1} + (u * k_t) v_t^T)
//        + r_t^T (Sd_{t-1} + (u * kd_t + ud * k_t) v_t^T + (u * k_t) vd_t^T)
//
// Replaces the TPU kernels repro/kernels/wkv6_scan/kernel.py::
// wkv6_scan_kernel, wkv6_scan_mt_kernel (emit_primal=False; S <= 32 takes
// the chunked kernel in wkv6_chunk.cu) and wkv6_scan_mt_jvps_kernel. See
// repro_torch/kernels/wkv6_scan/ops.py for the design note. Every operand
// and output is fp32 (the reference's ops.py casts all of them to fp32
// before its kernels).
//
// Layout (the public one, no transposes): r, k, v, w, gy (B, S, H, hd),
// u (H, hd); tangents lead with T: rd, kd, vd, wd (T, B, S, H, hd), ud
// (T, H, hd) or null; y (B, S, H, hd), yd (T, B, S, H, hd).
//
// Column j of y_t, S and every Sd reads only column j of the state, so the
// lanes that own column j of one (b, h) row hold its state rows in
// registers.
//
// The primal (wkv6_primal_kernel) keeps the recurrence and its per-token
// fp32 rounding of the state, s = fma(w, s, k v_j), which the card-vs-CPU
// parity readings follow. At rwkv6-1.6b's shape it moves 10.5 MB (3.1 us at
// 3.35 TB/s), and what bounds it is latency: the walk is sequential in S.
// A block takes one (b, h) row, 128 threads at hd = 64: thread (cg, gl)
// holds the R x CL = 8 x 4 state block of rows 8 gl .. 8 gl + 7 and columns
// 4 cg .. 4 cg + 3, so a token's r, k, w rows (16-byte shared loads, each
// row group padded by 4 floats: no bank conflicts) serve four columns and
// the shared-memory traffic stays under the FMA work (one column a thread
// read three times as many floats a flop and was bound by shared memory).
// The block's r, k, w rows and v columns of up to 32 tokens are copied in one
// round of 16-byte cp.async copies, in commit groups of 16 tokens, so the
// walk starts when the first 16 have landed; longer S walk a ring of two
// 32-token chunks, the next loading while one is walked. The readout is
// y_t[j] = r_t . S_{t-1}[:, j] + a_t v_t[j]: the bonus a_t = sum_i r_t u
// k_t is summed once a token (u of the lane's rows in registers), and each
// lane's partials of 8 tokens are summed over the column group's 8 lanes in
// one reduce-scatter of shuffles that leaves each lane one token. y leaves
// through shared memory as coalesced rows.
//
// The recurrent multi-tangent pass (S > 32) and the contraction
// (wkv6_kernel, modes TANGENTS and JVPS): G = 8 lanes own a value column,
// lane g holds rows i = q * G + g (q < R, R = HP / G, HP = hd padded to 16,
// 32 or 64) of the column's primal state and of its TC tangent states. A
// block takes JB = 32 columns of one (b, h) row (256 threads). It walks the
// S tokens in chunks of SC: it stages the chunk's r, k, w and the TC
// tangents' rd, kd, wd, which every column reads, and its columns' v, vd
// (and gy) in shared memory with coalesced loads, and writes its outputs
// back from shared memory the same way. grid.z walks the tangents in chunks
// of TC; each chunk recomputes the (cheap) primal walk instead of holding
// more tangent state. The contraction multiplies each lane's partial by
// gy_t[j] as it goes (no per-token shuffle), then sums the block in a fixed
// order into one partial per (tangent, block), which a second kernel sums
// in a fixed order: no atomics. Each tangent runs the same instruction
// sequence (explicit __fmaf_rn / __fmul_rn / __fadd_rn, the same shuffle
// trees) whatever T and TC are, so a tangent's output from a T = 8 launch is
// bit for bit its T = 1 output.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int G = 8;                // lanes a value column
constexpr int JB = 32;              // value columns a block
constexpr int THREADS = G * JB;     // 256
constexpr int WARPS = THREADS / 32;
constexpr int SC = 8;               // tokens a staged chunk
constexpr int HD_MAX = 64;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on sm_90

// what a launch computes: T tangent outputs, or the T contractions
// <gy, yd_t> with no tangent output
enum Mode { TANGENTS = 1, JVPS = 2 };

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
  const size_t chunk = (size_t)SC * (3 * hp + JB);
  const size_t ud = (size_t)tc * hp;
  const size_t g = mode == JVPS ? (size_t)SC * JB : 0;
  const size_t out = mode == TANGENTS ? (size_t)SC * JB * tc : 0;
  const size_t red = mode == JVPS ? (size_t)WARPS * tc : 0;
  return chunk * (1 + tc) + ud + g + out + red;
}

template <int R, int TC, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ rd,
            const float* __restrict__ kd, const float* __restrict__ vd,
            const float* __restrict__ wd, const float* __restrict__ ud,
            const float* __restrict__ gy, float* __restrict__ out, int B,
            int S, int H, int hd, int T) {
  constexpr int HP = R * G;
  extern __shared__ float smem[];
  float* sR = smem;                               // (SC, HP)
  float* sK = sR + SC * HP;                       // (SC, HP)
  float* sW = sK + SC * HP;                       // (SC, HP)
  float* sV = sW + SC * HP;                       // (SC, JB)
  float* sRd = sV + SC * JB;                      // (TC, SC, HP)
  float* sKd = sRd + TC * SC * HP;               // (TC, SC, HP)
  float* sWd = sKd + TC * SC * HP;               // (TC, SC, HP)
  float* sVd = sWd + TC * SC * HP;               // (TC, SC, JB)
  float* sUd = sVd + TC * SC * JB;               // (TC, HP)
  float* sG = sUd + TC * HP;                     // (SC, JB), JVPS only
  float* sOut = sG + (MODE == JVPS ? SC * JB : 0);  // (TC, SC, JB), TANGENTS only
  float* sRed = sOut + (MODE == TANGENTS ? TC * SC * JB : 0);

  const int ntile = (hd + JB - 1) / JB;
  const int bh = blockIdx.x / ntile, j0 = (blockIdx.x % ntile) * JB;
  const int b = bh / H, h = bh % H;
  const int t0 = blockIdx.z * TC;
  const int nt = min(TC, T - t0);
  const bool has_ud = ud != nullptr;
  const int cl = threadIdx.x / G, g = threadIdx.x % G;   // column in the tile, lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t HH = (size_t)H * hd;                      // one token's stride

  float uu[R], s[R], sd[TC][R], acc[TC];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = q * G + g;
    uu[q] = i < hd ? u[(size_t)h * hd + i] : 0.f;
    s[q] = 0.f;
#pragma unroll
    for (int t = 0; t < TC; ++t) sd[t][q] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < TC; ++t) acc[t] = 0.f;
  for (int e = threadIdx.x; e < TC * HP; e += THREADS) {
    const int t = e / HP, i = e % HP;
    sUd[e] = has_ud && t < nt && i < hd ? ud[((size_t)(t0 + t) * H + h) * hd + i] : 0.f;
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
    for (int e = threadIdx.x; e < TC * SC * HP; e += THREADS) {
      const int t = e / (SC * HP), ss = (e / HP) % SC, i = e % HP, tk = s0 + ss;
      const bool ok = t < nt && tk < S && i < hd;
      const size_t gi = (((size_t)(t0 + t) * B + b) * S + tk) * HH + (size_t)h * hd + i;
      sRd[e] = ok ? rd[gi] : 0.f;
      sKd[e] = ok ? kd[gi] : 0.f;
      sWd[e] = ok ? wd[gi] : 0.f;
    }
    for (int e = threadIdx.x; e < TC * SC * JB; e += THREADS) {
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
#pragma unroll
      for (int t = 0; t < TC; ++t) {
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
    if (MODE == TANGENTS) {
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
    for (int t = 0; t < TC; ++t) {
      const float ws = warp_sum(acc[t]);
      if (lane == 0) sRed[warp * TC + t] = ws;
    }
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      float tot = 0.f;
      for (int wi = 0; wi < WARPS; ++wi) tot = __fadd_rn(tot, sRed[wi * TC + threadIdx.x]);
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
  const dim3 grid((unsigned)n_blocks(a.B, a.H, a.hd), 1, (a.T + TC - 1) / TC);
  kern<<<grid, THREADS, smem, stream>>>(a.r, a.k, a.v, a.w, a.u, a.rd, a.kd, a.vd,
                                        a.wd, a.ud, a.gy, a.out, a.B, a.S, a.H,
                                        a.hd, a.T);
  return (int)cudaGetLastError();
}

template <int R, int MODE>
int launch_r(const Args& a, cudaStream_t s) {
  switch (tangent_chunk(a.T)) {
    case 8:
      // eight tangents' state at hd > 32 in TANGENTS mode pass 255 registers
      // and spill: four a block there (a tangent's output does not depend on
      // its chunk)
      if constexpr (R == 8 && MODE == TANGENTS) return launch_t<R, 4, MODE>(a, s);
      else return launch_t<R, 8, MODE>(a, s);
    case 4: return launch_t<R, 4, MODE>(a, s);
    case 2: return launch_t<R, 2, MODE>(a, s);
    default: return launch_t<R, 1, MODE>(a, s);
  }
}

template <int MODE>
int launch(const Args& a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a.hd <= 16) return launch_r<2, MODE>(a, s);
  if (a.hd <= 32) return launch_r<4, MODE>(a, s);
  return launch_r<8, MODE>(a, s);
}

// ---- the primal: the recurrence, one (b, h) row a block ----------------------

constexpr int PG = 8;     // lanes a column group: PG row groups of R rows
constexpr int PQ = 32;    // tokens a staged chunk
constexpr int PLG = 16;   // tokens a load group: one commit group, one bonus barrier
constexpr int PY = 8;     // tokens whose readout partials are summed together

// Floats of one staged chunk: r, k, w (PQ tokens of PG row groups of R rows,
// each group padded by 4) and v (PQ rows of PG R, padded by 4).
template <int R>
__host__ __device__ constexpr int primal_chunk() {
  return 3 * PQ * PG * (R + 4) + PQ * (PG * R + 4);
}

template <int R>
size_t primal_smem(int S) {
  const int slots = S > PQ ? 2 : 1;
  return ((size_t)slots * primal_chunk<R>() + PQ + (size_t)PQ * (PG * R + 4)) * sizeof(float);
}

// wait until at most n (< 8) of this thread's committed copy groups are in flight
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: hopper::cp_async_wait<0>(); break;
    case 1: hopper::cp_async_wait<1>(); break;
    case 2: hopper::cp_async_wait<2>(); break;
    case 3: hopper::cp_async_wait<3>(); break;
    case 4: hopper::cp_async_wait<4>(); break;
    case 5: hopper::cp_async_wait<5>(); break;
    case 6: hopper::cp_async_wait<6>(); break;
    default: hopper::cp_async_wait<7>(); break;
  }
}

// One halving of a reduce-scatter over the lanes: the lane keeps the lower
// (with ``hi`` the upper) half of ``in`` and adds the partner's copy of it
template <int M>
__device__ __forceinline__ void halve(const float (&in)[M], float (&out)[M / 2], int off,
                                      bool hi) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float got = __shfl_xor_sync(0xffffffffu, hi ? in[i] : in[i + M / 2], off);
    out[i] = __fadd_rn(hi ? in[i + M / 2] : in[i], got);
  }
}

// A block: one (b, h) row, PG HP / CL threads; thread (cg, gl) holds the
// R x CL state block of rows gl R .. and columns cg CL .. (HP = PG R >= hd).
template <int R, int CL>
__global__ void __launch_bounds__(PG * PG * R / CL)
wkv6_primal_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, float* __restrict__ y, int B, int S,
                   int H, int hd, int vec) {
  constexpr int HP = PG * R, PT = PG * HP / CL;
  constexpr int RS = PG * (R + 4);           // a token's r, k, w row
  constexpr int VS = HP + 4;                 // a token's v row
  constexpr int YS = HP + 4;                 // a token's staged y row
  constexpr int CH = primal_chunk<R>();
  static_assert(R % 4 == 0 && CL % 4 == 0 && HP % CL == 0 && PY == PG && PLG % PY == 0 &&
                    PQ % PLG == 0 && (PLG * PG) % PT % 32 == 0 && 2 * PQ / PLG <= 8, "layout");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nch = (S + PQ - 1) / PQ;
  float* sBonus = sm + (nch > 1 ? 2 : 1) * CH;    // (PQ)
  float* sY = sBonus + PQ;                         // (PQ, YS)
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int cg = threadIdx.x / PG, gl = threadIdx.x % PG;   // column group, row group
  const size_t row0 = ((size_t)b * S * H + h) * hd, ts = (size_t)H * hd;

  // chunk ch's r, k, w, v into ring slot ``slot``, one commit group per PLG tokens
  auto stage = [&](int ch, int slot) {
    float* d = sm + slot * CH;
    for (int t0 = 0; t0 < PQ; t0 += PLG) {
      if (vec) {
        for (int e = threadIdx.x; e < PLG * HP / 4; e += PT) {
          const int tl = t0 + e / (HP / 4), i = (e % (HP / 4)) * 4;
          const bool ok = ch * PQ + tl < S && i < hd;
          const size_t gi = ok ? row0 + (ch * PQ + tl) * ts + i : 0;
          const int o = tl * RS + (i / R) * (R + 4) + i % R;
          hopper::cp_async16(d + o, r + gi, ok);
          hopper::cp_async16(d + PQ * RS + o, k + gi, ok);
          hopper::cp_async16(d + 2 * PQ * RS + o, w + gi, ok);
          hopper::cp_async16(d + 3 * PQ * RS + tl * VS + i, v + gi, ok);
        }
      } else {
        for (int e = threadIdx.x; e < PLG * HP; e += PT) {
          const int tl = t0 + e / HP, i = e % HP;
          const bool ok = ch * PQ + tl < S && i < hd;
          const size_t gi = ok ? row0 + (ch * PQ + tl) * ts + i : 0;
          const int o = tl * RS + (i / R) * (R + 4) + i % R;
          hopper::cp_async4(d + o, r + gi, ok);
          hopper::cp_async4(d + PQ * RS + o, k + gi, ok);
          hopper::cp_async4(d + 2 * PQ * RS + o, w + gi, ok);
          hopper::cp_async4(d + 3 * PQ * RS + tl * VS + i, v + gi, ok);
        }
      }
      hopper::cp_async_commit();
    }
  };

  float st[R][CL], uu[R];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < CL; ++c) st[q][c] = 0.f;
  stage(0, 0);
#pragma unroll
  for (int q = 0; q < R; ++q) {   // u of the lane's rows, loaded while the chunk lands
    const int i = gl * R + q;
    uu[q] = i < hd ? u[(size_t)h * hd + i] : 0.f;
  }
  for (int ch = 0; ch < nch; ++ch) {
    const float* d = sm + (ch & 1) * CH;
    const int nq = min(PQ, S - ch * PQ);
    const bool next = ch + 1 < nch;
    if (next) stage(ch + 1, (ch + 1) & 1);   // loads while chunk ch is walked
#pragma unroll 1
    for (int t8 = 0; t8 < nq; t8 += PY) {
      const bool first = t8 % PLG == 0;
      if (first) {
        wait_groups(PQ / PLG - 1 - t8 / PLG + (next ? PQ / PLG : 0));
        __syncthreads();   // tokens t8 .. t8 + PLG - 1 have landed
      }
      // their bonus a_t = sum_i r_t[i] u[i] k_t[i]: PG lanes a token
      for (int e = threadIdx.x; first && e < PLG * PG; e += PT) {
        const int tl = t8 + e / PG, o = tl * RS + gl * (R + 4);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q)
          acc = __fmaf_rn(__fmul_rn(d[o + q], d[PQ * RS + o + q]), uu[q], acc);
#pragma unroll
        for (int m = PG / 2; m > 0; m >>= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
        if (gl == 0) sBonus[tl] = acc;
      }
      float part[PY * CL];   // (token, column) readout partials over the lane's rows
#pragma unroll
      for (int q8 = 0; q8 < PY; ++q8) {
        const int tl = t8 + q8;
        const float* rr = d + tl * RS + gl * (R + 4);
        float vv[CL], ri[R], ki[R], wi[R];
#pragma unroll
        for (int q = 0; q < CL; q += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(d + 3 * PQ * RS + tl * VS + cg * CL + q);
          vv[q] = v4.x; vv[q + 1] = v4.y; vv[q + 2] = v4.z; vv[q + 3] = v4.w;
        }
#pragma unroll
        for (int q = 0; q < R; q += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(rr + q);
          const float4 k4 = *reinterpret_cast<const float4*>(rr + PQ * RS + q);
          const float4 w4 = *reinterpret_cast<const float4*>(rr + 2 * PQ * RS + q);
          ri[q] = r4.x; ri[q + 1] = r4.y; ri[q + 2] = r4.z; ri[q + 3] = r4.w;
          ki[q] = k4.x; ki[q + 1] = k4.y; ki[q + 2] = k4.z; ki[q + 3] = k4.w;
          wi[q] = w4.x; wi[q + 1] = w4.y; wi[q + 2] = w4.z; wi[q + 3] = w4.w;
        }
#pragma unroll
        for (int c = 0; c < CL; ++c) part[q8 * CL + c] = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q) {
#pragma unroll
          for (int c = 0; c < CL; ++c) {
            part[q8 * CL + c] = __fmaf_rn(ri[q], st[q][c], part[q8 * CL + c]);   // r . S_{t-1}[:, j]
            st[q][c] = __fmaf_rn(wi[q], st[q][c], __fmul_rn(ki[q], vv[c]));   // the reference's order
          }
        }
      }
      if (first) __syncthreads();   // the group's bonus is in sBonus
      // the column group's lanes: PY x CL partials -> one token's CL columns a lane
      float h4[PY * CL / 2], h2[PY * CL / 4], h1[PY * CL / 8];
      halve<PY * CL>(part, h4, 4, gl & 4);
      halve<PY * CL / 2>(h4, h2, 2, gl & 2);
      halve<PY * CL / 4>(h2, h1, 1, gl & 1);
      const int tl = t8 + gl;   // the token the halvings left this lane
      const float* vt = d + 3 * PQ * RS + tl * VS + cg * CL;
      float* yt = sY + tl * YS + cg * CL;
#pragma unroll
      for (int c = 0; c < CL; ++c) yt[c] = __fmaf_rn(sBonus[tl], vt[c], h1[c]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < PQ * HP / 4; e += PT) {
      const int tl = e / (HP / 4), i = (e % (HP / 4)) * 4;
      if (tl >= nq || i >= hd) continue;
      float* o = y + row0 + (ch * PQ + tl) * ts + i;
      const float* src = sY + tl * YS + i;
      if (vec) *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(src);
      else
        for (int q = 0; q < 4 && i + q < hd; ++q) o[q] = src[q];
    }
  }
  hopper::cp_async_wait<0>();   // the zero fills of a last, partial chunk
}

template <int R, int CL>
int launch_primal(const float* r, const float* k, const float* v, const float* w,
                  const float* u, float* y, int B, int S, int H, int hd, cudaStream_t st) {
  auto kern = wkv6_primal_kernel<R, CL>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)primal_smem<R>(PQ + 1));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = hd % 4 == 0 && al(r) && al(k) && al(v) && al(w) && al(y);
  kern<<<(unsigned)((long long)B * H), PG * PG * R / CL, primal_smem<R>(S), st>>>(
      r, k, v, w, u, y, B, S, H, hd, vec);
  return (int)cudaGetLastError();
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
  const float *fr = (const float*)r, *fk = (const float*)k, *fv = (const float*)v,
              *fw = (const float*)w, *fu = (const float*)u;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 32) return launch_primal<4, 4>(fr, fk, fv, fw, fu, (float*)y, B, S, H, hd, st);
  return launch_primal<8, 4>(fr, fk, fv, fw, fu, (float*)y, B, S, H, hd, st);
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
