// RWKV6 WKV recurrence for Hopper (sm_90a): the multi-tangent pass and its
// contraction epilogue for S <= 32 in the chunked form, their sums over
// channels and their token products in fp64 on the fp64 tensor cores; plain
// C interface.
//
// Per head, tokens s, s' < Q = 32 and channel c (the recurrence from a fresh
// state, S_t = diag(w_t) S_{t-1} + k_t v_t^T, y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)):
//   L_c[s][s'] = w_{s-1}[c] ... w_{s'+1}[c]   (s' < s; running products in the
//                                              recurrence's order, L_c[s'+1][s'] = 1)
//   A[s][s']   = sum_c r_s[c] k_s'[c] L_c[s][s'],   A[s][s] = a_s = sum_c r_s[c] u[c] k_s[c]
//   y          = A v
// and per tangent, by the product rule (no logs, ratios or division):
//   Ld_c[s+1][s'] = w_s Ld_c[s][s'] + wd_s L_c[s][s']
//   Ad[s][s']  = sum_c (rd_s k_s' L + r_s kd_s' L + r_s k_s' Ld),
//   Ad[s][s]   = sum_c (u (rd_s k_s + r_s kd_s) + ud r_s k_s)
//   yd         = Ad v + A vd
//
// Replaces the TPU kernels repro/kernels/wkv6_scan/kernel.py::
// wkv6_scan_mt_kernel (emit_primal=False) and wkv6_scan_mt_jvps_kernel for
// S <= 32, every launch of the training path; longer S take the recurrent
// kernels in wkv6_scan.cu. Every operand and output is fp32 (the reference's
// ops.py casts them all). Layout (the public one, no transposes): r, k, v, w,
// gy (B, S, H, hd), u (H, hd); tangents lead with T: rd, kd, vd, wd (T, B, S,
// H, hd), ud (T, H, hd) or null; yd (T, B, S, H, hd).
//
// What bounds it on the H100: bytes, in this form. At rwkv6-1.6b's shape
// (B=8, S=32, H=32, hd=64, T=8) it must move 92 MB (the T tangent inputs
// and outputs: 27.5 us at 3.35 TB/s) and needs 0.98 GFLOP against 3.09 in the
// recurrent one (chip_smoke.py's wkv6_flops). The decay is per channel, so A
// is a (Q, Q, hd) contraction, not a matrix product. The design splits it:
//
// - Pairs inside a sub-chunk of C = 8 tokens: warp (half, sub) walks
//   sub-chunk sub for channel 32 half + lane, rows s down the sub-chunk with
//   the running L (and Ld) of every column s' in registers. Each term is
//   formed in fp32 and converted to fp64; the 36 values (28 pairs, 8
//   diagonal entries) are summed over the warp's lanes in one reduce-scatter
//   of fp64 shuffles (5 halvings, 37 exchanges) and the two halves' sums
//   added in a fixed order.
// - Pairs across sub-chunks: with e the last token of sub-chunk j < sub(s),
//   L_c[s][s'] = L_c[s][e] L_c[e+1][s'], two running products that are both
//   at most 1 (no ratio of products, so nothing divides by an underflowed
//   product). So the block of rows s > e and columns s' in sub-chunk j is
//   Rj K^T with Rj[s][c] = r_s L_c[s][e] and K[s'][c] = k_s' L_c[e+1][s']
//   (the sub-chunk's walk carries L one token past its end for it, and
//   stores K in fp64), and its tangent Rdj K^T + Rj Kd^T with Rdj = rd L + r
//   Ld and Kd = kd L + k Ld: matrix products over c on DMMA
//   (mma.sync.m16n8k8.f64; fp32 operands are exact in fp64, the sums round
//   to nearest; TF32 / 3xTF32 rounds its sums toward zero, which missed the
//   mamba2 card-vs-CPU limits). The warps of sub-chunks 1-3 then walk
//   L_c[s][e] down the chunk for the three boundaries e.
// - yd = Ad v + A vd on DMMA too: A and Ad stay in shared memory in fp64
//   (their upper triangles zero), one warp an 8-column slice of hd.
//
// A block takes one (b, h) row and a chunk of its tangents (grid.z splits the
// tangents only as far as the SMs need), 8 warps and 219 KB of shared memory
// (one block an SM). A and its K and Rj tiles are built once a block; r, k,
// v, w are staged once with 16-byte cp.async copies (4-byte ones where a row
// is not 16-byte aligned) and each tangent's rd, kd, vd, wd go through a ring
// of three stages, so tangents t+1 and t+2 load while t computes; yd leaves
// through shared memory as 16-byte rows. Every tangent runs the same
// instruction sequence whatever T and the tangent chunk are, and nothing is
// summed across blocks (no atomics), so a tangent's output from a T = 8
// launch is bit for bit its T = 1 output. Any B, H; S <= 32, hd <= 64;
// ragged edges read as zero and are not stored.
//
// The contraction epilogue (template JVPS) is the same walk with a
// contraction finish where the tangent pass forms y = Ad v + A vd and stores
// it: each output warp loads the 8 gy values at its accumulators' positions
// into registers once a block (no shared memory: the block already holds 219
// KB and a staged gy tile would not fit), and per tangent rounds each y to
// fp32 (bitwise the yd the tangent pass stores), multiplies it by its gy in
// fp64 (exact), sums the products in a fixed order, the warp by a fixed
// shuffle tree and the warps in warp order into one fp64 partial per
// (tangent, (b, h) block); sum_parts_f64_kernel adds the partials in a
// fixed order and rounds once to fp32. No yd leaves the block and no
// atomics are used: at rwkv6-1.6b's shape the launch moves 77.6 MB instead
// of 92 (23.2 us at 3.35 TB/s), and a tangent's jvp from a T = 8 launch is
// bit for bit its T = 1 jvp. What the store cost the tangent pass is little
// (its 16-byte stores overlap the next tangent), so the epilogue reads about
// the tangent pass's time plus the partials' sum, a dependent launch. (On
// the H100, summing the thread partials on one warp with slack, after the
// tangent's last barrier or during the next tangent's cross blocks, and
// deferring the shuffle tree into the next tangent's walk read no faster.)
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::FragB;
using hopper::load_a;
using hopper::load_b;
using hopper::load_bt;
using hopper::mma;

constexpr int Q = 32;                  // tokens a chunk: the route serves S <= Q
constexpr int C = 8;                   // tokens a sub-chunk: one warp walks its pairs
constexpr int NSUB = Q / C;
constexpr int NB = NSUB - 1;           // sub-chunk boundaries
constexpr int HD = 64;                 // channels, zero-padded
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int XS = HD + 4;             // row stride of the (Q, HD) tiles: A / B^T fragments
constexpr int VS = HD + 8;             // row stride of v, vd: B fragments (k = token)
constexpr int MS = Q + 4;              // row stride of the fp64 (Q, Q) tiles A, Ad
constexpr int NPAIR = C * (C - 1) / 2; // pairs s' < s inside a sub-chunk
constexpr int NVAL = NPAIR + C;        // and its diagonal
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block on sm_90

static_assert(2 * NSUB == WARPS && 2 * NB <= WARPS && Q == 32 && HD == 64,
              "the warp roles below");

// A tile set (floats): r, k, w (Q, XS); v (Q, VS); u (HD). The primal set, then
// STAGES stages of the tangents' rd, kd, wd, vd, ud.
constexpr int R_OFF = 0, K_OFF = Q * XS, W_OFF = 2 * Q * XS, V_OFF = 3 * Q * XS;
constexpr int U_OFF = V_OFF + Q * VS;
constexpr int SET = U_OFF + HD;
// Boundary j's R tile holds rows rb(j) .. Q - 1 (whole 16-row m-tiles; the rows
// up to the boundary stay zero).
__host__ __device__ constexpr int rb(int j) { return (C * (j + 1) / 16) * 16; }
__host__ __device__ constexpr int roff(int j) { return j == 0 ? 0 : roff(j - 1) + (Q - rb(j - 1)) * XS; }
constexpr int RH = roff(NB);
constexpr int STAGES = 3;              // tangent t + 2 loads while t computes
constexpr int KROWS = Q - C;           // K's rows: the sub-chunks above a boundary
constexpr int A_OFF = (1 + STAGES) * SET;    // fp64 A, Ad (Q, MS) each
constexpr int KH_OFF = A_OFF + 4 * Q * MS;   // fp64 K, Kd (KROWS, XS) each
constexpr int RH_OFF = KH_OFF + 4 * KROWS * XS;  // Rj, Rdj (RH) each
constexpr int PART_OFF = RH_OFF + 2 * RH;    // fp64 (2, NSUB, NVAL): the halves' sums
constexpr int RED_OFF = PART_OFF + 4 * NSUB * NVAL;   // JVPS: fp64, a warp's partial each
constexpr int TOTAL = RED_OFF + 2 * WARPS;
static_assert(SET % 4 == 0 && A_OFF % 4 == 0 && KH_OFF % 4 == 0 && RH_OFF % 4 == 0 &&
                  PART_OFF % 4 == 0 && RED_OFF % 4 == 0,
              "16-byte aligned tiles");
static_assert((size_t)TOTAL * sizeof(float) <= SMEM_LIMIT, "shared memory");

struct Args {
  const float *r, *k, *v, *w, *u, *rd, *kd, *vd, *wd, *ud;
  float* out;
  int B, S, H, hd, T;
  int TC;        // tangents a block
  int vec;       // 16-byte copies and stores
};

// ---- staging ---------------------------------------------------------------

// Q tokens of head row (b, h) of a (B, S, H, hd) tensor into a (Q, HD) tile of
// row stride ld; outside S and hd: zeros
__device__ void stage_rows(float* dst, const float* src, int ld, const Args& a, int b, int h) {
  const size_t row0 = ((size_t)b * a.S * a.H + h) * a.hd, ts = (size_t)a.H * a.hd;
  if (a.vec) {
    for (int e = threadIdx.x; e < Q * HD / 4; e += THREADS) {
      const int s = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool ok = s < a.S && c < a.hd;
      hopper::cp_async16(dst + s * ld + c, ok ? src + row0 + s * ts + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < Q * HD; e += THREADS) {
      const int s = e / HD, c = e % HD;
      const bool ok = s < a.S && c < a.hd;
      hopper::cp_async4(dst + s * ld + c, ok ? src + row0 + s * ts + c : src, ok);
    }
  }
}

// hd values at src (null: zeros) into HD floats
__device__ void stage_vec(float* dst, const float* src, const float* base, int hd) {
  for (int c = threadIdx.x; c < HD; c += THREADS) {
    const bool ok = src != nullptr && c < hd;
    hopper::cp_async4(dst + c, ok ? src + c : base, ok);
  }
}

// ---- the walks -------------------------------------------------------------

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// One halving of a reduce-scatter over the lanes: the lane keeps the lower
// (or, with ``hi``, the upper) half of ``in`` (padded with a zero when M is
// odd) and adds the partner's copy of it (``off`` lanes away)
template <int M>
__device__ __forceinline__ void halve(const double (&in)[M], double (&out)[(M + 1) / 2],
                                      int off, bool hi, int& base, int& lim) {
  constexpr int H2 = (M + 1) / 2;
#pragma unroll
  for (int i = 0; i < H2; ++i) {
    const double lo = in[i];
    const double up = i + H2 < M ? in[i + H2 < M ? i + H2 : i] : 0.0;
    const double got = __shfl_xor_sync(0xffffffffu, hi ? lo : up, off);
    out[i] = __dadd_rn(hi ? up : lo, got);
  }
  if (hi) base += H2;
  else lim = min(lim, base + H2);
}

// Warp (half, sub) walks the pairs s' < s of sub-chunk ``sub`` and its
// diagonal for channel c = 32 half + lane, and writes the sums of its 32
// channels into part (fp64, NVAL values in pair order: s (s - 1) / 2 + s',
// then the diagonal), and L one token past the sub-chunk's end, times k
// (with TANG: kd L + k Ld), into kt (fp64: K or Kd). Every term is formed in fp32
// and summed in fp64: A's (or with TANG this tangent's Ad's) entries. P: the
// primal tile set, G: the tangent's.
template <bool TANG>
__device__ void intra(const float* P, const float* G, double* part, double* kt, int sub,
                      int half, int lane) {
  const int c = 32 * half + lane, s0 = sub * C;
  auto at = [&](const float* set, int off, int s) { return set[off + (s0 + s) * XS + c]; };
  const float u = P[U_OFF + c];
  const float ud = TANG ? G[U_OFF + c] : 0.f;
  double val[NVAL];
  float L[C], Ld[C], kk[C], kd[C];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    kk[s] = at(P, K_OFF, s);
    kd[s] = TANG ? at(G, K_OFF, s) : 0.f;
  }
#pragma unroll
  for (int s = 0; s < C; ++s) {
    const float r = at(P, R_OFF, s);
    const float rd = TANG ? at(G, R_OFF, s) : 0.f;
    // row s: L[sp], Ld[sp] hold L_c[s][sp] and its tangent
#pragma unroll
    for (int sp = 0; sp < s; ++sp) {
      float term;
      if constexpr (TANG)   // r (k Ld + kd L) + rd (k L)
        term = __fmaf_rn(r, __fmaf_rn(kk[sp], Ld[sp], __fmul_rn(kd[sp], L[sp])),
                         __fmul_rn(rd, __fmul_rn(kk[sp], L[sp])));
      else                  // r (k L)
        term = __fmul_rn(r, __fmul_rn(kk[sp], L[sp]));
      val[s * (s - 1) / 2 + sp] = (double)term;
    }
    // the diagonal: u (r k), with TANG u (rd k + r kd) + ud (r k)
    const float rk = __fmul_rn(r, kk[s]);
    if constexpr (TANG)
      val[NPAIR + s] = (double)__fmaf_rn(u, __fmaf_rn(rd, kk[s], __fmul_rn(r, kd[s])),
                                         __fmul_rn(ud, rk));
    else
      val[NPAIR + s] = (double)__fmul_rn(u, rk);
    // to row s + 1: the columns so far decay by w_s, column s starts at 1
    const float w = at(P, W_OFF, s);
    const float wd = TANG ? at(G, W_OFF, s) : 0.f;
#pragma unroll
    for (int sp = 0; sp < s; ++sp) {
      if constexpr (TANG) Ld[sp] = __fmaf_rn(w, Ld[sp], __fmul_rn(wd, L[sp]));
      L[sp] = __fmul_rn(L[sp], w);
    }
    L[s] = 1.f;
    Ld[s] = 0.f;
  }
  // L[sp] = L_c[s0 + C][s0 + sp]: the K (Kd) rows of the blocks below
  if (sub < NSUB - 1) {
#pragma unroll
    for (int sp = 0; sp < C; ++sp)
      kt[(s0 + sp) * XS + c] = (double)(TANG ? __fmaf_rn(kd[sp], L[sp], __fmul_rn(kk[sp], Ld[sp]))
                                            : __fmul_rn(kk[sp], L[sp]));
  }
  // sums over the lanes: 36 -> 18 -> 9 -> 5 -> 3 -> 2 values a lane
  int base = 0, lim = NVAL;
  double v18[18], v9[9], v5[5], v3[3], v2[2];
  halve<NVAL>(val, v18, 16, lane & 16, base, lim);
  halve<18>(v18, v9, 8, lane & 8, base, lim);
  halve<9>(v9, v5, 4, lane & 4, base, lim);
  halve<5>(v5, v3, 2, lane & 2, base, lim);
  halve<3>(v3, v2, 1, lane & 1, base, lim);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (base + i < lim) part[base + i] = v2[i];
}

// The two channel halves' sums of sub-chunk ``sub`` into M (half 0 + half 1)
__device__ void combine(const double* part, double* M, int e) {
  const int sub = e / NVAL;
  int p = e % NVAL, s, sp;
  if (p >= NPAIR) {
    s = sp = p - NPAIR;
  } else {
    s = 1;
    while (p >= s) p -= s++;
    sp = p;
  }
  M[(sub * C + s) * MS + sub * C + sp] = __dadd_rn(part[e], part[NSUB * NVAL + e]);
}

// Warps walk L_c[s][e] (and its tangent) down the chunk from the boundary e
// = C (J + 1) - 1, channel c = 32 half + lane, and write Rj[s][c] = r_s L
// (with TANG: rd_s L + r_s Ld) into rt.
template <bool TANG, int J>
__device__ void boundary(const float* P, const float* G, float* rt, int half, int lane) {
  constexpr int e = C * (J + 1) - 1;
  const int c = 32 * half + lane;
  float* dst = rt + roff(J) - rb(J) * XS + c;   // row s at dst + s XS
  float L = 1.f, Ld = 0.f;
#pragma unroll
  for (int s = e + 1; s < Q; ++s) {
    const float r = P[R_OFF + s * XS + c], w = P[W_OFF + s * XS + c];
    if constexpr (TANG) {
      const float rd = G[R_OFF + s * XS + c], wd = G[W_OFF + s * XS + c];
      dst[s * XS] = __fmaf_rn(rd, L, __fmul_rn(r, Ld));
      Ld = __fmaf_rn(w, Ld, __fmul_rn(wd, L));
    } else {
      dst[s * XS] = __fmul_rn(r, L);
    }
    L = __fmul_rn(L, w);
  }
}

// The boundary walk of warps (sub >= 1, half): boundary NSUB - 1 - sub
template <bool TANG>
__device__ void boundaries(const float* P, const float* G, float* rt, int sub, int half,
                           int lane) {
  static_assert(NB == 3, "one case a boundary");
  if (sub == 3) boundary<TANG, 0>(P, G, rt, half, lane);
  else if (sub == 2) boundary<TANG, 1>(P, G, rt, half, lane);
  else if (sub == 1) boundary<TANG, 2>(P, G, rt, half, lane);
}

// The block of M below boundary j, one m-tile of it: unit 0 is (j, m-tile) =
// (0, 0), unit 1 (0, 1), unit 2 (1, 1), unit 3 (2, 1). Rows s > e of the
// m-tile, columns s' of sub-chunk j: Rj K^T, with TANG Rdj K^T + Rj Kd^T;
// every 8-channel step (channels past hd are zero in both tiles), even and
// odd steps of each product in their own accumulator (short dependent
// chains), summed in a fixed order.
template <bool TANG>
__device__ void cross(const float* rh, const float* rdh, const double* kh, const double* kdh,
                      double* M, int unit, int g, int t) {
  const int j = unit == 0 ? 0 : unit - 1, m = unit == 0 ? 0 : 1, e = C * (j + 1) - 1;
  const int ro = roff(j) + (16 * m - rb(j)) * XS, ko = C * j * XS;
  double acc[2][2][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 8) {
    const int q = (k0 / 8) & 1;
    if constexpr (TANG) {
      mma(acc[0][q], load_a(rdh + ro + k0, XS, g, t), load_bt(kh + ko + k0, XS, g, t));
      mma(acc[1][q], load_a(rh + ro + k0, XS, g, t), load_bt(kdh + ko + k0, XS, g, t));
    } else {
      mma(acc[0][q], load_a(rh + ro + k0, XS, g, t), load_bt(kh + ko + k0, XS, g, t));
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = 16 * m + g + 8 * hf;
    if (s > e) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * hf + q;
        M[s * MS + C * j + 2 * t + q] =
            __dadd_rn(__dadd_rn(acc[0][0][i], acc[0][1][i]), __dadd_rn(acc[1][0][i], acc[1][1][i]));
      }
    }
  }
}

// acc (the warp's two 16 x 8 tiles of rows s, columns 8 n .. 8 n + 7 of hd)
// += M x: M (Q, Q) fp64 lower-triangular, x a (Q, VS) tile
__device__ __forceinline__ void token_product(double (&acc)[2][4], const double* M,
                                              const float* x, int n, int g, int t) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const FragB fb = load_b(x + 8 * k * VS + 8 * n, VS, g, t);
    if (k < 2) mma(acc[0], load_a(M + 8 * k, MS, g, t), fb);
    mma(acc[1], load_a(M + 16 * MS + 8 * k, MS, g, t), fb);
  }
}

// JVPS: the cotangent of head row (b, h) at the positions of an output
// warp's accumulators (token 16 m + g (+8), column 8 n + 2 t (+1)); zero
// outside S and hd
__device__ __forceinline__ void load_gy(float (&gyr)[2][4], const float* gy, const Args& a,
                                        int b, int h, int n, int g, int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = 16 * m + g + 8 * (q >> 1), c = 8 * n + 2 * t + (q & 1);
      const bool ok = s < a.S && c < a.hd;
      gyr[m][q] = ok ? gy[(((size_t)b * a.S + s) * a.H + h) * a.hd + c] : 0.f;
    }
}

// ---- the kernel ------------------------------------------------------------

// JVPS: the tangents contracted with gy (B, S, H, hd) into parts (T, B H:
// one fp64 partial a (tangent, (b, h) block)) instead of stored. (gy and
// parts are parameters of their own: Args stays at the tangent pass's size,
// whose loads the compiler keeps in registers.)
template <bool JVPS>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_chunk_kernel(const Args a, const float* __restrict__ gy, double* __restrict__ parts) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tb = blockIdx.z * a.TC, nt = min(a.TC, a.T - tb);
  const int nk = (a.hd + 7) / 8;            // 8-channel steps, 8-column slices of hd
  const size_t tstride = (size_t)a.B * a.S * a.H * a.hd;
  const float* P = sm;
  double* sA = reinterpret_cast<double*>(sm + A_OFF);
  double* sAd = sA + Q * MS;
  double* kh = reinterpret_cast<double*>(sm + KH_OFF);
  double* kdh = kh + KROWS * XS;
  float* rh = sm + RH_OFF;
  float* rdh = rh + RH;
  double* part = reinterpret_cast<double*>(sm + PART_OFF);
  double* red = reinterpret_cast<double*>(sm + RED_OFF);
  const int sub = warp % NSUB, half = warp / NSUB;
  float gyr[2][4];
  if constexpr (JVPS) {
    hopper::grid_launch_dependents();   // the partials' sum may launch; it waits for this grid
    load_gy(gyr, gy, a, b, h, warp, g, t);
  }

  auto stage_tangent = [&](int tt, int st) {   // tangent tt's tiles into stage st
    float* G = sm + (1 + st) * SET;
    const size_t o = (size_t)tt * tstride;
    stage_rows(G + R_OFF, a.rd + o, XS, a, b, h);
    stage_rows(G + K_OFF, a.kd + o, XS, a, b, h);
    stage_rows(G + W_OFF, a.wd + o, XS, a, b, h);
    stage_rows(G + V_OFF, a.vd + o, VS, a, b, h);
    stage_vec(G + U_OFF, a.ud ? a.ud + ((size_t)tt * a.H + h) * a.hd : nullptr, a.u, a.hd);
  };

  stage_rows(sm + R_OFF, a.r, XS, a, b, h);
  stage_rows(sm + K_OFF, a.k, XS, a, b, h);
  stage_rows(sm + W_OFF, a.w, XS, a, b, h);
  stage_rows(sm + V_OFF, a.v, VS, a, b, h);
  stage_vec(sm + U_OFF, a.u + (size_t)h * a.hd, a.u, a.hd);
  stage_tangent(tb, 0);
  hopper::cp_async_commit();
  if (nt > 1) stage_tangent(tb + 1, 1);
  hopper::cp_async_commit();
  // A and Ad keep zero upper triangles; the R tiles zero rows up to their boundary
  for (int e = threadIdx.x; e < 2 * Q * MS; e += THREADS) sA[e] = 0.0;
  for (int e = threadIdx.x; e < 2 * RH; e += THREADS) rh[e] = 0.f;
  hopper::cp_async_wait<1>();   // the primal and tangent tb
  __syncthreads();

  // A, K and the R tiles, once a block
  intra<false>(P, nullptr, part + (half * NSUB + sub) * NVAL, kh, sub, half, lane);
  boundaries<false>(P, nullptr, rh, sub, half, lane);
  __syncthreads();
  if (warp < 4) cross<false>(rh, nullptr, kh, nullptr, sA, warp, g, t);
  else
    for (int e = threadIdx.x - 128; e < NSUB * NVAL; e += THREADS - 128) combine(part, sA, e);
  __syncthreads();

  for (int it = 0; it < nt; ++it) {
    float* G = sm + (1 + it % STAGES) * SET;
    if (it + 2 < nt) stage_tangent(tb + it + 2, (it + 2) % STAGES);   // loads while `it` computes
    hopper::cp_async_commit();
    intra<true>(P, G, part + (half * NSUB + sub) * NVAL, kdh, sub, half, lane);
    boundaries<true>(P, G, rdh, sub, half, lane);
    __syncthreads();
    // Ad's blocks below the boundaries (warps 0-3) and the halves' sums of its
    // sub-chunk blocks (4-7), while every warp starts its yd slice with A vd
    if (warp < 4) cross<true>(rh, rdh, kh, kdh, sAd, warp, g, t);
    else
      for (int e = threadIdx.x - 128; e < NSUB * NVAL; e += THREADS - 128) combine(part, sAd, e);
    double acc[2][4] = {}, accd[2][4] = {};
    if (warp < nk) token_product(acc, sA, G + V_OFF, warp, g, t);
    __syncthreads();
    if constexpr (JVPS) {
      // the contraction finish in place of the store: y rounded to fp32
      // (bitwise the yd the tangent pass stores), times gy in fp64 (exact),
      // the thread's 8 products in a fixed order
      double p = 0.0;
      if (warp < nk) {
        token_product(accd, sAd, P + V_OFF, warp, g, t);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            p = __fma_rn((double)__double2float_rn(__dadd_rn(accd[m][q], acc[m][q])),
                         (double)gyr[m][q], p);
      }
      p = hopper::warp_sum_f64(p);
      if (lane == 0) red[warp] = p;
    } else {
      if (warp < nk) {
        token_product(accd, sAd, P + V_OFF, warp, g, t);
        float* o = G + R_OFF;   // rd is read: yd takes its place
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int s = 16 * m + g, i = 8 * warp + 2 * t;
          double y[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) y[q] = __dadd_rn(accd[m][q], acc[m][q]);
          st2(o + s * XS + i, __double2float_rn(y[0]), __double2float_rn(y[1]));
          st2(o + (s + 8) * XS + i, __double2float_rn(y[2]), __double2float_rn(y[3]));
        }
      }
      __syncthreads();
      float* out = a.out + (size_t)(tb + it) * tstride + ((size_t)b * a.S * a.H + h) * a.hd;
      const size_t ts = (size_t)a.H * a.hd;
      for (int e = threadIdx.x; e < Q * HD / 4; e += THREADS) {
        const int s = e / (HD / 4), c = (e % (HD / 4)) * 4;
        if (s >= a.S || c >= a.hd) continue;
        const float* src = G + R_OFF + s * XS + c;
        if (a.vec) {
          *reinterpret_cast<float4*>(out + s * ts + c) = *reinterpret_cast<const float4*>(src);
        } else {
          for (int q = 0; q < 4 && c + q < a.hd; ++q) out[s * ts + c + q] = src[q];
        }
      }
    }
    hopper::cp_async_wait<1>();   // tangent it + 1 (it + 2 may still be in flight)
    __syncthreads();
    if constexpr (JVPS) {
      // the block's partial: the warps in warp order (read before any warp
      // passes the next tangent's first barrier)
      if (threadIdx.x == 0) {
        double p = 0.0;
        for (int w = 0; w < WARPS; ++w) p = __dadd_rn(p, red[w]);
        parts[(size_t)(tb + it) * gridDim.x + blockIdx.x] = p;
      }
    }
  }
}

// ---- launch ----------------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

bool bad_args(int B, int S, int H, int hd, int T) {
  return B < 1 || S < 1 || S > Q || H < 1 || hd < 1 || hd > HD || T < 1 || T > 65535 ||
         (long long)B * H > 2147483647LL;
}

Args make_args(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* rd, const void* kd, const void* vd, const void* wd,
               const void* ud, void* out, int B, int S, int H, int hd, int T) {
  Args a;
  a.r = (const float*)r; a.k = (const float*)k; a.v = (const float*)v;
  a.w = (const float*)w; a.u = (const float*)u; a.rd = (const float*)rd;
  a.kd = (const float*)kd; a.vd = (const float*)vd; a.wd = (const float*)wd;
  a.ud = (const float*)ud; a.out = (float*)out;
  a.B = B; a.S = S; a.H = H; a.hd = hd; a.T = T;
  a.vec = hd % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
          aligned16(u) && aligned16(rd) && aligned16(kd) && aligned16(vd) &&
          aligned16(wd) && aligned16(ud) && aligned16(out);
  // tangents a block: split over grid.z only until the blocks cover the SMs
  const long long heads = (long long)B * H;
  long long nz = sm_count() / heads;
  nz = nz < 1 ? 1 : nz > T ? T : nz;
  a.TC = (int)((T + nz - 1) / nz);
  return a;
}

template <bool JVPS>
int launch_t(const Args& a, const float* gy, double* parts, cudaStream_t stream) {
  const size_t smem = (size_t)TOTAL * sizeof(float);
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(wkv6_chunk_kernel<JVPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((unsigned)((long long)a.B * a.H), 1, (unsigned)((a.T + a.TC - 1) / a.TC));
  wkv6_chunk_kernel<JVPS><<<grid, THREADS, smem, stream>>>(a, gy, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after its launch; ud may be null (u carries no
// tangent).
extern "C" int wkv6_chunk_tangents(const void* r, const void* k, const void* v,
                                   const void* w, const void* u, const void* rd,
                                   const void* kd, const void* vd, const void* wd,
                                   const void* ud, void* yd, int B, int S, int H,
                                   int hd, int T, void* stream) {
  if (bad_args(B, S, H, hd, T)) return (int)cudaErrorInvalidValue;
  return launch_t<false>(make_args(r, k, v, w, u, rd, kd, vd, wd, ud, yd, B, S, H, hd, T),
                         nullptr, nullptr, (cudaStream_t)stream);
}

// The contraction epilogue's fp64 partials of a launch, for each tangent: one
// a (b, h) block; -1 for shapes it does not take.
extern "C" long long wkv6_chunk_jvps_parts(int B, int S, int H, int hd) {
  return bad_args(B, S, H, hd, 1) ? -1 : (long long)B * H;
}

// jvps_t = <gy, yd_t>: gy (B, S, H, hd); parts: fp64 scratch (T,
// wkv6_chunk_jvps_parts(...)); jvps: fp32 (T,); ud may be null. Returns
// cudaGetLastError() after its launches.
extern "C" int wkv6_chunk_jvps(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* rd, const void* kd,
                               const void* vd, const void* wd, const void* ud,
                               const void* gy, void* parts, void* jvps, int B, int S,
                               int H, int hd, int T, void* stream) {
  if (bad_args(B, S, H, hd, T)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(r, k, v, w, u, rd, kd, vd, wd, ud, nullptr, B, S, H, hd, T);
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_t<true>(a, (const float*)gy, (double*)parts, s);
  if (err != 0) return err;
  return hopper::launch_dependent(hopper::sum_parts_f64_kernel<32>, dim3(T), 32, 0, s,
                                  (const double*)parts, (float*)jvps, B * H);
}
