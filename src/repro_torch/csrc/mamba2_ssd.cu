// Mamba2 state recurrence for Hopper (sm_90a): the multi-tangent pass in the
// chunked state-space-dual (SSD) form, and at S <= 32 its contraction
// epilogue; plain C interface.
//
//   h_s = d_s h_{s-1} + x_s B_s^T,   y_s = h_s C_s          (h: hd x N a head)
//   and per tangent t its jvp, yd_s = d(h_s C_s), or jvps_t = <gy, yd_t>
//
// Replaces the TPU kernels repro/kernels/mamba2_scan/kernel.py::
// mamba2_scan_mt_kernel (emit_primal=False) and, for S <= 32 (every
// main-path launch), mamba2_scan_mt_jvps_kernel; the primal, and the
// contraction at S > 32, are in mamba2_scan.cu, in the recurrent form. Every
// operand and output is fp32 (the reference's ops.py casts them all). Layout
// (the public one, no transposes): x (B, S, H, hd), bm/cm (B, S, N), dec (B,
// S, H); tangents lead with T: xd (T, B, S, H, hd), bd/cd (T, B, S, N), dd
// (T, B, S, H); yd (T, B, S, H, hd); gy (B, S, H, hd).
//
// The algorithm (Dao & Gu 2024, "Transformers are SSMs", section 6), per
// batch row b, head h and chunk of Q = 32 tokens s, s' (chunk-local):
//   G  = C B^T (Q x Q, shared by every head of b)
//   L[s][s'] = d_s L[s-1][s'], L[s'][s'] = 1, 0 above the diagonal (running
//              products, the recurrence's order of multiplication; no logs,
//              no ratios, no division)
//   y  = (L o G) x  +  diag(Lc) C h_prev^T,   Lc_s = d_0 ... d_s
//   h_next = Lc_last h_prev + x^T diag(L[last, .]) B
// and per tangent, by the product rule with no division:
//   Gd = Cd B^T + C Bd^T,   Ld[s][s'] = d_s Ld[s-1][s'] + dd_s L[s-1][s']
//   yd = (Ld o G + L o Gd) x + (L o G) xd  + the carry's derivative
//   hd_next = Lc_last hd + Lcd_last h + xd^T diag(Ll) B + x^T (diag(Lld) B + diag(Ll) Bd)
//
// What bounds it on the H100: bytes. At zamba2's shape (B=8, S=32, H=64,
// hd=N=64, T=8) it must move 73 MB (mostly the T tangent inputs and outputs:
// 21.8 us at 3.35 TB/s) and needs 0.58 GFLOP in this form (lower triangles;
// the recurrent form 6.1; chip_smoke.py's mamba2_flops). The products run
// on the fp64 tensor cores (mma.sync.m16n8k8.f64, DMMA; 67 TFLOP/s): fp32
// operands are exact in fp64, so are their products, and the sums round to
// nearest. 3xTF32 on the tf32 tensor cores (hi/lo splits, three mma a
// k-step) missed the estimator's card-vs-CPU limits on the H100: the tf32
// units round their sums toward zero, which shrinks every output a little,
// the same way, and the shrink adds up over a round. G and Gd stay in fp64
// and M = L o G is formed in fp64 where it is loaded: G serves every head
// and column of its batch row, so rounding it to fp32 makes errors that add
// up coherently over the H hd outputs of a token. Plain TF32 keeps about
// three digits; wgmma's 64-row tiles do not fit a 32-token chunk.
//
// The design. A block serves HG heads of one batch row (a 64-column slice of
// hd each: one warp a 16-column slice, WPH = 4 warps a head; HG = 4 heads,
// 16 warps, at zamba2's shape) and a chunk of tangents, so G is computed
// once a block and each Gd once a tangent for all HG heads: recomputing Gd
// per head would double the pass's tensor work, and a pre-pass kernel
// writing G and Gd to scratch would add a dependent launch. Products are
// computed transposed, yd^T (i x s) = x^T (i x s') M^T (s' x s), so x and xd
// are the A operands straight from their staged tiles and the causal zeros
// of M skip 6 of the 16 (s, s') 8 x 8 tiles. One warp a head walks L (once a
// block when S <= Q) and, per tangent, Ld, one lane a column s'; L and Ld
// stay in shared memory, never in device memory. While the walkers build Ld
// the head's other warps already run the tangent-independent xd^T M2^T
// (M2 = L o G), then every warp adds x^T M1^T (M1 = Ld o G + L o Gd). x, B,
// C and the decays are staged once with 16-byte cp.async copies (4-byte ones
// where a row is not 16-byte aligned) and each tangent's xd, Bd, Cd and dd
// are double-buffered, so tangent t+1 loads while t computes; yd leaves
// through shared memory as coalesced 16-byte rows. One block of up to 16
// warps a SM; grid.z splits the tangents only as far as the SMs need.
// (Measured on the H100 against this design: bulk copies (cp.async.bulk)
// with mbarriers instead of cp.async cost more to issue a tangent than they
// saved at S = 32, and a separate phase for the walk was slower than
// overlapping it.)
// S > Q carries the (hd x N) state between chunks (template CARRY): then a
// block serves one head, holds its primal state and one tangent's state in
// shared memory (mma accumulators are loaded from and stored back to it;
// one warp owns 16 of its rows) and walks each tangent through every chunk,
// redoing the primal carry for each tangent, its tiles single-buffered.
// Every tangent runs the same instruction sequence whatever T and the
// tangent chunk are, and nothing is summed across blocks (no atomics), so a
// tangent's output from a T = 8 launch is bit for bit its T = 1 output. Any
// B, S, H, hd; N <= 128; ragged edges read as zero and are not stored.
//
// The contraction epilogue (template JVPS, one chunk) is the same walk with
// a contraction finish in place of the tangent store: each thread loads the
// 16 gy values at its accumulator fragment's positions into registers once
// a block, and per tangent rounds each accumulator to fp32 (bitwise the yd
// the tangent pass stores), multiplies it by its gy in fp64 (exact) and sums
// the 16 products in a fixed order, the warp by a fixed shuffle tree and the
// warps in warp order into one fp64 partial per (tangent, block);
// sum_parts_f64_kernel adds the partials in a fixed order and rounds once to
// fp32. No yd leaves the block and no atomics are used: at zamba2's shape
// the launch moves 43.7 MB instead of 73 (13.0 us at 3.35 TB/s), and the
// block plan and every sum's order depend on B, H, hd and N alone, so a
// tangent's jvp from a T = 8 launch is bit for bit its T = 1 jvp. (On the
// H100, summing the thread partials on the warp with the fewest Gd units,
// after the tangent's last barrier, read no faster.)
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int Q = 32;              // tokens a chunk
constexpr int MS = Q + 4;          // row stride of the Q x Q tiles (G, Gd, L, Ld)
constexpr int N_MAX = 128;
constexpr int HW_MAX = 64;         // hd columns a head a block (WPH <= 4 warps)
constexpr int WARPS_MAX = 16;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on sm_90

struct Args {
  const float *x, *bm, *cm, *dec, *xd, *bd, *cd, *dd;
  float* out;
  int B, S, H, hd, N, T;
  int HG;        // heads a block
  int WPH;       // warps a head (16 hd columns each)
  int HW;        // hd columns a head a block: 16 WPH
  int nhdc;      // hd chunks of HW
  int ngroups;   // head groups of HG
  int TC;        // tangents a block
  int NP, NS;    // N rounded up to 8; row stride of the (Q, N) tiles
  int XS;        // row stride of the (Q, HG, HW) tiles
  int vec_x, vec_n;   // 16-byte copies for the hd rows / the N rows
};

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// Offsets (floats) into a block's dynamic shared memory.
struct Layout {
  int x, b, c, dec;                  // the chunk's primal tiles
  int xd, bd, cd, dd;                // the tangent's tiles, stage 0
  int stage;                         // floats from one stage to the next
  int g, gd, gd2;                    // fp64: G; Gd's two halves (Cd B^T, C Bd^T)
  int l, ld;                         // L, Ld: one a head
  int h, hdt;                        // carried states (CARRY: one head)
  int vec;                           // CARRY: Lc, Lcd by row, Ll, Lld by column
  int red;                           // JVPS: the warps' fp64 partials
  int total;
};

__host__ __device__ inline Layout layout(bool carry, int HG, int HW, int XS, int NS) {
  Layout L = {};
  int o = 0;
  L.x = o;   o += Q * XS;
  L.b = o;   o += Q * NS;
  L.c = o;   o += Q * NS;
  L.dec = o; o += up4(Q * HG);
  L.xd = o; o += Q * XS;        // two stages of the tangent tiles (one with CARRY)
  L.bd = o; o += Q * NS;
  L.cd = o; o += Q * NS;
  L.dd = o; o += up4(Q * HG);
  L.stage = carry ? 0 : o - L.xd;
  o += L.stage;
  L.g = o;   o += 2 * Q * MS;
  L.gd = o;  o += 2 * Q * MS;
  L.gd2 = o; o += 2 * Q * MS;
  L.l = o;   o += HG * Q * MS;
  L.ld = o;  o += HG * Q * MS;
  L.h = o;   o += carry ? HW * NS : 0;
  L.hdt = o; o += carry ? HW * NS : 0;
  L.vec = o; o += carry ? HG * 4 * Q : 0;
  L.red = o; o += 2 * WARPS_MAX;
  L.total = o;
  return L;
}

using hopper::cp_async4;
using hopper::FragA;
using hopper::FragB;
using hopper::load_a;
using hopper::load_at;
using hopper::load_bt;
using hopper::mma;

// ---- staging ---------------------------------------------------------------

// A thread's share of a (Q, HG, HW) tile of a (B, S, H, hd) tensor, moved
// VEC columns at a time (4 with 16-byte rows, else 1): from column c of head
// hh, in tokens s0, s0 + R, ... (R = 2 VEC: the block's 32 HG WPH threads
// cover R tokens of HG heads of HW / VEC pieces); ``off`` is its tile offset
// at token s0 and ``goff`` its element offset in batch row b at token 0;
// ``ok`` its head and columns lie inside H and hd.
struct XPart {
  int s0, R, off, vec;
  size_t goff, tstride;    // tstride: elements a token
  bool ok;
};

__device__ __forceinline__ XPart x_part(const Args& a, int b, int h0, int i0) {
  XPart p;
  p.vec = a.vec_x ? 4 : 1;
  const int per = a.HW / p.vec;                  // pieces a head row
  const int c = (threadIdx.x % per) * p.vec, rest = threadIdx.x / per;
  const int hh = rest % a.HG;
  p.s0 = rest / a.HG;
  p.R = blockDim.x / (per * a.HG);
  p.off = p.s0 * a.XS + hh * a.HW + c;
  p.tstride = (size_t)a.H * a.hd;
  p.goff = (size_t)b * a.S * p.tstride + (size_t)(h0 + hh) * a.hd + i0 + c;
  p.ok = h0 + hh < a.H && i0 + c < a.hd;
  return p;
}

// Q tokens from token t0 of a (B, S, H, hd) tensor into a (Q, HG, HW) tile
// of row stride XS; outside S, H or hd: zeros.
__device__ void stage_x(float* dst, const float* src, const Args& a, const XPart& p, int t0) {
  for (int s = p.s0; s < Q; s += p.R) {
    const bool ok = p.ok && t0 + s < a.S;
    const float* g = ok ? src + p.goff + (size_t)(t0 + s) * p.tstride : src;
    if (p.vec == 4) hopper::cp_async16(dst + p.off + (s - p.s0) * a.XS, g, ok);
    else cp_async4(dst + p.off + (s - p.s0) * a.XS, g, ok);
  }
}

// Q tokens x NP columns of a (B, S, N) tensor into a tile of row stride NS;
// outside S and N: zeros
__device__ void stage_n(float* dst, const float* src, const Args& a, int b, int t0) {
  if (a.vec_n) {
    const int n4 = a.NP >> 2;
    for (int e = threadIdx.x; e < Q * n4; e += blockDim.x) {
      const int s = e / n4, n = (e - s * n4) << 2;
      const bool ok = t0 + s < a.S && n < a.N;
      hopper::cp_async16(dst + s * a.NS + n,
                         ok ? src + ((size_t)b * a.S + t0 + s) * a.N + n : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < Q * a.NP; e += blockDim.x) {
      const int s = e / a.NP, n = e - s * a.NP;
      const bool ok = t0 + s < a.S && n < a.N;
      cp_async4(dst + s * a.NS + n, ok ? src + ((size_t)b * a.S + t0 + s) * a.N + n : src, ok);
    }
  }
}

// Q tokens x HG heads of a (B, S, H) tensor, (token, head) order
__device__ void stage_dec(float* dst, const float* src, const Args& a, int b, int s0, int h0) {
  for (int e = threadIdx.x; e < Q * a.HG; e += blockDim.x) {
    const int s = e / a.HG, hh = e - s * a.HG;
    const bool ok = s0 + s < a.S && h0 + hh < a.H;
    cp_async4(dst + e, ok ? src + ((size_t)b * a.S + s0 + s) * a.H + h0 + hh : src, ok);
  }
}

// the tile written by stage_x back to (B, S, H, hd), inside S, H and hd only
__device__ void store_x(float* dst, const float* src, const Args& a, const XPart& p, int t0) {
  if (!p.ok) return;
  for (int s = p.s0; s < Q && t0 + s < a.S; s += p.R) {
    float* g = dst + p.goff + (size_t)(t0 + s) * p.tstride;
    const float* d = src + p.off + (s - p.s0) * a.XS;
    if (p.vec == 4) *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(d);
    else *g = *d;
  }
}

// ---- the pieces of a chunk -------------------------------------------------

// Output tile k of 6 of a lower-triangular Q x Q product A Bm^T in fp64 (A,
// Bm: (Q, NP) row-major tiles of stride NS; rows s in 16 mt.., columns s' in
// 8 nt..; the two tiles wholly above the diagonal are never needed or written).
__device__ void gram_tile(double* out, const float* A, const float* Bm, int NS, int NP, int k,
                          int g, int t) {
  const int mt = k >= 2, nt = k >= 2 ? k - 2 : k;
  const float* pa = A + 16 * mt * NS;
  const float* pb = Bm + 8 * nt * NS;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
  for (int k0 = 0; k0 < NP; k0 += 8)
    mma(acc, load_a(pa + k0, NS, g, t), load_bt(pb + k0, NS, g, t));
  double* o = out + 16 * mt * MS + 8 * nt;   // kept in fp64: every head of the row reads it
  o[g * MS + 2 * t] = acc[0];
  o[g * MS + 2 * t + 1] = acc[1];
  o[(g + 8) * MS + 2 * t] = acc[2];
  o[(g + 8) * MS + 2 * t + 1] = acc[3];
}

// One warp a head: lane s' walks column s' of L (and Ld) down the chunk and
// writes it, zero above the diagonal. The primal part (PRIM) writes L, with
// CARRY also the carry's multipliers Lc_s = d_0 .. d_s (by row) and L of the
// chunk's last token (by column); the tangent part (TANG) writes Ld, with
// CARRY Lcd_s and the last token's Ld.
template <bool PRIM, bool TANG, bool CARRY>
__device__ void walk(float* sm, const Layout& Ly, int st, int hh, int HG, int qn, int lane) {
  const float* __restrict__ dec = sm + Ly.dec;
  const float* __restrict__ dd = sm + Ly.dd + st * Ly.stage;
  float* __restrict__ lt = sm + Ly.l + hh * Q * MS;
  float* __restrict__ ldt = sm + Ly.ld + hh * Q * MS;
  float* __restrict__ vec = sm + Ly.vec + hh * 4 * Q;
  float L = 0.f, Ld = 0.f, Lc = 1.f, Lcd = 0.f;
#pragma unroll 8
  for (int s = 0; s < Q; ++s) {
    const float d = dec[s * HG + hh];
    if constexpr (TANG) {
      const float ddv = dd[s * HG + hh];
      Ld = s == lane ? 0.f : __fmaf_rn(d, Ld, __fmul_rn(ddv, L));
      if constexpr (CARRY) Lcd = __fmaf_rn(d, Lcd, __fmul_rn(ddv, Lc));
      ldt[s * MS + lane] = Ld;
    }
    L = s == lane ? 1.f : __fmul_rn(d, L);
    if constexpr (CARRY) Lc = __fmul_rn(d, Lc);
    if constexpr (PRIM) lt[s * MS + lane] = L;
    if constexpr (CARRY) {
      if (lane == 0) {
        if constexpr (PRIM) vec[s] = Lc;
        if constexpr (TANG) vec[Q + s] = Lcd;
      }
      if (s == qn - 1) {
        if constexpr (PRIM) vec[2 * Q + lane] = L;
        if constexpr (TANG) vec[3 * Q + lane] = Ld;
      }
    }
  }
}

// The (s', s) fragment of M^T for the tile of rows s in 8 j.., columns s' in
// 8 k.. (p: that tile's offset in the Q x Q tiles), formed in fp64:
// M2 = L o G, or M1 = Ld o G + L o (Gd + Gd2). L and Ld are zero above the
// diagonal, so M is too.
struct MTiles { const float *l, *ld; const double *g, *gd, *gd2; };

template <bool M1>
__device__ __forceinline__ FragB load_m(const MTiles& m, int p, int g, int t) {
  FragB f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = p + g * MS + t + 4 * e;
    if constexpr (M1) f.v[e] = __fma_rn((double)m.ld[q], m.g[q], m.l[q] * (m.gd[q] + m.gd2[q]));
    else f.v[e] = m.l[q] * m.g[q];
  }
  return f;
}

// The warp's 16 x Q slice of y^T = x^T M^T (x: the warp's columns of a
// (Q, ., XS) tile; ZERO: start from 0, else add); (s, s') tiles above the
// diagonal skipped. The primal is x^T M2^T; a tangent xd^T M2^T + x^T M1^T.
template <bool ZERO, bool M1>
__device__ __forceinline__ void chunk_product(double (&acc)[4][4], const float* x, int XS,
                                              const MTiles& m, int g, int t) {
  if constexpr (ZERO) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const FragA fx = load_at(x + 8 * k * XS, XS, g, t);
#pragma unroll
    for (int j = k; j < 4; ++j) mma(acc[j], fx, load_m<M1>(m, 8 * j * MS + 8 * k, g, t));
  }
}

// CARRY, a chunk after the first: the states' part of the warp's output,
// yd^T += hd (Lc C)^T + h (Lcd C + Lc Cd)^T (h, hd: the warp's 16 rows of the
// states carried in; the scaled operands formed in fp64).
__device__ void carry_readout(double (&acc)[4][4], const float* h, const float* hdt,
                              const float* C, const float* Cd, const float* vec, int NS,
                              int NP, int g, int t) {
  const float* lc = vec;
  const float* lcd = vec + Q;
  for (int k0 = 0; k0 < NP; k0 += 8) {
    const FragA fh = load_a(h + k0, NS, g, t);
    const FragA fhd = load_a(hdt + k0, NS, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 8 * j + g;
      const double c0 = C[s * NS + k0 + t], c1 = C[s * NS + k0 + t + 4];
      const double d0 = Cd[s * NS + k0 + t], d1 = Cd[s * NS + k0 + t + 4];
      mma(acc[j], fhd, {{lc[s] * c0, lc[s] * c1}});
      mma(acc[j], fh, {{__fma_rn((double)lcd[s], c0, lc[s] * d0),
                        __fma_rn((double)lcd[s], c1, lc[s] * d1)}});
    }
  }
}

// CARRY: the warp's 16 rows of the states carried out of the chunk, in
// place: hd' = Lc_l hd + Lcd_l h + xd^T diag(Ll) B + x^T (diag(Lld) B + diag(Ll) Bd)
// first (it reads the old h), then h' = Lc_l h + x^T diag(Ll) B, summed in
// fp64 and stored in fp32; ``first``: the states carried in are zero.
__device__ void carry_update(float* h, float* hdt, const FragA (&ax)[4],
                             const FragA (&axd)[4], const float* Bm, const float* Bd,
                             const float* vec, int qn, bool first, int NS, int NP, int g,
                             int t) {
  const double lcl = vec[qn - 1];
  const double lcdl = vec[Q + qn - 1];
  const float* ll = vec + 2 * Q;
  const float* lld = vec + 3 * Q;
  for (int n0 = 0; n0 < NP; n0 += 8) {
    int idx[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) idx[e] = (g + 8 * (e >> 1)) * NS + n0 + 2 * t + (e & 1);
    double acc[4], accd[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const double hv = first ? 0.0 : h[idx[e]];
      acc[e] = lcl * hv;
      accd[e] = first ? 0.0 : __fma_rn(lcdl, hv, lcl * hdt[idx[e]]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s1 = 8 * k + t, s2 = s1 + 4;
      const double b1 = Bm[s1 * NS + n0 + g], b2 = Bm[s2 * NS + n0 + g];
      const FragB fb = {{ll[s1] * b1, ll[s2] * b2}};
      const double e1 = Bd[s1 * NS + n0 + g], e2 = Bd[s2 * NS + n0 + g];
      mma(accd, axd[k], fb);
      mma(accd, ax[k], {{__fma_rn((double)lld[s1], b1, ll[s1] * e1),
                         __fma_rn((double)lld[s2], b2, ll[s2] * e2)}});
      mma(acc, ax[k], fb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[idx[e]] = __double2float_rn(acc[e]);
      hdt[idx[e]] = __double2float_rn(accd[e]);
    }
  }
}

// the warp's 16 x Q accumulator tile, rounded to fp32, into its columns of a
// (Q, ., XS) tile
__device__ __forceinline__ void put_acc(float* o, const double (&acc)[4][4], int XS, int g,
                                        int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 8 * j + 2 * t;
    o[s * XS + g] = __double2float_rn(acc[j][0]);
    o[(s + 1) * XS + g] = __double2float_rn(acc[j][1]);
    o[s * XS + g + 8] = __double2float_rn(acc[j][2]);
    o[(s + 1) * XS + g + 8] = __double2float_rn(acc[j][3]);
  }
}

// JVPS: the cotangent at the positions of the warp's accumulator tile (the
// ones put_acc writes): token 8 j + 2 t (+1), column c0 + g (+8) of head h;
// zero outside S, H and hd
__device__ __forceinline__ void load_gy(float (&gyr)[4][4], const float* gy, const Args& a,
                                        int b, int h, int c0, int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 8 * j + 2 * t + (e & 1), c = c0 + g + 8 * (e >> 1);
      const bool ok = s < a.S && h < a.H && c < a.hd;
      gyr[j][e] = ok ? gy[(((size_t)b * a.S + s) * a.H + h) * a.hd + c] : 0.f;
    }
}

// JVPS, the contraction finish in place of put_acc: each accumulator rounded
// to fp32 (the value put_acc would store), times its gy in fp64 (exact), the
// thread's 16 products summed in a fixed order
__device__ __forceinline__ double contract(const double (&acc)[4][4], const float (&gyr)[4][4]) {
  double p = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p = __fma_rn((double)__double2float_rn(acc[j][e]), (double)gyr[j][e], p);
  return p;
}

// ---- the kernel ------------------------------------------------------------

// (CARRY: one head, at most 4 warps; JVPS: one chunk, the tangents contracted
// with gy (B, S, H, hd) into parts (T, B ngroups nhdc: one fp64 partial a
// (tangent, block)) instead of stored)
template <bool CARRY, bool JVPS>
__global__ void __launch_bounds__(CARRY ? 128 : WARPS_MAX * 32)
mamba2_ssd_kernel(const Args a, const float* __restrict__ gy, double* __restrict__ parts) {
  static_assert(!(CARRY && JVPS), "the contraction serves one chunk");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout Ly = layout(CARRY, a.HG, a.HW, a.XS, a.NS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int W = blockDim.x >> 5;
  const int group = blockIdx.x / a.nhdc;
  const int h0 = group * a.HG, i0 = (blockIdx.x - group * a.nhdc) * a.HW;
  const int b = blockIdx.y;
  const int hh = warp / a.WPH, ws = warp - hh * a.WPH;
  const int col0 = hh * a.HW + ws * 16;       // the warp's columns of an x tile
  const bool walker = ws == hh % a.WPH;       // the heads' walkers on 4 partitions
  const int nchunks = CARRY ? (a.S + Q - 1) / Q : 1;
  const XPart xp = x_part(a, b, h0, i0);
  float* sx = sm + Ly.x;
  float* sb = sm + Ly.b;
  float* sc = sm + Ly.c;
  const MTiles mt = {sm + Ly.l + hh * Q * MS, sm + Ly.ld + hh * Q * MS,   // the warp's head
                     reinterpret_cast<const double*>(sm + Ly.g),
                     reinterpret_cast<const double*>(sm + Ly.gd),
                     reinterpret_cast<const double*>(sm + Ly.gd2)};
  float* hs = sm + Ly.h + ws * 16 * a.NS;     // CARRY: the warp's rows of the states
  float* hds = sm + Ly.hdt + ws * 16 * a.NS;
  const float* vec = sm + Ly.vec;
  double* red = reinterpret_cast<double*>(sm + Ly.red);
  double acc[4][4];
  float gyr[4][4];
  if constexpr (JVPS) {
    hopper::grid_launch_dependents();   // the partials' sum may launch; it waits for this grid
    load_gy(gyr, gy, a, b, h0 + hh, i0 + ws * 16, g, t);
  }

  auto stage_primal = [&](int s0) {   // a chunk's x, B, C and decays
    stage_x(sx, a.x, a, xp, s0);
    stage_n(sb, a.bm, a, b, s0);
    stage_n(sc, a.cm, a, b, s0);
    stage_dec(sm + Ly.dec, a.dec, a, b, s0, h0);
  };
  auto arrived = [&]() {              // this thread's copies have landed
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
  };
  auto gram_g = [&]() {
    for (int u = warp; u < 6; u += W)
      gram_tile(reinterpret_cast<double*>(sm + Ly.g), sc, sb, a.NS, a.NP, u, g, t);
  };

  {
    // the block's tangents tb .. tb + nt - 1
    const int tb = blockIdx.z * a.TC, nt = min(a.TC, a.T - tb);
    const size_t xstride = (size_t)a.B * a.S * a.H * a.hd;
    const size_t nstride = (size_t)a.B * a.S * a.N;
    const size_t dstride = (size_t)a.B * a.S * a.H;
    auto stage_tangent = [&](int tt, int st, int s0) {   // tangent tt's tiles into stage st
      const int o = st * Ly.stage;
      stage_x(sm + Ly.xd + o, a.xd + tt * xstride, a, xp, s0);
      stage_n(sm + Ly.bd + o, a.bd + tt * nstride, a, b, s0);
      stage_n(sm + Ly.cd + o, a.cd + tt * nstride, a, b, s0);
      stage_dec(sm + Ly.dd + o, a.dd + tt * dstride, a, b, s0, h0);
    };
    auto gram_d = [&](int u, int st) {   // Gd's two halves, units 0..11
      const int o = st * Ly.stage;
      double* gd = reinterpret_cast<double*>(sm + (u < 6 ? Ly.gd : Ly.gd2));
      if (u < 6) gram_tile(gd, sm + Ly.cd + o, sb, a.NS, a.NP, u, g, t);
      else gram_tile(gd, sc, sm + Ly.bd + o, a.NS, a.NP, u - 6, g, t);
    };

    if constexpr (!CARRY) {
      // one chunk: x, B, C, the decays, G and L once for every tangent
      stage_primal(0);
      stage_tangent(tb, 0, 0);
      arrived();
      __syncthreads();
      gram_g();
      __syncthreads();
      if (walker) walk<true, false, false>(sm, Ly, 0, hh, a.HG, a.S, lane);
      for (int it = 0; it < nt; ++it) {
        const int st = it & 1;
        float* sxd = sm + Ly.xd + st * Ly.stage;
        if (it + 1 < nt) stage_tangent(tb + it + 1, st ^ 1, 0);   // loads while it computes
        for (int u = warp; u < 12; u += W) gram_d(u, st);
        __syncthreads();
        // the walkers build Ld while the head's other warps start on xd^T M2^T
        if (walker) walk<false, true, false>(sm, Ly, st, hh, a.HG, a.S, lane);
        chunk_product<true, false>(acc, sxd + col0, a.XS, mt, g, t);
        __syncthreads();
        chunk_product<false, true>(acc, sx + col0, a.XS, mt, g, t);
        if constexpr (JVPS) {
          const double p = hopper::warp_sum_f64(contract(acc, gyr));
          if (lane == 0) red[warp] = p;
        } else {
          __syncwarp();   // the warp's own columns of xd are read; yd takes their place
          put_acc(sxd + col0, acc, a.XS, g, t);
          __syncthreads();
          store_x(a.out + (tb + it) * xstride, sxd, a, xp, 0);
        }
        arrived();   // tangent it + 1
        __syncthreads();
        if constexpr (JVPS) {
          // the block's partial: the warps in warp order (read before any
          // warp passes the next tangent's first barrier)
          if (threadIdx.x == 0) {
            double p = 0.0;
            for (int w = 0; w < W; ++w) p = __dadd_rn(p, red[w]);
            parts[(size_t)(tb + it) * gridDim.x * gridDim.y + (size_t)b * gridDim.x +
                  blockIdx.x] = p;
          }
        }
      }
    } else {
      // CARRY: each tangent through every chunk, the primal carry redone with it
      float* sxd = sm + Ly.xd;
      for (int it = 0; it < nt; ++it) {
        for (int ch = 0; ch < nchunks; ++ch) {
          const int s0 = ch * Q, qn = min(Q, a.S - s0);
          stage_primal(s0);
          stage_tangent(tb + it, 0, s0);
          arrived();
          __syncthreads();
          gram_g();
          for (int u = warp; u < 12; u += W) gram_d(u, 0);
          __syncthreads();
          if (walker) walk<true, true, true>(sm, Ly, 0, hh, a.HG, qn, lane);
          __syncthreads();
          chunk_product<true, false>(acc, sxd + col0, a.XS, mt, g, t);
          chunk_product<false, true>(acc, sx + col0, a.XS, mt, g, t);
          FragA ax[4], axd[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ax[k] = load_at(sx + 8 * k * a.XS + col0, a.XS, g, t);
            axd[k] = load_at(sxd + 8 * k * a.XS + col0, a.XS, g, t);
          }
          if (ch > 0)
            carry_readout(acc, hs, hds, sc, sm + Ly.cd, vec, a.NS, a.NP, g, t);
          if (ch + 1 < nchunks)
            carry_update(hs, hds, ax, axd, sb, sm + Ly.bd, vec, qn, ch == 0, a.NS, a.NP, g, t);
          __syncwarp();
          put_acc(sxd + col0, acc, a.XS, g, t);
          __syncthreads();
          store_x(a.out + (tb + it) * xstride, sxd, a, xp, s0);
          __syncthreads();
        }
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

template <bool CARRY, bool JVPS>
int launch_t(const Args& a, const float* gy, double* parts, cudaStream_t stream) {
  const Layout Ly = layout(CARRY, a.HG, a.HW, a.XS, a.NS);
  const size_t smem = (size_t)Ly.total * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = mamba2_ssd_kernel<CARRY, JVPS>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid(a.ngroups * a.nhdc, a.B, (a.T + a.TC - 1) / a.TC);
  kern<<<grid, 32 * a.HG * a.WPH, smem, stream>>>(a, gy, parts);
  return (int)cudaGetLastError();
}

// The block partials of a contraction launch: a (tangent, block) each
long long n_parts(const Args& a) { return (long long)a.B * a.ngroups * a.nhdc; }

bool bad_args(int B, int S, int H, int hd, int N, int T) {
  return B < 1 || B > 65535 || S < 1 || H < 1 || hd < 1 || N < 1 || N > N_MAX || T < 1 ||
         (long long)H * hd > 2147483647LL;
}

// Shapes, strides and the block's share of heads and tangents.
Args make_args(const void* x, const void* bm, const void* cm, const void* dec,
               const void* xd, const void* bd, const void* cd, const void* dd, void* out,
               int B, int S, int H, int hd, int N, int T) {
  Args a;
  a.x = (const float*)x; a.bm = (const float*)bm; a.cm = (const float*)cm;
  a.dec = (const float*)dec; a.xd = (const float*)xd; a.bd = (const float*)bd;
  a.cd = (const float*)cd; a.dd = (const float*)dd; a.out = (float*)out;
  a.B = B; a.S = S; a.H = H; a.hd = hd; a.N = N; a.T = T;
  a.WPH = (min(hd, HW_MAX) + 15) / 16;
  a.HW = 16 * a.WPH;
  a.nhdc = (hd + a.HW - 1) / a.HW;
  a.NP = (N + 7) & ~7;
  a.NS = a.NP + 4;              // an odd multiple of 4: fragment loads miss bank conflicts
  a.vec_x = hd % 4 == 0 && aligned16(x) && aligned16(xd) && aligned16(out);
  a.vec_n = N % 4 == 0 && aligned16(bm) && aligned16(cm) && aligned16(bd) && aligned16(cd);
  const bool carry = S > Q;
  // heads a block: one with the carry; otherwise as many as 16 warps and
  // shared memory hold, so G and each Gd serve them all
  a.HG = 1;
  if (!carry) {
    a.HG = min(H, WARPS_MAX / a.WPH);
    while (a.HG > 1) {
      const int row = a.HG * a.HW;
      const int xs = row + (40 - row % 32) % 32;
      if ((size_t)layout(false, a.HG, a.HW, xs, a.NS).total * sizeof(float) <= SMEM_LIMIT)
        break;
      --a.HG;
    }
  }
  const int row = a.HG * a.HW;
  a.XS = row + (40 - row % 32) % 32;   // = 8 mod 32: x^T fragments miss bank conflicts
  a.ngroups = (H + a.HG - 1) / a.HG;
  // tangents a block: split over grid.z only until the blocks cover the SMs
  const long long base = (long long)a.B * a.ngroups * a.nhdc;
  long long nz = sm_count() / base;
  nz = nz < 1 ? 1 : nz > T ? T : nz;
  if (nz > 65535) nz = 65535;
  a.TC = (int)((T + nz - 1) / nz);
  return a;
}

}  // namespace

// Returns cudaGetLastError() after its launch.
extern "C" int mamba2_scan_mt_tangents(const void* x, const void* bm,
                                       const void* cm, const void* dec,
                                       const void* xd, const void* bd,
                                       const void* cd, const void* dd, void* yd,
                                       int B, int S, int H, int hd, int N, int T,
                                       void* stream) {
  if (bad_args(B, S, H, hd, N, T)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, bm, cm, dec, xd, bd, cd, dd, yd, B, S, H, hd, N, T);
  cudaStream_t s = (cudaStream_t)stream;
  return S > Q ? launch_t<true, false>(a, nullptr, nullptr, s)
               : launch_t<false, false>(a, nullptr, nullptr, s);
}

// The contraction epilogue at S <= 32 (one chunk): per-block fp64 partials
// of a launch, for each tangent (the plan depends on B, H, hd and N only);
// -1 for shapes it does not take.
extern "C" long long mamba2_ssd_jvps_parts(int B, int S, int H, int hd, int N) {
  if (bad_args(B, S, H, hd, N, 1) || S > Q) return -1;
  return n_parts(make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, B, S, H, hd, N, 1));
}

// jvps_t = <gy, yd_t> for S <= 32: gy (B, S, H, hd); parts: fp64 scratch
// (T, mamba2_ssd_jvps_parts(...)); jvps: fp32 (T,). Returns
// cudaGetLastError() after its launches.
extern "C" int mamba2_ssd_jvps(const void* x, const void* bm, const void* cm,
                               const void* dec, const void* xd, const void* bd,
                               const void* cd, const void* dd, const void* gy, void* parts,
                               void* jvps, int B, int S, int H, int hd, int N, int T,
                               void* stream) {
  if (bad_args(B, S, H, hd, N, T) || S > Q) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, bm, cm, dec, xd, bd, cd, dd, nullptr, B, S, H, hd, N, T);
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_t<false, true>(a, (const float*)gy, (double*)parts, s);
  if (err != 0) return err;
  return hopper::launch_dependent(hopper::sum_parts_f64_kernel<32>, dim3(T), 32, 0, s,
                                  (const double*)parts, (float*)jvps, (int)n_parts(a));
}
