"""RWKV6 WKV recurrence from a fresh state: primal, T stacked jvp tangents
in one walk, and the same walk contracted against an output cotangent (the
jvp-contraction epilogue).

    y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)     (per head, S in R^{hd x hd})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,        S_0 = 0

Per tangent the walk carries Sd_t = wd_t * S_{t-1} + w_t * Sd_{t-1} + kd_t
v_t^T + k_t vd_t^T and emits yd_t = rd_t^T (S_{t-1} + (u * k_t) v_t^T) +
r_t^T (Sd_{t-1} + (u * kd_t + ud * k_t) v_t^T + (u * k_t) vd_t^T).

Replaces three TPU kernels of ``repro/kernels/wkv6_scan/kernel.py``:
``wkv6_scan_kernel`` (every rwkv6 layer's primal inside the estimator),
``wkv6_scan_mt_kernel`` in its ``emit_primal=False`` route (all K tangents
of every rwkv6 layer) and ``wkv6_scan_mt_jvps_kernel`` (the ssm family's
final site on the fused route). The public layout is the reference ops':
r, k, v, w (B,S,H,hd), u (H,hd), tangents with a leading T (uds (T,H,hd)
or None: the SPRY path's u is a frozen base weight, so it passes none).
Every operand is cast to fp32 as the reference's ``ops.py`` does, and the
kernels take and give fp32 only. The reference flattens to (B*H, S, hd)
and pads S to its TPU block; the CUDA kernels index (B,S,H,hd) directly
and take any S, so neither copy is made.

On the H100 the recurrent walk is bound by operations: per (b*h, token) the
primal walk does 5 hd^2 flops and each tangent 11 hd^2, none of it a product
a tensor core takes (a rank-1 update and a mat-vec a token). The TPU kernel
keeps the (hd, hd) state and T tangent states in VMEM, 144 KiB at T=8,
hd=64. The port computes each function in the form that bounds it least:

- The primal (``csrc/wkv6_scan.cu``, ``wkv6_primal_kernel``) keeps the
  recurrence and its per-token fp32 rounding of the state, ``s = fma(w, s,
  k v_j)``: the rwkv6 card-vs-CPU check follows that rounding, as zamba2's
  follows the mamba2 state's. A block takes one (b, h) row and stages its
  r, k, w rows and v columns for up to 32 tokens in one round of 16-byte
  ``cp.async`` copies (longer S: a ring of two 32-token chunks, the next
  loading while one is walked); each thread holds an 8-row x 4-column
  block of the state in registers, so a token's r, k, w rows arrive as
  16-byte shared loads that serve four columns. The readout is y_t[j] = r_t
  . S_{t-1}[:, j] + a_t v_t[j] with the bonus a_t = sum_i r_t u k_t once a
  token; the partials of 8 tokens are summed over a column's 8 row lanes in
  one reduce-scatter of shuffles; y leaves through shared memory as rows.
- The tangents at S <= 32, every main-path launch, use the chunked form
  (``csrc/wkv6_chunk.cu``; ``wkv6_chunked_ref`` below is its plain
  version): per 32-token chunk y = A v with A[s][s'] = sum_c r_s k_s' L_c
  and L_c[s][s'] the product of the decays in (s', s), by running
  products; a tangent is yd = Ad v + A vd with Ad from the product rule.
  At rwkv6-1.6b's shape that needs 0.98 GFLOP for T=8 against 3.09 in
  the recurrent form (``chip_smoke.wkv6_flops``), so the pass is bound by
  its 92 MB instead. Sums over c and the (Q x Q) x (Q x hd) products run
  in fp64, the products on the fp64 tensor cores (``mma.sync`` f64). S >
  32 keeps the recurrent kernel of the first port (``launches_by_path``
  counts both routes, by ``wkv6_mt_path``).
- The contraction epilogue takes the same routes (``wkv6_jvps_path``). At
  S <= 32, every main-path launch, it is the chunked tangent kernel with a
  contraction finish in place of the yd store (``csrc/wkv6_chunk.cu``,
  route ``chunk``): each y rounded to fp32, so the tangents contracted are
  bitwise the ones the tangent pass stores, times gy in fp64, summed in a
  fixed order into one fp64 partial per (tangent, (b, h) block), which a
  one-warp kernel sums in a fixed order and rounds once to fp32
  (``wkv6_scan_mt_jvps_chunked_ref`` is its plain version). S > 32 keeps
  the recurrent kernel of the first port (route ``rec``): G = 8 lanes own
  a value column, each lane hd/8 of its rows, so a column's primal state
  and its TC tangent states stay in registers; each lane's partial is
  multiplied by gy as it goes and the block summed in a fixed order into
  one fp32 partial per (tangent, block). Neither uses atomics; the chunk
  carry for S > 32 is not written yet.

Every tangent runs the same instruction sequence for any T, so a T=8
launch equals eight T=1 launches bit for bit, on every route. hd <= 64.

CPU tensors take the plain versions below; CUDA tensors launch a kernel
or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, calls

HD_MAX = 64
CHUNK = 32          # tokens of the chunked tangent route; longer S: recurrent
launches = {"wkv6_scan": 0, "wkv6_scan_mt": 0, "wkv6_scan_mt_jvps": 0}
launches_by_path = {"wkv6_scan_mt": {"chunk": 0, "rec": 0},
                    "wkv6_scan_mt_jvps": {"chunk": 0, "rec": 0}}


def wkv6_mt_path(S):
    """Route of a ``wkv6_scan_mt_tangents`` launch: 'chunk' (the chunked
    form on the fp64 tensor cores, one chunk) for S <= CHUNK, else 'rec'
    (the recurrent kernel)."""
    return "chunk" if S <= CHUNK else "rec"


# Route of a ``wkv6_scan_mt_jvps`` launch: the chunked tangent kernel with a
# contraction finish for S <= CHUNK, else the recurrent kernel
wkv6_jvps_path = wkv6_mt_path


def wkv6_scan_ref(r, k, v, w, u, state=None):
    """Plain version (port of ``ref.wkv6_scan_ref``): r, k, v, w (B,S,H,hd);
    u (H,hd); state (B,H,hd,hd) or None (zeros). Returns (y (B,S,H,hd),
    final state)."""
    B, S, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, ..., None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_scan_mt_ref(r, k, v, w, u, rds, kds, vds, wds, uds=None):
    """Plain version (port of ``ref.wkv6_scan_mt_ref``): (y, ydots) with the
    T tangents as independent jvps of the plain primal (uds None: u carries
    no tangent)."""
    y = wkv6_scan_ref(r, k, v, w, u)[0]
    if uds is None:
        uds = torch.zeros((rds.shape[0],) + u.shape, dtype=torch.float32,
                          device=u.device)

    def one(rd, kd, vd, wd, ud):
        return torch.func.jvp(lambda *p: wkv6_scan_ref(*p)[0],
                              (r, k, v, w, u), (rd, kd, vd, wd, ud))[1]
    return y, torch.func.vmap(one)(rds, kds, vds, wds, uds)


def wkv6_chunked_ref(r, k, v, w, u, rds=None, kds=None, vds=None, wds=None,
                     uds=None, *, chunk=32):
    """Plain version of the chunked form the S <= 32 multi-tangent kernel
    computes, for the tests and chip_smoke: y, or (y, ydots) with tangents
    (uds None: u carries no tangent). Per chunk of ``chunk`` tokens s, s'
    (chunk-local) and channel c: L_c[s][s'] = w_{s-1} ... w_{s'+1} for
    s' < s, built by running products down each column in the
    recurrence's order (L_c[s'+1][s'] = 1; no logs, ratios or division);
    A[s][s'] = sum_c r_s k_s' L_c[s][s'] with the bonus a_s = sum_c r_s u
    k_s on the diagonal; y = A v. Per tangent, by the product rule,
    Ld_c[s+1][s'] = w_s Ld_c[s][s'] + wd_s L_c[s][s'], Ad = sum_c (rd k L +
    r kd L + r k Ld), ad_s = sum_c (u (rd_s k_s + r_s kd_s) + ud r_s k_s),
    yd = Ad v + A vd. The terms are formed in fp32; A, Ad and everything
    after them are summed in fp64. The (hd, hd) state and its tangents
    carry from chunk to chunk in fp64: row s of a chunk reads r_s^T
    diag(Lc_s) S with Lc_s = w_{s-1} ... w_0 of the chunk."""
    B, S, H, hd = r.shape
    tang = rds is not None
    T = rds.shape[0] if tang else 0
    f64 = torch.float64

    def heads(x):                      # (..., B, S, H, hd) -> (..., B, H, S, hd)
        return x.transpose(-3, -2)

    def csum(x):                       # fp32 terms summed over c in fp64
        return x.to(f64).sum(-1)

    pr = tuple(map(heads, (r, k, v, w)))
    tg = tuple(map(heads, (rds, kds, vds, wds))) if tang else None
    uu = u[None, :, None, :]                               # (1,H,1,hd)
    ud = None if uds is None else uds[:, None, :, None, :]  # (T,1,H,1,hd)
    st = r.new_zeros((B, H, hd, hd), dtype=f64)
    std = r.new_zeros((T, B, H, hd, hd), dtype=f64)
    ys, yds = [], []
    for s0 in range(0, S, chunk):
        q = min(chunk, S - s0)
        rr, kk, vv, ww = (x[..., s0:s0 + q, :] for x in pr)           # (B,H,q,hd)
        eye = torch.eye(q, dtype=r.dtype, device=r.device)[..., None]  # (q,q,1)
        col, lc = torch.zeros_like(rr), torch.ones_like(rr[..., 0, :])
        L, Lc = [], []
        if tang:
            rdd, kdd, vdd, wdd = (x[..., s0:s0 + q, :] for x in tg)   # (T,B,H,q,hd)
            dcol, dlc = torch.zeros_like(rdd), torch.zeros_like(rdd[..., 0, :])
            Ld, Lcd = [], []
        for s in range(q):              # row s: col[s'] = L_c[s][s'], lc = Lc_s
            L.append(col)
            Lc.append(lc)
            if tang:
                Ld.append(dcol)
                Lcd.append(dlc)
                dcol = ww[..., s, None, :] * dcol + wdd[..., s, None, :] * col
                dlc = ww[..., s, :] * dlc + wdd[..., s, :] * lc
            col = ww[..., s, None, :] * col + eye[s]   # column s starts at 1
            lc = ww[..., s, :] * lc
        L, Lc = torch.stack(L, -3), torch.stack(Lc, -2)   # (B,H,q,q,hd), (B,H,q,hd)
        kL = kk[..., None, :, :] * L
        A = csum(rr[..., :, None, :] * kL) + torch.diag_embed(csum(rr * uu * kk))
        vv64 = vv.to(f64)
        ys.append(A @ vv64 + (rr * Lc).to(f64) @ st)
        if tang:
            Ld, Lcd = torch.stack(Ld, -3), torch.stack(Lcd, -2)
            ad = uu * (rdd * kk + rr * kdd)
            if ud is not None:
                ad = ad + ud * (rr * kk)
            Ad = csum(rdd[..., :, None, :] * kL + rr[..., :, None, :]
                      * (kdd[..., None, :, :] * L + kk[..., None, :, :] * Ld))
            Ad = Ad + torch.diag_embed(csum(ad))
            yds.append(Ad @ vv64 + A @ vdd.to(f64)
                       + (rdd * Lc + rr * Lcd).to(f64) @ st
                       + (rr * Lc).to(f64) @ std)
            std = (dlc.to(f64)[..., None] * st + lc.to(f64)[..., None] * std
                   + (kdd * col + kk * dcol).to(f64).transpose(-1, -2) @ vv64
                   + (kk * col).to(f64).transpose(-1, -2) @ vdd.to(f64))
        st = (lc.to(f64)[..., None] * st
              + (kk * col).to(f64).transpose(-1, -2) @ vv64)
    y = heads(torch.cat(ys, dim=-2)).float()
    return (y, heads(torch.cat(yds, dim=-2)).float()) if tang else y


def wkv6_scan_mt_jvps_ref(r, k, v, w, u, rds, kds, vds, wds, gy, uds=None):
    """Plain version (port of ``ref.wkv6_scan_mt_jvps_ref``): materializes
    the T tangents and contracts them with gy in fp32 -> (T,)."""
    yds = wkv6_scan_mt_ref(r, k, v, w, u, rds, kds, vds, wds, uds)[1]
    return torch.einsum("bshd,tbshd->t", gy.float(), yds.float())


def wkv6_scan_mt_jvps_chunked_ref(r, k, v, w, u, rds, kds, vds, wds, gy,
                                  uds=None):
    """Plain version of the chunk route's contraction, for the tests: the
    chunked form's tangents (``wkv6_chunked_ref``) in fp32, contracted with
    gy in fp64 and rounded once to fp32 -> (T,)."""
    yds = wkv6_chunked_ref(r, k, v, w, u, rds, kds, vds, wds, uds)[1]
    return torch.einsum("bshd,tbshd->t", gy.double(), yds.float().double()).float()


def _f32(*ts):
    """The reference's layout casts: every operand fp32 and contiguous."""
    return tuple(None if t is None else t.float().contiguous() for t in ts)


# (library, pointers, ints), then the stream
_ARGS = {"wkv6_scan_fwd": ("wkv6_scan", 6, 4),
         "wkv6_scan_mt_tangents": ("wkv6_scan", 11, 5),
         "wkv6_chunk_tangents": ("wkv6_chunk", 11, 5),
         "wkv6_scan_mt_jvps": ("wkv6_scan", 13, 5),
         "wkv6_chunk_jvps": ("wkv6_chunk", 13, 5)}


def _fn(symbol):
    lib, n_ptr, n_int = _ARGS[symbol]
    fn = getattr(build.load(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(what, r, k, v, w, u, more=()):
    """Device, dtype, contiguity and shapes the kernels take; returns
    (B, S, H, hd)."""
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError(f"{what}: r must be (B,S,H,hd) and u (H,hd)")
    B, S, H, hd = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)) + tuple(more):
        if t.device != r.device:
            raise ValueError(f"{what}: {name} on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernels take fp32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape or \
            u.shape != (H, hd):
        raise ValueError(f"{what}: r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)} u{tuple(u.shape)} "
                         f"do not agree")
    if not 1 <= hd <= HD_MAX or B * H * ((hd + 31) // 32) > 2 ** 31 - 1:
        raise ValueError(f"{what}: needs 1 <= hd <= {HD_MAX} (hd={hd})")
    return B, S, H, hd


def _check_tangents(what, r, k, v, w, u, rds, kds, vds, wds, uds, extra=()):
    more = (("rds", rds), ("kds", kds), ("vds", vds), ("wds", wds)) + tuple(extra)
    if uds is not None:
        more += (("uds", uds),)
    dims = _check(what, r, k, v, w, u, more)
    T = rds.shape[0]
    if any(t.shape != (T,) + r.shape for t in (rds, kds, vds, wds)) or (
            uds is not None and uds.shape != (T,) + u.shape):
        raise ValueError(f"{what}: tangent stacks must be (T,)+primal shape")
    if not 1 <= T <= 65535:
        raise ValueError(f"{what}: needs 1 <= T <= 65535, got {T}")
    return dims + (T,)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def wkv6_scan(r, k, v, w, u):
    """y (B,S,H,hd) fp32 of the recurrence from a fresh state."""
    r, k, v, w, u = _f32(r, k, v, w, u)
    if r.device.type == "cpu":
        out = wkv6_scan_ref(r, k, v, w, u)[0]
        if calls.recording is not None:
            calls.record("wkv6_scan", "plain", (r, k, v, w, u), out)
        return out
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan: unsupported device {r.device}")
    B, S, H, hd = _check("wkv6_scan", r, k, v, w, u)
    y = torch.empty_like(r)
    if y.numel() == 0:
        return y
    err = _fn("wkv6_scan_fwd")(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                               w.data_ptr(), u.data_ptr(), y.data_ptr(),
                               B, S, H, hd, _stream(r))
    build.check(err, "wkv6_scan")
    launches["wkv6_scan"] += 1
    if calls.recording is not None:
        calls.record("wkv6_scan", "cuda", (r, k, v, w, u), y)
    return y


def wkv6_scan_mt_tangents(r, k, v, w, u, rds, kds, vds, wds, uds=None):
    """Tangent-only multi-tangent pass: rds..wds (T,B,S,H,hd), uds (T,H,hd)
    or None -> ydots (T,B,S,H,hd). The primal's pieces (A, or the state
    walk on the recurrent route) are formed inside the kernel but y is not
    written. The route is ``wkv6_mt_path(S)``."""
    r, k, v, w, u, rds, kds, vds, wds, uds = _f32(r, k, v, w, u, rds, kds, vds,
                                                  wds, uds)
    if r.device.type == "cpu":
        out = wkv6_scan_mt_ref(r, k, v, w, u, rds, kds, vds, wds, uds)[1]
        if calls.recording is not None:
            calls.record("wkv6_scan_mt", "plain", (r, k, v, w, u, rds, kds, vds, wds, uds),
                         out)
        return out
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan_mt_tangents: unsupported device {r.device}")
    B, S, H, hd, T = _check_tangents("wkv6_scan_mt_tangents", r, k, v, w, u,
                                     rds, kds, vds, wds, uds)
    out = torch.empty_like(rds)
    if out.numel() == 0:
        return out
    path = wkv6_mt_path(S)
    symbol = "wkv6_chunk_tangents" if path == "chunk" else "wkv6_scan_mt_tangents"
    err = _fn(symbol)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        rds.data_ptr(), kds.data_ptr(), vds.data_ptr(), wds.data_ptr(),
        _ptr(uds), out.data_ptr(), B, S, H, hd, T, _stream(r))
    build.check(err, "wkv6_scan_mt_tangents")
    launches["wkv6_scan_mt"] += 1
    launches_by_path["wkv6_scan_mt"][path] += 1
    if calls.recording is not None:
        calls.record("wkv6_scan_mt", path, (r, k, v, w, u, rds, kds, vds, wds, uds), out)
    return out


def _parts(path, B, S, H, hd):
    """(per-block partials a contraction launch of route ``path`` writes
    for each tangent, their dtype), from the route's own library."""
    if path == "chunk":
        lib, symbol, dtype, dims = ("wkv6_chunk", "wkv6_chunk_jvps_parts",
                                    torch.float64, (B, S, H, hd))
    else:
        lib, symbol, dtype, dims = ("wkv6_scan", "wkv6_scan_mt_jvps_parts",
                                    torch.float32, (B, H, hd))
    fn = getattr(build.load(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(dims)
        fn.restype = ctypes.c_longlong
    n = fn(*dims)
    if n < 1:
        raise ValueError(f"wkv6_scan_mt_jvps: route {path} does not take {dims}")
    return n, dtype


def wkv6_scan_mt_jvps(r, k, v, w, u, rds, kds, vds, wds, gy, uds=None):
    """jvps (T,) fp32 = <gy, ydot_t>: operands as ``wkv6_scan_mt_tangents``
    plus the output cotangent gy (B,S,H,hd); no (T,B,S,H,hd) output is
    formed. The route is ``wkv6_jvps_path(S)``."""
    r, k, v, w, u, rds, kds, vds, wds, gy, uds = _f32(r, k, v, w, u, rds, kds,
                                                      vds, wds, gy, uds)
    if r.device.type == "cpu":
        out = wkv6_scan_mt_jvps_ref(r, k, v, w, u, rds, kds, vds, wds, gy, uds)
        if calls.recording is not None:
            calls.record("wkv6_scan_mt_jvps", "plain",
                         (r, k, v, w, u, rds, kds, vds, wds, gy, uds), out)
        return out
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan_mt_jvps: unsupported device {r.device}")
    B, S, H, hd, T = _check_tangents("wkv6_scan_mt_jvps", r, k, v, w, u, rds,
                                     kds, vds, wds, uds, (("gy", gy),))
    if gy.shape != r.shape:
        raise ValueError(f"wkv6_scan_mt_jvps: gy{tuple(gy.shape)} is not "
                         f"r{tuple(r.shape)}")
    path = wkv6_jvps_path(S)
    if r.numel() == 0:
        return torch.zeros(T, dtype=torch.float32, device=r.device)
    n, dtype = _parts(path, B, S, H, hd)
    parts = torch.empty((T, n), dtype=dtype, device=r.device)
    jvps = torch.empty(T, dtype=torch.float32, device=r.device)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            rds.data_ptr(), kds.data_ptr(), vds.data_ptr(), wds.data_ptr(),
            _ptr(uds), gy.data_ptr(), parts.data_ptr(), jvps.data_ptr())
    if path == "chunk":
        err = _fn("wkv6_chunk_jvps")(*ptrs, B, S, H, hd, T, _stream(r))
    else:
        err = _fn("wkv6_scan_mt_jvps")(*ptrs, B, S, H, hd, T, _stream(r))
    build.check(err, "wkv6_scan_mt_jvps")
    launches["wkv6_scan_mt_jvps"] += 1
    launches_by_path["wkv6_scan_mt_jvps"][path] += 1
    if calls.recording is not None:
        calls.record("wkv6_scan_mt_jvps", path,
                     (r, k, v, w, u, rds, kds, vds, wds, gy, uds), (jvps, parts))
    return jvps
