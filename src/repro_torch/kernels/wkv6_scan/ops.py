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

On the H100 the work is bound by operations: per (b*h, token) the primal
walk does 7 hd^2 flops (5 without the readout, which the tangent modes
skip) and each tangent 13 hd^2, none of it a product a tensor core takes
(a rank-1 update and a mat-vec a token). The TPU kernel keeps the (hd, hd)
state and T tangent states in VMEM, 144 KiB at T=8, hd=64. The CUDA
kernel (``csrc/wkv6_scan.cu``) uses that column j of y, S and every Sd
reads only column j of the state: G = 8 lanes own one
value column, each lane hd/8 of its rows, so a column's primal state and
its TC tangent states stay in registers (8 (TC+1) floats a lane at
hd = 64, TC = 8) and y_t[j] is a 3-step shuffle sum. A block takes 32
columns of one (b, h) row and stages each 8-token chunk of r, k, w (and
their tangents), which every column reads, in shared memory with
coalesced loads; outputs leave through shared memory as coalesced rows.
Tangents go in chunks of TC <= 8 over grid.z, each chunk redoing the
primal walk. The contraction multiplies each lane's partial by gy as it
goes and sums the block in a fixed order into one fp32 partial per
(tangent, block); a second small kernel sums those in a fixed order: no
atomics, the same jvps on every run, and every lane runs the same
instruction sequence for any T (explicit fma intrinsics), so a T=8 launch
equals eight T=1 launches bit for bit. hd <= 64.

CPU tensors take the plain versions below; CUDA tensors launch a kernel
or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HD_MAX = 64
launches = {"wkv6_scan": 0, "wkv6_scan_mt": 0, "wkv6_scan_mt_jvps": 0}


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


def wkv6_scan_mt_jvps_ref(r, k, v, w, u, rds, kds, vds, wds, gy, uds=None):
    """Plain version (port of ``ref.wkv6_scan_mt_jvps_ref``): materializes
    the T tangents and contracts them with gy in fp32 -> (T,)."""
    yds = wkv6_scan_mt_ref(r, k, v, w, u, rds, kds, vds, wds, uds)[1]
    return torch.einsum("bshd,tbshd->t", gy.float(), yds.float())


def _f32(*ts):
    """The reference's layout casts: every operand fp32 and contiguous."""
    return tuple(None if t is None else t.float().contiguous() for t in ts)


_ARGS = {"wkv6_scan_fwd": (6, 4), "wkv6_scan_mt_tangents": (11, 5),
         "wkv6_scan_mt_jvps": (13, 5)}        # (pointers, ints), then the stream


def _fn(symbol):
    fn = getattr(build.load("wkv6_scan"), symbol)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGS[symbol]
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
        return wkv6_scan_ref(r, k, v, w, u)[0]
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
    return y


def wkv6_scan_mt_tangents(r, k, v, w, u, rds, kds, vds, wds, uds=None):
    """Tangent-only multi-tangent pass: rds..wds (T,B,S,H,hd), uds (T,H,hd)
    or None -> ydots (T,B,S,H,hd). The primal walk runs inside the kernel
    (the tangent recurrence needs S) but y is not written."""
    r, k, v, w, u, rds, kds, vds, wds, uds = _f32(r, k, v, w, u, rds, kds, vds,
                                                  wds, uds)
    if r.device.type == "cpu":
        return wkv6_scan_mt_ref(r, k, v, w, u, rds, kds, vds, wds, uds)[1]
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan_mt_tangents: unsupported device {r.device}")
    B, S, H, hd, T = _check_tangents("wkv6_scan_mt_tangents", r, k, v, w, u,
                                     rds, kds, vds, wds, uds)
    out = torch.empty_like(rds)
    if out.numel() == 0:
        return out
    err = _fn("wkv6_scan_mt_tangents")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        rds.data_ptr(), kds.data_ptr(), vds.data_ptr(), wds.data_ptr(),
        _ptr(uds), out.data_ptr(), B, S, H, hd, T, _stream(r))
    build.check(err, "wkv6_scan_mt_tangents")
    launches["wkv6_scan_mt"] += 1
    return out


def _parts(B, H, hd):
    """Per-block partials a contraction launch writes for each tangent."""
    fn = build.load("wkv6_scan").wkv6_scan_mt_jvps_parts
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    return fn(B, H, hd)


def wkv6_scan_mt_jvps(r, k, v, w, u, rds, kds, vds, wds, gy, uds=None):
    """jvps (T,) fp32 = <gy, ydot_t>: operands as ``wkv6_scan_mt_tangents``
    plus the output cotangent gy (B,S,H,hd); no (T,B,S,H,hd) output is
    formed."""
    r, k, v, w, u, rds, kds, vds, wds, gy, uds = _f32(r, k, v, w, u, rds, kds,
                                                      vds, wds, gy, uds)
    if r.device.type == "cpu":
        return wkv6_scan_mt_jvps_ref(r, k, v, w, u, rds, kds, vds, wds, gy, uds)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan_mt_jvps: unsupported device {r.device}")
    B, S, H, hd, T = _check_tangents("wkv6_scan_mt_jvps", r, k, v, w, u, rds,
                                     kds, vds, wds, uds, (("gy", gy),))
    if gy.shape != r.shape:
        raise ValueError(f"wkv6_scan_mt_jvps: gy{tuple(gy.shape)} is not "
                         f"r{tuple(r.shape)}")
    if r.numel() == 0:
        return torch.zeros(T, dtype=torch.float32, device=r.device)
    parts = torch.empty((T, _parts(B, H, hd)), dtype=torch.float32,
                        device=r.device)
    jvps = torch.empty(T, dtype=torch.float32, device=r.device)
    err = _fn("wkv6_scan_mt_jvps")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        rds.data_ptr(), kds.data_ptr(), vds.data_ptr(), wds.data_ptr(),
        _ptr(uds), gy.data_ptr(), parts.data_ptr(), jvps.data_ptr(),
        B, S, H, hd, T, _stream(r))
    build.check(err, "wkv6_scan_mt_jvps")
    launches["wkv6_scan_mt_jvps"] += 1
    return jvps
