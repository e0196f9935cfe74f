"""Mamba2 state recurrence from a fresh state: primal, T stacked jvp
tangents in one walk, and the same walk contracted against an output
cotangent (the jvp-contraction epilogue).

    h_s = d_s h_{s-1} + xdt_s B_s^T     (per head, h in R^{hd x N})
    y_s = h_s C_s

``xdt`` is the dt-premultiplied input xh * dt. Per tangent the walk
carries hd_s = dd_s h_{s-1} + d_s hd_{s-1} + xdtd_s B_s^T + xdt_s Bd_s^T and
emits yd_s = hd_s C_s + h_s Cd_s.

Replaces three TPU kernels of ``repro/kernels/mamba2_scan/kernel.py``:
``mamba2_scan_kernel`` (every mamba2 layer's primal inside the estimator),
``mamba2_scan_mt_kernel`` in its ``emit_primal=False`` route (all K
tangents of every mamba2 layer) and ``mamba2_scan_mt_jvps_kernel`` (the
hybrid family's final site on the fused route). Layouts are the
reference's public ones: xdt (B,S,H,hd), B/C (B,S,N), decay (B,S,H), and
tangents with a leading T. Every operand is fp32 (the reference's
``ops._layout`` casts them all), so the kernels take and give fp32 only.

On the H100 the work is bound by operations: per (b*h, token) the primal
does 5 hd N flops (3 for the state update, 2 for the readout, which the
tangent modes skip) and each tangent 11 hd N, so at the main path's
hd = N = 64, T = 8 the tangent modes do about 0.37 MFLOP of fp32 that no
tensor core takes (a rank-1 update and a mat-vec per token); the tangent
output (T x the input) is the largest byte count. The TPU kernel keeps one
(hd, N) state per (b*h) row and T tangent states in VMEM, 144 KiB at T=8,
more than a block's shared memory beside anything else. The CUDA kernel
(``csrc/mamba2_scan.cu``) splits the state by rows instead: row i of h
depends on x_s[i] alone, so one warp owns a row, its lanes hold the row's
N columns, and the primal and TC tangent rows stay in registers (2 (TC+1)
floats a lane at N = 64); y_s[i] is one warp reduction. A block takes 16
rows of one batch row and stages each 8-token chunk of B/C (and Bd/Cd),
shared by every head of the batch row, once in shared memory with its
rows' x, d, xd, dd, gy; outputs leave through shared memory as coalesced
rows. Tangents go in chunks of TC <= 8 over grid.z, each chunk redoing the
primal walk rather than spilling. The contraction writes one fp32 partial
per (tangent, block) in a fixed order and a second small kernel sums them
in a fixed order: no atomics, the same jvps on every run, and every lane
runs the same instruction sequence for any T (explicit fma intrinsics),
so a T=8 launch equals eight T=1 launches bit for bit. N <= 128.

CPU tensors take the plain versions below; CUDA tensors launch a kernel
or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

N_MAX = 128
launches = {"mamba2_scan": 0, "mamba2_scan_mt": 0, "mamba2_scan_mt_jvps": 0}


def mamba2_scan_ref(xdt, bmat, cmat, decay, state=None):
    """Plain version (port of ``ref.mamba2_scan_ref``): xdt (B,S,H,hd);
    bmat, cmat (B,S,N); decay (B,S,H); state (B,H,hd,N) or None (zeros).
    Returns (y (B,S,H,hd), final state)."""
    B, S, H, hd = xdt.shape
    N = bmat.shape[-1]
    h = (torch.zeros((B, H, hd, N), dtype=torch.float32, device=xdt.device)
         if state is None else state)
    ys = []
    for s in range(S):
        upd = torch.einsum("bhi,bn->bhin", xdt[:, s], bmat[:, s])
        h = decay[:, s, :, None, None] * h + upd
        ys.append(torch.einsum("bhin,bn->bhi", h, cmat[:, s]))
    return torch.stack(ys, dim=1), h


def mamba2_scan_mt_ref(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds):
    """Plain version (port of ``ref.mamba2_scan_mt_ref``): (y, ydots) with
    the T tangents as independent jvps of the plain primal."""
    y = mamba2_scan_ref(xdt, bmat, cmat, decay)[0]

    def one(xd, bd, cd, dd):
        return torch.func.jvp(lambda *p: mamba2_scan_ref(*p)[0],
                              (xdt, bmat, cmat, decay), (xd, bd, cd, dd))[1]
    return y, torch.func.vmap(one)(xdtds, bds, cds, decayds)


def mamba2_scan_mt_jvps_ref(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds,
                            gy):
    """Plain version (port of ``ref.mamba2_scan_mt_jvps_ref``): materializes
    the T tangents and contracts them with gy in fp32 -> (T,)."""
    yds = mamba2_scan_mt_ref(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds)[1]
    return torch.einsum("bshd,tbshd->t", gy.float(), yds.float())


_ARGS = {"mamba2_scan_fwd": (5, 5), "mamba2_scan_mt_tangents": (9, 6),
         "mamba2_scan_mt_jvps": (11, 6)}        # (pointers, ints), then the stream


def _fn(symbol):
    fn = getattr(build.load("mamba2_scan"), symbol)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGS[symbol]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(what, xdt, bmat, cmat, decay, more=()):
    """Device, dtype, contiguity and shapes the kernels take; returns
    (B, S, H, hd, N)."""
    if xdt.dim() != 4 or bmat.dim() != 3:
        raise ValueError(f"{what}: xdt must be (B,S,H,hd) and bmat (B,S,N)")
    B, S, H, hd = xdt.shape
    N = bmat.shape[-1]
    for name, t in (("xdt", xdt), ("bmat", bmat), ("cmat", cmat),
                    ("decay", decay)) + tuple(more):
        if t.device != xdt.device:
            raise ValueError(f"{what}: {name} on {t.device}, xdt on {xdt.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernels take fp32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if bmat.shape != (B, S, N) or cmat.shape != (B, S, N) or \
            decay.shape != (B, S, H):
        raise ValueError(f"{what}: xdt{tuple(xdt.shape)} bmat{tuple(bmat.shape)} "
                         f"cmat{tuple(cmat.shape)} decay{tuple(decay.shape)} "
                         f"do not agree")
    if not 1 <= N <= N_MAX or B > 65535 or H * hd > 2 ** 31 - 64:
        raise ValueError(f"{what}: needs 1 <= N <= {N_MAX} (N={N}), B <= 65535")
    return B, S, H, hd, N


def _check_tangents(what, xdt, bmat, cmat, decay, xdtds, bds, cds, decayds,
                    extra=()):
    dims = _check(what, xdt, bmat, cmat, decay,
                  (("xdtds", xdtds), ("bds", bds), ("cds", cds),
                   ("decayds", decayds)) + tuple(extra))
    T = xdtds.shape[0]
    if (xdtds.shape[1:] != xdt.shape or bds.shape[1:] != bmat.shape
            or cds.shape[1:] != cmat.shape or decayds.shape[1:] != decay.shape
            or not bds.shape[0] == cds.shape[0] == decayds.shape[0] == T):
        raise ValueError(f"{what}: tangent stacks must be (T,)+primal shape")
    if not 1 <= T <= 65535 * 8:
        raise ValueError(f"{what}: needs 1 <= T <= {65535 * 8}, got {T}")
    return dims + (T,)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def mamba2_scan(xdt, bmat, cmat, decay):
    """y (B,S,H,hd) fp32 of the recurrence from a fresh state."""
    if xdt.device.type == "cpu":
        return mamba2_scan_ref(xdt, bmat, cmat, decay)[0]
    if xdt.device.type != "cuda":
        raise ValueError(f"mamba2_scan: unsupported device {xdt.device}")
    B, S, H, hd, N = _check("mamba2_scan", xdt, bmat, cmat, decay)
    y = torch.empty_like(xdt)
    if y.numel() == 0:
        return y
    err = _fn("mamba2_scan_fwd")(
        xdt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), decay.data_ptr(),
        y.data_ptr(), B, S, H, hd, N, _stream(xdt))
    build.check(err, "mamba2_scan")
    launches["mamba2_scan"] += 1
    return y


def mamba2_scan_mt_tangents(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds):
    """Tangent-only multi-tangent pass: xdtds (T,B,S,H,hd); bds, cds
    (T,B,S,N); decayds (T,B,S,H) -> ydots (T,B,S,H,hd). The primal walk runs
    inside the kernel (the tangent recurrence needs h) but y is not
    written."""
    if xdt.device.type == "cpu":
        return mamba2_scan_mt_ref(xdt, bmat, cmat, decay, xdtds, bds, cds,
                                  decayds)[1]
    if xdt.device.type != "cuda":
        raise ValueError(f"mamba2_scan_mt_tangents: unsupported device {xdt.device}")
    B, S, H, hd, N, T = _check_tangents("mamba2_scan_mt_tangents", xdt, bmat,
                                        cmat, decay, xdtds, bds, cds, decayds)
    out = torch.empty_like(xdtds)
    if out.numel() == 0:
        return out
    err = _fn("mamba2_scan_mt_tangents")(
        xdt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), decay.data_ptr(),
        xdtds.data_ptr(), bds.data_ptr(), cds.data_ptr(), decayds.data_ptr(),
        out.data_ptr(), B, S, H, hd, N, T, _stream(xdt))
    build.check(err, "mamba2_scan_mt_tangents")
    launches["mamba2_scan_mt"] += 1
    return out


def _parts(B, H, hd):
    """Per-block partials a contraction launch writes for each tangent."""
    fn = build.load("mamba2_scan").mamba2_scan_mt_jvps_parts
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    return fn(B, H, hd)


def mamba2_scan_mt_jvps(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds, gy):
    """jvps (T,) fp32 = <gy, ydot_t>: operands as ``mamba2_scan_mt_tangents``
    plus the output cotangent gy (B,S,H,hd); no (T,B,S,H,hd) output is
    formed."""
    if xdt.device.type == "cpu":
        return mamba2_scan_mt_jvps_ref(xdt, bmat, cmat, decay, xdtds, bds, cds,
                                       decayds, gy)
    if xdt.device.type != "cuda":
        raise ValueError(f"mamba2_scan_mt_jvps: unsupported device {xdt.device}")
    B, S, H, hd, N, T = _check_tangents("mamba2_scan_mt_jvps", xdt, bmat, cmat,
                                        decay, xdtds, bds, cds, decayds,
                                        (("gy", gy),))
    if gy.shape != xdt.shape:
        raise ValueError(f"mamba2_scan_mt_jvps: gy{tuple(gy.shape)} is not "
                         f"xdt{tuple(xdt.shape)}")
    if xdt.numel() == 0:
        return torch.zeros(T, dtype=torch.float32, device=xdt.device)
    parts = torch.empty((T, _parts(B, H, hd)), dtype=torch.float32,
                        device=xdt.device)
    jvps = torch.empty(T, dtype=torch.float32, device=xdt.device)
    err = _fn("mamba2_scan_mt_jvps")(
        xdt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), decay.data_ptr(),
        xdtds.data_ptr(), bds.data_ptr(), cds.data_ptr(), decayds.data_ptr(),
        gy.data_ptr(), parts.data_ptr(), jvps.data_ptr(), B, S, H, hd, N, T,
        _stream(xdt))
    build.check(err, "mamba2_scan_mt_jvps")
    launches["mamba2_scan_mt_jvps"] += 1
    return jvps
