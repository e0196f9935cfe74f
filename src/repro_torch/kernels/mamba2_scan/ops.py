"""Mamba2 state recurrence from a fresh state: primal, T stacked jvp
tangents in one pass, and the same tangents contracted against an output
cotangent (the jvp-contraction epilogue).

    h_s = d_s h_{s-1} + xdt_s B_s^T     (per head, h in R^{hd x N})
    y_s = h_s C_s

``xdt`` is the dt-premultiplied input xh * dt. Per tangent the recurrence
carries hd_s = dd_s h_{s-1} + d_s hd_{s-1} + xdtd_s B_s^T + xdt_s Bd_s^T
and emits yd_s = hd_s C_s + h_s Cd_s.

Replaces three TPU kernels of ``repro/kernels/mamba2_scan/kernel.py``:
``mamba2_scan_kernel`` (every mamba2 layer's primal inside the estimator,
``csrc/mamba2_scan.cu``), ``mamba2_scan_mt_kernel`` in its
``emit_primal=False`` route (all K tangents of every mamba2 layer,
``csrc/mamba2_ssd.cu``) and ``mamba2_scan_mt_jvps_kernel`` (the hybrid
family's final site on the fused route: ``csrc/mamba2_ssd.cu`` at S <= 32,
``csrc/mamba2_scan.cu`` above). Layouts are the reference's public ones: xdt
(B,S,H,hd), B/C (B,S,N), decay (B,S,H), and tangents with a leading T.
Every operand is fp32 (the reference's ``ops._layout`` casts them all), so
the kernels take and give fp32 only.

The tangents use the chunked state-space-dual form (``mamba2_chunked_ref``
below is its plain version): inside a chunk of 32 tokens y = (L o C B^T) x
with L[s, s'] the product of the decays in (s', s], built as running
products; a tangent is y' = (Ld o G + L o Gd) x + (L o G) xd with Ld by
the product rule, and the (hd, N) state carries from chunk to chunk. At
zamba2's shapes that form needs 0.58 GFLOP for T = 8 against 6.1 in the
recurrent one, all of it matrix products, which run on the fp64 tensor
cores (fp32 operands exact in fp64, sums rounded to nearest; 3xTF32 on the
tf32 units rounds its sums toward zero and missed the card-vs-CPU limits).
What is left bounds the pass by bytes: its 73 MB are mostly the T tangent
inputs and outputs. So a block serves several heads of one batch row,
computes G = C B^T once and each Gd once for all of them (in fp64: they
serve every output of the row), keeps L and Ld in shared memory, stages x,
B, C once and double-buffers each tangent's xd, Bd, Cd and dd with
asynchronous copies, and writes yd as coalesced rows.

The primal keeps the recurrence, one thread a state row with its N columns
in registers, in the reference's order of fp32 operations: the estimator's
card-vs-CPU parity follows the primal's rounding, and the reference rounds
the state at every token (a primal exact in fp64 misses the zamba2 limit:
``scripts/parity_plain_on_card.py``, PERF.md). The contraction epilogue
takes a route by sequence length (``mamba2_jvps_path``): at S <= 32, every
main-path launch, the tangent pass's chunked kernel with a contraction
finish in place of the yd store (route ``chunk``): each accumulator rounded
to fp32, so the tangents contracted are bitwise the ones the tangent pass
stores, times gy in fp64, summed in a fixed order into one fp64 partial
per (tangent, block), which a one-warp kernel sums in a fixed order and
rounds once to fp32 (``mamba2_scan_mt_jvps_chunked_ref`` is its plain
version). Longer S keep the recurrent kernel of the first port (route
``rec``: one warp a state row, fp32 partials); carrying the chunk state
through the contraction is not written yet. No route uses atomics, and in
every kernel a tangent runs the same instruction sequence for any T, so a
T=8 launch equals eight T=1 launches bit for bit. N <= 128.

CPU tensors take the plain versions below; CUDA tensors launch a kernel
or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, calls

N_MAX = 128
CHUNK = 32          # tokens of the chunked contraction route; longer S: recurrent
launches = {"mamba2_scan": 0, "mamba2_scan_mt": 0, "mamba2_scan_mt_jvps": 0}
launches_by_path = {"mamba2_scan_mt_jvps": {"chunk": 0, "rec": 0}}


def mamba2_jvps_path(S):
    """Route of a ``mamba2_scan_mt_jvps`` launch: 'chunk' (the chunked
    tangent kernel with a contraction finish, one chunk) for S <= CHUNK,
    else 'rec' (the recurrent kernel)."""
    return "chunk" if S <= CHUNK else "rec"


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


def mamba2_chunked_ref(xdt, bmat, cmat, decay, xdtds=None, bds=None, cds=None,
                       decayds=None, chunk=32):
    """Plain version of the chunked state-space-dual form the multi-tangent
    CUDA kernel computes, for the tests: y, or (y, ydots) with tangents. Per chunk of
    ``chunk`` tokens, G = C B^T; L[s, s'] = d_s L[s-1, s'] with L[s', s'] = 1
    (running products); Ld[s, s'] = d_s Ld[s-1, s'] + dd_s L[s-1, s'] with
    Ld[s', s'] = 0; y = (L o G) x + Lc C h^T with Lc_s = d_0 .. d_s, and the
    state h (B,H,hd,N) and its tangents carried to the next chunk."""
    B, S, H, hd = xdt.shape
    N = bmat.shape[-1]
    tang = xdtds is not None
    T = xdtds.shape[0] if tang else 0
    h = xdt.new_zeros((B, H, hd, N))
    hdt = xdt.new_zeros((T, B, H, hd, N))
    ys, yds = [], []
    for s0 in range(0, S, chunk):
        q = min(chunk, S - s0)
        x, bm, cm = xdt[:, s0:s0 + q], bmat[:, s0:s0 + q], cmat[:, s0:s0 + q]
        d = decay[:, s0:s0 + q].transpose(1, 2)                  # (B,H,q)
        G = torch.einsum("bsn,bun->bsu", cm, bm)[:, None]        # (B,1,q,q)
        if tang:
            xd, bd, cd = (xdtds[:, :, s0:s0 + q], bds[:, :, s0:s0 + q],
                          cds[:, :, s0:s0 + q])
            dd = decayds[:, :, s0:s0 + q].transpose(2, 3)        # (T,B,H,q)
            Gd = (torch.einsum("zbsn,bun->zbsu", cd, bm)
                  + torch.einsum("bsn,zbun->zbsu", cm, bd))[:, :, None]
        eye = torch.eye(q, dtype=xdt.dtype, device=xdt.device)
        row, drow = xdt.new_zeros((B, H, q)), xdt.new_zeros((T, B, H, q))
        lc, lcd = xdt.new_ones((B, H)), xdt.new_zeros((T, B, H))
        L, Ld, Lc, Lcd = [], [], [], []
        for s in range(q):                                       # running products
            if tang:
                drow = d[..., s, None] * drow + dd[..., s, None] * row
                drow = drow * (1 - eye[s])
                lcd = d[..., s] * lcd + dd[..., s] * lc
                Ld.append(drow)
                Lcd.append(lcd)
            row = d[..., s, None] * row * (1 - eye[s]) + eye[s]
            lc = d[..., s] * lc
            L.append(row)
            Lc.append(lc)
        L, Lc = torch.stack(L, -2), torch.stack(Lc, -1)          # (B,H,q,q), (B,H,q)
        M = L * G
        y = (torch.einsum("bhsu,buhi->bshi", M, x)
             + torch.einsum("bhs,bhin,bsn->bshi", Lc, h, cm))
        if tang:
            Ld, Lcd = torch.stack(Ld, -2), torch.stack(Lcd, -1)
            yd = (torch.einsum("zbhsu,buhi->zbshi", Ld * G + L * Gd, x)
                  + torch.einsum("bhsu,zbuhi->zbshi", M, xd)
                  + torch.einsum("zbhs,bhin,bsn->zbshi", Lcd, h, cm)
                  + torch.einsum("bhs,bhin,zbsn->zbshi", Lc, h, cd)
                  + torch.einsum("bhs,zbhin,bsn->zbshi", Lc, hdt, cm))
            yds.append(yd)
            hdt = (Lcd[..., -1, None, None] * h + Lc[..., -1, None, None] * hdt
                   + torch.einsum("bhu,zbuhi,bun->zbhin", L[..., -1, :], xd, bm)
                   + torch.einsum("zbhu,buhi,bun->zbhin", Ld[..., -1, :], x, bm)
                   + torch.einsum("bhu,buhi,zbun->zbhin", L[..., -1, :], x, bd))
        h = (Lc[..., -1, None, None] * h
             + torch.einsum("bhu,buhi,bun->bhin", L[..., -1, :], x, bm))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return (y, torch.cat(yds, dim=2)) if tang else y


def mamba2_scan_mt_jvps_ref(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds,
                            gy):
    """Plain version (port of ``ref.mamba2_scan_mt_jvps_ref``): materializes
    the T tangents and contracts them with gy in fp32 -> (T,)."""
    yds = mamba2_scan_mt_ref(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds)[1]
    return torch.einsum("bshd,tbshd->t", gy.float(), yds.float())


def mamba2_scan_mt_jvps_chunked_ref(xdt, bmat, cmat, decay, xdtds, bds, cds,
                                    decayds, gy):
    """Plain version of the chunk route's contraction, for the tests: the
    chunked form's tangents (``mamba2_chunked_ref``) in fp32, contracted
    with gy in fp64 and rounded once to fp32 -> (T,)."""
    yds = mamba2_chunked_ref(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds)[1]
    return torch.einsum("bshd,tbshd->t", gy.double(), yds.float().double()).float()


# (library, pointers, ints), then the stream
_ARGS = {"mamba2_scan_fwd": ("mamba2_scan", 5, 5),
         "mamba2_scan_mt_tangents": ("mamba2_ssd", 9, 6),
         "mamba2_scan_mt_jvps": ("mamba2_scan", 11, 6),
         "mamba2_ssd_jvps": ("mamba2_ssd", 11, 6)}


def _fn(symbol):
    lib, n_ptr, n_int = _ARGS[symbol]
    fn = getattr(build.load(lib), symbol)
    if fn.argtypes is None:
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
        out = mamba2_scan_ref(xdt, bmat, cmat, decay)[0]
        if calls.recording is not None:
            calls.record("mamba2_scan", "plain", (xdt, bmat, cmat, decay), out)
        return out
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
    if calls.recording is not None:
        calls.record("mamba2_scan", "cuda", (xdt, bmat, cmat, decay), y)
    return y


def mamba2_scan_mt_tangents(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds):
    """Tangent-only multi-tangent pass: xdtds (T,B,S,H,hd); bds, cds
    (T,B,S,N); decayds (T,B,S,H) -> ydots (T,B,S,H,hd). The primal's
    pieces (L, G, the carried state) are formed inside the kernel but y is
    not written."""
    if xdt.device.type == "cpu":
        out = mamba2_scan_mt_ref(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds)[1]
        if calls.recording is not None:
            calls.record("mamba2_scan_mt", "plain",
                         (xdt, bmat, cmat, decay, xdtds, bds, cds, decayds), out)
        return out
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
    if calls.recording is not None:
        calls.record("mamba2_scan_mt", "cuda",
                     (xdt, bmat, cmat, decay, xdtds, bds, cds, decayds), out)
    return out


def _parts(path, B, S, H, hd, N):
    """(per-block partials a contraction launch of route ``path`` writes
    for each tangent, their dtype), from the route's own library."""
    if path == "chunk":
        lib, symbol, dtype, dims = ("mamba2_ssd", "mamba2_ssd_jvps_parts",
                                    torch.float64, (B, S, H, hd, N))
    else:
        lib, symbol, dtype, dims = ("mamba2_scan", "mamba2_scan_mt_jvps_parts",
                                    torch.float32, (B, H, hd))
    fn = getattr(build.load(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(dims)
        fn.restype = ctypes.c_longlong
    n = fn(*dims)
    if n < 1:
        raise ValueError(f"mamba2_scan_mt_jvps: route {path} does not take {dims}")
    return n, dtype


def mamba2_scan_mt_jvps(xdt, bmat, cmat, decay, xdtds, bds, cds, decayds, gy):
    """jvps (T,) fp32 = <gy, ydot_t>: operands as ``mamba2_scan_mt_tangents``
    plus the output cotangent gy (B,S,H,hd); no (T,B,S,H,hd) output is
    formed. The route is ``mamba2_jvps_path(S)``."""
    if xdt.device.type == "cpu":
        out = mamba2_scan_mt_jvps_ref(xdt, bmat, cmat, decay, xdtds, bds, cds,
                                      decayds, gy)
        if calls.recording is not None:
            calls.record("mamba2_scan_mt_jvps", "plain",
                         (xdt, bmat, cmat, decay, xdtds, bds, cds, decayds, gy), out)
        return out
    if xdt.device.type != "cuda":
        raise ValueError(f"mamba2_scan_mt_jvps: unsupported device {xdt.device}")
    B, S, H, hd, N, T = _check_tangents("mamba2_scan_mt_jvps", xdt, bmat, cmat,
                                        decay, xdtds, bds, cds, decayds,
                                        (("gy", gy),))
    if gy.shape != xdt.shape:
        raise ValueError(f"mamba2_scan_mt_jvps: gy{tuple(gy.shape)} is not "
                         f"xdt{tuple(xdt.shape)}")
    path = mamba2_jvps_path(S)
    if xdt.numel() == 0:
        return torch.zeros(T, dtype=torch.float32, device=xdt.device)
    n, dtype = _parts(path, B, S, H, hd, N)
    parts = torch.empty((T, n), dtype=dtype, device=xdt.device)
    jvps = torch.empty(T, dtype=torch.float32, device=xdt.device)
    ptrs = (xdt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), decay.data_ptr(),
            xdtds.data_ptr(), bds.data_ptr(), cds.data_ptr(), decayds.data_ptr(),
            gy.data_ptr(), parts.data_ptr(), jvps.data_ptr())
    if path == "chunk":
        err = _fn("mamba2_ssd_jvps")(*ptrs, B, S, H, hd, N, T, _stream(xdt))
    else:
        err = _fn("mamba2_scan_mt_jvps")(*ptrs, B, S, H, hd, N, T, _stream(xdt))
    build.check(err, "mamba2_scan_mt_jvps")
    launches["mamba2_scan_mt_jvps"] += 1
    launches_by_path["mamba2_scan_mt_jvps"][path] += 1
    if calls.recording is not None:
        calls.record("mamba2_scan_mt_jvps", path,
                     (xdt, bmat, cmat, decay, xdtds, bds, cds, decayds, gy), (jvps, parts))
    return jvps
