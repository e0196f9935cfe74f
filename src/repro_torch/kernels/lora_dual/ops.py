"""LoRA multi-tangent projection: the tangent half of y = x@W + s(x@A)@B.

    ydot_t = s * ((x@Adot_t + xdot_t@A) @ B + (x@A) @ Bdot_t) + xdot_t@W

for T stacked tangents (``xdots (T,M,K)`` or None, ``adots (T,K,r)``,
``bdots (T,r,N)`` -> ``(T,M,N)``), its jvp-contraction epilogue
``<gy, ydot_t>`` for T tangents with no (T,M,N) output (second part of
this module), and the serving engine's multi-adapter primal
``y[m] = x[m]@W + s(x[m]@A[idx m])@B[idx m]`` (third part).

Replaces the TPU kernel ``repro/kernels/lora_dual/kernel.py::
lora_dual_mt_kernel`` (body ``_mt_kernel``) in its ``emit_primal=False``
route (``ops.lora_dual_mt_tangents``), the one ``kernels/dispatch.py``
takes for every LoRA projection inside the estimator.

On the H100: with an input tangent the T GEMMs xdot_t@W (2·T·M·K·N
operations) bound the kernel by operations at the main path's shapes; with
none (the first layer) only rank-r work is left and writing the (T,M,N)
output bounds it by bytes. The CUDA kernel (``csrc/lora_dual_mt.cu``) is
one launch over a (N/64, M/64, T) grid: each block accumulates one
tangent's 64x64 output tile in registers (fp32, plain SIMT FMAs) and the
block's rank-r pieces x@A and x@Adot_t + xdot_t@A in shared memory during
the same K loop, then adds the rank-r finish in the epilogue. x, xdot and
W may be fp32 or bf16 (converted on load); the LoRA factors are fp32; the
output is rounded once to x's dtype. Ragged M/N/K edges are masked in the
kernel, never padded in device memory. Tensor-core use (wgmma) and reading
W once for all T tangents are later work.

CPU tensors take the plain version below; CUDA tensors launch the kernel
or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

R_MAX = 16          # LoRA rank bound of the kernel's shared-memory tiles
JT_MAX = 64         # tangents a contraction-epilogue launch
# kernel launches; the plain versions do not count
launches = {"lora_dual_mt": 0, "lora_dual_mt_jvps": 0, "lora_dual_multi": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lora_dual_mt_tangents_ref(x, xdots, w, a, adots, b, bdots, scale):
    """Plain version: the reference dispatch's mirror numerics (the rank-r
    update in A's dtype, cast once, then the input-tangent GEMM added)."""
    K = x.shape[-1]
    T = adots.shape[0]
    x32 = x.reshape(-1, K).to(a.dtype)
    u = x32 @ a                                            # (M, r)
    ud = x32 @ adots                                       # (T, M, r)
    if xdots is not None:
        xd = xdots.reshape(T, -1, K)
        ud = xd.to(a.dtype) @ a + ud
    lo = (ud @ b) * scale + (u @ bdots) * scale            # (T, M, N)
    yd = lo.to(x.dtype)
    if xdots is not None:
        yd = xd @ w + yd
    return yd.reshape((T,) + x.shape[:-1] + (w.shape[1],))


def _fn(symbol):
    fn = getattr(build.load("lora_dual"), symbol)
    if fn.argtypes is None:
        n_ptr = 8 if symbol == "lora_dual_mt_tangents" else 9
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + \
            [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, xdots, w, a, adots, b, bdots, gy=None, what="lora_dual_mt_tangents",
           t_max=65535):
    dev = x.device
    K, N = w.shape
    r = a.shape[1]
    T = adots.shape[0]
    tensors = {"x": x, "w": w, "a": a, "adots": adots, "b": b, "bdots": bdots}
    for name, t in (("xdots", xdots), ("gy", gy)):
        if t is not None:
            tensors[name] = t
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODE or any(
            tensors[n].dtype != x.dtype for n in ("w", "xdots", "gy") if n in tensors):
        raise TypeError(f"{what}: x, xdots, w (and gy) must share one dtype of "
                        f"{list(_DTYPE_CODE)}")
    for name in ("a", "adots", "b", "bdots"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32")
    if x.shape[-1] != K or a.shape != (K, r) or adots.shape != (T, K, r) or \
            b.shape != (r, N) or bdots.shape != (T, r, N):
        raise ValueError(f"{what}: inconsistent shapes "
                         f"x{tuple(x.shape)} w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"adots{tuple(adots.shape)} b{tuple(b.shape)} "
                         f"bdots{tuple(bdots.shape)}")
    if xdots is not None and xdots.shape != (T,) + tuple(x.shape):
        raise ValueError(f"{what}: xdots{tuple(xdots.shape)} "
                         f"is not (T,)+x{tuple(x.shape)}")
    if gy is not None and gy.shape != tuple(x.shape[:-1]) + (N,):
        raise ValueError(f"{what}: gy{tuple(gy.shape)} is not x{tuple(x.shape)} "
                         f"with its last axis N={N}")
    if not 1 <= r <= R_MAX or not 1 <= T <= t_max or K < 1:
        raise ValueError(f"{what}: needs 1<=r<={R_MAX}, "
                         f"1<=T<={t_max}, K>=1 (r={r}, T={T}, K={K})")


def lora_dual_mt_tangents(x, xdots, w, a, adots, b, bdots, scale=1.0):
    """x (..., K); xdots (T, ..., K) or None; w (K, N); a (K, r);
    adots (T, K, r); b (r, N); bdots (T, r, N) -> ydots (T, ..., N) in
    x's dtype."""
    if x.device.type == "cpu":
        return lora_dual_mt_tangents_ref(x, xdots, w, a, adots, b, bdots, scale)
    if x.device.type != "cuda":
        raise ValueError(f"lora_dual_mt_tangents: unsupported device {x.device}")
    _check(x, xdots, w, a, adots, b, bdots)
    K, N = w.shape
    T, r = adots.shape[0], a.shape[1]
    M = x.numel() // K
    out = torch.empty((T,) + x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    err = _fn("lora_dual_mt_tangents")(_DTYPE_CODE[x.dtype], x.data_ptr(),
             None if xdots is None else xdots.data_ptr(), w.data_ptr(),
             a.data_ptr(), adots.data_ptr(), b.data_ptr(), bdots.data_ptr(),
             out.data_ptr(), M, K, N, r, T, float(scale),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "lora_dual_mt_tangents")
    launches["lora_dual_mt"] += 1
    return out


# ---------------------------------------------------------------------------
# Contraction epilogue: <gy, ydot_t> for T tangents, no (T,M,N) output
# ---------------------------------------------------------------------------
#
# Replaces the TPU kernel ``repro/kernels/lora_dual/kernel.py::
# lora_dual_mt_jvps_kernel`` (body ``_mt_jvps_kernel``), which
# ``kernels/dispatch.lora_jvp_contract`` reaches for the final site of a
# ``SplitLoss`` of kind 'lora' on the fused-contraction route.
#
# On the H100: the work is one frozen-W product gy@W^T (2*M*K*N
# operations) shared by all T tangents plus rank-r terms, so with an input
# tangent it is bound by operations at bf16 rates only for very small T;
# at the main path's shapes the bytes of the T xdot tangents (T*M*K) bound
# it; without one it reads x, gy and the rank-r factors only. The CUDA kernel
# (``csrc/lora_dual_mt.cu``, ``lora_dual_mt_jvps_kernel``) runs a
# (N/64, M/64) grid; each block holds its gy tile in shared memory and
# rewrites its contraction as <gy@W^T + s*(gy@B^T)@A^T, xdot_t> +
# s*<x^T(gy@B^T), Adot_t> + s*<(x@A)^T gy, Bdot_t>, so the frozen-W product
# and every other factor that does not depend on t is formed once per K
# step for all T, and each tangent costs one read of its xdot tile and
# rank-r dots. Sums are fp32 SIMT FMAs, kept per thread and summed in a
# fixed order (no atomics), one (T,) partial per block, summed here.
# Tensor cores for gy@W^T and reading x once for all N tiles are later
# work.


def lora_dual_mt_jvps_ref(x, w, a, adots, b, bdots, gy, scale=1.0, xdots=None):
    """Plain version: the reference's reassociated rank-r form
    (``lora_dual/ops.py::lora_dual_mt_jvps`` with ``impl='reassoc'``); it
    never builds a (T,M,N) tensor."""
    K, N = w.shape
    T = adots.shape[0]
    x2 = x.reshape(-1, K).to(a.dtype)
    gy2 = gy.reshape(-1, N).float()
    u = x2 @ a                                     # (M, r)
    z1 = gy2 @ b.T                                 # (M, r)
    z2 = u.T @ gy2                                 # (r, N)
    udots = x2 @ adots                             # (T, M, r)
    if xdots is not None:
        xd = xdots.reshape(T, -1, K)
        udots = udots + xd.to(a.dtype) @ a
    jvps = scale * (torch.einsum("mr,tmr->t", z1, udots)
                    + torch.einsum("rn,trn->t", z2, bdots.float()))
    if xdots is not None:
        jvps = jvps + torch.einsum("mk,tmk->t", gy2 @ w.float().T, xd.float())
    return jvps


def lora_dual_mt_jvps(x, w, a, adots, b, bdots, gy, scale=1.0, xdots=None):
    """All T jvp scalars <gy, ydot_t> (fp32, (T,)): x (..., K); w (K, N);
    a (K, r); adots (T, K, r); b (r, N); bdots (T, r, N); gy (..., N) in
    x's dtype; xdots (T, ..., K) or None."""
    if x.device.type == "cpu":
        return lora_dual_mt_jvps_ref(x, w, a, adots, b, bdots, gy, scale, xdots)
    if x.device.type != "cuda":
        raise ValueError(f"lora_dual_mt_jvps: unsupported device {x.device}")
    _check(x, xdots, w, a, adots, b, bdots, gy, what="lora_dual_mt_jvps",
           t_max=JT_MAX)
    K, N = w.shape
    T, r = adots.shape[0], a.shape[1]
    M = x.numel() // K
    if M == 0 or N == 0:
        return torch.zeros(T, dtype=torch.float32, device=x.device)
    parts = torch.empty(((M + 63) // 64, (N + 63) // 64, T), dtype=torch.float32,
                        device=x.device)
    err = _fn("lora_dual_mt_jvps")(
        _DTYPE_CODE[x.dtype], x.data_ptr(),
        None if xdots is None else xdots.data_ptr(), w.data_ptr(), a.data_ptr(),
        adots.data_ptr(), b.data_ptr(), bdots.data_ptr(), gy.data_ptr(),
        parts.data_ptr(), M, K, N, r, T, float(scale),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "lora_dual_mt_jvps")
    launches["lora_dual_mt_jvps"] += 1
    return parts.sum(dim=(0, 1))


# ---------------------------------------------------------------------------
# Multi-adapter projection: each row reads its own LoRA page (serving)
# ---------------------------------------------------------------------------
#
# Replaces the TPU kernel ``repro/kernels/lora_dual/kernel.py::
# lora_dual_multi_kernel`` (body ``_multi_kernel``), which the reference's
# ``dispatch.lora_proj_multi`` reaches for every adapted projection of the
# serving engine's batched decode step.
#
#     y[m] = x[m] @ W + s * (x[m] @ A[idx[m]]) @ B[idx[m]]
#
# The TPU kernel keeps all P resident pages' rank-r partials in VMEM and
# one-hot selects each row's page in its epilogue; here a row reads its own
# page by index, so u[m] = x[m] @ A[idx[m]] costs K*r multiply-adds a row and
# nothing is computed for the other pages.
#
# On the H100: at decode M is the engine's batch (4 at llama2-7b), so
# reading the frozen W (K*N elements) once bounds the kernel by bytes (33.6
# MB of bf16 at K = N = 4096, about 10 us); its 2*M*K*N operations take a
# hundredth of that. The CUDA kernel (``csrc/lora_dual_multi.cu``) runs a
# (N/32, M/8) grid of 512 threads: lanes run along N (neighbouring columns
# of one W row, coalesced), the block's 16 warps split each 512-wide K chunk,
# each thread holds fp32 sums for the block's 8 rows of its column, and x's
# chunk is staged in shared memory (read as a broadcast). In the same K loop
# the block accumulates u for its rows from their own pages. The epilogue
# sums the warps' partials in a fixed order (no atomics), adds s*u@B[page]
# and rounds once to x's dtype. Ragged M/N/K edges are masked, never padded
# in memory. Tensor cores, TMA and split-K (more blocks than N/32 at small
# M) are later work.


def _row_pages(idx, batch_shape):
    """Adapter pages broadcast to ``batch_shape`` (idx right-padded with
    unit axes, as the reference), flattened to (M,)."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (len(batch_shape) - idx.dim()))
    return idx.expand(batch_shape).reshape(-1)


def lora_dual_multi_ref(x, idx, w, a_stack, b_stack, scale):
    """Plain version, the reference dispatch's 'jnp' mirror numerics: x@W in
    x's dtype, the rank-r term (x32 @ A[idx]) @ B[idx] * s in A's dtype,
    cast and added."""
    K, N = w.shape
    batch = x.shape[:-1]
    pages = _row_pages(idx, batch).long()
    x2 = x.reshape(-1, K)
    y = x2 @ w
    u = torch.bmm(x2.to(a_stack.dtype)[:, None], a_stack[pages])      # (M, 1, r)
    lo = torch.bmm(u, b_stack[pages])[:, 0] * scale                   # (M, N)
    return (y + lo.to(y.dtype)).reshape(batch + (N,))


def lora_dual_multi(x, idx, w, a_stack, b_stack, scale=1.0):
    """x (..., K); idx adapter pages broadcastable to x.shape[:-1]; w (K, N);
    a_stack (P, K, r); b_stack (P, r, N) -> y (..., N) in x's dtype. Pages
    must lie in [0, P): on the card a row outside it comes back NaN."""
    if x.device.type == "cpu":
        return lora_dual_multi_ref(x, idx, w, a_stack, b_stack, scale)
    if x.device.type != "cuda":
        raise ValueError(f"lora_dual_multi: unsupported device {x.device}")
    K, N = w.shape
    batch = x.shape[:-1]
    P, r = a_stack.shape[0], a_stack.shape[-1]
    pages = _row_pages(idx, batch)
    for name, t in (("x", x), ("idx", pages), ("w", w), ("a_stack", a_stack),
                    ("b_stack", b_stack)):
        if t.device != x.device:
            raise ValueError(f"lora_dual_multi: {name} on {t.device}, x on {x.device}")
        if name != "idx" and not t.is_contiguous():
            raise ValueError(f"lora_dual_multi: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"lora_dual_multi: x and w must share one dtype of "
                        f"{list(_DTYPE_CODE)}")
    if a_stack.dtype != torch.float32 or b_stack.dtype != torch.float32:
        raise TypeError("lora_dual_multi: a_stack and b_stack must be float32")
    if pages.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lora_dual_multi: idx must be an integer tensor, not "
                        f"{pages.dtype}")
    if x.shape[-1] != K or a_stack.shape != (P, K, r) or b_stack.shape != (P, r, N):
        raise ValueError(f"lora_dual_multi: inconsistent shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} a_stack{tuple(a_stack.shape)} "
                         f"b_stack{tuple(b_stack.shape)}")
    if not 1 <= r <= R_MAX or P < 1 or K < 1:
        raise ValueError(f"lora_dual_multi: needs 1<=r<={R_MAX}, P>=1, K>=1 "
                         f"(r={r}, P={P}, K={K})")
    M = pages.numel()
    y = torch.empty(batch + (N,), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    pages = pages.to(torch.int32).contiguous()
    fn = build.load("lora_dual_multi").lora_dual_multi
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), pages.data_ptr(), w.data_ptr(),
             a_stack.data_ptr(), b_stack.data_ptr(), y.data_ptr(), M, K, N, r, P,
             float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "lora_dual_multi")
    launches["lora_dual_multi"] += 1
    return y
