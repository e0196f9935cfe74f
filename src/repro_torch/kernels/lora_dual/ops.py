"""LoRA multi-tangent projection: the tangent half of y = x@W + s(x@A)@B.

    ydot_t = s * ((x@Adot_t + xdot_t@A) @ B + (x@A) @ Bdot_t) + xdot_t@W

for T stacked tangents (``xdots (T,M,K)`` or None, ``adots (T,K,r)``,
``bdots (T,r,N)`` -> ``(T,M,N)``).

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
launches = {"lora_dual_mt": 0}   # kernel launches; the plain version does not count

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


def _lib():
    lib = build.load("lora_dual")
    fn = lib.lora_dual_mt_tangents
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, xdots, w, a, adots, b, bdots):
    dev = x.device
    K, N = w.shape
    r = a.shape[1]
    T = adots.shape[0]
    tensors = {"x": x, "w": w, "a": a, "adots": adots, "b": b, "bdots": bdots}
    if xdots is not None:
        tensors["xdots"] = xdots
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"lora_dual_mt_tangents: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"lora_dual_mt_tangents: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype or (
            xdots is not None and xdots.dtype != x.dtype):
        raise TypeError("lora_dual_mt_tangents: x, xdots and w must share one "
                        f"dtype of {list(_DTYPE_CODE)}")
    for name in ("a", "adots", "b", "bdots"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"lora_dual_mt_tangents: {name} must be float32")
    if x.shape[-1] != K or a.shape != (K, r) or adots.shape != (T, K, r) or \
            b.shape != (r, N) or bdots.shape != (T, r, N):
        raise ValueError("lora_dual_mt_tangents: inconsistent shapes "
                         f"x{tuple(x.shape)} w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"adots{tuple(adots.shape)} b{tuple(b.shape)} "
                         f"bdots{tuple(bdots.shape)}")
    if xdots is not None and xdots.shape != (T,) + tuple(x.shape):
        raise ValueError(f"lora_dual_mt_tangents: xdots{tuple(xdots.shape)} "
                         f"is not (T,)+x{tuple(x.shape)}")
    if not 1 <= r <= R_MAX or not 1 <= T <= 65535 or K < 1:
        raise ValueError(f"lora_dual_mt_tangents: needs 1<=r<={R_MAX}, "
                         f"1<=T<=65535, K>=1 (r={r}, T={T}, K={K})")


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
    fn = _lib()
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(),
             None if xdots is None else xdots.data_ptr(), w.data_ptr(),
             a.data_ptr(), adots.data_ptr(), b.data_ptr(), bdots.data_ptr(),
             out.data_ptr(), M, K, N, r, T, float(scale),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "lora_dual_mt_tangents")
    launches["lora_dual_mt"] += 1
    return out
