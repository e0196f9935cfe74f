"""Causal (sliding-window) GQA flash attention: primal, and T stacked
jvp tangents in one walk.

Replaces two TPU kernels of ``repro/kernels/swa_attention/kernel.py``:
``swa_attention_kernel`` (body ``_kernel``), the primal of every attention
inside the estimator, and ``swa_attention_mt_kernel`` (body ``_mt_kernel``)
in its ``emit_primal=False`` route (``ops.swa_attention_mt_tangents``), all
K tangents of every attention. Per tangent the walk carries

    sd = (qd k^T + q kd^T) * scale,   mu_d = sum_j p_j sd_j,
    acc_d = sum_j p_j sd_j v_j + p_j vd_j      (rescaled by the primal alpha)

and finishes ``outd = acc_d / l - (mu_d / l) * out``.

On the H100 the primal is bound by operations at long S and by launch and
latency at the main path's S=32; the tangent walk does 2 + 2 products per
tangent per (query, key) pair on top of the primal's 2, so it is bound by
operations, and by the bytes of its (T, B*H, S, hd) output at short S.
The CUDA kernel (``csrc/swa_attention.cu``) gives each query row to one
warp (lanes split hd, so the primal accumulator lives in registers) and
walks 32-key chunks of the causal band staged in shared memory as fp32;
lane j scores key j, the warp reduces max and sum with shuffles. The T
tangent accumulators (T x hd per row) do not fit in registers for T up to
64, so they live in the warp's slice of shared memory (the launch halves
the warps a block until it fits), and each chunk's kd_t/vd_t tiles are
staged one tangent at a time. No (S, S) or (T, S, S)
tensor is ever written. The reference's numerics are kept: the explicit
keep-gate on p (exp(NEG_INF - NEG_INF) would be 1), the clamp of l at
1e-30, the band start ``(q_start - (window - 1)) // chunk`` with
out-of-range keys masked, and the GQA map ``h // (H / KV)``. S and hd
edges are masked in the kernel; hd <= 128. Tensor cores, TMA and
multi-row tiles are later work.

CPU tensors take the plain versions below; CUDA tensors launch a kernel
or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

T_MAX = 64          # tangents a launch (the kernel's shared-memory plan)
HD_MAX = 128
launches = {"swa_attention": 0, "swa_attention_mt": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def swa_attention_ref(q, k, v, window=None):
    """Plain version (port of ``ref.swa_attention_gqa_ref``): q (B,H,S,hd);
    k,v (B,KV,S,hd), head h reads kv head h // (H // KV)."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, S, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bgrqd,bgkd->bgrqk", qg, k).float() * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    scores = torch.where(keep, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p.to(q.dtype), v)
    return out.reshape(B, H, S, hd)


def swa_attention_mt_tangents_ref(q, k, v, qds, kds, vds, window=None):
    """Plain version (port of ``ref.swa_attention_mt_ref``): T independent
    jvps of the GQA reference -> (T, B, H, S, hd)."""
    f = functools.partial(swa_attention_ref, window=window)

    def one(qd, kd, vd):
        return torch.func.jvp(f, (q, k, v), (qd, kd, vd))[1]
    return torch.func.vmap(one)(qds, kds, vds)


def _fn(symbol):
    fn = getattr(build.load("swa_attention"), symbol)
    if fn.argtypes is None:
        n_ptr = 4 if symbol == "swa_attention_fwd" else 7
        n_int = 6 if symbol == "swa_attention_fwd" else 7
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + \
            [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(what, q, k, v, tangents=()):
    B, H, S, hd = q.shape
    KV = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(tangents):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if k.shape != (B, KV, S, hd) or v.shape != k.shape or KV < 1 or H % KV:
        raise ValueError(f"{what}: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} are not GQA-compatible")
    if not 1 <= hd <= HD_MAX or B * H > 2 ** 31 - 1:
        raise ValueError(f"{what}: needs 1 <= hd <= {HD_MAX} (hd={hd})")


def swa_attention(q, k, v, window=None):
    """q (B,H,S,hd); k,v (B,KV,S,hd) -> (B,H,S,hd), causal, banded to the
    last ``window`` keys when window is set."""
    if q.device.type == "cpu":
        return swa_attention_ref(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention: unsupported device {q.device}")
    _check("swa_attention", q, k, v)
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _fn("swa_attention_fwd")(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B * H, S, hd, H, H // k.shape[1],
        -1 if window is None else int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "swa_attention")
    launches["swa_attention"] += 1
    return out


def swa_attention_mt_tangents(q, k, v, qds, kds, vds, window=None):
    """Tangent-only multi-tangent pass: qds (T,B,H,S,hd); kds, vds
    (T,B,KV,S,hd) -> outds (T,B,H,S,hd)."""
    if q.device.type == "cpu":
        return swa_attention_mt_tangents_ref(q, k, v, qds, kds, vds, window)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention_mt_tangents: unsupported device {q.device}")
    T = qds.shape[0]
    _check("swa_attention_mt_tangents", q, k, v,
           (("qds", qds), ("kds", kds), ("vds", vds)))
    if qds.shape[1:] != q.shape or kds.shape[1:] != k.shape or \
            vds.shape[1:] != k.shape or kds.shape[0] != T or vds.shape[0] != T:
        raise ValueError("swa_attention_mt_tangents: tangent stacks must be "
                         "(T,)+primal shape")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"swa_attention_mt_tangents: needs 1 <= T <= {T_MAX}, got {T}")
    B, H, S, hd = q.shape
    out = torch.empty_like(qds)
    if out.numel() == 0:
        return out
    err = _fn("swa_attention_mt_tangents")(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qds.data_ptr(), kds.data_ptr(), vds.data_ptr(), out.data_ptr(),
        B * H, S, hd, H, H // k.shape[1], T, -1 if window is None else int(window),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "swa_attention_mt_tangents")
    launches["swa_attention_mt"] += 1
    return out
