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

On the H100 (``csrc/lora_dual_mt.cu``, whose header holds the full note):
with an input tangent the T GEMMs xdot_t@W (2·T·M·K·N operations) bound
the call by operations at the main path's T·M >= 1024 and by the bytes of
W and xdot at T=1; with none (the first perturbed unit) only rank-r work is
left and writing the (T,M,N) output bounds it by bytes. Three routes, one
rule (``lora_mt_path``):

- ``tc`` (bf16 with an input tangent, K and N multiples of 8, every
  operand, the fp32 LoRA factors too, on a 16-byte boundary): the T
  tangents are one GEMM of T·M rows on bf16 ``wgmma`` with fp32
  accumulators; a producer warp keeps the TMA unit
  filling a ring of 128-byte-swizzled tiles through mbarriers, and the two
  blocks of a cluster share each W tile by TMA multicast; blocks sharing a
  strip of W run side by side, so W is read from device memory about once
  a call, not once a tangent. A pre-pass kernel in the same call forms
  u = x@A and udot_t = x@Adot_t + xdot_t@A in fp32 (fixed summation
  order); the GEMM's epilogue adds s·(udot_t@B + u@Bdot_t) to the fp32
  accumulator and rounds once.
- ``store`` (bf16, no input tangent, the same alignment): the same
  pre-pass, then a store-bound kernel that never reads W, stages its B and
  Bdot_t columns once a block and writes 16-byte vectors.
- ``simt`` (fp32, or off that alignment): one launch over a
  (N/64, M/64, T) grid of plain fp32 FMAs on 64x64 tiles with the rank-r
  pieces accumulated in shared memory in the same K loop. fp32 stays on it
  because TF32 tensor cores keep about three digits and the reduced fp32
  configs are held to the CPU at 1e-5.

LoRA factors are fp32; the output is rounded once to x's dtype. Ragged
M/N/K edges are masked in the kernels, never padded in device memory.
``launches_by_path`` counts each call by the route it took; ``launches``
counts calls, one a call whatever the route.

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
# calls by route (``lora_mt_path``, ``lora_jvps_path``, ``lora_multi_path``);
# each sums to its launches
launches_by_path = {"lora_dual_mt": {"tc": 0, "store": 0, "simt": 0},
                    "lora_dual_mt_jvps": {"tc": 0, "simt": 0},
                    "lora_dual_multi": {"stream": 0, "simt": 0}}
STREAM_M_MAX = 16       # rows of the multi-adapter stream route (fp32 sums a thread)
STREAM_K_MAX = 12288    # its K: a block stages its K / 8 slice of x in shared memory
                        # (command-r-plus-104b's d_model 12288: 1536 columns)

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


def lora_mt_path(dtype, K, N, has_xd, aligned=True):
    """The kernel a CUDA ``lora_dual_mt_tangents`` call takes: 'tc' (bf16,
    an input tangent, K and N multiples of 8 and every operand starting on
    16 bytes (``aligned``): the TMA unit copies 16-byte-strided rows of x,
    xdots and w, and the pre-pass and epilogue load the fp32 factors in
    float4 and float2 vectors),
    'store' (the same without an input tangent) or 'simt' (fp32, or off
    that alignment)."""
    if dtype != torch.bfloat16 or K % 8 or N % 8 or not aligned:
        return "simt"
    return "tc" if has_xd else "store"


def _fn(symbol):
    fn = getattr(build.load("lora_dual"), symbol)
    if fn.argtypes is None:
        if symbol == "lora_dual_mt_jvps_bf16_blocks":
            fn.argtypes = [ctypes.c_int] * 3
        elif symbol in ("lora_dual_mt_tangents_bf16", "lora_dual_mt_jvps_bf16"):
            n_ptr = 9 if symbol == "lora_dual_mt_tangents_bf16" else 10
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + \
                [ctypes.c_float, ctypes.c_void_p]
        else:
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
    path = lora_mt_path(x.dtype, K, N, xdots is not None,
                        all(t.data_ptr() % 16 == 0
                            for t in (x, xdots, w, a, adots, b, bdots) if t is not None))
    out = torch.empty((T,) + x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    xd_ptr = None if xdots is None else xdots.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if path == "simt":
        err = _fn("lora_dual_mt_tangents")(
            _DTYPE_CODE[x.dtype], x.data_ptr(), xd_ptr, w.data_ptr(), a.data_ptr(),
            adots.data_ptr(), b.data_ptr(), bdots.data_ptr(), out.data_ptr(),
            M, K, N, r, T, float(scale), stream)
    else:       # u (M, r) and udot (T, M, r) of the rank-r pre-pass, fp32
        scratch = torch.empty((T + 1) * M * r, dtype=torch.float32, device=x.device)
        err = _fn("lora_dual_mt_tangents_bf16")(
            x.data_ptr(), xd_ptr, w.data_ptr(), a.data_ptr(), adots.data_ptr(),
            b.data_ptr(), bdots.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            M, K, N, r, T, float(scale), stream)
    build.check(err, "lora_dual_mt_tangents")
    launches["lora_dual_mt"] += 1
    launches_by_path["lora_dual_mt"][path] += 1
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
# On the H100: the work is one frozen-W product z = gy@W^T (2*M*K*N
# operations) shared by all T tangents plus rank-r terms; with an input
# tangent the bytes of W and the T xdot tangents bound it (54.5 MB at
# llama2-7b widths, T=8, against 8.6 GFLOP), without one it reads x, gy
# and the rank-r factors only. Two routes, one rule (``lora_jvps_path``):
#
# - ``tc`` (bf16, K and N multiples of 8, every operand on 16 bytes; with or
#   without an input tangent): the rank-r pre-pass of ``lora_dual_mt``
#   (u = x@A, udot_t in fp32), then a bf16 ``wgmma`` GEMM whose epilogue
#   contracts (``csrc/lora_dual_mt.cu``, ``lora_jvps_tc_kernel``): a block
#   owns a 64 x 128 tile of z over one slice of N (N split until the grid is
#   about one wave of the 132 SMs, by (M, K, N) alone, never by T), TMA
#   fills a ring of 128-byte-swizzled gy and W tiles (both K-major: W^T's
#   rows are W's) and then each xdot_t's tile, and the fp32 accumulator is
#   dotted with each xdot_t's tile in fp32, so z never leaves the block;
#   the block's idle producer warps add s*<gy, udot_t@B + u@Bdot_t> over
#   their share of the slice (both terms are sums over N). Without an input
#   tangent the GEMM is skipped and only those rank-r terms run. One (T,)
#   partial a block, summed by a one-warp kernel in a fixed order: no
#   atomics, and tangent t of a T=8 launch is bitwise a T=1 launch.
# - ``simt`` (fp32, or off that alignment): a (N/64, M/64) grid; each block
#   holds its gy tile in shared memory and rewrites its contraction as
#   <gy@W^T + s*(gy@B^T)@A^T, xdot_t> + s*<x^T(gy@B^T), Adot_t> +
#   s*<(x@A)^T gy, Bdot_t>, so every factor that does not depend on t is
#   formed once per K step for all T; fp32 SIMT FMAs, one (T,) partial per
#   block, summed here. fp32 stays here: TF32 keeps about three digits.


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


def lora_jvps_path(dtype, K, N, has_xd, aligned=True):
    """The kernel a CUDA ``lora_dual_mt_jvps`` call takes: 'tc' (bf16, K and
    N multiples of 8 and every operand starting on 16 bytes (``aligned``):
    the TMA unit copies 16-byte-strided rows of gy, W and xdots, the
    pre-pass reads x and xdots in 16-byte vectors, and the rank-r terms read
    gy, B and Bdots in 16-byte vectors) or 'simt' (fp32, or off that
    alignment). Unlike ``lora_mt_path``, ``has_xd`` does not change the
    route: without an input tangent the tc route skips the GEMM and runs the
    rank-r terms alone."""
    del has_xd
    return "tc" if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned \
        else "simt"


def lora_dual_mt_jvps_split_ref(x, w, a, adots, b, bdots, gy, scale=1.0, xdots=None,
                                steps=None):
    """Plain version in the tc kernel's association: N cut into the
    kernel's slices of ``steps`` 64-column stages (default: its plan for
    these widths, ``jvps_split_plan``); each slice's partial <gy@W^T,
    xdot_t> + s<gy, udot_t@B + u@Bdot_t> over that slice alone, the
    partials summed in slice order. Held against the JAX reference on the
    CPU; the port's main path never calls it."""
    K, N = w.shape
    T = adots.shape[0]
    x2 = x.reshape(-1, K).to(a.dtype)
    gy2 = gy.reshape(-1, N).float()
    u = x2 @ a                                                    # (M, r)
    udots = x2 @ adots                                            # (T, M, r)
    xd = None
    if xdots is not None:
        xd = xdots.reshape(T, -1, K).float()
        udots = udots + xd @ a
    if steps is None:
        steps = jvps_split_plan(x2.shape[0], K, N)[1]
    jvps = torch.zeros(T, dtype=torch.float32, device=gy.device)
    for n0 in range(0, N, steps * 64):
        ns = slice(n0, min(N, n0 + steps * 64))
        g = gy2[:, ns]
        lo = udots @ b[:, ns] + u @ bdots[:, :, ns]               # (T, M, n)
        part = scale * torch.einsum("mn,tmn->t", g, lo)
        if xd is not None:
            part = part + torch.einsum("mk,tmk->t", g @ w.float()[:, ns].T, xd)
        jvps = jvps + part
    return jvps


def jvps_split_plan(M, K, N):
    """The tc contraction's plan, as ``csrc/lora_dual_mt.cu::jvps_plan``
    makes it from (M, K, N) alone: (blocks along M, K and N, 64-column
    stages a slice of N). Tiles of z are 64 x 128; N is split into the
    fewest slices that bring the grid to about 128 blocks."""
    mt, kt, n_steps = -(-M // 64), -(-K // 128), -(-N // 64)
    split = min(n_steps, max(1, -(-128 // (mt * kt))))
    steps = -(-n_steps // split)
    return (mt, kt, -(-n_steps // steps)), steps


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
    path = lora_jvps_path(x.dtype, K, N, xdots is not None,
                          all(t.data_ptr() % 16 == 0
                              for t in (x, xdots, w, a, adots, b, bdots, gy) if t is not None))
    xd_ptr = None if xdots is None else xdots.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if path == "tc":    # u, udot_t of the pre-pass, then the blocks' (T,) partials
        blocks = _fn("lora_dual_mt_jvps_bf16_blocks")(M, K, N)
        scratch = torch.empty((T + 1) * M * r + T * blocks, dtype=torch.float32,
                              device=x.device)
        jvps = torch.empty(T, dtype=torch.float32, device=x.device)
        err = _fn("lora_dual_mt_jvps_bf16")(
            x.data_ptr(), xd_ptr, w.data_ptr(), a.data_ptr(), adots.data_ptr(),
            b.data_ptr(), bdots.data_ptr(), gy.data_ptr(), scratch.data_ptr(),
            jvps.data_ptr(), M, K, N, r, T, float(scale), stream)
    else:
        parts = torch.empty(((M + 63) // 64, (N + 63) // 64, T), dtype=torch.float32,
                            device=x.device)
        err = _fn("lora_dual_mt_jvps")(
            _DTYPE_CODE[x.dtype], x.data_ptr(), xd_ptr, w.data_ptr(), a.data_ptr(),
            adots.data_ptr(), b.data_ptr(), bdots.data_ptr(), gy.data_ptr(),
            parts.data_ptr(), M, K, N, r, T, float(scale), stream)
    build.check(err, "lora_dual_mt_jvps")
    launches["lora_dual_mt_jvps"] += 1
    launches_by_path["lora_dual_mt_jvps"][path] += 1
    return jvps if path == "tc" else parts.sum(dim=(0, 1))


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
# MB of bf16 at K = N = 4096, about 10 us at 3.35 TB/s); its 2*M*K*N
# operations are 4 a byte. Two routes, one rule (``lora_multi_path``):
#
# - ``stream`` (bf16, M <= 16, K and N multiples of 8, x and W on 16
#   bytes, K <= 12288): streams W from HBM, where the engine's decode step finds it
#   (``csrc/lora_dual_multi.cu``, ``lora_multi_stream_kernel``, whose header
#   holds the full note). A block owns 128 columns and one of 8 K slices:
#   256 blocks at decode, all resident at once; each thread keeps 10
#   16-byte cp.async copies of its W rows in flight in a shared-memory ring
#   and fp32 sums for every row. The 8 slices of a strip are one
#   thread-block cluster that sums its partials of x@W and of u = x@A[page]
#   (each slice's, from its rows' own pages) in rank order through
#   distributed shared memory, adds s*u@B[page] and rounds once: one launch,
#   no workspace, no float atomics, so repeat launches are bitwise equal.
# - ``simt`` (fp32, more rows, or off that alignment): a (N/32, M/8) grid of
#   512 threads; lanes run along N, the block's 16 warps split each 512-wide
#   K chunk staged in shared memory, each thread holds fp32 sums for the
#   block's 8 rows of its column, and u accumulates from the rows' pages in
#   the same K loop; the epilogue sums the warps' partials in a fixed order.
#   A tensor-core tile path for prefill-sized M is later work.
#
# Ragged M/N/K edges are masked, never padded in memory.


def lora_multi_path(dtype, M, K, N, aligned=True):
    """The kernel a CUDA ``lora_dual_multi`` call takes: 'stream' (bf16,
    1 <= M <= STREAM_M_MAX rows, K and N multiples of 8 and x and W on a
    16-byte boundary (``aligned``) for 16-byte copies of eight elements of a
    row, K <= STREAM_K_MAX) or 'simt'."""
    if (dtype == torch.bfloat16 and M <= STREAM_M_MAX and K <= STREAM_K_MAX
            and K % 8 == 0 and N % 8 == 0 and aligned):
        return "stream"
    return "simt"


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
    path = lora_multi_path(x.dtype, M, K, N, (x.data_ptr() | w.data_ptr()) % 16 == 0)
    args = (x.data_ptr(), pages.data_ptr(), w.data_ptr(), a_stack.data_ptr(),
            b_stack.data_ptr(), y.data_ptr(), M, K, N, r, P, float(scale),
            torch.cuda.current_stream(x.device).cuda_stream)
    if path == "stream":
        err = _multi_fn("lora_dual_multi_stream")(*args)
    else:
        err = _multi_fn("lora_dual_multi")(_DTYPE_CODE[x.dtype], *args)
    build.check(err, "lora_dual_multi")
    launches["lora_dual_multi"] += 1
    launches_by_path["lora_dual_multi"][path] += 1
    return y


def _multi_fn(symbol):
    fn = getattr(build.load("lora_dual_multi"), symbol)
    if fn.argtypes is None:
        lead = [] if symbol == "lora_dual_multi_stream" else [ctypes.c_int]
        fn.argtypes = lead + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
