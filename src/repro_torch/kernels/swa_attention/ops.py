"""Causal (sliding-window) GQA flash attention: primal, T stacked jvp
tangents in one walk, and the same walk contracted against an output
cotangent (the jvp-contraction epilogue, second half of this module).

Replaces two TPU kernels of ``repro/kernels/swa_attention/kernel.py``:
``swa_attention_kernel`` (body ``_kernel``), the primal of every attention
inside the estimator, and ``swa_attention_mt_kernel`` (body ``_mt_kernel``)
in its ``emit_primal=False`` route (``ops.swa_attention_mt_tangents``), all
K tangents of every attention. Per tangent the walk carries

    sd = (qd k^T + q kd^T) * scale,   mu_d = sum_j p_j sd_j,
    acc_d = sum_j p_j sd_j v_j + p_j vd_j      (rescaled by the primal alpha)

and finishes ``outd = acc_d / l - (mu_d / l) * out``.

On the H100 the primal does 4·hd operations a kept (query, key) pair and
reads q, k and v once: it is bound by operations at long S and by launch
latency at the main path's S=32. In bf16 with hd a multiple of 8
(``swa_path``: roberta-large's 64, llama2-7b's, gemma3-27b's and
command-r's 128, h2o-danube's 120, gemma3-12b's 256) it runs on tensor
cores (``csrc/swa_attention.cu``, ``swa_tc_kernel``, whose header holds the
full note). A width off the 16 multiple (120) is padded to the next one
inside the kernels: its 16-byte copies past column hd are zero-filled in
shared memory, the row stride in device memory stays hd, the scale stays
1/sqrt(hd), only the first hd columns are stored, and the padding adds
exactly 0 to the contraction.
hd <= 128 keeps the plan below; 128 < hd <= 256 pads to a multiple of 32
and runs a wide plan: the primal reads Q from shared memory instead of
registers, and the tangent walk and the contraction split the hd columns
of their outputs across two blocks, each computing the scores in full.
In the narrow plan a warp owns 16 query rows (the height of mma.sync.m16n8k16),
a block is one (b, h) with min(4, ceil(S/16)) warps, so S=32 takes two
full warps and S=2048 64-row blocks whose key tiles feed four warps. 64-key
K/V tiles arrive by cp.async in a double-buffered shared-memory ring;
Q stays in registers; S = Q·K^T and P·V run on the tensor cores with fp32
accumulators, the online softmax on the score fragments (row max and sum
over the lane quad by shuffles), P rounded to bf16 before P·V as the
reference does, l summed from the fp32 p.

The tangent walk does 2 + 2 products per tangent per (query, key) pair on
top of the primal's 2: at the main path's S=32 it is bound by the bytes of
its (T, B*H, S, hd) tangent stacks and output (about 18 MB at
roberta-large's T=8), at long S by operations. In bf16 on ``swa_path``'s
tensor-core route (``swa_tc_mt_kernel``) a block is one (b, h), a query
tile of 16 rows a warp and a group of 1–4 tangents (as many 16 x hd fp32
accumulators as a warp's registers hold: 4 at hd <= 32, 2 at hd <= 64, 1
above); more tangents are more blocks. Q, the group's Qd_t and, per 64-key
tile, K, V, Kd_t and Vd_t arrive by cp.async; each warp runs the primal
walk, then per tangent Sd = Qd_t K^T + Q Kd_t^T on the tensor cores, psd =
p sd scale in fp32, mu_t += sum psd, acc_t += psd V + bf16(p) Vd_t, and
finishes outd_t in 16-byte stores. p is rounded to bf16 before its products
as the reference rounds it; psd goes in as two bf16 (hi + lo) instead of
one rounding: psd is several units where few keys are kept, and the first
rows' outd cancels acc_t against the fp32 mu_t, so one rounding would leave
up to |psd| |v| / 512. ``swa_attention_mt_tiled_ref`` is the
plain tiled walk in the kernel's roundings (``round_psd`` gives the
reference's; the wide plan's column split changes no sum of the tangent
outputs, so it covers every width). The contraction epilogue runs the same
walk on the same route (second half of this module). fp32 and hd off the 8
multiple run ``swa_kernel``: each query row to one warp (lanes split hd, so the primal
accumulator lives in registers), walking 32-key chunks of the causal band
staged in shared memory as fp32; lane j scores key j, the warp reduces max
and sum with shuffles; its T tangent accumulators live in the warp's slice
of shared memory (the launch halves the warps a block until it fits), and
each chunk's kd_t/vd_t tiles are staged one tangent at a time. No (S, S) or
(T, S, S) tensor is ever written. Every kernel keeps the reference's
numerics: the explicit keep-gate on p (exp(NEG_INF - NEG_INF) would be
1), the clamp of l at 1e-30, the band start ``(q_start - (window - 1)) //
tile`` with out-of-range keys masked, and the GQA map ``h // (H / KV)``.
S and hd edges are masked in the kernels; hd <= 256 (at hd 256 the simt
plan holds T <= 48 tangents a launch and raises above). ``launches_by_path``
counts the primal and tangent calls by route.

CPU tensors take the plain versions below; CUDA tensors launch a kernel
or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, calls

T_MAX = 64          # tangents a launch (the kernel's shared-memory plan)
HD_MAX = 256        # gemma3-12b; 120 (h2o-danube) and every width off the 16
                    # multiple is padded inside the tensor-core kernels
TC_KEYS = 64        # keys a tile of the tensor-core kernels (csrc TC_BKV)
launches = {"swa_attention": 0, "swa_attention_mt": 0, "swa_attention_mt_jvps": 0}
# primal, tangent and contraction calls by route (``swa_path``); each sums to
# its launches
launches_by_path = {"swa_attention": {"tc": 0, "simt": 0},
                    "swa_attention_mt": {"tc": 0, "simt": 0},
                    "swa_attention_mt_jvps": {"tc": 0, "simt": 0}}

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


def swa_attention_mt_tiled_ref(q, k, v, qds, kds, vds, window=None, round_psd=False):
    """Plain tiled version of the tangent walk in the roundings of the
    tensor-core kernel: keys in its tiles of TC_KEYS (at multiples of it)
    with an online softmax and fp32 accumulators, p rounded to q's dtype
    before its products with v and vd. ``round_psd`` rounds psd too before
    its product with v, as the reference's ``_mt_kernel`` does; the kernel
    carries psd as two bf16 (module note). Operands as
    ``swa_attention_mt_tangents``."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    dt = q.dtype
    rep = lambda t: t.repeat_interleave(G, dim=-3).float()  # noqa: E731  kv head h // G
    qf, qdf = q.float(), qds.float()
    kf, vf, kdf, vdf = rep(k), rep(v), rep(kds), rep(vds)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, H, S, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    mu = torch.zeros((qds.shape[0], B, H, S, 1), device=q.device)
    accd = torch.zeros_like(qdf)
    qpos = torch.arange(S, device=q.device)[:, None]
    for c0 in range(0, S, TC_KEYS):
        ks = slice(c0, min(S, c0 + TC_KEYS))
        kpos = torch.arange(ks.start, ks.stop, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        kt, vt = kf[..., ks, :], vf[..., ks, :]
        s = torch.where(keep, qf @ kt.transpose(-1, -2) * scale, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ vt
        sd = (qdf @ kt.transpose(-1, -2) + qf @ kdf[..., ks, :].transpose(-1, -2)) * scale
        psd = p * sd
        mu = mu * alpha + psd.sum(-1, keepdim=True)
        accd = accd * alpha + ((psd.to(dt).float() if round_psd else psd) @ vt
                               + p.to(dt).float() @ vdf[..., ks, :])
        m = m_new
    lc = l.clamp_min(1e-30)
    return (accd / lc - (mu / lc) * (acc / lc)).to(dt)


def swa_path(dtype, hd, aligned=True):
    """The kernel a CUDA ``swa_attention`` (primal), ``swa_attention_mt_tangents``
    or ``swa_attention_mt_jvps`` call takes: 'tc' (bf16 with hd a multiple
    of 8, so every row is whole 16-byte copies (the kernels pad it to the
    16-column depth of an mma step in shared memory), and every operand on a
    16-byte boundary (``aligned``) for the copies of query, key and value
    rows, their tangents' and gy's) or 'simt'."""
    return "tc" if dtype == torch.bfloat16 and hd % 8 == 0 and aligned else "simt"


_ARGS = {"swa_attention_fwd": (4, 6), "swa_attention_mt_tangents": (7, 7),
         "swa_attention_mt_jvps": (8, 7),      # (pointers, ints) after dtype
         "swa_attention_fwd_tc": (4, 6),       # no dtype: bf16 only
         "swa_attention_mt_tangents_tc": (7, 7),
         "swa_attention_mt_jvps_tc": (9, 7)}


def _fn(symbol):
    fn = getattr(build.load("swa_attention"), symbol)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGS[symbol]
        lead = [] if symbol.endswith("_tc") else [ctypes.c_int]
        fn.argtypes = lead + [ctypes.c_void_p] * n_ptr + \
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


def _check_tangents(what, q, k, v, qds, kds, vds, extra=()):
    T = qds.shape[0]
    _check(what, q, k, v, (("qds", qds), ("kds", kds), ("vds", vds)) + tuple(extra))
    if qds.shape[1:] != q.shape or kds.shape[1:] != k.shape or \
            vds.shape[1:] != k.shape or kds.shape[0] != T or vds.shape[0] != T:
        raise ValueError(f"{what}: tangent stacks must be (T,)+primal shape")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"{what}: needs 1 <= T <= {T_MAX}, got {T}")
    return T


def swa_attention(q, k, v, window=None):
    """q (B,H,S,hd); k,v (B,KV,S,hd) -> (B,H,S,hd), causal, banded to the
    last ``window`` keys when window is set."""
    if q.device.type == "cpu":
        out = swa_attention_ref(q, k, v, window)
        if calls.recording is not None:
            calls.record("swa_attention", "plain", (q, k, v), out)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention: unsupported device {q.device}")
    _check("swa_attention", q, k, v)
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    path = swa_path(q.dtype, hd, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S, hd,
            H, H // k.shape[1], -1 if window is None else int(window),
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if path == "tc":
        err = _fn("swa_attention_fwd_tc")(*args)
    else:
        err = _fn("swa_attention_fwd")(_DTYPE_CODE[q.dtype], *args)
    build.check(err, "swa_attention")
    launches["swa_attention"] += 1
    launches_by_path["swa_attention"][path] += 1
    if calls.recording is not None:
        calls.record("swa_attention", path, (q, k, v), out)
    return out


def swa_attention_mt_tangents(q, k, v, qds, kds, vds, window=None):
    """Tangent-only multi-tangent pass: qds (T,B,H,S,hd); kds, vds
    (T,B,KV,S,hd) -> outds (T,B,H,S,hd)."""
    if q.device.type == "cpu":
        out = swa_attention_mt_tangents_ref(q, k, v, qds, kds, vds, window)
        if calls.recording is not None:
            calls.record("swa_attention_mt", "plain", (q, k, v, qds, kds, vds), out)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention_mt_tangents: unsupported device {q.device}")
    T = _check_tangents("swa_attention_mt_tangents", q, k, v, qds, kds, vds)
    B, H, S, hd = q.shape
    out = torch.empty_like(qds)
    if out.numel() == 0:
        return out
    path = swa_path(q.dtype, hd,
                    all(t.data_ptr() % 16 == 0 for t in (q, k, v, qds, kds, vds, out)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qds.data_ptr(), kds.data_ptr(),
            vds.data_ptr(), out.data_ptr(), B * H, S, hd, H, H // k.shape[1], T,
            -1 if window is None else int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if path == "tc":
        err = _fn("swa_attention_mt_tangents_tc")(*args)
    else:
        err = _fn("swa_attention_mt_tangents")(_DTYPE_CODE[q.dtype], *args)
    build.check(err, "swa_attention_mt_tangents")
    launches["swa_attention_mt"] += 1
    launches_by_path["swa_attention_mt"][path] += 1
    if calls.recording is not None:
        calls.record("swa_attention_mt", path, (q, k, v, qds, kds, vds), out)
    return out


# ---------------------------------------------------------------------------
# Contraction epilogue: <gy, outd_t> for T tangents, no (T,B,H,S,hd) output
# ---------------------------------------------------------------------------
#
# Replaces the TPU kernel ``repro/kernels/swa_attention/kernel.py::
# swa_attention_mt_jvps_kernel`` (body ``_mt_jvps_kernel``), which
# ``kernels/dispatch.swa_jvp_contract`` reaches at the final attention site
# of the dense family's split loss on the fused-contraction route.
#
# On the H100 it does the multi-tangent walk's operations but writes no
# tangent output, so at the main path's S=32 it is bound by the bytes it
# reads (q, k, v, their T tangents and gy) and in practice by latency;
# at long S by operations. Two routes, ``swa_path``'s rule:
#
# - ``tc`` (bf16, hd a multiple of 8, every operand on 16 bytes):
#   ``swa_tc_jvps_kernel`` (``csrc/swa_attention.cu``) runs the tangent
#   kernel's tensor-core walk (its grid, tangent groups, cp.async staging,
#   band, keep gate, GQA map and l clamp) with the warp's 16 rows of gy
#   staged beside Q; at the finish outd_t stays in fp32 fragments and is
#   dotted with gy's, reduced over the warp by shuffles and over the
#   block's warps in warp order, one partial a (t, b*h, query block; in
#   the wide plan, hd > 128, and column half); a one-warp kernel sums each
#   tangent's partials in a fixed order. Every
#   product whose result reaches the contraction carries its fp32 factor
#   as a bf16 (hi, lo) pair (p in P V and p Vd_t, psd in psd V): one
#   rounding of p leaves about 2^-9 of each term, and over the ~2.6e5 terms
#   of a roberta contraction that misses 1e-6 of sum|terms|. A tangent's
#   arithmetic and summation order do not depend on T or on its group, so
#   tangent t of a T=8 launch is bitwise a T=1 launch.
# - ``simt`` (fp32, other widths): the multi-tangent kernel's simt walk
#   (mode JVPS: one warp a query row, T tangent accumulators in the warp's
#   slice of shared memory) with the tangent store replaced by the same
#   contraction in fp32, the block's rows summed in warp order into one
#   (T,) partial per (b*h, query block), summed here.
#
# No float atomics, so the sum is the same from run to run, and nothing of
# size (T, S, hd) reaches device memory.


def swa_attention_mt_jvps_ref(q, k, v, qds, kds, vds, gy, window=None):
    """Plain version (port of ``ref.swa_attention_mt_jvps_ref``):
    materializes the T tangents with the plain multi-tangent version and
    contracts them with gy in fp32 -> (T,)."""
    outds = swa_attention_mt_tangents_ref(q, k, v, qds, kds, vds, window)
    return torch.einsum("bhsd,tbhsd->t", gy.float(), outds.float())


def _query_blocks(S, hd, T):
    """Query blocks of an epilogue launch (the kernel picks its warps a
    block from its shared-memory plan): the partials' second axis."""
    fn = build.load("swa_attention").swa_attention_mt_jvps_blocks
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    return fn(S, hd, T)


def _check_jvps(q, k, v, qds, kds, vds, gy):
    T = _check_tangents("swa_attention_mt_jvps", q, k, v, qds, kds, vds,
                        (("gy", gy),))
    if gy.shape != q.shape:
        raise ValueError(f"swa_attention_mt_jvps: gy{tuple(gy.shape)} is not "
                         f"q{tuple(q.shape)}")
    return T


def swa_attention_mt_jvps(q, k, v, qds, kds, vds, gy, window=None):
    """jvps (T,) fp32 = <gy, outd_t>: operands as
    ``swa_attention_mt_tangents`` plus the output cotangent gy (B,H,S,hd)."""
    if q.device.type == "cpu":
        out = swa_attention_mt_jvps_ref(q, k, v, qds, kds, vds, gy, window)
        if calls.recording is not None:
            calls.record("swa_attention_mt_jvps", "plain", (q, k, v, qds, kds, vds, gy),
                         out)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention_mt_jvps: unsupported device {q.device}")
    T = _check_jvps(q, k, v, qds, kds, vds, gy)
    B, H, S, hd = q.shape
    if q.numel() == 0:
        return torch.zeros(T, dtype=torch.float32, device=q.device)
    path = swa_path(q.dtype, hd,
                    all(t.data_ptr() % 16 == 0 for t in (q, k, v, qds, kds, vds, gy)))
    tail = (B * H, S, hd, H, H // k.shape[1], T, -1 if window is None else int(window),
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qds.data_ptr(), kds.data_ptr(),
            vds.data_ptr(), gy.data_ptr())
    if path == "tc":    # one partial a (t, b*h, 16 query rows, column half) at most
        parts = torch.empty(2 * T * B * H * -(-S // 16), dtype=torch.float32,
                            device=q.device)
        jvps = torch.empty(T, dtype=torch.float32, device=q.device)
        err = _fn("swa_attention_mt_jvps_tc")(*ptrs, parts.data_ptr(), jvps.data_ptr(), *tail)
    else:
        parts = torch.empty((B * H, _query_blocks(S, hd, T), T), dtype=torch.float32,
                            device=q.device)
        err = _fn("swa_attention_mt_jvps")(_DTYPE_CODE[q.dtype], *ptrs, parts.data_ptr(),
                                           *tail)
    build.check(err, "swa_attention_mt_jvps")
    launches["swa_attention_mt_jvps"] += 1
    launches_by_path["swa_attention_mt_jvps"][path] += 1
    out = jvps if path == "tc" else parts.sum(dim=(0, 1))
    if calls.recording is not None:
        calls.record("swa_attention_mt_jvps", path, (q, k, v, qds, kds, vds, gy),
                     (out, parts))
    return out
