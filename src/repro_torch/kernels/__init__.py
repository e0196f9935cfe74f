"""Hand-written Hopper kernels of the port and their dispatch.

lora_dual/      LoRA multi-tangent projection (tangents of every LoRA
                projection inside the estimator) and its jvp-contraction
                epilogue (the final site of a 'lora' split loss)
swa_attention/  causal (sliding-window) GQA flash attention: primal,
                multi-tangent, and the multi-tangent contraction epilogue
                (the dense family's final site on the fused route)
mamba2_scan/    the Mamba2 state recurrence: primal, multi-tangent, and the
                multi-tangent contraction epilogue (the hybrid family's
                final site on the fused route)
wkv6_scan/      the RWKV6 WKV recurrence: primal, multi-tangent, and the
                multi-tangent contraction epilogue (the ssm family's final
                site on the fused route)
dispatch.py     forward-mode rules that route the model's LoRA projections,
                attention mixers and mamba2 / wkv6 recurrences to those kernels,
                and the contraction ops of the fused-contraction route
calls.py        the forward-AD region and the recorder of the calls that
                reach a kernel entry point (``record_calls``)
build.py        nvcc build at first use, ctypes loading
csrc/           the CUDA sources

Each kernel module keeps a plain PyTorch version beside its wrapper (CPU
tensors take it) and a launch counter that only a kernel launch moves; the
wrappers with more than one kernel route (``lora_dual_mt`` and its
contraction epilogue, ``lora_dual_multi``, the ``swa_attention`` primal,
tangents and contraction epilogue, ``wkv6_scan_mt_tangents``, and the
mamba2 and wkv6 contraction epilogues) also count their calls by route.
"""
from repro_torch.kernels.lora_dual import ops as _lora_ops
from repro_torch.kernels.mamba2_scan import ops as _mamba2_ops
from repro_torch.kernels.swa_attention import ops as _swa_ops
from repro_torch.kernels.wkv6_scan import ops as _wkv6_ops

_COUNTERS = (_lora_ops.launches, _swa_ops.launches, _mamba2_ops.launches,
             _wkv6_ops.launches)
_PATH_COUNTERS = (_lora_ops.launches_by_path, _swa_ops.launches_by_path,
                  _mamba2_ops.launches_by_path, _wkv6_ops.launches_by_path)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def launch_paths() -> dict:
    """{kernel name: {route: launches since the last reset}} for the kernels
    with more than one route."""
    return {k: dict(v) for c in _PATH_COUNTERS for k, v in c.items()}


def reset_launch_counts() -> None:
    """Zero every launch counter, the per-route ones included."""
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
    for c in _PATH_COUNTERS:
        for paths in c.values():
            for p in paths:
                paths[p] = 0
