"""Hand-written Hopper kernels of the port and their dispatch.

lora_dual/      LoRA multi-tangent projection (tangents of every LoRA
                projection inside the estimator) and its jvp-contraction
                epilogue (the final site of a 'lora' split loss)
swa_attention/  causal (sliding-window) GQA flash attention: primal,
                multi-tangent, and the multi-tangent contraction epilogue
                (the dense family's final site on the fused route)
dispatch.py     forward-mode rules that route the model's LoRA projections
                and attention mixers to those kernels, and the contraction
                ops of the fused-contraction route
build.py        nvcc build at first use, ctypes loading
csrc/           the CUDA sources

Each kernel module keeps a plain PyTorch version beside its wrapper (CPU
tensors take it) and a launch counter that only a kernel launch moves.
"""
from repro_torch.kernels.lora_dual import ops as _lora_ops
from repro_torch.kernels.swa_attention import ops as _swa_ops

_COUNTERS = (_lora_ops.launches, _swa_ops.launches)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
