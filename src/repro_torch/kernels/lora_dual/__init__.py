from repro_torch.kernels.lora_dual.ops import (
    lora_dual_mt_tangents,
    lora_dual_mt_tangents_ref,
)
