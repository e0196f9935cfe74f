from repro_torch.kernels.lora_dual.ops import (
    lora_dual_mt_jvps,
    lora_dual_mt_jvps_ref,
    lora_dual_mt_tangents,
    lora_dual_mt_tangents_ref,
    lora_dual_multi,
    lora_dual_multi_ref,
)
