from repro_torch.kernels.swa_attention.ops import (
    swa_attention,
    swa_attention_mt_jvps,
    swa_attention_mt_jvps_ref,
    swa_attention_mt_tangents,
    swa_attention_mt_tangents_ref,
    swa_attention_ref,
)
