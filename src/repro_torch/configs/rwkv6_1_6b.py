"""rwkv6-1.6b (Finch): attention-free RNN with data-dependent decay.
[arXiv:2404.05892] As ``repro/configs/rwkv6_1_6b.py``. Its family (ssm)
is ported for training and serving."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # wkv heads = d_model / head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    notes="attn-free; O(1) decode state -> long_500k runs; SPRY splits LoRA on r/k/v/g/o projections",
)
