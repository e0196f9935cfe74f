"""zamba2-1.2b — Mamba2 backbone with a SHARED attention block interleaved.
[arXiv:2411.15242] As ``repro/configs/zamba2_1_2b.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2),
    hybrid_attn_every=6,   # shared-weight attention block applied every 6 mamba blocks
    window=4096,           # the shared attn block uses a bounded window for 500k decode
    attn_pattern="swa",
    notes="Mamba2 + shared attn; recurrent state + windowed attn -> long_500k runs",
)
