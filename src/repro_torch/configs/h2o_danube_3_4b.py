"""h2o-danube-3-4b — llama/mistral-style dense decoder with sliding-window attn.
[arXiv:2401.16818]
The same fields as ``repro/configs/h2o_danube_3_4b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    attn_pattern="swa",
    window=4096,
    notes="SWA w=4096 -> long_500k runs with ring-buffer cache",
)
