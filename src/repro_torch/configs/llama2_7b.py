"""llama2-7b — the paper's primary billion-scale evaluation model.
[arXiv:2307.09288] bf16 + LoRA, as ``repro/configs/llama2_7b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=32000,
    attn_pattern="full",
    notes="paper's own model; used for the faithful-repro memory benchmark",
)
