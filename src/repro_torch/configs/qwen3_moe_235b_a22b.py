"""qwen3-moe-235b-a22b — MoE 128 experts top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B family card]
The same fields as ``repro/configs/qwen3_moe_235b_a22b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,             # per-expert hidden (matches pool spec)
    vocab=151936,
    attn_pattern="full",
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    notes="expert-parallel over model axis; full attention -> long_500k skipped",
)
