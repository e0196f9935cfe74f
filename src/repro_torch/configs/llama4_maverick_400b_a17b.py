"""llama4-maverick-400b-a17b — MoE 128 experts top-1 + shared expert,
early-fusion multimodal (image tokens arrive as STUB embeddings).
[hf:meta-llama/Llama-4-Scout-17B-16E family card]
The same fields as ``repro/configs/llama4_maverick_400b_a17b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,             # per-expert hidden (matches pool spec)
    vocab=202048,
    attn_pattern="full",
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192, n_shared_experts=1),
    frontend="vision",
    n_frontend_tokens=128, # early-fusion image tokens (stub embeddings)
    notes="top-1 routing + shared expert; full attention in this config -> long_500k skipped",
)
