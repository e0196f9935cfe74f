"""gemma3-27b — dense decoder, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family card]
The same fields as ``repro/configs/gemma3_27b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    attn_pattern="local_global",
    local_global_ratio=5,
    window=1024,
    rope_theta=1e6,
    tie_embeddings=True,
    notes="5 local (w=1024) : 1 global; sub-quadratic decode -> long_500k runs",
)
