"""internvl2-76b — VLM: InternViT frontend (STUB) + InternLM2-76B backbone.
[arXiv:2404.16821]

Per the carve-out, only the language backbone is implemented; `input_specs`
provides precomputed patch embeddings at d_model (projector output).
The same fields as ``repro/configs/internvl2_76b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    attn_pattern="full",
    frontend="vision",
    n_frontend_tokens=256,
    notes="ViT+projector stubbed to 256 patch embeddings; full attention -> long_500k skipped",
)
