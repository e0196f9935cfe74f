"""roberta-large (355M) — the paper's primary sub-billion evaluation model.
[arXiv:1907.11692] Finetuned with LoRA r=1, alpha=1 (paper Appendix B).
Same published widths as ``repro/configs/roberta_large_lora.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="roberta-large-lora",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=50265,
    attn_pattern="full",
    use_bias=True,
    norm="layernorm",
    act="gelu",
    n_classes=4,
    notes="paper's own model; used for the faithful-repro benchmarks",
)
