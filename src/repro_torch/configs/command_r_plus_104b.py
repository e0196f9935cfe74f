"""command-r-plus-104b — dense GQA decoder, no biases.
[hf:CohereForAI/c4ai-command-r-v01]
The same fields as ``repro/configs/command_r_plus_104b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    attn_pattern="full",
    use_bias=False,
    tie_embeddings=True,
    notes="GQA kv=8, no-bias; pure full attention -> long_500k skipped (DESIGN.md §5)",
)
