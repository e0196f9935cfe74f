"""whisper-tiny — encoder-decoder; mel/conv frontend STUBBED to frame embeddings.
[arXiv:2212.04356]
The same fields as ``repro/configs/whisper_tiny.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    attn_pattern="full",
    encoder_layers=4,
    encoder_seq=1500,      # precomputed conv frame embeddings (stub)
    frontend="audio",
    use_bias=True,
    rope_theta=0.0,        # whisper uses absolute (sinusoidal) positions
    norm="layernorm",
    act="gelu",
    notes="enc-dec; decode shapes lower the decoder w/ cross-attn memory; long_500k skipped (full attn)",
)
