"""Config dataclasses: model architectures, input shapes and FL settings.

Port of ``repro/configs/base.py`` for every family: dense, moe, vlm,
audio (encoder-decoder), hybrid (zamba2) and ssm (rwkv6).
``ModelConfig.dtype`` maps ``param_dtype`` to a torch dtype (the reference
maps it to a jnp dtype). The parameter estimates and ``INPUT_SHAPES`` are
the reference's. ``reduce_config`` derives the CPU smoke-test variant (2
layers, d_model=256, <=4 experts) exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    n_shared_experts: int = 0     # dense experts always applied (llama4 style)
    router_chunk: int = 2048      # tokens a dispatch chunk


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                     # 'rwkv6' | 'mamba2'
    state_dim: int = 64           # mamba2 N
    head_dim: int = 64
    conv_kernel: int = 4          # mamba2 depthwise conv width
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    attn_pattern: str = "full"                # full | swa | local_global
    window: int = 4096
    local_global_ratio: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0                # zamba2: shared attn after every N blocks
    encoder_layers: int = 0                   # whisper: encoder depth
    encoder_seq: int = 0                      # frame embeddings the encoder reads
    frontend: Optional[str] = None            # 'vision' | 'audio' (stub embeddings)
    n_frontend_tokens: int = 0                # image patch tokens prepended
    norm: str = "rmsnorm"
    act: str = "silu"
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    param_dtype: str = "bfloat16"
    n_classes: int = 0                        # >0 adds a classifier head
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def sub_quadratic(self) -> bool:
        """True if the architecture supports 500k-token decode structurally
        (bounded window / recurrent state)."""
        return (self.family in ("ssm", "hybrid")
                or self.attn_pattern in ("swa", "local_global"))

    def is_global_layer(self, i: int) -> bool:
        if self.attn_pattern == "full":
            return True
        if self.attn_pattern == "swa":
            return False
        return (i % (self.local_global_ratio + 1)) == self.local_global_ratio

    def _per_layer(self, experts: int):
        """(attention, FFN) parameters of one layer; a MoE FFN counts
        ``experts`` routed experts and the shared ones."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.family == "ssm" and self.ssm and self.ssm.kind == "rwkv6":
            attn = 5 * d * d + d * d  # r,k,v,g,w projections + output
        if self.moe is not None:
            ffn = 3 * d * self.moe.d_expert * (experts + self.moe.n_shared_experts)
        else:
            ffn = 3 * d * self.d_ff
        return attn, ffn

    def _decoder_estimate(self, experts: int) -> int:
        attn, ffn = self._per_layer(experts)
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + 2 * self.d_model) + emb

    def n_param_estimate(self) -> float:
        """Rough total parameter count (the reference's MODEL_FLOPS = 6·N·D)."""
        experts = self.moe.n_experts if self.moe is not None else 0
        total = self._decoder_estimate(experts)
        if self.encoder_layers:
            attn, ffn = self._per_layer(experts)
            total += self.encoder_layers * (2 * attn + ffn + 3 * self.d_model)
        return float(total)

    def n_active_param_estimate(self) -> float:
        """Active params per token (MoE counts top_k + shared experts only)."""
        if self.moe is None:
            return self.n_param_estimate()
        return float(self._decoder_estimate(self.moe.top_k))


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class SpryConfig:
    """Hyperparameters of the paper's algorithm (Alg. 1 + §3)."""
    n_clients_per_round: int = 16        # M
    n_total_clients: int = 100
    sampling_rate: float = 0.16          # s (read by no in-process path)
    k_perturbations: int = 1             # K
    tangent_batch: int | None = None     # None = all K in one batched pass;
                                         # 1 = sequential; 1<b<K = groups of b
    fused_contraction: bool = False      # contract the final mixer site's K
                                         # tangent outputs against the post-head
                                         # cotangent in-kernel (split losses)
    local_lr: float = 1e-4               # eta_l
    server_lr: float = 1e-2              # eta
    server_opt: str = "fedyogi"          # fedyogi | fedadam | fedavg | fedsgd | fedadagrad
    client_opt: str = "sgd"              # sgd | adamw (backprop baselines)
    comm_mode: str = "per_epoch"         # per_epoch | per_iteration: the
                                         # runtime engines' default mode
                                         # (fl.runtime); make_round_step
                                         # raises on per_iteration
    local_iters: int = 1
    microbatch_size: int | None = None   # grad-accumulation chunk (None = full batch)
    jvp_clip: float | None = None
    lora_rank: int = 1                   # paper default r=1, alpha=1
    lora_alpha: float = 1.0
    lora_targets: Tuple[str, ...] = ("wq", "wv")
    peft: str = "lora"                   # lora | ia3 | bitfit | classifier_only (all ported)
    dirichlet_alpha: float = 0.1
    seed: int = 0


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """2 layers, d_model=256, <=4 experts — same family, runnable on CPU."""
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads if cfg.n_kv_heads >= cfg.n_heads else 2))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
                                  top_k=min(cfg.moe.top_k, 2), d_expert=128,
                                  router_chunk=64)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, head_dim=32, state_dim=16)
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=256,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=64,
        d_ff=512,
        vocab=512,
        window=64,
        moe=moe,
        ssm=ssm,
        hybrid_attn_every=1 if cfg.hybrid_attn_every else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
        param_dtype="float32",
        n_classes=cfg.n_classes or 4,
    )
