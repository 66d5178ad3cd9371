"""Model / shape configuration schema (the port's own copy of the JAX
package's `configs/base.py`, field for field).

One `ModelConfig` per assigned architecture lives in `configs/<id>.py`
with the exact published numbers; `reduced()` derives the small smoke-test
variant of the same family.  `ShapeSpec` defines the assigned input shapes
(train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # norms / activations
    mlp_act: str = "swiglu"      # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    qk_norm: bool = False
    # attention pattern
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0   # glm4: rotary on half the head dim
    sliding_window: int = 0      # 0 = full attention
    local_global_ratio: int = 0  # gemma3: 5 local then 1 global, repeating
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    n_global_attn_layers: int = 0   # hymba: few full-attention layers
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500         # whisper frame positions (stub frontend)
    # modality frontend stubs
    frontend: str = "none"          # none | patches | frames
    num_frontend_tokens: int = 0    # llava: image patch tokens per sample
    tie_embeddings: bool = True
    # dtype policy
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embeddings/logits shard over the
        model axis (granite 49155, hymba 32001, whisper 51866 don't divide
        16); logits at padded ids are masked to -inf."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid with windowed attention)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        qo = d * self.n_heads * hd * 2
        kv = d * self.n_kv_heads * hd * 2
        if self.family == "ssm":                       # rwkv6 time+channel mix
            att = self.n_layers * (4 * d * d + d * self.d_ff * 2 + d * d)
            mlp = 0
        else:
            att = self.n_layers * (qo + kv)
            if self.n_experts:
                mlp = self.n_layers * (
                    self.n_experts * 3 * d * self.moe_d_ff
                    + self.n_shared_experts * 3 * d * self.moe_d_ff
                    + d * self.n_experts)
            else:
                ff_mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
                mlp = self.n_layers * ff_mult * d * self.d_ff
        if self.family == "hybrid":
            din = self.ssm_expand * d
            mlp += self.n_layers * (2 * d * din + din * self.ssm_state * 2)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (qo + kv + 2 * d * self.d_ff)
            att += self.n_layers * (qo + kv)           # cross attention
        return att + mlp + emb + enc

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Same family, tiny: for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            moe_d_ff=64 if self.n_experts else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            vocab_size=256,
            num_frontend_tokens=min(self.num_frontend_tokens, 8),
            encoder_len=16,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            n_global_attn_layers=min(self.n_global_attn_layers, 1),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str    # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: O(L^2) at 500k — skipped per assignment"
    return True, ""
