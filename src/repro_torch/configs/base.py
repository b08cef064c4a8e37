"""Architecture configuration (stdlib only).

A copy of ``repro/configs/base.py``: the same ``ModelConfig`` fields,
``padded_vocab``, ``reduced()`` and ``get_config``, so a config built here
compares equal field by field with the reference one.  Only the
architectures of the ported slices are registered (dense decoders, gemma3's
5:1 local:global pattern among them, the encoder-only bert-large, the
attention-free Mamba-1 LM and qwen3-moe-235b, whose every layer is a
top-k mixture of experts); the rest of
the reference's zoo joins as the port grows (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional

__all__ = ["ModelConfig", "get_config", "ARCH_IDS", "REFERENCE_ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads

    # attention details
    rope_theta: float = 1e4
    rope_fraction: float = 1.0      # partial rotary (gptj = 0.25)
    sliding_window: Optional[int] = None
    layer_pattern: tuple[str, ...] = ("attn",)   # repeating block kinds
    attn_logit_softcap: Optional[float] = None

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    moe_period: int = 1
    capacity_factor: float = 1.25

    # MLA
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 → ceil(d_model / 16)

    # encoder-decoder
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0

    # modality frontend stubs
    frontend: Optional[str] = None
    num_patches: int = 0

    # misc
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    use_fusion: bool = False
    dropout_rate: float = 0.0
    gated_mlp: bool = True
    mlp_activation: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_state and not self.ssm_dt_rank:
            object.__setattr__(self, "ssm_dt_rank", math.ceil(self.d_model / 16))

    @property
    def padded_vocab(self) -> int:
        """Embedding/LM-head rows padded to a multiple of 256; the padded
        logits are masked to -1e30 at decode."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def _layer_kinds(self):
        kinds = []
        for i in range(self.num_layers):
            kind = self.layer_pattern[i % self.pattern_period]
            moe_here = (
                self.is_moe
                and i >= self.first_k_dense
                and (i % self.moe_period == self.moe_period - 1
                     or self.moe_period == 1)
            )
            kinds.append((kind, moe_here))
        return kinds

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (same numbers as the
        reference's ``reduced()``)."""
        period = self.pattern_period
        n_layers = max(period, 2 if period == 1 else period)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_tok=min(self.experts_per_tok, 2),
            moe_d_ff=64 if self.is_moe else 0,
            capacity_factor=1e9,
            kv_lora_rank=32 if self.use_mla else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            rope_head_dim=8 if self.use_mla else 64,
            ssm_state=min(self.ssm_state, 8),
            ssm_dt_rank=4 if self.ssm_state else 0,
            sliding_window=32 if self.sliding_window else None,
            encoder_layers=2 if self.is_encdec else 0,
            encoder_seq=16 if self.is_encdec else 0,
            num_patches=8 if self.frontend == "vision_stub" else 0,
            first_k_dense=min(self.first_k_dense, 1),
            dtype="float32",
        )


# The architectures the port runs.
ARCH_IDS = ["minicpm_2b", "gptj_6b", "llama2_13b", "falcon_mamba_7b", "bert_large",
            "chatglm3_6b", "glm4_9b", "gemma3_12b", "qwen3_moe_235b"]

# Every architecture of the reference package; those not in ARCH_IDS are
# still to be ported.
REFERENCE_ARCH_IDS = [
    "falcon_mamba_7b", "deepseek_v2_236b", "qwen3_moe_235b", "whisper_small",
    "chatglm3_6b", "gemma3_12b", "minicpm_2b", "glm4_9b",
    "jamba_1_5_large", "llava_next_34b",
    "bert_large", "gptj_6b", "llama2_13b",
]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        if arch in REFERENCE_ARCH_IDS:
            raise KeyError(
                f"arch {arch!r} is not ported yet (see ROADMAP.md, Queue 1); "
                f"ported: {ARCH_IDS}")
        raise KeyError(f"unknown arch {arch!r}; known: {REFERENCE_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
