"""qwen3-moe-235b-a22b — 128 experts top-8, GQA kv=4 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536,                       # (unused: every layer is MoE)
    vocab_size=151936,
    num_experts=128, experts_per_tok=8,
    moe_d_ff=1536,
    rope_theta=1e6,
    norm="rmsnorm",
    source="hf:Qwen/Qwen3-30B-A3B",
)
