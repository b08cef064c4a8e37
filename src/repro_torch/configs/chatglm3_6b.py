"""chatglm3-6b — dense, GQA kv=2, 2D (half-dim) RoPE [arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,
    norm="rmsnorm",
    source="arXiv:2406.12793",
)
