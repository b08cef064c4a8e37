"""glm4-9b — dense, GQA kv=2, half-dim RoPE [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_fraction=0.5,
    norm="rmsnorm",
    source="hf:THUDM/glm-4-9b",
)
