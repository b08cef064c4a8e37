"""gptj-6b — the paper's LLM inference workload (Fig. 11)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gptj-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=16384,
    vocab_size=50400,
    rope_fraction=0.25,
    norm="layernorm", gated_mlp=False, mlp_activation="gelu",
    source="github:kingoflolz/mesh-transformer-jax (paper workload)",
)
