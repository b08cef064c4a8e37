"""llama2-13b — the paper's LLM inference workload (Fig. 11)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40, num_kv_heads=40, head_dim=128,
    d_ff=13824,
    vocab_size=32000,
    norm="rmsnorm",
    source="arXiv:2307.09288 (paper workload)",
)
