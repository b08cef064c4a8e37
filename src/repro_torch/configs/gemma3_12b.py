"""gemma3-12b — dense, 5:1 local:global attention, 128k ctx, 262k vocab
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=1024,
    rope_theta=1e6,
    norm="rmsnorm", mlp_activation="gelu",
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
