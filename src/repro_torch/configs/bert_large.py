"""bert-large — the paper's own BERT workload (Fig. 9/10; encoder-only,
bidirectional, post-LN approximated as pre-LN layernorm)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-large",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096,
    vocab_size=30522,
    layer_pattern=("bidir",),
    norm="layernorm", gated_mlp=False, mlp_activation="gelu",
    tie_embeddings=True,
    source="arXiv:1810.04805 (paper workload)",
)
