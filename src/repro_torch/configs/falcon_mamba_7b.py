"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1, num_kv_heads=1, head_dim=64,   # attention-free; placeholders
    d_ff=0,
    vocab_size=65024,
    layer_pattern=("mamba",),
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    norm="rmsnorm",
    source="arXiv:2410.05355",
)
