# One <arch>.py per ported architecture (exact published configs), resolved
# by repro_torch.configs.base.get_config.
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config

__all__ = ["ARCH_IDS", "ModelConfig", "get_config"]
