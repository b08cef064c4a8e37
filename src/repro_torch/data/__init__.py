from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, to_device

__all__ = ["DataConfig", "SyntheticCorpus", "to_device"]
