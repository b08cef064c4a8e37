from repro_torch.optim.adamw import AdamWConfig, apply_updates, global_norm, init_state
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "cosine_schedule", "wsd_schedule"]
