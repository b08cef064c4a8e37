from repro_torch.checkpoint.checkpoint import (all_steps, latest_step,
                                               restore_checkpoint, save_checkpoint)

__all__ = ["all_steps", "latest_step", "restore_checkpoint", "save_checkpoint"]
