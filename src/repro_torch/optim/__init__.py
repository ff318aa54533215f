from repro_torch.optim.adamw import (OptimConfig, adamw_init, adamw_update, clip_by_global_norm,
                                     global_norm, lr_schedule)

__all__ = ["OptimConfig", "adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
           "lr_schedule"]
