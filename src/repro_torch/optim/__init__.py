from repro_torch.optim.optimizers import (OptConfig, adafactor_init,
                                          adamw_init, clip_scale,
                                          global_norm, make_optimizer)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["OptConfig", "adamw_init", "adafactor_init", "clip_scale",
           "global_norm", "make_optimizer", "cosine_schedule"]
