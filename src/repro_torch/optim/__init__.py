"""Optimizers, LR schedule and gradient compression of the port."""
from repro_torch.optim.compression import compress_grad, decompress_grad
from repro_torch.optim.optimizers import (OptState, adafactor_init,
                                          adamw_init, clip_by_global_norm,
                                          opt_init, opt_init_specs,
                                          opt_update)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["OptState", "adamw_init", "adafactor_init", "opt_init",
           "opt_init_specs", "opt_update", "clip_by_global_norm",
           "cosine_schedule", "compress_grad", "decompress_grad"]
