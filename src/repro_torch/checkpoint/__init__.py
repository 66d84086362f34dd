"""Checkpointing of the port."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)

__all__ = ["Checkpointer", "latest_step", "save_checkpoint",
           "restore_checkpoint"]
