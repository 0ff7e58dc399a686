"""Training of the port (counterpart of ``repro.training``): the
``Trainer`` (AdamW with ZeRO-1, microbatches, remat, int8 gradient
compression) and checkpoints with reshard-on-load."""
from .checkpoint import load_checkpoint, save_checkpoint
from .compress import int8_compress_psum
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .train_step import Trainer

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "Trainer",
           "int8_compress_psum", "save_checkpoint", "load_checkpoint"]
