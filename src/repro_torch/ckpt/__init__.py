"""Sharded, atomic, async checkpointing (counterpart of the JAX package's
``ckpt/``; the on-disk format is the same)."""
from .checkpoint import (CheckpointManager, latest,  # noqa: F401
                         load_checkpoint, save_checkpoint)
