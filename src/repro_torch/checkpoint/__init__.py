"""Fault-tolerant checkpointing in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpointer import (CheckpointCorruptError,
                                                 Checkpointer)

__all__ = ["CheckpointCorruptError", "Checkpointer"]
