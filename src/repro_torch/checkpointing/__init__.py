"""Checkpoints to .npz under the JAX package's pytree paths (a port of
``repro/checkpointing``)."""
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
