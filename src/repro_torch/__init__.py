"""PyTorch/CUDA port of the AutoChunk reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports neither
it nor ``jax``.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU, where every kernel wrapper takes its plain PyTorch
version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
