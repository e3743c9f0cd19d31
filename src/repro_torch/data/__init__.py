"""Synthetic batches for every family (a port of ``repro/data``)."""
from .synthetic import batch_specs, make_batch, synthetic_stream

__all__ = ["batch_specs", "make_batch", "synthetic_stream"]
