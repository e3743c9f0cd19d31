"""Command-line tools of the port: ``python -m repro_torch.tools.precompile``
and ``python -m repro_torch.tools.trace_export``."""
