"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist.

    Entry points default to ``"cuda"`` and never carry on on the CPU by
    themselves: without a card they raise, and the caller opts into the
    CPU (plain PyTorch kernels) with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but CUDA is not"
            " available here; pass device='cpu' (CLI: --device cpu) to run"
            " the plain PyTorch kernels on the CPU"
        )
    return dev
