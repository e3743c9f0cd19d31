"""Carry the JAX package's parameters into the port.

The JAX side hands over its parameter pytree with every leaf turned into a
numpy array (``jax.tree.map(np.asarray, params)``); this module builds the
port's :class:`~repro_torch.models.model.Model` from it, in the stacked
(``scan_layers``) form or the list form, whichever the tree has.  Nothing
here imports JAX: the tree is plain dicts, lists and numpy arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device
from .models.model import Model


def numpy_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """Copy one array onto ``device``; bfloat16 (ml_dtypes) goes by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _convert(tree: Any, device):
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return numpy_to_torch(tree, device)


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], *,
                      device="cuda") -> Model:
    """The port's model holding the same numbers as the JAX ``tree``."""
    dev = resolve_device(device)
    return Model(cfg, _convert(tree, dev))
