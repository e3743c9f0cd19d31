"""Tree checkpointing to .npz (flat key paths, dtype-preserving).

The flat keys are the JAX package's pytree paths (``blocks/attn/wq``,
list entries by index: ``blocks/0/attn/wq``), so a float32 checkpoint
written by either package loads in the other.  bfloat16 is stored by its
bits, as a 2-byte void array: the layout ``np.savez`` gives an ml_dtypes
``bfloat16`` array, and the one ``interop.numpy_to_torch`` reads.

A tree is a :class:`~repro_torch.models.model.Model` (any ``ParamTree``),
or nested dicts / lists / tuples of tensors.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..interop import numpy_to_torch
from ..models.model import Model


def _map_with_paths(tree, fn: Callable[[str, torch.Tensor], Any], prefix: str = ""):
    """``tree`` with each tensor ``t`` at path ``k`` replaced by ``fn(k, t)``;
    a module becomes nested dicts (a ``ModuleList`` a list)."""
    if isinstance(tree, nn.ModuleList):
        return [_map_with_paths(m, fn, f"{prefix}{i}/") for i, m in enumerate(tree)]
    if isinstance(tree, nn.Module):
        out = {name: fn(prefix + name, p) for name, p in tree.named_parameters(recurse=False)}
        for name, sub in tree.named_children():
            out[name] = _map_with_paths(sub, fn, f"{prefix}{name}/")
        return out
    if isinstance(tree, Mapping):
        return {k: _map_with_paths(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}

    def put(key, t):
        flat[key] = _to_numpy(t)

    _map_with_paths(tree, put)
    return flat


def save_checkpoint(path: str, tree, *, step: int = 0, extra: Dict | None = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    flat = _flatten_with_paths(tree)
    meta = {"step": step, "extra": extra or {}, "keys": sorted(flat)}
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_checkpoint(path: str, tree_like) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like``.  Returns (tree, step).

    Each leaf takes ``tree_like``'s dtype and device.  For a ``Model`` the
    tree is a new ``Model`` of the same config (frozen, as ``init_params``
    gives it)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))

        def restore(key, ref: torch.Tensor):
            if key not in data:
                raise KeyError(f"checkpoint missing key {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(ref.shape)}")
            return numpy_to_torch(arr, ref.device).to(ref.dtype)

        tree = _map_with_paths(tree_like, restore)
    if isinstance(tree_like, Model):
        tree = Model(tree_like.cfg, tree)
    return tree, int(meta["step"])
