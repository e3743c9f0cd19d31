"""Public AutoChunk API: ``autochunk(fn, ChunkConfig(...)) -> ChunkedFunction``.

    cf = autochunk(fn, ChunkConfig(budget_ratio=0.2))
    y  = cf(*args)                                  # lazy per-shape compile
    compiled = cf.trace(*args).search().compile()   # explicit stages

``build_autochunk(fn, example_args, budget_ratio=...)`` is the one-shot
entry point returning an :class:`AutoChunkResult`.  The JAX package's deprecated
``autochunk(fn, example_args, memory_budget)`` form raises here.  A port of
``repro/core/api.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .config import ChunkConfig, ShapeBucketer
from .selection import CostHyper
from .staged import (
    _DEFAULT_BUCKETER,
    AutoChunkResult,
    ChunkedFunction,
    CompiledFunction,
    Planned,
    StageRecord,
    Traced,
)

__all__ = [
    "AutoChunkResult",
    "ChunkConfig",
    "ChunkedFunction",
    "CompiledFunction",
    "Planned",
    "ShapeBucketer",
    "StageRecord",
    "Traced",
    "autochunk",
    "build_autochunk",
]


def build_autochunk(fn: Callable, example_args: Sequence[Any], *,
                    budget_ratio: Optional[float] = None, budget_bytes: Optional[int] = None,
                    weight_argnums: Sequence[int] = (0,), hyper: Optional[CostHyper] = None,
                    max_stages: int = 12, beam: int = 4, window: int = 48,
                    min_gain: float = 0.02, allow_hoist: bool = True,
                    dim_blocklist: Sequence[int] = (), anneal: int = 2,
                    kernel_dispatch: str = "auto", mask_mode: str = "auto",
                    verbose: bool = False, cache=None) -> AutoChunkResult:
    """Run the full AutoChunk pipeline on ``fn`` in one shot.

    ``example_args`` are (pytrees of) tensors, real or on ``meta``; only
    their shapes and dtypes are read.  Exactly one of ``budget_ratio``
    (relative to the baseline activation peak) and ``budget_bytes`` must be
    given.  Equivalent to ``autochunk(fn, ChunkConfig(...),
    bucketer=None).compile(*example_args).result``.
    """
    if (budget_ratio is None) == (budget_bytes is None):
        raise ValueError("give exactly one of budget_ratio / budget_bytes")
    config = ChunkConfig(budget_ratio=budget_ratio, budget_bytes=budget_bytes,
                         weight_argnums=tuple(weight_argnums), hyper=hyper or CostHyper(),
                         max_stages=max_stages, beam=beam, window=window, min_gain=min_gain,
                         allow_hoist=allow_hoist, dim_blocklist=tuple(dim_blocklist),
                         anneal=anneal, kernel_dispatch=kernel_dispatch, mask_mode=mask_mode,
                         verbose=verbose)
    cf = ChunkedFunction(fn, config, cache=cache, bucketer=None)
    return cf.compile(*example_args).result


def _coerce_config(config: Optional[ChunkConfig], kwargs: dict) -> ChunkConfig:
    if "memory_budget" in kwargs:
        # the paper's scalar budget in the new spelling
        mb = kwargs.pop("memory_budget")
        if config is None:
            return ChunkConfig.from_scalar(mb, **kwargs)
        kwargs["budget_ratio" if mb <= 1.0 else "budget_bytes"] = (
            float(mb) if mb <= 1.0 else int(mb))
    if config is None:
        return ChunkConfig(**kwargs)
    if not isinstance(config, ChunkConfig):
        raise TypeError(f"config must be a ChunkConfig, got {type(config).__name__}")
    return config.with_(**kwargs) if kwargs else config


def autochunk(fn: Optional[Callable] = None, config: Optional[ChunkConfig] = None,
              *legacy_args, cache=None, bucketer=_DEFAULT_BUCKETER, **kwargs):
    """The AutoChunk transform; every form returns a :class:`ChunkedFunction`.

    * ``autochunk(fn, ChunkConfig(budget_ratio=0.4))``
    * ``autochunk(fn, budget_ratio=0.4)``: config built from keywords
    * ``@autochunk(ChunkConfig(...))`` / ``@autochunk(budget_ratio=0.4)``

    ``bucketer`` is a :class:`ShapeBucketer` (default: power-of-two buckets)
    or ``None`` to compile strictly per exact shape.
    """
    if callable(fn) and isinstance(config, (tuple, list)):
        raise NotImplementedError(
            "autochunk(fn, example_args, memory_budget) is the JAX package's deprecated"
            " form; use autochunk(fn, ChunkConfig(...)) or build_autochunk(fn, example_args)")
    if legacy_args:
        raise TypeError("autochunk() takes at most (fn, config) positionally; pass"
                        " tuning knobs via ChunkConfig or keywords")
    if fn is None or isinstance(fn, ChunkConfig):
        cfg = _coerce_config(fn if isinstance(fn, ChunkConfig) else config, kwargs)

        def decorate(f: Callable) -> ChunkedFunction:
            return ChunkedFunction(f, cfg, cache=cache, bucketer=bucketer)

        return decorate
    return ChunkedFunction(fn, _coerce_config(config, kwargs), cache=cache, bucketer=bucketer)
