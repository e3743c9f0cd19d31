"""Compilation configuration: :class:`ChunkConfig` and :class:`ShapeBucketer`.

``ChunkConfig`` holds every AutoChunk tuning knob in one frozen, validated,
serializable dataclass, field for field as the JAX package's.  Knobs whose
machinery is not ported yet are accepted at their defaults and raise
``NotImplementedError`` otherwise, naming the ROADMAP item that ports them.

``ShapeBucketer`` maps tensor dims onto a small set of buckets (power-of-two
by default, or explicit boundaries).  Two input signatures in the same
bucket share one searched plan: the plan found at the first shape is
replayed, rescaled, for every other shape in the bucket.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .selection import CostHyper

CACHE_POLICIES = ("lru", "cost_lfu")


def _as_int_tuple(name: str, xs: Sequence[int]) -> Tuple[int, ...]:
    try:
        out = tuple(sorted({int(x) for x in xs}))
    except (TypeError, ValueError) as e:
        raise ValueError(f"{name} must be a sequence of ints, got {xs!r}") from e
    if any(x < 0 for x in out):
        raise ValueError(f"{name} entries must be >= 0, got {xs!r}")
    return out


@dataclass(frozen=True)
class ChunkConfig:
    """All AutoChunk tuning knobs, validated and serializable.

    Exactly one of ``budget_ratio`` / ``budget_bytes`` is active; when
    neither is given the paper's default 50% activation budget applies.

    ``budget_ratio``    activation budget as a fraction of the baseline peak
    ``budget_bytes``    absolute activation budget
    ``weight_argnums``  which arguments are parameters (not activations)
    ``hyper``           selection cost hyper-parameters (:class:`CostHyper`)
    ``max_stages``      max chunk stages applied per compile
    ``beam``            candidates rewritten and re-estimated per stage
    ``window``          max region width considered by the search
    ``min_gain``        min fractional peak reduction for a stage to count
    ``allow_hoist``     hoist chunk-invariant subgraphs out of the loop
    ``dim_blocklist``   tensor dims never chunked
    ``anneal``          budget-halving retries when the target is missed
    ``kernel_dispatch`` fused CUDA kernels for matched chunk-loop bodies:
                        ``'auto'`` (dispatch when CUDA is available),
                        ``'on'`` (always; on CPU tensors the wrappers run
                        their plain versions), ``'off'`` (never)
    ``kernel_target``   the device whose kernels a dispatched site must fit:
                        ``'cuda'`` (a site whose shapes the CUDA kernel
                        refuses keeps its chunk loop) or ``'cpu'`` (the plain
                        versions take any shape); None follows the device of
                        the compiled inputs, and for ``meta`` inputs CUDA
                        when it is available
    ``autotune``        ``'auto'``/``'off'``; ``'on'`` waits for ROADMAP item 7
    ``mask_mode``       ``'auto'`` computes causal / sliding-window masks from
                        positions inside the kernel; ``'bool'`` streams every
                        mask as a bool array
    ``mesh_spec``       must be None (device meshes: ROADMAP item 11)
    ``canonical_bucket_exec``
                        compile one executable per shape bucket, at the
                        bucket's boundary shape, and serve every other
                        length in the bucket by right-padding the inputs to
                        the boundary and slicing the outputs back.  The
                        function must be length-masked: real outputs may not
                        depend on padded content (a causal forward is).
                        Part of the cache token
    ``cache_max_entries`` / ``cache_policy``
                        plan-cache eviction after each compile (``'lru'`` or
                        ``'cost_lfu'``); operational, never identity
    ``verbose``         per-stage progress printing (not part of the key)
    """

    budget_ratio: Optional[float] = None
    budget_bytes: Optional[int] = None
    weight_argnums: Tuple[int, ...] = (0,)
    hyper: CostHyper = field(default_factory=CostHyper)
    max_stages: int = 12
    beam: int = 4
    window: int = 48
    min_gain: float = 0.02
    allow_hoist: bool = True
    dim_blocklist: Tuple[int, ...] = ()
    anneal: int = 2
    kernel_dispatch: str = "auto"
    kernel_target: Optional[str] = None
    autotune: str = "auto"
    mask_mode: str = "auto"
    mesh_spec: Optional[Any] = None
    canonical_bucket_exec: bool = False
    cache_max_entries: Optional[int] = None
    cache_policy: str = "lru"
    verbose: bool = False

    def __post_init__(self):
        if self.budget_ratio is not None and self.budget_bytes is not None:
            raise ValueError("give at most one of budget_ratio / budget_bytes")
        if self.budget_ratio is None and self.budget_bytes is None:
            object.__setattr__(self, "budget_ratio", 0.5)
        if self.budget_ratio is not None and not 0.0 < self.budget_ratio <= 1.0:
            raise ValueError(f"budget_ratio must be in (0, 1], got {self.budget_ratio}")
        if self.budget_bytes is not None:
            if int(self.budget_bytes) < 1:
                raise ValueError(f"budget_bytes must be >= 1, got {self.budget_bytes}")
            object.__setattr__(self, "budget_bytes", int(self.budget_bytes))
        for name, lo in (("max_stages", 1), ("beam", 1), ("window", 1), ("anneal", 0)):
            v = getattr(self, name)
            if not isinstance(v, int) or v < lo:
                raise ValueError(f"{name} must be an int >= {lo}, got {v!r}")
        if self.min_gain < 0:
            raise ValueError(f"min_gain must be >= 0, got {self.min_gain}")
        if self.kernel_dispatch not in ("auto", "on", "off"):
            raise ValueError("kernel_dispatch must be 'auto', 'on', or 'off',"
                             f" got {self.kernel_dispatch!r}")
        if self.kernel_target not in (None, "cuda", "cpu"):
            raise ValueError(f"kernel_target must be None, 'cuda' or 'cpu', got"
                             f" {self.kernel_target!r}")
        if self.autotune not in ("auto", "on", "off"):
            raise ValueError(f"autotune must be 'auto', 'on', or 'off', got {self.autotune!r}")
        if self.mask_mode not in ("auto", "bool"):
            raise ValueError(f"mask_mode must be 'auto' or 'bool', got {self.mask_mode!r}")
        if self.cache_policy not in CACHE_POLICIES:
            raise ValueError(f"cache_policy must be one of {CACHE_POLICIES}, got"
                             f" {self.cache_policy!r}")
        if self.cache_max_entries is not None and (
                not isinstance(self.cache_max_entries, int) or self.cache_max_entries < 0):
            raise ValueError("cache_max_entries must be None or an int >= 0, got"
                             f" {self.cache_max_entries!r}")
        if not isinstance(self.hyper, CostHyper):
            raise ValueError(f"hyper must be a CostHyper, got {type(self.hyper).__name__}")
        object.__setattr__(self, "weight_argnums",
                           _as_int_tuple("weight_argnums", self.weight_argnums))
        object.__setattr__(self, "dim_blocklist",
                           _as_int_tuple("dim_blocklist", self.dim_blocklist))
        if self.mesh_spec is not None:
            raise NotImplementedError("mesh_spec: mesh-aware planning is ROADMAP queue A item 11")
        if self.autotune == "on":
            raise NotImplementedError("autotune='on': the kernel autotuner is ROADMAP queue A"
                                      " item 7")

    # ------------------------------------------------------------------
    @classmethod
    def from_scalar(cls, budget: float, **kw) -> "ChunkConfig":
        """The paper's scalar budget: <= 1.0 is a ratio of the baseline
        activation peak, > 1.0 is absolute bytes."""
        if budget <= 1.0:
            return cls(budget_ratio=float(budget), **kw)
        return cls(budget_bytes=int(budget), **kw)

    def with_(self, **kw) -> "ChunkConfig":
        """Derived config (same ``.with_`` idiom as the model configs)."""
        if "budget_bytes" in kw and "budget_ratio" not in kw:
            kw.setdefault("budget_ratio", None)
        if "budget_ratio" in kw and "budget_bytes" not in kw:
            kw.setdefault("budget_bytes", None)
        return dataclasses.replace(self, **kw)

    def resolve_budget(self, baseline_peak: int) -> int:
        """Absolute activation budget in bytes for a given baseline peak."""
        if self.budget_bytes is not None:
            return self.budget_bytes
        return int(baseline_peak * self.budget_ratio)

    def search_knobs(self, grad: bool = False) -> Dict[str, Any]:
        """The knobs that can change a search result, in the JAX package's
        layout (``kernel_dispatch`` resolved for a compile that needs
        gradients when ``grad``)."""
        return {
            "max_stages": self.max_stages,
            "beam": self.beam,
            "window": self.window,
            "min_gain": self.min_gain,
            "allow_hoist": self.allow_hoist,
            "dim_blocklist": sorted(self.dim_blocklist),
            "anneal": self.anneal,
            "kernel_dispatch": self.resolve_kernel_dispatch(grad),
            "autotune": self.resolve_autotune(),
            "mask_mode": self.mask_mode,
            "mesh": None,
        }

    def resolve_kernel_dispatch(self, grad: bool = False) -> bool:
        """Whether the kernel-dispatch pass runs: ``'auto'`` dispatches when
        CUDA is available (the JAX package: when on a TPU).

        ``grad`` marks a compile whose call needs gradients.  No kernel of
        either package has a backward, so there ``'auto'`` resolves off (as
        the JAX package's does on every backend its training runs on) and
        ``'on'`` raises."""
        if grad:
            if self.kernel_dispatch == "on":
                raise NotImplementedError(
                    "kernel_dispatch='on' in a compile that needs gradients: no kernel of"
                    " either package has a backward (ROADMAP queue A item 12: training"
                    " runs the generic chunk loops); use 'auto' or 'off'")
            return False
        if self.kernel_dispatch == "on":
            return True
        if self.kernel_dispatch == "off":
            return False
        return torch.cuda.is_available()

    def resolve_kernel_target(self, device: Optional[str] = None) -> str:
        """``'cuda'`` or ``'cpu'``: ``kernel_target`` if set, else ``device``
        (the compiled inputs' device type) if it is one of the two, else
        CUDA when it is available.  Never CPU for inputs on the card."""
        if self.kernel_target is not None:
            return self.kernel_target
        if device in ("cuda", "cpu"):
            return device
        return default_kernel_target()

    def resolve_autotune(self) -> bool:
        """The autotuner is not ported (ROADMAP queue A item 7): never runs."""
        return False

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        for k in ("verbose", "cache_max_entries", "cache_policy"):
            d.pop(k)  # presentation / eviction only, never identity
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChunkConfig":
        d = dict(d)
        for k in ("verbose", "cache_max_entries", "cache_policy"):
            d.pop(k, None)
        hyper = d.pop("hyper", None)
        if isinstance(hyper, dict):
            hyper = CostHyper(**hyper)
        return cls(hyper=hyper or CostHyper(),
                   **{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    def cache_token(self, device: Optional[str] = None, grad: bool = False) -> str:
        """Stable digest of everything that can change a search result
        (``kernel_dispatch`` and ``kernel_target`` at their resolved values,
        the target for inputs on ``device``, and whether the compile needs
        gradients)."""
        d = self.to_dict()
        d["kernel_dispatch"] = self.resolve_kernel_dispatch(grad)
        if grad:
            d["grad"] = True
        d["kernel_target"] = self.resolve_kernel_target(device)
        d["autotune"] = self.resolve_autotune()
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()


def default_kernel_target() -> str:
    """The dispatch target when nothing names one: the card if there is one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# Shape bucketing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeBucketer:
    """Round tensor dims onto bucket boundaries for plan reuse.

    ``buckets``  explicit ascending boundaries (e.g. ``(128, 256, 1024)``);
                 a dim maps to the smallest boundary >= itself.  Dims above
                 the largest boundary fall back to power-of-two rounding.
                 ``None`` means pure power-of-two buckets.
    ``min_dim``  dims below this pass through unchanged: small axes (batch,
                 heads) change the problem; sequence-like axes are bucketed.
    """

    buckets: Optional[Tuple[int, ...]] = None
    min_dim: int = 32

    def __post_init__(self):
        if self.buckets is not None:
            bs = tuple(int(b) for b in self.buckets)
            if not bs or any(b < 1 for b in bs) or list(bs) != sorted(set(bs)):
                raise ValueError("buckets must be strictly ascending positive ints,"
                                 f" got {self.buckets!r}")
            object.__setattr__(self, "buckets", bs)
        if self.min_dim < 1:
            raise ValueError(f"min_dim must be >= 1, got {self.min_dim}")

    def bucket_dim(self, size: int) -> int:
        size = int(size)
        if size < self.min_dim:
            return size
        if self.buckets is not None:
            for b in self.buckets:
                if size <= b:
                    return b
        return 1 << (size - 1).bit_length()

    def bucket_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(self.bucket_dim(s) for s in shape)

    # The canonical shape of a bucket is its upper boundary: the one shape a
    # bucket executable is compiled at (``ChunkConfig.canonical_bucket_exec``).

    def canonical_dim(self, size: int) -> int:
        """Bucket upper boundary for one dim (the padded extent)."""
        return self.bucket_dim(size)

    def canonical_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape a bucket executable is compiled at for ``shape``."""
        return self.bucket_shape(shape)
