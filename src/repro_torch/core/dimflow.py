"""Chunk-flow dimension propagation rules (backward, per aten op).

The paper's *chunk flow* (section 3.3) is a path of a chunk dimension
through consecutive graph nodes.  A rule answers, for one node and one
output dim:

    "If I want this output sliced along ``out_dim``, what do I need from the
     inputs?"

The answer, per input node, is either an integer dim (the input must be
sliced along it) or ``FULL`` (the whole input is needed for every chunk);
or the rule returns ``None`` (BREAK): the op cannot produce chunked output
along that dim from slices (a contraction or reduction along the dim, a
reshape that merges it, an op with no inputs such as ``arange``...).  A
broken node may still be hoisted out of the loop by the search pass when
its inputs are chunk-invariant.

These are the rules of the JAX package's ``core/dimflow.py`` re-expressed
over the aten ops that ``make_fx`` records.  Two differ in kind:

* ``x @ w`` on (B, S, d) traces as ``view(B*S, d)`` -> ``mm`` ->
  ``view(B, S, n)``.  The prefix-product reshape rule passes the chunk dim
  through such a merge when the dims merged outside it all have size 1, so a
  batch-1 chunk flow crosses linear layers.
* A split value (``split``/``chunk``, a list) carries one chunk dim shared by
  its parts, reached through ``getitem``: the rule the reference lacks for
  ``split`` (ROADMAP C-ref-1).

For a tuple value (``native_layer_norm``) the dim applies to every part.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

from torch.fx import Node

from .graph import op_name, vshape

FULL = "full"
InDim = Union[int, str]  # int dim or FULL
Req = Dict[Node, InDim]

_RULES: Dict[str, Callable[[Node, int], Optional[Req]]] = {}


def register(*names):
    def deco(fn):
        for n in names:
            _RULES[n] = fn
        return fn

    return deco


class _Conflict(Exception):
    pass


def _put(res: Req, node, req: InDim) -> None:
    """Record a requirement; one input read twice must agree."""
    if not isinstance(node, Node):
        return
    prev = res.get(node)
    if prev is not None and prev != req:
        raise _Conflict
    res[node] = req


def propagate(node, out_dim: int) -> Optional[Req]:
    """Map (output sliced along out_dim) -> {input node: dim | FULL}.

    Covers every tensor input of the node, or returns None (BREAK).  Nodes
    other than aten ops (chunk loops) always break.
    """
    if not isinstance(node, Node):
        return None
    memo = node.meta.setdefault("autochunk_dimflow", {})
    if out_dim not in memo:
        memo[out_dim] = _apply_rule(node, out_dim)
    return memo[out_dim]


def _apply_rule(node: Node, out_dim: int) -> Optional[Req]:
    rule = _RULES.get(op_name(node))
    if rule is None:
        return None
    try:
        return rule(node, out_dim)
    except (_Conflict, IndexError, ValueError, TypeError, KeyError):
        return None


def _norm(dim: int, rank: int) -> int:
    return dim + rank if dim < 0 else dim


# ---------------------------------------------------------------------------
# Pointwise ops: every same-shaped input slices along the same dim;
# broadcast inputs (size 1 or missing there) and scalars ride along whole.
# ---------------------------------------------------------------------------
_POINTWISE = [
    "add", "sub", "mul", "div", "pow", "remainder", "fmod", "maximum", "minimum",
    "atan2", "eq", "ne", "ge", "gt", "le", "lt",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "exp", "exp2", "log", "log1p", "expm1", "tanh", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "sqrt", "rsqrt", "sigmoid", "erf",
    "erfc", "abs", "neg", "sign", "floor", "ceil", "round", "reciprocal",
    "square", "isnan", "isinf", "isfinite", "clamp", "clamp_min", "clamp_max",
    "where", "masked_fill", "gelu", "silu", "relu", "_to_copy", "clone", "alias",
    "detach", "contiguous", "lift_fresh_copy", "copy", "zeros_like", "ones_like",
    "full_like", "empty_like", "expand",
]


def _broadcast_req(res: Req, inp: Node, out_shape, out_dim: int) -> None:
    shp = vshape(inp)
    if len(shp) == 0:
        _put(res, inp, FULL)
        return
    j = out_dim - (len(out_shape) - len(shp))
    if j < 0:
        _put(res, inp, FULL)
    elif shp[j] == out_shape[out_dim]:
        _put(res, inp, j)
    elif shp[j] == 1:
        _put(res, inp, FULL)
    else:
        raise ValueError("incompatible broadcast")


@register(*_POINTWISE)
def _pointwise(node, out_dim):
    out = vshape(node)
    res: Req = {}
    for inp in node.all_input_nodes:
        _broadcast_req(res, inp, out, out_dim)
    return res


@register("permute")
def _permute(node, out_dim):
    x = node.args[0]
    perm = [_norm(int(p), len(vshape(x))) for p in node.args[1]]
    return {x: perm[out_dim]}


@register("transpose", "t")
def _transpose(node, out_dim):
    x = node.args[0]
    rank = len(vshape(x))
    if op_name(node) == "t":
        a, b = 0, rank - 1
    else:
        a, b = _norm(int(node.args[1]), rank), _norm(int(node.args[2]), rank)
    d = b if out_dim == a else a if out_dim == b else out_dim
    return {x: d}


@register("view", "_unsafe_view", "reshape")
def _reshape(node, out_dim):
    # Prefix-product rule: slicing commutes with a row-major reshape iff the
    # element count before the dim and the dim's own extent both match.
    x = node.args[0]
    out, inn = vshape(node), vshape(x)
    pre_out = math.prod(out[:out_dim])
    for d in range(len(inn)):
        if math.prod(inn[:d]) == pre_out and inn[d] == out[out_dim]:
            return {x: d}
    return None


@register("unsqueeze")
def _unsqueeze(node, out_dim):
    x = node.args[0]
    dim = _norm(int(node.args[1]), len(vshape(node)))
    if out_dim == dim:
        return None
    return {x: out_dim - (1 if out_dim > dim else 0)}


@register("squeeze")
def _squeeze(node, out_dim):
    x = node.args[0]
    inn = vshape(x)
    if len(node.args) > 1:
        dims = node.args[1] if isinstance(node.args[1], (list, tuple)) else [node.args[1]]
        removed = {_norm(int(d), len(inn)) for d in dims}
        removed = {d for d in removed if inn[d] == 1}
    else:
        removed = {d for d, n in enumerate(inn) if n == 1}
    kept = [d for d in range(len(inn)) if d not in removed]
    return {x: kept[out_dim]}


@register("select")
def _select(node, out_dim):
    x = node.args[0]
    dim = _norm(int(node.args[1]), len(vshape(x)))
    return {x: out_dim if out_dim < dim else out_dim + 1}


@register("slice")
def _slice(node, out_dim):
    x = node.args[0]
    inn = vshape(x)
    args = list(node.args) + [None] * (5 - len(node.args))
    dim = _norm(int(args[1] if args[1] is not None else 0), len(inn))
    if out_dim != dim:
        return {x: out_dim}
    start = args[2] or 0
    end = inn[dim] if args[3] is None else min(int(args[3]), inn[dim])
    step = args[4] or 1
    if start == 0 and end == inn[dim] and step == 1:
        return {x: out_dim}
    return None


def _matmul_req(res: Req, a, b, out_dim: int) -> Req:
    """``a @ b`` over (M, K) x (K, N): rows slice a, columns slice b."""
    if out_dim == 0:
        _put(res, a, 0)
        _put(res, b, FULL)
    else:
        _put(res, a, FULL)
        _put(res, b, 1)
    return res


@register("mm")
def _mm(node, out_dim):
    return _matmul_req({}, node.args[0], node.args[1], out_dim)


@register("addmm")
def _addmm(node, out_dim):
    bias, a, b = node.args[:3]
    res: Req = {}
    _broadcast_req(res, bias, vshape(node), out_dim)
    return _matmul_req(res, a, b, out_dim)


@register("bmm")
def _bmm(node, out_dim):
    a, b = node.args[:2]
    res: Req = {}
    if out_dim == 0:
        _put(res, a, 0)
        _put(res, b, 0)
    elif out_dim == 1:
        _put(res, a, 1)
        _put(res, b, FULL)
    else:
        _put(res, a, FULL)
        _put(res, b, 2)
    return res


@register("_softmax", "_log_softmax", "softmax", "log_softmax")
def _softmax(node, out_dim):
    x = node.args[0]
    if _norm(int(node.args[1]), len(vshape(x))) == out_dim:
        return None
    return {x: out_dim}


@register("sum", "mean", "amax", "amin", "argmax", "argmin", "prod", "var", "std",
          "logsumexp")
def _reduce(node, out_dim):
    x = node.args[0]
    rank = len(vshape(x))
    dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
    if dims is None:
        return None  # full reduction
    if isinstance(dims, int):
        dims = [dims]
    axes = {_norm(int(d), rank) for d in dims}
    keepdim = node.args[2] if len(node.args) > 2 else node.kwargs.get("keepdim", False)
    if keepdim:
        return None if out_dim in axes else {x: out_dim}
    kept = [d for d in range(rank) if d not in axes]
    return {x: kept[out_dim]}


@register("native_layer_norm")
def _layer_norm(node, out_dim):
    x, normalized, w, b = node.args[:4]
    if out_dim >= len(vshape(x)) - len(normalized):
        return None
    res: Req = {}
    _put(res, x, out_dim)
    _put(res, w, FULL)
    _put(res, b, FULL)
    return res


@register("getitem")
def _getitem(node, out_dim):
    # parts of a split / tuple value share the parent's chunk dim
    return {node.args[0]: out_dim}


@register("split", "split_with_sizes")
def _split(node, out_dim):
    x = node.args[0]
    dim = node.args[2] if len(node.args) > 2 else node.kwargs.get("dim", 0)
    if _norm(int(dim), len(vshape(x))) == out_dim:
        return None
    return {x: out_dim}


@register("cat")
def _cat(node, out_dim):
    tensors = node.args[0]
    rank = len(vshape(node))
    dim = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 0)
    if _norm(int(dim), rank) == out_dim:
        return None
    res: Req = {}
    for t in tensors:
        _put(res, t, out_dim)
    return res


@register("embedding")
def _embedding(node, out_dim):
    weight, indices = node.args[:2]
    if out_dim >= len(vshape(indices)):
        return None
    res: Req = {}
    _put(res, weight, FULL)
    _put(res, indices, out_dim)
    return res


# Ops without tensor inputs (``arange``, ``ones``, ``full``, ``scalar_tensor``,
# ``empty``...) have no rule: chunks would need offset positions.  They BREAK
# and the search hoists them (compute once, slice per chunk), which is
# always legal.


@register("cumsum", "cumprod", "cummax", "cummin", "logcumsumexp")
def _cumulative(node, out_dim):
    x = node.args[0]
    if _norm(int(node.args[1]), len(vshape(x))) == out_dim:
        return None
    return {x: out_dim}
