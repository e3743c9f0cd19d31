"""Kernel dispatch: swap matched chunk-loop bodies for fused CUDA kernels.

After :func:`~repro_torch.core.lowering.apply_chunk` has spliced a region
into a ``ChunkLoopNode``, the node's body is matched against softmax
attention as the port's aten graph spells it:

    bmm(q, k^T) -> [view of the leading dims] -> [* or / scalar]
      -> where(mask, x, -1e30) -> _softmax(-1) -> [expand / view] -> bmm(p, v)

with ``_to_copy`` casts anywhere on the way.  A match whose mask resolves
to a contiguous band (causal or sliding window, built from ``arange``
position algebra) dispatches onto
:func:`repro_torch.kernels.chunked_attention.computed_attention`: the
predicate is recomputed from positions inside the kernel and no mask is
read.  Any other mask, or every mask under ``mask_mode="bool"``, keeps
:func:`~repro_torch.kernels.chunked_attention.masked_attention`.

The kernel reads q, K and V at their sources: the matcher looks through the
``.float()`` casts to the bf16 tensors and through ``expand``/``clone``/
``_unsafe_view`` to the un-repeated K and V, so each kv head is read once
(native GQA) and the repeated copies the plain graph makes are pruned.

A match replaces its interior nodes with one
:class:`~repro_torch.core.lowering.KernelDispatch` record (the chunk loop
stays); non-matching bodies keep the generic loop.  The SwiGLU matcher of
the JAX package waits for the ``chunked_ffn`` slice: such bodies count as
misses.  ``annotate_candidates`` runs the matcher during selection.  Counters
``kernel_dispatch_hits`` / ``kernel_dispatch_misses`` /
``kernel_dispatch_computed_mask`` in ``core.stats``.  A port of
``repro/core/kernel_dispatch.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.fx import Node

from . import stats
from .graph import Graph, op_name, vdtype, vshape
from .lowering import (
    LOOP_INDEX,
    BodyOp,
    ChunkLoopNode,
    KernelDispatch,
    is_chunk_loop,
    refresh_node,
    validate_body,
)
from .search import ChunkCandidate

_PASS = ("_to_copy", "clone", "alias", "detach", "contiguous", "lift_fresh_copy")
_VIEWS = ("view", "_unsafe_view", "reshape")
_CHAIN = _PASS + _VIEWS + ("permute", "transpose", "t", "unsqueeze", "squeeze", "expand")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_SOFTMAX = ("_softmax", "softmax")


@dataclass
class _BodyCtx:
    """A loop body viewed as a mini-graph (candidate or chunk-loop node)."""

    ops: List[BodyOp]
    sliced: Dict[Node, int]
    escapes: Set[Node]
    var_dim: Dict[Node, int]
    # FX nodes outside the body that the graph computes directly (prefix and
    # hoisted nodes): followed read-only through K/V layout chains
    outer: Set[Node] = field(default_factory=set)
    producer: Dict[Node, int] = field(default_factory=dict)
    consumers: Dict[Node, List[int]] = field(default_factory=dict)

    def __post_init__(self):
        for i, op in enumerate(self.ops):
            self.producer[op.node] = i
            for iv in op.node.all_input_nodes:
                self.consumers.setdefault(iv, []).append(i)

    def op_of(self, v) -> Tuple[Optional[int], Optional[BodyOp]]:
        i = self.producer.get(v) if isinstance(v, Node) else None
        return (i, self.ops[i]) if i is not None else (None, None)


def _outer_nodes(g: Optional[Graph]) -> Set[Node]:
    return {n for n in g.nodes if isinstance(n, Node)} if g is not None else set()


def _ctx_from_node(node: ChunkLoopNode, outer: Set[Node]) -> _BodyCtx:
    p = node.params
    return _BodyCtx(ops=list(p["body"]), sliced=dict(p["sliced"]),
                    escapes=set(node.outvars), var_dim=dict(p["var_dim"]), outer=outer)


def _ctx_from_candidate(g: Graph, cand: ChunkCandidate, outer: Set[Node]) -> _BodyCtx:
    region = set(cand.in_loop)
    escapes: Set[Node] = set(cand.loop_out) | g.out_set
    for i in cand.in_loop:
        v = g.nodes[i]
        if any(c not in region for c in g.consumers.get(v, [])):
            escapes.add(v)
    body = {g.nodes[i] for i in cand.in_loop}
    return _BodyCtx(ops=[BodyOp(g.nodes[i]) for i in cand.in_loop],
                    sliced=dict(cand.sliced_in), escapes=escapes,
                    var_dim=dict(cand.var_dim), outer=outer - body)


@dataclass
class Match:
    """One recognized fused-kernel site inside a loop body."""

    kind: str
    interior: Set[int]          # body positions the kernel replaces
    at: int                     # body position of the root node
    root: Node
    reads: Tuple[Node, ...]
    launch: Callable            # fn(env, kw) -> value for root
    tile_bytes: int             # selection-time charge of the dispatched body
    extra_bytes: Callable[[int], int]   # scratch bytes at chunk size c
    mask: str = "bool"                  # "computed" (a band) or "bool"


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _scalar(a) -> Optional[float]:
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return float(a)
    return None


def _args_of(ctx: _BodyCtx, v) -> Optional[Tuple[str, Sequence[Any]]]:
    """(op name, args) of the node defining ``v``, in the body or outside."""
    _, op = ctx.op_of(v)
    if op is not None:
        return op_name(op.node), op.args
    if isinstance(v, Node) and v in ctx.outer:
        return op_name(v), v.args
    return None


def _is_neg_const(ctx: _BodyCtx, a) -> bool:
    """True when ``a`` is (a cast or broadcast of) a scalar <= -1e15."""
    for _ in range(6):
        s = _scalar(a)
        if s is not None:
            return s <= -1e15
        got = _args_of(ctx, a)
        if got is None:
            return False
        nm, args = got
        if nm in _PASS or nm == "expand":
            a = args[0]
        elif nm == "scalar_tensor":
            a = args[0]
        elif nm == "full":
            a = args[1]
        else:
            return False
    return False


def _prod(xs) -> int:
    return int(math.prod(xs)) if xs else 1


def _leading_reshape(op: BodyOp) -> bool:
    """A reshape of the leading dims only: the last two dims unchanged."""
    src = op.args[0]
    return isinstance(src, Node) and vshape(src)[-2:] == vshape(op.node)[-2:]


def _same_shape_expand(op: BodyOp) -> bool:
    return isinstance(op.args[0], Node) and vshape(op.args[0]) == vshape(op.node)


def _interior_is_private(ctx: _BodyCtx, interior: Set[int], at: int) -> bool:
    """No interior value may be read outside the match."""
    for i in interior:
        if i == at:
            continue
        v = ctx.ops[i].node
        if v in ctx.escapes:
            return False
        if any(c not in interior for c in ctx.consumers.get(v, [])):
            return False
    return True


# ---------------------------------------------------------------------------
# Operand chains: from a bmm operand back to the tensor the kernel reads
# ---------------------------------------------------------------------------

@dataclass
class _Chain:
    source: Node
    steps: List[Tuple[str, Sequence[Any], Node]]   # source -> operand order
    group: int = 1
    repeat_at: int = -1                            # step index of the GQA expand


def _walk_chain(ctx: _BodyCtx, v: Node, outward: bool) -> _Chain:
    """Walk back through layout ops and casts.  Stops at a sliced input, at
    a non-layout op, or (unless ``outward``) at the body's edge."""
    steps = []
    cur = v
    while cur not in ctx.sliced:
        _, op = ctx.op_of(cur)
        if op is not None:
            nm, args = op_name(op.node), op.args
        elif outward and cur in ctx.outer:
            nm, args = op_name(cur), cur.args
        else:
            break
        if nm not in _CHAIN or not isinstance(args[0], Node):
            break
        steps.append((nm, args, cur))
        cur = args[0]
    return _Chain(source=cur, steps=list(reversed(steps)))


def _find_gqa_repeat(chain: _Chain, nb: int) -> None:
    """Mark the expand that repeats one batch dim G times (GQA), if the rest
    of the chain only flattens the batch with it as the innermost factor."""
    for idx, (nm, args, out) in enumerate(chain.steps):
        if nm != "expand":
            continue
        inn, outs = vshape(args[0]), vshape(out)
        if inn == outs:
            continue
        if len(inn) != len(outs):
            return
        rep = [d for d in range(len(outs)) if inn[d] != outs[d]]
        if len(rep) != 1 or inn[rep[0]] != 1:
            return
        r = rep[0]
        rest = chain.steps[idx + 1:]
        if not rest or any(s[0] not in _PASS for s in rest[:-1]) or rest[-1][0] not in _VIEWS:
            return
        final = vshape(rest[-1][2])
        if len(final) != 3 or _prod(outs[:r + 1]) != nb or final[0] != nb:
            return
        chain.group, chain.repeat_at = outs[r], idx
        return


def _replay(t: torch.Tensor, chain: _Chain) -> torch.Tensor:
    """Apply the chain's layout ops to the source value.  Casts are dropped
    (the kernel reads the source dtype and computes in f32); the GQA repeat
    is dropped, and the flattening after it keeps the batch as -1."""
    for idx, (nm, args, _) in enumerate(chain.steps):
        if nm in _PASS or idx == chain.repeat_at:
            continue
        if nm in _VIEWS:
            sizes = list(args[1])
            if chain.repeat_at >= 0 and idx > chain.repeat_at:
                sizes[0] = -1
            t = t.reshape(sizes)
        elif nm == "expand":
            t = t.expand(list(args[1]))
        elif nm == "permute":
            t = t.permute(list(args[1]))
        elif nm == "transpose":
            t = t.transpose(args[1], args[2])
        elif nm == "t":
            t = t.t()
        elif nm == "unsqueeze":
            t = t.unsqueeze(args[1])
        elif nm == "squeeze":
            t = t.squeeze(args[1]) if len(args) > 1 else t.squeeze()
    return t


# ---------------------------------------------------------------------------
# Concrete masks
# ---------------------------------------------------------------------------

_MASK_EVAL_OPS = frozenset({
    "arange", "ones", "zeros", "full", "scalar_tensor", "unsqueeze", "squeeze", "view",
    "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "slice", "select",
    "clone", "alias", "_to_copy", "lift_fresh_copy", "le", "lt", "ge", "gt", "eq", "ne",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_xor", "logical_not", "add", "sub", "mul", "neg", "abs",
    "minimum", "maximum", "where", "remainder", "floor_divide",
})
_MASK_EVAL_LIMIT = 1 << 26  # elements per intermediate (8192^2)


def _concrete_mask_value(v: Node) -> Optional[torch.Tensor]:
    """The full-shape value behind a mask node, evaluated on the CPU, or None.

    Position masks are built from ``arange`` comparisons that read no graph
    input.  This evaluates the node's chain of the original trace with real
    CPU tensors: the FX arguments are never chunk-adjusted, so the result is
    the full (Sq, Skv) mask even when the body runs at chunk size.  Anything
    outside the position algebra (a placeholder, a gather...) returns None
    and keeps the bool-mask kernel.
    """
    memo: Dict[Node, torch.Tensor] = {}
    cpu = torch.device("cpu")

    def ev(n: Node, depth: int) -> torch.Tensor:
        if n in memo:
            return memo[n]
        if depth > 32 or n.op != "call_function" or op_name(n) not in _MASK_EVAL_OPS:
            raise LookupError(n)
        if _prod(vshape(n)) > _MASK_EVAL_LIMIT:
            raise LookupError(n)
        from .lowering import call_op

        env = {a: ev(a, depth + 1) for a in n.all_input_nodes}
        memo[n] = call_op(n.target, n.args, n.kwargs, env, cpu)
        return memo[n]

    try:
        return ev(v, 0)
    except LookupError:
        return None


def _band_params(mask: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(U, L) such that mask[a, j] == (j - a <= U) and (a - j <= L).

    Anything that is not a contiguous causal / sliding-window band (padding
    masks, block-sparse patterns, a row with no live key) returns None.
    """
    sq, skv = mask.shape
    counts = mask.sum(dim=1)
    if bool((counts == 0).any()):
        return None
    m8 = mask.to(torch.uint8)
    idx = torch.arange(sq)
    first = m8.argmax(dim=1)
    last = skv - 1 - m8.flip(1).argmax(dim=1)
    if not bool((counts == last - first + 1).all()):
        return None  # a row with holes is not a band
    u = int((last - idx).max())
    low = int((idx - first).max())
    if not (bool((first == (idx - low).clamp_min(0)).all())
            and bool((last == (idx + u).clamp_max(skv - 1)).all())):
        return None
    return u, low


def _mask_band(mask_node: Node, invert: bool) -> Optional[Tuple[int, int]]:
    """Band of a mask node, cached in its ``meta`` (the evaluation of an
    (8192, 8192) mask takes a moment and every stage re-runs the matcher)."""
    key = "autochunk_band_inverted" if invert else "autochunk_band"
    if key not in mask_node.meta:
        band = None
        m = _concrete_mask_value(mask_node)
        if m is not None and m.dtype == torch.bool and m.dim() >= 2 \
                and all(s == 1 for s in m.shape[:-2]):
            m2 = m.reshape(m.shape[-2:])
            band = _band_params(~m2 if invert else m2)
        mask_node.meta[key] = band
    return mask_node.meta[key]


# ---------------------------------------------------------------------------
# Attention matcher
# ---------------------------------------------------------------------------

def _call_kernel(kernel, q, *args, **kwargs):
    """Launch through the wrapper; on ``meta`` tensors (body validation)
    only the output shape is produced."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    return kernel(q, *args, **kwargs)


def _try_attention(ctx: _BodyCtx, i_sm: int, mask_mode: str = "auto") -> Optional[Match]:
    ops = ctx.ops
    sm = ops[i_sm]
    x = sm.args[0]
    if not isinstance(x, Node) or len(vshape(x)) < 2:
        return None
    rank = len(vshape(x))
    if int(sm.args[1]) % rank != rank - 1:
        return None
    interior: Set[int] = {i_sm}

    # backward from the softmax input to the scores bmm: casts, leading
    # reshapes, scalar scale factors and the mask select
    scale = 1.0
    mask_var = None
    invert = False
    where_node = None
    cur = x
    dg1 = None
    for _ in range(12):
        i_c, op = ctx.op_of(cur)
        if op is None:
            return None
        nm = op_name(op.node)
        if nm == "bmm":
            dg1 = (i_c, op)
            break
        interior.add(i_c)
        if nm in _PASS or (nm == "expand" and _same_shape_expand(op)):
            cur = op.args[0]
        elif nm in _VIEWS and _leading_reshape(op):
            cur = op.args[0]
        elif nm in ("mul", "div"):
            a, b = op.args[:2]
            s, nxt = _scalar(b), a
            if s is None and nm == "mul":
                s, nxt = _scalar(a), b
            if s is None or s <= 0 or not isinstance(nxt, Node):
                return None
            scale = scale * s if nm == "mul" else scale / s
            cur = nxt
        elif nm == "where":
            if mask_var is not None:
                return None
            cond, a, b = op.args[:3]
            if not isinstance(cond, Node):
                return None
            # where(m, x, -1e30): True means attend; where(m, -1e30, x) is the
            # True-means-masked convention and the kernel mask is negated
            if isinstance(a, Node) and _is_neg_const(ctx, b):
                cur, invert = a, False
            elif isinstance(b, Node) and _is_neg_const(ctx, a):
                cur, invert = b, True
            else:
                return None
            mask_var, where_node = cond, op.node
        else:
            return None
    if dg1 is None or mask_var is None:
        return None
    i_dg1, dg1_op = dg1
    interior.add(i_dg1)
    a_var, bt_var = dg1_op.args[:2]
    if not (isinstance(a_var, Node) and isinstance(bt_var, Node)) or a_var is bt_var:
        return None
    nb, sq, hd = vshape(a_var)
    nb2, hd2, skv = vshape(bt_var)
    if nb2 != nb or hd2 != hd or vshape(x)[-2:] != (sq, skv) or _prod(vshape(x)[:-2]) != nb:
        return None

    # forward from p to the output bmm
    cur = sm.node
    dg2 = None
    for _ in range(6):
        if cur in ctx.escapes:
            return None
        cons = ctx.consumers.get(cur, [])
        if len(cons) != 1:
            return None
        j = cons[0]
        op = ops[j]
        nm = op_name(op.node)
        if nm in _PASS or (nm == "expand" and _same_shape_expand(op)) \
                or (nm in _VIEWS and _leading_reshape(op)):
            interior.add(j)
            cur = op.node
            continue
        if nm == "bmm" and op.args[0] is cur and op.args[1] is not cur:
            dg2 = (j, op)
        break
    if dg2 is None:
        return None
    i_dg2, dg2_op = dg2
    interior.add(i_dg2)
    v_var = dg2_op.args[1]
    if not isinstance(v_var, Node) or vshape(cur) != (nb, sq, skv):
        return None
    nbv, skv2, hdv = vshape(v_var)
    if nbv != nb or skv2 != skv or hdv != hd:
        return None
    root = dg2_op.node
    if not _interior_is_private(ctx, interior, i_dg2):
        return None

    # --- the tensors the kernel reads -----------------------------------------
    q_chain = _walk_chain(ctx, a_var, outward=False)
    k_chain = _walk_chain(ctx, bt_var, outward=True)
    v_chain = _walk_chain(ctx, v_var, outward=True)
    _find_gqa_repeat(k_chain, nb)
    _find_gqa_repeat(v_chain, nb)
    if k_chain.group != v_chain.group:
        k_chain.group = v_chain.group = 1
        k_chain.repeat_at = v_chain.repeat_at = -1
    group = k_chain.group
    dtypes = {vdtype(c.source) for c in (q_chain, k_chain, v_chain)}
    kdtype = dtypes.pop() if len(dtypes) == 1 else None
    if kdtype not in _KERNEL_DTYPES:
        kdtype = torch.float32
    itemsize = torch.empty((), dtype=kdtype).element_size()
    root_dtype = vdtype(root)
    scale_f = float(scale)

    def operands(env):
        q = _replay(env[q_chain.source], q_chain)
        k = _replay(env[k_chain.source], k_chain).transpose(1, 2)
        v = _replay(env[v_chain.source], v_chain)
        return [t.to(kdtype).contiguous() for t in (q, k, v)]

    # --- mask: computed band or streamed bool -----------------------------------
    band = None
    m_rank = len(vshape(mask_var))
    if mask_mode != "bool" and m_rank >= 2 and ctx.var_dim.get(mask_var) == m_rank - 2 \
            and ctx.var_dim.get(bt_var) != 2 and ctx.var_dim.get(a_var) == 1:
        band = _mask_band(mask_var, invert)

    from ..kernels import chunked_attention as CA

    kv_bytes = 2 * (nb // group) * skv * hd * itemsize
    if band is not None:
        band_u, band_l = band
        causal = band_u < skv - 1
        window = (band_u + band_l + 1) if band_l < sq - 1 else None

        def launch(env, kw):
            q, k, v = operands(env)
            # kv position of this chunk's query row 0: the chunk start
            # (clamped like the loop clamps its slices) plus the band's
            # upper diagonal
            c, ext = kw["c"], kw["ext"]
            start = min(env[LOOP_INDEX] * c, ext - c)
            out = _call_kernel(CA.computed_attention, q, k, v, start + band_u,
                               scale=scale_f, causal=causal, window=window, group=group)
            return out.to(root_dtype)

        reads = (q_chain.source, k_chain.source, v_chain.source)
        mask_bytes = 0
        variant = "computed"
    else:
        where_shape = vshape(where_node)
        where_dim = ctx.var_dim.get(where_node)

        def launch(env, kw):
            q, k, v = operands(env)
            cq, skv_ = q.shape[1], k.shape[1]
            m = env[mask_var]
            if invert:
                m = m.logical_not()
            if m.dim() > 2 and all(s == 1 for s in m.shape[:-2]):
                m = m.reshape(m.shape[-2:])
            if m.dim() <= 2:                     # one mask for every head
                m = m.expand(cq, skv_)[None]
            else:
                lead = list(where_shape[:-2])
                if where_dim is not None and where_dim < len(lead):
                    lead[where_dim] = kw["c"]
                m = m.expand(*lead, cq, skv_).reshape(-1, cq, skv_)
            m = m.to(torch.bool).contiguous()
            out = _call_kernel(CA.masked_attention, q, k, v, m, scale=scale_f, group=group)
            return out.to(root_dtype)

        reads = (q_chain.source, k_chain.source, v_chain.source, mask_var)
        m_lead = vshape(mask_var)[:-2]
        mask_heads = 1 if all(s == 1 for s in m_lead) else nb
        mask_bytes = mask_heads * skv
        variant = "bool"

    def extra_bytes(c: int) -> int:
        # contiguous q, K, V (and mask) operands and the kernel output
        return kv_bytes + 2 * nb * c * hd * itemsize + mask_bytes * c

    from ..kernels.chunked_attention import BLOCK_Q

    return Match(kind="attention", interior=interior, at=i_dg2, root=root, reads=reads,
                 launch=launch, tile_bytes=extra_bytes(BLOCK_Q), extra_bytes=extra_bytes,
                 mask=variant)


# ---------------------------------------------------------------------------
# Body matching + the pass entry points
# ---------------------------------------------------------------------------

def match_body(ctx: _BodyCtx, mask_mode: str = "auto") -> List[Match]:
    """All non-overlapping fused-kernel matches in one loop body."""
    found: List[Match] = []
    used: Set[int] = set()
    for i, op in enumerate(ctx.ops):
        if op_name(op.node) not in _SOFTMAX:
            continue
        m = _try_attention(ctx, i, mask_mode)
        if m is None or m.interior & used:
            continue
        used |= m.interior
        found.append(m)
    return found


def _dead_after(ctx: _BodyCtx, skip: Set[int], protected: Set[Node]) -> Set[int]:
    """Body positions whose outputs become unread once ``skip`` is removed."""
    dead = set(skip)
    changed = True
    while changed:
        changed = False
        for i in range(len(ctx.ops) - 1, -1, -1):
            if i in dead:
                continue
            v = ctx.ops[i].node
            if v in ctx.escapes or v in protected:
                continue
            if all(c in dead for c in ctx.consumers.get(v, [])):
                dead.add(i)
                changed = True
    return dead


def _sync_node_inputs(node: ChunkLoopNode) -> None:
    """Make the node's inputs exactly what the dispatched body reads.

    A kernel may read a value from outside the body that the loop did not
    take before (the un-repeated K behind a captured repeated copy): it is
    captured.  Inputs nothing reads any more (a mask a computed-mask
    dispatch no longer needs, the repeated K/V) are dropped, so the graph
    pass can delete the nodes that built them.
    """
    p = node.params
    skip = set().union(*(d.skip for d in p["dispatches"]))
    fire = {d.at for d in p["dispatches"]}
    body_defined = {op.node for op in p["body"]}
    needed: Dict[Node, None] = {}
    for i, op in enumerate(p["body"]):
        if i in skip or i in fire:
            continue
        needed.update(dict.fromkeys(op.node.all_input_nodes))
    for d in p["dispatches"]:
        needed.update(dict.fromkeys(d.reads))
    sliced = [sv for sv in p["sliced"] if sv[0] in needed]
    have = {v for v, _ in sliced}
    captured = [v for v in p["captured"] if v in needed]
    have |= set(captured)
    captured += [v for v in needed if v not in have and v not in body_defined]
    if not sliced:
        raise ValueError("a dispatched loop keeps no sliced input")
    p["sliced"] = sliced
    p["captured"] = captured
    node.invars = [v for v, _ in sliced] + captured


def dispatch_node(node: ChunkLoopNode, g: Optional[Graph] = None, outer=None, *,
                  mask_mode: str = "auto") -> int:
    """Try to dispatch one chunk-loop node; returns the number of matches."""
    outer = _outer_nodes(g) if outer is None else outer
    try:
        ctx = _ctx_from_node(node, outer)
        matches = match_body(ctx, mask_mode)
    except (LookupError, ValueError, TypeError, IndexError, RuntimeError):
        # an exotic body that trips the matcher keeps the generic loop
        matches = []
    if not matches:
        refresh_node(node)  # drop any dispatch-aware body_peak cap
        stats.bump("kernel_dispatch_misses")
        return 0
    protected = {v for m in matches for v in m.reads} | {m.root for m in matches}
    at_set = {m.at for m in matches}
    skip0 = {i for m in matches for i in m.interior if i != m.at}
    skip_all = _dead_after(ctx, skip0 | at_set, protected) - at_set
    c, ext = int(node.params["c"]), int(node.params["chunk_extent"])
    kw = {"c": c, "ext": ext}
    records = []
    for j, m in enumerate(matches):
        own = set(m.interior) - {m.at}
        if j == 0:  # fold the nodes that died with the matches into the first record
            own |= skip_all - {i for mm in matches for i in mm.interior} - at_set
        records.append(KernelDispatch(
            skip=frozenset(own), at=m.at, root=m.root, reads=tuple(m.reads),
            fn=(lambda env, _b=m.launch: _b(env, kw)), kind=m.kind,
            extra_bytes=m.extra_bytes(c)))
    p = node.params
    saved = (p["dispatches"], list(p["sliced"]), list(p["captured"]), list(node.invars))
    p["dispatches"] = tuple(records)
    try:
        _sync_node_inputs(node)
        validate_body(node)
    except (ValueError, RuntimeError):
        # dispatch must never break a compilable plan: revert to the loop
        p["dispatches"], p["sliced"], p["captured"], node.invars = saved
        refresh_node(node)
        stats.bump("kernel_dispatch_misses")
        return 0
    refresh_node(node)
    stats.bump("kernel_dispatch_hits", len(records))
    n_computed = sum(1 for m in matches if m.mask == "computed")
    if n_computed:
        stats.bump("kernel_dispatch_computed_mask", n_computed)
    return len(records)


def _prune_graph(g: Graph) -> Graph:
    """Fixpoint dead-node elimination after dispatch: node-input pruning can
    orphan whole prefix chains (a mask's, a repeated K's)."""
    from .graph import node_ins

    nodes = list(g.nodes)
    while True:
        consumed: Set[Node] = set(g.outvars)
        for n in nodes:
            consumed.update(node_ins(n))
        keep = [n for n in nodes if is_chunk_loop(n) or n in consumed]
        if len(keep) == len(nodes):
            break
        nodes = keep
    return Graph(invars=list(g.invars), outvars=list(g.outvars), nodes=nodes,
                 weight_invars=set(g.weight_invars), consts=dict(g.consts), gm=g.gm)


def dispatch_graph(g: Graph, *, mask_mode: str = "auto") -> Graph:
    """Run kernel dispatch over every chunk loop of a rewritten graph and
    return the graph with the nodes the kernels made dead removed."""
    outer = _outer_nodes(g)
    dispatched = 0
    for node in [n for n in g.nodes if is_chunk_loop(n)]:
        dispatched += dispatch_node(node, g, outer, mask_mode=mask_mode)
    return _prune_graph(g) if dispatched else g


def annotate_candidates(g: Graph, cands: Sequence[ChunkCandidate],
                        mask_mode: str = "auto") -> None:
    """Dispatch-aware selection: set ``kernel_tile_bytes`` on every candidate
    whose body matches a fused kernel."""
    outer = _outer_nodes(g)
    for cand in cands:
        if not any(op_name(g.nodes[i]) in _SOFTMAX for i in cand.in_loop):
            continue  # nothing the matchers could take
        try:
            matches = match_body(_ctx_from_candidate(g, cand, outer), mask_mode)
        except (LookupError, ValueError, TypeError, IndexError, RuntimeError):
            continue
        if matches:
            cand.kernel_tile_bytes = sum(m.tile_bytes for m in matches)
