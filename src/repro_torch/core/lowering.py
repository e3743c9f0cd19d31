"""Lowering backend: chunk stages as graph rewrites, one emit.

* :func:`apply_chunk` rewrites a :class:`~repro_torch.core.graph.Graph`
  structurally: the chunked region ``[s, e]`` is spliced into
  ``prefix -> hoisted -> ChunkLoopNode -> suffix``, where
  :class:`ChunkLoopNode` is a plain object in the node list carrying the
  region's nodes with their shape arguments shrunk to the chunk size.
  Applying a multi-stage plan is K successive rewrites on one graph; nothing
  is traced.
* :func:`emit` turns the final graph into one Python callable that
  evaluates the node list on real tensors.  Each chunk loop is a Python
  ``for`` loop that slices its inputs (``narrow`` views), runs the body and
  writes each chunk into an output buffer allocated with ``torch.empty`` and
  filled in place.  Every value is freed after its last use, in loop bodies
  too, so the activation peak on the card is the one the estimator models.

``ChunkLoopNode`` reads ``invars`` and defines ``outvars`` (FX nodes of the
original trace), so estimation, search, selection and plan serialization
run on rewritten graphs unchanged; dimflow has no rule for it, which makes
applied loops opaque to later stages.  The ``kernel_dispatch`` pass may
attach :class:`KernelDispatch` records to a loop node, swapping part of the
body for a fused CUDA kernel.  A port of ``repro/core/lowering.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Sequence, Set, Tuple

import torch
from torch.fx import Node

from . import stats
from .graph import Graph, alias_source, atom_bytes, node_outs, op_name, vshape
from .search import ChunkCandidate

aten = torch.ops.aten


class LoweringError(RuntimeError):
    """A candidate's loop body does not evaluate at chunk shapes."""


class _LoopIndexSentinel:
    """Body-environment key under which a chunk loop binds its iteration
    index (a Python int); dispatched kernels derive the chunk start from it."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<loop_index>"


LOOP_INDEX = _LoopIndexSentinel()


@dataclass(frozen=True)
class KernelDispatch:
    """One fused-kernel substitution inside a chunk-loop body.

    ``skip``  body positions replaced by the kernel (never evaluated)
    ``at``    body position of the match root: the kernel fires here
    ``root``  the value the kernel's result is bound to
    ``reads`` values the kernel closure reads (kept alive until ``at``)
    ``fn``    ``fn(env) -> value``: computes ``root`` from the environment
    ``kind``  ``'attention'`` or ``'swiglu'``
    ``extra_bytes`` device bytes the call allocates besides ``root``
    """

    skip: FrozenSet[int]
    at: int
    root: Node
    reads: Tuple[Node, ...]
    fn: Callable[[Dict[Any, Any]], Any]
    kind: str = "?"
    extra_bytes: int = 0


class BodyOp:
    """One node of a loop body: the FX node (the value it defines) and its
    arguments with shape arguments shrunk to the chunk size."""

    __slots__ = ("node", "args", "kwargs")

    def __init__(self, node: Node, args=None):
        self.node = node
        self.args = node.args if args is None else args
        self.kwargs = node.kwargs

    def __repr__(self) -> str:
        return f"BodyOp({self.node.name})"


class ChunkLoopNode:
    """A chunked region lowered to a structured loop node.

    params:
      ``body``         list of :class:`BodyOp` (chunk-sized semantics)
      ``sliced``       [(value, dim)] inputs sliced per chunk
      ``captured``     values the body reads whole
      ``out_dims``     chunk dim per outvar (reassembly axis)
      ``var_dim``      value -> chunk dim over the body flow
      ``n_chunks``     requested chunk count
      ``c``            per-chunk slice extent (ceil)
      ``n_iters``      actual loop trips
      ``chunk_extent`` full extent of the chunked dim
      ``body_peak``    modeled per-iteration live bytes (estimation pass)
      ``dispatches``   KernelDispatch records (kernel_dispatch pass)
    """

    def __init__(self, invars: List[Node], outvars: List[Node], params: Dict[str, Any]):
        self.invars = invars
        self.outvars = outvars
        self.params = params

    def __repr__(self) -> str:
        p = self.params
        return (f"chunk_loop[n={p['n_chunks']} c={p['c']} ext={p['chunk_extent']}"
                f" body={len(p['body'])} dispatch={len(p['dispatches'])}]")


def is_chunk_loop(node) -> bool:
    return isinstance(node, ChunkLoopNode)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

# a view of a chunk slice may not be expressible as a view (a narrowed
# inner dim); reshape copies where it must and is a view elsewhere
_AS_RESHAPE = {aten.view.default: aten.reshape.default,
               aten._unsafe_view.default: aten.reshape.default}


def _materialize(a, env):
    if isinstance(a, Node):
        return env[a]
    if isinstance(a, (list, tuple)):
        return type(a)(_materialize(x, env) for x in a)
    return a


def call_op(target, args, kwargs, env, device):
    """Evaluate one aten op; ``device=`` arguments recorded at trace time
    (``meta``) become the device of the runtime inputs."""
    args = _materialize(args, env)
    if kwargs:
        kwargs = {k: (device if k == "device" else _materialize(v, env))
                  for k, v in kwargs.items()}
    return _AS_RESHAPE.get(target, target)(*args, **kwargs)


def _free_after(n_steps: int, reads: Sequence[Sequence[Node]], keep: Set[Node],
                defined: Sequence[Sequence[Node]]) -> List[List[Node]]:
    """For each step, the values whose last read (or definition, if never
    read) is that step, except ``keep``."""
    last: Dict[Node, int] = {}
    for i, vs in enumerate(defined):
        for v in vs:
            last.setdefault(v, i)
    for i, vs in enumerate(reads):
        for v in vs:
            last[v] = i
    free: List[List[Node]] = [[] for _ in range(n_steps)]
    for v, i in last.items():
        if v not in keep and 0 <= i < n_steps:
            free[i].append(v)
    return free


def _narrow(val, d: int, start: int, c: int):
    """Chunk ``[start, start + c)`` of a value along ``d`` (each part of a
    split value)."""
    if isinstance(val, (list, tuple)):
        return type(val)(t.narrow(d, start, c) for t in val)
    return val.narrow(d, start, c)


class _LoopProgram:
    """The per-call plan of one chunk loop: which body steps run, what each
    frees, and which dispatch fires where."""

    def __init__(self, node: ChunkLoopNode):
        p = node.params
        self.node = node
        dispatches = p["dispatches"]
        skip = set().union(*(d.skip for d in dispatches)) if dispatches else set()
        fire = {d.at: d for d in dispatches}
        self.steps = []
        reads, defined = [], []
        for i, op in enumerate(p["body"]):
            if i in fire:
                self.steps.append((fire[i], None))
                reads.append(fire[i].reads)
            elif i in skip:
                continue
            else:
                self.steps.append((None, op))
                reads.append(op.node.all_input_nodes)
            defined.append([op.node])
        self.free = _free_after(len(self.steps), reads, set(node.outvars), defined)

    def run(self, env: Dict[Any, Any], device) -> None:
        node = self.node
        p = node.params
        c, n_iters, ext = p["c"], p["n_iters"], p["chunk_extent"]
        # output buffers, written chunk by chunk in place
        bufs = [torch.empty(vshape(v), dtype=v.meta["val"].dtype, device=device)
                for v in node.outvars]
        for i in range(n_iters):
            # the last chunk is clamped to end at the extent: it overlaps the
            # previous chunk and rewrites it with the same values
            start = min(i * c, ext - c)
            benv: Dict[Any, Any] = {v: env[v] for v in p["captured"]}
            benv[LOOP_INDEX] = i
            for v, d in p["sliced"]:
                benv[v] = _narrow(env[v], d, start, c)
            for (disp, op), free in zip(self.steps, self.free):
                if disp is not None:
                    benv[disp.root] = disp.fn(benv)
                else:
                    benv[op.node] = call_op(op.node.target, op.args, op.kwargs, benv, device)
                for v in free:
                    benv.pop(v, None)
            for buf, v, d in zip(bufs, node.outvars, p["out_dims"]):
                buf.narrow(d, start, c).copy_(benv.pop(v))
            del benv
        for v, b in zip(node.outvars, bufs):
            env[v] = b


# ---------------------------------------------------------------------------
# The rewrite
# ---------------------------------------------------------------------------

_SIZE_ARG_OPS = ("view", "_unsafe_view", "reshape", "expand", "new_zeros", "new_ones",
                 "new_empty", "new_full")


def _adjust_op(node: Node, var_dim: Dict[Node, int], ext: int, c: int) -> BodyOp:
    """Shrink the shape arguments of an in-loop node to chunk size ``c``.

    Ops such as ``view``/``expand`` bake their output shape into their
    arguments at trace time; inside the loop the chunked dim has extent
    ``c``.  Ops without shape arguments re-derive their output shapes from
    their (sliced) inputs and keep their arguments.
    """
    d = var_dim.get(node)
    name = op_name(node)
    if d is None:
        return BodyOp(node)
    args = list(node.args)
    if name in _SIZE_ARG_OPS:
        sizes = list(args[1])
        if d < len(sizes) and sizes[d] == ext:
            sizes[d] = c
        args[1] = sizes
        return BodyOp(node, tuple(args))
    if name == "slice" and len(args) > 3:
        dim = args[1] if args[1] >= 0 else args[1] + len(vshape(node))
        if dim == d and args[3] is not None and args[3] >= ext:
            args[3] = c
            return BodyOp(node, tuple(args))
    return BodyOp(node)


def _body_peak_bytes(node: ChunkLoopNode) -> int:
    """Modeled device bytes live while one loop iteration runs.

    Slices are views and loop inputs live outside, so they cost nothing
    here; body values count at chunk size, views of them count nothing and
    keep their root alive; a dispatched kernel counts its root and the
    scratch it allocates.  The full output buffers are the loop node's own
    outputs, which the estimation pass adds.
    """
    p = node.params
    c, var_dim = p["c"], p["var_dim"]
    dispatches = p["dispatches"]
    skip = set().union(*(d.skip for d in dispatches)) if dispatches else set()
    fire = {d.at: d for d in dispatches}
    inputs = {v for v, _ in p["sliced"]} | set(p["captured"])
    root: Dict[Node, Node] = {}
    for op in p["body"]:
        src = alias_source(op.node)
        root[op.node] = root.get(src, src) if src is not None else op.node

    def rt(v):
        return root.get(v, v)

    def nbytes(v) -> int:
        if v in inputs or rt(v) is not v:
            return 0
        b = atom_bytes(v)
        d = var_dim.get(v)
        shape = vshape(v)
        if d is not None and d < len(shape):
            b = int(b * c / max(shape[d], 1))
        return b

    n = len(p["body"])
    last: Dict[Node, int] = {}
    for i, op in enumerate(p["body"]):
        if i in skip and i not in fire:
            continue
        reads = fire[i].reads if i in fire else op.node.all_input_nodes
        for v in reads:
            last[rt(v)] = i
    for v in node.outvars:
        last[rt(v)] = n
    live: Set[Node] = set()
    cur = peak = 0
    for i, op in enumerate(p["body"]):
        if i in skip and i not in fire:
            continue
        v = op.node
        b = nbytes(v)
        extra = fire[i].extra_bytes if i in fire else 0
        peak = max(peak, cur + b + extra)
        if b and last.get(v, -1) > i and v not in live:
            live.add(v)
            cur += b
        for r in [r for r in live if last.get(r, -1) <= i]:
            live.remove(r)
            cur -= nbytes(r)
    return peak


def _meta_value(v: Node, d, c):
    """A ``meta`` tensor (or list of them) shaped like ``v``, dim ``d`` at ``c``."""
    val = v.meta["val"]

    def one(t):
        shape = list(t.shape)
        if d is not None:
            shape[d] = c
        return torch.empty(shape, dtype=t.dtype, device="meta")

    if isinstance(val, (list, tuple)):
        return type(val)(one(t) for t in val)
    return one(val)


def validate_body(node: ChunkLoopNode) -> None:
    """Evaluate the loop body on ``meta`` tensors at chunk shapes; raise
    LoweringError if it does not give chunk-shaped outputs."""
    p = node.params
    env: Dict[Any, Any] = {}
    for v, d in p["sliced"]:
        env[v] = _meta_value(v, d, p["c"])
    for v in p["captured"]:
        env[v] = _meta_value(v, None, None)
    meta = torch.device("meta")
    try:
        prog = _LoopProgram(node)
        env[LOOP_INDEX] = 0
        for disp, op in prog.steps:
            if disp is not None:
                env[disp.root] = disp.fn(env)
            else:
                env[op.node] = call_op(op.node.target, op.args, op.kwargs, env, meta)
        outs = [env[v] for v in node.outvars]
    except Exception as e:  # any op refusing the chunk shapes rejects the loop
        raise LoweringError(f"loop body failed at chunk shapes: {e!r}") from e
    for v, d, o in zip(node.outvars, p["out_dims"], outs):
        want = list(vshape(v))
        want[d] = p["c"]
        if tuple(o.shape) != tuple(want) or o.dtype != v.meta["val"].dtype:
            raise LoweringError(f"loop body output mismatch: got {tuple(o.shape)}/{o.dtype},"
                                f" want {tuple(want)}/{v.meta['val'].dtype}")
    p["validated"] = True


def validate_pending(g: Graph) -> None:
    """Validate every not-yet-validated chunk loop of ``g`` (the search
    scores beam candidates unvalidated and validates only the winner)."""
    for node in g.nodes:
        if is_chunk_loop(node) and not node.params.get("validated"):
            validate_body(node)


def make_chunk_loop(g: Graph, cand: ChunkCandidate, n_chunks: int) -> ChunkLoopNode:
    """Build the structured loop node for one candidate (no validation)."""
    ext = cand.chunk_extent
    n = int(n_chunks)
    c = -(-ext // n)             # ceil: per-chunk slice extent
    n_iters = -(-ext // c)       # actual loop trips (== n when divisible)
    body = [_adjust_op(g.nodes[i], cand.var_dim, ext, c) for i in cand.in_loop]
    captured = list(cand.full_in)
    node = ChunkLoopNode(
        invars=[v for v, _ in cand.sliced_in] + captured,
        outvars=list(cand.loop_out),
        params={
            "body": body,
            "sliced": list(cand.sliced_in),
            "captured": captured,
            "out_dims": [cand.var_dim[v] for v in cand.loop_out],
            "var_dim": dict(cand.var_dim),
            "n_chunks": n,
            "c": c,
            "n_iters": n_iters,
            "chunk_extent": ext,
            "dispatches": (),
            "body_peak": 0,
            "validated": False,
        },
    )
    node.params["body_peak"] = _body_peak_bytes(node)
    if cand.kernel_bytes is not None:
        # dispatch-aware selection marked this body as kernelizable: cap the
        # modeled body peak so the beam's estimate agrees with the one that
        # picked n; the dispatch pass recomputes it from the real skip sets
        node.params["body_peak"] = min(node.params["body_peak"], cand.kernel_bytes(c))
    return node


def refresh_node(node: ChunkLoopNode) -> None:
    """Recompute derived params after a dispatch changed the node."""
    node.params["body_peak"] = _body_peak_bytes(node)


def apply_chunk(g: Graph, cand: ChunkCandidate, n_chunks: int, *,
                validate: bool = True) -> Graph:
    """Rewrite ``g`` so that ``cand`` executes as a chunk loop.

    Returns a new :class:`Graph` over the same values: prefix nodes, the
    hoisted (chunk-invariant) nodes, one :class:`ChunkLoopNode`, the
    suffix.  A pure data-structure rewrite; nothing is traced.
    """
    stats.bump("lowering_rewrites")
    node = make_chunk_loop(g, cand, n_chunks)
    if validate:
        validate_body(node)
    nodes = (list(g.nodes[:cand.s]) + [g.nodes[i] for i in cand.hoisted] + [node]
             + list(g.nodes[cand.e + 1:]))
    return Graph(invars=list(g.invars), outvars=list(g.outvars), nodes=nodes,
                 weight_invars=set(g.weight_invars), consts=dict(g.consts), gm=g.gm)


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def _runtime_device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def graph_callable(g: Graph) -> Callable[..., Tuple[Any, ...]]:
    """A flat callable evaluating ``g``'s node list on real tensors."""
    invars, outvars, nodes = list(g.invars), list(g.outvars), list(g.nodes)
    consts = dict(g.consts)
    loops = {id(n): _LoopProgram(n) for n in nodes if is_chunk_loop(n)}
    reads = [[] if is_chunk_loop(n) else n.all_input_nodes for n in nodes]
    for i, n in enumerate(nodes):
        if is_chunk_loop(n):
            reads[i] = list(n.invars)
    free = _free_after(len(nodes), reads, set(outvars), [node_outs(n) for n in nodes])

    def fn(*flat_args):
        device = _runtime_device(flat_args)
        env: Dict[Any, Any] = {v: t.to(device) for v, t in consts.items()}
        env.update(zip(invars, flat_args))
        for node, dead in zip(nodes, free):
            prog = loops.get(id(node))
            if prog is not None:
                prog.run(env, device)
            else:
                env[node] = call_op(node.target, node.args, node.kwargs, env, device)
            for v in dead:
                env.pop(v, None)
        return tuple(env[v] for v in outvars)

    return fn


def emit(g: Graph) -> Callable[..., Tuple[Any, ...]]:
    """Emit the rewritten graph as one flat callable (counted as a lowering)."""
    stats.bump("lowering_emits")
    return graph_callable(g)
