"""Graph capture shared by the AutoChunk compiler passes.

The JAX package traces a function to a flat jaxpr; the port traces it to a
flat aten graph with ``make_fx(tracing_mode="fake")``.  Example arguments
are tensors on the ``meta`` device (or fake tensors): shapes and dtypes
only, nothing is materialized, as the JAX ``trace`` takes
``ShapeDtypeStruct``s.  A model is traced over a dict of its parameter
tensors (``torch.func.functional_call``), so weights are placeholders under
``weight_argnums``, never ``get_attr`` constants.

FX ``Node``s take the place of jaxpr ``Var``s: a node is both the op and the
value it produces.  A :class:`Graph` keeps the op nodes in program order
(after a chunk rewrite, also ``core.lowering`` chunk-loop nodes, which read
``invars`` and define ``outvars``), the bytes each value allocates (from
``meta["val"]``), the split of the inputs into weights and activations,
constants (``get_attr`` tensors), and liveness.  Unlike jaxpr values, aten
nodes can alias: a view (``view``, ``permute``, ``expand``, a ``getitem`` of
a split) or an in-place op allocates nothing and keeps its base alive.  Such
a node carries 0 bytes and maps to the value that owns the storage (its
``root``), whose ``last_use`` covers every alias.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.fx import Node
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from ..kernels import OP_FLOPS
from . import stats


def val_bytes(val: Any) -> int:
    """Bytes of a node's value (a tensor or a tuple/list of tensors)."""
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (tuple, list)):
        return sum(val_bytes(v) for v in val)
    return 0


# The passes read shapes and sizes of the same values many times over; both
# are cached in the node's meta (the trace belongs to the compiler).

def atom_bytes(v: Node) -> int:
    """Bytes of a value, alias or not."""
    b = v.meta.get("autochunk_bytes")
    if b is None:
        b = v.meta["autochunk_bytes"] = val_bytes(v.meta.get("val"))
    return b


def vshape(v: Node) -> Tuple[int, ...]:
    """Shape of a value; for a tuple/list value (a split), its first element's."""
    shape = v.meta.get("autochunk_shape")
    if shape is None:
        val = v.meta.get("val")
        while isinstance(val, (tuple, list)) and val:
            val = val[0]
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else ()
        v.meta["autochunk_shape"] = shape
    return shape


def vdtype(v: Node):
    val = v.meta.get("val")
    return val.dtype if isinstance(val, torch.Tensor) else None


def is_tensor_value(v: Node) -> bool:
    return isinstance(v.meta.get("val"), torch.Tensor)


def op_name(node) -> str:
    """``"add"``, ``"view"``, ``"getitem"``...; ``""`` for non-FX nodes."""
    if not isinstance(node, Node):
        return ""
    t = node.target
    if t is operator.getitem:
        return "getitem"
    packet = getattr(t, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(t, "__name__", str(t))


def node_outs(node) -> List[Node]:
    """Values an entry of ``Graph.nodes`` defines."""
    return [node] if isinstance(node, Node) else list(node.outvars)


def node_ins(node) -> List[Node]:
    """Values an entry of ``Graph.nodes`` reads."""
    return list(node.all_input_nodes) if isinstance(node, Node) else list(node.invars)


def alias_source(node: Node) -> Optional[Node]:
    """The input node whose storage ``node`` aliases, or None."""
    if node.target is operator.getitem:
        return node.args[0]
    schema = getattr(node.target, "_schema", None)
    if schema is None or not schema.returns:
        return None
    if schema.returns[0].alias_info is None:
        return None
    src = node.args[0] if node.args else None
    return src if isinstance(src, Node) else None


@dataclass
class Graph:
    """Flat aten graph of one traced function (possibly chunk-rewritten)."""

    invars: List[Node]                 # placeholders, in flattened arg order
    outvars: List[Node]
    nodes: List[Any]                   # op nodes (and chunk loops) in order
    weight_invars: Set[Node] = field(default_factory=set)
    consts: Dict[Node, torch.Tensor] = field(default_factory=dict)
    gm: Any = None                     # the traced torch.fx.GraphModule

    def __post_init__(self):
        self.ins: List[List[Node]] = [node_ins(n) for n in self.nodes]
        self.outs: List[List[Node]] = [node_outs(n) for n in self.nodes]
        self.producer: Dict[Node, int] = {}
        self.consumers: Dict[Node, List[int]] = {}
        self.root: Dict[Node, Node] = {}
        for v in list(self.invars) + list(self.consts):
            self.root[v] = v
        for i, n in enumerate(self.nodes):
            for ov in self.outs[i]:
                self.producer[ov] = i
                src = alias_source(ov) if isinstance(n, Node) else None
                self.root[ov] = self.root.get(src, src) if src is not None else ov
            for iv in self.ins[i]:
                self.consumers.setdefault(iv, []).append(i)
        n_nodes = len(self.nodes)
        # last_ref: last reader of each value; last_use: of each storage root
        self.last_ref: Dict[Node, int] = {v: max(cs) for v, cs in self.consumers.items()}
        for v in self.outvars:
            self.last_ref[v] = n_nodes  # live until the end
        self.last_use: Dict[Node, int] = {}
        for v, i in self.last_ref.items():
            r = self.root.get(v, v)
            self.last_use[r] = max(self.last_use.get(r, -1), i)
        self.out_set: Set[Node] = set(self.outvars)
        self.input_set: Set[Node] = set(self.invars) | set(self.consts)

    def node_bytes(self, v: Node) -> int:
        """Bytes value ``v`` allocates: 0 for aliases, inputs and constants."""
        if self.root.get(v) is not v or v in self.input_set:
            return 0
        return atom_bytes(v)

    def var_bytes(self, v: Node) -> int:
        """Bytes of ``v``'s value, alias or not."""
        return atom_bytes(v)


def trace(fn: Callable, example_args: Sequence[Any],
          weight_argnums: Sequence[int] = (0,)) -> Tuple[Graph, Any]:
    """Trace ``fn(*example_args)`` to a :class:`Graph`.

    ``example_args`` are pytrees (dicts, lists, tuples) of tensors, best on
    the ``meta`` device.  Returns (graph, output pytree spec).
    """
    stats.bump("trace_calls")
    gm = make_fx(fn, tracing_mode="fake")(*example_args)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    weight_set: Set[Node] = set()
    pos = 0
    for argi, arg in enumerate(example_args):
        cnt = len(pytree.tree_leaves(arg))
        if argi in weight_argnums:
            weight_set.update(placeholders[pos:pos + cnt])
        pos += cnt
    consts = {n: getattr(gm, n.target) for n in gm.graph.nodes if n.op == "get_attr"}
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    out_leaves, out_spec = pytree.tree_flatten(out_node.args[0])
    outs = [a for a in out_leaves if isinstance(a, Node)]
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    g = Graph(invars=placeholders, outvars=outs, nodes=nodes,
              weight_invars=weight_set, consts=consts, gm=gm)
    return g, out_spec


# ---------------------------------------------------------------------------
# FLOP model (the chunk-selection cost function reads it)
# ---------------------------------------------------------------------------

def _numel(v: Node) -> int:
    val = v.meta.get("val")
    if isinstance(val, torch.Tensor):
        return val.numel()
    if isinstance(val, (tuple, list)):
        return sum(x.numel() for x in val if isinstance(x, torch.Tensor))
    return 0


def eqn_flops(node) -> float:
    """Cheap analytic FLOP estimate for one graph entry."""
    if not isinstance(node, Node):
        # chunk loop: body nodes keep their full-extent values, so their
        # summed flops already equal the total across iterations
        return sum(eqn_flops(op.node) for op in node.params["body"])
    f = node.meta.get("autochunk_flops")
    if f is None:
        f = node.meta["autochunk_flops"] = _node_flops(node)
    return f


def _node_flops(node: Node) -> float:
    name = op_name(node)
    if name in ("mm", "bmm", "addmm", "baddbmm"):
        a = node.args[1] if name in ("addmm", "baddbmm") else node.args[0]
        return 2.0 * _numel(node) * vshape(a)[-1]
    if name in OP_FLOPS:            # a kernel op counts its own work
        return OP_FLOPS[name](*(a.meta["val"] if isinstance(a, Node) else a
                                for a in node.args))
    if name in ("sum", "mean", "amax", "amin", "argmax", "argmin"):
        return float(_numel(node.args[0]))
    return float(_numel(node))


def graph_flops(g: Graph, lo: int = 0, hi: Optional[int] = None) -> float:
    hi = len(g.nodes) if hi is None else hi
    return sum(eqn_flops(n) for n in g.nodes[lo:hi])


def dim_stride(shape: Sequence[int], dim: int) -> int:
    """Row-major stride (in elements) of ``dim``."""
    s = 1
    for d in shape[dim + 1:]:
        s *= d
    return s
