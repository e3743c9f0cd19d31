"""Graph capture shared by the AutoChunk compiler passes.

The JAX package traces a function to a flat jaxpr; the port traces it to a
flat aten graph with ``make_fx(tracing_mode="fake")``.  Example arguments
are tensors on the ``meta`` device (or fake tensors): shapes and dtypes
only, nothing is materialized, as the JAX ``trace`` takes
``ShapeDtypeStruct``s.

A :class:`Graph` keeps the op nodes in program order, the bytes each node
allocates (from ``meta["val"]``), the split of the inputs into weights and
activations, and ``last_use`` per storage.  Unlike jaxpr values, aten
nodes can alias: a view (``view``, ``permute``, ``t``, ``expand``, a
``getitem`` of a split) or an in-place op allocates nothing and keeps its
base alive.  Such a node carries 0 bytes and maps to the node that owns
the storage (its ``root``), whose ``last_use`` covers every alias.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Set, Tuple

import torch
from torch.fx import Node
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from . import stats


def val_bytes(val: Any) -> int:
    """Bytes of a node's value (a tensor or a tuple/list of tensors)."""
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (tuple, list)):
        return sum(val_bytes(v) for v in val)
    return 0


def _alias_source(node: Node):
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
    """Flat aten graph of one traced function."""

    invars: List[Node]                 # placeholders, in flattened arg order
    outvars: List[Node]
    nodes: List[Node]                  # op nodes in program order
    weight_invars: Set[Node] = field(default_factory=set)
    gm: Any = None                     # the traced torch.fx.GraphModule

    def __post_init__(self):
        self.root: Dict[Node, Node] = {}
        for v in self.invars:
            self.root[v] = v
        for n in self.nodes:
            src = _alias_source(n)
            self.root[n] = self.root.get(src, src) if src is not None else n
        self.last_use: Dict[Node, int] = {}
        for i, n in enumerate(self.nodes):
            for a in n.all_input_nodes:
                r = self.root.get(a, a)
                self.last_use[r] = max(self.last_use.get(r, -1), i)
        n_nodes = len(self.nodes)
        for v in self.outvars:
            self.last_use[self.root[v]] = n_nodes  # live until the end

    def node_bytes(self, node: Node) -> int:
        """Bytes ``node`` allocates: 0 for aliases and inputs."""
        if self.root.get(node) is not node or node in self.invars:
            return 0
        return val_bytes(node.meta.get("val"))

    def var_bytes(self, node: Node) -> int:
        """Bytes of ``node``'s value, alias or not."""
        return val_bytes(node.meta.get("val"))


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
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    out_leaves, out_spec = pytree.tree_flatten(out_node.args[0])
    outs = [a for a in out_leaves if isinstance(a, Node)]
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    g = Graph(invars=placeholders, outvars=outs, nodes=nodes,
              weight_invars=weight_set, gm=gm)
    return g, out_spec
