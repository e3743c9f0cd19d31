"""Port dimflow rules against the JAX package's on the same functions.

Each case is written twice, as a JAX function and as a torch function; the
port traces to aten ops where JAX traces to jaxpr primitives, so the rules
are compared where both meet: for an output dim, which dim of each function
input the chunk flow slices (or ``FULL``, or a break).  The cases are those
of ``tests/test_core_dimflow.py``, plus the merge of a size-1 batch
(``view`` -> ``mm`` -> ``view``) and ``split`` -> ``getitem``, which the
reference lacks.  Exact.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import trace as jtrace
from repro.core.dimflow import FULL as JFULL
from repro.core.dimflow import propagate as jpropagate
from repro_torch.core.dimflow import FULL, propagate
from repro_torch.core.graph import op_name, trace

torch.set_num_threads(2)


def _meta(*shapes):
    return [torch.empty(s, device="meta") for s in shapes]


def port_flow(f, shapes, out_dim):
    """{input index: dim | FULL} the flow needs for output ``out_dim``;
    None when a rule breaks."""
    g, _ = trace(f, _meta(*shapes), weight_argnums=())
    var_dim = {g.outvars[0]: out_dim}
    full = set()
    for node in reversed(g.nodes):
        if node not in var_dim:
            if node in full:  # a whole value needs its inputs whole
                full.update(node.all_input_nodes)
            continue
        req = propagate(node, var_dim[node])
        if req is None:
            return None
        for inp, d in req.items():
            if d == FULL:
                full.add(inp)
            elif var_dim.setdefault(inp, d) != d:
                return "conflict"
    return {i: var_dim.get(v, FULL if v in full else None) for i, v in enumerate(g.invars)}


def jax_flow(f, shapes, out_dim):
    g, _ = jtrace(f, [jnp.zeros(s) for s in shapes], weight_argnums=())
    var_dim = {g.outvars[0]: out_dim}
    full = set()
    for eqn in reversed(g.eqns):
        ov = eqn.outvars[0]
        if ov not in var_dim:
            if ov in full:
                full.update(a for a in eqn.invars if isinstance(a, jax.extend.core.Var))
            continue
        req = jpropagate(eqn, 0, var_dim[ov])
        if req is None:
            return None
        for i, d in req.items():
            a = eqn.invars[i]
            if not isinstance(a, jax.extend.core.Var):
                continue
            if d == JFULL:
                full.add(a)
            elif var_dim.setdefault(a, d) != d:
                return "conflict"
    return {i: var_dim.get(v, FULL if v in full else None) for i, v in enumerate(g.invars)}


CASES = {
    "elementwise": (lambda x: torch.tanh(x), lambda x: jnp.tanh(x), [(4, 8)]),
    "broadcast_binary": (lambda x, y: x / y, lambda x, y: x / y, [(4, 8, 8), (4, 8, 1)]),
    "batched_matmul": (lambda a, b: a @ b.transpose(1, 2),
                       lambda a, b: jnp.einsum("bsd,btd->bst", a, b),
                       [(2, 16, 8), (2, 32, 8)]),
    "reduce": (lambda x: x.sum(dim=1), lambda x: jnp.sum(x, axis=1), [(4, 8, 16)]),
    "reshape_prefix": (lambda x: x.reshape(4, 8, 32), lambda x: x.reshape(4, 8, 32),
                       [(4, 8, 4, 8)]),
    "transpose": (lambda x: x.permute(2, 0, 1), lambda x: jnp.transpose(x, (2, 0, 1)),
                  [(2, 3, 4)]),
    "concat": (lambda a, b: torch.cat([a, b], dim=1),
               lambda a, b: jnp.concatenate([a, b], axis=1), [(2, 4), (2, 4)]),
    "cumsum": (lambda x: torch.cumsum(x, dim=1), lambda x: jnp.cumsum(x, axis=1), [(4, 8)]),
    # a linear layer on (1, S, d): view(S, d) -> mm -> view(1, S, n)
    "linear_batch1": (lambda x, w: x @ w, lambda x, w: x @ w, [(1, 16, 8), (8, 12)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flow_to_inputs_matches_jax(name):
    tf, jf, shapes = CASES[name]
    out_shape = jax.eval_shape(jf, *[jnp.zeros(s) for s in shapes]).shape
    for d, size in enumerate(out_shape):
        if size > 1:  # a size-1 dim is never chunked
            assert port_flow(tf, shapes, d) == jax_flow(jf, shapes, d), (name, d)


def test_softmax_breaks_on_its_axis():
    """One ``_softmax`` node where the jaxpr has max/sub/exp/sum/div; the
    search rejects a sliced softmax axis in both."""
    f = lambda x: torch.softmax(x, dim=-1)
    assert port_flow(f, [(4, 8)], 0) == {0: 0}
    assert port_flow(f, [(4, 8)], 1) is None


def test_linear_batch2_merge_breaks():
    """(2, S, d) merges batch and sequence before the mm: slicing S does not
    commute with the merge, so the flow breaks there (the batch dim, the
    outermost of the merge, still passes)."""
    f = lambda x, w: x @ w
    assert port_flow(f, [(2, 16, 8), (8, 12)], 1) is None
    assert port_flow(f, [(1, 16, 8), (8, 12)], 1) == {0: 1, 1: FULL}


def test_split_getitem_passes_other_dims():
    """``torch.chunk`` traces as split -> getitem; the parts share a chunk
    dim on every axis but the split one."""
    f = lambda h: (lambda u, g: u * torch.sigmoid(g))(*torch.chunk(h, 2, dim=-1))
    assert port_flow(f, [(2, 8, 16)], 0) == {0: 0}
    assert port_flow(f, [(2, 8, 16)], 1) == {0: 1}
    assert port_flow(f, [(2, 8, 16)], 2) is None


def test_arange_breaks_and_hoists():
    g, _ = trace(lambda x: x + torch.arange(8, dtype=torch.float32, device=x.device),
                 _meta((8,)), weight_argnums=())
    arange = next(n for n in g.nodes if op_name(n) == "arange")
    assert propagate(arange, 0) is None
    add = next(n for n in g.nodes if op_name(n) == "add")
    assert propagate(add, 0) == {g.invars[0]: 0, arange: 0}
