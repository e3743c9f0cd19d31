"""Port RG-LRU scan (plain version, CPU) against the JAX Pallas kernel and oracle.

The same numpy inputs go through ``repro.kernels.rglru_scan.rglru_scan`` in
interpret mode, JAX's ``rglru_ref`` (a log-depth associative scan) and the
port's wrapper on CPU tensors, which runs the plain PyTorch version (a
sequential f32 loop) through the ``repro_torch::rglru_scan`` custom op.
Cases: the sweep of ``tests/test_kernels.py::test_rglru_kernel_sweep``,
with f32 and bf16 inputs.  Tolerance 1e-5, the JAX sweep's own (the scan
and the loop multiply and add in another order); the output is f32 for
either input type.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as jrglru_scan
from repro_torch.core.graph import eqn_flops, op_name
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as RS

torch.set_num_threads(2)

ATOL = 1e-5


def _inputs(B, S, D, dtype, seed=0):
    """a in (0, 1), b scaled as the JAX sweep scales them; the JAX side gets
    the same (already rounded) values."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D), dtype=np.float32)))
    b = rng.standard_normal((B, S, D), dtype=np.float32) * 0.3
    ta, tb = (torch.from_numpy(x).to(dtype) for x in (a, b))
    return (ta, tb), [jnp.asarray(t.float().numpy()).astype(jnp.dtype(str(dtype)[6:]))
                      for t in (ta, tb)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,chunk", [(1, 64, 16, 16), (2, 256, 32, 64), (1, 128, 8, 128)])
def test_plain_matches_pallas_kernel_and_oracle(B, S, D, chunk, dtype):
    (a, b), (ja, jb) = _inputs(B, S, D, dtype)
    h = RS.rglru_scan(a, b, chunk=chunk)
    assert h.shape == (B, S, D) and h.dtype == torch.float32
    want = jrglru_scan(ja, jb, chunk=chunk, interpret=True)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jref.rglru_ref(ja, jb)), atol=ATOL)


def test_odd_length_and_oracle_match_jax():
    (a, b), (ja, jb) = _inputs(2, 37, 24, torch.float32, seed=1)
    np.testing.assert_allclose(ref.rglru_ref(a, b).numpy(), np.asarray(jref.rglru_ref(ja, jb)),
                               atol=ATOL)
    assert torch.equal(RS.rglru_scan(a, b), ref.rglru_ref(a, b))


def test_plain_version_is_the_recurrence_step_by_step():
    """One multiply and one add a step in f32: the arithmetic the CUDA
    kernel does (it rounds the product before the sum), bit for bit."""
    (a, b), _ = _inputs(1, 20, 8, torch.bfloat16, seed=2)
    h = RS.rglru_scan_plain(a, b)
    hv = torch.zeros(1, 8)
    for t in range(20):
        hv = a[:, t].float() * hv + b[:, t].float()
        assert torch.equal(h[:, t], hv)


def test_strided_inputs_give_the_contiguous_result():
    (a, b), _ = _inputs(2, 30, 16, torch.float32, seed=3)
    packed = torch.cat([a, b], dim=-1)
    av, bv = packed[..., :16], packed[..., 16:]
    assert not av.is_contiguous()
    assert torch.equal(RS.rglru_scan(av, bv), RS.rglru_scan(a, b))


def test_cpu_runs_plain_version_and_counts_no_launch():
    (a, b), _ = _inputs(1, 16, 8, torch.float32, seed=4)
    before = RS.rglru_scan.launches
    assert torch.equal(RS.rglru_scan(a, b), RS.rglru_scan_plain(a, b))
    assert RS.rglru_scan.launches == before


def test_op_traces_as_one_node():
    a = torch.empty((2, 64, 32), dtype=torch.bfloat16, device="meta")
    gm = make_fx(lambda a, b: RS.rglru_scan(a, b), tracing_mode="fake")(a, a.clone())
    ops = [node for node in gm.graph.nodes if node.op == "call_function"]
    assert [op_name(node) for node in ops] == ["rglru_scan"]
    assert ops[0].target is torch.ops.repro_torch.rglru_scan.default
    val = ops[0].meta["val"]
    assert tuple(val.shape) == (2, 64, 32) and val.dtype == torch.float32
    assert eqn_flops(ops[0]) == 2 * 2 * 64 * 32


def test_wrapper_raises_on_what_the_op_does_not_take():
    (a, b), _ = _inputs(1, 16, 8, torch.float32, seed=5)
    with pytest.raises(ValueError):
        RS.rglru_scan(a, b[:, :8])                  # shapes disagree
    with pytest.raises(ValueError):
        RS.rglru_scan(a[0], b[0])                   # not (B, S, D)
    with pytest.raises(TypeError):
        RS.rglru_scan(a, b.bfloat16())              # mixed dtypes
    with pytest.raises(TypeError):
        RS.rglru_scan(a.double(), b.double())
