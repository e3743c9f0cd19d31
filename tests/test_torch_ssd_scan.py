"""Port SSD scan (plain version, CPU) against the JAX Pallas kernel and oracles.

The same numpy inputs go through ``repro.kernels.ssd_scan.ssd_scan`` in
interpret mode, JAX's ``ssd_sequential_ref`` and ``ssd_chunked`` (whose
``h_final`` is the final state), and the port's wrapper on CPU tensors,
which runs the plain PyTorch version (the port of ``ssd_chunked``) through
the ``repro_torch::ssd_scan`` custom op.  Cases: the three of
``tests/test_kernels.py::test_ssd_kernel_vs_sequential``, a length the
chunk does not divide (the dt = 0 padding) and batch 2.  Tolerances:
float32 2e-4, the JAX sweep's own (the chunked and the sequential forms sum
in another order); bfloat16 x, B and C 2e-3 + 2^-7 |want| on y (both round
an f32 result to 8 mantissa bits and may land one unit apart), 2e-4 on the
f32 state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.core.graph import eqn_flops, op_name
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as SS

torch.set_num_threads(2)

ATOL = 2e-4


def _inputs(b, s, h, p, n, seed=0):
    """x (b,s,h,p), dt (b,s,h) after softplus, A (h,) < 0, B and C (b,s,n),
    scaled as the JAX sweep scales them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    A = -np.exp(rng.standard_normal((h,), dtype=np.float32) * 0.3)
    B = rng.standard_normal((b, s, n), dtype=np.float32) * 0.5
    C = rng.standard_normal((b, s, n), dtype=np.float32) * 0.5
    return x, dt, A, B, C


def _torch(arrs, dtype=torch.float32):
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrs)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


# (b, s, h, p, n, chunk)
CASES = [
    pytest.param(1, 64, 2, 8, 4, 16, id="sweep-s64"),
    pytest.param(2, 128, 3, 16, 8, 32, id="sweep-b2-s128"),
    pytest.param(1, 256, 1, 32, 16, 64, id="sweep-s256"),
    pytest.param(1, 100, 2, 8, 4, 32, id="ragged-s100"),
    pytest.param(2, 48, 2, 16, 16, 16, id="b2-reduced-chunk"),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_plain_matches_pallas_kernel_and_oracles(b, s, h, p, n, chunk):
    arrs = _inputs(b, s, h, p, n)
    y, state = SS.ssd_scan(*_torch(arrs), chunk=chunk)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrs]
    y_seq, st_seq = jref.ssd_sequential_ref(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_seq), atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(st_seq), atol=ATOL)
    y_ch, h_final = jssd_chunked(*j, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ch), atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(h_final), atol=ATOL)
    if s % chunk == 0:          # the Pallas wrapper takes whole chunks only
        y_k = jssd_scan(*j, chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_k), atol=ATOL)


def test_bf16_inputs_against_pallas_kernel():
    """bf16 x, B and C with f32 dt: y in bf16, the state in f32."""
    arrs = _inputs(1, 128, 2, 16, 8, seed=1)
    x, dt, A, B, C = _torch(arrs, torch.bfloat16)
    y, state = SS.ssd_scan(x, dt, A, B, C, chunk=32)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    jx, jB, jC = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, B, C))
    jdt, jA = jnp.asarray(arrs[1]), jnp.asarray(arrs[2])
    want = np.asarray(jssd_scan(jx, jdt, jA, jB, jC, chunk=32, interpret=True), np.float32)
    np.testing.assert_allclose(y.float().numpy(), want, atol=2e-3, rtol=2.0 ** -7)
    _, h_final = jssd_chunked(jx, jdt, jA, jB, jC, 32)
    np.testing.assert_allclose(state.numpy(), np.asarray(h_final), atol=ATOL)


def test_chunk_larger_than_sequence_is_cut_to_it():
    arrs = _inputs(1, 24, 2, 8, 4, seed=2)
    y, state = SS.ssd_scan(*_torch(arrs), chunk=128)
    y1, state1 = SS.ssd_scan_plain(*_torch(arrs), 24)
    assert torch.equal(y, y1) and torch.equal(state, state1)


def test_oracles_match_jax():
    arrs = _inputs(2, 40, 2, 8, 4, seed=3)
    t, j = _torch(arrs), [jnp.asarray(a) for a in arrs]
    y, st = ref.ssd_sequential_ref(*t)
    y_j, st_j = jref.ssd_sequential_ref(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), atol=ATOL)
    y2, st2 = ref.ssd_ref(*t, 16)
    y2_j, st2_j = jref.ssd_ref(*j, 16)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y2_j), atol=ATOL)
    np.testing.assert_allclose(st2.numpy(), np.asarray(st2_j), atol=ATOL)


def test_strided_views_give_the_contiguous_result():
    """x, B and C as column slices of one (b, s, hp + 2n) tensor, as the SSM
    block hands them over."""
    b, s, h, p, n = 1, 64, 2, 8, 4
    x, dt, A, B, C = _torch(_inputs(b, s, h, p, n, seed=4))
    packed = torch.cat([x.reshape(b, s, h * p), B, C], dim=-1)
    xv = packed[..., :h * p].reshape(b, s, h, p)
    Bv, Cv = packed[..., h * p:h * p + n], packed[..., h * p + n:]
    assert not xv.is_contiguous() and not Bv.is_contiguous()
    got = SS.ssd_scan(xv, dt, A, Bv, Cv, chunk=16)
    want = SS.ssd_scan(x, dt, A, B, C, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_runs_plain_version_and_counts_no_launch():
    arrs = _inputs(1, 32, 1, 8, 4, seed=5)
    before = SS.ssd_scan.launches
    got = SS.ssd_scan(*_torch(arrs), chunk=16)
    assert SS.ssd_scan.launches == before
    want = SS.ssd_scan_plain(*_torch(arrs), 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_op_traces_as_one_node():
    """Under ``make_fx(tracing_mode="fake")`` the op is one node with the
    outputs' shapes and dtypes, and the FLOP model counts it."""
    b, s, h, p, n = 1, 256, 4, 16, 8
    x = torch.empty((b, s, h, p), dtype=torch.bfloat16, device="meta")
    dt = torch.empty((b, s, h), device="meta")
    A = torch.empty((h,), device="meta")
    B = torch.empty((b, s, n), dtype=torch.bfloat16, device="meta")

    def fn(x, dt, A, B, C):
        return SS.ssd_scan(x, dt, A, B, C, chunk=64)

    gm = make_fx(fn, tracing_mode="fake")(x, dt, A, B, B.clone())
    ops = [node for node in gm.graph.nodes if node.op == "call_function"]
    scans = [node for node in ops if op_name(node) == "ssd_scan"]
    assert len(scans) == 1
    assert scans[0].target is torch.ops.repro_torch.ssd_scan.default
    assert all(op_name(node) in ("ssd_scan", "getitem") for node in ops)
    y, st = scans[0].meta["val"]
    assert tuple(y.shape) == (b, s, h, p) and y.dtype == torch.bfloat16
    assert tuple(st.shape) == (b, h, p, n) and st.dtype == torch.float32
    q, nc = 64, 4
    assert eqn_flops(scans[0]) == b * h * nc * (2 * q * q * n + 2 * q * q * p + 4 * q * n * p)


def test_wrapper_raises_on_what_the_op_does_not_take():
    x, dt, A, B, C = _torch(_inputs(1, 32, 2, 8, 4, seed=6))
    with pytest.raises(ValueError):
        SS.ssd_scan(x, dt[:, :16], A, B, C)                   # s disagrees
    with pytest.raises(ValueError):
        SS.ssd_scan(x, dt, A[:1], B, C)                       # h disagrees
    with pytest.raises(ValueError):
        SS.ssd_scan(x, dt, A, B, C[..., :2])                  # C is not B's shape
    with pytest.raises(ValueError):
        SS.ssd_scan(x, dt, A, B, C, chunk=0)
    with pytest.raises(TypeError):
        SS.ssd_scan(x, dt, A, B.bfloat16(), C)                # B is not x's dtype
    with pytest.raises(TypeError):
        SS.ssd_scan(x, dt.double(), A, B, C)                  # dt must be f32
    with pytest.raises(TypeError):
        SS.ssd_scan(x.double(), dt, A, B.double(), C.double())
