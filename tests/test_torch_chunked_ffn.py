"""Port chunked SwiGLU FFN (plain version, CPU) against the JAX Pallas kernel.

The same numpy inputs go through ``repro.kernels.chunked_ffn.chunked_ffn``
in interpret mode, JAX's ``ref.swiglu_ffn_ref`` in float32, and the port's
wrapper on CPU tensors, which runs the plain PyTorch version.  Cases: those
of ``tests/test_kernels.py::test_ffn_kernel_sweep`` plus ragged row counts
(17, 60) and an f wider than the plain version's f-block.  Tolerances:
float32 1e-5 (the two sum in another order); bfloat16 2e-3 + 2^-7 |want|
(both round an f32 result to 8 mantissa bits and may land one unit apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.chunked_ffn import chunked_ffn as jchunked_ffn
from repro_torch.kernels import chunked_ffn as CF
from repro_torch.kernels import ref

torch.set_num_threads(2)

TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-3, 2.0 ** -7)}


def _inputs(S, d, f, dtype, seed=0):
    """x (S, d), w_in (d, 2f) whose first half is up and second gate, w_down
    (f, d), scaled as the JAX sweep scales them; the JAX side gets the same
    (already rounded) values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, d), dtype=np.float32) * 0.3
    w_in = rng.standard_normal((d, 2 * f), dtype=np.float32) * 0.05
    wd = rng.standard_normal((f, d), dtype=np.float32) * 0.05
    tx, tw, twd = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w_in, wd))
    j = [jnp.asarray(t.float().numpy()) for t in (tx, tw, twd)]
    return (tx, tw, twd), j


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


# (S, d, f, bs, bf): the JAX sweep's cases, ragged rows, f over two plain blocks
CASES = [
    pytest.param(128, 32, 256, 64, 64, id="sweep-s128"),
    pytest.param(256, 64, 512, 128, 512, id="sweep-s256"),
    pytest.param(17, 64, 512, 128, 128, id="ragged-s17"),
    pytest.param(60, 32, 256, 64, 128, id="ragged-s60"),
    pytest.param(64, 32, 1024, 64, 256, id="f1024"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,d,f,bs,bf", CASES)
def test_plain_matches_pallas_kernel_and_oracle(S, d, f, bs, bf, dtype):
    (x, w_in, wd), (jx, jw, jwd) = _inputs(S, d, f, dtype)
    wu, wg = w_in[:, :f], w_in[:, f:]
    jwu, jwg = jw[:, :f], jw[:, f:]
    got = CF.chunked_ffn(x, wg, wu, wd)
    assert got.dtype == x.dtype and got.shape == (S, d)
    jdt = jnp.dtype(dtype)
    want_kernel = jchunked_ffn(jx.astype(jdt), jwg.astype(jdt), jwu.astype(jdt),
                               jwd.astype(jdt), block_s=bs, block_f=bf, interpret=True)
    _close(got, want_kernel, dtype)
    _close(got, jref.swiglu_ffn_ref(jx, jwg, jwu, jwd), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_w_in_equals_separate_weights(dtype):
    """Column views of the fused w_in give the separate form's result; the
    views share the fused weight's storage (no copy of either half)."""
    S, d, f = 60, 64, 256
    (x, w_in, wd), _ = _inputs(S, d, f, dtype, seed=1)
    want = CF.chunked_ffn(x, w_in[:, f:].contiguous(), w_in[:, :f].contiguous(), wd)
    assert torch.equal(CF.chunked_ffn_fused(x, w_in, wd), want)
    # gate first, up second: offsets name the halves
    swapped = torch.cat([w_in[:, f:], w_in[:, :f]], dim=1)
    assert torch.equal(CF.chunked_ffn_fused(x, swapped, wd, up=f, gate=0), want)
    views = (w_in[:, f:], w_in[:, :f])
    assert all(v.untyped_storage().data_ptr() == w_in.untyped_storage().data_ptr()
               for v in views)
    assert views[0].stride() == (2 * f, 1)


def test_swiglu_ffn_ref_matches_jax():
    (x, w_in, wd), (jx, jw, jwd) = _inputs(48, 32, 128, "float32", seed=2)
    got = ref.swiglu_ffn_ref(x, w_in[:, 128:], w_in[:, :128], wd)
    _close(got, jref.swiglu_ffn_ref(jx, jw[:, 128:], jw[:, :128], jwd), "float32")


def test_plain_version_matches_oracle_in_f32():
    """The kernel's arithmetic (f32 inside, one rounding at the end) is the
    oracle's in float32."""
    (x, w_in, wd), _ = _inputs(33, 32, 1024, "float32", seed=3)
    wg, wu = w_in[:, 1024:], w_in[:, :1024]
    got = CF.chunked_ffn_plain(x, wg, wu, wd)           # two f-blocks of 512
    _close(got, ref.swiglu_ffn_ref(x, wg, wu, wd), "float32")


def test_cpu_runs_plain_version_and_counts_no_launch():
    (x, w_in, wd), _ = _inputs(17, 32, 128, "float32", seed=4)
    before = CF.chunked_ffn.launches
    got = CF.chunked_ffn_fused(x, w_in, wd)
    assert CF.chunked_ffn.launches == before
    assert torch.equal(got, CF.chunked_ffn_plain(x, w_in[:, 128:], w_in[:, :128], wd))


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    (x, w_in, wd), _ = _inputs(16, 32, 128, "float32", seed=5)
    wg, wu = w_in[:, 128:], w_in[:, :128]
    with pytest.raises(ValueError):
        CF.chunked_ffn(x[:, :16], wg, wu, wd)                 # d disagrees
    with pytest.raises(ValueError):
        CF.chunked_ffn(x, wg, wu, wd[:64])                    # f disagrees
    with pytest.raises(TypeError):
        CF.chunked_ffn(x, wg.bfloat16(), wu, wd)              # mixed dtypes
    with pytest.raises(TypeError):
        CF.chunked_ffn(x.double(), wg.double(), wu.double(), wd.double())
    # a tensor that is neither on the CPU nor on a card: no plain fallback
    meta = [t.to("meta") for t in (x, wg, wu, wd)]
    with pytest.raises(ValueError, match="no kernel for device"):
        CF.chunked_ffn(*meta)


def test_workspace_bytes():
    assert CF.workspace_bytes(2048, 3072, torch.bfloat16) == 2048 * 3072 * 4
    assert CF.workspace_bytes(2048, 3072, torch.float32) == 0
