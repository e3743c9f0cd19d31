"""The port's AdamW and schedules against ``repro.optim``.

Schedules: ``cosine_schedule`` and ``linear_warmup_cosine`` agree with the
JAX package's at steps 0-40 within 1e-7.  ``adamw_update`` on one random
tree of numpy-seeded values and gradients, three steps: float32 parameters
and moments within 1e-6 relative (both compute in float32; only the order
of the global-norm sum differs), with the clip engaged (norm about 40) and
not (norm 0.05), and with weight decay; bfloat16 parameters with float32
moments within one bfloat16 ulp (2^-8 relative) in the parameters and 1e-5
in the moments, and bfloat16 moments.  The reference's
quadratic-convergence case, ported; a ``None`` gradient raises.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim import linear_warmup_cosine as jwarmup
from repro_torch.optim import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                               linear_warmup_cosine)

torch.set_num_threads(2)

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": [(2, 2), (7,)]}}


@pytest.mark.parametrize("sched", [
    dict(kind="cos", args=(3e-4, 30)), dict(kind="cos", args=(1.0, 7, 0.0)),
    dict(kind="warm", args=(1e-3, 2, 30)), dict(kind="warm", args=(3e-4, 20, 100)),
    dict(kind="warm", args=(0.5, 0, 10, 0.2)),
])
def test_schedules_match_jax(sched):
    ours = (cosine_schedule if sched["kind"] == "cos" else linear_warmup_cosine)(*sched["args"])
    theirs = (jcosine if sched["kind"] == "cos" else jwarmup)(*sched["args"])
    for step in range(41):
        got = ours(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(theirs(jnp.asarray(step, jnp.int32)))
        assert abs(float(got) - want) <= 1e-7, (step, float(got), want)
        assert float(ours(torch.tensor(step, dtype=torch.int32))) == float(got)


def _tree(rng, shapes, scale, dtype):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale, dtype) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v, scale, dtype) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(dtype)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _as_f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _leaves_equal(got, want, rtol, atol):
    g = jax.tree.leaves(jax.tree.map(_as_f32, got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    w = [_as_f32(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


CASES = {
    # (grad scale, param dtype, moment dtype, weight decay, param rtol, moment rtol)
    "f32_clipped": (10.0, np.float32, None, 0.1, 1e-6, 1e-6),
    "f32_unclipped": (0.01, np.float32, None, 0.0, 1e-6, 1e-6),
    "bf16_f32_moments": (10.0, ml_dtypes.bfloat16, "float32", 0.1, 2 ** -8, 1e-5),
    "bf16_unclipped": (0.01, ml_dtypes.bfloat16, "float32", 0.1, 2 ** -8, 1e-5),
    "bf16_bf16_moments": (10.0, ml_dtypes.bfloat16, None, 0.1, 2 ** -8, 2 ** -8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_update_matches_jax(case):
    gscale, dtype, mdt, wd, prtol, mrtol = CASES[case]
    rng = np.random.default_rng(0)
    p_np = _tree(rng, SHAPES, 1.0, dtype)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _to_torch(p_np)
    jst, tst = jadamw_init(jp, moment_dtype=mdt), adamw_init(tp, moment_dtype=mdt)
    assert tst.step == 0
    for step in range(3):
        g_np = _tree(rng, SHAPES, gscale, dtype)
        gnorm = np.sqrt(sum(float(np.sum(np.square(x.astype(np.float32))))
                            for x in jax.tree.leaves(g_np)))
        assert (gnorm > 1.0) == (gscale > 1.0)      # the clip engages, or not
        lr = 1e-3 * (step + 1)
        jp, jst = jadamw_update(jp, jax.tree.map(jnp.asarray, g_np), jst, lr, weight_decay=wd)
        tp, tst = adamw_update(tp, _to_torch(g_np), tst, lr, weight_decay=wd)
        assert tst.step == int(jst.step) == step + 1
        _leaves_equal(tp, jp, prtol, 0.0)
        _leaves_equal(tst.mu, jst.mu, mrtol, 1e-12)
        _leaves_equal(tst.nu, jst.nu, mrtol, 1e-12)
    want_dt = torch.float32 if dtype == np.float32 else torch.bfloat16
    assert all(t.dtype == want_dt for t in jax.tree.leaves(tp))
    mom_dt = torch.float32 if (mdt == "float32" or dtype == np.float32) else torch.bfloat16
    assert all(t.dtype == mom_dt for t in jax.tree.leaves(tst.mu))


def test_adamw_leaves_inputs_unwritten():
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 0.5)}
    st = adamw_init(p)
    new, st2 = adamw_update(p, g, st, 0.1)
    assert torch.equal(p["w"], torch.ones(4)) and torch.equal(st.mu["w"], torch.zeros(4))
    assert not torch.equal(new["w"], p["w"]) and isinstance(st2, AdamWState)


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        torch.sum(w ** 2).backward()
        params, opt = adamw_update(params, {"w": w.grad}, opt, lr=0.1, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_none_gradient_raises():
    p = {"a": torch.ones(2), "b": [torch.ones(3), torch.ones(1)]}
    g = {"a": torch.ones(2), "b": [None, torch.ones(1)]}
    with pytest.raises(ValueError, match=r"no gradient for parameter \['b'\]\[0\]"):
        adamw_update(p, g, adamw_init(p), 1e-3)
    with pytest.raises(ValueError, match="2 gradients for 3 parameters"):
        adamw_update(p, {"a": torch.ones(2), "b": [torch.ones(1)]}, adamw_init(p), 1e-3)
