"""The rules that keep gradients honest, the checkpoints and the train CLI.

- A compile whose call needs gradients never dispatches a kernel: with
  ``kernel_dispatch='on'`` it raises, naming the ROADMAP item; under
  ``'auto'`` on a host where a card is reported (``torch.cuda.is_available``
  patched, the kernels' plain versions on CPU tensors) the inference compile
  of reduced gpt-paper's block (S 128, budget 0.3) dispatches its attention
  and the training compile of the same block visits no site, with its own plan key, and its
  gradients equal the unbudgeted ones (1e-5 of each leaf's largest).
- A ``ChunkedFunction`` called without and then with gradients compiles
  twice, keys the two plans apart, and replays each only for its own mode.
- The stacked and list forms give the same gradients (each layer's slice of
  a stacked weight is a view, so its gradient accumulates into the stack),
  unbudgeted and at budget 0.4, within 1e-6 of each leaf's largest.
- ``refuse_grad`` (what the kernel wrappers call before a CUDA launch)
  raises on an input that needs gradients and only then; the CPU branches
  of ``computed_attention`` and ``chunked_ffn`` differentiate.
- Checkpoints: a float32 model round-trips (stacked, list, onto another
  seed's weights of the same shapes); one written by
  ``repro.checkpointing.save_checkpoint`` loads through the port's
  ``load_checkpoint`` with equal values, and the port's loads back through
  the JAX package's; bfloat16 round-trips bit-equal and
  a JAX-written bfloat16 checkpoint loads bit-equal; the reference's
  missing-key and shape errors; ``run_train`` writes its checkpoints.
- ``python -m repro_torch.launch.train --arch gpt-paper --local --steps 3
  --device cpu`` exits 0 with the JAX CLI's first line and ``[train] done``.
"""
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.checkpointing import load_checkpoint as jload_checkpoint
from repro.checkpointing import save_checkpoint as jsave_checkpoint
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.checkpointing import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, autochunk, plan_cache_key, stats
from repro_torch.data import make_batch, synthetic_stream
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import chunked_attention as CA
from repro_torch.kernels import chunked_ffn as CF
from repro_torch.kernels import refuse_grad
from repro_torch.models import model as M
from repro_torch.training import loss_fn, run_train

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _block(w, x):
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    logits = q @ k.transpose(-1, -2) / math.sqrt(x.shape[-1])
    o = (torch.softmax(logits, dim=-1) @ v) @ w["wo"]
    h = x + o
    return h + F.gelu(h @ w["w1"]) @ w["w2"]


def _weights(d=32, f=64, seed=0, grad=False):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, f), "w2": (f, d)}
    return {k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1)
            .requires_grad_(grad) for k, s in shapes.items()}


def _x(seq=64, d=32, seed=9):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((1, seq, d),
                                                                        dtype=np.float32))


def _jax_tree(arch="gpt-paper", dtype="float32", **kw):
    jcfg = jax_config(arch).reduced().with_(dtype=dtype, **kw)
    return jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0))


def _model(arch="gpt-paper", dtype="float32", **kw):
    jcfg, jparams = _jax_tree(arch, dtype, **kw)
    cfg = get_config(arch).reduced().with_(dtype=dtype, **kw)
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _grads(cfg, model, batch):
    model.requires_grad_()
    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(cfg, model, batch, remat=False)
    loss.backward()
    out = {k: p.grad.clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    model.requires_grad_(False)
    return out


# ---------------------------------------------------------------------------
# kernel dispatch and plan keys under gradients
# ---------------------------------------------------------------------------

def test_kernel_dispatch_on_with_gradients_raises():
    for kd, want in (("auto", False), ("off", False)):
        assert ChunkConfig(kernel_dispatch=kd).resolve_kernel_dispatch(grad=True) is want
    with pytest.raises(NotImplementedError, match="no kernel of either package has a backward"):
        ChunkConfig(kernel_dispatch="on").resolve_kernel_dispatch(grad=True)
    cf = autochunk(_block, ChunkConfig(budget_ratio=0.4, kernel_dispatch="on"))
    w, x = _weights(grad=True), _x()
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 12"):
        cf.compile(w, x)
    with pytest.raises(NotImplementedError, match="has a backward"):
        cf(w, x)
    # the same compile needs no gradient under no_grad, nor with frozen weights
    with torch.no_grad():
        y = cf(w, x)
    assert y.grad_fn is None and cf.stats()["compiled_shapes"] == 1
    cf(_weights(), x)
    assert cf.stats()["compiled_shapes"] == 1 and cf.stats()["shape_hits"] == 1


def test_grad_and_inference_compiles_never_share_a_plan():
    cf = autochunk(_block, ChunkConfig(budget_ratio=0.4))
    w, wg, x = _weights(), _weights(grad=True), _x()
    want = _block(w, x)
    with torch.no_grad():
        y0 = cf(w, x)
        t0 = cf.trace(w, x)
        key0 = t0.cache_key()
    assert cf.stats()["compiles"] == 1 and y0.grad_fn is None
    # an inference key has no grad knob: plan caches written before grad
    # joined the keys still hit
    knobs = dict(cf.config.search_knobs(), kernel_target=t0.target)
    assert key0 == plan_cache_key(t0.graph, t0.budget_bytes, cf.config.hyper, knobs)
    y1 = cf(wg, x)
    key1 = cf.trace(wg, x).cache_key()
    assert cf.stats()["compiles"] == 2 and y1.grad_fn is not None
    assert key0 != key1 and cf.autochunk_result.plan
    assert len({c.result.cache_key for c in cf._compiled.values()}) == 2
    np.testing.assert_allclose(y1.detach().numpy(), want.numpy(), atol=1e-5)
    # each mode replays its own plan: no third compile, outputs as before
    with torch.no_grad():
        y2 = cf(wg, x)       # weights that require grad, but no grad mode
    y3 = cf(wg, x)
    assert cf.stats()["compiles"] == 2 and cf.stats()["shape_hits"] == 2
    assert y2.grad_fn is None and y3.grad_fn is not None
    # the grad plan's gradients are the unchunked function's
    y3.square().sum().backward()
    got = {k: v.grad.clone() for k, v in wg.items()}
    ref = {k: v.detach().clone().requires_grad_(True) for k, v in wg.items()}
    _block(ref, x).square().sum().backward()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), ref[k].grad.numpy(),
                                   atol=1e-5 * float(ref[k].grad.abs().max()))


def test_auto_dispatch_is_off_for_a_training_compile(monkeypatch):
    """On a host that reports a card, ``'auto'`` dispatches for inference
    and not for a compile that needs gradients (kernel target: the CPU
    tensors' plain versions)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg, model = _model()
    batch = make_batch(cfg, 2, 128, seed=1, device="cpu")
    ref = _grads(cfg, model, batch)
    M._AC_CACHE.clear()
    bcfg = cfg.with_(autochunk_budget=0.3)      # the plan chunks the attention at S 128
    before = stats.snapshot()
    with torch.no_grad():
        M.forward(bcfg, model, batch)
    d = stats.delta(before)
    assert d["kernel_dispatch_hits"] >= 1
    before = stats.snapshot()
    got = _grads(bcfg, model, batch)
    d = stats.delta(before)
    assert d["kernel_dispatch_hits"] == d["kernel_dispatch_misses"] == 0
    assert d["search_passes"] >= 1
    (cf,) = M._AC_CACHE.values()
    assert cf.stats()["compiles"] == 2
    results = [c.result for c in cf._compiled.values()]
    assert len({r.cache_key for r in results}) == 2 and all(r.plan for r in results)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=1e-5 * float(ref[k].abs().max()))
    M._AC_CACHE.clear()


@pytest.mark.parametrize("budget", [None, 0.4], ids=["unbudgeted", "budget0.4"])
def test_stacked_and_list_forms_give_the_same_gradients(budget):
    jcfg, jparams = _jax_tree()
    tree = jax.tree.map(np.asarray, jparams)
    listed = dict(tree, blocks=[jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
                                for i in range(jcfg.n_layers)])
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32", autochunk_budget=budget)
    lcfg = cfg.with_(scan_layers=False)
    stacked = params_from_numpy(cfg, tree, device="cpu")
    lmodel = params_from_numpy(lcfg, listed, device="cpu")
    batch = make_batch(cfg, 2, 64, seed=2, device="cpu")
    M._AC_CACHE.clear()
    gs, gl = _grads(cfg, stacked, batch), _grads(lcfg, lmodel, batch)
    n = 0
    for k, g in gs.items():
        if not k.startswith("blocks."):
            np.testing.assert_allclose(gl[k].numpy(), g.numpy(), atol=1e-6 * float(g.abs().max()))
            continue
        for i in range(cfg.n_layers):
            li = gl["blocks.%d.%s" % (i, k[len("blocks."):])]
            assert float(g[i].abs().max()) > 0
            np.testing.assert_allclose(li.numpy(), g[i].numpy(),
                                       atol=1e-6 * float(g[i].abs().max()))
            n += 1
    assert n == cfg.n_layers * sum(k.startswith("blocks.") for k in gs)
    M._AC_CACHE.clear()


def test_refuse_grad_and_plain_kernels_differentiate():
    t, f = torch.ones(2, requires_grad=True), torch.ones(2)
    with pytest.raises(NotImplementedError, match="has no backward"):
        refuse_grad("computed_attention", f, t)
    refuse_grad("computed_attention", f, None)
    with torch.no_grad():
        refuse_grad("computed_attention", t)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 32), dtype=np.float32))
               .requires_grad_(True) for _ in range(3))
    out = CA.computed_attention(q, k, v, scale=0.2)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(torch.isfinite(t.grad).all() and t.grad.abs().max() > 0 for t in (q, k, v))
    x = torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32))
    w = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1).requires_grad_(True)
         for s in ((16, 32), (16, 32), (32, 16))]
    CF.chunked_ffn(x, *w).sum().backward()
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in w)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _assert_same(a, b):
    na, nb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(na) == sorted(nb)
    for k in na:
        assert na[k].dtype == nb[k].dtype, k
        assert torch.equal(na[k].view(torch.int16) if na[k].dtype == torch.bfloat16 else na[k],
                           nb[k].view(torch.int16) if nb[k].dtype == torch.bfloat16 else nb[k]), k


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
def test_checkpoint_round_trip_f32(tmp_path, scan_layers):
    cfg, model = _model(scan_layers=scan_layers)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, model, step=7, extra={"note": "x"})
    back, step = load_checkpoint(path, model)
    assert step == 7 and isinstance(back, M.Model) and back.cfg == cfg
    _assert_same(back, model)
    like = M.init_params(cfg, 1, device="cpu")         # other numbers, same shapes
    back2, _ = load_checkpoint(path[:-4], like)        # ".npz" optional
    _assert_same(back2, model)
    keys = json_keys(path)
    prefix = "blocks/attn/wq" if scan_layers else "blocks/0/attn/wq"
    assert prefix in keys and "embed/embedding" in keys


def json_keys(path):
    import json
    with np.load(path) as d:
        return json.loads(str(d["__meta__"]))["keys"]


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "list"])
def test_checkpoint_interop_with_jax_f32(tmp_path, scan_layers):
    jcfg, jparams = _jax_tree(scan_layers=scan_layers)
    cfg, model = _model(scan_layers=scan_layers)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jsave_checkpoint(jpath, jparams, step=3)
    like = M.init_params(cfg, 1, device="cpu")         # other numbers, same shapes
    back, step = load_checkpoint(jpath, like)
    assert step == 3
    _assert_same(back, model)
    save_checkpoint(tpath, back, step=4)
    assert json_keys(tpath) == json_keys(jpath)
    jback, jstep = jload_checkpoint(tpath, jparams)
    assert jstep == 4
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_bf16_bit_equal(tmp_path):
    jcfg, jparams = _jax_tree(dtype="bfloat16")
    cfg, model = _model(dtype="bfloat16")
    path, jpath = str(tmp_path / "bf16.npz"), str(tmp_path / "jbf16.npz")
    save_checkpoint(path, model)
    with np.load(path) as d:
        assert d["embed/embedding"].dtype == np.dtype("V2")
    back, _ = load_checkpoint(path, model)
    _assert_same(back, model)
    jsave_checkpoint(jpath, jparams)            # ml_dtypes bfloat16, stored as 2-byte voids
    jback, _ = load_checkpoint(jpath, model)
    _assert_same(jback, model)


def test_checkpoint_errors(tmp_path):
    cfg, model = _model()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"embed": {"embedding": model["embed"]["embedding"]}})
    with pytest.raises(KeyError, match="checkpoint missing key blocks/"):
        load_checkpoint(path, model)
    save_checkpoint(path, model)
    wide, _ = _model(d_model=64)
    with pytest.raises(ValueError, match="shape mismatch for "):
        load_checkpoint(path, M.init_params(wide, device="cpu"))


def test_run_train_writes_checkpoints(tmp_path):
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    model = M.init_params(cfg, 0, device="cpu")
    path = str(tmp_path / "run.npz")
    model, _, _ = run_train(cfg, model, synthetic_stream(cfg, 2, 16, device="cpu"), steps=3,
                            checkpoint_path=path, checkpoint_every=2, log_fn=lambda s: None)
    back, step = load_checkpoint(path, model)
    assert step == 3
    _assert_same(back, model)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_local_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ck = str(tmp_path / "cli.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt-paper", "--local",
         "--steps", "3", "--device", "cpu", "--checkpoint", ck],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    jcfg, jparams = _jax_tree()
    n = sum(x.size for x in jax.tree.leaves(jparams))
    assert lines[0] == (f"[train] gpt-paper (dense); {n/1e6:.1f}M params; batch=8 seq=256")
    assert lines[1].startswith("step     0 loss=") and lines[2].startswith("step     2 loss=")
    assert lines[-1].startswith("[train] done: loss ")
    assert os.path.exists(ck)
