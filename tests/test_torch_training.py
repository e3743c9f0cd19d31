"""The port's training loop against ``repro.training``.

Weights from the JAX ``init_params`` carried over by
``repro_torch.interop``, batches from the port's and the JAX package's
``make_batch`` (bit-equal), all ``reduced()`` in float32:

- ``loss_fn``'s ``loss``, ``ce``, ``aux`` and ``mtp_ce`` within 1e-5 on
  gpt-paper (dense), internvl2-1b (vlm: the text slice after the patches),
  qwen2-moe-a2.7b (aux; at the reduced capacity factor 8 an expert's
  capacity holds every token, so none overflows and C-ref-4 does not
  enter) and deepseek-v3-671b (MLA, the MTP term on the re-embedded
  inputs);
- gpt-paper's gradients against ``jax.grad`` of the reference ``loss_fn``,
  leaf by leaf within 1e-4 of each leaf's largest gradient, with ``remat``
  on and off and through the per-block AutoChunk plan at budget 0.4 (the
  plan has a stage: ``_AC_CACHE``'s ``autochunk_result``);
- one ``make_train_step`` against the JAX step: loss and lr within 1e-6;
  the new weights whose gradient is at least 1e-3 of its leaf's largest
  within 1e-6 of the leaf's largest value (plus 1e-6), every weight within
  Adam's first-step bound of 2 lr (where |g| is near eps the step follows
  the gradients' own 1e-4 differences); moments within 1e-4 (mu) and 2e-4
  (nu) of each leaf's largest; a 6-step ``run_train`` history within 1e-4;
- the port of ``test_training_loss_decreases`` (30 steps, a drop of more
  than 0.5);
- ``run_train`` refuses the ssm and hybrid families, naming A12(b).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import make_batch as jmake_batch
from repro.models import model as JM
from repro.optim import adamw_init as jadamw_init
from repro.optim import linear_warmup_cosine as jwarmup
from repro.training import loss_fn as jloss_fn
from repro.training import make_train_step as jmake_train_step
from repro.training import run_train as jrun_train
from repro_torch.configs import get_config
from repro_torch.data import make_batch, synthetic_stream
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.training import loss_fn, make_train_step, run_train

torch.set_num_threads(2)

GRAD_RTOL = 1e-4     # of each leaf's largest gradient


def _pair(arch, **kw):
    kw = dict(dtype="float32", **kw)
    cfg = get_config(arch).reduced().with_(**kw)
    jcfg = jax_config(arch).reduced().with_(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, model, jparams


def _batches(cfg, jcfg, B, S, seed=0):
    return make_batch(cfg, B, S, seed=seed, device="cpu"), jmake_batch(jcfg, B, S, seed=seed)


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(named):
    return {k.replace(".", "/"): v.detach().numpy() for k, v in named.items()}


def _close_per_leaf(got, want, rtol, floor=0.0):
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= rtol * scale + floor, (k, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


LOSS_ARCHS = {
    "gpt-paper": dict(B=2, S=32),
    "internvl2-1b": dict(B=2, S=24),
    "qwen2-moe-a2.7b": dict(B=2, S=32),
    "deepseek-v3-671b": dict(B=2, S=32),
}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", list(LOSS_ARCHS))
def test_loss_fn_matches_jax(arch, remat):
    cfg, jcfg, model, jparams = _pair(arch)
    c = LOSS_ARCHS[arch]
    batch, jbatch = _batches(cfg, jcfg, c["B"], c["S"])
    if cfg.family == "moe":
        # an expert's capacity holds every token, so none overflows (C-ref-4)
        assert MOE.capacity(cfg, c["B"] * c["S"]) >= c["B"] * c["S"]
    with torch.no_grad():
        loss, met = loss_fn(cfg, model, batch, remat=remat)
    jloss, jmet = jloss_fn(jcfg, jparams, jbatch, remat=remat)
    assert sorted(met) == sorted(jmet)
    assert ("mtp_ce" in met) == bool(cfg.mtp)
    for k in jmet:
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-5, (k, float(met[k]), float(jmet[k]))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    if cfg.family == "moe":
        assert float(met["aux"]) > 0


def _port_grads(cfg, model, batch, remat):
    model.requires_grad_()
    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(cfg, model, batch, remat=remat)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    out = _tflat(grads)
    model.requires_grad_(False)
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), out


@pytest.mark.parametrize("budget", [None, 0.4], ids=["unbudgeted", "budget0.4"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_jax_grad(remat, budget):
    cfg, jcfg, model, jparams = _pair("gpt-paper")
    batch, jbatch = _batches(cfg, jcfg, 2, 64)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, jbatch, remat=remat), has_aux=True)(jparams)
    M._AC_CACHE.clear()
    run_cfg = cfg.with_(autochunk_budget=budget) if budget else cfg
    loss, grads = _port_grads(run_cfg, model, batch, remat)
    assert abs(loss - float(jloss)) <= 1e-5
    _close_per_leaf(grads, _jflat(jgrads), GRAD_RTOL)
    if budget:
        (cf,) = M._AC_CACHE.values()
        r = cf.autochunk_result
        assert r is not None and len(r.plan) >= 1 and r.final_peak < r.baseline_peak
        # one compile (the grad one) served every layer, and the recompute
        assert cf.stats()["compiles"] == 1
        assert cf.stats()["calls"] == cfg.n_layers * (2 if remat else 1)


def test_train_step_matches_jax():
    cfg, jcfg, model, jparams = _pair("gpt-paper")
    batch, jbatch = _batches(cfg, jcfg, 2, 32, seed=4)
    jstep = jax.jit(jmake_train_step(jcfg, jwarmup(1e-3, 2, 10)))
    jnew, jopt, jmet = jstep(jparams, jadamw_init(jparams, moment_dtype="float32"), jbatch)
    _, pgrads = _port_grads(cfg, model, batch, remat=True)   # the gradients the step takes
    step = make_train_step(cfg, linear_warmup_cosine(1e-3, 2, 10))
    model.requires_grad_()
    opt = adamw_init(dict(model.named_parameters()), moment_dtype="float32")
    model, opt, met = step(model, opt, batch)
    assert opt.step == int(jopt.step) == 1
    for k in ("loss", "ce", "aux", "lr"):
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-6, k
    assert all(p.grad is None for p in model.parameters())
    # Adam's first step moves each weight by lr * g / (|g| + eps) (+ decay):
    # where |g| is near eps, the gradients' own 1e-4 differences decide the
    # step; so the weights whose gradient is at least 1e-3 of its leaf's
    # largest agree to 1e-6; a smaller gradient of the same sign as the
    # reference's moves its weight within lr times its relative error of the
    # reference's (so a flipped update fails); and every weight stays within
    # that step's bound, 2 lr, of the reference
    jgrads = _jflat(jax.grad(lambda p: jloss_fn(jcfg, p, jbatch)[0])(jparams))
    lr = float(jmet["lr"])
    got, want, old = _tflat(dict(model.named_parameters())), _jflat(jnew), _jflat(jparams)
    for k, w in want.items():
        g = np.abs(jgrads[k])
        big = g >= 1e-3 * g.max()
        assert big.mean() > 0.5, k
        err = np.abs(got[k] - w)
        tight = 1e-6 * np.abs(w).max() + 1e-6
        assert err[big].max() <= tight, (k, err[big].max())
        same = ~big & (g > 0) & (np.sign(pgrads[k]) == np.sign(jgrads[k]))
        rel = np.abs(pgrads[k] - jgrads[k])[same] / g[same]
        assert (err[same] <= tight + lr * rel).all(), (k, (err[same] - lr * rel).max())
        assert err.max() <= 2 * lr, (k, err.max())
        assert np.abs(w - old[k]).max() > 0.5 * lr       # the step moved the leaf
    _close_per_leaf(_tflat(opt.mu), _jflat(jopt.mu), GRAD_RTOL)
    _close_per_leaf(_tflat(opt.nu), _jflat(jopt.nu), 2 * GRAD_RTOL)


def test_run_train_history_matches_jax():
    cfg, jcfg, model, jparams = _pair("gpt-paper")
    kw = dict(steps=6, log_every=1, base_lr=1e-3, warmup=2, log_fn=lambda s: None)
    _, _, jhist = jrun_train(jcfg, jparams, iter(jmake_batch(jcfg, 2, 32, seed=s)
                                                 for s in range(6)), **kw)
    lines = []
    _, opt, hist = run_train(cfg, model, synthetic_stream(cfg, 2, 32, device="cpu"),
                             **dict(kw, log_fn=lines.append))
    assert [h["step"] for h in hist] == list(range(6)) and opt.step == 6
    assert len(lines) == 6 and lines[0].startswith("step     0 loss=")
    for h, jh in zip(hist, jhist):
        assert sorted(h) == sorted(jh)
        for k in jh:
            assert abs(h[k] - jh[k]) <= 1e-4, (h["step"], k, h[k], jh[k])


def test_training_loss_decreases():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    data = synthetic_stream(cfg, 4, 64, seed=0, device="cpu")
    params, _, hist = run_train(cfg, params, data, steps=30, log_every=29,
                                base_lr=1e-3, log_fn=lambda s: None)
    assert [h["step"] for h in hist] == [0, 29]
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_run_train_refuses_scan_families(arch):
    cfg = get_config(arch).reduced().with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    data = synthetic_stream(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match=r"A12\(b\): gradients of the scan ops"):
        run_train(cfg, params, data, steps=1, log_fn=lambda s: None)
    with pytest.raises(NotImplementedError, match=r"A12\(b\)"):
        make_train_step(cfg, linear_warmup_cosine(1e-3, 1, 2))
    assert not any(p.requires_grad for p in params.parameters())
