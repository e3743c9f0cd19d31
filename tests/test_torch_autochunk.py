"""The port's AutoChunk compiler on gpt-paper against the JAX package's.

gpt-paper ``reduced()`` in float32 with 2 layers (list form), weights from
the JAX ``init_params`` carried over by ``repro_torch.interop``, one
sequence of 512 tokens (at 256 the output logits alone outweigh a 0.2
budget, for the JAX compiler as for the port).  At budgets 0.2 and 0.5 the
port's chunked forward equals its unchunked forward (1e-5) and both equal
the JAX ``build_autochunk`` output and ``forward`` (1e-4); the predicted
final peak fits the budget, and a tighter budget never gives a larger one.
Peaks and stage counts of both compilers are printed side by side
(``pytest -s``); they are not required to agree, since aten and jaxpr
granularity differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import build_autochunk as jax_build_autochunk
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, autochunk, stats
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import chunked_attention as CA

torch.set_num_threads(2)

S = 512
BUDGETS = (0.2, 0.5)


@pytest.fixture(scope="module")
def pair():
    kw = dict(dtype="float32", n_layers=2, scan_layers=False)
    cfg = get_config("gpt-paper").reduced().with_(**kw)
    jcfg = jax_config("gpt-paper").reduced().with_(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, S))

    def fwd(params, batch):
        return torch.func.functional_call(model, params, (batch["tokens"],))[0]

    def jfwd(params, batch):
        return JM.forward(jcfg, params, batch)[0]

    port = (fwd, dict(model.named_parameters()), {"tokens": torch.tensor(tokens)})
    jax_side = (jfwd, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    return port, jax_side


@pytest.fixture(scope="module")
def jax_results(pair):
    _, (jfwd, jparams, jbatch) = pair
    ref = np.asarray(jfwd(jparams, jbatch))
    return ref, {b: jax_build_autochunk(jfwd, (jparams, jbatch), budget_ratio=b)
                 for b in BUDGETS}


@pytest.fixture(scope="module")
def port_results(pair):
    (fwd, params, batch), _ = pair
    out = {}
    for b in BUDGETS:
        cf = autochunk(fwd, ChunkConfig(budget_ratio=b, kernel_dispatch="off"), bucketer=None)
        out[b] = cf.compile(params, batch)
    return out


@pytest.mark.parametrize("budget", BUDGETS)
def test_chunked_forward_matches_unchunked_and_jax(pair, jax_results, port_results, budget):
    (fwd, params, batch), (jfwd, jparams, jbatch) = pair
    jref, jres = jax_results
    compiled = port_results[budget]
    unchunked = fwd(params, batch).numpy()
    got = compiled(params, batch).numpy()
    np.testing.assert_allclose(got, unchunked, atol=1e-5, rtol=0)
    np.testing.assert_allclose(unchunked, jref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jres[budget].fn(jparams, jbatch)),
                               atol=1e-4, rtol=0)
    r, jr = compiled.result, jres[budget]
    assert r.plan, "the compiler applied no stage"
    assert r.final_peak <= r.budget_bytes
    print(f"\n[autochunk] gpt-paper reduced f32 L=2 S={S} budget {budget}:"
          f" port baseline {r.baseline_peak} B final {r.final_peak} B stages {len(r.plan)}"
          f" | jax baseline {jr.baseline_peak} B final {jr.final_peak} B stages {len(jr.plan)}")


def test_tighter_budget_never_gives_a_larger_peak(port_results):
    finals = [port_results[b].result.final_peak for b in sorted(BUDGETS)]
    assert finals == sorted(finals)


def test_dispatched_forward_matches_and_calls_the_kernel(pair, monkeypatch):
    """``kernel_dispatch='on'`` on the CPU: every attention site goes through
    ``computed_attention`` (its plain version on CPU tensors) and the output
    is unchanged."""
    (fwd, params, batch), _ = pair
    calls = []
    kernel = CA.computed_attention
    monkeypatch.setattr(CA, "computed_attention",
                        lambda *a, **k: calls.append(a[0].shape) or kernel(*a, **k))
    before = stats.snapshot()
    cf = autochunk(fwd, ChunkConfig(budget_ratio=0.2, kernel_dispatch="on"), bucketer=None)
    compiled = cf.compile(params, batch)
    d = stats.delta(before)
    assert d["kernel_dispatch_hits"] == d["kernel_dispatch_computed_mask"] == 2
    got = compiled(params, batch).numpy()
    np.testing.assert_allclose(got, fwd(params, batch).numpy(), atol=1e-5, rtol=0)
    n_chunks = sum(r.n_chunks for r in compiled.result.plan
                   if r.chunk_extent == S and r.n_loop_eqns > 8)
    assert len(calls) == n_chunks > 0
    assert compiled.result.final_peak <= compiled.result.budget_bytes
