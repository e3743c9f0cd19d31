"""Port paged engine against the JAX ``PagedServeEngine``, token for token.

gpt-paper ``reduced()`` in float32 with the JAX package's weights carried
over by ``repro_torch.interop``; both engines pin the same prefill chunk and
decode greedily, so the generated tokens must be identical.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serving import PagedServeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import stats
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.obs.tracing import TRACER
from repro_torch.serving import PagedServeEngine, Request

torch.set_num_threads(2)

PROMPTS = [[1, 2, 3, 4, 5], list(range(1, 20)), [7] * 11]
ENGINE = dict(max_seqs=3, max_len=64, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    jcfg = jax_config("gpt-paper").reduced().with_(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


def _serve(engine, request_cls, prompts, *, together, max_new=5):
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
        if not together:
            engine.run()
    engine.run()
    assert all(r.done and len(r.generated) == max_new for r in reqs)
    return [r.generated for r in reqs]


def test_greedy_tokens_match_jax_isolated_and_staggered(models):
    cfg, params, jcfg, jparams = models
    ours = PagedServeEngine(cfg, params, device="cpu", **ENGINE)
    theirs = JaxEngine(jcfg, jparams, obs=False, **ENGINE)
    before = stats.snapshot()
    alone = _serve(ours, Request, PROMPTS, together=False)
    assert alone == _serve(theirs, JaxRequest, PROMPTS, together=False)
    # staggered lengths in one batch: short prompts decode while long ones
    # still prefill, so steps mix both kinds of rows
    ours.sched_stats.update(dict.fromkeys(ours.sched_stats, 0))
    theirs.sched_stats.update(dict.fromkeys(theirs.sched_stats, 0))
    together = _serve(ours, Request, PROMPTS, together=True)
    assert together == _serve(theirs, JaxRequest, PROMPTS, together=True) == alone
    assert ours.sched_stats == {k: theirs.sched_stats[k] for k in ours.sched_stats}
    assert ours.sched_stats["mixed_steps"] > 0
    d = stats.delta(before)
    assert d["mixed_steps"] == ours.sched_stats["mixed_steps"]
    assert d["pages_allocated"] == d["pages_freed"] > 0
    assert ours.pool.pages_in_use == 0
    m = ours.metrics()
    assert set(m) == set(theirs.metrics()) - {"mesh"}
    assert m["requests"] == 6 and m["tokens"] == 30


def test_phi3_head_dim_96_greedy_tokens_match_jax():
    """A reduced phi3-mini at head dim 96 (d_model 192, 2 heads), which the
    CUDA paged kernel has no instance for: the CPU engine serves it and
    its greedy tokens equal the JAX engine's.  Its window is max_len, as
    the full config's 8192 covers a served context (the reduced 32 would
    not be a paged config)."""
    shape = dict(d_model=192, n_heads=2, n_kv_heads=2, dtype="float32",
                 sliding_window=ENGINE["max_len"])
    cfg = get_config("phi3-mini-3.8b").reduced().with_(**shape)
    jcfg = jax_config("phi3-mini-3.8b").reduced().with_(**shape)
    assert cfg.hd == jcfg.hd == 96
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ours = PagedServeEngine(cfg, params, device="cpu", **ENGINE)
    theirs = JaxEngine(jcfg, jparams, obs=False, **ENGINE)
    got = _serve(ours, Request, PROMPTS, together=True)
    assert got == _serve(theirs, JaxRequest, PROMPTS, together=True)


def test_engine_for_the_card_refuses_a_head_dim_at_construction(monkeypatch):
    """Built for the card, the engine asks the paged kernel's
    ``cuda_refusal`` and raises before it allocates anything, naming the
    ROADMAP item, instead of failing at its first step."""
    from repro_torch.serving import engine as E

    monkeypatch.setattr(E, "resolve_device", lambda device: torch.device("cuda"))
    # hd 48 has no paged kernel instance; phi3-mini's hd 96 has one
    cfg = get_config("phi3-mini-3.8b").reduced().with_(
        d_model=96, n_heads=2, n_kv_heads=2, sliding_window=ENGINE["max_len"])
    assert cfg.hd == 48 and E.cuda_refusal(96) is None
    with pytest.raises(NotImplementedError, match="hd in .* got 48.*queue B2"):
        PagedServeEngine(cfg, None, **ENGINE)


def test_admission_is_bounded_by_pages(models):
    cfg, params, jcfg, jparams = models
    # 4 pages of 8 tokens: each request needs 3-4 pages, so one runs at a time
    kw = dict(ENGINE, num_pages=4)
    ours = PagedServeEngine(cfg, params, device="cpu", **kw)
    theirs = JaxEngine(jcfg, jparams, obs=False, **kw)
    got = _serve(ours, Request, PROMPTS, together=True)
    assert got == _serve(theirs, JaxRequest, PROMPTS, together=True)
    assert ours.sched_stats["admission_refusals"] == theirs.sched_stats["admission_refusals"] > 0
    assert ours.pool.peak_pages_in_use <= 4 and ours.pool.pages_in_use == 0
    with pytest.raises(ValueError, match="exceeds max_len"):
        ours.submit(Request(rid=9, prompt=[1] * 60, max_new_tokens=5))


def test_planned_chunk_sampling_and_options(models):
    cfg, params, _, _ = models
    auto = PagedServeEngine(cfg, params, device="cpu", max_seqs=2, max_len=64,
                            autochunk_budget=0.5)
    plan = auto.prefill_plan
    assert auto.prefill_chunk == plan.chunk <= 64 and plan.fits
    assert auto.metrics()["prefill_plan"]["peak_bytes"] == plan.peak_bytes
    # sampling draws from the engine's own generator: same seed, same tokens
    runs = []
    for _ in range(2):
        e = PagedServeEngine(cfg, params, device="cpu", greedy=False, seed=3, **ENGINE)
        runs.append(_serve(e, Request, PROMPTS[:2], together=True))
    assert runs[0] == runs[1]
    for kw in (dict(autotune=True), dict(mesh="data:1")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PagedServeEngine(cfg, params, device="cpu", **ENGINE, **kw)
    # obs (the default since the observability slice) records the serving
    # spans; tests/test_torch_obs.py holds them against the JAX engine's
    TRACER.clear()
    e = PagedServeEngine(cfg, params, device="cpu", obs=True, **ENGINE)
    _serve(e, Request, PROMPTS[:2], together=True)
    assert len(TRACER.spans("serve.step")) == e.sched_stats["steps"] > 0
    assert {"serve.admit", "serve.prefill_chunk", "serve.decode_wave"} <= {
        s.name for s in TRACER.spans()}


def test_engine_defaults_to_the_card(models):
    cfg, params, _, _ = models
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedServeEngine(cfg, params, **ENGINE)


def test_cli_local_cpu_paged():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        engine = serve.main(["--arch", "gpt-paper", "--local", "--device", "cpu", "--paged",
                             "--stagger", "--requests", "3", "--prompt-len", "8",
                             "--max-len", "64", "--max-new", "4", "--max-seqs", "3"])
    text = out.getvalue()
    assert "[serve] paged engine built" in text and "prefill_chunk=" in text
    assert "[serve] 3 requests" in text and "[serve] paged: mixed_steps=" in text
    assert engine.metrics()["tokens"] == 12
    # without --paged the CLI serves through the fixed-slot engine; a flag
    # for a module the port lacks exits naming its ROADMAP item
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "gpt-paper", "--local", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "8", "--max-len", "64", "--max-new", "4"])
    assert "[serve] 3 requests, 12 tokens" in out.getvalue()
    with pytest.raises(SystemExit, match="ROADMAP queue A item 11"):
        serve.main(["--arch", "gpt-paper", "--local", "--device", "cpu", "--mesh", "data=1"])
