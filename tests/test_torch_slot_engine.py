"""The port's fixed-slot ``ServeEngine`` against the JAX package's.

Greedy tokens equal the JAX engine's on gpt-paper ``reduced()`` in float32
and on phi3-mini ``reduced()`` with its sliding window (16) below
``max_len`` (64), whose prompts and decodes run past the window: served
alone, more requests than slots, interleaved slots against solo serving,
and with ``eos_id``.  Weights from the JAX ``init_params`` carried over by
``repro_torch.interop``.  The compiled decode wave's logits are held within
1e-4 of the plain wave's (as the JAX package's test holds its own), and the
plan cache, ``reconfigure``, canonical-bucket and eviction counters follow
the JAX package's tests of the same engine, leaving out the case where the
two packages count a failed exact-key replay differently (ROADMAP C-ref-3).
The serving CLI without ``--paged`` prints the JAX CLI's counters.
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core import stats
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M
from repro_torch.obs.tracing import TRACER
from repro_torch.serving import Request, ServeEngine

torch.set_num_threads(2)
ATOL = 1e-4          # the compiled wave against the plain one (chunked sums)
ARCHS = {"gpt": ("gpt-paper", {}), "phi3": ("phi3-mini-3.8b", {"sliding_window": 16})}


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    name, over = ARCHS[request.param]
    cfg = get_config(name).reduced().with_(dtype="float32", **over)
    jcfg = jax_config(name).reduced().with_(dtype="float32", **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                 device="cpu")


@pytest.fixture(scope="module")
def gpt():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


def _serve(engine_cls, request_cls, cfg, params, prompts, *, max_batch, max_new, eos=None,
           **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, max_len=64, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new, eos_id=eos)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


def _both(pair, prompts, **kw):
    cfg, jcfg, jparams, params = pair
    theirs = _serve(JServeEngine, JRequest, jcfg, jparams, prompts, **kw)
    ours = _serve(ServeEngine, Request, cfg, params, prompts, device="cpu", **kw)
    return ours, theirs


# prompts past phi3's window of 16 (prefill rolls the ring) and inside it
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4], [2, 7, 1],
           [9, 9, 9, 9, 8]]


def test_engine_alone_matches_jax(pair):
    ours, theirs = _both(pair, PROMPTS[:1], max_batch=2, max_new=24)
    assert ours == theirs


def test_engine_more_requests_than_slots_matches_jax(pair):
    ours, theirs = _both(pair, PROMPTS + [[7, 7], [1, 2, 3, 4]], max_batch=2, max_new=10)
    assert ours == theirs and all(len(g) == 10 for g in ours)


def test_engine_interleaved_slots_are_isolated(pair):
    """Three requests in three slots, each at its own position (one past the
    window, two inside it, crossing it while decoding): the same tokens as
    each served alone, and as the JAX engine's."""
    cfg, _, _, params = pair
    solo = [_serve(ServeEngine, Request, cfg, params, [p], max_batch=1, max_new=20,
                   device="cpu")[0] for p in PROMPTS]
    ours, theirs = _both(pair, PROMPTS, max_batch=3, max_new=20)
    assert ours == solo == theirs


def test_engine_eos_stops_early(pair):
    cfg, _, _, params = pair
    (probe,) = _serve(ServeEngine, Request, cfg, params, PROMPTS[1:2], max_batch=1,
                      max_new=8, device="cpu")
    eos = probe[2]
    ours, theirs = _both(pair, PROMPTS[1:2], max_batch=1, max_new=8, eos=eos)
    assert ours == theirs
    assert ours[0][-1] == eos and len(ours[0]) <= 3


def _first_wave(eng):
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=1))
    eng._admit()
    toks, pos = torch.tensor([5, 0]), torch.tensor([3, 0])
    return eng._decode_wave(eng.cache, toks, pos)


def test_compiled_wave_logits_match_the_plain_wave(gpt):
    """The compiled wave (budget 0.5) against the plain one from the same
    cache, tokens and positions, within 1e-4; it writes the same cache.
    Its plan has 4 stages where the JAX package's has none (see
    ``test_compiled_wave_stage_counts``)."""
    cfg, params = gpt
    e1 = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    e2 = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5, device="cpu")
    lg1, lg2 = _first_wave(e1), _first_wave(e2)
    np.testing.assert_allclose(lg1[0].numpy(), lg2[0].numpy(), atol=ATOL, rtol=0)
    for a, b in zip(jax.tree.leaves(e1.cache), jax.tree.leaves(e2.cache)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_compiled_wave_stage_counts(gpt):
    """gpt-paper reduced, 2 slots, max_len 64, budget 0.5: the JAX package's
    wave plan has 0 stages, the port's 4.  The port's wave is one batched
    step over an aten graph, where the products ``q @ K^T`` and ``p @ V``
    over the cache (permuted views) copy K and V repeated over the query
    group (2 here); at both layers the search chunks the K copy with its
    product over the 64 ring slots and the V copy with its product over the
    32 head-dim columns (4 stages, 0.13 -> 0.04 MiB).  The JAX wave is
    vmapped ``dot_general``s that copy nothing, so its search finds no
    stage.  Plans are compared per package, logits across them."""
    cfg, params = gpt
    jcfg = jax_config("gpt-paper").reduced().with_(dtype="float32")
    jeng = JServeEngine(jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0)), max_batch=2,
                        max_len=64, autochunk_budget=0.5)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5, device="cpu")
    assert len(jeng.autochunk_result.plan) == 0
    res = eng.autochunk_result
    assert len(res.plan) == 4 and res.final_peak <= res.budget_bytes
    assert all(r.chunk_extent in (32, 64) for r in res.plan)


def test_jax_wave_budget_lies_below_its_own_io_bytes(gpt):
    """Why the two packages' wave plans differ (ROADMAP C-6, a cost): at
    budget 0.5 the JAX wave's budget, 199,168 B, lies below its own input
    and output bytes, 266,256 B, so no chunking can reach it and its search
    takes no stage; the port's aten wave peaks at 134,272 B (it copies K and
    V) and its 4 stages bring that to 38,016 B, within its 67,136 B budget.
    The estimators also count the in-place cache differently."""
    cfg, params = gpt
    jcfg = jax_config("gpt-paper").reduced().with_(dtype="float32")
    jres = JServeEngine(jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0)), max_batch=2,
                        max_len=64, autochunk_budget=0.5).autochunk_result
    assert (jres.baseline_peak, jres.io_bytes, jres.budget_bytes, jres.final_peak) == (
        398_336, 266_256, 199_168, 398_336)
    res = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5,
                      device="cpu").autochunk_result
    assert (res.baseline_peak, res.budget_bytes, res.final_peak, len(res.plan)) == (
        134_272, 67_136, 38_016, 4)


def test_engine_plan_cache_and_reconfigure(gpt, tmp_path):
    """As the JAX package's test of the same name: the cache is warm after
    construction; a second engine on the same directory replays the plan
    with no search, the same logits bit for bit; a new bucket is cold, a
    seen one reused outright; reconfigure refuses while requests run."""
    cfg, params = gpt
    cache_dir = tmp_path / "plans"
    e1 = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5,
                     plan_cache=cache_dir, device="cpu")
    assert e1.plan_cache.stats()["entries"] == 1
    assert not e1.autochunk_result.from_cache
    before = stats.snapshot()
    e2 = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5,
                     plan_cache=cache_dir, device="cpu")
    d = stats.delta(before)
    assert e2.autochunk_result.from_cache
    assert d["search_calls"] == 0 and d["rank_calls"] == 0
    assert torch.equal(_first_wave(e1), _first_wave(e2))
    e1.run()
    e2.run()

    e2.reconfigure(max_len=96)
    assert e2.exec_len == 128
    assert len(e2.plan_cache) == 2
    before = stats.snapshot()
    e2.reconfigure(max_len=64)
    d = stats.delta(before)
    assert d["search_calls"] == 0 and d["trace_calls"] == 0
    assert d["bucket_exec_hits"] == 1 and d["bucket_exec_compiles"] == 0
    e2.submit(Request(rid=1, prompt=[1, 2, 3], max_new_tokens=2))
    assert e2.run()[-1].done
    e2.submit(Request(rid=2, prompt=[4], max_new_tokens=2))
    with pytest.raises(RuntimeError):
        e2.reconfigure(max_len=96)
    e2.run()


def test_engine_canonical_bucket_exec(gpt):
    """One wave serves the bucket: max_len 60 runs at the 64 boundary with
    the tokens of a max_len 64 engine; reconfiguring inside the bucket makes
    no trace, no search and no new wave."""
    cfg, params = gpt
    eng = ServeEngine(cfg, params, max_batch=2, max_len=60, autochunk_budget=0.5, device="cpu")
    assert eng.exec_len == 64
    want = _serve(ServeEngine, Request, cfg, params, [[3, 1, 4, 1, 5]], max_batch=2,
                  max_new=6, device="cpu")[0]
    r = Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=6)
    eng.submit(r)
    eng.run()
    assert r.generated == want
    wave = eng._decode_wave
    before = stats.snapshot()
    eng.reconfigure(max_len=50)
    d = stats.delta(before)
    assert d["trace_calls"] == 0 and d["search_passes"] == 0
    assert d["bucket_exec_hits"] == 1 and d["bucket_exec_compiles"] == 0
    assert eng.exec_stats["wave_reuses"] == 1 and eng._decode_wave is wave
    r2 = Request(rid=1, prompt=[3, 1, 4, 1, 5], max_new_tokens=6)
    eng.submit(r2)
    eng.run()
    assert r2.generated == want
    m = eng.metrics()
    assert m["exec_len"] == 64 and m["bucket_exec"]["wave_compiles"] == 1
    assert m["plan_telemetry"]["hits"] >= 1 and "64" in m["plan_telemetry"]["buckets"]


def test_engine_telemetry_driven_eviction(gpt, tmp_path):
    cfg, params = gpt
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5,
                      plan_cache=tmp_path / "plans", cache_max_entries=1, device="cpu")
    assert len(eng.plan_cache) == 1 and eng.exec_stats["evicted"] == 0
    eng.reconfigure(max_len=200)
    assert eng.exec_len == 256
    assert len(eng.plan_cache) == 1 and eng.exec_stats["evicted"] == 1
    assert eng.plan_cache.stats()["evictions"] == 1
    assert eng.plan_cache.get(eng.autochunk_result.cache_key) is not None


def test_admit_samples_first_token_when_not_greedy(gpt):
    """A sampling engine draws the first token from the prefill logits with
    its generator: the same draw as a generator of the same seed makes, the
    same token from an engine of the same seed; a greedy one takes argmax."""
    cfg, params = gpt
    prompt = [3, 1, 4, 1, 5]
    logits, _ = M.prefill(cfg, params, {"tokens": torch.tensor([prompt])}, 64)
    probs = torch.softmax(logits[0, -1:].float(), dim=-1)
    want = int(torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(7))[0, 0])
    firsts = []
    for _ in range(2):
        eng = ServeEngine(cfg, params, max_batch=1, max_len=64, greedy=False, seed=7,
                          device="cpu")
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
        eng._admit()
        firsts.append(eng.slot_req[0].generated[0])
    assert firsts == [want, want]
    eng = ServeEngine(cfg, params, max_batch=1, max_len=64, device="cpu")
    eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=1))
    eng._admit()
    assert eng.slot_req[0].generated[0] == int(torch.argmax(logits[0, -1]))


def test_engine_metrics(gpt):
    cfg, params = gpt
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[1, 2, 3 + i], max_new_tokens=4))
    eng.run()
    m = eng.metrics()
    assert set(m) == {"requests", "tokens", "decode_waves", "throughput_tok_s",
                      "mean_ttft_s", "mean_latency_s", "exec_len", "bucket_exec"}
    assert m["requests"] == 3 and m["tokens"] == 12 and m["decode_waves"] == 6
    assert m["throughput_tok_s"] > 0 and m["mean_ttft_s"] >= 0 and m["exec_len"] == 64


@pytest.mark.parametrize("engine", ["plain", "budget-0.5", "paged"])
def test_dropped_engine_frees_its_cache_without_a_collection(gpt, engine):
    """With the garbage collector off, a dropped engine and its cache die
    at once: the engine holds no bound method of itself (the plain wave
    is a function of the config and weights), so no reference cycle keeps
    its card memory until a collection.  The first trace of a process
    imports parts of torch whose import frames sit in a cycle with every
    frame below them, so one compile runs first, with the collector on."""
    import gc
    import weakref

    from repro_torch.serving import PagedServeEngine

    cfg, params = gpt
    ServeEngine(cfg, params, max_batch=2, max_len=32, autochunk_budget=0.5, device="cpu")
    gc.collect()
    gc.disable()
    try:
        if engine == "paged":
            eng = PagedServeEngine(cfg, params, max_seqs=2, max_len=32, page_size=8,
                                   device="cpu")
        else:
            budget = 0.5 if engine == "budget-0.5" else None
            eng = ServeEngine(cfg, params, max_batch=2, max_len=32, autochunk_budget=budget,
                              device="cpu")
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
        eng.run()
        leaf = eng.pool.pages if engine == "paged" else M._cache_leaves(eng.cache)[0][0]
        refs = weakref.ref(eng), weakref.ref(leaf)
        del eng, leaf
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


@pytest.mark.parametrize("kw,item", [
    ({"autotune": True}, "item 7"), ({"mesh": "data=1"}, "item 11"), ({"obs": True}, "item 9"),
    ({"arch": "deepseek-v3-671b"}, "item 10 (c)"), ({"arch": "qwen2-moe-a2.7b"}, "item 10 (c)"),
])
def test_engine_refusals_name_their_item(kw, item):
    """Each refusal names its ROADMAP item.  Both families of item 10 (c)
    are served now: qwen2-moe (MoE) and deepseek-v3 (MoE with MLA, its
    latent ring) build and serve (tests/test_torch_moe_decode.py and
    tests/test_torch_mla_decode.py hold their tokens against the JAX
    engine's).  Item 9 (observability) is in: ``obs=True`` builds an
    engine that serves and records a ``serve.step`` span a step
    (tests/test_torch_obs.py holds its telemetry against the JAX engine's)."""
    kw = dict(kw)
    cfg = get_config(kw.pop("arch", "gpt-paper")).reduced()
    if kw.get("obs"):
        TRACER.clear()
        cfg = cfg.with_(dtype="float32")
        eng = ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"), max_batch=1, max_len=16,
                          device="cpu", **kw)
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
        (req,) = eng.run()
        assert req.done and len(req.generated) == 3
        assert len(TRACER.spans("serve.step")) == eng.n_decode_steps == 2
        return
    if cfg.family == "moe":
        cfg = cfg.with_(dtype="float32")
        eng = ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"), max_batch=1, max_len=16,
                          device="cpu", **kw)
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
        (req,) = eng.run()
        assert req.done and len(req.generated) == 3 and "moe_layers" in eng.cache
        assert set(eng.cache["moe_layers"]) == ({"ckv", "kr"} if cfg.mla else {"k", "v"})
        return
    with pytest.raises(NotImplementedError, match=re.escape(f"ROADMAP queue A {item}")):
        ServeEngine(cfg, None, max_batch=1, max_len=16, device="cpu", **kw)


def test_engine_needs_a_card_by_default(gpt):
    cfg, params = gpt
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params, max_batch=1, max_len=16)


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_cli_without_paged_prints_the_jax_counters():
    """``serve.main`` without ``--paged`` serves through ``ServeEngine``; its
    requests line (counts and decode waves) and second-run line (a
    reconfigure inside the warm 64 bucket) read as the JAX CLI's."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--arch", "gpt-paper", "--local", "--autochunk", "0.5", "--max-len", "64",
            "--second-max-len", "50", "--requests", "4", "--max-new", "6"]
    ours = _cli(serve.main, argv + ["--device", "cpu"])
    theirs = _cli(jserve.main, argv)

    def lines(text):
        reqs = re.findall(r"\[serve\] (\d+) requests, (\d+) tokens .*, (\d+) decode waves\)",
                          text)
        second = re.search(r"\[serve\] second run: (.*)", text).group(1)
        return reqs, second

    assert lines(ours) == lines(theirs)
    assert lines(ours)[1] == "bucket_exec_hits=1 new_traces=0 new_searches=0 new_wave_compiles=0"
    assert "[serve] engine built" in ours and "plan cache: cold" in ours
    assert "[serve] codegen stats:" in ours


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_paged_engine_refuses_recurrent_states(arch):
    """The SSM and hybrid families keep the fixed-slot engine, as in the JAX
    package: the paged engine refuses them at construction."""
    from repro_torch.serving import PagedServeEngine

    cfg = get_config(arch).reduced().with_(dtype="float32", n_layers=3)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match=f"family={cfg.family!r}"):
        PagedServeEngine(cfg, params, max_seqs=2, max_len=64, device="cpu")
    assert ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu").cache


def test_paged_engine_sends_a_window_past_max_len_to_the_slot_engine():
    """The paged engine keeps the whole context, so it refuses a window
    below ``max_len`` and names the engine that serves it."""
    from repro_torch.serving import PagedServeEngine

    name, over = ARCHS["phi3"]
    cfg = get_config(name).reduced().with_(dtype="float32", **over)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="ServeEngine"):
        PagedServeEngine(cfg, params, max_seqs=2, max_len=64, device="cpu")
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    assert M.cache_width(cfg, eng.exec_len) == 16
