"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

The same operations go through both packages: the metrics registries'
Prometheus text must be byte-equal and their snapshots equal; both
tracers, on a ``ManualClock``, must record the same span trees and the
same Chrome events but for ``pid`` and ``tid``; both ``trace_export``
tools must print the same summary lines; the port's graph watermark must
equal the JAX jaxpr watermark on the chain, fan-out and
widest-intermediate cases.  Both engines, serving reduced gpt-paper in
float32 with the JAX package's weights, must record the JAX engines'
span names and histogram counts, and their ``metrics()`` keys (less
``mesh``); with the prefix cache and a spill arena, one ``serve.spill`` /
``serve.restore`` span per page and the JAX engine's hit-ratio gauge.  The
serving CLI's ``--metrics-out`` / ``--trace-out`` / ``--prom-out`` files
carry the JAX CLI's keys.  Each case starts from reset registries and
cleared, enabled tracers in both packages.
"""
import contextlib
import io
import json
import math
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.obs import accuracy as JA
from repro.obs import metrics as JMet
from repro.obs import tracing as JT
from repro.obs.clock import ManualClock as JManualClock
from repro.serving import PagedServeEngine as JPaged
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServe
from repro.tools import trace_export as JX
from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, autochunk, stats
from repro_torch.core import graph as G
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.obs import accuracy as A
from repro_torch.obs import metrics as Met
from repro_torch.obs import tracing as T
from repro_torch.obs.clock import ManualClock
from repro_torch.serving import PagedServeEngine, Request, ServeEngine
from repro_torch.tools import trace_export as X

torch.set_num_threads(2)

SERVE_HISTOGRAMS = ("serve_ttft_seconds", "serve_queue_wait_seconds",
                    "serve_step_latency_seconds", "serve_decode_tok_per_s")


@pytest.fixture(autouse=True)
def fresh_obs():
    for reg in (Met.REGISTRY, JMet.REGISTRY):
        reg.reset()
    for tr in (T.TRACER, JT.TRACER):
        tr.enabled = True
        tr.clear()
    yield
    for tr in (T.TRACER, JT.TRACER):        # --no-obs turns a tracer off
        tr.enabled = True


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    reg.counter("a_total", help="requests served").inc(3)
    reg.counter("b_total").inc()
    reg.gauge("g_pages", "pages").set(2.5)
    reg.gauge("g_ratio").set(1 / 3)
    h = reg.histogram("h_lat", buckets=(0.5, 1.0), help="step latency")
    for v in (0.25, 0.5, 5.0, 0.1 + 0.2):
        h.observe(v)
    d = reg.histogram("h_default", help="default latency edges")
    for v in (0.0005, 0.0004, 0.003, 11.0, 0.25, 10.0):
        d.observe(v)
    t = reg.histogram("h_tps", mod.THROUGHPUT_BUCKETS)
    for v in (1.0, 7.5, 1e5):
        t.observe(v)
    return reg


def test_registry_exposition_is_byte_equal_to_jax():
    ours, theirs = _registry_ops(Met), _registry_ops(JMet)
    assert (Met.LATENCY_BUCKETS_S, Met.THROUGHPUT_BUCKETS) == \
        (JMet.LATENCY_BUCKETS_S, JMet.THROUGHPUT_BUCKETS)
    for step in ("ops", "counters_only", "all"):
        if step == "counters_only":
            ours.reset(counters_only=True)
            theirs.reset(counters_only=True)
        elif step == "all":
            ours.reset()
            theirs.reset()
        assert ours.to_prometheus() == theirs.to_prometheus(), step
        assert ours.snapshot() == theirs.snapshot(), step
        assert ours.to_json(extra_key="v") == theirs.to_json(extra_key="v"), step
        assert ours.counter_values() == theirs.counter_values(), step


def test_histogram_le_edges_and_validation():
    reg = Met.MetricsRegistry()
    h = reg.histogram("h", buckets=(1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 5.0, 7.0):
        h.observe(v)
    # the first bucket with v <= le: 1.0 in le=1, 5.0 in le=5, 7.0 in +Inf
    assert h.bucket_counts() == [2, 1, 1, 1]
    assert h.cumulative() == [(1.0, 2), (2.0, 3), (5.0, 4), (float("inf"), 5)]
    assert (h.count, h.sum) == (5, 15.0)
    for bad in ((1.0, 1.0, 2.0), (2.0, 1.0), ()):
        with pytest.raises(ValueError, match="strictly"):
            reg.histogram(f"bad{len(bad)}", buckets=bad)
    assert reg.histogram("ok", buckets=Met.LATENCY_BUCKETS_S) is not None


def test_registry_type_mismatch_and_counters_only_reset():
    reg = Met.MetricsRegistry()
    c = reg.counter("x_total")
    assert reg.counter("x_total") is c and reg.get("x_total") is c
    assert reg.get("never_registered") is None
    with pytest.raises(TypeError, match="already registered as Counter"):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    c.inc(3)
    reg.gauge("g").set(7.0)
    reg.histogram("h", buckets=(1.0,)).observe(0.5)
    reg.reset(counters_only=True)
    assert (c.value, reg.gauge("g").value, reg.histogram("h", buckets=(1.0,)).count) == (0, 7.0, 1)
    reg.reset()
    assert (reg.gauge("g").value, reg.histogram("h", buckets=(1.0,)).count) == (0.0, 0)


@pytest.mark.parametrize("v,want", [(0.0005, "0.0005"), (float("inf"), "+Inf"), (3.0, "3"),
                                    (0.0, "0"), (1e21, "1000000000000000000000"),
                                    (0.1 + 0.2, "0.30000000000000004")])
def test_fmt_matches_jax(v, want):
    assert Met._fmt(v) == JMet._fmt(v) == want


# ---------------------------------------------------------------------------
# core.stats, the shim over the registry
# ---------------------------------------------------------------------------

# the port's counter names before the registry (every one stays registered)
OLD_COUNTERS = (
    "trace_calls", "estimate_calls", "search_calls", "rank_calls", "search_passes",
    "selection_passes", "codegen_calls", "lowering_rewrites", "lowering_emits",
    "kernel_dispatch_hits", "kernel_dispatch_misses", "kernel_dispatch_computed_mask",
    "plan_cache_hits", "plan_cache_misses", "plan_evictions", "plan_replays",
    "plan_replay_failures", "plan_bucket_hits", "plan_bucket_misses", "plan_bucket_rejects",
    "bucket_exec_hits", "bucket_exec_misses", "bucket_exec_compiles", "padded_calls",
    "pages_allocated", "pages_freed", "mixed_steps", "prefill_chunks", "admission_refusals",
    "prefix_hits", "prefix_tokens_reused", "cow_copies", "pages_spilled", "pages_restored",
)


def test_stats_shim_keeps_the_dict_api():
    assert stats.COUNTERS == OLD_COUNTERS
    before = stats.snapshot()
    assert type(before) is dict and set(OLD_COUNTERS) <= set(before)
    assert all(type(v) is int for v in before.values())
    stats.bump("obs_shim_test_counter")
    stats.bump("obs_shim_test_counter", 4)
    d = stats.delta(before)
    assert d["obs_shim_test_counter"] == 5 and d["trace_calls"] == 0
    assert type(d) is dict and set(d) == set(before) | {"obs_shim_test_counter"}
    c = Met.default_registry().get("obs_shim_test_counter")
    assert isinstance(c, Met.Counter) and c.value == stats.snapshot()["obs_shim_test_counter"]
    Met.default_registry().gauge("obs_shim_gauge").set(2.0)
    assert stats.reset() is None
    assert set(stats.snapshot().values()) == {0}
    assert Met.default_registry().gauge("obs_shim_gauge").value == 2.0   # counters only
    assert stats.delta(stats.snapshot()) == dict.fromkeys(stats.snapshot(), 0)


def test_stats_bump_is_thread_safe():
    n_threads, n_incs, name = 8, 10_000, "obs_thread_test_counter"
    base = stats.snapshot().get(name, 0)
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait()
        for _ in range(n_incs):
            stats.bump(name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert stats.snapshot()[name] - base == n_threads * n_incs


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _traced_program(tracing, clock_cls):
    clk = clock_cls(100.0)
    tr = tracing.Tracer(clock=clk)          # origin pinned at 100.0
    with tr.span("serve.step"):
        clk.advance(0.002)
        with tr.span("serve.admit"):
            clk.advance(0.0005)
        tr.instant("mark", eqns=3)
        with tr.span("serve.decode_wave", rows=4):
            clk.advance(0.001)
            with tr.span("compile.trace", leaves=2):
                clk.advance(0.25)
    with tr.span("compile.search", budget_bytes=7):
        clk.advance(1.5)
        tr.instant("compile.select", stage=0)
    return tr


def _chrome_less_ids(tr):
    return [{k: v for k, v in e.items() if k not in ("pid", "tid")}
            for e in tr.to_chrome()["traceEvents"]]


def test_tracer_span_tree_and_chrome_events_equal_jax(tmp_path):
    ours, theirs = _traced_program(T, ManualClock), _traced_program(JT, JManualClock)

    def tree(tr):
        return [(s.name, s.start, s.end, s.depth, s.parent, s.args, s.duration)
                for s in tr.spans()]

    assert tree(ours) == tree(theirs)
    assert [s.name for s in ours.spans()] == ["serve.step", "serve.admit", "mark",
                                              "serve.decode_wave", "compile.trace",
                                              "compile.search", "compile.select"]
    assert [s.depth for s in ours.spans()] == [0, 1, 1, 1, 2, 0, 1]
    assert _chrome_less_ids(ours) == _chrome_less_ids(theirs)
    doc = ours.to_chrome()
    assert doc["displayTimeUnit"] == "ms" and doc["traceEvents"][0]["ph"] == "M"
    assert ours.spans("serve.admit")[0].to_dict()["parent"] == "serve.step"
    path = tmp_path / "t.json"
    ours.export_chrome(str(path))
    assert json.loads(path.read_text())["traceEvents"] == doc["traceEvents"]
    ours.clear()
    assert ours.spans() == []


def test_disabled_tracer_and_traced_decorator():
    tr = T.Tracer(clock=ManualClock())
    tr.enabled = False
    with tr.span("x") as s:
        assert s is None
    tr.instant("y")
    assert tr.spans() == []

    @T.traced("unit.traced_fn")
    def fn(a, b):
        return a + b

    assert fn(2, 3) == 5 and len(T.TRACER.spans("unit.traced_fn")) == 1
    T.set_enabled(False)
    assert fn(2, 3) == 5 and len(T.TRACER.spans("unit.traced_fn")) == 1
    T.set_enabled(True)


# ---------------------------------------------------------------------------
# trace_export
# ---------------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_trace_export_summary_and_cli_equal_jax(tmp_path):
    path = tmp_path / "t.json"
    _traced_program(T, ManualClock).export_chrome(str(path))
    assert X.summarize(X.load_events(str(path))) == JX.summarize(JX.load_events(str(path)))
    rows = X.summarize(X.load_events(str(path)))
    assert rows[0]["name"] == "compile.search" and rows[0]["total_ms"] == pytest.approx(1500.0)
    outs = {}
    for tag, main in (("port", X.main), ("jax", JX.main)):
        merged = tmp_path / f"merged-{tag}.json"
        rc, text = _run(main, [str(path), str(path), "--summary", "-o", str(merged)])
        assert rc == 0
        outs[tag] = (text.replace(str(merged), "OUT"), json.loads(merged.read_text()))
    assert outs["port"] == outs["jax"]
    assert "[trace] 2 file(s), 14 spans" in outs["port"][0]
    bad = tmp_path / "bad.json"
    bad.write_text('{"notatrace": 1}')
    with pytest.raises(ValueError, match="not a Chrome trace"):
        X.load_events(str(bad))


# ---------------------------------------------------------------------------
# plan accuracy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,m", [(80, 100), (150, 100), (0, 0), (5, 0)])
def test_compare_formula_equals_jax(p, m):
    ours = A.compare(p, m, "interpret", cache_key="k", chunk=16)
    theirs = JA.compare(p, m, "interpret", cache_key="k", chunk=16)
    assert ours.to_dict() == theirs.to_dict() and ours.status_line() == theirs.status_line()
    assert math.isinf(ours.error_pct) == (m == 0 and p > 0)


def test_publish_mirrors_into_gauges_as_jax():
    regs = (Met.MetricsRegistry(), JMet.MetricsRegistry())
    for p, m in ((50, 100), (5, 0)):
        A.publish(A.compare(p, m, "interpret"), registry=regs[0])
        JA.publish(JA.compare(p, m, "interpret"), registry=regs[1])
        assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert regs[0].gauge("plan_error_pct").value == -1.0
    assert regs[0].counter("plan_accuracy_reports").value == 2


def _fanout(x):
    y = x * 2.0
    return torch.exp(y) + torch.tanh(y) + y


def _jfanout(x):
    y = x * 2.0
    return jnp.exp(y) + jnp.tanh(y) + y


WATERMARK_CASES = {
    # name: (port fn, JAX fn, input shape, bytes the watermark must reach)
    "chain": (lambda x: (x * 2.0) + 1.0, lambda x: (x * 2.0) + 1.0, (8,), 2 * 32),
    "fanout": (_fanout, _jfanout, (256,), 3 * 1024),
    "widest_intermediate": (lambda x: torch.einsum("i,j->ij", x, x).sum(0),
                            lambda x: jnp.sum(jnp.einsum("i,j->ij", x, x), axis=0),
                            (256,), 256 * 256 * 4),
}


@pytest.mark.parametrize("name", list(WATERMARK_CASES))
def test_watermark_equals_jax(name):
    fn, jfn, shape, least = WATERMARK_CASES[name]
    g, _ = G.trace(fn, [torch.empty(shape, device="meta")], weight_argnums=())
    closed = jax.make_jaxpr(jfn)(jnp.zeros(shape, jnp.float32))
    ours = A.watermark_graph(g)
    assert ours == JA.watermark_jaxpr(closed) >= least
    nbytes = 4 * math.prod(shape)
    assert A.watermark_graph(g, exclude_nbytes=(nbytes,)) == \
        JA.watermark_jaxpr(closed, exclude_nbytes=(nbytes,))
    if name == "chain":
        assert A.watermark_graph(g, exclude_nbytes=(nbytes,)) == 0


def test_compiled_forward_accuracy_and_cpu_device_measurement():
    kw = dict(dtype="float32", n_layers=2, scan_layers=False)
    cfg = get_config("gpt-paper").reduced().with_(**kw)
    from repro_torch.models import model as M

    model = M.init_params(cfg, 0, device="meta")

    def fwd(params, batch):
        return torch.func.functional_call(model, params, (batch["tokens"],))[0]

    params = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in model.named_parameters()}
    batch = {"tokens": torch.empty((1, 512), dtype=torch.int64, device="meta")}
    planned = autochunk(fwd, ChunkConfig(budget_ratio=0.5), bucketer=None).trace(
        params, batch).search()
    assert planned.plan.stages, "budget 0.5 at S 512 must chunk"
    reports = Met.default_registry().counter("plan_accuracy_reports").value
    result = planned.compile().result
    acc = result.accuracy
    assert acc.source == "interpret" and acc.cache_key == planned.plan.cache_key
    assert acc.predicted_bytes == planned.plan.stages[-1].peak_after
    assert acc.measured_bytes == A.watermark_graph(planned.graph) > 0
    assert math.isfinite(acc.error_pct) and acc.error_pct < 50.0
    assert Met.default_registry().counter("plan_accuracy_reports").value == reports + 1
    assert Met.default_registry().gauge("plan_predicted_bytes").value == acc.predicted_bytes
    names = {s.name for s in T.TRACER.spans()}
    assert {"compile.trace", "compile.estimate", "compile.search", "compile.select",
            "compile.emit", "lower.apply_chunk"} <= names
    # the CPU has no allocator peak: the record comes back unchanged
    cpu = torch.device("cpu")
    for dev in (cpu, "meta", None):
        assert A.device_bytes_in_use(dev) is None and A.device_peak_bytes(dev) is None
        assert A.reset_device_peak(dev) is False
    assert A.with_device_measurement(acc, A.device_bytes_in_use(cpu),
                                     A.device_peak_bytes(cpu)) is acc
    assert A.with_device_measurement(acc, None, 10**9) is acc
    upgraded = A.with_device_measurement(acc, 100, 100 + acc.measured_bytes)
    assert upgraded.source == "device" and upgraded.error_pct == acc.error_pct
    assert upgraded.extra["interpret_measured_bytes"] == acc.measured_bytes


# ---------------------------------------------------------------------------
# the engines against the JAX engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    jcfg = jax_config("gpt-paper").reduced().with_(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


PROMPTS = [[1, 2, 3, 4, 5], list(range(1, 20)), [7] * 11]


def _serve(engine, request_cls, batches, max_new=4):
    rid = 0
    for batch in batches:
        for prompt in batch:
            engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
            rid += 1
        engine.run()
    return [r.generated for r in sorted(engine.finished, key=lambda r: r.rid)]


def _recorded(metrics_mod, tracing_mod):
    hists = metrics_mod.default_registry().snapshot()["histograms"]
    counts = {n: hists[n]["count"] for n in SERVE_HISTOGRAMS if n in hists}
    return counts, {s.name for s in tracing_mod.TRACER.spans()}


def _both_engines(ours_fn, theirs_fn, batches):
    """Serve ``batches`` on the port engine with obs off, then on, then on
    the JAX engine; returns (tokens off, on, JAX, port engine, JAX engine,
    port histogram counts and span names, JAX's)."""
    T.TRACER.clear()
    off = ours_fn(obs=False)
    tokens_off = _serve(off, Request, batches)
    counts_off, names_off = _recorded(Met, T)
    assert set(counts_off.values()) <= {0}
    assert not any(n.startswith("serve.") and n not in ("serve.spill", "serve.restore")
                   for n in names_off)
    T.TRACER.clear()
    ours = ours_fn(obs=True)
    tokens = _serve(ours, Request, batches)
    theirs = theirs_fn()
    jax_tokens = _serve(theirs, JRequest, batches)
    return (tokens_off, tokens, jax_tokens, ours, theirs, _recorded(Met, T),
            _recorded(JMet, JT))


@pytest.mark.parametrize("budget", [None, 0.5])
def test_slot_engine_records_the_jax_engines_telemetry(models, budget):
    cfg, params, jcfg, jparams = models
    kw = dict(max_batch=2, max_len=64, autochunk_budget=budget)
    off, on, jax_tokens, ours, theirs, (counts, names), (jcounts, jnames) = _both_engines(
        lambda obs: ServeEngine(cfg, params, device="cpu", obs=obs, **kw),
        lambda: JServe(jcfg, jparams, obs=True, **kw), [PROMPTS])
    assert off == on == jax_tokens
    assert counts == jcounts
    assert counts["serve_ttft_seconds"] == counts["serve_queue_wait_seconds"] == len(PROMPTS)
    assert counts["serve_step_latency_seconds"] == ours.n_decode_steps
    assert {"serve.step", "serve.admit", "serve.prefill_chunk", "serve.decode_wave"} <= names
    if budget is None:
        assert names == jnames and ours.plan_accuracy() is None
        assert set(ours.metrics()) == set(theirs.metrics()) - {"mesh"}
        return
    # the JAX search finds no stage for its vmapped wave, the port's chunks
    # it: the port's compile adds the passes of a plan with stages
    assert len(theirs.autochunk_result.plan) == 0 < len(ours.autochunk_result.plan)
    assert jnames <= names and names - jnames == {"compile.emit", "lower.apply_chunk"}
    assert {"serve.compile", "compile.trace", "compile.search"} <= jnames
    assert len(T.TRACER.spans("serve.decode_wave")) == ours.n_decode_steps
    assert set(ours.metrics()) == set(theirs.metrics()) - {"mesh"}
    acc = ours.plan_accuracy()
    assert acc.source == "interpret" and ours.metrics()["plan_accuracy"] == acc.to_dict()
    key = ours.autochunk_result.cache_key
    assert ours.plan_cache.entry_meta(key)["accuracy"] == acc.to_dict()
    assert Met.default_registry().gauge("serve_cache_hit_ratio").value == \
        JMet.default_registry().gauge("serve_cache_hit_ratio").value


def test_paged_engine_records_the_jax_engines_telemetry(models):
    cfg, params, jcfg, jparams = models
    # at budget 0.6 both planners pick a chunk of 32 (at 0.5 the port's
    # estimator, within 2x of the JAX one's, picks 16 where JAX picks 32)
    kw = dict(max_seqs=3, max_len=64, page_size=8, autochunk_budget=0.6)
    off, on, jax_tokens, ours, theirs, (counts, names), (jcounts, jnames) = _both_engines(
        lambda obs: PagedServeEngine(cfg, params, device="cpu", obs=obs, **kw),
        lambda: JPaged(jcfg, jparams, obs=True, **kw), [PROMPTS])
    assert ours.prefill_chunk == theirs.prefill_chunk
    assert off == on == jax_tokens
    assert counts == jcounts
    assert counts["serve_ttft_seconds"] == counts["serve_queue_wait_seconds"] == len(PROMPTS)
    assert counts["serve_step_latency_seconds"] == ours.sched_stats["steps"]
    assert names == jnames - {"serve.step_compile"}
    assert {"serve.step", "serve.admit", "serve.prefill_chunk", "serve.decode_wave",
            "compile.plan_prefill", "compile.estimate"} <= names
    assert len(T.TRACER.spans("serve.step")) == ours.sched_stats["steps"]
    assert set(ours.metrics()) == set(theirs.metrics()) - {"mesh"}
    acc, jacc = ours.plan_accuracy(), theirs.plan_accuracy()
    assert acc.source == jacc.source == "interpret"
    assert set(acc.to_dict()) == set(jacc.to_dict())
    for k in ("chunk", "kv_exec_len"):        # budget bytes follow each estimator
        assert acc.extra[k] == jacc.extra[k]
    assert acc.predicted_bytes == acc.measured_bytes > 0
    gauges = Met.default_registry().snapshot()["gauges"]
    assert gauges["serve_pages_in_use"] == JMet.default_registry().gauge(
        "serve_pages_in_use").value == 0


def test_paged_prefix_cache_spill_spans_and_hit_ratio(models):
    """The spill scenario of tests/test_torch_prefix_cache.py: one
    ``serve.spill`` / ``serve.restore`` span per page, the prefix-cache hit
    ratio equal to the JAX engine's."""
    cfg, params, jcfg, jparams = models
    shared, unique = list(range(1, 21)), [2] * 20
    kw = dict(max_seqs=2, max_len=32, page_size=8, num_pages=5, prefix_cache=True,
              spill_pages=4, prefill_chunk=8)
    ours = PagedServeEngine(cfg, params, device="cpu", **kw)
    theirs = JPaged(jcfg, jparams, obs=True, **kw)
    before = stats.snapshot()
    for i, (prompt, cache) in enumerate([(shared, True), (shared, True), (unique, False),
                                         (shared, True)]):
        ours.submit(Request(rid=i, prompt=prompt, max_new_tokens=4, cache_prefix=cache))
        ours.run()
        theirs.submit(JRequest(rid=i, prompt=prompt, max_new_tokens=4, cache_prefix=cache))
        theirs.run()
    d = stats.delta(before)
    assert d["pages_spilled"] == len(T.TRACER.spans("serve.spill")) > 0
    assert d["pages_restored"] == len(T.TRACER.spans("serve.restore")) > 0
    assert len(T.TRACER.spans("serve.spill")) == len(JT.TRACER.spans("serve.spill"))
    assert len(T.TRACER.spans("serve.restore")) == len(JT.TRACER.spans("serve.restore"))
    ratio = Met.default_registry().gauge("serve_cache_hit_ratio").value
    assert ratio == JMet.default_registry().gauge("serve_cache_hit_ratio").value == 0.5
    assert _recorded(Met, T)[0] == _recorded(JMet, JT)[0]


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

CLI = {"slot": ["--arch", "gpt-paper", "--local", "--requests", "3", "--prompt-len", "8",
                "--max-new", "3", "--max-len", "32", "--max-batch", "2", "--autochunk", "0.5"],
       "paged": ["--arch", "gpt-paper", "--local", "--paged", "--prefix-cache",
                 "--shared-prefix", "8", "--requests", "3", "--prompt-len", "12",
                 "--max-new", "2", "--max-len", "32", "--page-size", "8"]}


def _cli_files(main, argv, tmp_path, tag):
    files = {flag: tmp_path / f"{tag}{flag}" for flag in ("--metrics-out", "--trace-out",
                                                           "--prom-out")}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv + [a for flag, p in files.items() for a in (flag, str(p))])
    return out.getvalue(), files


@pytest.mark.parametrize("path", list(CLI))
def test_cli_writes_the_jax_clis_artifacts(path, tmp_path):
    text, files = _cli_files(serve.main, CLI[path] + ["--device", "cpu"], tmp_path, "port")
    assert all(p.exists() for p in files.values())
    assert "[serve] plan_accuracy: predicted_bytes=" in text and "source=interpret" in text
    doc = json.loads(files["--metrics-out"].read_text())
    _, jfiles = _cli_files(jax_serve.main, CLI[path], tmp_path, "jax")
    jdoc = json.loads(jfiles["--metrics-out"].read_text())
    assert set(doc) == set(jdoc) == {"counters", "metrics", "plan_accuracy"}
    for kind in ("histograms", "gauges"):
        # the serving and plan instruments (earlier tests register others)
        mine = {n for n in doc["metrics"][kind] if n.startswith(("serve_", "plan_"))}
        assert mine == {n for n in jdoc["metrics"][kind]
                        if n.startswith(("serve_", "plan_"))}, kind
    assert doc["plan_accuracy"]["source"] == "interpret"
    assert doc["metrics"]["histograms"]["serve_ttft_seconds"]["count"] == 3
    names = {e["name"] for e in X.load_events(str(files["--trace-out"])) if e.get("ph") == "X"}
    assert {"serve.step", "serve.admit", "serve.decode_wave", "serve.prefill_chunk"} <= names
    prom = files["--prom-out"].read_text()
    assert "# TYPE serve_ttft_seconds histogram" in prom
    assert 'serve_ttft_seconds_bucket{le="+Inf"} 3' in prom


def test_cli_no_obs_writes_a_trace_without_spans(tmp_path):
    text, files = _cli_files(serve.main, CLI["paged"] + ["--device", "cpu", "--no-obs"],
                             tmp_path, "off")
    assert "[serve] chrome trace (0 spans)" in text
    assert not [e for e in X.load_events(str(files["--trace-out"])) if e.get("ph") == "X"]
    doc = json.loads(files["--metrics-out"].read_text())
    assert doc["metrics"]["histograms"]["serve_ttft_seconds"]["count"] == 0
