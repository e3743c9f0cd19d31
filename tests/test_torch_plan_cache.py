"""Port plan cache, fingerprints and persistence against the JAX package.

The counter invariants of ``tests/test_plan_cache.py`` and the cache cases
of ``tests/test_staged_api.py``: a warm hit replays with zero search and
selection passes and gives the cold compile's outputs bit for bit; a
corrupt, stale or foreign plan falls back to the search; the key changes
with shape, budget, hypers, knobs and kernel target and is stable across a
retrace.  The port's own cases: the key is the same in another process and
for a ``meta`` trace and a fake trace on the CPU, and a plan file of one
framework is a miss, never an error, for the other.  Outputs within 1e-5 of
the unchunked function and of the JAX package's.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PlanCache as JPlanCache
from repro.core import build_autochunk as jbuild_autochunk
from repro_torch.core import (
    ChunkConfig,
    ChunkPlan,
    PlanCache,
    apply_chunk,
    autochunk,
    build_autochunk,
    build_fn_from_plan,
    estimate_memory,
    plan_cache_key,
    search_chunks,
    stats,
    trace,
)
from repro_torch.core.plan import FRAMEWORK, PLAN_FORMAT_VERSION, PlanApplyError, PlanStage
from repro_torch.core.selection import CostHyper

torch.set_num_threads(2)
SRC = str(Path(__file__).resolve().parents[1] / "src")

BLOCK_SRC = '''
import math
import torch
import torch.nn.functional as F


def mini_block(w, x):
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    logits = q @ k.transpose(-1, -2) / math.sqrt(x.shape[-1])
    o = (torch.softmax(logits, dim=-1) @ v) @ w["wo"]
    h = x + o
    return h + F.gelu(h @ w["w1"]) @ w["w2"]


def meta_args(seq=64, d=32, f=64):
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, f),
              "w2": (f, d)}
    w = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    return w, torch.empty((1, seq, d), device="meta")
'''
_ns: dict = {}
exec(BLOCK_SRC, _ns)
_mini_block, _meta_args = _ns["mini_block"], _ns["meta_args"]


def _jax_block(w, x):
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    logits = jnp.einsum("bsd,btd->bst", q, k) / jnp.sqrt(x.shape[-1])
    o = jnp.einsum("bst,btd->bsd", jax.nn.softmax(logits, axis=-1), v) @ w["wo"]
    h = x + o
    return h + jax.nn.gelu(h @ w["w1"], approximate=False) @ w["w2"]


def _numpy_example(seq=64, d=32, f=64, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, f),
              "w2": (f, d)}
    w = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in shapes.items()}
    return w, rng.standard_normal((1, seq, d), dtype=np.float32)


def _example(seq=64):
    w, x = _numpy_example(seq)
    return {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x)


def _flat(w, x):
    leaves = list(w.values()) + [x]
    keys = list(w)

    def flat_fn(*ls):
        return (_mini_block(dict(zip(keys, ls[:-1])), ls[-1]),)

    return flat_fn, leaves


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

def test_plan_json_roundtrip_carries_the_framework_tag():
    w, x = _example()
    res = build_autochunk(_mini_block, (w, x), budget_ratio=0.3)
    assert res.plan, "expected at least one stage at this budget"
    plan = res.to_chunk_plan()
    doc = json.loads(plan.to_json())
    assert doc["framework"] == FRAMEWORK == "torch" and doc["version"] == PLAN_FORMAT_VERSION
    plan2 = ChunkPlan.from_json(plan.to_json())
    assert plan2.to_dict() == plan.to_dict()
    assert plan2.stages[0].n_chunks == res.plan[0].n_chunks
    assert plan2.stages[0].chunk_extent == res.plan[0].chunk_extent
    with pytest.raises(PlanApplyError, match="framework"):
        ChunkPlan.from_dict({k: v for k, v in doc.items() if k != "framework"})


def test_plan_save_load_apply_matches_fresh_search_and_jax(tmp_path):
    w, x = _example()
    res = build_autochunk(_mini_block, (w, x), budget_ratio=0.3)
    res.to_chunk_plan().save(tmp_path / "plan.json")
    loaded = ChunkPlan.load(tmp_path / "plan.json")
    flat_fn, leaves = _flat(w, x)
    g, _ = trace(flat_fn, leaves, weight_argnums=())
    fn, _, prof = build_fn_from_plan(g, loaded)
    y_replay = fn(*leaves)[0]
    assert torch.equal(y_replay, res.fn(w, x))
    assert prof.peak_bytes == res.final_peak
    jw, jx = _numpy_example()
    jres = jbuild_autochunk(_jax_block, (jw, jx), budget_ratio=0.3)
    np.testing.assert_allclose(y_replay.numpy(), np.asarray(jres.fn(jw, jx)), atol=1e-5)


def test_multi_stage_plan_replay_roundtrip():
    """A hand-built 2-stage plan survives JSON and replays exactly."""
    def f(w, x):
        s = (x @ w["a"]) @ (x @ w["a"]).transpose(-1, -2)
        y1 = torch.softmax(s, dim=-1) @ x
        h = torch.tanh(y1 @ w["m"])
        s2 = (h @ w["b"]) @ (h @ w["b"]).transpose(-1, -2)
        return y1 + torch.softmax(s2, dim=-1) @ h

    rng = np.random.default_rng(0)
    w = {k: torch.from_numpy(rng.standard_normal((32, 32), dtype=np.float32) * 0.1)
         for k in ("a", "m", "b")}
    x = torch.from_numpy(rng.standard_normal((1, 256, 32), dtype=np.float32))
    keys = list(w)

    def flat_fn(*ls):
        return (f(dict(zip(keys, ls[:3])), ls[3]),)

    leaves = list(w.values()) + [x]
    g, _ = trace(flat_fn, leaves, weight_argnums=())
    stages = []
    for _ in range(2):
        cands = [c for c in search_chunks(g, estimate_memory(g)) if c.chunk_extent == 256]
        assert cands, "expected sequence-dim candidates"
        cand = min(cands, key=lambda c: c.e - c.s)
        stages.append(PlanStage.from_candidate(g, cand, 4))
        g = apply_chunk(g, cand, 4)       # stage i + 1 indexes the rewritten graph
    plan = ChunkPlan.from_json(ChunkPlan(cache_key="test", budget_bytes=0, baseline_peak=0,
                                         final_peak=0, stages=stages).to_json())
    g0, _ = trace(flat_fn, leaves, weight_argnums=())
    fn, _, _ = build_fn_from_plan(g0, plan)
    np.testing.assert_allclose(fn(*leaves)[0].numpy(), f(w, x).numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# Hits and misses
# ---------------------------------------------------------------------------

def test_warm_hit_skips_search_and_selection():
    w, x = _example()
    cache = PlanCache()
    r1 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
    assert not r1.from_cache and r1.plan
    before = stats.snapshot()
    r2 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
    d = stats.delta(before)
    assert r2.from_cache and r2.cache_key == r1.cache_key
    assert d["search_passes"] == d["selection_passes"] == 0
    assert d["plan_cache_hits"] == 1 and d["plan_cache_misses"] == 0
    # the port replays on its own trace: no verification re-trace
    assert d["trace_calls"] == 1
    assert r2.final_peak == r1.final_peak
    assert torch.equal(r2.fn(w, x), r1.fn(w, x))


def test_cache_miss_then_populate():
    w, x = _example()
    cache = PlanCache()
    assert len(cache) == 0
    before = stats.snapshot()
    r = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
    assert stats.delta(before)["plan_cache_misses"] == 1
    assert not r.from_cache and r.cache_key is not None
    assert len(cache) == 1 and r.cache_key in cache


def test_disk_cache_shared_between_instances(tmp_path):
    w, x = _example()
    r1 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3,
                         cache=PlanCache(tmp_path / "plans"))
    assert not r1.from_cache
    assert [p.name for p in (tmp_path / "plans").glob("*.json")] == [f"{r1.cache_key}.json"]
    r2 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3,
                         cache=PlanCache(tmp_path / "plans"))
    assert r2.from_cache and torch.equal(r2.fn(w, x), r1.fn(w, x))
    r3 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=str(tmp_path / "plans"))
    assert r3.from_cache


def test_corrupt_disk_plan_falls_back_to_search(tmp_path):
    w, x = _example()
    r1 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=tmp_path / "plans")
    for p in (tmp_path / "plans").glob("*.json"):
        p.write_text("{not json")
    before = stats.snapshot()
    r2 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=tmp_path / "plans")
    d = stats.delta(before)
    assert not r2.from_cache and d["search_passes"] > 0 and d["plan_cache_misses"] == 1
    assert r2.final_peak == r1.final_peak
    # the cold compile rewrote the entry: the next process hits
    assert build_autochunk(_mini_block, (w, x), budget_ratio=0.3,
                           cache=tmp_path / "plans").from_cache


def test_stale_plan_replay_failure_counts_a_miss_and_searches():
    w, x = _example()
    cache = PlanCache()
    r1 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
    broken = ChunkPlan.from_dict(cache.get(r1.cache_key).to_dict())
    broken.stages[0].var_dim = {"node:9999:0": 1}       # unresolvable value
    cache.put(r1.cache_key, broken)
    before = stats.snapshot()
    r2 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
    d = stats.delta(before)
    assert not r2.from_cache
    assert d["plan_replay_failures"] == 1 and d["search_passes"] > 0
    assert d["plan_cache_hits"] == 0 and d["plan_cache_misses"] == 1
    np.testing.assert_allclose(r2.fn(w, x).numpy(), _mini_block(w, x).numpy(), atol=1e-5)


def test_budget_change_with_shared_cache_compiles_separately():
    w, x = _example()
    cache = PlanCache()
    r1 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
    r2 = build_autochunk(_mini_block, (w, x), budget_ratio=0.5, cache=cache)
    assert not r2.from_cache and len(cache) == 2
    r3 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
    assert r3.from_cache and r3.cache_key == r1.cache_key


def test_plan_apply_rejects_wrong_graph():
    w, x = _example()
    plan = build_autochunk(_mini_block, (w, x), budget_ratio=0.3).to_chunk_plan()
    keys = list(w)
    g, _ = trace(lambda *ls: (ls[-1] @ dict(zip(keys, ls[:-1]))["wq"],),
                 list(w.values()) + [x], weight_argnums=())
    with pytest.raises(PlanApplyError):
        build_fn_from_plan(g, plan)


# ---------------------------------------------------------------------------
# The key
# ---------------------------------------------------------------------------

def _key(seq=64, budget=100_000, hyper=CostHyper(), knobs=None, fn=None, args=None):
    w, x = args if args is not None else _meta_args(seq)
    flat_fn, leaves = _flat(w, x) if fn is None else (fn, list(w.values()) + [x])
    g, _ = trace(flat_fn, leaves, weight_argnums=())
    return plan_cache_key(g, budget, hyper, {"window": 48} if knobs is None else knobs)


def test_cache_key_invalidates_on_shape_change():
    keys = {_key(args=_meta_args(64)), _key(args=_meta_args(128)),
            _key(args=_meta_args(64, d=64, f=64))}
    assert len(keys) == 3


def test_cache_key_invalidates_on_budget_hyper_knobs_and_target():
    base = _key()
    assert _key() == base
    assert _key(budget=200_000) != base
    assert _key(hyper=CostHyper(lam=9.0)) != base
    assert _key(knobs={"window": 32}) != base
    assert _key(knobs={"window": 48, "kernel_target": "cuda"}) != \
        _key(knobs={"window": 48, "kernel_target": "cpu"})
    # through the staged API: the resolved kernel target is in the key
    cf = autochunk(_mini_block, ChunkConfig(budget_ratio=0.3))
    w, x = _example()
    cpu = cf.trace(w, x)
    cuda = autochunk(_mini_block, ChunkConfig(budget_ratio=0.3, kernel_target="cuda")).trace(w, x)
    assert (cpu.target, cuda.target) == ("cpu", "cuda")
    assert cpu.cache_key() != cuda.cache_key()


def test_cache_key_stable_across_retrace():
    assert _key() == _key()


def test_cache_key_same_in_another_process(tmp_path):
    code = BLOCK_SRC + '''
from repro_torch.core import ChunkConfig, autochunk
w, x = meta_args()
print(autochunk(mini_block, ChunkConfig(budget_ratio=0.3, kernel_target="cpu"))
      .trace(w, x).cache_key())
'''
    out = subprocess.run([sys.executable, "-B", "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    w, x = _meta_args()
    here = autochunk(_mini_block, ChunkConfig(budget_ratio=0.3, kernel_target="cpu"))
    assert out.stdout.strip() == here.trace(w, x).cache_key()


def _arange_block(w, x):
    """Factory ops carry ``device=`` (arange, full): a causal band mask."""
    s = x.shape[1]
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(s, device=x.device)[None, :]
    logits = (x @ w["wq"]) @ (x @ w["wk"]).transpose(-1, -2)
    neg = torch.full((), -1e30, device=x.device)
    return torch.softmax(torch.where(j <= i, logits, neg), dim=-1) @ x


def test_meta_trace_and_fake_cpu_trace_share_a_key():
    w, x = _example()
    keys = list(w)

    def flat_fn(*ls):
        return (_arange_block(dict(zip(keys, ls[:-1])), ls[-1]),)

    g_cpu, _ = trace(flat_fn, list(w.values()) + [x], weight_argnums=())
    g_meta, _ = trace(flat_fn, [t.to("meta") for t in list(w.values()) + [x]],
                      weight_argnums=())
    devices = {str(n.kwargs["device"]) for n in g_cpu.nodes if "device" in n.kwargs}
    assert devices == {"cpu"}           # the trace did record the device
    assert plan_cache_key(g_cpu, 1, None, None) == plan_cache_key(g_meta, 1, None, None)


# ---------------------------------------------------------------------------
# Plan files across frameworks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_file_into_port", "port_file_into_jax"])
def test_plan_file_of_the_other_framework_is_a_miss(tmp_path, direction):
    w, x = _example()
    jw, jx = _numpy_example()
    port = build_autochunk(_mini_block, (w, x), budget_ratio=0.3)
    jres = jbuild_autochunk(_jax_block, (jw, jx), budget_ratio=0.3)
    d = tmp_path / "plans"
    if direction == "jax_file_into_port":
        # the JAX plan under the port's own key, as an entry and an alias
        jres.to_chunk_plan().save(d / f"{port.cache_key}.json")
        jres.to_chunk_plan().save(d / "buckets" / "alias.json")
        cache = PlanCache(d)
        assert cache.get(port.cache_key) is None and cache.get_bucket("alias") is None
        r = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=cache)
        assert not r.from_cache       # searched and rewrote the entry
        assert ChunkPlan.load(d / f"{port.cache_key}.json").framework == "torch"
    else:
        port.to_chunk_plan().save(d / f"{jres.cache_key}.json")
        port.to_chunk_plan().save(d / "buckets" / "alias.json")
        cache = JPlanCache(d)
        assert cache.get(jres.cache_key) is None and cache.get_bucket("alias") is None
        r = jbuild_autochunk(_jax_block, (jw, jx), budget_ratio=0.3, cache=cache)
        assert not r.from_cache
    assert port.cache_key != jres.cache_key


# ---------------------------------------------------------------------------
# The staged API over a cache
# ---------------------------------------------------------------------------

def test_bucket_reuse_persists_through_disk_cache(tmp_path):
    w = _example()[0]
    cf1 = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4), cache=tmp_path / "plans")
    first = cf1.trace(w, _example(48)[1]).search()
    assert not first.from_cache and first.plan.stages
    assert list((tmp_path / "plans" / "buckets").glob("*.json"))
    # a fresh transform (another process) at a sibling length: a bucket hit
    # from disk, written back under its exact key
    cf2 = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4), cache=tmp_path / "plans")
    x60 = _example(60)[1]
    before = stats.snapshot()
    planned = cf2.trace(w, x60).search()
    d = stats.delta(before)
    assert planned.bucket_hit and d["search_passes"] == 0
    assert d["plan_bucket_hits"] == 1 and d["plan_cache_misses"] == 1
    assert planned.plan.meta["rescaled_from"] == first.plan.cache_key
    np.testing.assert_allclose(planned.compile()(w, x60).numpy(),
                               _mini_block(w, x60).numpy(), atol=1e-5)
    cf3 = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4), cache=tmp_path / "plans")
    before = stats.snapshot()
    again = cf3.trace(w, x60).search()
    assert again.from_cache and not again.bucket_hit
    assert stats.delta(before)["plan_cache_hits"] == 1
    assert cf3.stats()["plan_cache"]["hits"] == 1


def test_version_mismatch_rejected_not_crashed(tmp_path):
    w, x = _example()
    r1 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=tmp_path / "plans")
    p = tmp_path / "plans" / f"{r1.cache_key}.json"
    doc = json.loads(p.read_text())
    doc["version"] = PLAN_FORMAT_VERSION + 1
    p.write_text(json.dumps(doc))
    with pytest.raises(PlanApplyError):
        ChunkPlan.load(p)
    r2 = build_autochunk(_mini_block, (w, x), budget_ratio=0.3, cache=tmp_path / "plans")
    assert not r2.from_cache and json.loads(p.read_text())["version"] == PLAN_FORMAT_VERSION


def test_chunked_function_honors_cache_eviction_knobs(tmp_path):
    w = _example()[0]
    cf = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4, cache_max_entries=1),
                   cache=tmp_path / "plans")
    cf.compile(w, _example(48)[1])
    assert len(cf.cache) == 1
    before = stats.snapshot()
    cf.compile(w, _example(100)[1])       # another bucket: a second plan
    assert len(cf.cache) == 1 and cf.cache.stats()["evictions"] >= 1
    assert stats.delta(before)["plan_evictions"] >= 1


@pytest.mark.parametrize("case", ["max_entries", "max_age", "in_memory"])
def test_prune(tmp_path, case):
    t = [1_000_000.0]
    cache = PlanCache(None if case == "in_memory" else tmp_path / "plans", clock=lambda: t[0])
    for i, k in enumerate("abc"):
        t[0] = 1_000_000.0 + 10 * i
        cache.put(k, ChunkPlan(cache_key=k, budget_bytes=1, baseline_peak=2, final_peak=1))
    t[0] = 1_000_100.0
    if case == "max_age":
        assert cache.prune(max_age_s=95) == 1            # "a" was last used 100 s ago
        assert cache.keys() == ["b", "c"]
    else:
        assert cache.prune(max_entries=1) == 2
        assert cache.keys() == ["c"]
    if case != "in_memory":
        assert sorted(p.stem for p in (tmp_path / "plans").glob("*.json")) == cache.keys()
