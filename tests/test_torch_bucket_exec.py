"""Port canonical bucket executables and plan-cache eviction against the JAX package.

The counter invariants of ``tests/test_bucket_exec.py``: with
``canonical_bucket_exec`` one executable per shape bucket, compiled at the
boundary, serves every other length in the bucket by padding; a warm bucket
costs 0 traces and 0 search passes; padded outputs have the true shapes and
match the unpadded function under causal and sliding-window masks and at a
boundary the chunk count does not divide.  Each case also runs through the
JAX package on the same numpy inputs (outputs within 1e-5).  The eviction
policies (``lru``, ``cost_lfu``, ``max_age``, aliases riding with their
plan) run on both packages' ``PlanCache`` under the same pinned clock and
must remove the same plans.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import ChunkConfig as JChunkConfig
from repro.core import PlanCache as JPlanCache
from repro.core import ShapeBucketer as JShapeBucketer
from repro.core import autochunk as jautochunk
from repro.core.lowering import pad_to_shape as jpad_to_shape
from repro.core.plan import ChunkPlan as JChunkPlan
from repro_torch.core import ChunkConfig, PlanCache, ShapeBucketer, autochunk, stats
from repro_torch.core.lowering import emit_padded_call, pad_to_shape, slice_to_shape
from repro_torch.core.plan import ChunkPlan

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# Length-masked blocks: attention masked by a true length in a 0-d argument
# ---------------------------------------------------------------------------

def _np_weights(d=32, f=64, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, f),
              "w2": (f, d)}
    return {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in shapes.items()}


def _np_x(seq, d=32, seed=9):
    return np.random.default_rng(seed).standard_normal((2, seq, d), dtype=np.float32)


def _masked_block(w, x, length, window=None):
    s = x.shape[1]
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    logits = q @ k.transpose(-1, -2) / x.shape[-1] ** 0.5
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(s, device=x.device)[None, :]
    mask = (j <= i) & (j < length)
    if window is not None:
        mask = mask & (j > i - window)
    a = torch.softmax(torch.where(mask, logits, torch.full((), -1e30, device=x.device)), -1)
    h = x + (a @ v) @ w["wo"]
    return h + F.gelu(h @ w["w1"]) @ w["w2"]


def _jax_masked_block(w, x, length, window=None):
    s = x.shape[1]
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    logits = jnp.einsum("bsd,btd->bst", q, k) / jnp.sqrt(x.shape[-1])
    i = jnp.arange(s)[:, None]
    j = jnp.arange(s)[None, :]
    mask = (j <= i) & (j < length)
    if window is not None:
        mask = mask & (j > i - window)
    a = jax.nn.softmax(jnp.where(mask, logits, -1e30), axis=-1)
    h = x + jnp.einsum("bst,btd->bsd", a, v) @ w["wo"]
    return h + jax.nn.gelu(h @ w["w1"], approximate=False) @ w["w2"]


def _causal_block(w, x, length):
    return _masked_block(w, x, length)


def _window_block(w, x, length):
    return _masked_block(w, x, length, window=8)


def _jax_causal_block(w, x, length):
    return _jax_masked_block(w, x, length)


def _jax_window_block(w, x, length):
    return _jax_masked_block(w, x, length, window=8)


def _args(seq, seed=9):
    w, x = _np_weights(), _np_x(seq, seed=seed)
    return ({k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x),
            torch.tensor(seq, dtype=torch.int32))


def _jax_out(jfn, seq, seed=9, **kw):
    """The JAX package's canonical bucket executable at the same inputs."""
    cf = jautochunk(jfn, JChunkConfig(budget_ratio=0.4, canonical_bucket_exec=True), **kw)
    return np.asarray(cf(_np_weights(), _np_x(seq, seed=seed), jnp.asarray(seq, jnp.int32)))


# ---------------------------------------------------------------------------
# The pad / slice protocol
# ---------------------------------------------------------------------------

def test_pad_and_slice_roundtrip_matches_jax():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    p = pad_to_shape(x, (5, 4))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jpad_to_shape(x.numpy(), (5, 4))))
    assert torch.equal(slice_to_shape(p, (3, 4)), x)
    assert pad_to_shape(x, (3, 4)) is x
    tok = torch.tensor([[3, 1, 2]])
    assert pad_to_shape(tok, (1, 5)).tolist() == [[3, 1, 2, 0, 0]]
    with pytest.raises(ValueError):
        pad_to_shape(x, (2, 4))
    with pytest.raises(ValueError):
        slice_to_shape(x, (4, 4))


def test_emit_padded_call_slices_by_true_output_specs():
    """An output axis that coincides with the padded extent but is not the
    padded axis is left alone."""
    def fn(x):                       # (s, 8) -> (8, s)
        return x.T

    x = torch.ones((5, 8))
    wrapped = emit_padded_call(fn, (torch.empty((8, 8), device="meta"),),
                               fn(x.to("meta")))
    before = stats.snapshot()
    y = wrapped(x)
    assert stats.delta(before)["padded_calls"] == 1
    assert y.shape == (8, 5) and torch.equal(y, x.T)
    with pytest.raises(ValueError):
        wrapped(x, x)


# ---------------------------------------------------------------------------
# Canonical bucket executables
# ---------------------------------------------------------------------------

def test_bucket_exec_zero_traces_zero_searches_on_warm_bucket():
    cf = autochunk(_causal_block, ChunkConfig(budget_ratio=0.4, canonical_bucket_exec=True))
    w, x60, n60 = _args(60)
    y60 = cf(w, x60, n60)
    assert y60.shape == x60.shape
    np.testing.assert_allclose(y60.numpy(), _causal_block(w, x60, n60).numpy(), atol=1e-5)
    assert cf.counters["compiles"] == cf.counters["bucket_exec_compiles"] == 1
    assert cf.stats()["bucket_execs"] == 1
    _, x50, n50 = _args(50, seed=3)          # the same bucket (64), another length
    before = stats.snapshot()
    y50 = cf(w, x50, n50)
    d = stats.delta(before)
    assert d["trace_calls"] == d["search_passes"] == d["selection_passes"] == 0
    assert d["bucket_exec_compiles"] == 0 and d["bucket_exec_hits"] == 1
    assert d["padded_calls"] == 1 and cf.counters["compiles"] == 1
    assert y50.shape == x50.shape
    np.testing.assert_allclose(y50.numpy(), _causal_block(w, x50, n50).numpy(), atol=1e-5)
    np.testing.assert_allclose(y50.numpy(), _jax_out(_jax_causal_block, 50, seed=3), atol=1e-5)
    before = stats.snapshot()                # the same length again: memoized
    cf(w, x50, n50)
    d = stats.delta(before)
    assert d["bucket_exec_hits"] == 1 and d["trace_calls"] == 0
    assert cf.stats()["padded_shapes"] == 2


def test_bucket_exec_boundary_length_needs_no_padding():
    cf = autochunk(_causal_block, ChunkConfig(budget_ratio=0.4, canonical_bucket_exec=True))
    w, x64, n64 = _args(64, seed=5)
    before = stats.snapshot()
    y = cf(w, x64, n64)
    assert stats.delta(before)["padded_calls"] == 0
    np.testing.assert_allclose(y.numpy(), _causal_block(w, x64, n64).numpy(), atol=1e-5)
    assert cf.stats()["compiled_shapes"] == 1
    before = stats.snapshot()
    cf(w, x64, n64)
    assert stats.delta(before)["bucket_exec_compiles"] == 0


def test_padded_call_equivalence_sliding_window():
    cf = autochunk(_window_block, ChunkConfig(budget_ratio=0.4, canonical_bucket_exec=True))
    for seq, seed in ((60, 1), (49, 2)):
        w, x, n = _args(seq, seed=seed)
        y = cf(w, x, n)
        assert y.shape == x.shape
        np.testing.assert_allclose(y.numpy(), _window_block(w, x, n).numpy(), atol=1e-5)
        np.testing.assert_allclose(y.numpy(), _jax_out(_jax_window_block, seq, seed=seed),
                                   atol=1e-5)
    assert cf.counters["bucket_exec_compiles"] == cf.counters["bucket_exec_hits"] == 1


def test_padded_call_equivalence_non_divisible_boundary():
    """A boundary of 72 gives chunk counts that do not divide the canonical
    extent; the clamped last chunk stays exact through the padded path."""
    bucketer = ShapeBucketer(buckets=(72,), min_dim=48)
    cf = autochunk(_causal_block, ChunkConfig(budget_ratio=0.4, canonical_bucket_exec=True),
                   bucketer=bucketer)
    w, x60, n60 = _args(60, seed=7)
    y = cf(w, x60, n60)
    assert y.shape == x60.shape
    np.testing.assert_allclose(y.numpy(), _causal_block(w, x60, n60).numpy(), atol=1e-5)
    ((_, canon),) = list(cf._bucket_execs)
    assert ((2, 72, 32), "torch.float32", "cpu") in canon     # compiled at 72
    before = stats.snapshot()
    _, x65, n65 = _args(65, seed=8)
    y65 = cf(w, x65, n65)
    d = stats.delta(before)
    assert d["bucket_exec_hits"] == 1 and d["trace_calls"] == 0
    np.testing.assert_allclose(y65.numpy(), _causal_block(w, x65, n65).numpy(), atol=1e-5)
    jbucketer = JShapeBucketer(buckets=(72,), min_dim=48)
    np.testing.assert_allclose(y65.numpy(),
                               _jax_out(_jax_causal_block, 65, seed=8, bucketer=jbucketer),
                               atol=1e-5)


def test_canonical_exec_off_by_default():
    cf = autochunk(_causal_block, ChunkConfig(budget_ratio=0.4))
    assert not cf.config.canonical_bucket_exec
    cf(*_args(60))
    assert cf.stats()["bucket_execs"] == 0 and cf.counters["compiles"] == 1


def test_config_eviction_knob_validation_and_token():
    with pytest.raises(ValueError):
        ChunkConfig(cache_policy="mru")
    with pytest.raises(ValueError):
        ChunkConfig(cache_max_entries=-1)
    cfg = ChunkConfig(canonical_bucket_exec=True, cache_max_entries=4)
    # canonical_bucket_exec is identity (as in the JAX package); eviction is not
    assert cfg.cache_token() != ChunkConfig().cache_token()
    assert ChunkConfig(cache_max_entries=4).cache_token() == ChunkConfig().cache_token()
    assert ShapeBucketer().canonical_shape((2, 60, 32)) == (2, 64, 32)


# ---------------------------------------------------------------------------
# Eviction, on both packages' caches under one pinned clock
# ---------------------------------------------------------------------------

NOW = 1_700_000_000.0
IMPLS = {"port": (PlanCache, ChunkPlan), "jax": (JPlanCache, JChunkPlan)}


def _plan(impl, key, compile_s=None):
    plan = IMPLS[impl][1](cache_key=key, budget_bytes=1, baseline_peak=2, final_peak=1)
    if compile_s is not None:
        plan.meta["compile_s"] = compile_s
    return plan


def _cache(impl, path=None):
    return IMPLS[impl][0](path, clock=lambda: NOW)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_evict_lru_drops_least_recently_used(tmp_path, impl):
    cache = _cache(impl, tmp_path / "plans")
    for i, k in enumerate("abcd"):
        cache.put(k, _plan(impl, k))
        cache.record_use(k, now=NOW - 100 + i * 10)
    assert cache.evict(policy="lru", max_entries=2, now=NOW) == 2
    assert cache.get("a") is None and cache.get("b") is None
    assert cache.get("c") is not None and cache.get("d") is not None
    assert cache.stats()["evictions"] == 2


@pytest.mark.parametrize("impl", list(IMPLS))
def test_evict_cost_lfu_keeps_high_hit_times_cost_plans(impl):
    def build():
        cache = _cache(impl)
        for k in ("hot_cheap", "cold_costly", "cold_cheap"):
            cache.put(k, _plan(impl, k))
        for _ in range(10):
            cache.record_use("hot_cheap", compile_s=0.1, now=NOW)
        cache.record_use("cold_costly", compile_s=50.0, now=NOW - 500)
        cache.record_use("cold_cheap", compile_s=0.1, now=NOW - 100)
        return cache

    lfu = build()
    assert lfu.evict(policy="cost_lfu", max_entries=2, now=NOW) == 1
    assert lfu.get("cold_cheap") is None
    assert lfu.get("hot_cheap") is not None and lfu.get("cold_costly") is not None
    lru = build()
    assert lru.evict(policy="lru", max_entries=2, now=NOW) == 1
    assert lru.get("cold_costly") is None
    with pytest.raises(ValueError):
        _cache(impl).evict(policy="mru")


@pytest.mark.parametrize("impl", list(IMPLS))
def test_evict_cost_lfu_reads_persisted_compile_cost(tmp_path, impl):
    writer = _cache(impl, tmp_path / "plans")
    writer.put("costly", _plan(impl, "costly", 120.0))
    writer.put("cheap", _plan(impl, "cheap", 0.2))
    fresh = _cache(impl, tmp_path / "plans")     # a restarted process
    assert fresh.evict(policy="cost_lfu", max_entries=1) == 1
    assert fresh.get("costly") is not None and fresh.get("cheap") is None


@pytest.mark.parametrize("impl", list(IMPLS))
def test_evict_max_age_uses_recency(tmp_path, impl):
    cache = _cache(impl, tmp_path / "plans")
    cache.put("stale", _plan(impl, "stale"))
    cache.put("fresh", _plan(impl, "fresh"))
    cache.record_use("stale", now=NOW - 1000)
    cache.record_use("fresh", now=NOW)
    assert cache.evict(policy="lru", max_age_s=500, now=NOW) == 1
    assert cache.get("stale") is None and cache.get("fresh") is not None


@pytest.mark.parametrize("impl", list(IMPLS))
def test_telemetry_recorded_on_get_put(tmp_path, impl):
    cache = _cache(impl, tmp_path / "plans")
    plan = _plan(impl, "k", 7.5)
    cache.put("k", plan)
    m = cache.entry_meta("k")
    assert m["hits"] == 0 and m["compile_s"] == 7.5 and m["last_used"] == NOW
    cache.get("k")
    cache.record_use("k", bucket=128)
    m = cache.entry_meta("k")
    assert m["hits"] == 2 and m["buckets"] == {"128": 1}
    cache.put_bucket("bk", plan)              # an alias hit is a use of the home plan
    cache.get_bucket("bk")
    assert cache.entry_meta("k")["hits"] == 3
    cache.record_accuracy("k", {"predicted": 10, "measured": 11})
    assert cache.entry_meta("k")["accuracy"] == {"predicted": 10, "measured": 11}
    assert cache.stats()["bucket_hits"] == 1 and cache.stats()["entries"] == 1


@pytest.mark.parametrize("impl", list(IMPLS))
def test_evict_counts_one_record_per_plan_with_aliases(tmp_path, impl):
    cache = _cache(impl, tmp_path / "plans")
    pa, pb = _plan(impl, "ka"), _plan(impl, "kb")
    cache.put("ka", pa)
    cache.put_bucket("bucket-a", pa)
    cache.put("kb", pb)
    cache.put_bucket("bucket-b", pb)
    cache.record_use("ka", now=NOW - 100)
    cache.record_use("kb", now=NOW)
    assert cache.prune(max_entries=1, now=NOW) == 1      # one plan, not three files
    assert cache.get("ka") is None and cache.get_bucket("bucket-a") is None
    assert cache.get("kb") is not None and cache.get_bucket("bucket-b") is not None
    assert len(list((tmp_path / "plans" / "buckets").glob("*.json"))) == 1


@pytest.mark.parametrize("impl", list(IMPLS))
def test_evict_in_memory_aliases_ride_along(impl):
    cache = _cache(impl)
    pa, pb = _plan(impl, "ka"), _plan(impl, "kb")
    cache.put("ka", pa)
    cache.put_bucket("bucket-a", pa)
    cache.put("kb", pb)
    cache.put_bucket("bucket-b", pb)
    cache.record_use("ka", now=NOW - 100)
    cache.record_use("kb", now=NOW)
    assert cache.evict(policy="lru", max_entries=1, now=NOW) == 1
    assert cache.get("ka") is None and cache.get_bucket("bucket-a") is None
    assert cache.get("kb") is not None and cache.get_bucket("bucket-b") is not None


@pytest.mark.parametrize("impl", list(IMPLS))
def test_clear_with_and_without_disk(tmp_path, impl):
    cache = _cache(impl, tmp_path / "plans")
    cache.put("k", _plan(impl, "k"))
    cache.put_bucket("b", _plan(impl, "k"))
    cache.clear()
    assert cache.entry_meta("k") == {} and len(cache) == 1     # the file stays
    cache.clear(disk=True)
    assert len(cache) == 0 and not list((tmp_path / "plans").rglob("*.json"))


def test_default_clock_is_wall_time(tmp_path):
    cache = PlanCache(tmp_path / "plans")
    t0 = time.time()
    cache.put("k", _plan("port", "k"))
    assert t0 - 1 <= cache.entry_meta("k")["last_used"] <= time.time() + 1
