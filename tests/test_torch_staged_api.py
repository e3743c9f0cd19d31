"""Port staged API: ChunkConfig, ShapeBucketer, trace/search/compile, buckets.

The counter invariants of ``tests/test_staged_api.py`` that need no plan
cache: the staged pipeline gives the one-shot ``build_autochunk`` result; a
second compile at another length in the same shape bucket replays the plan
with zero search and selection passes; direct calls compile lazily per
shape; decorator and keyword forms; ``ChunkConfig`` validation, defaults and
the knob layout it shares with the JAX package.  Outputs within 1e-5.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import ChunkConfig as JChunkConfig
from repro.core import ShapeBucketer as JShapeBucketer
from repro_torch.core import (
    ChunkConfig,
    ChunkedFunction,
    ChunkPlan,
    ShapeBucketer,
    autochunk,
    build_autochunk,
    stats,
)
from repro_torch.core.plan import PLAN_FORMAT_VERSION, PlanApplyError
from repro_torch.core.selection import CostHyper

torch.set_num_threads(2)


def _mini_block(w, x):
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    logits = q @ k.transpose(-1, -2) / math.sqrt(x.shape[-1])
    o = (torch.softmax(logits, dim=-1) @ v) @ w["wo"]
    h = x + o
    return h + F.gelu(h @ w["w1"]) @ w["w2"]


def _mini_weights(d=32, f=64, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, f), "w2": (f, d)}
    return {k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1)
            for k, s in shapes.items()}


def _x(seq=48, d=32, seed=9):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((1, seq, d),
                                                                        dtype=np.float32))


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# ChunkConfig / ShapeBucketer
# ---------------------------------------------------------------------------

def test_config_defaults_to_paper_budget():
    cfg = ChunkConfig()
    assert cfg.budget_ratio == 0.5 and cfg.budget_bytes is None
    assert cfg.resolve_budget(1000) == 500
    assert ChunkConfig(budget_bytes=123).resolve_budget(10 ** 9) == 123


@pytest.mark.parametrize("kw", [
    dict(budget_ratio=0.5, budget_bytes=10), dict(budget_ratio=0.0), dict(budget_ratio=1.5),
    dict(budget_bytes=0), dict(max_stages=0), dict(beam=0), dict(window=0), dict(anneal=-1),
    dict(min_gain=-0.1), dict(kernel_dispatch="maybe"), dict(autotune="sometimes"),
    dict(mask_mode="float"), dict(cache_policy="fifo"), dict(cache_max_entries=-1),
    dict(weight_argnums=("a",)), dict(dim_blocklist=(-1,)),
])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        ChunkConfig(**kw)


@pytest.mark.parametrize("kw,item", [
    (dict(mesh_spec={"axes": {"data": 2}}), "item 11"),
    (dict(autotune="on"), "item 7"),
])
def test_config_unported_knobs_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ChunkConfig(**kw)


def test_config_coerces_and_with_swaps_budget_kind():
    cfg = ChunkConfig(weight_argnums=[1, 0, 1], dim_blocklist=[2, 0])
    assert cfg.weight_argnums == (0, 1) and cfg.dim_blocklist == (0, 2)
    swapped = ChunkConfig(budget_ratio=0.3).with_(budget_bytes=1000)
    assert swapped.budget_bytes == 1000 and swapped.budget_ratio is None
    assert ChunkConfig.from_scalar(0.25).budget_ratio == 0.25
    assert ChunkConfig.from_scalar(4096).budget_bytes == 4096


def test_config_cache_token_and_knobs():
    assert ChunkConfig(budget_ratio=0.4).cache_token() == ChunkConfig(budget_ratio=0.4).cache_token()
    assert ChunkConfig(budget_ratio=0.4).cache_token() != ChunkConfig(budget_ratio=0.3).cache_token()
    # verbose and eviction knobs are not identity
    assert ChunkConfig(verbose=True, cache_max_entries=3).cache_token() == ChunkConfig().cache_token()
    assert set(ChunkConfig().search_knobs()) == set(JChunkConfig().search_knobs())
    d = ChunkConfig(budget_ratio=0.3, hyper=CostHyper(alpha=2.0)).to_dict()
    assert ChunkConfig.from_dict(d) == ChunkConfig(budget_ratio=0.3, hyper=CostHyper(alpha=2.0))


@pytest.mark.parametrize("buckets", [None, (128, 256, 1024)])
def test_bucketer_matches_jax(buckets):
    ours, theirs = ShapeBucketer(buckets=buckets), JShapeBucketer(buckets=buckets)
    for size in (1, 7, 31, 32, 33, 48, 60, 64, 65, 100, 128, 129, 300, 1024, 1025, 5000):
        assert ours.bucket_dim(size) == theirs.bucket_dim(size), size
    assert ours.bucket_shape((2, 48, 32)) == theirs.bucket_shape((2, 48, 32))
    with pytest.raises(ValueError):
        ShapeBucketer(buckets=(256, 128))
    with pytest.raises(ValueError):
        ShapeBucketer(min_dim=0)


# ---------------------------------------------------------------------------
# Staged trace / search / compile
# ---------------------------------------------------------------------------

def test_staged_matches_one_shot():
    w, x = _mini_weights(), _x()
    one_shot = build_autochunk(_mini_block, (w, x), budget_ratio=0.4)
    cf = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4))
    meta = ({k: v.to("meta") for k, v in w.items()}, x.to("meta"))
    traced = cf.trace(*meta)          # shapes only: meta tensors trace the same
    assert traced.baseline_peak == one_shot.baseline_peak == traced.memory_profile.peak_bytes
    assert traced.budget_bytes == one_shot.budget_bytes
    planned = traced.search()
    assert planned.final_peak == one_shot.final_peak
    assert len(planned.plan.stages) == len(one_shot.plan) > 0
    assert not planned.from_cache
    compiled = planned.compile()
    assert compiled.result.final_peak == one_shot.final_peak
    _close(compiled(w, x), _mini_block(w, x))
    _close(one_shot.fn(w, x), _mini_block(w, x))


def test_planned_plan_round_trips(tmp_path):
    w, x = _mini_weights(), _x()
    planned = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4)).trace(w, x).search()
    restored = ChunkPlan.from_json(planned.plan.to_json())
    assert restored.to_dict() == planned.plan.to_dict()
    assert restored.version == PLAN_FORMAT_VERSION
    planned.save(tmp_path / "plan.json")
    assert ChunkPlan.load(tmp_path / "plan.json").final_peak == planned.final_peak
    bad = dict(planned.plan.to_dict(), version=PLAN_FORMAT_VERSION + 1)
    with pytest.raises(PlanApplyError):
        ChunkPlan.from_dict(bad)


def test_bucket_hit_runs_zero_search_passes():
    w = _mini_weights()
    cf = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4))
    first = cf.trace(w, _x(seq=48)).search()
    assert not first.from_cache and first.plan.stages
    x2 = _x(seq=60)                   # same power-of-two bucket as 48 (64)
    before = stats.snapshot()
    planned = cf.trace(w, x2).search()
    d = stats.delta(before)
    assert d["search_passes"] == d["selection_passes"] == 0
    assert d["plan_bucket_hits"] == 1 and d["trace_calls"] == 1
    assert planned.from_cache and planned.bucket_hit
    assert len(planned.plan.stages) == len(first.plan.stages)
    _close(planned.compile()(w, x2), _mini_block(w, x2))


def test_different_bucket_searches_fresh():
    w = _mini_weights()
    cf = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4))
    cf.trace(w, _x(seq=48)).search()
    before = stats.snapshot()
    planned = cf.trace(w, _x(seq=100)).search()   # bucket 128 != 64
    assert stats.delta(before)["search_passes"] > 0
    assert not planned.from_cache


def test_direct_call_compiles_lazily_per_shape():
    w = _mini_weights()
    x48, x60 = _x(seq=48), _x(seq=60)
    cf = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4))
    _close(cf(w, x48), _mini_block(w, x48))
    cf(w, x48)                        # same shape: no new compile
    assert cf.counters["compiles"] == 1 and cf.counters["shape_hits"] == 1
    before = stats.snapshot()
    _close(cf(w, x60), _mini_block(w, x60))   # sibling shape: a bucket replay
    assert stats.delta(before)["search_passes"] == 0
    assert cf.counters["compiles"] == 2 and cf.counters["bucket_hits"] == 1
    s = cf.stats()
    assert s["compiled_shapes"] == 2 and s["bucket_plans"] == 1
    assert cf.autochunk_result is not None


def test_decorator_and_kwargs_forms():
    w, x = _mini_weights(), _x()

    @autochunk(ChunkConfig(budget_ratio=0.4))
    def block(w, x):
        return _mini_block(w, x)

    assert isinstance(block, ChunkedFunction)
    _close(block(w, x), _mini_block(w, x))

    @autochunk(budget_ratio=0.4)
    def block2(w, x):
        return _mini_block(w, x)

    _close(block2(w, x), _mini_block(w, x))
    cf = autochunk(_mini_block, budget_ratio=0.3, window=32)
    assert cf.config.budget_ratio == 0.3 and cf.config.window == 32
    assert autochunk(_mini_block, memory_budget=0.25).config.budget_ratio == 0.25
    assert autochunk(_mini_block, memory_budget=5000).config.budget_bytes == 5000


def test_bucketer_none_disables_bucketing():
    w = _mini_weights()
    cf = autochunk(_mini_block, ChunkConfig(budget_ratio=0.4), bucketer=None)
    cf.trace(w, _x(seq=48)).search()
    before = stats.snapshot()
    cf.trace(w, _x(seq=60)).search()
    d = stats.delta(before)
    assert d["search_passes"] > 0 and d["plan_bucket_hits"] == 0


def test_unported_surfaces_raise():
    w, x = _mini_weights(), _x()
    with pytest.raises(NotImplementedError):
        autochunk(_mini_block, (w, x), 0.5)          # the deprecated JAX form
    with pytest.raises(ValueError):
        build_autochunk(_mini_block, (w, x), budget_ratio=0.4, budget_bytes=100)
    with pytest.raises(ValueError):
        build_autochunk(_mini_block, (w, x))
