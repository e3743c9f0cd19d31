"""Port prefix cache and spill tier against the JAX package's, op for op.

The cases of ``tests/test_prefix_cache.py`` run on both packages' ``KVPool``
and ``PrefixCache`` with the same op programs: after every op the two
caches' matches (``PrefixMatch`` fields, page ids), radix trees,
``stats()``, free lists and host slots must agree, and so must the pools'
contents.  The engine cases serve gpt-paper ``reduced()`` in float32 with
the JAX package's weights carried over by ``repro_torch.interop``: greedy
tokens must be equal with the cache on and off and equal to the JAX
engine's with its cache on, and every counter the reference's tests assert
must equal the JAX engine's on the same requests.
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
from repro.core import stats as jax_stats
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.serving import KVPool as JaxPool
from repro.serving import PagedServeEngine as JaxEngine
from repro.serving import PrefixCache as JaxCache
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import stats
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.serving import KVPool, PagedServeEngine, PrefixCache, PrefixMatch, Request

torch.set_num_threads(2)

COUNTERS = ("prefix_hits", "prefix_tokens_reused", "cow_copies", "pages_spilled",
            "pages_restored", "admission_refusals")


# ======================================================================
# pool and cache, both packages in lock step
# ======================================================================

class Pair:
    """A port pool + cache and a JAX pool + cache over the same contents."""

    def __init__(self, num_pages=16, page_size=4, spill_pages=0, seed=0):
        shape = dict(n_layers=2, n_kv_heads=1, head_dim=4, num_pages=num_pages,
                     page_size=page_size)
        self.tp = KVPool(**shape, device="cpu")
        self.jp = JaxPool(**shape)
        data = np.random.default_rng(seed).standard_normal(tuple(self.tp.pages.shape))
        self.tp.pages.copy_(torch.tensor(data, dtype=torch.float32))
        self.jp.pages = jnp.asarray(data, jnp.float32)
        self.tc = PrefixCache(self.tp, spill_pages=spill_pages)
        self.jc = JaxCache(self.jp, spill_pages=spill_pages)

    def both(self, fn):
        """``fn(pool, cache)`` on both packages; the results must agree."""
        ours, theirs = fn(self.tp, self.tc), fn(self.jp, self.jc)
        if isinstance(ours, PrefixMatch):
            ours, theirs = _match(ours), _match(theirs)
        assert ours == theirs
        self.check()
        return ours

    def seed(self, prompt, sid):
        """Reserve and fill a sequence for ``prompt``, insert it into the
        cache; returns its table."""
        def go(pool, cache):
            pool.reserve(sid, len(prompt))
            pool.ensure(sid, len(prompt))
            created = cache.insert(prompt, pool.table(sid)[:pool.pages_for(len(prompt))])
            return created, pool.table(sid)
        return self.both(go)[1]

    def lock(self, prompt):
        return self.both(lambda pool, cache: cache.lock_prefix(prompt))

    def set_page(self, page, value):
        """Write ``value`` (a scalar or one page's block) at every layer."""
        self.tp.pages[:, page] = torch.as_tensor(np.asarray(value, np.float32))
        self.jp.pages = self.jp.pages.at[:, page].set(value)

    def check(self):
        tp, jp = self.tp, self.jp
        assert list(tp._free) == list(jp._free) and dict(tp._ref) == dict(jp._ref)
        assert list(tp._host_free) == list(jp._host_free)
        assert tp.stats() == jp.stats()
        assert self.tc.stats() == self.jc.stats()
        assert _tree(self.tc.root) == _tree(self.jc.root)
        np.testing.assert_array_equal(tp.pages.numpy(), np.asarray(jp.pages))
        if tp.spill_enabled:
            np.testing.assert_array_equal(tp._host.numpy(), jp._host)
        for pool, cache in ((tp, self.tc), (jp, self.jc)):
            pool.check_invariants()
            cache.check_invariants()


def _match(m):
    return (m.matched_tokens, list(m.full_pages), m.boundary_page, sorted(m.pages))


def _tree(node):
    return (node.tokens, node.page, node.host_slot, node.last_access,
            [_tree(c) for c in node.children])


def test_match_full_and_partial_blocks():
    b = Pair(page_size=4)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]   # blocks [1..4][5..8][9,10]
    table = b.seed(prompt, sid=0)
    # the identical prompt, capped at len-1: 2 full pages + a partial boundary
    assert b.lock(prompt) == (9, table[:2], table[2], sorted(table))
    # mid-block divergence: the boundary is the diverging page
    assert b.lock([1, 2, 3, 4, 5, 99, 0, 0])[:3] == (5, table[:1], table[1])
    # block-aligned divergence: full pages only
    assert b.lock([1, 2, 3, 4, 99, 98, 97, 96])[:3] == (4, table[:1], None)
    assert b.lock([42, 43, 44, 45])[:3] == (0, [], None)
    assert b.lock([1])[0] == 0                  # cap = len-1 = 0


def test_insert_reuses_and_upgrades_nodes():
    b = Pair(page_size=4)
    table0 = b.seed([1, 2, 3, 4, 5, 6], sid=0)
    assert (b.tc.stats()["nodes"], b.tc.stats()["cached_tokens"]) == (2, 6)
    # a longer prompt upgrades the partial tail to its fuller page
    table1 = b.seed([1, 2, 3, 4, 5, 6, 7, 8, 9], sid=1)
    assert (b.tc.stats()["nodes"], b.tc.stats()["cached_tokens"]) == (3, 9)
    assert b.lock([1, 2, 3, 4, 5, 6, 7, 8, 9, 10])[:3] == (9, [table0[0], table1[1]], table1[2])
    b.seed([1, 2, 3, 4, 5, 6, 7, 8, 9], sid=2)  # an exact re-insert adds nothing
    assert b.tc.stats()["nodes"] == 3


def test_divergent_blocks_become_siblings():
    b = Pair(page_size=4)
    b.seed([1, 2, 3, 4, 5, 6, 7, 8], sid=0)
    b.seed([1, 2, 3, 4, 5, 6, 9, 9], sid=1)
    assert b.tc.stats()["nodes"] == 3
    assert len(b.tc.root.children[0].children) == 2
    assert b.lock([1, 2, 3, 4, 5, 6, 9, 9, 0])[0] == 8


def test_cow_boundary_page_is_copied_not_shared():
    b = Pair(page_size=4)
    table = b.seed([1, 2, 3, 4, 5, 6], sid=0)
    b.set_page(table[1], 7.25)
    m = b.lock([1, 2, 3, 4, 5, 9])              # diverges at token 5
    assert m[:3] == (5, table[:1], table[1])
    before = stats.snapshot()
    b.both(lambda pool, _: pool.reserve(9, 8, shared_pages=m[1], shared_tokens=m[0],
                                        boundary_page=m[2]))
    assert stats.delta(before)["cow_copies"] == 1
    cow = b.tp.table(9)[1]
    assert cow != table[1] and bool((b.tp.pages[:, cow] == 7.25).all())
    b.set_page(cow, -1.0)                       # the copy's writes stay in the copy
    assert float(b.tp.pages[0, table[1], 0, 0, 0]) == 7.25
    assert b.tp.table(9)[0] == table[0] and b.tp.refcount(table[0]) >= 2
    b.check()


def test_release_pages_spills_lru_then_drops():
    b = Pair(num_pages=8, page_size=4, spill_pages=2)
    b.seed([1, 2, 3, 4], sid=0)
    b.seed([9, 8, 7, 6], sid=1)
    b.both(lambda pool, _: (pool.free(0), pool.free(1)))   # both pages cache-only
    b.lock([9, 8, 7, 6, 5])                     # t1 used last: t0 is the LRU victim
    before = stats.snapshot()
    assert b.both(lambda _, cache: cache.release_pages(1)) == 1
    assert stats.delta(before)["pages_spilled"] == 1
    s = b.tc.stats()
    assert (s["spilled_nodes"], s["resident_pages"]) == (1, 1)
    m = b.lock([1, 2, 3, 4, 5])                 # restores t0 from the host tier
    assert m[0] == 4 and stats.delta(before)["pages_restored"] == 1
    assert b.tc.stats()["spilled_nodes"] == 0 and b.tp.refcount(m[1][0]) == 1
    # with the host arena full, release falls back to dropping LRU leaves
    b.both(lambda _, cache: cache.release_pages(2))
    assert b.tc.stats()["spilled_nodes"] == 2
    b.seed([5, 5, 5, 5], sid=2)
    b.both(lambda pool, _: pool.free(2))
    nodes = b.tc.stats()["nodes"]
    assert b.both(lambda _, cache: cache.release_pages(1)) == 1
    assert b.tc.stats()["nodes"] == nodes - 1
    # flush drops every node, spilled ones included: no page or slot leaks
    b.both(lambda _, cache: cache.flush())
    assert b.tp.free_pages == b.tp.num_pages and b.tp.spilled_pages == 0


def test_spill_roundtrip_preserves_kv_bytes():
    b = Pair(num_pages=4, page_size=4, spill_pages=2)
    table = b.seed([3, 1, 4, 1], sid=0)
    want = np.random.default_rng(1).standard_normal(tuple(b.tp.pages.shape[0:1])
                                                    + tuple(b.tp.pages.shape[2:]))
    want = want.astype(np.float32)
    b.tp.pages[:, table[0]] = torch.from_numpy(want)
    b.jp.pages = b.jp.pages.at[:, table[0]].set(want)
    b.both(lambda pool, _: pool.free(0))
    # take the free pages so the restore lands on another page id
    b.both(lambda pool, _: pool.reserve(7, 4))
    assert b.both(lambda _, cache: cache.release_pages(1)) == 1      # spill
    np.testing.assert_array_equal(b.tp._host[b.tc.root.children[0].host_slot].numpy(), want)
    b.both(lambda pool, _: pool.free(7))
    m = b.lock([3, 1, 4, 1, 9])                 # restore
    page = m[1][0]
    assert page != table[0]                     # the node moved; the match names its new page
    assert b.tc.root.children[0].page == page
    np.testing.assert_array_equal(b.tp.pages[:, page].numpy(), want)


# ======================================================================
# engine integration against the JAX engine
# ======================================================================

@pytest.fixture(scope="module")
def models():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    jcfg = jax_config("gpt-paper").reduced().with_(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, params, jcfg, jparams


def _engines(models, **kw):
    cfg, params, jcfg, jparams = models
    return (PagedServeEngine(cfg, params, device="cpu", **kw),
            JaxEngine(jcfg, jparams, obs=False, **kw))


def _drive(engine, request_cls, batches):
    """Serve each batch of (prompt, kwargs) to completion in turn; returns
    the generated tokens by rid and the counters' deltas."""
    mod = stats if request_cls is Request else jax_stats
    before = mod.snapshot()
    rid = 0
    for batch in batches:
        for prompt, kw in batch:
            engine.submit(request_cls(rid=rid, prompt=list(prompt), **kw))
            rid += 1
        engine.run()
    d = mod.delta(before)
    return {r.rid: r.generated for r in engine.finished}, {k: d[k] for k in COUNTERS}


SHARED = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5]
STAGGERED = [
    [(SHARED + [11, 12], dict(max_new_tokens=5))],          # the cached original
    [(SHARED + [11, 13], dict(max_new_tokens=5)),           # diverges mid-page (COW)
     (SHARED[:5] + [9, 9, 9], dict(max_new_tokens=5)),      # diverges earlier (COW)
     (SHARED + [11, 12, 14], dict(max_new_tokens=5))],      # extends the cached prompt
]
STAGGERED_ENGINE = dict(max_seqs=3, max_len=64, page_size=4, prefill_chunk=8)


def test_engine_tokens_equal_with_cache_on_off_and_to_jax(models):
    """The staggered shared-prefix set: greedy tokens equal with the cache
    on and off, and equal to the JAX engine's with its cache on; hits, COW
    copies and reused tokens as the reference's test asserts."""
    cfg, params, _, _ = models
    off = PagedServeEngine(cfg, params, device="cpu", **STAGGERED_ENGINE)
    tokens_off, _ = _drive(off, Request, STAGGERED)
    ours, theirs = _engines(models, prefix_cache=True, **STAGGERED_ENGINE)
    tokens_on, counts = _drive(ours, Request, STAGGERED)
    jax_tokens, jax_counts = _drive(theirs, JaxRequest, STAGGERED)
    assert tokens_on == tokens_off == jax_tokens
    assert counts == jax_counts
    assert (counts["prefix_hits"], counts["cow_copies"], counts["prefix_tokens_reused"]) \
        == (3, 2, 11 + 5 + 12)
    for k in ("prefix_hits", "prefix_tokens_reused", "spill_retries"):
        assert ours.sched_stats[k] == theirs.sched_stats[k]
    assert ours.metrics()["prefix_cache"] == theirs.metrics()["prefix_cache"]
    ours.pool.check_invariants()
    ours.prefix_cache.check_invariants()
    ours.prefix_cache.flush()
    assert ours.pool.free_pages == ours.pool.num_pages
    assert ours.pool.alloc_events == ours.pool.free_events


def test_engine_spill_restore_under_pressure_matches_jax(models):
    """Pool pressure spills cached pages to the host arena; the next shared
    request restores them.  Counters, tokens and the pool's ledger equal the
    JAX engine's; nothing leaks once the cache is flushed."""
    shared, unique = list(range(1, 21)), [2] * 20
    new4 = dict(max_new_tokens=4)
    batches = [[(shared, new4)], [(shared, new4)],
               [(unique, dict(max_new_tokens=4, cache_prefix=False))], [(shared, new4)]]
    ours, theirs = _engines(models, max_seqs=2, max_len=32, page_size=8, num_pages=5,
                            prefix_cache=True, spill_pages=4)
    tokens, counts = _drive(ours, Request, batches)
    jax_tokens, jax_counts = _drive(theirs, JaxRequest, batches)
    assert tokens == jax_tokens and counts == jax_counts
    assert (counts["prefix_hits"], counts["cow_copies"]) == (2, 2)
    assert counts["pages_spilled"] == counts["pages_restored"] > 0
    assert counts["admission_refusals"] == 0
    assert ours.sched_stats["spill_retries"] == theirs.sched_stats["spill_retries"] > 0
    assert tokens[1] == tokens[3] == tokens[0]
    assert ours.pool.stats() == theirs.pool.stats()
    ours.pool.check_invariants()
    ours.prefix_cache.check_invariants()
    ours.prefix_cache.flush()
    assert ours.pool.free_pages == ours.pool.num_pages and ours.pool.spilled_pages == 0
    assert ours.pool.alloc_events == ours.pool.free_events


def test_engine_prefill_skip_shortens_work(models):
    """A matched admission starts prefill at the divergence point: 23 of 24
    tokens reused, one prefill chunk of one token."""
    cfg, params, _, _ = models
    prompt = list(range(2, 26))
    eng = PagedServeEngine(cfg, params, device="cpu", max_seqs=2, max_len=64, page_size=8,
                           prefill_chunk=8, prefix_cache=True)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    eng.run()
    before = stats.snapshot()
    eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=2))
    eng.run()
    d = stats.delta(before)
    assert (d["prefix_tokens_reused"], d["prefill_chunks"]) == (23, 1)
    assert eng.finished[1].generated == eng.finished[0].generated


def test_engine_cache_prefix_opt_out(models):
    """An opted-out request inserts nothing but may still match."""
    prompt = list(range(3, 19))
    out = dict(max_new_tokens=2, cache_prefix=False)
    batches = [[(prompt, out)], [(prompt, dict(max_new_tokens=2))], [(prompt, out)]]
    ours, theirs = _engines(models, max_seqs=2, max_len=64, page_size=8, prefix_cache=True)
    ours.submit(Request(rid=0, prompt=prompt, **out))
    ours.run()
    assert ours.prefix_cache.stats()["nodes"] == 0
    tokens, counts = _drive(ours, Request, batches[1:])
    theirs.submit(JaxRequest(rid=0, prompt=prompt, **out))
    theirs.run()
    jax_tokens, jax_counts = _drive(theirs, JaxRequest, batches[1:])
    assert tokens == jax_tokens and counts == jax_counts
    assert ours.sched_stats["prefix_hits"] == theirs.sched_stats["prefix_hits"] == 1
    assert ours.prefix_cache.stats() == theirs.prefix_cache.stats()
    assert ours.prefix_cache.stats()["nodes"] > 0


def test_spill_requires_prefix_cache(models):
    cfg, params, _, _ = models
    with pytest.raises(ValueError, match="prefix_cache"):
        PagedServeEngine(cfg, params, device="cpu", spill_pages=2)


def test_admission_retry_drop_path_without_spill(models):
    """With no spill tier, pressure drops cached leaves and admission still
    succeeds; counters and the cache's drops equal the JAX engine's."""
    batches = [[(list(range(1, 21)), dict(max_new_tokens=4))],
               [([2] * 20, dict(max_new_tokens=4, cache_prefix=False))]]
    ours, theirs = _engines(models, max_seqs=2, max_len=32, page_size=8, num_pages=5,
                            prefix_cache=True)
    tokens, counts = _drive(ours, Request, batches)
    jax_tokens, jax_counts = _drive(theirs, JaxRequest, batches)
    assert tokens == jax_tokens and counts == jax_counts
    assert len(ours.finished) == 2
    assert (counts["pages_spilled"], counts["admission_refusals"]) == (0, 0)
    assert ours.sched_stats["spill_retries"] == theirs.sched_stats["spill_retries"] > 0
    assert ours.prefix_cache.stats()["dropped_nodes"] \
        == theirs.prefix_cache.stats()["dropped_nodes"] > 0


def test_cli_shared_prefix_counters_match_jax():
    """``--shared-prefix`` drains the shared-system-prompt scenario; the
    ``[serve] prefix:`` counters equal the JAX CLI's for the same arguments."""
    argv = ["--arch", "gpt-paper", "--local", "--paged", "--prefix-cache",
            "--spill-pages", "8", "--shared-prefix", "40", "--prompt-len", "48",
            "--max-new", "4", "--requests", "6", "--max-len", "64", "--num-pages", "10",
            "--page-size", "8", "--max-seqs", "2", "--prefill-chunk", "16"]
    lines = []
    for main, extra in ((serve.main, ["--device", "cpu"]), (jax_serve.main, [])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(argv + extra)
        found = [ln for ln in out.getvalue().splitlines() if ln.startswith("[serve] prefix:")]
        assert len(found) == 1
        lines.append(dict(re.findall(r"(\w+)=(\d+)", found[0])))
    assert lines[0] == lines[1]
    assert int(lines[0]["prefix_hits"]) == 3
    assert int(lines[0]["pages_restored"]) > 0
