"""Port KV pool against the JAX package's allocator, op for op.

The seeded random allocator programs of ``tests/test_kv_pool.py`` (plain
and shared reservations with copy-on-write boundaries, lazy table growth,
frees, external holds), without the spill tier, which the port leaves to
the prefix-cache slice.  Both pools run the same program in lock step and
must agree exactly after every op: page tables, reservations, free lists,
refcounts, ``stats()`` and the pool's contents.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.serving import KVPool as JaxPool
from repro.serving import OutOfPagesError as JaxOutOfPages
from repro_torch.configs import get_config
from repro_torch.serving import KVPool, OutOfPagesError

torch.set_num_threads(2)

SHAPE = dict(n_layers=1, n_kv_heads=1, head_dim=4, num_pages=8, page_size=4)


def _pools(seed):
    """A port pool and a JAX pool holding the same random contents."""
    jp = JaxPool(**SHAPE)
    tp = KVPool(**SHAPE, device="cpu")
    data = np.random.default_rng(seed).standard_normal(tuple(tp.pages.shape))
    jp.pages = jnp.asarray(data, jnp.float32)
    tp.pages.copy_(torch.tensor(data, dtype=torch.float32))
    return tp, jp


def _state(p):
    seqs = {sid: (list(a.reserved), list(a.table), a.tokens) for sid, a in p._seqs.items()}
    return (list(p._free), dict(p._ref), seqs, p.peak_pages_in_use, p.cow_events)


def _both(tp, jp, fn):
    """Run ``fn`` on both pools; both must raise out-of-pages or neither."""
    outcomes = []
    for pool, err in ((tp, OutOfPagesError), (jp, JaxOutOfPages)):
        try:
            fn(pool)
            outcomes.append(None)
        except err as e:
            outcomes.append((e.need, e.free, e.in_use, e.num_pages))
    assert outcomes[0] == outcomes[1]
    return outcomes[0] is not None


def _check_same(tp, jp):
    assert _state(tp) == _state(jp)
    ours, theirs = tp.stats(), jp.stats()
    assert ours == {k: theirs[k] for k in ours}
    assert theirs["spilled_pages"] == theirs["pages_spilled"] == 0
    tp.check_invariants()
    jp.check_invariants()


@pytest.mark.parametrize("seed", range(8))
def test_allocator_program_matches_jax(seed, n_ops=60):
    rnd = random.Random(seed)
    tp, jp = _pools(seed)
    live = {}        # seq_id -> reserved token budget
    holds = []       # external page refs (the prefix cache's stand-in)
    next_sid = 0
    for _ in range(n_ops):
        op = rnd.choice(["reserve", "reserve_shared", "ensure", "free", "hold", "unhold"])
        free_before = tp.free_pages
        if op == "reserve":
            n = rnd.randint(1, 20)
            if _both(tp, jp, lambda p: p.reserve(next_sid, n)):
                assert tp.free_pages == free_before  # refusal is side-effect free
            else:
                live[next_sid] = 20
                next_sid += 1
        elif op == "reserve_shared" and holds:
            cand = list(dict.fromkeys(holds))
            k = rnd.randint(0, min(2, len(cand)))
            fulls, boundary, part = cand[:k], None, 0
            if len(cand) > k and rnd.random() < 0.5:
                boundary = cand[k]
                part = rnd.randint(1, tp.page_size - 1)
            shared = k * tp.page_size + part
            n = shared + rnd.randint(1, 10)
            if _both(tp, jp, lambda p: p.reserve(next_sid, n, shared_pages=fulls,
                                                 shared_tokens=shared,
                                                 boundary_page=boundary)):
                assert tp.free_pages == free_before
            else:
                live[next_sid] = n
                next_sid += 1
        elif op == "ensure" and live:
            sid = rnd.choice(list(live))
            n = rnd.randint(1, live[sid] + 4)
            _both(tp, jp, lambda p: p.ensure(sid, n))  # over-budget growth may fail
        elif op == "free" and live:
            sid = rnd.choice(list(live))
            assert tp.free(sid) == jp.free(sid)
            del live[sid]
        elif op == "hold":
            tabs = [pg for sid in live for pg in tp.table(sid)]
            if tabs:
                pg = rnd.choice(tabs)
                tp.incref(pg)
                jp.incref(pg)
                holds.append(pg)
        elif op == "unhold" and holds:
            pg = holds.pop(rnd.randrange(len(holds)))
            assert tp.decref(pg) == jp.decref(pg)
        _check_same(tp, jp)
        ids = list(live) + [None]
        np.testing.assert_array_equal(tp.table_array(ids, 6).numpy(),
                                      np.asarray(jp.table_array(ids, 6)))
    # copy-on-write moved the same contents into the same pages
    np.testing.assert_array_equal(tp.pages.numpy(), np.asarray(jp.pages))
    # full drain: every page comes home, the ledger balances
    for sid in list(live):
        tp.free(sid)
        jp.free(sid)
    while holds:
        pg = holds.pop()
        tp.decref(pg)
        jp.decref(pg)
    _check_same(tp, jp)
    assert tp.free_pages == tp.num_pages
    assert tp.alloc_events == tp.free_events


def test_for_config_and_write_match_jax():
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32")
    jcfg = jax_config("gpt-paper").reduced().with_(dtype="float32")
    tp = KVPool.for_config(cfg, num_pages=4, page_size=8, device="cpu")
    jp = JaxPool.for_config(jcfg, num_pages=4, page_size=8)
    # +1 physical page: the trash page for padded-row writes
    assert tuple(tp.pages.shape) == jp.pages.shape == (cfg.n_layers, 5, 8, 2 * cfg.n_kv_heads,
                                                       cfg.hd)
    assert tp.trash_page == jp.trash_page == 4
    assert tp.token_bytes() == jp.token_bytes()
    rng = np.random.default_rng(0)
    slots = np.array([3, 17, 8, 39], np.int32)
    k = rng.standard_normal((4, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    v = rng.standard_normal((4, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    tp.write(1, torch.tensor(slots, dtype=torch.long), torch.tensor(k), torch.tensor(v))
    jp.write(1, jnp.asarray(slots), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(tp.pages.numpy(), np.asarray(jp.pages))
    assert float(tp.pages[0].abs().sum()) == 0.0  # other layers untouched


def test_out_of_pages_error_is_actionable():
    tp = KVPool(**SHAPE, device="cpu")
    tp.reserve(0, 28)  # 7 of 8 pages
    with pytest.raises(OutOfPagesError) as ei:
        tp.reserve(1, 8)
    e = ei.value
    assert (e.need, e.free, e.in_use, e.num_pages) == (2, 1, 7, 8)
    assert "need 2 page(s)" in str(e) and "--num-pages" in str(e)
    # an engine-facing pool defaults to the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            KVPool(**SHAPE)
