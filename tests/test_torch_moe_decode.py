"""The port's MoE serving (``cache_specs``, ``moe_block_decode``,
``decode_step``, ``prefill``, ``ServeEngine`` and the CLI) against the JAX
package's.

qwen2-moe-a2.7b ``reduced()`` in float32 at 3 layers (2 slots against 3
layers, so a slot/layer mix-up shows) with a sliding window of 16, so that
a 20-token prompt rolls the ring at prefill and decoding wraps it; the
weights come from the JAX ``init_params`` carried over by
``repro_torch.interop``.  ``reduced()``'s capacity factor is 8: each of its
4 experts has at least 4 S slots for S tokens, so no expert overflows and
the JAX table's lost slot (ROADMAP C-ref-4) cannot arise.  The JAX package
serves a MoE model only in the stacked form (its list-form ``prefill``
raises and its ``decode_step`` reads ``moe_layers`` from a ``layers``
cache, ROADMAP C-ref-5), so the port is held against it in the stacked
form, with and without a dense first layer, and the port's list form
against its own stacked form.

Tolerances: prefill logits and caches and every decode step against JAX's
agree to ``ATOL`` 1e-5, as in ``tests/test_torch_ssm_decode.py``; decode
logits against the port's forward over the sequence so far to 1e-4;
greedy tokens exactly.
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M
from repro_torch.serving import Request, ServeEngine

torch.set_num_threads(2)
ARCH = "qwen2-moe-a2.7b"
ATOL = 1e-5
ATOL_FWD = 1e-4      # decode against the forward over the whole sequence
OVER = dict(dtype="float32", n_layers=3, sliding_window=16)
FORMS = {"stacked": {}, "densepre": {"first_k_dense": 1}}


def _pair(**kw):
    kw = dict(OVER, **kw)
    cfg, jcfg = get_config(ARCH).reduced().with_(**kw), jax_config(ARCH).reduced().with_(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                 device="cpu")


@pytest.fixture(scope="module", params=list(FORMS))
def pair(request):
    return _pair(**FORMS[request.param])


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _leaves_close(ours, theirs):
    ol, tl = jax.tree.leaves(ours), jax.tree.leaves(theirs)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, theirs))
    for a, b in zip(ol, tl):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b)


def _list_form(cfg, jparams):
    """The port's list-form model holding the stacked JAX weights."""
    tree = jax.tree.map(np.asarray, jparams)
    blocks = tree["blocks"]
    n = cfg.n_layers - cfg.first_k_dense
    tree = dict(tree, blocks=[jax.tree.map(lambda a: a[i], blocks) for i in range(n)])
    cfg_list = cfg.with_(scan_layers=False)
    return cfg_list, params_from_numpy(cfg_list, tree, device="cpu")


@pytest.mark.parametrize("over", [{}, {"first_k_dense": 1}, {"scan_layers": False},
                                  {"first_k_dense": 1, "scan_layers": False}],
                         ids=["stacked", "densepre", "list", "densepre-list"])
def test_cache_specs_match_jax(over):
    """Both packages lay the cache out alike: ``moe_layers`` stacked (L - k,
    B, ...) beside a ``dense_layers`` list for a dense prefix, or one
    ``layers`` list in the list form; the zero cache is on the device."""
    cfg = get_config(ARCH).reduced().with_(**over)
    jcfg = jax_config(ARCH).reduced().with_(**over)
    ours, theirs = M.cache_specs(cfg, 3, 64), JM.cache_specs(jcfg, 3, 64)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, theirs))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    k = cfg.first_k_dense
    if cfg.scan_layers:
        assert ours["moe_layers"]["k"].shape == (cfg.n_layers - k, 3, cfg.sliding_window,
                                                 cfg.n_kv_heads, cfg.hd)
        assert len(ours.get("dense_layers", [])) == k
    else:
        assert list(ours) == ["layers"] and len(ours["layers"]) == cfg.n_layers
    cache = M.init_cache(cfg, 3, 64, device="cpu")
    assert all(float(t.abs().sum()) == 0.0 for t in jax.tree.leaves(cache))


def test_layer_cache_views_the_moe_layout():
    """Layer ``i < k`` is entry ``i`` of ``dense_layers``, a later layer a
    view into ``moe_layers`` at ``i - k``: a write through it reaches the
    cache; each leaf's batch dim is its own (0 for the list, 1 stacked)."""
    cfg = get_config(ARCH).reduced().with_(first_k_dense=1, n_layers=3)
    cache = M.init_cache(cfg, 2, 32, device="cpu")
    assert M._layer_cache(cache, 0) is cache["dense_layers"][0]
    M._layer_cache(cache, 2)["k"][1].fill_(1.0)
    assert float(cache["moe_layers"]["k"][1, 1].min()) == 1.0
    assert float(cache["moe_layers"]["k"][0].abs().max()) == 0.0
    assert float(cache["moe_layers"]["k"][1, 0].abs().max()) == 0.0
    assert [d for _, d in M._cache_leaves(cache)] == [0, 0, 1, 1]
    one = M.init_cache(cfg, 1, 32, device="cpu")
    for t in pytree.tree_leaves(one):
        t.fill_(2.0)
    M.write_cache_row(cache, 1, one)
    assert float(cache["dense_layers"][0]["v"][1].min()) == 2.0
    assert float(cache["dense_layers"][0]["v"][0].abs().max()) == 0.0
    assert float(cache["moe_layers"]["v"][:, 1].min()) == 2.0
    assert float(cache["moe_layers"]["v"][:, 0].abs().max()) == 0.0
    with pytest.raises(ValueError, match="layouts differ"):
        M.write_cache_row(cache, 0, M.init_cache(cfg.with_(first_k_dense=0), 1, 32,
                                                 device="cpu"))


@pytest.mark.parametrize("S", [5, 21], ids=["short", "past-window"])
def test_prefill_matches_jax(pair, S):
    """Logits and every cache leaf; S 21 rolls the ring of 16.  The port's
    prefill logits equal its own forward's at the same window bit for bit."""
    cfg, jcfg, jparams, params = pair
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (1, S))
    lj, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 32)
    lt, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks)}, 32)
    _close(lt.numpy(), lj)
    _leaves_close(ct, cj)
    fwd = M.forward(cfg, params, {"tokens": torch.tensor(toks)}, window=cfg.sliding_window)[0]
    assert torch.equal(lt, fwd)
    assert ct["moe_layers"]["k"].shape[2] == cfg.sliding_window


def test_moe_block_decode_matches_jax(pair):
    """One MoE block at one token against ``JM.moe_block_decode`` from the
    same prefilled layer cache: the block's output and its ring."""
    cfg, jcfg, jparams, params = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 9))
    _, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks)}, 32)
    x = np.random.default_rng(4).standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    i = cfg.first_k_dense
    p = params.layer_params(i)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    c = M._layer_cache(ct, i)
    jc = {k: jnp.asarray(v.numpy()) for k, v in c.items()}
    ours = M.moe_block_decode(cfg, p, torch.from_numpy(x), c, torch.tensor([9]))
    theirs, jnc = JM.moe_block_decode(jcfg, jp, jnp.asarray(x), jc, jnp.int32(9))
    _close(ours.numpy(), theirs)
    _leaves_close(c, jnc)
    assert float(c["k"][0, 9].abs().max()) > 0


def test_decode_steps_match_jax_and_forward(pair):
    """Twenty waves of one row from a 7-token prefill: each wave's logits
    against the JAX decode step (1e-5) and the port's forward at the window
    over the sequence so far (1e-4; the ring of 16 wraps at 16), the whole
    cache after the last; the cache object is updated in place."""
    cfg, jcfg, jparams, params = pair
    T = 27
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, T))
    full, _ = M.forward(cfg, params, {"tokens": torch.tensor(toks)}, window=cfg.sliding_window)
    _, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :7])}, 64)
    _, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks[:, :7])}, 64)
    for pos in range(7, T):
        lgj, cj = JM.decode_step(jcfg, jparams, cj, jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                                 jnp.int32(pos))
        lgt, same = M.decode_step(cfg, params, ct, torch.tensor(toks[:, pos:pos + 1]),
                                  torch.tensor([pos]))
        assert same is ct
        _close(lgt.numpy(), lgj)
        _close(lgt[0, 0].numpy(), full[0, pos].numpy(), ATOL_FWD)
    _leaves_close(ct, cj)


def test_rows_at_different_positions_decode_as_alone(pair):
    """Two rows prefilled to 19 and 3 tokens step together for 10 waves,
    each row's logits equal to that row stepped alone; the rows reach the
    batched cache through ``write_cache_row`` (dim 0 of ``dense_layers``,
    dim 1 of ``moe_layers``)."""
    cfg, _, _, params = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (19, 3)]
    solo, batch_cache = [], M.init_cache(cfg, 2, 64, device="cpu")
    for b, pr in enumerate(prompts):
        _, c = M.prefill(cfg, params, {"tokens": torch.tensor(pr)}, 64)
        M.write_cache_row(batch_cache, b, c)
        solo.append(c)
    nxt = rng.integers(0, cfg.vocab_size, (10, 2))
    pos = torch.tensor([19, 3])
    for w in range(10):
        lg, _ = M.decode_step(cfg, params, batch_cache, torch.tensor(nxt[w])[:, None], pos + w)
        for b in range(2):
            lb, _ = M.decode_step(cfg, params, solo[b], torch.tensor([[nxt[w, b]]]),
                                  torch.tensor([int(pos[b]) + w]))
            _close(lg[b].numpy(), lb[0].numpy())


def _serve(engine_cls, request_cls, cfg, params, prompts, *, max_batch, max_new, **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, max_len=64, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


# one past the window of 16 (prefill rolls the ring), shorter ones
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4], [2, 7, 1],
           [9, 9, 9, 9, 8], [7, 7, 7], [1, 2, 3, 4]]


def test_engine_matches_jax(pair):
    """Five requests through 2 slots: the third and later wait for a freed
    slot, so a slot's cache rows are overwritten; greedy tokens equal the
    JAX engine's, and the first two equal their tokens served alone."""
    cfg, jcfg, jparams, params = pair
    theirs = _serve(JServeEngine, JRequest, jcfg, jparams, PROMPTS, max_batch=2, max_new=12)
    ours = _serve(ServeEngine, Request, cfg, params, PROMPTS, max_batch=2, max_new=12,
                  device="cpu")
    assert ours == theirs and all(len(g) == 12 for g in ours)
    solo = [_serve(ServeEngine, Request, cfg, params, [p], max_batch=1, max_new=12,
                   device="cpu")[0] for p in PROMPTS[:2]]
    assert ours[:2] == solo


def test_list_form_serves_the_stacked_forms_tokens(pair):
    """The port's list form (a cache of one ``layers`` list, which the JAX
    package cannot serve) on the same weights: the same greedy tokens, and
    the same prefill logits and K/V layer by layer."""
    cfg, _, jparams, params = pair
    cfg_list, params_list = _list_form(cfg, jparams)
    stacked = _serve(ServeEngine, Request, cfg, params, PROMPTS, max_batch=2, max_new=12,
                     device="cpu")
    listed = _serve(ServeEngine, Request, cfg_list, params_list, PROMPTS, max_batch=2,
                    max_new=12, device="cpu")
    assert listed == stacked
    toks = torch.tensor([PROMPTS[0]])
    l0, c0 = M.prefill(cfg, params, {"tokens": toks}, 64)
    l1, c1 = M.prefill(cfg_list, params_list, {"tokens": toks}, 64)
    _close(l1.numpy(), l0.numpy())
    assert list(c1) == ["layers"] and len(c1["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        for key in ("k", "v"):
            _close(c1["layers"][i][key].numpy(), M._layer_cache(c0, i)[key].numpy())


def test_compiled_wave_matches_the_plain_wave(pair):
    """The wave compiled at budget 0.5 against the plain one from the same
    cache, tokens and positions, for two waves: logits and the caches after
    both (the ring writes are in-place writes inside the compiled graph)
    within 1e-5."""
    cfg, _, _, params = pair
    e1 = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    e2 = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5, device="cpu")
    assert e2.autochunk_result is not None
    for e in (e1, e2):
        for rid, prompt in enumerate(PROMPTS[:2]):
            e.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
        e._admit()
    pos = torch.tensor([len(PROMPTS[0]), len(PROMPTS[1])])
    for w, toks in enumerate(([5, 9], [2, 4])):
        lg1 = e1._decode_wave(e1.cache, torch.tensor(toks), pos + w)
        lg2 = e2._decode_wave(e2.cache, torch.tensor(toks), pos + w)
        _close(lg2.numpy(), lg1.numpy())
    for a, b in zip(pytree.tree_leaves(e1.cache), pytree.tree_leaves(e2.cache)):
        _close(b.numpy(), a.numpy())
        assert float(a.abs().max()) > 0


def _plans():
    return {key[2]: (len(cf.autochunk_result.plan), cf.autochunk_result.final_peak)
            for key, cf in M._AC_CACHE.items()}


@pytest.mark.parametrize("budget,form", [(0.5, "stacked"), (0.1, "stacked"),
                                         (0.1, "densepre")])
def test_budgeted_prefill_matches_and_keeps_the_forward_plans(budget, form):
    """The per-block prefill under a budget runs the forward's blocks under
    its tags (``moe{window}``, and ``densepre{window}`` for a dense first
    layer): logits and caches within 1e-5 of the unbudgeted prefill; the
    forward at the same window compiled after it replays the prefill's
    plans, which are those the forward compiles alone."""
    over = dict(OVER, n_layers=3, capacity_factor=1.25, n_shared_experts=4, **FORMS[form])
    cfg = get_config(ARCH).reduced().with_(**over)
    cfg_ac = cfg.with_(autochunk_budget=budget)
    params = M.init_params(cfg, 0, device="cpu")
    S, w = 256, cfg.sliding_window
    batch = {"tokens": torch.tensor(np.random.default_rng(8).integers(0, cfg.vocab_size,
                                                                     (1, S)))}
    tags = {f"moe{w}"} | ({f"densepre{w}"} if cfg.first_k_dense else set())
    M._AC_CACHE.clear()
    M.forward(cfg_ac, params, batch, window=w)
    alone = _plans()
    assert set(alone) == tags and alone[f"moe{w}"][0] > 0
    M._AC_CACHE.clear()
    l0, c0 = M.prefill(cfg, params, batch, 2 * S)
    l1, c1 = M.prefill(cfg_ac, params, batch, 2 * S)
    _close(l1.numpy(), l0.numpy())
    for a, b in zip(pytree.tree_leaves(c0), pytree.tree_leaves(c1)):
        _close(b.numpy(), a.numpy())
    assert _plans() == alone
    searched = {k[2]: cf.stats()["compiles"] for k, cf in M._AC_CACHE.items()}
    M.forward(cfg_ac, params, batch, window=w)
    assert _plans() == alone
    assert {k[2]: cf.stats()["compiles"] for k, cf in M._AC_CACHE.items()} == searched
    M._AC_CACHE.clear()


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_cli_serves_moe_as_the_jax_cli():
    """``serve.main --arch qwen2-moe-a2.7b --local`` serves on the fixed-slot
    engine: its requests line (counts and decode waves) reads as the JAX
    CLI's with the same flags."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--local", "--max-batch", "2", "--requests", "3",
            "--prompt-len", "6", "--max-new", "4", "--max-len", "32"]

    def requests_line(text):
        return re.findall(r"\[serve\] (\d+) requests, (\d+) tokens .*, (\d+) decode waves\)",
                          text)

    ours = requests_line(_cli(serve.main, argv + ["--device", "cpu"]))
    assert ours == requests_line(_cli(jserve.main, argv)) == [("3", "12", "6")]
