"""The port's MLA serving (the absorbed decode against the latent ring,
``cache_specs``, ``prefill``, ``decode_step``, ``ServeEngine`` and the CLI)
against the JAX package's.

deepseek-v3-671b ``reduced()`` in float32: a dense first layer and a MoE
layer with sigmoid routing, MLA at kv_lora 32 and qk_rope 16, a sliding
window of 32, so a 40-token prompt rolls the ring at prefill and decoding
wraps it.  ``reduced()``'s capacity factor is 8, so no expert overflows and
the JAX table's lost slot (ROADMAP C-ref-4) cannot arise.  Weights come
from the JAX ``init_params`` carried over by ``repro_torch.interop``.  The
JAX package's ``prefill`` raises in the list form (ROADMAP C-ref-5), so
the port is held against it in the stacked form, and the port's list form
against its own stacked form.

The decode attends to the whole ring, as the JAX package's does: a ring as
wide as the window holds exactly the window, so decode logits equal the
forward's at ``window=cfg.sliding_window`` (not the unwindowed forward's)
past the wrap.

Tolerances: the absorbed attention, prefill logits and caches and every
decode step against JAX's to ``ATOL`` 1e-5; decode against the port's
windowed forward over the sequence so far and the compiled wave against
the plain one to 1e-4; the budgeted prefill against the unbudgeted one to
1e-3; greedy tokens exactly.
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
from repro.models import mla as JMLA
from repro.models import model as JM
from repro.serving import PagedServeEngine as JPagedServeEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, ChunkedFunction, stats
from repro_torch.core.lowering import is_chunk_loop
from repro_torch.interop import params_from_numpy
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.serving import PagedServeEngine, Request, ServeEngine

torch.set_num_threads(2)
ARCH = "deepseek-v3-671b"
ATOL = 1e-5
ATOL_FWD = 1e-4
ATOL_BUDGET = 1e-3
OVER = dict(dtype="float32")


@pytest.fixture(scope="module")
def pair():
    cfg, jcfg = get_config(ARCH).reduced().with_(**OVER), jax_config(ARCH).reduced().with_(**OVER)
    assert cfg.scan_layers and cfg.first_k_dense == 1 and cfg.sliding_window == 32
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                 device="cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _structure(tree):
    return jax.tree.structure(jax.tree.map(lambda t: 0, tree))


def _leaves_close(ours, theirs):
    assert _structure(ours) == _structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n))


@pytest.mark.parametrize("pos", [5, 45], ids=["ring-part-written", "past-wrap"])
def test_absorbed_decode_matches_jax(pair, pos):
    """``mla_attention_decode`` on the same ring of 32 and valid mask as the
    JAX function (one position for both rows, as the JAX function takes
    it): at position 5 the slots past it are invalid, at 45 the ring has
    wrapped and every slot is live."""
    cfg, jcfg, jparams, _ = pair
    tree = jax.tree.map(np.array, jparams["dense_blocks"][0]["attn"])
    p = {k: torch.from_numpy(v) for k, v in tree.items()}
    B, W = 2, cfg.sliding_window
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    ckv = rng.standard_normal((B, W, cfg.kv_lora_rank), dtype=np.float32)
    kr = rng.standard_normal((B, W, cfg.qk_rope_dim), dtype=np.float32)
    kv_pos = np.asarray(JM._ring_kv_positions(jnp.int32(pos), W))
    valid = kv_pos >= 0
    assert valid.all() == (pos >= W)
    theirs, _ = JMLA.mla_attention_decode(jcfg, tree, jnp.asarray(x), jnp.asarray(ckv),
                                          jnp.asarray(kr), jnp.int32(pos), jnp.asarray(valid))
    ours = MLA.mla_attention_decode(cfg, p, torch.from_numpy(x), torch.from_numpy(ckv),
                                    torch.from_numpy(kr), torch.full((B,), pos),
                                    torch.from_numpy(valid)[None].expand(B, W))
    assert ours.shape == (B, 1, cfg.d_model)
    _close(ours.numpy(), theirs)


def test_absorbed_decode_expands_no_operand_over_the_heads():
    """At full width (128 heads, kv_lora 512, a ring of 8192, 2 rows),
    traced on ``meta``: the absorbed decode's predicted peak stays far
    below one copy of the ring expanded over the heads (2 x 128 x 512 x
    8192 f32 = 4,294,967,296 B), which a broadcast ``@`` against the ring's
    unsqueezed view would make; every value is below that size too."""
    cfg = get_config(ARCH)
    p = MLA.mla_params(cfg, None, device="meta")
    B, W = 2, 8192

    def meta(*shape, dtype=cfg.torch_dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    args = (p, meta(B, 1, cfg.d_model), meta(B, W, cfg.kv_lora_rank),
            meta(B, W, cfg.qk_rope_dim), meta(B, dtype=torch.int64),
            meta(B, W, dtype=torch.bool))
    cf = ChunkedFunction(lambda p, *a: MLA.mla_attention_decode(cfg, p, *a),
                         ChunkConfig.from_scalar(0.5, weight_argnums=(0,)))
    traced = cf.trace(*args)
    expanded = B * cfg.n_heads * cfg.kv_lora_rank * W * 4
    assert expanded == 4_294_967_296
    assert traced.baseline_peak < 256 * 2**20
    assert max(traced.graph.node_bytes(v) for v in traced.graph.last_use) < 64 * 2**20


@pytest.mark.parametrize("form", ["stacked", "list"])
def test_cache_specs_hold_the_latent_ring(form):
    """The latent ring ``{"ckv": (B, W, kv_lora_rank), "kr": (B, W,
    qk_rope_dim)}`` in the model's dtype, laid out as the JAX package lays
    it out (stacked); the list form is one ``layers`` list.  ``init_cache``
    and ``write_cache_row`` serve it unchanged."""
    over = {} if form == "stacked" else {"scan_layers": False}
    cfg = get_config(ARCH).reduced().with_(**over)
    ours = M.cache_specs(cfg, 3, 64)
    W, L = cfg.sliding_window, cfg.n_layers
    if form == "stacked":
        theirs = JM.cache_specs(jax_config(ARCH).reduced(), 3, 64)
        assert _structure(ours) == _structure(theirs)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert ours["moe_layers"]["ckv"].shape == (L - 1, 3, W, cfg.kv_lora_rank)
        assert ours["dense_layers"][0]["kr"].shape == (3, W, cfg.qk_rope_dim)
    else:
        assert list(ours) == ["layers"] and len(ours["layers"]) == L
        assert all(set(c) == {"ckv", "kr"} for c in ours["layers"])
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in pytree.tree_leaves(ours))
    cache = M.init_cache(cfg, 3, 64, device="cpu")
    one = M.init_cache(cfg, 1, 64, device="cpu")
    for t in pytree.tree_leaves(one):
        t.fill_(2.0)
    M.write_cache_row(cache, 1, one)
    for i in range(L):
        for key in ("ckv", "kr"):
            leaf = M._layer_cache(cache, i)[key]
            assert float(leaf[1].min()) == 2.0 and float(leaf[0].abs().max()) == 0.0


@pytest.mark.parametrize("S", [5, 40], ids=["short", "past-window"])
def test_prefill_matches_jax(pair, S):
    """Logits and the ``ckv`` / ``kr`` leaves; S 40 rolls the ring of 32.
    The port's prefill logits equal its own windowed forward's."""
    cfg, jcfg, jparams, params = pair
    toks = _tokens(cfg, S, S)
    lj, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 64)
    lt, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks)}, 64)
    _close(lt.numpy(), lj)
    _leaves_close(ct, cj)
    fwd = M.forward(cfg, params, {"tokens": torch.tensor(toks)}, window=cfg.sliding_window)[0]
    assert torch.equal(lt, fwd)
    assert ct["moe_layers"]["ckv"].shape[2] == cfg.sliding_window


def test_decode_steps_match_jax_and_the_windowed_forward(pair):
    """Thirty-eight waves of one row from a 7-token prefill, across the
    ring's wrap at 32: each wave's logits against the JAX decode step
    (1e-5) and the port's forward at ``window=cfg.sliding_window`` over the
    sequence so far (1e-4), the whole cache after the last; the cache
    object is updated in place."""
    cfg, jcfg, jparams, params = pair
    T = 45
    toks = _tokens(cfg, T, 5)
    full, _ = M.forward(cfg, params, {"tokens": torch.tensor(toks)}, window=cfg.sliding_window)
    _, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :7])}, 64)
    _, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks[:, :7])}, 64)
    step = jax.jit(lambda c, t, pos: JM.decode_step(jcfg, jparams, c, t, pos))
    for pos in range(7, T):
        lgj, cj = step(cj, jnp.asarray(toks[:, pos:pos + 1], jnp.int32), jnp.int32(pos))
        lgt, same = M.decode_step(cfg, params, ct, torch.tensor(toks[:, pos:pos + 1]),
                                  torch.tensor([pos]))
        assert same is ct
        _close(lgt.numpy(), lgj)
        _close(lgt[0, 0].numpy(), full[0, pos].numpy(), ATOL_FWD)
    _leaves_close(ct, cj)


def test_rows_at_different_positions_decode_as_alone(pair):
    """Two rows prefilled to 40 and 3 tokens step together for 8 waves,
    each row's logits equal to that row stepped alone."""
    cfg, _, _, params = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (40, 3)]
    solo, batch_cache = [], M.init_cache(cfg, 2, 64, device="cpu")
    for b, pr in enumerate(prompts):
        _, c = M.prefill(cfg, params, {"tokens": torch.tensor(pr)}, 64)
        M.write_cache_row(batch_cache, b, c)
        solo.append(c)
    nxt = rng.integers(0, cfg.vocab_size, (8, 2))
    pos = torch.tensor([40, 3])
    for w in range(8):
        lg, _ = M.decode_step(cfg, params, batch_cache, torch.tensor(nxt[w])[:, None], pos + w)
        for b in range(2):
            lb, _ = M.decode_step(cfg, params, solo[b], torch.tensor([[nxt[w, b]]]),
                                  torch.tensor([int(pos[b]) + w]))
            _close(lg[b].numpy(), lb[0].numpy())


def _serve(engine_cls, request_cls, cfg, params, prompts, *, max_new=8, **kw):
    eng = engine_cls(cfg, params, max_batch=2, max_len=64, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


# one past the window of 32 (prefill rolls the ring), shorter ones; the
# third waits for a freed slot
PROMPTS = [list(range(3, 43)), [2, 7, 1], [9, 9, 9, 9, 8], [7, 7, 7]]


def _list_form(cfg, jparams):
    """The port's list-form model holding the stacked JAX weights."""
    tree = jax.tree.map(np.asarray, jparams)
    n = cfg.n_layers - cfg.first_k_dense
    tree = dict(tree, blocks=[jax.tree.map(lambda a: a[i], tree["blocks"]) for i in range(n)])
    cfg_list = cfg.with_(scan_layers=False)
    return cfg_list, params_from_numpy(cfg_list, tree, device="cpu")


def test_engine_matches_jax_and_the_list_form(pair):
    """Four requests through 2 slots: greedy tokens equal the JAX engine's
    (stacked); the port's list form on the same weights serves the same
    tokens."""
    cfg, jcfg, jparams, params = pair
    theirs = _serve(JServeEngine, JRequest, jcfg, jparams, PROMPTS)
    ours = _serve(ServeEngine, Request, cfg, params, PROMPTS, device="cpu")
    assert ours == theirs and all(len(g) == 8 for g in ours)
    cfg_list, params_list = _list_form(cfg, jparams)
    assert _serve(ServeEngine, Request, cfg_list, params_list, PROMPTS, device="cpu") == ours


def test_compiled_wave_matches_the_plain_wave(pair):
    """The wave compiled at budget 0.5 against the plain one from the same
    cache, tokens and positions (the first row past the wrap), for two
    waves: logits and the latent rings after both (the ring writes are
    in-place writes inside the compiled graph) within 1e-4."""
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
        _close(lg2.numpy(), lg1.numpy(), ATOL_FWD)
    for a, b in zip(pytree.tree_leaves(e1.cache), pytree.tree_leaves(e2.cache)):
        _close(b.numpy(), a.numpy(), ATOL_FWD)
        assert float(a.abs().max()) > 0


def _plans():
    return {key[2]: (len(cf.autochunk_result.plan), cf.autochunk_result.final_peak)
            for key, cf in M._AC_CACHE.items()}


@pytest.mark.parametrize("budget", [0.5, 0.1])
def test_budgeted_prefill_matches_and_keeps_the_forward_plans(budget):
    """The per-block prefill under a budget runs the forward's blocks under
    its tags (``densepre{window}``, ``moe{window}``): logits and latent
    rings within 1e-3 of the unbudgeted prefill; the prefill replays the
    plans the forward at the same length compiled (no new compile)."""
    cfg = get_config(ARCH).reduced().with_(dtype="float32", capacity_factor=1.25,
                                           sliding_window=256)
    cfg_ac = cfg.with_(autochunk_budget=budget)
    params = M.init_params(cfg, 0, device="cpu")
    S, w = 256, cfg.sliding_window
    batch = {"tokens": torch.tensor(_tokens(cfg, S, 8))}
    M._AC_CACHE.clear()
    M.forward(cfg_ac, params, batch, window=w)
    alone = _plans()
    assert set(alone) == {f"densepre{w}", f"moe{w}"} and alone[f"moe{w}"][0] > 0
    compiles = {k[2]: cf.stats()["compiles"] for k, cf in M._AC_CACHE.items()}
    l0, c0 = M.prefill(cfg, params, batch, 2 * S)
    before = stats.snapshot()
    l1, c1 = M.prefill(cfg_ac, params, batch, 2 * S)
    assert stats.delta(before)["search_passes"] == 0
    assert {k[2]: cf.stats()["compiles"] for k, cf in M._AC_CACHE.items()} == compiles
    assert _plans() == alone
    _close(l1.numpy(), l0.numpy(), ATOL_BUDGET)
    for a, b in zip(pytree.tree_leaves(c0), pytree.tree_leaves(c1)):
        _close(b.numpy(), a.numpy(), ATOL_BUDGET)
    M._AC_CACHE.clear()


def test_wave_compiled_for_the_card_dispatches_no_attention(pair):
    """The decode wave compiled as the engine compiles it, targeted at the
    card (``kernel_target="cuda"``, CPU tensors): MLA's absorbed scores are
    a sum of two products, so no attention site dispatches (0 attention
    hits, no computed mask); every dispatched loop is a SwiGLU's; its
    logits equal the plain wave's within 1e-4."""
    cfg, _, _, params = pair
    e = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    for rid, prompt in enumerate(PROMPTS[:2]):
        e.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
    e._admit()
    cf = ChunkedFunction(M.decode_fn(params), ChunkConfig.from_scalar(
        0.5, weight_argnums=(0,), kernel_target="cuda"))
    B = 2
    specs = (pytree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                             e.cache),
             torch.empty((B,), dtype=torch.int64, device="meta"),
             torch.empty((B,), dtype=torch.int64, device="meta"))
    weights = dict(params.named_parameters())
    before = stats.snapshot()
    planned = cf.trace(weights, *specs).search()
    d = stats.delta(before)
    loops = [n for n in planned.graph.nodes if is_chunk_loop(n)]
    kinds = [r.kind for n in loops for r in n.params["dispatches"]]
    assert loops and d["kernel_dispatch_computed_mask"] == 0
    assert "attention" not in kinds
    assert d["kernel_dispatch_hits"] == kinds.count("swiglu")
    compiled = planned.compile()
    cache2 = pytree.tree_map(lambda t: t.clone(), e.cache)
    toks, pos = torch.tensor([5, 9]), torch.tensor([len(PROMPTS[0]), len(PROMPTS[1])])
    want = e._decode_wave(e.cache, toks, pos)
    _close(compiled.fn(weights, cache2, toks, pos).numpy(), want.numpy(), ATOL_FWD)


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_cli_serves_mla_as_the_jax_cli():
    """``serve.main --arch deepseek-v3-671b --local`` serves on the
    fixed-slot engine: its requests line (counts and decode waves) reads as
    the JAX CLI's with the same flags."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--local", "--max-batch", "2", "--requests", "3",
            "--prompt-len", "6", "--max-new", "4", "--max-len", "48"]

    def requests_line(text):
        return re.findall(r"\[serve\] (\d+) requests, (\d+) tokens .*, (\d+) decode waves\)",
                          text)

    ours = requests_line(_cli(serve.main, argv + ["--device", "cpu"]))
    assert ours == requests_line(_cli(jserve.main, argv)) == [("3", "12", "6")]


def test_paged_engine_refuses_mla(pair):
    """The paged engine serves causal dense/GQA decoders; MLA keeps the
    slot engine in both packages."""
    cfg, jcfg, jparams, params = pair
    with pytest.raises(ValueError, match="mla=True"):
        JPagedServeEngine(jcfg, jparams, max_seqs=1, max_len=16)
    with pytest.raises(ValueError, match="mla=True"):
        PagedServeEngine(cfg, params, max_seqs=1, max_len=16, device="cpu")
