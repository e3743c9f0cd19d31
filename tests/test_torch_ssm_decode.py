"""The port's SSM and RG-LRU decode arms against the JAX package's.

``conv1d_step``, ``ssd_decode_step`` and ``rglru_step`` on the same seeded
numpy inputs; ``cache_specs`` (the stacked form for mamba2, the list form
for the hybrid, its local-attention rings capped at the window);
``prefill`` (each recurrent layer's final state and conv window, the
hybrid's ring rolled past a window of 8); several ``decode_step`` waves;
``ServeEngine`` token for token; the compiled wave at a budget against the
plain one; and the per-block prefill under a budget.  Configs are
``mamba2-1.3b.reduced()`` and ``recurrentgemma-9b.reduced()``, both at 3
layers (the reduced hybrid's 2 layers hold no attention layer; 3 layers
also differ from the engines' 2 slots, so a slot/layer mix-up shows), in
float32, on the JAX ``init_params`` weights carried over by
``repro_torch.interop``.

Tolerances: the one-token steps, the hybrid's prefill and every decode step
against JAX's agree to 1e-5.  mamba2's prefill is held to 1e-5 plus 1e-5 of
the tensor's largest magnitude: its scan is the SSD kernel's plain version,
whose sums run in another order than JAX's einsums (the forwards differ by
as much, see ``tests/test_torch_ssm_models.py``: 1.2e-5 on logits of 3.8,
2e-5 on states of 15, where an f32 step is 1e-6); the port's prefill
equals its own forward bit for bit.  Decode logits against the forward
over the sequence so far: 1e-4.
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
from repro.models import rglru as JRG
from repro.models import ssm as JSSM
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.serving import Request, ServeEngine

torch.set_num_threads(2)
ATOL = 1e-5
SCALE_SSD = 1e-5     # mamba2's prefill: the SSD sums in another order (docstring)
ATOL_FWD = 1e-4      # decode against the forward over the whole sequence
ARCHS = {"mamba2": ("mamba2-1.3b", {"n_layers": 3}),
         "hybrid": ("recurrentgemma-9b", {"n_layers": 3, "local_window": 8})}


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    name, over = ARCHS[request.param]
    cfg = get_config(name).reduced().with_(dtype="float32", **over)
    jcfg = jax_config(name).reduced().with_(dtype="float32", **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                 device="cpu")


def _close(got, want, scale=0.0):
    """|got - want| <= ATOL + scale * max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=ATOL + scale * float(np.abs(want).max()),
                               rtol=0)


def _leaves_close(ours, theirs, scale=0.0):
    ol, tl = jax.tree.leaves(ours), jax.tree.leaves(theirs)
    assert len(ol) == len(tl)
    for a, b in zip(ol, tl):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, scale)


def _np(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("fn", ["conv1d_step", "ssd_decode_step", "rglru_step"])
def test_step_functions_match_jax(fn):
    rng = np.random.default_rng(11)
    B, W, C = 3, 4, 40
    if fn == "conv1d_step":
        args = [_np((B, W - 1, C), rng), _np((B, C), rng), _np((W, C), rng, 0.5),
                _np((C,), rng)]
        ours = SSM.conv1d_step(*map(torch.from_numpy, args))
        theirs = JSSM.conv1d_step(*map(jnp.asarray, args))
    elif fn == "ssd_decode_step":
        h, p, n = 4, 8, 16
        dt = np.log1p(np.exp(_np((B, h), rng) - 1.0)).astype(np.float32)   # softplus
        A = -np.exp(rng.uniform(0, 2, h)).astype(np.float32)
        args = [_np((B, h, p, n), rng), _np((B, h, p), rng), dt, A, _np((B, n), rng),
                _np((B, n), rng)]
        ours = SSM.ssd_decode_step(*map(torch.from_numpy, args))
        theirs = JSSM.ssd_decode_step(*map(jnp.asarray, args))
    else:
        d = 32
        p = {"w_a": _np((d, d), rng, d ** -0.5), "b_a": _np((d,), rng, 0.1),
             "w_i": _np((d, d), rng, d ** -0.5), "b_i": _np((d,), rng, 0.1),
             "lam": rng.uniform(1, 3, d).astype(np.float32)}
        state, x = _np((B, d), rng), _np((B, d), rng)
        ours = RG.rglru_step({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(state), torch.from_numpy(x))
        theirs = JRG.rglru_step(jax.tree.map(jnp.asarray, p), jnp.asarray(state),
                                jnp.asarray(x))
        assert ours[0].dtype == torch.float32
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,over,max_len", [
    ("mamba2-1.3b", {}, 64),
    ("mamba2-1.3b", {"scan_layers": False}, 64),
    ("recurrentgemma-9b", {"n_layers": 3}, 48),                     # rings of 48
    ("recurrentgemma-9b", {"n_layers": 3, "local_window": 8}, 48),  # capped at 8
    ("recurrentgemma-9b", {"n_layers": 6, "dtype": "bfloat16"}, 96),
])
def test_cache_specs_match_jax(name, over, max_len):
    cfg = get_config(name).reduced().with_(**over)
    jcfg = jax_config(name).reduced().with_(**over)
    ours, theirs = M.cache_specs(cfg, 3, max_len), JM.cache_specs(jcfg, 3, max_len)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, theirs))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    layers = ours["layers"]
    if cfg.family == "ssm" and cfg.scan_layers:
        assert set(layers) == {"state", "conv"}
        assert layers["state"].shape[:2] == (cfg.n_layers, 3)
    cache = M.init_cache(cfg, 3, max_len, device="cpu")
    assert all(float(t.abs().sum()) == 0.0 for t in jax.tree.leaves(cache))


@pytest.mark.parametrize("S", [5, 21], ids=["short", "past-window"])
def test_prefill_matches_jax(pair, S):
    """Logits and every cache leaf; S 21 rolls the hybrid's ring of 8, and
    crosses mamba2's chunk of 16 with a ragged second chunk."""
    cfg, jcfg, jparams, params = pair
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (1, S))
    lj, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 32)
    lt, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks)}, 32)
    scale = SCALE_SSD if cfg.family == "ssm" else 0.0
    _close(lt.numpy(), lj, scale)
    _leaves_close(ct, cj, scale)
    assert torch.equal(lt, M.forward(cfg, params, {"tokens": torch.tensor(toks)})[0])
    if cfg.family == "hybrid":
        assert ct["layers"][2]["k"].shape[1] == 8


def test_prefill_pads_a_prompt_shorter_than_the_conv():
    """A 2-token prompt: the conv window's first row is the causal conv's
    zero padding, so one decode step equals the forward over 3 tokens."""
    cfg = get_config("mamba2-1.3b").reduced().with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.tensor([[5, 9, 2]])
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :2]}, 16)
    assert cache["layers"]["conv"].shape[2] == cfg.ssm_conv_width - 1
    assert float(cache["layers"]["conv"][:, :, 0].abs().max()) == 0.0
    lg, _ = M.decode_step(cfg, params, cache, toks[:, 2:], torch.tensor([2]))
    full = M.forward(cfg, params, {"tokens": toks})[0]
    np.testing.assert_allclose(lg[0, 0].numpy(), full[0, -1].numpy(), atol=ATOL_FWD, rtol=0)


def test_decode_steps_match_jax_and_forward(pair):
    """Twenty waves of one row from a 7-token prefill: each wave's logits
    against the JAX decode step (1e-5) and the port's forward over the
    sequence so far (1e-4; the hybrid's ring of 8 wraps at 8, 16 and 24),
    the whole cache after the last; the cache object is updated in place."""
    cfg, jcfg, jparams, params = pair
    T = 27
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, T))
    full, _ = M.forward(cfg, params, {"tokens": torch.tensor(toks)})
    _, cj = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :7])}, 64)
    _, ct = M.prefill(cfg, params, {"tokens": torch.tensor(toks[:, :7])}, 64)
    for pos in range(7, T):
        lgj, cj = JM.decode_step(jcfg, jparams, cj, jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                                 jnp.int32(pos))
        lgt, same = M.decode_step(cfg, params, ct, torch.tensor(toks[:, pos:pos + 1]),
                                  torch.tensor([pos]))
        assert same is ct
        np.testing.assert_allclose(lgt.numpy(), np.asarray(lgj), atol=ATOL, rtol=0)
        np.testing.assert_allclose(lgt[0, 0].numpy(), full[0, pos].numpy(), atol=ATOL_FWD,
                                   rtol=0)
    _leaves_close(ct, cj)


def test_rows_at_different_positions_decode_as_alone(pair):
    """Two rows prefilled to 11 and 3 tokens step together for 10 waves,
    each row's logits equal to that row stepped alone (the batched cache's
    row ``b`` of every leaf: dim 1 of the stacked form)."""
    cfg, _, _, params = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (11, 3)]
    bdim = 1 if cfg.scan_layers else 0
    solo, batch_cache = [], M.init_cache(cfg, 2, 64, device="cpu")
    for b, pr in enumerate(prompts):
        _, c = M.prefill(cfg, params, {"tokens": torch.tensor(pr)}, 64)
        for full, one in zip(pytree.tree_leaves(batch_cache), pytree.tree_leaves(c)):
            full.select(bdim, b).copy_(one.select(bdim, 0))
        solo.append(c)
    nxt = rng.integers(0, cfg.vocab_size, (10, 2))
    pos = torch.tensor([11, 3])
    for w in range(10):
        lg, _ = M.decode_step(cfg, params, batch_cache, torch.tensor(nxt[w])[:, None], pos + w)
        for b in range(2):
            lb, _ = M.decode_step(cfg, params, solo[b], torch.tensor([[nxt[w, b]]]),
                                  torch.tensor([int(pos[b]) + w]))
            np.testing.assert_allclose(lg[b].numpy(), lb[0].numpy(), atol=ATOL, rtol=0)


def _serve(engine_cls, request_cls, cfg, params, prompts, *, max_batch, max_new, **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, max_len=64, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


# one past the hybrid's window of 8 (prefill rolls the ring), shorter ones
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4], [2, 7, 1],
           [9, 9, 9, 9, 8], [7, 7, 7], [1, 2, 3, 4]]


def test_engine_matches_jax(pair):
    """Five requests through 2 slots (3 layers): the third and later wait
    for a freed slot, so a slot's state rows are overwritten; greedy tokens
    equal the JAX engine's, and each request's equal its tokens served
    alone."""
    cfg, jcfg, jparams, params = pair
    theirs = _serve(JServeEngine, JRequest, jcfg, jparams, PROMPTS, max_batch=2, max_new=12)
    ours = _serve(ServeEngine, Request, cfg, params, PROMPTS, max_batch=2, max_new=12,
                  device="cpu")
    assert ours == theirs and all(len(g) == 12 for g in ours)
    solo = [_serve(ServeEngine, Request, cfg, params, [p], max_batch=1, max_new=12,
                   device="cpu")[0] for p in PROMPTS[:2]]
    assert ours[:2] == solo


def test_compiled_wave_matches_the_plain_wave(pair):
    """The wave compiled at budget 0.5 against the plain one from the same
    cache, tokens and positions, for two waves: logits and the caches after
    both (the state and conv copies are in-place writes inside the compiled
    graph) within 1e-5."""
    cfg, _, _, params = pair
    e1 = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    e2 = ServeEngine(cfg, params, max_batch=2, max_len=64, autochunk_budget=0.5, device="cpu")
    assert e2.autochunk_result.plan
    for e in (e1, e2):
        for rid, prompt in enumerate(PROMPTS[:2]):
            e.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
        e._admit()
    pos = torch.tensor([len(PROMPTS[0]), len(PROMPTS[1])])
    for w, toks in enumerate(([5, 9], [2, 4])):
        lg1 = e1._decode_wave(e1.cache, torch.tensor(toks), pos + w)
        lg2 = e2._decode_wave(e2.cache, torch.tensor(toks), pos + w)
        np.testing.assert_allclose(lg2.numpy(), lg1.numpy(), atol=ATOL, rtol=0)
    for a, b in zip(pytree.tree_leaves(e1.cache), pytree.tree_leaves(e2.cache)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL, rtol=0)
        assert float(a.abs().max()) > 0


def _plans():
    return {key[2]: (len(cf.autochunk_result.plan), cf.autochunk_result.final_peak)
            for key, cf in M._AC_CACHE.items()}


@pytest.mark.parametrize("arch", ["mamba2", "hybrid"])
def test_budgeted_prefill_matches_and_keeps_the_forward_plans(arch):
    """The per-block prefill under a budget (its recurrent block under its
    own tag, ``ssm_prefill`` / ``hyb_rg_prefill``; the hybrid's attention
    block shares the forward's ``hyb_attn``) against the unbudgeted
    prefill: logits and caches within 1e-5.  The forward's plans compiled
    after it are those it compiles alone: mamba2 at S 96 (budget 0.5) 1
    stage, the hybrid at hd 256 and S 256 (``tests/test_torch_hybrid_budget.py``)
    3 + 1."""
    name, S, over, want = {
        "mamba2": ("mamba2-1.3b", 96, {}, {"ssm": 1}),
        "hybrid": ("recurrentgemma-9b", 256, {"n_layers": 3, "head_dim": 256},
                   {"hyb_attn": 3, "hyb_rg": 1}),
    }[arch]
    cfg = get_config(name).reduced().with_(dtype="float32", **over)
    cfg_ac = cfg.with_(autochunk_budget=0.5)
    params = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.tensor(np.random.default_rng(8).integers(0, cfg.vocab_size,
                                                                     (1, S)))}
    M._AC_CACHE.clear()
    M.forward(cfg_ac, params, batch)
    alone = _plans()
    assert {k: n for k, (n, _) in alone.items()} == want
    M._AC_CACHE.clear()
    l0, c0 = M.prefill(cfg, params, batch, 2 * S)
    l1, c1 = M.prefill(cfg_ac, params, batch, 2 * S)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=ATOL, rtol=0)
    for a, b in zip(pytree.tree_leaves(c0), pytree.tree_leaves(c1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL, rtol=0)
    tags = set(_plans())
    assert tags == ({"ssm_prefill"} if arch == "mamba2" else {"hyb_attn", "hyb_rg_prefill"})
    M.forward(cfg_ac, params, batch)
    after = _plans()
    assert {k: after[k] for k in alone} == alone
    M._AC_CACHE.clear()


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_cli_serves_the_family_as_the_jax_cli(arch):
    """``serve.main`` without ``--paged`` serves both families: its requests
    line (counts and decode waves) reads as the JAX CLI's."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--local", "--max-batch", "2", "--requests", "3",
            "--prompt-len", "6", "--max-new", "4", "--max-len", "32"]

    def requests_line(text):
        return re.findall(r"\[serve\] (\d+) requests, (\d+) tokens .*, (\d+) decode waves\)",
                          text)

    ours = requests_line(_cli(serve.main, argv + ["--device", "cpu"]))
    assert ours == requests_line(_cli(jserve.main, argv)) == [("3", "12", "6")]
